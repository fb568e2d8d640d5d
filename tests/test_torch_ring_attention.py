"""The port's context-parallel ring against the JAX package.

The same inputs, made from a seed with numpy, go through the JAX package's
carry-mode chunk entries (``flash_fwd_chunk`` / ``flash_dq_chunk`` /
``flash_dkv_chunk`` and their finalize functions, the Pallas bodies in
interpret mode) and the port's plain chunk versions, chained as one ring
rank chains them; then the port's loopback ring (a ``Topology(context=N,
loopback=True)``, one process driving the N ranks) through
``attention(impl="flash_ring")`` against the JAX package's single-device
``flash_attention(interpret=True)`` and the port's ``mha_reference``. On
the CPU the ring runs the chunk kernels' plain versions, so the schedule
itself is what these tests hold. The ``cuda``-marked tests hold the chunk
kernels against the plain versions and the ring against the single flash
kernels bit for bit.
"""

import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from deepspeed_tpu.ops.attention import flash_pallas as jf  # noqa: E402
from deepspeed_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from deepspeed_tpu_torch.ops.attention import core as pcore  # noqa: E402
from deepspeed_tpu_torch.ops.attention import flash as pf  # noqa: E402
from deepspeed_tpu_torch.ops.attention import sharded as ps  # noqa: E402
from deepspeed_tpu_torch.ops.kernels import CSRC  # noqa: E402
from deepspeed_tpu_torch.parallel.topology import (  # noqa: E402
    Topology,
    reset_topology,
    set_topology,
)

# fp32 on both sides: the same products summed in another order (the
# Pallas bodies stream 128-row blocks with an online max, the plain
# versions take one softmax over a chunk's row)
ATOL = RTOL = 1e-5
CHUNK, D = 128, 64


def _inputs(b, h, h_kv, s, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=sh).astype(np.float32)
                 for sh in ((b, h, s, d), (b, h_kv, s, d), (b, h_kv, s, d), (b, h, s, d)))


def _segments(b, s, seed):
    """Three packed segments per row, cut inside chunks, so a row of an
    early chunk sees no key of a later segment's chunk."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        for j, c in enumerate(np.sort(rng.choice(np.arange(8, s - 8), 2, replace=False))):
            seg[i, c:] = j + 1
    return seg


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture
def loopback():
    """A function setting a loopback Topology of context n; reset after."""
    def make(n):
        set_topology(Topology(context=n, loopback=True))

    yield make
    reset_topology()


def _chunks(x, n, axis=2):
    return np.split(x, n, axis=axis)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("h_kv", [4, 2])
@pytest.mark.parametrize("with_seg", [False, True])
def test_chunk_entries_match_jax(n, h_kv, with_seg):
    """The port's plain chunk versions chained as ring ranks chain them,
    against the JAX chunk entries chained the same way: forward and dq on
    the last rank (k/v chunks 0 .. N-2 non-causal, then the diagonal), dk/dv
    on rank 0 (q chunks 0 as the diagonal, then 1 .. N-1). The raw carries
    are compared after each hop (m, l and acc on rows that saw a key: JAX
    seeds m at -1e30, the port at -inf, so before its first visible key a
    JAX row counts masked keys at weight 1 and the first visible key's
    rescale by exp(-1e30 - m) wipes them; the dk/dv carries against JAX's
    per-query-head partials summed over the group), the finalized outputs
    at the end."""
    b, h, s = 1, 4, CHUNK * n
    q, k, v, do = _inputs(b, h, h_kv, s, D, seed=n * 10 + h_kv)
    seg = _segments(b, s, seed=n) if with_seg else None
    qc, kc, vc, doc = (_chunks(x, n) for x in (q, k, v, do))
    sc = _chunks(seg, n, axis=1) if with_seg else [None] * n
    t = {name: [torch.from_numpy(c) for c in chunks]
         for name, chunks in (("q", qc), ("k", kc), ("v", vc), ("do", doc), ("seg", sc))
         if chunks[0] is not None}
    tseg = t.get("seg")

    def jpair(i, j):
        return None if seg is None else (jnp.asarray(sc[i]), jnp.asarray(sc[j]))

    def ppair(i, j):
        return None if tseg is None else (tseg[i], tseg[j])

    # forward on the last rank
    home = n - 1
    jcarry = jf.flash_carry_init(b, h, CHUNK, D)
    pcarry = pf.flash_carry_init(b, h, CHUNK, D)
    for src in range(n):
        causal = src == home
        jcarry = jf.flash_fwd_chunk(jnp.asarray(qc[home]), jnp.asarray(kc[src]),
                                    jnp.asarray(vc[src]), jcarry, segment_ids=jpair(home, src),
                                    causal=causal, block=CHUNK, interpret=True)
        pcarry = pf.flash_fwd_chunk_reference(t["q"][home], t["k"][src], t["v"][src], pcarry,
                                              causal=causal, segment_ids=ppair(home, src))
        m_j, l_j = np.asarray(jcarry[0])[..., 0], np.asarray(jcarry[1])[..., 0]
        seen = np.isfinite(_np(pcarry[0]))
        assert (seen == (m_j > -1e29)).all()
        np.testing.assert_allclose(_np(pcarry[0])[seen], m_j[seen], atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(_np(pcarry[1])[seen], l_j[seen], atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(_np(pcarry[2])[seen], np.asarray(jcarry[2])[seen],
                                   atol=ATOL, rtol=RTOL)
    j_out, j_lse = jf.flash_finalize(jcarry, jnp.float32)
    p_out, p_lse = pf.flash_finalize(pcarry, torch.float32)
    np.testing.assert_allclose(_np(p_out), np.asarray(j_out), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_np(p_lse), np.asarray(j_lse)[..., 0], atol=ATOL, rtol=RTOL)

    # dq on the same rank, from the finalized out and lse
    jdq = jnp.zeros((b, h, CHUNK, D), jnp.float32)
    pdq = torch.zeros(b, h, CHUNK, D)
    for src in range(n):
        causal = src == home
        jdq = jf.flash_dq_chunk(jnp.asarray(qc[home]), jnp.asarray(kc[src]), jnp.asarray(vc[src]),
                                j_out, jnp.asarray(doc[home]), j_lse, jdq,
                                segment_ids=jpair(home, src), causal=causal, block=CHUNK,
                                interpret=True)
        pdq = pf.flash_dq_chunk_reference(t["q"][home], t["k"][src], t["v"][src], p_out,
                                          t["do"][home], p_lse, pdq, causal=causal,
                                          segment_ids=ppair(home, src))
        np.testing.assert_allclose(_np(pdq), np.asarray(jdq), atol=ATOL, rtol=RTOL)
    scale = D ** -0.5
    np.testing.assert_allclose(_np(pf.flash_dq_finalize(pdq, scale, torch.float32)),
                               np.asarray(jf.flash_dq_finalize(jdq, scale, jnp.float32)),
                               atol=ATOL, rtol=RTOL)

    # dk/dv on rank 0: every q chunk visits, each with its own out and lse
    outs, lses = [], []
    for i in range(n):
        carry = pf.flash_carry_init(b, h, CHUNK, D)
        for src in range(i + 1):
            carry = pf.flash_fwd_chunk_reference(t["q"][i], t["k"][src], t["v"][src], carry,
                                                 causal=src == i, segment_ids=ppair(i, src))
        o, lse = pf.flash_finalize(carry, torch.float32)
        outs.append(o)
        lses.append(lse)
    home = 0
    jdk = jdv = jnp.zeros((b, h, CHUNK, D), jnp.float32)
    pdk = pdv = torch.zeros(b, h_kv, CHUNK, D)
    for src in range(n):
        causal = src == home
        jdk, jdv = jf.flash_dkv_chunk(
            jnp.asarray(qc[src]), jnp.asarray(kc[home]), jnp.asarray(vc[home]),
            jnp.asarray(_np(outs[src])), jnp.asarray(doc[src]),
            jnp.asarray(_np(lses[src]))[..., None], jdk, jdv, segment_ids=jpair(src, home),
            causal=causal, block=CHUNK, interpret=True)
        pdk, pdv = pf.flash_dkv_chunk_reference(
            t["q"][src], t["k"][home], t["v"][home], outs[src], t["do"][src], lses[src], pdk,
            pdv, causal=causal, segment_ids=ppair(src, home))
        for got, want in ((pdk, jdk), (pdv, jdv)):
            want = np.asarray(want).reshape(b, h_kv, h // h_kv, CHUNK, D).sum(axis=2)
            np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=RTOL)
    jk_f, jv_f = jf.flash_dkv_finalize(jdk, jdv, scale, jnp.float32, h_kv)
    pk_f, pv_f = pf.flash_dkv_finalize(pdk, pdv, scale, torch.float32)
    np.testing.assert_allclose(_np(pk_f), np.asarray(jk_f), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_np(pv_f), np.asarray(jv_f), atol=ATOL, rtol=RTOL)


def _jax_flash(q, k, v, do, seg):
    import jax

    jseg = None if seg is None else jnp.asarray(seg)

    def f(q_, k_, v_):
        return jf.flash_attention(q_, k_, v_, True, jseg, None, True)

    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return (out,) + tuple(vjp(jnp.asarray(do)))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("h_kv", [4, 2])
@pytest.mark.parametrize("with_seg", [False, True])
def test_loopback_ring_matches_jax_flash(n, h_kv, with_seg, loopback, monkeypatch):
    """``attention(impl="flash_ring")`` on a loopback context-N topology,
    forward and backward (autograd through the ring's Function), against
    the JAX package's single-device flash in interpret mode and the port's
    ``mha_reference``: out, dq, dk and dv in fp32."""
    monkeypatch.setenv("DSTPU_FLASH_BLOCK", "128")
    b, h, s = 2, 4, 512
    q, k, v, do = _inputs(b, h, h_kv, s, D, seed=n + h_kv)
    seg = _segments(b, s, seed=3) if with_seg else None
    want = [np.asarray(a) for a in _jax_flash(q, k, v, do, seg)]
    t = params_from_numpy({"q": q, "k": k, "v": v, "do": do})
    tseg = None if seg is None else torch.from_numpy(seg)
    leaves = [t[name].clone().requires_grad_(True) for name in ("q", "k", "v")]
    ref = pcore.mha_reference(*leaves, segment_ids=tseg)
    ref_grads = torch.autograd.grad(ref, leaves, t["do"])
    loopback(n)
    calls = []
    monkeypatch.setattr(ps, "ring_forward", _spy(ps.ring_forward, calls))
    out = pcore.attention(*leaves, segment_ids=tseg, impl="flash_ring")
    grads = torch.autograd.grad(out, leaves, t["do"])
    assert calls == [n]  # the ring ran, over n ranks
    for got, w, r, what in zip((out,) + grads, want, (ref,) + ref_grads,
                               ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(_np(got), w, atol=ATOL, rtol=RTOL, err_msg=what)
        np.testing.assert_allclose(_np(got), _np(r), atol=ATOL, rtol=RTOL, err_msg=what)


def _spy(fn, calls):
    def wrapped(ring, qs, *rest):
        calls.append(len(qs))
        return fn(ring, qs, *rest)

    return wrapped


def test_ring_contract_raises(loopback):
    """What the ring cannot do raises, in the ring and in the dispatch:
    non-causal, a window, ALiBi, a dense bias, a sequence the context axis
    does not divide."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 256, D, seed=0))
    loopback(4)
    for kw, err, match in (
            ({"causal": False}, NotImplementedError, "causal=False"),
            ({"window": 64}, NotImplementedError, "sliding window"),
            ({"alibi_slopes": torch.ones(4)}, NotImplementedError, "ALiBi"),
    ):
        with pytest.raises(err, match=match):
            ps.ring_flash_attention(q, k, v, **kw)
        with pytest.raises(err, match=match):
            pcore.attention(q, k, v, impl="flash_ring", **kw)
    with pytest.raises(NotImplementedError, match="bias"):
        pcore.attention(q, k, v, impl="flash_ring", bias=torch.zeros(1, 4, 256, 256))
    with pytest.raises(ValueError, match="do not divide"):
        ps.ring_flash_attention(q[:, :, :254], k[:, :, :254], v[:, :, :254])


def test_auto_alibi_on_a_context_axis_raises(loopback):
    """A ring-eligible "auto" call with ALiBi takes the ring, as the JAX
    rule sends it, and the ring refuses ALiBi: it never falls through to
    the single-device kernel over this rank's keys alone."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 256, D, seed=0))
    loopback(2)  # chunks of 128 rows: whole tiles, so "auto" takes the ring
    for impl in (None, "auto"):
        with pytest.raises(NotImplementedError, match="queue 2, item 1"):
            pcore.attention(q, k, v, impl=impl, alibi_slopes=torch.ones(4))


def test_context_one_takes_the_single_path(monkeypatch):
    """With a context axis of 1 the ring is the single flash call: the
    Function is never applied and the result is flash_attention's."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 256, D, seed=1))
    monkeypatch.setattr(ps.RingAttention, "apply", None)
    set_topology(Topology(context=1, loopback=True))
    try:
        got = pcore.attention(q, k, v, impl="flash_ring")
    finally:
        reset_topology()
    torch.testing.assert_close(got, pf.flash_attention(q, k, v), atol=0, rtol=0)
    assert ps.ring_attention_local(q, k, v, axis_size=1).equal(got)


def test_auto_promotes_to_the_ring(loopback, monkeypatch):
    """"auto" on a context > 1 topology takes the ring where the JAX rule
    allows it ((s / N) % 128 == 0, causal, no bias or window) and equals the
    explicit "flash_ring" exactly; elsewhere it stays the reference."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 512, D, seed=2))
    loopback(4)
    calls = []
    monkeypatch.setattr(ps, "ring_forward", _spy(ps.ring_forward, calls))
    auto = pcore.attention(q, k, v)
    assert calls == [4]
    assert auto.equal(pcore.attention(q, k, v, impl="flash_ring"))
    calls.clear()
    pcore.attention(q[:, :, :256], k[:, :, :256], v[:, :, :256])  # chunks of 64
    pcore.attention(q, k, v, window=64)
    assert calls == []


def test_model_auto_promotes_to_the_ring(loopback, monkeypatch):
    """The JAX package's ``test_auto_impl_promotes_to_ring_on_context_mesh``
    on the port: a tiny model whose attention_impl is "auto" takes the ring
    on a context-4 topology (even at chunks of 16 rows), and its loss
    equals the explicit "flash_ring" loss exactly."""
    from deepspeed_tpu_torch.models import transformer as T

    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 64, size=(4, 65)))
    losses = {}
    calls = []
    monkeypatch.setattr(ps, "ring_forward", _spy(ps.ring_forward, calls))
    loopback(4)
    for impl in ("auto", "flash_ring"):
        cfg = T.TransformerConfig(vocab_size=64, hidden_size=32, n_layers=1, n_heads=4,
                                  max_seq_len=64, dtype="float32", attention_impl=impl,
                                  remat=False)
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        losses[impl] = float(T.make_loss_fn(cfg)(params, {"input_ids": toks}))
    assert calls == [4, 4]
    assert losses["auto"] == losses["flash_ring"]


def test_model_ring_refusals(loopback):
    """The model's ring branch refuses what the JAX model refuses."""
    from deepspeed_tpu_torch.models import transformer as T

    loopback(2)
    toks = torch.zeros(1, 17, dtype=torch.long)
    for over, match in ((dict(attn_causal=False), "causal-only"),
                        (dict(sliding_window=8), "sliding_window")):
        cfg = T.TransformerConfig(vocab_size=64, hidden_size=32, n_layers=1, n_heads=4,
                                  max_seq_len=64, dtype="float32", attention_impl="flash_ring",
                                  remat=False, **over)
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(NotImplementedError, match=match):
            T.make_loss_fn(cfg)(params, {"input_ids": toks})


def test_forward_tiles_are_the_kernel_sources():
    """The tiles ``sharded.py``'s bit contract cites are the kernels': the
    forward's per head dim (``flash.FWD_TILES``) are the ``FwdTiles``
    specialisations of ``csrc/flash_hopper.cuh`` and the backward's
    (``flash.BWD_TILES``) the ``BwdTiles`` ones of ``flash_hopper_bwd.cuh``,
    both read from the files; ``ring_matches_flash`` holds exactly at chunks
    of whole tiles of the forward's keys, dq's keys and dk/dv's queries."""
    src = (CSRC / "flash_hopper.cuh").read_text()
    found = {int(d): dict(bq=int(bq), bk=int(bk), stages=int(st)) for d, bq, bk, st in re.findall(
        r"struct FwdTiles<(\d+)> \{\s*static constexpr int BQ = (\d+), BK = (\d+), "
        r"STAGES = (\d+);", src)}
    assert found == pf.FWD_TILES
    src = (CSRC / "flash_hopper_bwd.cuh").read_text()
    found = {int(d): dict(bq=int(bq), bk=int(bk), kv_bk=int(kbk), kv_bq=int(kbq), stages=int(st),
                          kv_stages=int(kst))
             for d, bq, bk, kbk, kbq, st, kst in re.findall(
                 r"struct BwdTiles<(\d+)> \{\s*static constexpr int BQ = (\d+), BK = (\d+), "
                 r"KV_BK = (\d+), KV_BQ = (\d+), STAGES = (\d+), KV_STAGES = (\d+);", src)}
    assert found == pf.BWD_TILES
    assert set(pf.BWD_TILES) == set(pf.FWD_TILES)
    for d, tiles in pf.FWD_TILES.items():
        bwd = pf.BWD_TILES[d]
        whole = int(np.lcm.reduce([tiles["bk"], bwd["bk"], bwd["kv_bq"]]))
        assert all(ps.ring_matches_flash(m * whole, d) for m in (1, 2, 3, 32))
        assert not any(ps.ring_matches_flash(c, d) for c in (whole - 16, whole + 16))
        # "auto" promotes at multiples of 128 rows: whole tiles at every d
        assert 128 % whole == 0 and ps.ring_matches_flash(128, d)
    # a chunk of 192 rows: whole tiles at d 256 (64-key forward tiles), not
    # of the 128-key forward tiles at d 128
    assert not ps.ring_matches_flash(192, 128) and ps.ring_matches_flash(192, 256)


@pytest.mark.parametrize("d", sorted(pf.BWD_TILES))
@pytest.mark.parametrize("h_kv", [4, 2])
def test_backward_ring_over_whole_tiles_streams_as_one(d, h_kv):
    """The backward kernels' tile schedule on the plain chunk versions, in
    fp32: each query tile of dq's key-tile width streamed over the key tiles
    (the diagonal one causal), and each key tile of dk/dv streamed over the
    query tiles of its width, query tile outer and the GQA group's heads
    inner, their raw fp32 carries stored and reloaded at every hop of a ring
    of N chunks of whole tiles (dq: key chunks 0 .. i; dk/dv: query chunks
    i .. N-1), equal one long stream over the whole sequence bit for bit,
    with h_kv < h too; and the long streams finalized are the plain flash
    backward."""
    tiles = pf.BWD_TILES[d]
    bk, bq = tiles["bk"], tiles["kv_bq"]
    n, chunk = 4, 128
    s, h = n * chunk, 4
    group = h // h_kv
    assert ps.ring_matches_flash(chunk, d)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, h, h_kv, s, d, seed=d + h_kv))
    out, lse = pf.flash_fwd_reference(q, k, v)

    def fold_dq(acc, qi, k0, k1):  # query tile [qi, qi + bk) over key tiles in [k0, k1)
        rows = slice(qi, qi + bk)
        for kj in range(k0, min(k1, qi + bk), bk):
            keys = slice(kj, kj + bk)
            acc = pf.flash_dq_chunk_reference(
                q[:, :, rows], k[:, :, keys], v[:, :, keys], out[:, :, rows], do[:, :, rows],
                lse[:, :, rows], acc, causal=kj == qi)
        return acc

    def fold_dkv(acc, kj, q0, q1):  # key tile [kj, kj + bq) over query tiles in [q0, q1)
        keys = slice(kj, kj + bq)
        for qi in range(max(q0, kj), q1, bq):
            rows = slice(qi, qi + bq)
            for g in range(group):  # the group's heads inner
                heads = [kv * group + g for kv in range(h_kv)]
                acc = pf.flash_dkv_chunk_reference(
                    q[:, heads, rows], k[:, :, keys], v[:, :, keys], out[:, heads, rows],
                    do[:, heads, rows], lse[:, heads, rows], *acc, causal=qi == kj)
        return acc

    fresh_dq = lambda: torch.zeros(1, h, bk, d)  # noqa: E731
    fresh_dkv = lambda: (torch.zeros(1, h_kv, bq, d), torch.zeros(1, h_kv, bq, d))  # noqa: E731
    one_dq = {qi: fold_dq(fresh_dq(), qi, 0, s) for qi in range(0, s, bk)}
    one_dkv = {kj: fold_dkv(fresh_dkv(), kj, 0, s) for kj in range(0, s, bq)}
    ring_dq = {qi: fresh_dq() for qi in one_dq}
    ring_dkv = {kj: fresh_dkv() for kj in one_dkv}
    for home in range(n):
        for visitor in range(home + 1):  # ring A: key chunks 0 .. home, the diagonal last
            for qi in range(home * chunk, (home + 1) * chunk, bk):
                ring_dq[qi] = fold_dq(ring_dq[qi].clone(), qi, visitor * chunk,
                                      (visitor + 1) * chunk)
        for visitor in range(home, n):  # ring B: query chunks home .. N-1, the diagonal first
            for kj in range(home * chunk, (home + 1) * chunk, bq):
                ring_dkv[kj] = fold_dkv(tuple(t.clone() for t in ring_dkv[kj]), kj,
                                        visitor * chunk, (visitor + 1) * chunk)
    for qi in one_dq:
        assert torch.equal(one_dq[qi], ring_dq[qi]), qi
    for kj in one_dkv:
        assert all(torch.equal(a, b) for a, b in zip(one_dkv[kj], ring_dkv[kj])), kj
    sc = d ** -0.5
    dq = torch.cat([one_dq[qi] for qi in sorted(one_dq)], dim=2) * sc
    dk = torch.cat([one_dkv[kj][0] for kj in sorted(one_dkv)], dim=2) * sc
    dv = torch.cat([one_dkv[kj][1] for kj in sorted(one_dkv)], dim=2)
    for got, want in zip((dq, dk, dv), pf.flash_bwd_reference(q, k, v, out, do, lse)):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("d", sorted(pf.FWD_TILES))
def test_ring_over_whole_key_tiles_streams_as_one(d):
    """The kernels' tile schedule on the plain chunk version: each query
    tile of the forward's key-tile width streamed over the key tiles (the
    diagonal one causal), its fp32 carry stored and reloaded at every hop of
    a ring of N chunks of whole tiles, visiting chunks in ascending order,
    equals one long stream over the whole sequence bit for bit; and the long
    stream is the plain flash forward in fp32."""
    tile = pf.FWD_TILES[d]["bk"]
    n, chunk = 4, 2 * tile
    s = n * chunk
    assert ps.ring_matches_flash(chunk, d)
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 4, 2, s, d, seed=d))

    def fold(carry, qi, k0, k1):
        for kj in range(k0, min(k1, qi + tile), tile):
            carry = pf.flash_fwd_chunk_reference(
                q[:, :, qi:qi + tile], k[:, :, kj:kj + tile], v[:, :, kj:kj + tile], carry,
                causal=kj == qi)
        return carry

    fresh = lambda: pf.flash_carry_init(1, 4, tile, d)  # noqa: E731
    one = {qi: fold(fresh(), qi, 0, s) for qi in range(0, s, tile)}
    ring = {qi: fresh() for qi in range(0, s, tile)}
    for home in range(n):
        for visitor in range(home + 1):
            for qi in range(home * chunk, (home + 1) * chunk, tile):
                stored = tuple(t.clone() for t in ring[qi])
                ring[qi] = fold(stored, qi, visitor * chunk, (visitor + 1) * chunk)
    for qi in one:
        assert all(torch.equal(a, b) for a, b in zip(one[qi], ring[qi])), qi
    out = torch.cat([pf.flash_finalize(one[qi], torch.float32)[0] for qi in sorted(one)], dim=2)
    lse = torch.cat([pf.flash_finalize(one[qi], torch.float32)[1] for qi in sorted(one)], dim=2)
    want_out, want_lse = pf.flash_fwd_reference(q, k, v)
    torch.testing.assert_close(out, want_out, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, want_lse, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def _cuda_inputs(b, h, h_kv, s, d, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(*sh, generator=gen, device="cuda").bfloat16()
                 for sh in ((b, h, s, d), (b, h_kv, s, d), (b, h_kv, s, d), (b, h, s, d)))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_seg", [False, True])
def test_cuda_chunk_kernels_match_plain(causal, with_seg):
    """Each chunk kernel, raw and finalized, against its plain version
    (bf16 inputs; chip_smoke's tolerances)."""
    _card()
    b, h, h_kv, s, d = 1, 8, 2, 256, 128
    q, k, v, do = _cuda_inputs(b, h, h_kv, s, d, seed=7)
    seg = None
    if with_seg:
        seg = (torch.zeros(b, s, dtype=torch.int32, device="cuda"),
               torch.zeros(b, s, dtype=torch.int32, device="cuda"))
        seg[0][:, 100:] = 1
        seg[1][:, 40:] = 1
    kw = dict(segment_ids=seg, causal=causal)
    errs = chip_smoke.carry_case(torch, q, k, v, do, kw)
    assert all(np.isfinite(list(errs.values())))


@pytest.mark.cuda
@pytest.mark.parametrize("h_kv", [8, 2])
def test_cuda_ring_is_the_single_kernel_bit_for_bit(h_kv, loopback):
    """The loopback ring (N 4, chunks of 128) against the single flash
    kernels: out, lse, dq, dk and dv bit for bit, with GQA (h_kv 2) too."""
    _card()
    q, k, v, do = _cuda_inputs(1, 8, h_kv, 512, 128, seed=3)
    loopback(4)
    res = chip_smoke.ring_against_flash(torch, q, k, v, do)
    assert all(res[f"{what}_bitwise"] for what in ("out", "lse", "dq", "dk", "dv")), res


def test_bwd_tiles_tool_rewrites_one_specialisation():
    """``tools/torch_flash_bwd_tiles.py`` (the card's timing of other
    backward tiles) rewrites exactly the fields it is given of one
    ``BwdTiles`` specialisation of the real header, or of its register
    split, and its default variants name existing head dims and fields."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import torch_flash_bwd_tiles as tool

    text = (CSRC / "flash_hopper_bwd.cuh").read_text()
    out = tool.rewrite_tiles(text, 256, {"KV_BQ": 32, "KV_STAGES": 3})
    assert out != text and len(out.splitlines()) == len(text.splitlines())
    changed = [(a, b) for a, b in zip(text.splitlines(), out.splitlines()) if a != b]
    assert len(changed) == 1 and "KV_BQ = 32" in changed[0][1] and "KV_STAGES = 3" in changed[0][1]
    assert "BK = 32, KV_BK = 64" in changed[0][1]
    assert tool.rewrite_tiles(text, 128, {}) == text
    regs = tool.rewrite_tiles(text, 128, {"CONSUMER_REGS": 240, "PRODUCER_REGS": 24})
    changed = [b for a, b in zip(text.splitlines(), regs.splitlines()) if a != b]
    assert changed == ["constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;"]
    for spec in tool.DEFAULT:
        name, d, over = tool.parse(spec)
        assert d in pf.BWD_TILES and over and tool.rewrite_tiles(text, d, over) != text
    with pytest.raises(SystemExit):
        tool.parse("x=128:TILE=3")
