"""Paged attention of the PyTorch port against the JAX package.

The same pools, tables and queries, made from a seed with numpy, go through
the port's ``paged_attention(impl="kernel")`` (a CPU tensor: the kernel's
plain version, which the CUDA kernel is held to on the card) and the JAX
package's ``paged_attention(impl="kernel", interpret=True)``, the Pallas
``_paged_kernel`` in interpret mode; and through the plain gathers of both
packages (dense decode, chunk attention, reference).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.attention import paged_pallas as jx
from deepspeed_tpu_torch.ops.attention import paged as pt

# fp32 everywhere: fp32 scores and online vs one-shot softmax differ only
# in summation order (a few fp32 units in the last place of O(1) outputs)
ATOL = RTOL = 2e-5


def _world(seed, T, nh, nkv, d, bs, NB, B, E=0):
    """A pool of NB blocks + the trash block (id NB), per-token tables of
    distinct blocks, queries and E extra columns."""
    rng = np.random.default_rng(seed)
    w = {
        "q": rng.normal(size=(T, nh, d)).astype(np.float32),
        "k": rng.normal(size=(NB + 1, bs, nkv, d)).astype(np.float32),
        "v": rng.normal(size=(NB + 1, bs, nkv, d)).astype(np.float32),
        "trash": NB,
    }
    tables = np.full((T, B), NB, np.int32)
    pos = rng.integers(0, B * bs, size=T).astype(np.int32)
    for t in range(T):
        n = pos[t] // bs + 1
        tables[t, :n] = rng.permutation(NB)[:n]
    w["tables"], w["pos"] = tables, pos
    if E:
        w["ke"] = rng.normal(size=(T, E, nkv, d)).astype(np.float32)
        w["ve"] = rng.normal(size=(T, E, nkv, d)).astype(np.float32)
    return w, rng


def _both(w, extras=None, limit=None, **kw):
    """(port, jax) outputs of the kernel path for one world."""
    pj = dict(kw)
    pp = dict(kw)
    if extras is not None:
        pj["extra_kv"] = (jnp.asarray(w["ke"]), jnp.asarray(w["ve"]), jnp.asarray(extras))
        pp["extra_kv"] = (torch.from_numpy(w["ke"]), torch.from_numpy(w["ve"]),
                          torch.from_numpy(extras))
    if limit is not None:
        pj["pool_limit"] = jnp.asarray(limit)
        pp["pool_limit"] = torch.from_numpy(limit)
    want = jx.paged_attention(
        jnp.asarray(w["q"]), jnp.asarray(w["k"]), jnp.asarray(w["v"]),
        jnp.asarray(w["tables"]), jnp.asarray(w["pos"]), w["trash"],
        impl="kernel", interpret=True, **pj,
    )
    got = pt.paged_attention(
        torch.from_numpy(w["q"]), torch.from_numpy(w["k"]), torch.from_numpy(w["v"]),
        torch.from_numpy(w["tables"]), torch.from_numpy(w["pos"]), w["trash"],
        impl="kernel", **pp,
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("nh,nkv", [(4, 4), (4, 2), (8, 2)])
def test_causal_gqa_with_trash_rows(nh, nkv):
    w, _ = _world(nh * 10 + nkv, T=5, nh=nh, nkv=nkv, d=16, bs=8, NB=12, B=3)
    w["tables"][2] = w["trash"]  # an all-trash row
    got, want = _both(w)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert not got[2].any(), "an all-trash row must give exactly 0"


@pytest.mark.parametrize("E", [1, 4])
def test_pool_limit_and_extras(E):
    """The engine's write-after-read form: pool below ``limit``, extras at
    their positions (some -1), padded slots at q_pos = -1 see nothing."""
    w, rng = _world(E, T=6, nh=4, nkv=2, d=16, bs=8, NB=16, B=3, E=E)
    limit = (w["pos"] - rng.integers(0, 3, size=6)).clip(0).astype(np.int32)
    epos = (limit[:, None] + np.arange(E)[None]).astype(np.int32)
    epos[:, -1] = -1  # the last extra column is invalid everywhere
    if E > 1:
        epos[1, :] = -1
    w["pos"][4] = -1  # a padded decode slot
    w["pos"] = np.maximum(w["pos"], np.where(epos >= 0, epos, -1).max(axis=1)).astype(np.int32)
    w["pos"][4] = -1
    got, want = _both(w, extras=epos, limit=limit)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert not got[4].any(), "a slot at q_pos = -1 must give exactly 0"


def test_window_and_scale_override():
    w, rng = _world(5, T=6, nh=4, nkv=2, d=16, bs=8, NB=16, B=4, E=2)
    epos = np.stack([w["pos"] - 1, w["pos"]], axis=1).astype(np.int32)
    limit = np.maximum(w["pos"] - 1, 0).astype(np.int32)
    got, want = _both(w, extras=epos, limit=limit, window=8, scale=0.3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    got, want = _both(w, window=8)  # causal form with the window
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_all_masked_by_window_gives_zero():
    """A window that leaves no key: the online softmax must not turn the
    finite -1e30 fill into NaN, and the row must be exactly 0."""
    w, _ = _world(6, T=3, nh=4, nkv=2, d=16, bs=8, NB=8, B=2, E=1)
    epos = np.full((3, 1), -1, np.int32)
    limit = np.zeros(3, np.int32)
    got, want = _both(w, extras=epos, limit=limit)
    assert np.isfinite(got).all() and not got.any()
    np.testing.assert_array_equal(got, np.asarray(want))


def test_padded_slot_with_pool_limit_sees_nothing():
    """A slot at q_pos = -1 with a pool limit above 0: the Pallas kernel
    masks the whole pool, the JAX dense gather does not (it checks only
    kpos < limit). The port's dense path follows the kernel, since it is
    the kernel's plain version; the engine never passes this combination
    (its padded slots carry limit -1)."""
    w, _ = _world(12, T=3, nh=4, nkv=2, d=16, bs=8, NB=8, B=2)
    w["pos"][1] = -1
    limit = np.array([3, 9, 5], np.int32)
    got, want = _both(w, limit=limit)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert not got[1].any()
    jax_dense = np.asarray(jx.paged_decode_attention_dense(
        *(jnp.asarray(w[a]) for a in ("q", "k", "v", "tables", "pos")), w["trash"],
        pool_limit=jnp.asarray(limit),
    ))
    assert jax_dense[1].any(), "the JAX dense gather's difference this test pins"


def test_dense_decode_matches_jax_dense():
    w, rng = _world(8, T=5, nh=8, nkv=4, d=16, bs=8, NB=12, B=3, E=2)
    epos = np.stack([w["pos"], -np.ones(5, np.int32)], axis=1).astype(np.int32)
    want = jx.paged_decode_attention_dense(
        jnp.asarray(w["q"]), jnp.asarray(w["k"]), jnp.asarray(w["v"]),
        jnp.asarray(w["tables"]), jnp.asarray(w["pos"]), w["trash"], window=8,
        extra_kv=(jnp.asarray(w["ke"]), jnp.asarray(w["ve"]), jnp.asarray(epos)),
        pool_limit=jnp.asarray(w["pos"]),
    )
    got = pt.paged_decode_attention_dense(
        torch.from_numpy(w["q"]), torch.from_numpy(w["k"]), torch.from_numpy(w["v"]),
        torch.from_numpy(w["tables"]), torch.from_numpy(w["pos"]), w["trash"], window=8,
        extra_kv=(torch.from_numpy(w["ke"]), torch.from_numpy(w["ve"]), torch.from_numpy(epos)),
        pool_limit=torch.from_numpy(w["pos"]),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_reference_matches_jax_reference():
    w, _ = _world(9, T=4, nh=4, nkv=2, d=16, bs=8, NB=10, B=3)
    args = ("q", "k", "v", "tables", "pos")
    want = jx.paged_attention_reference(*(jnp.asarray(w[a]) for a in args), w["trash"],
                                        window=5, scale=0.2)
    got = pt.paged_attention_reference(*(torch.from_numpy(w[a]) for a in args), w["trash"],
                                       window=5, scale=0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("window", [0, 6])
def test_chunk_attention_matches_jax(window):
    """Prefill chunks: pool below the chunk start + in-chunk causal over the
    chunk's fresh K/V, padded tail tokens (q_pos = -1) give 0."""
    rng = np.random.default_rng(10 + window)
    Rc, tq, nh, nkv, d, bs, NB, B = 2, 8, 4, 2, 16, 8, 12, 3
    q = rng.normal(size=(Rc, tq, nh, d)).astype(np.float32)
    k = rng.normal(size=(NB + 1, bs, nkv, d)).astype(np.float32)
    v = rng.normal(size=(NB + 1, bs, nkv, d)).astype(np.float32)
    ke = rng.normal(size=(Rc, tq, nkv, d)).astype(np.float32)
    ve = rng.normal(size=(Rc, tq, nkv, d)).astype(np.float32)
    tables = np.stack([rng.permutation(NB)[:B] for _ in range(Rc)]).astype(np.int32)
    tables[1, 2] = NB
    start = np.array([5, 9], np.int32)
    pos = start[:, None] + np.arange(tq)[None]
    pos[1, 6:] = -1  # padded tail
    pos = pos.astype(np.int32)
    want = jx.paged_chunk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables), jnp.asarray(pos),
        NB, window=window, new_kv=(jnp.asarray(ke), jnp.asarray(ve)),
        pool_limit=jnp.asarray(start),
    )
    got = pt.paged_chunk_attention(
        *(torch.from_numpy(a) for a in (q, k, v, tables, pos)), NB, window=window,
        new_kv=(torch.from_numpy(ke), torch.from_numpy(ve)), pool_limit=torch.from_numpy(start),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert not got[1, 6:].any()
    # the legacy form: the pool already holds the chunk, causal <=
    want = jx.paged_chunk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables), jnp.asarray(pos),
        NB, window=window,
    )
    got = pt.paged_chunk_attention(
        *(torch.from_numpy(a) for a in (q, k, v, tables, pos)), NB, window=window
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_dispatch_contract():
    w, _ = _world(11, T=2, nh=4, nkv=2, d=16, bs=8, NB=4, B=2)
    args = [torch.from_numpy(w[a]) for a in ("q", "k", "v", "tables", "pos")] + [w["trash"]]
    dense = pt.paged_attention(*args, impl="dense")
    torch.testing.assert_close(pt.paged_attention(*args), dense, atol=0, rtol=0)
    torch.testing.assert_close(pt.paged_attention(*args, impl="kernel"), dense, atol=0, rtol=0)
    with pytest.raises(ValueError, match="unknown impl"):
        pt.paged_attention(*args, impl="pallas")
    with pytest.raises(ValueError, match="reference"):
        pt.paged_attention(*args, impl="reference", pool_limit=args[4])
    with pytest.raises(ValueError, match="not int8"):
        pt.paged_attention(*args, k_scale=torch.ones(5, 8, 2), v_scale=torch.ones(5, 8, 2))
    int8_pool = [args[0], args[1].to(torch.int8), args[2].to(torch.int8)] + args[3:]
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        pt.paged_attention(*int8_pool, k_scale=torch.ones(5, 8, 2))


@pytest.mark.parametrize("impl,device,d,want", [
    ("auto", "cuda", 128, "kernel"),
    (None, "cuda", 64, "kernel"),
    ("auto", "cpu", 96, "dense"),
    ("dense", "cuda", 96, "dense"),  # the plain gather on a card only when asked for
    ("kernel", "cpu", 128, "kernel"),  # runs the kernel's plain version on a CPU tensor
    ("auto", "cuda", 96, NotImplementedError),  # never the plain gather by default
    ("auto", "cuda", 80, NotImplementedError),
])
def test_resolve_impl(impl, device, d, want):
    if want is NotImplementedError:
        with pytest.raises(NotImplementedError, match="ROADMAP queue 2, item 3"):
            pt.resolve_impl(impl, device, d)
    else:
        assert pt.resolve_impl(impl, device, d) == want


@pytest.mark.cuda
def test_auto_refuses_an_unported_head_dim_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q = torch.zeros(2, 4, 96, device="cuda")
    pool = torch.zeros(3, 8, 2, 96, device="cuda")
    tables = torch.zeros(2, 1, dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError, match="head_dim 96"):
        pt.paged_attention(q, pool, pool, tables, tables[:, 0], 2)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    for d in pt.KERNEL_HEAD_DIMS:
        w, rng = _world(d, T=6, nh=8, nkv=2, d=d, bs=16, NB=12, B=3, E=3)
        epos = np.stack([w["pos"] - 1, w["pos"], -np.ones(6, np.int32)], 1).astype(np.int32)
        limit = np.maximum(w["pos"] - 1, 0).astype(np.int32)
        cu = {k: torch.as_tensor(v).cuda() for k, v in w.items() if k != "trash"}
        kw = dict(extra_kv=(cu["ke"], cu["ve"], torch.as_tensor(epos).cuda()),
                  pool_limit=torch.as_tensor(limit).cuda(), window=10)
        args = [cu[a] for a in ("q", "k", "v", "tables", "pos")] + [w["trash"]]
        before = pt.PAGED_KERNEL.launches
        got = pt.paged_decode(*args, **kw)
        assert pt.PAGED_KERNEL.launches == before + 1
        torch.testing.assert_close(got, pt.paged_decode_attention_dense(*args, **kw),
                                   atol=ATOL, rtol=RTOL)
