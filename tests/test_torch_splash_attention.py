"""Splash attention of the PyTorch port against the JAX package.

The same inputs, made from a seed with numpy, go through the port's numpy
copies (masks, schedules, sparsity configs), its plain forward and
backward (``splash_fwd_reference``/``splash_bwd_reference``, the versions
the CUDA kernels are held to on the card), its autograd ``splash_attention``
on CPU tensors and the ``attention`` seam, and through the JAX package's
``splash_attention(..., interpret=True)`` and its ``jax.vjp``, as
``tests/unit/ops/test_splash_attention.py`` runs them.
"""

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from deepspeed_tpu.ops.attention import core as jcore  # noqa: E402
from deepspeed_tpu.ops.sparse_attention import mask as jmask  # noqa: E402
from deepspeed_tpu_torch.ops.attention import core as pcore  # noqa: E402
from deepspeed_tpu_torch.ops.sparse_attention import mask as pmask  # noqa: E402
from deepspeed_tpu_torch.ops.sparse_attention import splash as ps  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the packages, not the functions that each package's ``ops`` exports under
# the same name
jsa = importlib.import_module("deepspeed_tpu.ops.sparse_attention")
psa = importlib.import_module("deepspeed_tpu_torch.ops.sparse_attention")

# fp32 on both sides: the same products, summed in another order (the
# Pallas body streams kv blocks with an online max; the plain version
# takes one softmax over the row)
FP32_ATOL = FP32_RTOL = 2e-5
BF16_ATOL = BF16_RTOL = 2.0 ** -6
S, BLOCK = 256, 64


def _both(name, *args, **kw):
    """The same mask built in both packages."""
    return getattr(jmask, name)(*args, **kw), getattr(pmask, name)(*args, **kw)


MASKS = {
    "full": lambda: _both("FullMask", (S, S)),
    "causal": lambda: _both("CausalMask", (S, S)),
    "local96": lambda: _both("LocalMask", (S, S), 96),
    "local64": lambda: _both("LocalMask", (S, S), 64),
    "document": lambda: _both("DocumentMask", [0] * 100 + [1] * 60 + [2] * 96),
    "document_non_monotone": lambda: _both("DocumentMask", [0, 1] * 128),
    "local_and_causal": lambda: tuple(
        a & b for a, b in zip(_both("LocalMask", (S, S), 80), _both("CausalMask", (S, S)))),
    "layout": lambda: _both("LayoutMask", np.eye(4, dtype=np.int32), 64),
}


@pytest.mark.parametrize("bq,bk", [(64, 64), (32, 64)])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_masks_match_jax(name, bq, bk):
    jm, pm = MASKS[name]()
    np.testing.assert_array_equal(pm.block_status(bq, bk), jm.block_status(bq, bk))
    np.testing.assert_array_equal(pm.token_mask(), jm.token_mask())
    assert (pm.causal, pm.window) == (jm.causal, jm.window)


def _same_schedule(p, j):
    for f in ("seq_q", "seq_kv", "block_q", "block_kv", "causal", "window"):
        assert getattr(p, f) == getattr(j, f), f
    for f in ("kv_index", "step_kind", "q_index", "step_kind_t"):
        np.testing.assert_array_equal(getattr(p, f), getattr(j, f), err_msg=f)
    if j.segment_ids is None:
        assert p.segment_ids is None
    else:
        np.testing.assert_array_equal(p.segment_ids, j.segment_ids)


@pytest.mark.parametrize("name", sorted(MASKS))
def test_schedules_match_jax(name):
    jm, pm = MASKS[name]()
    _same_schedule(psa.schedule_from_mask(pm, BLOCK), jsa.schedule_from_mask(jm, BLOCK))


def test_multi_head_schedule_matches_jax():
    heads = [np.eye(4, dtype=np.int32), np.ones((4, 4), np.int32), np.tril(np.ones((4, 4)))]
    jm = jsa.MultiHeadMask([jsa.LayoutMask(h_, 64) for h_ in heads])
    pm = psa.MultiHeadMask([psa.LayoutMask(h_, 64) for h_ in heads])
    _same_schedule(psa.schedule_from_mask(pm, 64), jsa.schedule_from_mask(jm, 64))
    with pytest.raises(ValueError, match="predicate"):
        psa.MultiHeadMask([psa.CausalMask((S, S)), psa.LocalMask((S, S), 96)])


CONFIGS = {
    "dense": ("DenseSparsityConfig", dict(num_heads=4, block=32)),
    "fixed": ("FixedSparsityConfig", dict(num_heads=4, block=32, num_local_blocks=4,
                                          num_global_blocks=1)),
    "fixed_per_head_uni": ("FixedSparsityConfig", dict(
        num_heads=4, block=32, different_layout_per_head=True, num_different_global_patterns=4,
        attention="unidirectional", horizontal_global_attention=True)),
    "bslongformer": ("BSLongformerSparsityConfig", dict(
        num_heads=4, block=32, num_sliding_window_blocks=3, global_block_indices=(0, 5),
        global_block_end_indices=(2, 7))),
    "bigbird": ("BigBirdSparsityConfig", dict(num_heads=4, block=32, num_random_blocks=2,
                                              seed=7)),
    "bigbird_per_head_uni": ("BigBirdSparsityConfig", dict(
        num_heads=4, block=32, num_random_blocks=3, different_layout_per_head=True,
        attention="unidirectional", seed=3)),
    "variable": ("VariableSparsityConfig", dict(
        num_heads=4, block=32, num_random_blocks=1, local_window_blocks=(2, 3, 4),
        global_block_indices=(1,), horizontal_global_attention=True, seed=5)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sparsity_configs_match_jax(name):
    """Every family's layout, BigBird's and Variable's seeded random blocks
    included, bit for bit, and the schedule it compiles into."""
    cls, kw = CONFIGS[name]
    jc, pc = getattr(jsa, cls)(**kw), getattr(psa, cls)(**kw)
    np.testing.assert_array_equal(pc.make_layout(512), jc.make_layout(512))
    _same_schedule(pc.make_schedule(512), jc.make_schedule(512))
    _same_schedule(pc.make_schedule(512, block_q=16, block_kv=32),
                   jc.make_schedule(512, block_q=16, block_kv=32))


def test_device_arrays_are_uploaded_once():
    sched = psa.schedule_from_mask(psa.LocalMask((S, S), 96), BLOCK)
    first = psa.schedule.device_arrays(sched, "cpu")
    assert all(a.dtype == torch.int32 and a.is_contiguous() for a in first)
    np.testing.assert_array_equal(first[0].numpy(), sched.kv_index)
    np.testing.assert_array_equal(first[3].numpy(), sched.step_kind_t)
    assert all(a is b for a, b in zip(first, psa.schedule.device_arrays(sched, "cpu")))


def test_forward_only_schedules_upload_the_forward_arrays():
    """A forward-only caller uploads kv_index and step_kind and nothing
    else; the plain versions' status shares the same per-schedule cache."""
    sched = ps.prefill_schedule(40, 8, S, 48, 32)
    kvi, kind = psa.schedule.device_arrays(sched, "cpu", ("kv_index", "step_kind"))
    np.testing.assert_array_equal(kind.numpy(), sched.step_kind)
    assert set(psa.schedule._DEVICE_ARRAYS[sched]) == {("kv_index", "cpu"), ("step_kind", "cpu")}
    status = ps._status_tensor(sched, "cpu")
    assert status is ps._status_tensor(sched, "cpu")
    assert ("status", "cpu") in psa.schedule._DEVICE_ARRAYS[sched]


@pytest.mark.parametrize("window", [0, 48])
def test_prefill_schedule_transpose_is_the_compacted_one(window):
    """prefill_schedule writes its one-query-block transposed schedule
    directly; it equals _compact over the swapped block status."""
    for t, start in ((1, 0), (8, 5), (32, 100), (32, S - 32), (32, 250)):
        sched = ps.prefill_schedule(start, t, S, window, 32)
        status = ps._status(sched)
        q_index, step_kind_t = psa.schedule._compact(np.swapaxes(status, 1, 2))
        np.testing.assert_array_equal(sched.q_index, q_index)
        np.testing.assert_array_equal(sched.step_kind_t, step_kind_t)
        assert sched.q_index.dtype == sched.step_kind_t.dtype == np.int32


# ---------------------------------------------------------------------------
# the plain versions and the autograd entry against the Pallas bodies
# ---------------------------------------------------------------------------
def _inputs(b, h, h_kv, s, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=sh).astype(np.float32)
                 for sh in ((b, h, s, d), (b, h_kv, s, d), (b, h_kv, s, d), (b, h, s, d)))


def _dead_layout():
    layout = np.zeros((1, 4, 4), np.int32)
    layout[0, 0, 0] = 1
    layout[0, 3, :] = 1  # query blocks 1 and 2 keep nothing
    return layout


def _bigbird():
    return psa.BigBirdSparsityConfig(num_heads=4, block=64, num_random_blocks=1,
                                     different_layout_per_head=True).make_layout(S)


SPLASH_CASES = {
    # name: (port schedule, jax schedule, runtime segment ids)
    "local_shared": lambda: (psa.schedule_from_mask(psa.LocalMask((S, S), 96), BLOCK),
                             jsa.schedule_from_mask(jsa.LocalMask((S, S), 96), BLOCK), None),
    "causal_seg_all": lambda: (psa.schedule_from_mask(psa.CausalMask((S, S)), BLOCK),
                               jsa.schedule_from_mask(jsa.CausalMask((S, S)), BLOCK),
                               np.array([[0] * 100 + [1] * 156, [0] * 200 + [1] * 56], np.int32)),
    "document_seg_schedule": lambda: (
        psa.schedule_from_mask(psa.DocumentMask([0] * 100 + [1] * 60 + [2] * 96)
                               & psa.CausalMask((S, S)), BLOCK),
        jsa.schedule_from_mask(jsa.DocumentMask([0] * 100 + [1] * 60 + [2] * 96)
                               & jsa.CausalMask((S, S)), BLOCK), None),
    "bigbird_per_head": lambda: (psa.schedule_from_layout(_bigbird(), 64, causal=True),
                                 jsa.schedule_from_layout(_bigbird(), 64, causal=True), None),
    "dead_rows": lambda: (psa.schedule_from_layout(_dead_layout(), 64),
                          jsa.schedule_from_layout(_dead_layout(), 64), None),
}


def _jax_splash(q, k, v, do, sched, seg):
    jseg = None if seg is None else jnp.asarray(seg)

    def f(q_, k_, v_):
        return jsa.splash_attention(q_, k_, v_, sched, segment_ids=jseg, interpret=True)

    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return (out,) + tuple(vjp(jnp.asarray(do)))


@pytest.mark.parametrize("case", sorted(SPLASH_CASES))
def test_plain_versions_and_function_match_jax(case):
    """fp32 at s 256, block 64, 4 query heads over 2 kv heads, d 64: the
    plain forward and backward, and the autograd Function over them (CPU
    tensors), against the Pallas bodies in interpret mode and their vjp."""
    psched, jsched, seg = SPLASH_CASES[case]()
    b = 1 if seg is None else seg.shape[0]
    q, k, v, do = _inputs(b, 4, 2, S, 64, seed=len(case))
    want = [np.asarray(a) for a in _jax_splash(q, k, v, do, jsched, seg)]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tseg = None if seg is None else torch.from_numpy(seg)
    out, lse = ps.splash_fwd_reference(tq, tk, tv, psched, segment_ids=tseg)
    grads = ps.splash_bwd_reference(tq, tk, tv, out, tdo, lse, psched, segment_ids=tseg)
    for got, w, what in zip((out,) + grads, want, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), w, atol=FP32_ATOL, rtol=FP32_RTOL, err_msg=what)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    fout = ps.splash_attention(*leaves, psched, segment_ids=tseg)
    fout.backward(tdo)
    for got, w, what in zip([fout] + [t.grad for t in leaves], want, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(got.detach().numpy(), w, atol=FP32_ATOL, rtol=FP32_RTOL,
                                   err_msg=what)
    if case == "dead_rows":
        assert not out[:, :, 64:192].any()
        assert bool((lse[:, :, 64:192] == -1e30).all())
        assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_plain_forward_is_differentiable_by_autograd():
    """forward_reference takes the plain forward with autograd (the oracle
    of attn_sparsity models): its gradients are the plain backward's."""
    psched = psa.schedule_from_layout(_bigbird(), 64, causal=True)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 4, 2, S, 64, seed=3))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = ps.splash_fwd_reference(*leaves, psched)
    out.backward(do)
    want = ps.splash_bwd_reference(q, k, v, out.detach(), do, lse.detach(), psched)
    for got, w in zip(leaves, want):
        torch.testing.assert_close(got.grad, w, atol=FP32_ATOL, rtol=FP32_RTOL)


def test_plain_versions_take_row_chunks(monkeypatch):
    """Query rows in chunks (one row of logits at a time here) give the
    one-chunk result, to fp32 rounding (the products are blocked otherwise)."""
    psched, _, seg = SPLASH_CASES["causal_seg_all"]()
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 4, 2, S, 64, seed=4))
    seg = torch.from_numpy(seg)
    whole = ps.splash_fwd_reference(q, k, v, psched, segment_ids=seg)
    whole_g = ps.splash_bwd_reference(q, k, v, whole[0], do, whole[1], psched, segment_ids=seg)
    monkeypatch.setattr(ps, "_CHUNK_ELEMS", 2 * 4 * S)
    assert len(ps._row_chunks(2, 4, S, S)) == S
    chunked = ps.splash_fwd_reference(q, k, v, psched, segment_ids=seg)
    chunked_g = ps.splash_bwd_reference(q, k, v, whole[0], do, whole[1], psched,
                                        segment_ids=seg)
    for a, b_ in zip(whole + whole_g, chunked + chunked_g):
        torch.testing.assert_close(a, b_, atol=FP32_ATOL, rtol=FP32_RTOL)


@pytest.mark.parametrize("t", [1, 8, 32])
def test_prefill_matches_jax(t):
    """The prefill form (one schedule row from the chunk start; window 48
    over S 256 in 32-key blocks) at several chunk starts, against the JAX
    package's in-jit row."""
    rng = np.random.default_rng(t)
    q = rng.normal(size=(1, 4, t, 64)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2, S, 64)).astype(np.float32) for _ in range(2))
    for start in (0, 5, 40, 100, S - t):
        want = jsa.splash_prefill_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            jnp.int32(start), window=48, block_kv=32,
                                            interpret=True)
        got = psa.splash_prefill_attention(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v), start, window=48, block_kv=32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL,
                                   rtol=FP32_RTOL, err_msg=f"start {start}")
        sched = ps.prefill_schedule(start, t, S, 48, 32)
        # the band of (48 + t) keys touches at most (48 + t - 2) // 32 + 2 blocks
        assert 1 <= sched.num_active <= (48 + t - 2) // 32 + 2 < S // 32


def test_prefill_past_the_context_drops_the_blocks_beyond_it():
    """A bucket's padded rows may run past S: those blocks are kind 0 (the
    valid rows' outputs are unchanged), never an index past the context."""
    sched = ps.prefill_schedule(250, 32, 256, 48, 32)
    assert int(sched.kv_index.max()) == 256 // 32 - 1
    full = ps.prefill_schedule(250, 32, 512, 48, 32)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 2, 32, 64)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1, 2, 512, 64)).astype(np.float32))
            for _ in range(2))
    cut = ps.splash_fwd_reference(q, k[:, :, :256], v[:, :, :256], sched, base=250)[0]
    ref = ps.splash_fwd_reference(q, k, v, full, base=250)[0]
    torch.testing.assert_close(cut[:, :, :6], ref[:, :, :6])  # rows 250..255, inside S


def test_sparse_self_attention_matches_jax():
    cfg = dict(num_heads=4, block=64, num_sliding_window_blocks=3)
    q, k, v, _ = _inputs(1, 4, 2, S, 64, seed=9)
    want = jsa.SparseSelfAttention(jsa.BSLongformerSparsityConfig(**cfg), interpret=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    mod = psa.SparseSelfAttention(psa.BSLongformerSparsityConfig(**cfg))
    got = mod(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL, rtol=FP32_RTOL)
    assert mod.get_schedule(S) is mod.get_schedule(S)
    with pytest.raises(ValueError, match="heads"):
        mod(*(torch.zeros(1, 2, S, 64) for _ in range(3)))
    # the calls the port refused before the layout kernels: an attn_mask
    # (the dense biased form) and use_splash=False (the layout kernels)
    mask = (np.random.default_rng(2).uniform(size=(S, S)) < 0.8).astype(np.float32)
    want = jsa.SparseSelfAttention(jsa.BSLongformerSparsityConfig(**cfg), interpret=True)(
        *(jnp.asarray(a) for a in (q, k, v)), attn_mask=jnp.asarray(mask))
    got = mod(*(torch.from_numpy(a) for a in (q, k, v)), attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL, rtol=FP32_RTOL)
    want = jsa.SparseSelfAttention(jsa.BSLongformerSparsityConfig(**cfg), use_splash=False,
                                   interpret=True)(*(jnp.asarray(a) for a in (q, k, v)))
    got = psa.SparseSelfAttention(psa.BSLongformerSparsityConfig(**cfg), use_splash=False)(
        *(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL, rtol=FP32_RTOL)


# ---------------------------------------------------------------------------
# the attention seam
# ---------------------------------------------------------------------------
def test_seam_derived_schedule_and_promotion_match_jax():
    q, k, v, _ = _inputs(1, 4, 2, S, 64, seed=4)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = jcore.attention(jq, jk, jv, causal=True, window=96, impl="splash")
    got = pcore.attention(tq, tk, tv, causal=True, window=96, impl="splash")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL, rtol=FP32_RTOL)
    jsched = jsa.schedule_from_mask(jsa.LocalMask((S, S), 96), BLOCK)
    psched = psa.schedule_from_mask(psa.LocalMask((S, S), 96), BLOCK)
    want = jcore.attention(jq, jk, jv, causal=True, schedule=jsched)
    got = pcore.attention(tq, tk, tv, causal=True, schedule=psched)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL, rtol=FP32_RTOL)
    assert pcore._splash_block(S) == jcore._splash_block(S) == 256
    assert pcore._splash_block(3 * 128) == jcore._splash_block(3 * 128) == 384
    assert pcore._splash_block(3 * 256) == jcore._splash_block(3 * 256) == 256


def test_seam_errors_match_jax(monkeypatch):
    q, k, v, _ = _inputs(1, 4, 4, 128, 64, seed=5)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    cases = [
        (dict(impl="splash", bias=np.zeros((1, 1, 128, 128), np.float32)), "dense bias"),
        (dict(impl="splash", window=64, window_flag=1), "window flag"),
    ]
    for kw, match in cases:
        jkw = {k_: jnp.asarray(v_) if isinstance(v_, (np.ndarray, int)) and k_ != "window"
               else v_ for k_, v_ in kw.items()}
        tkw = {k_: torch.from_numpy(v_) if isinstance(v_, np.ndarray) else v_
               for k_, v_ in kw.items()}
        with pytest.raises(ValueError, match=match):
            jcore.attention(jq, jk, jv, causal=True, **jkw)
        with pytest.raises(ValueError, match=match):
            pcore.attention(tq, tk, tv, causal=True, **tkw)
    for impl_kw in (dict(impl="splash"),
                    dict(schedule=psa.schedule_from_mask(psa.CausalMask((128, 128)), 64))):
        with pytest.raises(ValueError, match="ALiBi"):
            pcore.attention(tq, tk, tv, alibi_slopes=torch.ones(4), **impl_kw)
    with pytest.raises(ValueError, match="ALiBi"):
        jcore.attention(jq, jk, jv, alibi_slopes=jnp.ones(4), impl="splash")
    # more than one process: the head-sharded splash is the multi-GPU item
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        pcore.attention(tq, tk, tv, impl="splash")


def test_seam_promotion_falls_back_with_one_warning(monkeypatch, caplog):
    """None/"auto" with a schedule and a bias: the dense chain, as in JAX."""
    q, k, v, _ = _inputs(1, 4, 4, 128, 64, seed=6)
    bias = np.random.default_rng(0).normal(size=(1, 1, 128, 128)).astype(np.float32)
    jsched = jsa.schedule_from_mask(jsa.CausalMask((128, 128)), 64)
    psched = psa.schedule_from_mask(psa.CausalMask((128, 128)), 64)
    want = jcore.attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                           bias=jnp.asarray(bias), schedule=jsched)
    monkeypatch.setattr(pcore, "_warned_splash_fallback", False)
    from deepspeed_tpu_torch.utils.logging import logger

    monkeypatch.setattr(logger, "propagate", True)
    with caplog.at_level("WARNING"):
        for _ in range(2):
            got = pcore.attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                                  bias=torch.from_numpy(bias), schedule=psched)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL, rtol=FP32_RTOL)
    assert sum("fell back" in r.getMessage() for r in caplog.records) == 1


def test_splash_checks_match_jax():
    q, k, v, _ = _inputs(1, 4, 2, S, 64, seed=7)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    doc = ([0] * 128 + [1] * 128)
    for pkw, jkw, match in (
        (dict(schedule=psa.schedule_from_mask(psa.CausalMask((128, 128)), 64)),
         dict(schedule=jsa.schedule_from_mask(jsa.CausalMask((128, 128)), 64)), "schedule is for"),
        (dict(schedule=psa.schedule_from_layout(np.ones((3, 4, 4)), 64)),
         dict(schedule=jsa.schedule_from_layout(np.ones((3, 4, 4)), 64)), "3 heads"),
        (dict(schedule=psa.schedule_from_mask(psa.DocumentMask(doc), 64),
              segment_ids=torch.zeros(1, S, dtype=torch.int32)),
         dict(schedule=jsa.schedule_from_mask(jsa.DocumentMask(doc), 64),
              segment_ids=jnp.zeros((1, S), jnp.int32)), "already carries"),
    ):
        with pytest.raises(ValueError, match=match):
            jsa.splash_attention(jq, jk, jv, jkw.pop("schedule"), interpret=True, **jkw)
        with pytest.raises(ValueError, match=match):
            psa.splash_attention(tq, tk, tv, pkw.pop("schedule"), **pkw)
    with pytest.raises(ValueError, match="not divisible"):
        psa.splash_prefill_attention(tq[:, :, :8], tk, tv, 0, window=16, block_kv=100)


# ---------------------------------------------------------------------------
# no fallback for device tensors; the kernels on the card
# ---------------------------------------------------------------------------
def test_wrappers_never_fall_back_for_device_tensors(monkeypatch):
    """The plain versions are poisoned; a meta tensor (standing in for a
    CUDA one) must reach the kernels' own checks, and a block the kernels do
    not take is refused, never run on the plain version."""
    def poisoned(*a, **k):
        raise AssertionError("a plain version ran for a device tensor")

    for name in ("splash_fwd_reference", "splash_bwd_reference"):
        monkeypatch.setattr(ps, name, poisoned)
    sched = psa.schedule_from_mask(psa.LocalMask((128, 128), 64), 64)
    q = torch.randn(1, 4, 128, 128, device="meta", dtype=torch.bfloat16)
    k = torch.randn(1, 2, 128, 128, device="meta", dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 128, device="meta")
    for call in (lambda: psa.splash_attention(q, k, k, sched),
                 lambda: ps.splash_fwd_cuda(q, k, k, sched),
                 lambda: ps.splash_bwd_dq_cuda(q, k, k, q, q, lse, sched),
                 lambda: ps.splash_bwd_dkv_cuda(q, k, k, q, q, lse, sched),
                 lambda: psa.splash_prefill_attention(q[:, :, :8], k, k, 3, window=16,
                                                      block_kv=64),
                 lambda: pcore.attention(q, k, k, impl="splash")):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    small = psa.schedule_from_mask(psa.LocalMask((128, 128), 64), 32)
    with pytest.raises(NotImplementedError, match="multiples of 64"):
        ps.splash_fwd_cuda(q, k, k, small)
    single = ps.prefill_schedule(3, 8, 128, 16, 32)  # 8 rows, 32-key blocks: forward takes it
    with pytest.raises(ValueError, match="CUDA"):
        ps.splash_fwd_cuda(q[:, :, :8], k, k, single)
    with pytest.raises(NotImplementedError, match="bf16"):
        ps.splash_fwd_cuda(q.float(), k, k, sched)


CUDA_CASES = {
    # name: (b, h, h_kv, s, d, schedule builder, segments)
    "local_b128": (1, 8, 2, 1024, 128, lambda s: psa.schedule_from_mask(
        psa.LocalMask((s, s), 300), 128), False),
    "per_head_fixed_b64": (1, 4, 4, 512, 64, lambda s: psa.FixedSparsityConfig(
        num_heads=4, block=64, different_layout_per_head=True, num_different_global_patterns=4,
        attention="unidirectional").make_schedule(s), False),
    "causal_segments_b256": (2, 4, 1, 768, 128, lambda s: psa.schedule_from_mask(
        psa.CausalMask((s, s)), 256), True),
    "document_static_d256": (1, 2, 1, 512, 256, lambda s: psa.schedule_from_mask(
        psa.DocumentMask([0] * 200 + [1] * 312) & psa.CausalMask((s, s)), 128), False),
    "dead_rows_b64": (1, 2, 2, 256, 64, lambda s: psa.schedule_from_layout(
        _dead_layout(), 64), False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_kernels_match_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    b, h, h_kv, s, d, build, segmented = CUDA_CASES[case]
    sched = build(s)
    gen = torch.Generator(device="cuda").manual_seed(s + d)
    q = torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, h_kv, s, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, h_kv, s, d, generator=gen, device="cuda").bfloat16()
    do = torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
    seg = None
    if segmented:
        seg = torch.zeros(b, s, dtype=torch.int32, device="cuda")
        seg[0, 300:] = 1
        seg[-1, 500:] = 2
    out, lse = ps.splash_fwd_cuda(q, k, v, sched, segment_ids=seg)
    ref_out, ref_lse = ps.splash_fwd_reference(q, k, v, sched, segment_ids=seg)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=BF16_ATOL, rtol=BF16_RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    dq = ps.splash_bwd_dq_cuda(q, k, v, out, do, lse, sched, segment_ids=seg)
    dk, dv = ps.splash_bwd_dkv_cuda(q, k, v, out, do, lse, sched, segment_ids=seg)
    want = ps.splash_bwd_reference(q, k, v, out, do, lse, sched, segment_ids=seg)
    for got, w, what in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        scale = max(1.0, float(w.float().abs().max()))
        torch.testing.assert_close(got.float(), w.float(), atol=BF16_ATOL * scale,
                                   rtol=BF16_RTOL)
        chip_smoke.tile_rel_err(torch, what, got, w)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 8, 32, 64, 192])
def test_cuda_prefill_matches_plain(t):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    S_, window = 2048, 700
    gen = torch.Generator(device="cuda").manual_seed(t)
    q = torch.randn(1, 8, t, 128, generator=gen, device="cuda").bfloat16()
    k = torch.randn(1, 2, S_, 128, generator=gen, device="cuda").bfloat16()
    v = torch.randn(1, 2, S_, 128, generator=gen, device="cuda").bfloat16()
    for start in (0, 111, 1000, S_ - t):
        for bk in (64, 128, 16):
            sched = ps.prefill_schedule(start, t, S_, window, bk)
            got = psa.splash_prefill_attention(q, k, v, start, window=window, block_kv=bk)
            want = ps.splash_fwd_reference(q, k, v, sched, base=start)[0]
            torch.testing.assert_close(got.float(), want.float(), atol=BF16_ATOL,
                                       rtol=BF16_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["per_head_fixed", "local"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_fwd_dq_match_plain_on_64_blocks_with_runtime_segments(d, layout):
    """The wgmma forward and dq kernels against the plain versions at
    64-row blocks (each consumer warpgroup of a 128-row CTA on its own
    schedule row; two kv blocks a 128-key forward tile), per head or
    shared, with runtime segment ids, at every head dim."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    b, h, h_kv, s = 2, 4, 2, 512
    if layout == "local":
        sched = psa.schedule_from_mask(psa.LocalMask((s, s), 200), 64)
    else:
        sched = psa.FixedSparsityConfig(num_heads=h, block=64, different_layout_per_head=True,
                                        num_different_global_patterns=4,
                                        attention="unidirectional").make_schedule(s)
    gen = torch.Generator(device="cuda").manual_seed(d + 7)
    q = torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, h_kv, s, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, h_kv, s, d, generator=gen, device="cuda").bfloat16()
    do = torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
    seg = torch.zeros(b, s, dtype=torch.int32, device="cuda")
    seg[0, 150:] = 1
    seg[-1, 380:] = 2
    out, lse = ps.splash_fwd_cuda(q, k, v, sched, segment_ids=seg)
    ref_out, ref_lse = ps.splash_fwd_reference(q, k, v, sched, segment_ids=seg)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=BF16_ATOL, rtol=BF16_RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    dq = ps.splash_bwd_dq_cuda(q, k, v, out, do, lse, sched, segment_ids=seg)
    want = ps.splash_bwd_reference(q, k, v, out, do, lse, sched, segment_ids=seg)[0]
    scale = max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(dq.float(), want.float(), atol=BF16_ATOL * scale, rtol=BF16_RTOL)
    chip_smoke.tile_rel_err(torch, "dq", dq, want)


# chip_smoke.flash_digests of the flash kernels as built before their CTA
# bodies took a walk policy (flash_fwd.cu, flash_bwd.cu on an NVIDIA H100
# 80GB HBM3): the policy's FlashWalk must compile to the same bits
FLASH_DIGESTS_BEFORE = {"d128_s1000_causal1_w300_segNone": "aae60a2ffd5058df",
                        "d128_s768_causal1_w0_seg300": "f347c19b569c38ff",
                        "d64_s512_causal0_w0_segNone": "ffa3c8250fe5f428",
                        "d256_s640_causal1_w200_segNone": "c057366d7e6fa449"}


def test_flash_digests_before_the_policy_are_chip_smokes():
    """chip_smoke's kernels phase holds the flash kernels to the same
    digests as the cuda test below."""
    assert chip_smoke.FLASH_DIGESTS == FLASH_DIGESTS_BEFORE


@pytest.mark.cuda
def test_cuda_flash_outputs_are_the_bits_before_the_walk_policy():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    assert chip_smoke.flash_digests(torch, torch.device("cuda")) == FLASH_DIGESTS_BEFORE


def test_chip_smoke_splash_work_counts_kept_pairs():
    """The bound's pair count: the LocalMask's band (every query keeps
    min(q + 1, w) keys) and a dead layout's kept blocks."""
    sched = psa.schedule_from_mask(psa.LocalMask((256, 256), 96), 64)
    pairs, flops, moved = chip_smoke.splash_work(sched, 1, 4, 2, 64)
    assert pairs == 4 * sum(min(i + 1, 96) for i in range(256))
    assert flops["splash_bwd_dkv"] == 2 * flops["splash_fwd"] == 8 * pairs * 64
    # bytes: q and o at 4 heads, k and v at the 2 kv heads, bf16; lse fp32
    assert moved["splash_fwd"] == 2 * (4 * 256 * 64 * 2) + 2 * (2 * 256 * 64 * 2) + 4 * 256 * 4
    dead = psa.schedule_from_layout(_dead_layout(), 64)
    assert chip_smoke.splash_work(dead, 2, 4, 1, 64)[0] == 2 * 4 * 64 * 64 * 5
    seg = torch.tensor([[0] * 100 + [1] * 156])
    causal = psa.schedule_from_mask(psa.CausalMask((256, 256)), 64)
    assert chip_smoke.splash_work(causal, 1, 4, 1, 64, seg)[0] == 4 * (
        100 * 101 // 2 + 156 * 157 // 2)


def _plain_kernels(monkeypatch):
    """chip_smoke's splash check on the CPU: the kernel wrappers replaced by
    the plain versions, the CUDA stream calls by no-ops."""
    monkeypatch.setattr(ps, "splash_fwd_cuda", ps.splash_fwd_reference)
    monkeypatch.setattr(ps, "splash_bwd_dq_cuda",
                        lambda *a, **kw: ps.splash_bwd_reference(*a, **kw)[0])
    monkeypatch.setattr(ps, "splash_bwd_dkv_cuda",
                        lambda *a, **kw: ps.splash_bwd_reference(*a, **kw)[1:])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)


@pytest.mark.parametrize("off_by", [0.0, 0.03])
def test_chip_smoke_check_splash_holds_every_output(monkeypatch, off_by):
    """check_splash (which chip_smoke runs on every case and on the inputs
    each time is taken on) records out, lse, dq, dk and dv, and raises when
    one 64-row tile of dk is 3% off."""
    _plain_kernels(monkeypatch)
    if off_by:
        plain_dkv = ps.splash_bwd_dkv_cuda

        def skewed(*a, **kw):
            dk, dv = plain_dkv(*a, **kw)
            dk = dk.clone()
            dk[:, :, 128:192] *= 1 + off_by
            return dk, dv

        monkeypatch.setattr(ps, "splash_bwd_dkv_cuda", skewed)
    sched = psa.schedule_from_mask(psa.LocalMask((S, S), 96), BLOCK)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(1, 4, 2, S, 64, 3))
    errs = {n: {} for n in chip_smoke.SPLASH_KERNELS}
    tile_errs = {"splash_bwd_dq": {}, "splash_bwd_dkv": {}}
    if off_by:
        with pytest.raises(AssertionError, match="splash_bwd_dkv"):
            chip_smoke.check_splash(torch, errs, tile_errs, "x", q, k, v, do, sched)
        return
    out, lse = chip_smoke.check_splash(torch, errs, tile_errs, "x", q, k, v, do, sched)
    assert out.shape == q.shape and lse.shape == (1, 4, S)
    assert set(errs["splash_fwd"]) == {"x", "x_lse"} and set(errs["splash_bwd_dkv"]) == {
        "x", "x_dv"}
    assert all(e == 0.0 for e in tile_errs["splash_bwd_dq"].values())


# ---------------------------------------------------------------------------
# the dk/dv kernel's walk (its plain model, ``splash.dkv_walk``)
# ---------------------------------------------------------------------------
def _both_configs(cls, kw):
    return getattr(psa, cls)(**kw), getattr(jsa, cls)(**kw)


WALK_CASES = {
    # name: (h, h_kv, s, d, (port schedule, JAX schedule) builder, runtime segments)
    "local_b64_two_blocks_a_cta": (8, 2, 512, 128, lambda s: (
        psa.schedule_from_mask(psa.LocalMask((s, s), 160), 64),
        jsa.schedule_from_mask(jmask.LocalMask((s, s), 160), 64)), False),
    "local_b64_d256": (8, 2, 512, 256, lambda s: (
        psa.schedule_from_mask(psa.LocalMask((s, s), 160), 64),
        jsa.schedule_from_mask(jmask.LocalMask((s, s), 160), 64)), False),
    "local_b512_train_splash": (8, 2, 2048, 128, lambda s: (
        psa.schedule_from_mask(psa.LocalMask((s, s), 512), 512),
        jsa.schedule_from_mask(jmask.LocalMask((s, s), 512), 512)), False),
    "per_head_fixed_b64": (8, 2, 512, 128, lambda s: tuple(
        c.make_schedule(s) for c in _both_configs("FixedSparsityConfig", dict(
            num_heads=8, block=64, different_layout_per_head=True,
            num_different_global_patterns=4, attention="unidirectional"))), False),
    "per_head_bigbird_b64_d64": (4, 4, 512, 64, lambda s: tuple(
        c.make_schedule(s) for c in _both_configs("BigBirdSparsityConfig", dict(
            num_heads=4, block=64, num_random_blocks=2, different_layout_per_head=True,
            seed=7))), False),
    "causal_b128": (4, 1, 512, 128, lambda s: (
        psa.schedule_from_mask(psa.CausalMask((s, s)), 128),
        jsa.schedule_from_mask(jmask.CausalMask((s, s)), 128)), False),
    "dead_rows_b64": (2, 2, 256, 128, lambda s: (
        psa.schedule_from_layout(_dead_layout(), 64),
        jsa.schedule_from_layout(_dead_layout(), 64)), False),
    "document_static_ids_b64": (4, 2, 256, 128, lambda s: tuple(
        m & c for m, c in zip(_both("DocumentMask", [0] * 100 + [1] * 60 + [2] * 96),
                              _both("CausalMask", (S, S)))), False),
    "local_b64_runtime_segments": (8, 2, 512, 128, lambda s: (
        psa.schedule_from_mask(psa.LocalMask((s, s), 160), 64),
        jsa.schedule_from_mask(jmask.LocalMask((s, s), 160), 64)), True),
    # 32 query heads a kv head, two kv blocks a CTA: 64 rows, two cursors a lane
    "per_head_fixed_b64_h32_kv1": (32, 1, 512, 128, lambda s: tuple(
        c.make_schedule(s) for c in _both_configs("FixedSparsityConfig", dict(
            num_heads=32, block=64, different_layout_per_head=True,
            num_different_global_patterns=4, attention="unidirectional"))), False),
}


def _walk_schedules(case):
    h, h_kv, s, d, build, segmented = WALK_CASES[case]
    port, jax_ = build(s)
    if not hasattr(port, "q_index"):  # masks (the document case): compile both
        port, jax_ = psa.schedule_from_mask(port, 64), jsa.schedule_from_mask(jax_, 64)
    seg = None
    if segmented:
        seg = np.zeros(s, np.int32)
        seg[150:] = 1
        seg[380:] = 2
    return h, h_kv, s, d, port, jax_, seg


def _kept_tokens(sched, hs, seg, seg_all, base=0):
    """[sq, sk] the pairs a head row keeps (the plain versions' rule; query
    row i at position base + i)."""
    status = ps._status(sched)[hs]
    q = np.arange(sched.seq_q)[:, None]
    k = np.arange(sched.seq_kv)[None, :]
    st = status[q // sched.block_q, k // sched.block_kv]
    pred = np.ones_like(st, bool)
    if sched.causal:
        pred &= q + base >= k
    if sched.window:
        pred &= (q + base - k) < sched.window
    ids = seg if seg is not None else sched.segment_ids
    same = np.ones_like(pred) if ids is None else ids[:, None] == ids[None, :]
    if seg_all:
        return ((st == 2) | ((st == 1) & pred)) & same
    return (st == 2) | ((st == 1) & pred & same)


def _ctas(sched, h_kv, d):
    kv_bk = ps.BWD_TILES[d]["kv_bk"]
    return [(kvh, k0) for kvh in range(h_kv) for k0 in range(0, sched.seq_kv, kv_bk)]


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_dkv_walk_lists_the_query_tiles_with_kept_pairs_in_order(case):
    """Per dk/dv CTA (kv head, KV_BK keys) the walk lists (query tile,
    head) stages in flash's order (query tile outer, the GQA group's heads
    inner, ascending), each with the step kind of its two 64-key halves.
    Without segment ids: exactly the stages whose tile holds a kept pair,
    and a half's kind is nonzero exactly where it holds one. With ids (a
    document schedule's static ids, or runtime ids): every such stage, and
    an extra one only where ids could match (runtime ids prune a tile none
    of whose ids is in the keys' range)."""
    h, h_kv, s, d, sched, _, seg = _walk_schedules(case)
    seg_all = seg is not None
    ids = seg if seg is not None else sched.segment_ids
    group = h // h_kv
    kv_bk = ps.BWD_TILES[d]["kv_bk"]
    kept = [_kept_tokens(sched, hs, seg, seg_all) for hs in range(sched.num_heads)]
    status = ps._status(sched)
    for kvh, k0 in _ctas(sched, h_kv, d):
        walk = ps.dkv_walk(sched, h, h_kv, d, kvh, k0, seg=seg, seg_all=seg_all)
        order = [(q0, hq) for q0, hq, _ in walk]
        assert order == sorted(order), (kvh, k0)
        assert len(set(order)) == len(order)
        got = {(q0, hq): kinds for q0, hq, kinds in walk}
        want = {}
        for q0 in range(0, s, 64):
            for g in range(group):
                hq = kvh * group + g
                hs = 0 if sched.num_heads == 1 else hq
                kinds = []
                for a in range(kv_bk // 64):
                    k_lo = k0 + 64 * a
                    block = kept[hs][q0:q0 + 64, k_lo:min(k_lo + 64, s)]
                    kinds.append(int(status[hs, q0 // sched.block_q, k_lo // sched.block_kv])
                                 if block.any() else 0)
                if any(kinds):
                    want[(q0, hq)] = tuple(kinds)
        if ids is None:
            assert got == want, (kvh, k0)
            continue
        for key, kinds in want.items():
            assert key in got, (kvh, k0, key)
            assert all(k == w for k, w in zip(got[key], kinds) if w), (kvh, k0, key)
        kids = ids[k0:k0 + kv_bk]
        for (q0, hq) in set(got) - set(want):
            qids = ids[q0:q0 + 64]
            assert ((qids >= kids.min()) & (qids <= kids.max())).any() or not seg_all


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_dkv_walk_reads_the_jax_schedule_alike(case):
    """The walk reads only the transposed schedule and its blocks: over the
    JAX package's schedule (compiled from the same mask or layout) it lists
    the same stages for every CTA."""
    h, h_kv, s, d, port, jax_, seg = _walk_schedules(case)
    _same_schedule(port, jax_)
    for kvh, k0 in _ctas(port, h_kv, d):
        assert ps.dkv_walk(port, h, h_kv, d, kvh, k0, seg=seg, seg_all=seg is not None) == \
            ps.dkv_walk(jax_, h, h_kv, d, kvh, k0, seg=seg, seg_all=seg is not None)


def test_dkv_walk_rows_bound_the_producer_lanes():
    """A CTA's producer warp merges its schedule rows, every 32nd a lane:
    two kv blocks a 128-key CTA at 64-key blocks, times the group's heads
    of a per-head schedule; 64-key CTAs (d 256) and blocks of 128 or more
    keys take one block. Any count is taken (its cursors live in shared
    memory)."""
    local64 = psa.schedule_from_mask(psa.LocalMask((512, 512), 160), 64)
    local128 = psa.schedule_from_mask(psa.LocalMask((512, 512), 160), 128)
    per_head = psa.FixedSparsityConfig(num_heads=8, block=64, different_layout_per_head=True,
                                       num_different_global_patterns=4).make_schedule(512)
    assert ps.dkv_walk_rows(local64, 32, 8, 128) == 2
    assert ps.dkv_walk_rows(local64, 32, 8, 256) == 1
    assert ps.dkv_walk_rows(local128, 32, 8, 128) == 1
    assert ps.dkv_walk_rows(per_head, 8, 2, 128) == 8
    assert ps.dkv_walk_rows(per_head, 8, 1, 64) == 16
    assert ps.dkv_walk_rows(per_head, 8, 8, 256) == 1
    per_head32 = psa.FixedSparsityConfig(num_heads=32, block=64, different_layout_per_head=True,
                                         num_different_global_patterns=4).make_schedule(512)
    assert ps.dkv_walk_rows(per_head32, 32, 1, 128) == 64


CUDA_DKV_CASES = {
    # name: (b, h, h_kv, s, d, schedule builder, segments)
    "local_b64_gqa": (1, 8, 2, 1024, 128, lambda s: psa.schedule_from_mask(
        psa.LocalMask((s, s), 300), 64), False),
    "per_head_fixed_b64_gqa": (1, 8, 2, 512, 64, lambda s: psa.FixedSparsityConfig(
        num_heads=8, block=64, different_layout_per_head=True, num_different_global_patterns=4,
        attention="unidirectional").make_schedule(s), False),
    "local_b128_d256": (1, 4, 2, 1024, 256, lambda s: psa.schedule_from_mask(
        psa.LocalMask((s, s), 300), 128), False),
    "local_b64_d256_segments": (2, 4, 2, 512, 256, lambda s: psa.schedule_from_mask(
        psa.LocalMask((s, s), 200), 64), True),
    # 64 rows of the transposed schedule a CTA (refused before the cursors
    # moved to shared memory)
    "per_head_fixed_b64_h32_kv1": (1, 32, 1, 512, 128, lambda s: psa.FixedSparsityConfig(
        num_heads=32, block=64, different_layout_per_head=True,
        num_different_global_patterns=4, attention="unidirectional").make_schedule(s), False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_DKV_CASES))
def test_cuda_dkv_matches_plain_on_the_walks(case):
    """The wgmma dk/dv kernel against the plain backward where its walk
    merges rows: 64-key blocks (two a CTA), per-head schedules over a GQA
    group (32 heads a kv head: 64 rows), d 256 (64-key CTAs), runtime
    segment ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    b, h, h_kv, s, d, build, segmented = CUDA_DKV_CASES[case]
    sched = build(s)
    gen = torch.Generator(device="cuda").manual_seed(s + d + 1)
    q = torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, h_kv, s, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, h_kv, s, d, generator=gen, device="cuda").bfloat16()
    do = torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
    seg = None
    if segmented:
        seg = torch.zeros(b, s, dtype=torch.int32, device="cuda")
        seg[0, 150:] = 1
        seg[-1, 380:] = 2
    out, lse = ps.splash_fwd_cuda(q, k, v, sched, segment_ids=seg)
    dk, dv = ps.splash_bwd_dkv_cuda(q, k, v, out, do, lse, sched, segment_ids=seg)
    _, rdk, rdv = ps.splash_bwd_reference(q, k, v, out, do, lse, sched, segment_ids=seg)
    for got, w, what in ((dk, rdk, "dk"), (dv, rdv, "dv")):
        scale = max(1.0, float(w.float().abs().max()))
        torch.testing.assert_close(got.float(), w.float(), atol=BF16_ATOL * scale,
                                   rtol=BF16_RTOL)
        chip_smoke.tile_rel_err(torch, what, got, w)


# ---------------------------------------------------------------------------
# the forward and dq kernels' walk (its plain model, ``splash.row_walk``)
# ---------------------------------------------------------------------------
ROW_WALK_CASES = {
    # name: (h, s, d, (port schedule, JAX schedule) builder, runtime segments)
    "local_b64_two_rows_a_cta": (2, 512, 128, lambda s: (
        psa.schedule_from_mask(psa.LocalMask((s, s), 160), 64),
        jsa.schedule_from_mask(jmask.LocalMask((s, s), 160), 64)), False),
    "local_b512_shared": (2, 2048, 128, lambda s: (
        psa.schedule_from_mask(psa.LocalMask((s, s), 700), 512),
        jsa.schedule_from_mask(jmask.LocalMask((s, s), 700), 512)), False),
    "per_head_fixed_b64_d64": (4, 512, 64, lambda s: tuple(
        c.make_schedule(s) for c in _both_configs("FixedSparsityConfig", dict(
            num_heads=4, block=64, different_layout_per_head=True,
            num_different_global_patterns=4, attention="unidirectional"))), False),
    "per_head_bigbird_b64_d256": (4, 512, 256, lambda s: tuple(
        c.make_schedule(s) for c in _both_configs("BigBirdSparsityConfig", dict(
            num_heads=4, block=64, num_random_blocks=2, different_layout_per_head=True,
            seed=7))), False),
    "causal_b192": (1, 768, 128, lambda s: (
        psa.schedule_from_mask(psa.CausalMask((s, s)), 192),
        jsa.schedule_from_mask(jmask.CausalMask((s, s)), 192)), False),
    "dead_rows_b64": (1, 256, 128, lambda s: (
        psa.schedule_from_layout(_dead_layout(), 64),
        jsa.schedule_from_layout(_dead_layout(), 64)), False),
    "document_static_ids_b64": (1, 256, 128, lambda s: tuple(
        m & c for m, c in zip(_both("DocumentMask", [0] * 100 + [1] * 60 + [2] * 96),
                              _both("CausalMask", (S, S)))), False),
    "local_b64_runtime_segments": (2, 512, 128, lambda s: (
        psa.schedule_from_mask(psa.LocalMask((s, s), 160), 64),
        jsa.schedule_from_mask(jmask.LocalMask((s, s), 160), 64)), True),
    # key blocks of 48 under 64-row query blocks (forward only)
    "local_q64_k48": (1, 384, 128, lambda s: (
        psa.schedule_from_mask(psa.LocalMask((s, s), 100), 64, 48),
        jsa.schedule_from_mask(jmask.LocalMask((s, s), 100), 64, 48)), False),
}


def _row_walk_schedules(case):
    h, s, d, build, segmented = ROW_WALK_CASES[case]
    port, jax_ = build(s)
    if not hasattr(port, "q_index"):  # masks (the document case): compile both
        port, jax_ = psa.schedule_from_mask(port, 64), jsa.schedule_from_mask(jax_, 64)
    seg = None
    if segmented:
        seg = np.zeros(s, np.int32)
        seg[150:] = 1
        seg[380:] = 2
    return h, d, port, jax_, seg


def _hold_row_walk(sched, h, d, kernel, seg=None, seg_all=False, base=0):
    """Every CTA's walk against the schedule's token mask: tiles ascending
    and never twice; every kept pair in a walked tile with its block's kind;
    a nonzero kind only where the block has it; no walked tile without a
    live column, no live PARTIAL column that the causal bound and the band
    leave dead for all of its warpgroup's rows, no kind past the keys; a
    whole flag only over 64 full rows and a full tile whose pairs are all
    kept."""
    tile = (ps.FWD_TILES if kernel == "fwd" else ps.BWD_TILES)[d]["bk"]
    sq, sk = sched.seq_q, sched.seq_kv
    ids = seg if seg is not None else sched.segment_ids
    status = ps._status(sched)
    kept = [_kept_tokens(sched, hs, seg, seg_all, base) for hs in range(sched.num_heads)]
    visits = 0
    for head in range(h):
        hs = 0 if sched.num_heads == 1 else head
        for q0 in range(0, sq, 128):
            n_rows = min(128, sq - q0)
            walk = ps.row_walk(sched, d, head, q0, kernel=kernel, seg=ids, seg_all=seg_all,
                               base=base)
            k0s = [k0 for k0, _, _ in walk]
            assert k0s == sorted(set(k0s)) and all(k0 % tile == 0 for k0 in k0s), (head, q0)
            covered = np.zeros((n_rows, sk), np.int64)
            for k0, kinds, wholes in walk:
                assert any(any(cols) for cols in kinds), (head, q0, k0)
                n = min(tile, sk - k0)
                for w in (0, 1):
                    r0, r1 = 64 * w, min(64 * w + 64, n_rows)
                    cols = np.asarray(kinds[w])
                    assert not cols[n:].any()
                    if r0 >= r1:
                        assert not cols.any() and not wholes[w]
                        continue
                    covered[r0:r1, k0:k0 + n] = cols[:n]
                    qpos = base + q0 + np.arange(r0, r1)[:, None]
                    kpos = k0 + np.arange(n)[None, :]
                    pred = np.ones((r1 - r0, n), bool)
                    if sched.causal:
                        pred &= qpos >= kpos
                    if sched.window:
                        pred &= qpos - kpos < sched.window
                    assert pred.any(axis=0)[cols[:n] == pmask.PARTIAL].all(), (head, q0, k0, w)
                    if wholes[w]:
                        assert r1 - r0 == 64 and n == tile
                        assert kept[hs][q0 + r0:q0 + r1, k0:k0 + n].all(), (head, q0, k0, w)
                visits += 1
            q = np.arange(q0, q0 + n_rows)
            want = status[hs][(q // sched.block_q)[:, None], (np.arange(sk) // sched.block_kv)]
            rows_kept = kept[hs][q0:q0 + n_rows]
            assert (covered[rows_kept] == want[rows_kept]).all(), (head, q0)
            assert ((covered == 0) | (covered == want)).all(), (head, q0)
    assert visits


# the backward takes key blocks of multiples of 64 only: dq has no 48-key case
@pytest.mark.parametrize("case,kernel", [
    (c, k) for c in sorted(ROW_WALK_CASES) for k in ("fwd", "dq")
    if (c, k) != ("local_q64_k48", "dq")])
def test_row_walk_covers_every_kept_pair_with_its_kind(case, kernel):
    """Per forward / dq CTA (128 query rows of one head, two consumer
    warpgroups, each on its own schedule row at 64-row blocks) the walk
    hands over ascending key tiles with a kind per (warpgroup, key column):
    every kept pair of the schedule's token mask lies in a walked tile with
    its block's kind, and a column is live only where its warpgroup can
    keep a pair."""
    h, d, sched, _, seg = _row_walk_schedules(case)
    _hold_row_walk(sched, h, d, kernel, seg, seg_all=seg is not None)


@pytest.mark.parametrize("case", sorted(ROW_WALK_CASES))
def test_row_walk_reads_the_jax_schedule_alike(case):
    """The walk reads only the row schedule and its blocks: over the JAX
    package's schedule (compiled from the same mask or layout) it lists the
    same tiles, kinds and flags for every CTA, forward and dq."""
    h, d, port, jax_, seg = _row_walk_schedules(case)
    _same_schedule(port, jax_)
    ids = seg if seg is not None else port.segment_ids
    for kernel in ("fwd", "dq"):
        for head in range(h):
            for q0 in range(0, port.seq_q, 128):
                kw = dict(kernel=kernel, seg=ids, seg_all=seg is not None)
                assert ps.row_walk(port, d, head, q0, **kw) == ps.row_walk(jax_, d, head, q0,
                                                                           **kw)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("kernel", ["fwd", "dq"])
def test_row_walk_is_the_flash_walk_over_a_shared_local_mask(kernel, d):
    """Over a LocalMask in 512-blocks (one schedule row shared by the heads)
    each CTA walks exactly the flash kernel's key tiles for the same causal
    window (flash_common.cuh's key_tiles), in its order: so out, lse and dq
    equal flash's as values on a card."""
    s, window = 2048, 700
    sched = psa.schedule_from_mask(psa.LocalMask((s, s), window), 512)
    tile = (ps.FWD_TILES if kernel == "fwd" else ps.BWD_TILES)[d]["bk"]
    for q0 in range(0, s, 128):
        lo = max(0, q0 - window + 1) // tile * tile
        assert [k0 for k0, _, _ in ps.row_walk(sched, d, 0, q0, kernel=kernel)] == list(
            range(lo, min(s, q0 + 128), tile)), q0


@pytest.mark.parametrize("block_kv", [16, 48, 128])
@pytest.mark.parametrize("t", [1, 8, 256])
def test_row_walk_of_the_prefill_form(t, block_kv):
    """The prefill's one schedule row (a chunk of t query rows at global
    positions start + i over S keys; a 128-row CTA past t rows, key blocks
    that are not multiples of 64): the forward's walk covers every kept
    pair, for chunk starts 0, inside the window and at the context's end."""
    S, window = 1536, 400
    for start in (0, 333, S - t):
        sched = ps.prefill_schedule(start, t, S, window, block_kv)
        _hold_row_walk(sched, 1, 128, "fwd", base=start)
