"""Layout-predicate sparse attention of the PyTorch port against the JAX package.

The same inputs, made from a seed with numpy, go through the port's plain
forward and backward (``sparse_fwd_reference``/``sparse_bwd_reference``,
the versions the CUDA kernels are held to on the card), its autograd
``sparse_attention`` on CPU tensors and ``SparseSelfAttention`` with
``use_splash=False``, and through the JAX package's ``sparse_attention(...,
interpret=True)`` (the Pallas bodies in interpret mode) and its
``jax.vjp``, as ``tests/unit/ops/test_sparse_attention.py`` runs them.
"""

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import core as jcore
from deepspeed_tpu.ops.sparse_attention import sparse_pallas as jsp
from deepspeed_tpu_torch.ops.attention import core as pcore
from deepspeed_tpu_torch.ops.attention.flash import BWD_TILES, FWD_TILES
from deepspeed_tpu_torch.ops.kernels import KERNELS
from deepspeed_tpu_torch.ops.sparse_attention import sparse as psp
from deepspeed_tpu_torch.ops.sparse_attention import splash


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
# Pallas body streams kv blocks with an online max; the plain version takes
# one softmax over the row)
FP32_ATOL = FP32_RTOL = 2e-5
BF16_ATOL = BF16_RTOL = 2.0 ** -6
S = 256

# name: (config class, its arguments, sequence length)
CONFIGS = {
    "dense_b64": ("DenseSparsityConfig", dict(num_heads=4, block=64), S),
    "fixed_b64_uni": ("FixedSparsityConfig", dict(
        num_heads=4, block=64, num_local_blocks=2, num_global_blocks=1,
        attention="unidirectional"), S),
    "fixed_b64_bi": ("FixedSparsityConfig", dict(
        num_heads=4, block=64, num_local_blocks=2, num_global_blocks=1,
        horizontal_global_attention=True), S),
    "bslongformer_b64": ("BSLongformerSparsityConfig", dict(
        num_heads=4, block=64, num_sliding_window_blocks=3, global_block_indices=(0, 2)), S),
    "bigbird_b64_per_head": ("BigBirdSparsityConfig", dict(
        num_heads=4, block=64, num_random_blocks=2, num_sliding_window_blocks=1,
        different_layout_per_head=True, seed=7), S),
    "variable_b64": ("VariableSparsityConfig", dict(
        num_heads=4, block=64, num_random_blocks=1, local_window_blocks=(1, 2),
        global_block_indices=(0,), seed=5), S),
    "fixed_b16_uni": ("FixedSparsityConfig", dict(
        num_heads=2, block=16, num_local_blocks=4, num_global_blocks=1,
        attention="unidirectional"), 128),
    "bigbird_b16_per_head": ("BigBirdSparsityConfig", dict(
        num_heads=2, block=16, num_random_blocks=2, num_sliding_window_blocks=3,
        different_layout_per_head=True, seed=3), 128),
}

# name: (config, causal): every family at block 64, both directions, and
# two 16-blocks (a kernel tile spans several layout blocks)
CASES = {
    "fixed_b64_causal": ("fixed_b64_uni", True),
    "fixed_b64_bidirectional": ("fixed_b64_bi", False),
    "bslongformer_b64_causal": ("bslongformer_b64", True),
    "bslongformer_b64_bidirectional": ("bslongformer_b64", False),
    "bigbird_b64_per_head_bidirectional": ("bigbird_b64_per_head", False),
    "variable_b64_causal": ("variable_b64", True),
    "fixed_b16_causal": ("fixed_b16_uni", True),
    "bigbird_b16_per_head_bidirectional": ("bigbird_b16_per_head", False),
}


def _inputs(b, h, h_kv, s, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=sh).astype(np.float32)
                 for sh in ((b, h, s, d), (b, h_kv, s, d), (b, h_kv, s, d), (b, h, s, d)))


def _configs(name):
    cls, kw, s = CONFIGS[name]
    return getattr(jsa, cls)(**kw), getattr(psa, cls)(**kw), s


def _dead_layout():
    layout = np.zeros((1, 2, 2), np.int32)
    layout[0, 0, 1] = 1  # q block 0 keeps only the future k block 1
    layout[0, 1, :] = 1
    return layout


def _jax_sparse(q, k, v, do, layout, block, causal):
    def f(q_, k_, v_):
        return jsa.sparse_attention(q_, k_, v_, layout, block, causal=causal, interpret=True)

    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(a) for a in (out,) + tuple(vjp(jnp.asarray(do)))]


def _port_all(q, k, v, do, layout, block, causal):
    """(plain out, dq, dk, dv) and (function out, dq, dk, dv) of the port."""
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = psp.sparse_fwd_reference(tq, tk, tv, layout, block, causal)
    plain = (out,) + psp.sparse_bwd_reference(tq, tk, tv, out, tdo, lse, layout, block, causal)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    fout = psa.sparse_attention(*leaves, layout, block, causal=causal)
    fout.backward(tdo)
    function = [fout.detach()] + [t.grad for t in leaves]
    return [t.numpy() for t in plain], [t.numpy() for t in function], lse


def _close(got, want, what):
    for g, w, name in zip(got, want, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, atol=FP32_ATOL, rtol=FP32_RTOL,
                                   err_msg=f"{what}: {name}")


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_make_layout_matches_jax(name):
    """All five families (dense, Fixed, BSLongformer, BigBird, Variable),
    BigBird's and Variable's seeded random blocks included, bit for bit at
    the sizes these tests run."""
    jc, pc, s = _configs(name)
    np.testing.assert_array_equal(pc.make_layout(s), jc.make_layout(s))
    assert pc.make_layout(s).dtype == np.int32


# ---------------------------------------------------------------------------
# the plain versions and the autograd function against the Pallas bodies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_versions_and_function_match_jax(case):
    """fp32, d 64: the plain forward and backward, and the autograd Function
    over them (CPU tensors), against the Pallas bodies in interpret mode and
    their vjp, on the same layout."""
    name, causal = CASES[case]
    jc, pc, s = _configs(name)
    layout = pc.make_layout(s)
    h = layout.shape[0]
    q, k, v, do = _inputs(1, h, h, s, 64, seed=len(case))
    want = _jax_sparse(q, k, v, do, jc.make_layout(s), pc.block, causal)
    plain, function, _ = _port_all(q, k, v, do, layout, pc.block, causal)
    _close(plain, want, "plain")
    _close(function, want, "function")


def test_causally_dead_rows_give_zero_and_finite_grads():
    """A query block whose only kept block lies in the causal future: 0
    out, lse -1e30, zero dq and finite gradients, as in the JAX package."""
    q, k, v, do = _inputs(1, 1, 1, 128, 64, seed=11)
    want = _jax_sparse(q, k, v, do, _dead_layout(), 64, True)
    plain, function, lse = _port_all(q, k, v, do, _dead_layout(), 64, True)
    _close(plain, want, "plain")
    _close(function, want, "function")
    assert not plain[0][:, :, :64].any() and not function[0][:, :, :64].any()
    assert bool((lse[:, :, :64] == -1e30).all())
    assert not plain[1][:, :, :64].any()
    assert all(np.isfinite(g).all() for g in plain[1:] + function[1:])


def test_dense_layout_is_full_attention():
    """The dense layout against both packages' ``mha_reference`` (not
    causal) and against the JAX kernel."""
    jc, pc, s = _configs("dense_b64")
    q, k, v, do = _inputs(1, 4, 4, s, 64, seed=2)
    plain, function, _ = _port_all(q, k, v, do, pc.make_layout(s), 64, False)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ref = pcore.mha_reference(tq, tk, tv, causal=False).numpy()
    jref = np.asarray(jcore.mha_reference(*(jnp.asarray(a) for a in (q, k, v)), causal=False))
    for got in (plain[0], function[0]):
        np.testing.assert_allclose(got, ref, atol=FP32_ATOL, rtol=FP32_RTOL)
        np.testing.assert_allclose(got, jref, atol=FP32_ATOL, rtol=FP32_RTOL)
    _close(plain, _jax_sparse(q, k, v, do, jc.make_layout(s), 64, False), "plain")


@pytest.mark.parametrize("causal", [False, True])
def test_dense_oracle_matches_jax_and_the_kernel_path(causal):
    """``sparse_attention_reference`` (dense token mask, autograd) against
    the JAX oracle, and against the port's kernel path on the same layout."""
    jc, pc, s = _configs("bslongformer_b64")
    q, k, v, do = _inputs(1, 4, 4, s, 64, seed=5)
    layout = pc.make_layout(s)
    want = jsa.sparse_attention_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                          jc.make_layout(s), 64, causal=causal)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = psa.sparse_attention_reference(tq, tk, tv, layout, 64, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL, rtol=FP32_RTOL)
    kernel_path = psa.sparse_attention(tq, tk, tv, torch.from_numpy(layout), 64, causal=causal)
    np.testing.assert_allclose(kernel_path.numpy(), got.numpy(), atol=FP32_ATOL, rtol=FP32_RTOL)


def test_plain_versions_take_row_chunks(monkeypatch):
    """Query rows in chunks (one row of logits at a time here) give the
    one-chunk result, to fp32 rounding."""
    _, pc, s = _configs("bigbird_b64_per_head")
    layout = pc.make_layout(s)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 4, 4, s, 64, seed=4))
    whole = psp.sparse_fwd_reference(q, k, v, layout, 64, True)
    whole_g = psp.sparse_bwd_reference(q, k, v, whole[0], do, whole[1], layout, 64, True)
    monkeypatch.setattr(splash, "_CHUNK_ELEMS", 2 * 4 * s)
    assert len(psp._row_chunks(2, 4, s, s)) == s
    chunked = psp.sparse_fwd_reference(q, k, v, layout, 64, True)
    chunked_g = psp.sparse_bwd_reference(q, k, v, whole[0], do, whole[1], layout, 64, True)
    for a, b_ in zip(whole + whole_g, chunked + chunked_g):
        torch.testing.assert_close(a, b_, atol=FP32_ATOL, rtol=FP32_RTOL)


def test_plain_forward_is_differentiable_by_autograd():
    """The plain forward under autograd gives the plain backward's
    gradients."""
    _, pc, s = _configs("fixed_b64_uni")
    layout = pc.make_layout(s)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 4, 4, s, 64, seed=6))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = psp.sparse_fwd_reference(*leaves, layout, 64, True)
    out.backward(do)
    want = psp.sparse_bwd_reference(q, k, v, out.detach(), do, lse.detach(), layout, 64, True)
    for got, w in zip(leaves, want):
        torch.testing.assert_close(got.grad, w, atol=FP32_ATOL, rtol=FP32_RTOL)


# ---------------------------------------------------------------------------
# SparseSelfAttention
# ---------------------------------------------------------------------------
def _module_grads(jmod, pmod, q, k, v, do, **kw):
    """(out, dq, dk, dv) of each package's SparseSelfAttention call."""
    jkw = {key: jnp.asarray(val) for key, val in kw.items()}
    out, vjp = jax.vjp(lambda q_, k_, v_: jmod(q_, k_, v_, **jkw),
                       *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(a) for a in (out,) + tuple(vjp(jnp.asarray(do)))]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = pmod(*leaves, **{key: torch.from_numpy(val) for key, val in kw.items()})
    got.backward(torch.from_numpy(do))
    return [got.detach().numpy()] + [t.grad.numpy() for t in leaves], want


@pytest.mark.parametrize("attention", ["unidirectional", "bidirectional"])
def test_sparse_self_attention_layout_kernel_path_with_gqa(attention):
    """``use_splash=False`` with 4 query heads over 2 kv heads: the kv are
    expanded as ``jnp.repeat(axis=1)`` expands them, ``causal`` follows the
    config, and the kv gradients sum over each group."""
    kw = dict(num_heads=4, block=64, num_local_blocks=2, num_global_blocks=1,
              attention=attention)
    jmod = jsa.SparseSelfAttention(jsa.FixedSparsityConfig(**kw), use_splash=False,
                                   interpret=True)
    pmod = psa.SparseSelfAttention(psa.FixedSparsityConfig(**kw), use_splash=False)
    q, k, v, do = _inputs(1, 4, 2, S, 64, seed=9)
    got, want = _module_grads(jmod, pmod, q, k, v, do)
    _close(got, want, attention)
    assert pmod.device_layout(S, "cpu") is pmod.device_layout(S, "cpu")


RNG = np.random.default_rng(21)
KPM = np.where(np.arange(S) < 200, 0.0, -10000.0).astype(np.float32)[None]  # [1, s] "add"
KPM_MUL = (np.arange(S) < 200).astype(np.float32)[None]  # [1, s] "mul": 0 = masked
BIASED = {
    # name: (key_padding_mask_mode, attn_mask_mode, call arguments)
    "rpe": ("add", "mul", dict(rpe=RNG.normal(size=(1, 4, S, S)).astype(np.float32))),
    "key_padding_add": ("add", "mul", dict(key_padding_mask=KPM)),
    "key_padding_mul": ("mul", "mul", dict(key_padding_mask=KPM_MUL)),
    "attn_mask_add": ("add", "add", dict(attn_mask=RNG.normal(size=(S, S)).astype(np.float32))),
    "attn_mask_mul": ("add", "mul", dict(
        attn_mask=(RNG.uniform(size=(S, S)) < 0.7).astype(np.float32))),
}


@pytest.mark.parametrize("use_splash", [True, False])
@pytest.mark.parametrize("name", sorted(BIASED))
def test_sparse_self_attention_biased_calls_match_jax(name, use_splash):
    """``rpe``, ``key_padding_mask`` and ``attn_mask`` in both modes build the
    fp32 bias and take the dense biased form whatever ``use_splash`` says
    (GQA kv expanded), forward and gradients."""
    kpm_mode, am_mode, kw = BIASED[name]
    cfg = dict(num_heads=4, block=64, num_sliding_window_blocks=3)
    mods = [pkg.SparseSelfAttention(pkg.BSLongformerSparsityConfig(**cfg),
                                    key_padding_mask_mode=kpm_mode, attn_mask_mode=am_mode,
                                    use_splash=use_splash, **extra)
            for pkg, extra in ((jsa, dict(interpret=True)), (psa, {}))]
    q, k, v, do = _inputs(1, 4, 2, S, 64, seed=13)
    got, want = _module_grads(*mods, q, k, v, do, **kw)
    _close(got, want, name)


def test_biased_form_matches_jax_and_keeps_the_value_dtype():
    """``sparse_attention_with_bias`` against the JAX package's: causal with
    a bias broadcast over heads, and in bf16 (weights rounded to v's dtype
    before P V, rows that keep nothing zeroed)."""
    jc, pc, s = _configs("bigbird_b64_per_head")
    q, k, v, _ = _inputs(2, 4, 4, s, 64, seed=8)
    bias = np.random.default_rng(1).normal(size=(2, 1, s, s)).astype(np.float32)
    want = jsa.sparse_attention_with_bias(*(jnp.asarray(a) for a in (q, k, v)),
                                          jc.make_layout(s), 64, causal=True,
                                          bias=jnp.asarray(bias))
    got = psa.sparse_attention_with_bias(*(torch.from_numpy(a) for a in (q, k, v)),
                                         pc.make_layout(s), 64, causal=True,
                                         bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL, rtol=FP32_RTOL)
    lay = _dead_layout()
    qb, kb, vb = (a[:, :1, :128] for a in (q, k, v))
    want = jsa.sparse_attention_with_bias(
        *(jnp.asarray(a, jnp.bfloat16) for a in (qb, kb, vb)), lay, 64, causal=True)
    got = psa.sparse_attention_with_bias(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (qb, kb, vb)), lay, 64, causal=True)
    assert got.dtype == torch.bfloat16 and not got[:, :, :64].any()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=BF16_ATOL, rtol=BF16_RTOL)


# ---------------------------------------------------------------------------
# errors, raised before any work, as the JAX package raises them
# ---------------------------------------------------------------------------
def _both_raise(exc, jcall, pcall):
    with pytest.raises(exc) as je:
        jcall()
    with pytest.raises(exc) as pe:
        pcall()
    assert str(pe.value) == str(je.value)


def test_errors_match_jax():
    q, k, v, _ = _inputs(1, 4, 2, 128, 64, seed=1)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    lay = np.ones((4, 2, 2), np.int32)
    bias = np.zeros((1, 1, 128, 128), np.float32)
    # a bias on the kernel path and on its oracle
    _both_raise(NotImplementedError,
                lambda: jsa.sparse_attention(jq, jq, jq, lay, 64, bias=jnp.asarray(bias),
                                             interpret=True),
                lambda: psa.sparse_attention(tq, tq, tq, lay, 64, bias=torch.from_numpy(bias)))
    _both_raise(NotImplementedError,
                lambda: jsa.sparse_attention_reference(jq, jq, jq, lay, 64,
                                                       bias=jnp.asarray(bias)),
                lambda: psa.sparse_attention_reference(tq, tq, tq, lay, 64,
                                                       bias=torch.from_numpy(bias)))
    # GQA not expanded
    _both_raise(ValueError,
                lambda: jsa.sparse_attention(jq, jk, jv, lay, 64, interpret=True),
                lambda: psa.sparse_attention(tq, tk, tv, lay, 64))
    # a layout of another shape
    _both_raise(ValueError,
                lambda: jsa.sparse_attention(jq, jq, jq, np.ones((4, 4, 4), np.int32), 64,
                                             interpret=True),
                lambda: psa.sparse_attention(tq, tq, tq, np.ones((4, 4, 4), np.int32), 64))
    # SparseSelfAttention with the wrong head count
    cfg = dict(num_heads=2, block=64)
    _both_raise(ValueError,
                lambda: jsa.SparseSelfAttention(jsa.FixedSparsityConfig(**cfg),
                                                use_splash=False, interpret=True)(jq, jq, jq),
                lambda: psa.SparseSelfAttention(psa.FixedSparsityConfig(**cfg),
                                                use_splash=False)(tq, tq, tq))


# ---------------------------------------------------------------------------
# no fallback for device tensors; the kernels on the card
# ---------------------------------------------------------------------------
def test_wrappers_never_fall_back_for_device_tensors(monkeypatch):
    """The plain versions are poisoned; a meta tensor (standing in for a
    CUDA one) must reach the kernels' own checks, and what the kernels do
    not take (fp32, head_dim 96, a block of 48 or one that does not divide
    s) is refused, never run on the plain version."""
    def poisoned(*a, **k):
        raise AssertionError("a plain version ran for a device tensor")

    for name in ("sparse_fwd_reference", "sparse_bwd_reference"):
        monkeypatch.setattr(psp, name, poisoned)
    lay = torch.ones(4, 2, 2, dtype=torch.int32)
    q = torch.randn(1, 4, 128, 128, device="meta", dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 128, device="meta")
    for call in (lambda: psa.sparse_attention(q, q, q, lay.to("meta"), 64),
                 lambda: psp.sparse_fwd_cuda(q, q, q, lay, 64),
                 lambda: psp.sparse_bwd_dq_cuda(q, q, q, q, q, lse, lay, 64),
                 lambda: psp.sparse_bwd_dkv_cuda(q, q, q, q, q, lse, lay, 64, True)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(NotImplementedError, match="bf16.*queue 2, item 1"):
        psp.sparse_fwd_cuda(q.float(), q.float(), q.float(), lay, 64)
    with pytest.raises(NotImplementedError, match="head_dim 96"):
        psp.sparse_fwd_cuda(*(torch.zeros(1, 4, 128, 96, device="meta",
                                          dtype=torch.bfloat16),) * 3, lay, 64)
    for block, s in ((48, 96), (64, 96)):
        qs = torch.zeros(1, 4, s, 128, device="meta", dtype=torch.bfloat16)
        with pytest.raises(NotImplementedError, match="blocks in"):
            psp.sparse_fwd_cuda(qs, qs, qs, torch.ones(4, s // block, s // block), block)


def test_kernels_are_registered_with_their_pallas_bodies():
    """Each wrapper's kernel and the Pallas body it replaces (file:line of
    the JAX kernel function)."""
    root = Path(__file__).resolve().parents[1]
    for name, fn in (("sparse_fwd", "_sparse_fwd_kernel"),
                     ("sparse_bwd_dq", "_sparse_bwd_dq_kernel"),
                     ("sparse_bwd_dkv", "_sparse_bwd_dkv_kernel")):
        path, line = KERNELS[name].replaces.rsplit(":", 1)
        assert path == "deepspeed_tpu/ops/sparse_attention/sparse_pallas.py"
        src = (root / path).read_text().splitlines()
        assert src[int(line) - 1].startswith(f"def {fn}(")


CUDA_CASES = {
    # name: (b, h, s, d, layout config, causal)
    "fixed_b128_causal_d128": (1, 8, 1024, 128, ("FixedSparsityConfig", dict(
        num_heads=8, block=128, num_local_blocks=4, attention="unidirectional")), True),
    "bigbird_b64_per_head_d64": (2, 4, 512, 64, ("BigBirdSparsityConfig", dict(
        num_heads=4, block=64, num_random_blocks=2, different_layout_per_head=True)), False),
    "fixed_b16_causal_d256": (1, 2, 512, 256, ("FixedSparsityConfig", dict(
        num_heads=2, block=16, num_local_blocks=4, attention="unidirectional")), True),
    "bslongformer_b32_d128": (1, 4, 1056, 128, ("BSLongformerSparsityConfig", dict(
        num_heads=4, block=32, num_sliding_window_blocks=3)), False),
    "dense_b256_d64": (1, 2, 512, 64, ("DenseSparsityConfig", dict(num_heads=2, block=256)),
                       False),
    "bigbird_b16_causal_ragged_d64": (2, 2, 1040, 64, ("BigBirdSparsityConfig", dict(
        num_heads=2, block=16, num_random_blocks=3, different_layout_per_head=True)), True),
    "bslongformer_b32_causal_ragged_d64": (1, 2, 544, 64, ("BSLongformerSparsityConfig", dict(
        num_heads=2, block=32, num_sliding_window_blocks=3)), True),
    "fixed_b32_d256": (1, 2, 512, 256, ("FixedSparsityConfig", dict(
        num_heads=2, block=32, num_local_blocks=4, horizontal_global_attention=True)), False),
    # 512 dq CTAs and 512 dk/dv CTAs: several waves over the card's 132 SMs
    "fixed_b128_causal_waves_d128": (2, 8, 4096, 128, ("FixedSparsityConfig", dict(
        num_heads=8, block=128, num_local_blocks=4, attention="unidirectional")), True),
    # 64-blocks under the forward's 128-key tiles: its per-column form at d
    # 128 (dq's 64-key tiles take the scalar one), the last tile half past s
    "bigbird_b64_causal_ragged_d128": (1, 4, 1088, 128, ("BigBirdSparsityConfig", dict(
        num_heads=4, block=64, num_random_blocks=2, different_layout_per_head=True)), True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_kernels_match_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    b, h, s, d, (cls, kw), causal = CUDA_CASES[case]
    cfg = getattr(psa, cls)(**kw)
    lay = torch.as_tensor(cfg.make_layout(s), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(s + d)
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    out, lse = psp.sparse_fwd_cuda(q, k, v, lay, cfg.block, causal)
    ref, ref_lse = psp.sparse_fwd_reference(q, k, v, lay, cfg.block, causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=BF16_ATOL, rtol=BF16_RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=2e-5)
    dq = psp.sparse_bwd_dq_cuda(q, k, v, out, do, lse, lay, cfg.block, causal)
    dk, dv = psp.sparse_bwd_dkv_cuda(q, k, v, out, do, lse, lay, cfg.block, causal)
    for got, want in zip((dq, dk, dv), psp.sparse_bwd_reference(q, k, v, out, do, lse, lay,
                                                                 cfg.block, causal)):
        scale = max(1.0, float(want.float().abs().max()))
        torch.testing.assert_close(got.float(), want.float(), atol=BF16_ATOL * scale,
                                   rtol=BF16_RTOL)


# ---------------------------------------------------------------------------
# the kernels' walks (plain models of sparse_common.cuh's LayoutRowWalk, over
# the forward's and dq's key tiles, and LayoutDkvWalk)
# ---------------------------------------------------------------------------
def _walk_layouts():
    """name: (layout, block, causal): each layout of ``CUDA_CASES`` at s
    min(s, 512 + s % 64) (ragged where the case is), and ``chip_smoke.py``'s
    ``sparse_cases`` (a)-(f) at 2 heads, s 512."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    out = {}
    for name, (_, _, s, _, (cls, kw), causal) in CUDA_CASES.items():
        cfg = getattr(psa, cls)(**kw)
        out[name] = (cfg.make_layout(min(s, 512 + s % 64)), cfg.block, causal)
    for name, layout, block, causal in chip_smoke.sparse_cases(2, 512):
        out[f"chip_smoke_{name}"] = (np.asarray(layout, np.int32), block, causal)
    return out


WALK_LAYOUTS = sorted(_walk_layouts())


def _row_walk_count(layout, block, causal, s, d, fwd=False):
    """[h, s + 128, s + 128] visits of each pair that ``layout_walk``'s
    tiles keep (``layout_fwd_walk``'s with ``fwd``), with its checks of
    each CTA's walk."""
    h = layout.shape[0]
    bk = (FWD_TILES if fwd else BWD_TILES)[d]["bk"]
    walk = psp.layout_fwd_walk if fwd else psp.layout_walk
    count = np.zeros((h, s + 128, s + 128), np.int32)
    for head in range(h):
        for q0 in range(0, s, 128):
            tiles = walk(layout, block, causal, s, d, head, q0)
            assert [t[0] for t in tiles] == sorted({t[0] for t in tiles}), "ascending, once"
            for k0, codes, cols in tiles:
                kept_any = False
                for w in (0, 1):
                    rows = np.arange(q0 + 64 * w, q0 + 64 * w + 64)[:, None]
                    keys = np.arange(k0, k0 + bk)[None, :]
                    if block >= max(64, bk):
                        assert codes[w] != psp.WALK_COLUMNS, "blocks of the tile: one code"
                    if codes[w] == psp.WALK_WHOLE:
                        keep = np.ones((64, bk), bool)
                    else:
                        knd = np.asarray(cols[w])[None] if codes[w] == psp.WALK_COLUMNS else codes[w]
                        keep = psp.walk_keep(knd, rows, keys, block, causal, s) & np.ones(
                            (64, bk), bool)
                    count[head, q0 + 64 * w:q0 + 64 * w + 64, k0:k0 + bk] += keep
                    kept_any |= bool(keep.any())
                assert kept_any, f"tile {k0} of CTA {q0} keeps no pair"
    return count


def _dkv_walk_count(layout, block, causal, s, d):
    """The same for ``layout_dkv_walk``'s stages."""
    h, kv_bk = layout.shape[0], BWD_TILES[d]["kv_bk"]
    count = np.zeros((h, s + 128, s + 128), np.int32)
    for head in range(h):
        for k0 in range(0, s, kv_bk):
            stages = psp.layout_dkv_walk(layout, block, causal, s, d, head, k0)
            assert [t[0] for t in stages] == sorted({t[0] for t in stages}), "ascending, once"
            for q0, kinds in stages:
                kept_any = False
                for a, kind in enumerate(kinds):
                    rows = np.arange(q0, q0 + 64)[:, None]
                    keys = np.arange(k0 + 64 * a, k0 + 64 * a + 64)[None, :]
                    if kind & psp.DKV_WHOLE:
                        keep = np.ones((64, 64), bool)
                    else:
                        keep = psp.dkv_walk_keep(kind, rows, keys, block, causal, s) & np.ones(
                            (64, 64), bool)
                    if block >= 64:
                        assert kind & ~psp.DKV_WHOLE in (0, 1), "blocks of 64+: one bit a half"
                    count[head, q0:q0 + 64, k0 + 64 * a:k0 + 64 * a + 64] += keep
                    kept_any |= bool(keep.any())
                assert kept_any, f"query tile {q0} of CTA {k0} keeps no pair"
    return count


def _jax_token_mask(layout, block, causal, s):
    """[h, s, s] the pairs the JAX package's ``_sparse_dense`` attends: its
    softmax weights with q = k = 0 (every kept logit 0, every other -1e30)
    read through v = the identity."""
    h = layout.shape[0]
    zeros = jnp.zeros((1, h, s, 1), jnp.float32)
    eye = jnp.broadcast_to(jnp.eye(s, dtype=jnp.float32), (1, h, s, s))
    w = jsp._sparse_dense(zeros, zeros, eye, jnp.asarray(layout), block, causal, None, None)
    return np.asarray(w)[0] > 0


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("walk", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("name", WALK_LAYOUTS)
def test_walks_keep_exactly_the_layout_pairs(name, walk, d):
    """Each walk's tiles, with their codes and bit predicate, visit every
    pair ``_kept`` keeps exactly once and no other; each CTA's tiles come in
    ascending order, every tile handed over keeps a pair, and blocks of at
    least 64 and of the tile never take the per-column form. d 128 and 256
    differ in the tiles (fwd 128 / 64 keys, dq 64 / 32, dk/dv 128 / 64 keys
    a CTA); d 64 has d 128's."""
    layout, block, causal = _walk_layouts()[name]
    s = layout.shape[1] * block
    if walk == "dkv":
        count = _dkv_walk_count(layout, block, causal, s, d)
    else:
        count = _row_walk_count(layout, block, causal, s, d, fwd=walk == "fwd")
    assert not count[:, s:].any() and not count[:, :, s:].any()
    want = psp._kept(torch.from_numpy(layout), block, causal, 0, s, s)[0].numpy()
    np.testing.assert_array_equal(count[:, :s, :s], want.astype(np.int32))


@pytest.mark.parametrize("d", [128, 256])
def test_forward_walk_takes_the_per_column_form_below_its_tile(d):
    """The forward's walk over ``chip_smoke.sparse_cases``' 64-block layouts
    (b), (c): per-column codes under the 128-key tiles of d 128, scalar
    codes under the 64-key tiles of d 256 (and dq's 64 / 32 at both); the
    128-block layouts (d)-(f) scalar at both."""
    layouts = _walk_layouts()

    def forms(name, walk):
        layout, block, causal = layouts[f"chip_smoke_{name}"]
        s = layout.shape[1] * block
        return {c for q0 in range(0, s, 128) for head in range(layout.shape[0])
                for _, codes, _ in walk(layout, block, causal, s, d, head, q0) for c in codes}

    for name in ("b_bigbird_b64_per_head", "c_dead_rows_b64_causal"):
        assert (psp.WALK_COLUMNS in forms(name, psp.layout_fwd_walk)) == (d == 128)
        assert psp.WALK_COLUMNS not in forms(name, psp.layout_walk)
    for name in ("d_dense_b128", "e_fixed_b128_causal", "f_tril_b128_causal"):
        assert psp.WALK_COLUMNS not in forms(name, psp.layout_fwd_walk)


@pytest.mark.parametrize("name", WALK_LAYOUTS)
def test_kept_pairs_are_the_jax_token_mask(name):
    """The pairs the walks are held to (``_kept``) are the token mask of
    the JAX package's ``_sparse_dense`` over the same layout."""
    layout, block, causal = _walk_layouts()[name]
    s = layout.shape[1] * block
    want = _jax_token_mask(layout, block, causal, s)
    got = psp._kept(torch.from_numpy(layout), block, causal, 0, s, s)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_dkv_ctas_is_the_dkv_grid():
    """``dkv_ctas`` (the rows of the dk/dv kernel's ``cta_clock``) is the
    dk/dv grid: (b h) x key tiles of ``BWD_TILES[d]["kv_bk"]``, the last
    one ragged."""
    assert psp.dkv_ctas(1, 32, 16384, 128) == 32 * 128
    assert psp.dkv_ctas(2, 2, 1040, 64) == 4 * 9
    assert psp.dkv_ctas(2, 2, 1040, 256) == 4 * 17


def test_ab_tool_parses_and_needs_a_card(monkeypatch):
    """``tools/torch_sparse_ab.py``: its per-checkout program compiles, and
    without a card it refuses (exit 2) before starting any process."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import torch_sparse_ab

    compile(torch_sparse_ab.CHILD, "torch_sparse_ab.CHILD", "exec")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch_sparse_ab.subprocess, "run", lambda *a, **k: pytest.fail("ran"))
    assert torch_sparse_ab.main([]) == 2
