"""``matmul_precision`` in the port against the JAX package, on the CPU.

Mirrors ``tests/unit/ops/test_qmatmul.py``. The same numpy-seeded operands
go through the port's ``qmatmul`` and the JAX package's under ``jax.jit``
(the compiled form the JAX model trains with: XLA turns ``absmax / qmax``
into a product with qmax's fp32 reciprocal, and the port's scales follow
that form). The int8 modes are held bit for bit in fp32 (exact int32
products, the same scales, the same rescale order); fp8 to a stated
tolerance (fp32 sums of the upcast codes in another order); the backward
to the JAX vjp in fp32. The library products the card takes
(``torch._int_mm``, ``torch._scaled_mm``) also run on CPU tensors here, so
their padding is held against the plain products. Then the model: losses
of ``initialize`` -> ``train_batch`` at ``matmul_precision`` int8 and fp8
against the JAX engine's, and the refusals that are gone.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops.qmatmul import qmatmul as jax_qmatmul
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops import qmatmul as Q


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# fp8: the codes and scales agree; fp32 sums of up to 128 products of
# e4m3 codes in another order differ by a few fp32 ulps of the row sum
FP8_RTOL = FP8_ATOL = 1e-5
# the backward is fp32 products on both sides, summed in another order
GRAD_RTOL = GRAD_ATOL = 1e-5


def _operands(seed, lead=(4, 64), k=128, n=96, outlier=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (k,)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    if outlier:
        w[:, 0] *= 50.0  # one hot output channel sets a per-tensor scale
    return x, w


def _jax_forward(x, w, mode):
    return np.asarray(jax.jit(lambda a, b: jax_qmatmul(a, b, mode))(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("outlier", [False, True])
@pytest.mark.parametrize("mode", ["int8", "int8_tensor"])
def test_int8_forward_equals_jax_bit_for_bit(mode, outlier):
    x, w = _operands(0, outlier=outlier)
    got = Q.qmatmul(torch.from_numpy(x), torch.from_numpy(w), mode).numpy()
    np.testing.assert_array_equal(got, _jax_forward(x, w, mode))


def test_fp8_forward_matches_jax():
    x, w = _operands(1)
    got = Q.qmatmul(torch.from_numpy(x), torch.from_numpy(w), "fp8").numpy()
    want = _jax_forward(x, w, "fp8")
    np.testing.assert_allclose(got, want, rtol=FP8_RTOL, atol=FP8_ATOL)
    # and the fp8 codes themselves are JAX's
    xq, sx = Q._cast_fp8(torch.from_numpy(x))
    jq, js = jax.jit(lambda a: _jax_fp8_cast_compiled(a))(jnp.asarray(x))
    assert float(sx) == float(js)
    np.testing.assert_array_equal(xq.view(torch.uint8).numpy(),
                                  np.asarray(jq).view(np.uint8))


def _jax_fp8_cast_compiled(a):
    from deepspeed_tpu.ops.quantizer.block_quant import fp8_cast

    return fp8_cast(a)


@pytest.mark.parametrize("mode", ["fp8", "int8", "int8_tensor"])
def test_forward_close_to_dense(mode):
    """The JAX suite's accuracy bounds hold in the port too."""
    x, w = _operands(2)
    dense = x @ w
    q = Q.qmatmul(torch.from_numpy(x), torch.from_numpy(w), mode).numpy()
    rel = np.linalg.norm(q - dense) / np.linalg.norm(dense)
    assert rel < (0.015 if mode == "int8" else 0.05), rel


@pytest.mark.parametrize("mode", ["fp8", "int8", "int8_tensor"])
def test_backward_equals_jax_vjp(mode):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 32)).astype(np.float32)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    g = rng.normal(size=(8, 16)).astype(np.float32)
    # one compiled vjp (the JAX package's eager ops compile per shape)
    jdx, jdw = jax.jit(lambda a, b, c: jax.vjp(lambda a, b: jax_qmatmul(a, b, mode), a, b)[1](c))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    dx, dw = torch.autograd.grad(Q.qmatmul(tx, tw, mode), (tx, tw), torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # the straight-through recipe: the dense matmul's gradients, exactly
    ddx, ddw = torch.autograd.grad(tx @ tw, (tx, tw), torch.from_numpy(g))
    assert torch.equal(dx, ddx)
    np.testing.assert_allclose(dw.numpy(), ddw.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_bf16_backward_is_the_vjp_formula():
    """bf16 operands: dx = g @ w.T in bf16, dw the fp32 product cast to
    bf16 (what the card run holds bit for bit)."""
    g_ = torch.Generator().manual_seed(4)
    x = torch.randn(3, 16, 64, generator=g_).bfloat16().requires_grad_(True)
    w = torch.randn(64, 40, generator=g_).bfloat16().requires_grad_(True)
    g = torch.randn(3, 16, 40, generator=g_).bfloat16()
    for mode in Q.MODES:
        out = Q.qmatmul(x, w, mode)
        assert out.dtype == torch.bfloat16 and out.shape == (3, 16, 40)
        dx, dw = torch.autograd.grad(out, (x, w), g)
        want_dx, want_dw = Q.qmatmul_vjp(x.detach(), w.detach(), g)
        assert torch.equal(dx, want_dx) and torch.equal(dw, want_dw)
        assert dw.dtype == torch.bfloat16


def test_bad_mode_rejected():
    with pytest.raises(ValueError, match="mode"):
        Q.qmatmul(torch.ones(2, 4), torch.ones(4, 4), "int4")
    with pytest.raises(ValueError, match="mode"):
        Q.qmatmul_forward(torch.ones(2, 4), torch.ones(4, 4), "bf16")


@pytest.mark.parametrize("shape", [(8, 64, 48), (4, 20, 36), (40, 128, 16)])
def test_library_products_pad_to_the_plain_products(shape):
    """The card's library calls, run on CPU tensors: ``_int_mm`` on rows
    padded above 16 and k, n to multiples of 8 equals the exact int32
    product; ``_scaled_mm`` on operands padded to multiples of 16, the
    second column-major, equals the plain fp32 product of the codes."""
    m, k, n = shape
    g = torch.Generator().manual_seed(m * k + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    assert torch.equal(Q._int8_library(xq, wq), Q.int8_product_reference(xq, wq))
    assert torch.equal(Q.int8_product(xq, wq), Q.int8_product_reference(xq, wq))
    xf, sx = Q._cast_fp8(torch.randn(m, k, generator=g))
    wf, sw = Q._cast_fp8(torch.randn(k, n, generator=g))
    got = Q._fp8_library(xf, wf, sx, sw, torch.float32)
    want = Q.fp8_product_reference(xf, wf, sx, sw, torch.float32)
    assert got.shape == (m, n)
    # the library applies sx * sw in its epilogue: fp32 rounding of the scale
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the model through the training engine
# ---------------------------------------------------------------------------
BASE = dict(vocab_size=256, hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2,
            max_seq_len=64, remat=False, dtype="float32")
DS_CONFIG = {
    "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-2, "weight_decay": 0.01}},
    "gradient_clipping": 1.0, "steps_per_print": 1000,
}


@functools.lru_cache(maxsize=1)
def _numpy_params():
    return jax.tree.map(lambda t: t.numpy(), PT.init_params(
        PT.get_config("tiny", **BASE), torch.Generator().manual_seed(0), "cpu"))


def _wide_params():
    """Fresh copies of the model's params for the file, drawn by the port
    and carried into JAX as numpy (the JAX package's eager init compiles
    per shape); ``matmul_precision`` does not change them."""
    flat = _numpy_params()
    return jax.tree.map(jnp.array, flat), jax.tree.map(lambda a: torch.from_numpy(a.copy()), flat)


def _trajectories(prec, steps=4):
    jc = JT.get_config("tiny", matmul_precision=prec, **BASE)
    pc = PT.get_config("tiny", matmul_precision=prec, **BASE)
    jp, tp = _wide_params()
    je, *_ = deepspeed_tpu.initialize(model=JT.make_loss_fn(jc), model_parameters=jp,
                                      config=copy.deepcopy(DS_CONFIG))
    pe, *_ = deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc), model_parameters=tp,
                                            config=copy.deepcopy(DS_CONFIG))
    # one batch every step (as the JAX suite trains): the loss must fall
    batch = {"input_ids": np.random.default_rng(5).integers(0, 256, size=(4, 17)).astype(np.int32)}
    rows = []
    for _ in range(steps):
        rows.append((float(je.train_batch(batch=batch)), float(pe.train_batch(batch=batch)),
                     je.get_global_grad_norm(), pe.get_global_grad_norm()))
    return rows


@pytest.mark.parametrize("prec", ["int8", "fp8"])
def test_train_batch_losses_match_the_jax_engine(prec):
    """fp32, AdamW, clipping, gas 2. The first step runs on identical
    params: its loss and gradient norm equal the JAX engine's to fp32 sums
    in another order (1e-5). From the second step the params differ by the
    update's ~1e-7, and a code whose value sits on a rounding boundary
    flips, which moves the quantized forward by a quantization step: the
    trajectories stay within 1e-2 relative (4 steps), and the loss falls."""
    rows = _trajectories(prec)
    jl, pl, jn, pn = rows[0]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    np.testing.assert_allclose(pn, jn, rtol=1e-5)
    for jl, pl, jn, pn in rows[1:]:
        np.testing.assert_allclose(pl, jl, rtol=1e-2)
        np.testing.assert_allclose(pn, jn, rtol=1e-2)
    assert rows[-1][1] < rows[0][1]


def test_quantized_forward_differs_from_default():
    """Control: the quantized precisions change the loss (so the parity
    above compares the quantized forward, not the dense one)."""
    _, tp = _wide_params()
    batch = {"input_ids": torch.from_numpy(
        np.random.default_rng(6).integers(0, 256, size=(2, 17)).astype(np.int64))}
    losses = {p: float(PT.make_loss_fn(PT.get_config("tiny", matmul_precision=p, **BASE))(
        tp, batch)) for p in ("default", "int8", "fp8")}
    assert losses["int8"] != losses["default"] and losses["fp8"] != losses["default"]
    assert abs(losses["int8"] - losses["default"]) < 0.02 * losses["default"]


def test_matmul_precision_is_served():
    """The refusal is gone: init_params, the engines and the forward take
    every precision; an unknown one fails in the config, as in JAX."""
    from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2

    for prec in ("int8", "int8_tensor", "fp8"):
        cfg = PT.get_config("tiny", matmul_precision=prec, **BASE)
        params = PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        rc = RaggedInferenceEngineConfig.from_dict(
            {"dtype": "float32", "kv_cache": {"block_size": 16, "num_blocks": 16,
                                              "max_blocks_per_seq": 4}})
        eng = InferenceEngineV2(cfg, params, rc, device="cpu")
        out = eng.generate([np.arange(1, 9, dtype=np.int32)], max_new_tokens=3)
        assert out[0].shape == (11,)
    with pytest.raises(ValueError, match="matmul_precision"):
        PT.get_config("tiny", matmul_precision="int4")
