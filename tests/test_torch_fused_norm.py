"""RMSNorm of the PyTorch port against the JAX package's Pallas bodies.

The same inputs, made from a seed with numpy, go through the port's
``rms_norm`` and ``fused_rms_norm`` (CPU tensors: the plain versions the
CUDA kernels are held to) and the JAX package's
``fused_rms_norm(..., interpret=True)``, the Pallas ``_rms_fwd_kernel``
and, through its ``custom_vjp``, ``_rms_bwd_kernel`` run in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.normalization.fused_norm import fused_rms_norm
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.ops.normalization import fused_norm as port
from deepspeed_tpu_torch.ops.normalization import rms_norm


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# fp32 in, fp32 statistics on both sides: only the order of the row sum
# differs, a few fp32 units in the last place of O(1) outputs
FP32_ATOL = FP32_RTOL = 1e-5
# bf16 outputs: both sides compute in fp32 and round once, so a rounding
# boundary can put them one bf16 unit apart (2^-8 relative)
BF16_ATOL = BF16_RTOL = 2.0 ** -7


def _jax_ref(x, w, eps):
    return np.asarray(fused_rms_norm(jnp.asarray(x), jnp.asarray(w), eps, True)).astype(np.float32)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


@pytest.mark.parametrize("rows,h", [(13, 96), (8, 128), (5, 128), (1, 96)])
def test_fp32_matches_pallas_body(rows, h):
    rng = np.random.default_rng(rows * 1000 + h)
    x = rng.normal(size=(rows, h)).astype(np.float32) * 3.0
    w = rng.normal(size=(h,)).astype(np.float32)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), _jax_ref(x, w, 1e-5), atol=FP32_ATOL, rtol=FP32_RTOL)


@pytest.mark.parametrize("w_dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("rows,h", [(11, 128), (3, 96)])
def test_bf16_input_matches_pallas_body(rows, h, w_dtype):
    """bf16 activations; the weight is bf16, or fp32 as rmsnorm_1p passes
    ``1 + w``."""
    rng = np.random.default_rng(7 + rows + h)
    x = _bf16(rng.normal(size=(rows, h)))
    w = rng.normal(size=(h,)).astype(np.float32)
    if w_dtype == "bf16":
        w = _bf16(w)
    xt = params_from_numpy({"x": x, "w": w})
    got = rms_norm(xt["x"], xt["w"], 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), _jax_ref(x, w, 1e-6), atol=BF16_ATOL, rtol=BF16_RTOL
    )


def test_leading_dims_kept():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 96)).astype(np.float32)
    w = rng.normal(size=(96,)).astype(np.float32)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (2, 5, 96)
    np.testing.assert_allclose(got.numpy(), _jax_ref(x, w, 1e-5), atol=FP32_ATOL, rtol=FP32_RTOL)


def test_layer_norm_matches_jax_reference():
    from deepspeed_tpu.ops.normalization.fused_norm import layer_norm_reference

    rng = np.random.default_rng(4)
    x, w, b = (rng.normal(size=s).astype(np.float32) for s in ((6, 96), (96,), (96,)))
    got = port.layer_norm_reference(*(torch.from_numpy(a) for a in (x, w, b)))
    want = np.asarray(layer_norm_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=FP32_RTOL)


def test_plain_forward_norms_through_the_plain_rmsnorm(monkeypatch):
    """The plain forward (``forward_reference``) is the engine's logit
    reference: its 2L + 1 norms go through ``rms_norm_reference``, never the
    kernel's wrapper, so a fault in the kernel cannot show on both sides of
    the comparison. (``rms_norm`` reaches the plain version through its own
    module, which this count does not see.)"""
    from deepspeed_tpu_torch.models import transformer as T

    seen = []

    def counting(x, w, eps=1e-5):
        seen.append(tuple(x.shape))
        return port.rms_norm_reference(x, w, eps)

    monkeypatch.setattr(T, "rms_norm_reference", counting)
    cfg = T.get_config("tiny", dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    T.forward_reference(params, torch.zeros(1, 5, dtype=torch.long), cfg)
    assert len(seen) == 2 * cfg.n_layers + 1


def _jax_vjp(x, w, g, eps):
    """(dx, dw) of the JAX fused_rms_norm's custom_vjp in interpret mode
    (the Pallas _rms_bwd_kernel for dx, its jnp row reduction for dw)."""
    import jax

    _, vjp = jax.vjp(lambda x_, w_: fused_rms_norm(x_, w_, eps, True), jnp.asarray(x),
                     jnp.asarray(w))
    return tuple(np.asarray(a).astype(np.float32) for a in vjp(jnp.asarray(g)))


@pytest.mark.parametrize("case", ["fp32", "bf16", "bf16_fp32_weight"])
def test_backward_matches_pallas_body(case):
    """dx and dw of the port's ``fused_rms_norm`` (its autograd Function on
    CPU tensors: the kernel's plain formula for dx, the torch row reduction
    for dw) against the JAX vjp. fp32 tight; bf16 within a few bf16 units,
    since both compute in fp32 and round once; dw sums over rows in fp32."""
    rng = np.random.default_rng(len(case))
    rows, h, eps = 24, 128, 1e-5
    x = rng.normal(size=(rows, h)).astype(np.float32) * 2.0
    w = (1 + 0.1 * rng.normal(size=(h,))).astype(np.float32)
    g = rng.normal(size=(rows, h)).astype(np.float32)
    if case != "fp32":
        x, g = _bf16(x), _bf16(g)
        if case == "bf16":
            w = _bf16(w)
    want_dx, want_dw = _jax_vjp(x, w, g, eps)
    t = params_from_numpy({"x": x, "w": w, "g": g})
    xt = t["x"].clone().requires_grad_(True)
    wt = t["w"].clone().requires_grad_(True)
    y = port.fused_rms_norm(xt, wt, eps)
    y.backward(t["g"])
    assert xt.grad.dtype == xt.dtype and wt.grad.dtype == wt.dtype
    tol = FP32_ATOL if case == "fp32" else BF16_ATOL
    np.testing.assert_allclose(xt.grad.float().numpy(), want_dx, atol=tol, rtol=tol)
    np.testing.assert_allclose(wt.grad.float().numpy(), want_dw, atol=tol * 10, rtol=tol)
    # rms_norm on a CPU tensor: the plain version under autograd, the same
    # gradients as the JAX package's jnp path on the CPU
    xr = t["x"].clone().requires_grad_(True)
    wr = t["w"].clone().requires_grad_(True)
    rms_norm(xr, wr, eps).backward(t["g"])
    np.testing.assert_allclose(xr.grad.float().numpy(), want_dx, atol=tol, rtol=tol)
    np.testing.assert_allclose(wr.grad.float().numpy(), want_dw, atol=tol * 10, rtol=tol)


def test_rmsnorm_1p_weight_gradient_reaches_the_bf16_param():
    """gemma's rmsnorm_1p passes ``1 + w`` in fp32: the gradient flows back
    through the add to the bf16 parameter."""
    from deepspeed_tpu_torch.models import transformer as T

    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32)).bfloat16()
    w = torch.zeros(64, dtype=torch.bfloat16, requires_grad=True)
    y = T._norm(x, w, None, "rmsnorm_1p", 1e-6)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert w.grad.dtype == torch.bfloat16 and bool(torch.isfinite(w.grad.float()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,h", [(1056, 4096), (7, 96), (5, 100)])
def test_cuda_kernel_matches_plain(rows, h):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(rows)
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(rows, h, generator=gen, device="cuda").to(dt)
        w = torch.randn(h, generator=gen, device="cuda").to(dt)
        before = port.RMS_KERNEL.launches
        got = port.rms_norm_cuda(x, w)
        assert port.RMS_KERNEL.launches == before + 1
        tol = BF16_ATOL if dt == torch.bfloat16 else FP32_ATOL
        torch.testing.assert_close(
            got.float(), port.rms_norm_reference(x, w).float(), atol=tol, rtol=tol
        )


@pytest.mark.cuda
@pytest.mark.parametrize("rows,h", [(4096, 4096), (7, 96), (5, 100)])
def test_cuda_backward_kernel_matches_plain(rows, h):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(rows + h)
    for dt, wdt in ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                    (torch.float32, torch.float32)):
        x = torch.randn(rows, h, generator=gen, device="cuda").to(dt)
        w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(wdt)
        g = torch.randn(rows, h, generator=gen, device="cuda").to(dt)
        before = port.RMS_BWD_KERNEL.launches
        got = port.rms_norm_bwd_cuda(x, w, g)
        assert port.RMS_BWD_KERNEL.launches == before + 1
        tol = BF16_ATOL if dt == torch.bfloat16 else FP32_ATOL
        torch.testing.assert_close(got.float(), port.rms_norm_bwd_reference(x, w, g).float(),
                                   atol=tol, rtol=tol)
