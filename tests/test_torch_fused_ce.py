"""The port's fused LM head + cross-entropy against the JAX package's.

The same numpy arrays go through ``deepspeed_tpu.ops.fused_ce.fused_ce_loss``
(its Pallas kernels in interpret mode, as ``tests/unit/ops/test_fused_ce.py``
runs them on the CPU) and ``deepspeed_tpu_torch.ops.fused_ce.fused_ce_loss``
(on CPU tensors: the plain versions of the CUDA kernels, the same recompute
formulas). Loss, dx and dW, in fp32 (tight: the same function summed in
another order) and bf16 (one rounding of d and of each output, at other
places in XLA and torch). Card-only cases carry the ``cuda`` marker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import fused_ce as jce
from deepspeed_tpu_torch.ops import fused_ce as pce

# fp32: sums of h products and V exponentials in another order
FP32_ATOL = FP32_RTOL = 2e-5
# bf16 operands: logits are fp32 sums of exact products on both sides, so
# the loss differs as in fp32; d and the outputs round once to bf16 (2^-8)
BF16_LOSS_ATOL = 2e-4
BF16_GRAD_RTOL = 2.0 ** -6


def _data(n, h, V, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h)).astype(np.float32)
    w = (rng.standard_normal((h, V)) * 0.05).astype(np.float32)
    labels = rng.integers(0, V, size=(n,)).astype(np.int32)
    g = rng.random(n).astype(np.float32) / n
    g[rng.random(n) < 0.2] = 0.0  # masked rows
    return x, w, labels, g


def _jax_loss_and_grads(x, w, labels, g, dtype):
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    lj, gj = jnp.asarray(labels), jnp.asarray(g)

    def total(x_, w_):
        return jnp.sum(jce.fused_ce_loss(x_, w_, lj, interpret=True) * gj)

    loss = jce.fused_ce_loss(xj, wj, lj, interpret=True)
    dx, dw = jax.grad(total, argnums=(0, 1))(xj, wj)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return f32(loss), f32(dx), f32(dw)


def _port_loss_and_grads(x, w, labels, g, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    wt = torch.from_numpy(w).to(dtype).requires_grad_(True)
    loss = pce.fused_ce_loss(xt, wt, torch.from_numpy(labels))
    dx, dw = torch.autograd.grad(loss, (xt, wt), torch.from_numpy(g))
    assert loss.dtype == torch.float32 and dx.dtype == dtype and dw.dtype == dtype
    return loss.detach().numpy(), dx.float().numpy(), dw.float().numpy()


# V 300 divides no 128-wide tile; n 40 is a single short row block
SHAPES = {"n64_h32_V512": (64, 32, 512), "n40_h48_V300": (40, 48, 300)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fp32_loss_and_grads_match_jax_kernels(shape):
    x, w, labels, g = _data(*SHAPES[shape], seed=1)
    jl, jdx, jdw = _jax_loss_and_grads(x, w, labels, g, jnp.float32)
    pl, pdx, pdw = _port_loss_and_grads(x, w, labels, g, torch.float32)
    np.testing.assert_allclose(pl, jl, atol=FP32_ATOL, rtol=FP32_RTOL)
    np.testing.assert_allclose(pdx, jdx, atol=FP32_ATOL * np.abs(jdx).max(), rtol=FP32_RTOL)
    np.testing.assert_allclose(pdw, jdw, atol=FP32_ATOL * np.abs(jdw).max(), rtol=FP32_RTOL)
    assert not pdx[g == 0].any()  # a masked row has no gradient


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bf16_loss_and_grads_match_jax_kernels(shape):
    x, w, labels, g = _data(*SHAPES[shape], seed=2)
    jl, jdx, jdw = _jax_loss_and_grads(x, w, labels, g, jnp.bfloat16)
    pl, pdx, pdw = _port_loss_and_grads(x, w, labels, g, torch.bfloat16)
    np.testing.assert_allclose(pl, jl, atol=BF16_LOSS_ATOL, rtol=FP32_RTOL)
    for got, want in ((pdx, jdx), (pdw, jdw)):
        np.testing.assert_allclose(got, want, atol=BF16_GRAD_RTOL * np.abs(want).max(),
                                   rtol=BF16_GRAD_RTOL)


def test_reference_matches_jax_reference_and_the_fused_loss():
    x, w, labels, _ = _data(64, 32, 300, seed=3)
    want = np.asarray(jce.fused_ce_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels)))
    xt, wt, lt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(labels)
    np.testing.assert_allclose(pce.fused_ce_reference(xt, wt, lt).numpy(), want,
                               atol=FP32_ATOL, rtol=FP32_RTOL)
    np.testing.assert_allclose(pce.fused_ce_loss(xt, wt, lt).numpy(), want,
                               atol=FP32_ATOL, rtol=FP32_RTOL)


def test_plain_backward_is_autograd_of_the_dense_reference():
    """The recompute formulas against autograd through the dense loss (fp32:
    rounding d to the operand type changes nothing)."""
    x, w, labels, g = _data(48, 24, 200, seed=4)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    lt, gt = torch.from_numpy(labels), torch.from_numpy(g)
    want = torch.autograd.grad(pce.fused_ce_reference(xt, wt, lt), (xt, wt), gt)
    _, lse = pce.fused_ce_fwd_reference(xt.detach(), wt.detach(), lt)
    got = pce.fused_ce_bwd_reference(xt.detach(), wt.detach(), lt, lse, gt)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-5)


def test_tied_head_view_lands_on_the_embedding():
    """A tied head is a transposed view of the embedding: dW flows through
    the transpose onto ``embed`` (fp32: equal to autograd of the dense loss)."""
    rng = np.random.default_rng(5)
    embed = torch.from_numpy(rng.standard_normal((96, 16)).astype(np.float32) * 0.1)
    x = torch.from_numpy(rng.standard_normal((24, 16)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 96, size=(24,)).astype(np.int32))
    grads = []
    for fn in (pce.fused_ce_loss, pce.fused_ce_reference):
        e = embed.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(x, e.t(), labels).mean(), e)
        assert g.shape == embed.shape
        grads.append(g)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-7, rtol=1e-5)


def test_a_cuda_tensor_never_takes_the_plain_version():
    """Without a card the wrappers must raise for anything that is not a CPU
    tensor path: here, the kernels' own argument checks on CPU tensors."""
    x, w, labels, g = (torch.from_numpy(a) for a in _data(8, 8, 16, seed=6))
    with pytest.raises(ValueError, match="CUDA device"):
        pce.fused_ce_fwd_cuda(x.bfloat16(), w.bfloat16(), labels)
    with pytest.raises(ValueError, match="CUDA device"):
        pce.fused_ce_dx_cuda(x.bfloat16(), w.bfloat16(), labels, g, g)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 128, 1000), (130, 72, 515)])
def test_cuda_kernels_match_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    n, h, V = shape
    x, w, labels, g = (torch.from_numpy(a).cuda() for a in _data(n, h, V, seed=7))
    x, w = x.bfloat16().requires_grad_(True), w.bfloat16().requires_grad_(True)
    loss = pce.fused_ce_loss(x, w, labels)
    dx, dw = torch.autograd.grad(loss, (x, w), g)
    ref_loss, lse = pce.fused_ce_fwd_reference(x.detach(), w.detach(), labels)
    rdx, rdw = pce.fused_ce_bwd_reference(x.detach(), w.detach(), labels, lse, g)
    torch.testing.assert_close(loss, ref_loss, atol=BF16_LOSS_ATOL, rtol=FP32_RTOL)
    for got, want in ((dx, rdx), (dw, rdw)):
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_GRAD_RTOL,
                                   atol=BF16_GRAD_RTOL * float(want.float().abs().max()))
    with pytest.raises(NotImplementedError, match="bf16"):
        pce.fused_ce_loss(x.detach().float(), w.detach().float(), labels)
    # a tied head: w is a transposed view of the embedding, dW lands on it
    embed = w.detach().t().contiguous().requires_grad_(True)
    (de,) = torch.autograd.grad(pce.fused_ce_loss(x.detach(), embed.t(), labels), embed, g)
    assert de.shape == embed.shape
    # (atomic adds sum in an order that changes from launch to launch)
    torch.testing.assert_close(de.float(), rdw.float().t(), rtol=BF16_GRAD_RTOL,
                               atol=BF16_GRAD_RTOL * float(rdw.float().abs().max()))
