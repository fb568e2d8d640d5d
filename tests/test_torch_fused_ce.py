"""The port's fused LM head + cross-entropy against the JAX package's.

The same numpy arrays go through ``deepspeed_tpu.ops.fused_ce.fused_ce_loss``
(its Pallas kernels in interpret mode, as ``tests/unit/ops/test_fused_ce.py``
runs them on the CPU) and ``deepspeed_tpu_torch.ops.fused_ce.fused_ce_loss``
(on CPU tensors: the plain versions of the CUDA kernels, the same recompute
formulas). Loss, dx and dW, in fp32 (tight: the same function summed in
another order) and bf16 (one rounding of d and of each output, at other
places in XLA and torch). Card-only cases carry the ``cuda`` marker.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import fused_ce as jce
from deepspeed_tpu_torch.ops import fused_ce as pce


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_pad8_copies_keep_the_plain_backward():
    """The backward kernels' host arithmetic on CPU tensors: ``pad8`` pads x
    and w with zeros to rows of multiples of 8 (TMA's 16-byte strides) and
    leaves tensors that fit alone; the kernels' arithmetic on the padded
    copies (d masked past the true V, the planes cut back to [n, h] and
    [h, V]) equals the plain backward on the unpadded ones (fp32: the same
    products, plus exact zeros)."""
    for n, h, V in ((40, 20, 37), (24, 8, 515), (16, 13, 24)):
        x, w, labels, g = (torch.from_numpy(a) for a in _data(n, h, V, seed=8))
        xp, wp = pce.pad8(x, w)
        h8, V8 = pce.round8(h), pce.round8(V)
        assert xp.shape == (n, h8) and wp.shape == (h8, V8)
        assert xp.data_ptr() % 16 == 0 and wp.data_ptr() % 16 == 0
        assert torch.equal(xp[:, :h], x) and not xp[:, h:].any()
        assert torch.equal(wp[:h, :V], w) and not wp[h:].any() and not wp[:, V:].any()
        _, lse = pce.fused_ce_fwd_reference(x, w, labels)
        onehot = torch.arange(V8)[None, :] == labels.long()[:, None]
        d = (torch.exp(xp @ wp - lse[:, None]) - onehot.float()) * g[:, None]
        d[:, V:] = 0.0  # the kernels' column mask
        got = ((d @ wp.t())[:, :h], (xp.t() @ d)[:h, :V])
        for a, b in zip(got, pce.fused_ce_bwd_reference(x, w, labels, lse, g)):
            torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-5)
    # rows that already fit are passed on as they are; a misaligned base is copied
    x, w = torch.zeros(16, 64, dtype=torch.bfloat16), torch.zeros(64, 128, dtype=torch.bfloat16)
    xp, wp = pce.pad8(x, w)
    assert xp.data_ptr() == x.data_ptr() and wp.data_ptr() == w.data_ptr()
    odd = torch.zeros(16 * 64 + 1, dtype=torch.bfloat16)[1:].view(16, 64)
    assert odd.data_ptr() % 16 != 0
    xp, _ = pce.pad8(odd, w)
    assert xp.data_ptr() % 16 == 0 and torch.equal(xp, odd)
    assert [pce.round8(k) for k in (1, 8, 9, 50257)] == [8, 8, 16, 50264]


def _span_forward(x, w, labels, span):
    """The forward kernels' arithmetic on the CPU in fp32: the ``pad8``
    copies, logits at or past the true V set to -inf, per span of ``span``
    columns an online (max, sum-exp) over passes of 256 columns into a
    [spans, n] plane, the spans folded in order; the label's logit (none
    for a label outside [0, V))."""
    n, V = x.shape[0], w.shape[1]
    xp, wp = pce.pad8(x, w)
    logits = xp @ wp
    assert logits.shape[1] == pce.round8(V)
    logits[:, V:] = float("-inf")
    spans = -(-V // span)
    pm, pl = torch.empty(spans, n), torch.empty(spans, n)
    for j in range(spans):
        m, l = torch.full((n,), float("-inf")), torch.zeros(n)
        for c0 in range(j * span, min((j + 1) * span, V), 256):
            s = logits[:, c0:c0 + 256]
            mn = torch.maximum(m, s.max(dim=1).values)
            assert torch.isfinite(mn).all()  # a pass holds a live column
            l = l * torch.exp(m - mn) + torch.exp(s - mn[:, None]).sum(dim=1)
            m = mn
        pm[j], pl[j] = m, l
    M = pm.max(dim=0).values
    lse = M + torch.log((pl * torch.exp(pm - M)).sum(dim=0).clamp_min(1e-30))
    lbl = labels.long()
    ok = (lbl >= 0) & (lbl < V)
    tgt = torch.gather(logits, 1, lbl.clamp(0, V - 1)[:, None])[:, 0]
    return lse - torch.where(ok, tgt, torch.zeros_like(tgt)), lse


def test_span_partials_on_padded_copies_keep_the_plain_forward():
    """The forward kernels' host and merge arithmetic on CPU tensors: spans
    that do not divide V, -inf past the true V (the pad8 columns included),
    labels -100 and V among the inputs. Loss and lse equal the plain forward,
    and the loss equals the JAX kernel's (interpret mode), in fp32."""
    for (n, h, V), span in (((40, 20, 37), 256), ((24, 8, 515), 256), ((33, 24, 130), 512),
                            ((16, 13, 1300), 512), ((8, 64, 2100), 1024)):
        x, w, labels, _ = _data(n, h, V, seed=11)
        labels[0], labels[-1] = -100, V
        xt, wt, lt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(labels)
        loss, lse = _span_forward(xt, wt, lt, span)
        want_loss, want_lse = pce.fused_ce_fwd_reference(xt, wt, lt)
        torch.testing.assert_close(loss, want_loss, atol=FP32_ATOL, rtol=FP32_RTOL)
        torch.testing.assert_close(lse, want_lse, atol=FP32_ATOL, rtol=FP32_RTOL)
        assert loss[0] == lse[0] and loss[-1] == lse[-1]  # no logit for -100 or V
        jl = jce.fused_ce_loss(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels), interpret=True)
        np.testing.assert_allclose(loss.numpy(), np.asarray(jl), atol=FP32_ATOL, rtol=FP32_RTOL)
    assert pce.FWD_SPAN % 256 == 0


def test_backward_kernels_are_the_wgmma_source():
    """The registry's forward, dx and dW entries name ``fused_ce.cu`` and
    ``fused_ce_bwd.cu`` and keep their JAX origins; both sources run wgmma on
    tiles brought by TMA (the shared ``hopper_common.cuh``) through one
    logits pass (``fused_ce_hopper.cuh``) and hold none of the Ampere path,
    and neither defines the other's entry points."""
    from deepspeed_tpu_torch.ops.kernels import CSRC, KERNELS

    root = Path(__file__).resolve().parents[1]
    for name, src, body in (("fused_ce_fwd", "fused_ce.cu", "_fwd_kernel"),
                            ("fused_ce_dx", "fused_ce_bwd.cu", "_bwd_dx_kernel"),
                            ("fused_ce_dw", "fused_ce_bwd.cu", "_bwd_dw_kernel")):
        k = KERNELS[name]
        assert k.source == src and k.source_path.is_file()
        path, line = k.replaces.rsplit(":", 1)
        assert path == "deepspeed_tpu/ops/fused_ce.py"
        assert (root / path).read_text().splitlines()[int(line) - 1].startswith(f"def {body}(")
    bwd = (CSRC / "fused_ce_bwd.cu").read_text()
    fwd = (CSRC / "fused_ce.cu").read_text()
    logits = (CSRC / "fused_ce_hopper.cuh").read_text()
    hopper = (CSRC / "hopper_common.cuh").read_text()
    for src in (bwd, fwd):
        assert '#include "hopper_common.cuh"' in src and '#include "fused_ce_hopper.cuh"' in src
        assert "flash_common" not in src
        # the shared logits pass, loaded by TMA and multiplied by wgmma
        assert "load_logits_pass<" in src and "logits_pass<" in src
        assert "wgmma_m64n" in src + logits and "tma_load_2d" in src + logits
    assert '#include "hopper_common.cuh"' in logits
    assert "wgmma_m64n256k16" in logits and "tma_load_2d" in logits
    assert "wgmma.mma_async" in hopper and "cp.async.bulk.tensor" in hopper
    for src in (bwd, fwd, logits, hopper):
        assert "mma.sync" not in src and "cp.async.cg" not in src
    assert "dstt_fused_ce_dx" not in fwd and "dstt_fused_ce_dw" not in fwd
    assert "dstt_fused_ce_fwd" not in bwd
    # the forward merges its spans without atomics: loss and lse repeat
    assert not any(op in fwd for op in ("atomicAdd", "atomicMax", "red_add", "red_fragment"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 128, 1000), (130, 72, 515), (777, 1000, 3001),
                                   (100, 64, 700), (33, 24, 130), (1, 8, 5)])
def test_cuda_kernels_match_plain(shape):
    """Loss and gradients against the plain versions, from shapes smaller
    than one tile and one span up; labels -100 and V contribute no logit;
    two forward launches give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    n, h, V = shape
    x, w, labels, g = (torch.from_numpy(a).cuda() for a in _data(n, h, V, seed=7))
    labels[0] = -100
    if n > 1:
        labels[-1] = V
    x, w = x.bfloat16().requires_grad_(True), w.bfloat16().requires_grad_(True)
    loss = pce.fused_ce_loss(x, w, labels)
    dx, dw = torch.autograd.grad(loss, (x, w), g)
    ref_loss, lse = pce.fused_ce_fwd_reference(x.detach(), w.detach(), labels)
    loss_a, lse_a = pce.fused_ce_fwd_cuda(x.detach(), w.detach(), labels)
    loss_b, lse_b = pce.fused_ce_fwd_cuda(x.detach(), w.detach(), labels)
    assert torch.equal(loss_a, loss_b) and torch.equal(lse_a, lse_b) and torch.equal(loss_a, loss)
    torch.testing.assert_close(lse_a, lse, atol=BF16_LOSS_ATOL, rtol=FP32_RTOL)
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


@pytest.mark.cuda
@pytest.mark.parametrize("frozen", ["w", "x"])
def test_cuda_backward_launches_only_the_gradient_asked_for(frozen):
    """A frozen w launches dx alone, a frozen x dW alone (the launch
    counters), and the one gradient still matches the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from deepspeed_tpu_torch.ops import kernels as K

    x, w, labels, g = (torch.from_numpy(a).cuda() for a in _data(300, 520, 3000, seed=9))
    x, w = x.bfloat16().requires_grad_(frozen != "x"), w.bfloat16().requires_grad_(frozen != "w")
    loss = pce.fused_ce_loss(x, w, labels)
    K.reset_counts()
    (got,) = torch.autograd.grad(loss, (w if frozen == "x" else x), g)
    counts = K.counts()
    assert counts["fused_ce_dx"] == (frozen == "w") and counts["fused_ce_dw"] == (frozen == "x")
    _, lse = pce.fused_ce_fwd_reference(x.detach(), w.detach(), labels)
    rdx, rdw = pce.fused_ce_bwd_reference(x.detach(), w.detach(), labels, lse, g)
    want = rdw if frozen == "x" else rdx
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_GRAD_RTOL,
                               atol=BF16_GRAD_RTOL * float(want.float().abs().max()))
