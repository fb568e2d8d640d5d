"""Fused LM head + cross-entropy for the port: three hand-written CUDA kernels.

Counterpart of ``deepspeed_tpu/ops/fused_ce.py``. For hidden rows ``x``
[n, h], the head matrix ``w`` [h, V] and ``labels`` [n]:

    loss_i = logsumexp_v (x w)_iv - (x w)_i[label_i]

without the [n, V] logits ever reaching device memory. Three kernels in
``ops/kernels/csrc/fused_ce.cu``:

  * ``fused_ce_fwd`` replaces ``_fwd_kernel``: per-row loss and the fp32
    log-sum-exp the backward recomputes from;
  * ``fused_ce_dx``  replaces ``_bwd_dx_kernel``: ``d = (exp(logits - lse) -
    onehot) * g`` rounded to the operand type, ``dx = d w^T`` summed in fp32;
  * ``fused_ce_dw``  replaces ``_bwd_dw_kernel``: ``dW = x^T d`` summed in
    fp32.

``fused_ce_loss`` is a ``torch.autograd.Function`` over them that saves
``(x, w, labels, lse)``. Beside the kernels stand their plain versions
(``fused_ce_fwd_reference``, ``fused_ce_bwd_reference``, written from the
same recompute formulas) and the dense ``fused_ce_reference``. A CPU tensor
takes the plain versions; a CUDA tensor launches the kernels or raises for
what they do not take (a dtype other than bf16). Nothing falls back.

``w`` must be [h, V] row-major for the kernels. A tied head arrives as a
transposed view of the embedding: the wrapper then makes one contiguous
copy, knowingly (one pass over the matrix); the Function returns dW in
``w``'s shape and autograd carries it through the transpose onto the
embedding.

dx and dW are summed with fp32 atomic adds, in whatever order the card
runs the CTAs: on a CUDA tensor their last bits change from launch to
launch (the forward does not: loss and lse repeat bit for bit). The CPU
path and the dense head are deterministic.
"""

import torch

from deepspeed_tpu_torch.ops.kernels import KERNELS, stream_ptr

FWD_KERNEL = KERNELS["fused_ce_fwd"]
DX_KERNEL = KERNELS["fused_ce_dx"]
DW_KERNEL = KERNELS["fused_ce_dw"]
_TILE = 128  # the kernels' vocabulary tile (fused_ce.cu: BN)


def fused_ce_reference(x, w, labels):
    """Dense reference: fp32 logits, logsumexp minus the label's logit."""
    logits = x.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return lse - tgt


def _logits(x, w):
    """x w with fp32 sums, as the kernels' tensor-core products give."""
    return x.float() @ w.float()


def fused_ce_fwd_reference(x, w, labels):
    """Plain forward: (loss [n], lse [n]), fp32. A label outside [0, V)
    contributes no logit, as in the kernel."""
    logits = _logits(x, w)
    m = logits.max(dim=-1).values
    l = torch.exp(logits - m[:, None]).sum(dim=-1)
    lse = m + torch.log(l.clamp_min(1e-30))
    lbl = labels.long()
    ok = (lbl >= 0) & (lbl < w.shape[1])
    tgt = torch.gather(logits, 1, lbl.clamp(0, w.shape[1] - 1)[:, None])[:, 0]
    return lse - torch.where(ok, tgt, torch.zeros_like(tgt)), lse


def fused_ce_bwd_reference(x, w, labels, lse, g):
    """Plain backward from the saved lse: ``d`` rounded to the operand type
    before both products, sums in fp32, each result rounded once. Returns
    (dx in x's dtype, dW in w's dtype)."""
    p = torch.exp(_logits(x, w) - lse.float()[:, None])
    onehot = torch.arange(w.shape[1], device=x.device)[None, :] == labels.long()[:, None]
    d = ((p - onehot.float()) * g.float()[:, None])
    dx = (d.to(w.dtype).float() @ w.float().t()).to(x.dtype)
    dw = (x.float().t() @ d.to(x.dtype).float()).to(w.dtype)
    return dx, dw


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------
def _kernel_args(where, x, w, labels, *rows):
    """Check what the kernels take; return contiguous tensors (labels as
    int32, per-row vectors as fp32) and (n, h, V)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] or labels.shape != x.shape[:1]:
        raise ValueError(f"{where}: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"labels {tuple(labels.shape)}")
    tensors = (x, w, labels) + rows
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError(f"{where}: every tensor must be on one CUDA device "
                         f"(got {sorted({str(t.device) for t in tensors})})")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{where}: x/w {x.dtype}/{w.dtype}; the kernels take bf16 (fp32 runs the plain "
            "version on the CPU only)")
    n, h = x.shape
    V = w.shape[1]
    if n == 0 or h == 0 or V == 0:
        raise ValueError(f"{where}: empty problem n {n}, h {h}, V {V}")
    for t in rows:
        if t.shape != (n,):
            raise ValueError(f"{where}: a per-row vector of shape {tuple(t.shape)}, expected {(n,)}")
    # a tied head is a transposed view: the kernels read [h, V] row-major
    out = [x.contiguous(), w.contiguous(), labels.to(torch.int32).contiguous()]
    out += [t.float().contiguous() for t in rows]
    return out, (n, h, V)


def fused_ce_fwd_cuda(x, w, labels):
    """Launch the forward kernel. Returns (loss [n], lse [n]), fp32."""
    (x, w, labels), (n, h, V) = _kernel_args("fused_ce_fwd_cuda", x, w, labels)
    tiles = -(-V // _TILE)
    part = torch.empty((2, tiles, n), device=x.device, dtype=torch.float32)
    tgt = torch.zeros(n, device=x.device, dtype=torch.float32)
    loss = torch.empty(n, device=x.device, dtype=torch.float32)
    lse = torch.empty(n, device=x.device, dtype=torch.float32)
    rc = FWD_KERNEL.fn()(x.data_ptr(), w.data_ptr(), labels.data_ptr(), part[0].data_ptr(),
                         part[1].data_ptr(), tgt.data_ptr(), loss.data_ptr(), lse.data_ptr(),
                         n, h, V, stream_ptr(x))
    FWD_KERNEL.check(rc)
    FWD_KERNEL.launches += 1
    return loss, lse


def fused_ce_dx_cuda(x, w, labels, lse, g):
    """Launch the dx kernel. Returns dx (bf16, x's shape): fp32 sums in a
    zeroed [n, h] plane, rounded once."""
    (x, w, labels, lse, g), (n, h, V) = _kernel_args("fused_ce_dx_cuda", x, w, labels, lse, g)
    dx32 = torch.zeros((n, h), device=x.device, dtype=torch.float32)
    rc = DX_KERNEL.fn()(x.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                        g.data_ptr(), dx32.data_ptr(), n, h, V, stream_ptr(x))
    DX_KERNEL.check(rc)
    DX_KERNEL.launches += 1
    return dx32.to(x.dtype)


def fused_ce_dw_cuda(x, w, labels, lse, g):
    """Launch the dW kernel. Returns dW (bf16, [h, V]): fp32 sums in a
    zeroed [h, V] plane, rounded once."""
    (x, w, labels, lse, g), (n, h, V) = _kernel_args("fused_ce_dw_cuda", x, w, labels, lse, g)
    dw32 = torch.zeros((h, V), device=x.device, dtype=torch.float32)
    rc = DW_KERNEL.fn()(x.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                        g.data_ptr(), dw32.data_ptr(), n, h, V, stream_ptr(x))
    DW_KERNEL.check(rc)
    DW_KERNEL.launches += 1
    return dw32.to(w.dtype)


class FusedCrossEntropy(torch.autograd.Function):
    """The kernels (CUDA tensors) or their plain versions (CPU tensors)
    under one autograd node; saves x, w, labels and the fp32 lse."""

    @staticmethod
    def forward(ctx, x, w, labels):
        if x.device.type == "cpu":
            loss, lse = fused_ce_fwd_reference(x, w, labels)
        else:
            loss, lse = fused_ce_fwd_cuda(x, w, labels)
        ctx.save_for_backward(x, w, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad[:2]
        dx = dw = None
        if x.device.type == "cpu":
            dx, dw = fused_ce_bwd_reference(x, w, labels, lse, g)
        else:
            if need_dx:
                dx = fused_ce_dx_cuda(x, w, labels, lse, g)
            if need_dw:
                dw = fused_ce_dw_cuda(x, w, labels, lse, g)
        return (dx if need_dx else None), (dw if need_dw else None), None


def fused_ce_loss(x, w, labels):
    """Per-row cross-entropy of ``softmax(x @ w)`` against ``labels``
    without materializing the [n, V] logits. x: [n, h]; w: [h, V]; labels:
    [n] integers -> loss [n] fp32. Differentiable in x and w."""
    return FusedCrossEntropy.apply(x, w, labels)


__all__ = ["fused_ce_bwd_reference", "fused_ce_dw_cuda", "fused_ce_dx_cuda",
           "fused_ce_fwd_cuda", "fused_ce_fwd_reference", "fused_ce_loss", "fused_ce_reference"]
