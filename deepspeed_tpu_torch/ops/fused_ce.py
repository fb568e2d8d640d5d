"""Fused LM head + cross-entropy for the port: three hand-written CUDA kernels.

Counterpart of ``deepspeed_tpu/ops/fused_ce.py``. For hidden rows ``x``
[n, h], the head matrix ``w`` [h, V] and ``labels`` [n]:

    loss_i = logsumexp_v (x w)_iv - (x w)_i[label_i]

without the [n, V] logits ever reaching device memory. Three kernels, all
on one logits pass (``ops/kernels/csrc/fused_ce_hopper.cuh``: wgmma fed by
TMA), so the forward's logits are the ones the backward recomputes, bit
for bit:

  * ``fused_ce_fwd`` (``fused_ce.cu``) replaces ``_fwd_kernel``: per-row
    loss and the fp32 log-sum-exp the backward recomputes from. A CTA
    reduces 128 rows x a span of ``FWD_SPAN`` vocabulary columns to a
    per-row (max, sum-exp) pair in a [spans, n] fp32 plane, and a second
    kernel of the same call folds the spans in a fixed order;
  * ``fused_ce_dx`` (``fused_ce_bwd.cu``, wgmma fed by TMA) replaces
    ``_bwd_dx_kernel``: ``d = (exp(logits - lse) - onehot) * g`` rounded to
    the operand type, ``dx = d w^T`` summed in fp32;
  * ``fused_ce_dw`` (``fused_ce_bwd.cu``) replaces ``_bwd_dw_kernel``:
    ``dW = x^T d`` summed in fp32.

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
embedding. The kernels read x and w through TMA, which wants row
lengths that are multiples of 8 elements (16 bytes) and 16-byte aligned
bases: where h or V is not a multiple of 8 (GPT-2's vocabulary of 50257),
``pad8`` makes zero-padded copies x [n, h8] and w [h8, V8] once per call
(zeros change no sum; the kernels mask d past the true V), and the
outputs are cut back to [n, h] and [h, V].

dx and dW are summed with fp32 atomic adds, in whatever order the card
runs the CTAs: on a CUDA tensor their last bits change from launch to
launch (the forward does not: it uses no atomics, so loss and lse repeat
bit for bit). The CPU path and the dense head are deterministic.
"""

import torch

from deepspeed_tpu_torch.ops.kernels import KERNELS, stream_ptr

FWD_KERNEL = KERNELS["fused_ce_fwd"]
DX_KERNEL = KERNELS["fused_ce_dx"]
DW_KERNEL = KERNELS["fused_ce_dw"]
# vocabulary columns of a forward CTA (a multiple of fused_ce_hopper.cuh's
# 256-column pass); tools/torch_fused_ce_ab.py --sweep times others
FWD_SPAN = 1024


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


def fused_ce_fwd_cuda(x, w, labels, span=FWD_SPAN):
    """Launch the forward kernels (the span kernel and the merge) on the
    padded operands. Returns (loss [n], lse [n]), fp32."""
    (x, w, labels), (n, h, V) = _kernel_args("fused_ce_fwd_cuda", x, w, labels)
    if span <= 0 or span % 256:
        raise ValueError(f"fused_ce_fwd_cuda: span {span} is not a positive multiple of 256")
    xp, wp = pad8(x, w)
    part = torch.empty((2, -(-V // span), n), device=x.device, dtype=torch.float32)
    tgt, loss, lse = (torch.empty(n, device=x.device, dtype=torch.float32) for _ in range(3))
    rc = FWD_KERNEL.fn()(xp.data_ptr(), wp.data_ptr(), labels.data_ptr(), part[0].data_ptr(),
                         part[1].data_ptr(), tgt.data_ptr(), loss.data_ptr(), lse.data_ptr(),
                         n, h, V, span, stream_ptr(x))
    FWD_KERNEL.check(rc)
    FWD_KERNEL.launches += 1
    return loss, lse


def round8(k):
    """The next multiple of 8 (a 16-byte row of bf16) at or above k."""
    return -(-k // 8) * 8


def _aligned(t):
    return t if t.data_ptr() % 16 == 0 else t.clone()


def pad8(x, w):
    """x [n, h8] and w [h8, V8] for the kernels (h8, V8 = h, V
    rounded up to multiples of 8): the tensors themselves where they already
    fit, else zero-padded copies; each base 16-byte aligned."""
    h, V = w.shape
    h8, V8 = round8(h), round8(V)
    if h8 != h:
        x = torch.nn.functional.pad(x, (0, h8 - h))
    if (h8, V8) != (h, V):
        w = torch.nn.functional.pad(w, (0, V8 - V, 0, h8 - h))
    return _aligned(x), _aligned(w)


def _bwd_cuda(kernel, where, x, w, labels, lse, g):
    """Launch one backward kernel on the padded operands. Returns its fp32
    plane (dx [n, h8], dW [h8, V8]), zeroed and then summed into."""
    (x, w, labels, lse, g), (n, h, V) = _kernel_args(where, x, w, labels, lse, g)
    xp, wp = pad8(x, w)
    shape = (n, xp.shape[1]) if kernel is DX_KERNEL else tuple(wp.shape)
    out = torch.zeros(shape, device=x.device, dtype=torch.float32)
    rc = kernel.fn()(xp.data_ptr(), wp.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                     g.data_ptr(), out.data_ptr(), n, h, V, stream_ptr(x))
    kernel.check(rc)
    kernel.launches += 1
    return out


def fused_ce_dx_cuda(x, w, labels, lse, g):
    """Launch the dx kernel. Returns dx (bf16, x's shape): fp32 sums in a
    zeroed plane, rounded once."""
    out = _bwd_cuda(DX_KERNEL, "fused_ce_dx_cuda", x, w, labels, lse, g)
    return out[:, :x.shape[1]].to(x.dtype)


def fused_ce_dw_cuda(x, w, labels, lse, g):
    """Launch the dW kernel. Returns dW (bf16, [h, V]): fp32 sums in a
    zeroed plane, rounded once."""
    out = _bwd_cuda(DW_KERNEL, "fused_ce_dw_cuda", x, w, labels, lse, g)
    return out[:w.shape[0], :w.shape[1]].to(w.dtype)


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
           "fused_ce_fwd_cuda", "fused_ce_fwd_reference", "fused_ce_loss", "fused_ce_reference",
           "pad8"]
