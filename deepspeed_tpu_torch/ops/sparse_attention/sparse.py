"""Layout-predicate block-sparse attention: hand-written CUDA forward and
backward.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/sparse_pallas.py``.
Flash-style online-softmax attention gated by a static per-head int32
layout [h, s / block, s / block] (``SparsityConfig.make_layout``): a (query
block, key block) pair the layout marks 0 is skipped, ``causal`` masks
``q >= k`` inside the kept blocks, and a query row that keeps no key gives
0. Three kernels, in ``ops/kernels/csrc/sparse_fwd.cu`` and
``sparse_bwd.cu``:

  * ``sparse_fwd``     replaces ``_sparse_fwd_kernel``: out and an fp32 LSE
    [b, h, s];
  * ``sparse_bwd_dq``  replaces ``_sparse_bwd_dq_kernel``: dq over the
    layout's row;
  * ``sparse_bwd_dkv`` replaces ``_sparse_bwd_dkv_kernel``: dk, dv over the
    layout's column (the kernel reads the transposed layout).

They read the layout itself, never a splash schedule, so that they can
stand as the splash kernels' independent oracle. Head counts must match:
the caller expands GQA first (``SparseSelfAttention`` does).

Beside the kernels are their plain versions, ``sparse_fwd_reference`` and
``sparse_bwd_reference``: the same function as masked softmax attention
over the layout's token mask, in chunks of query rows so that no [h, s, s]
tensor is formed. A CPU tensor takes the plain versions (any float dtype,
any block); a CUDA tensor launches the kernels or raises for what they do
not take (a dtype other than bf16, a head_dim outside 64/128/256, a block
outside 16/32/64/128/256 or one that does not divide s). Nothing falls
back.

``sparse_attention`` is the differentiable entry (``SparseAttention``, an
autograd Function saving q, k, v, out and lse); the dense oracle
``sparse_attention_reference`` refuses a bias, as the JAX package's does,
and ``sparse_attention_with_bias`` is the biased form (plain torch, as it
is plain XLA in the JAX package).
"""

import ctypes
from typing import Optional

import torch

from deepspeed_tpu_torch.ops.attention.core import NEG_INF
from deepspeed_tpu_torch.ops.kernels import KERNELS, stream_ptr
# tensor helpers only: the plain versions' row chunks, the default scale and
# the kernels' 16-byte alignment (the sparse kernels never read a schedule)
from deepspeed_tpu_torch.ops.sparse_attention.splash import _aligned, _row_chunks, _scale

FWD_KERNEL = KERNELS["sparse_fwd"]
DQ_KERNEL = KERNELS["sparse_bwd_dq"]
DKV_KERNEL = KERNELS["sparse_bwd_dkv"]
KERNEL_HEAD_DIMS = (64, 128, 256)
KERNEL_BLOCKS = (16, 32, 64, 128, 256)


def _reject_bias(bias, where):
    if bias is not None:
        raise NotImplementedError(
            f"{where}: additive bias is not supported on the block-sparse "
            "kernel path, and the oracle must match the kernel exactly — "
            "use sparse_attention_with_bias (dense fallback) for rpe/"
            "padding/attention masks")


def _layout(layout, device):
    """The layout as an int32 tensor on ``device`` (no copy when it is one)."""
    return torch.as_tensor(layout, dtype=torch.int32, device=device)


def _check(q, k, layout, block):
    """The JAX package's checks, in its order and with its messages."""
    b, h, s, d = q.shape
    if k.shape[1] != h:
        raise ValueError("sparse kernel expects matched head counts (expand GQA first)")
    want = (h, s // block, s // block)
    if tuple(layout.shape) != want:
        raise ValueError(f"layout shape {tuple(layout.shape)} != expected {want}")


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------
def _kept(layout, block, causal, r0, r1, s):
    """[1, h, r1 - r0, s] boolean: the pairs the kernels keep for query rows
    r0..r1."""
    dev = layout.device
    rows = torch.arange(r0, r1, device=dev)
    cols = torch.arange(s, device=dev)
    keep = (layout[:, rows // block][:, :, cols // block] != 0)
    if causal:
        keep = keep & (rows[:, None] >= cols[None, :])
    return keep[None]


def sparse_fwd_reference(q, k, v, layout, block: int, causal: bool = False, scale=None):
    """Plain forward with the kernel's arithmetic: fp32 logits * scale, the
    layout's dropped pairs (and, if causal, k > q) at -1e30, p = exp(logits -
    max) (0 for a dropped pair) rounded to v's dtype before p @ v, divided
    by max(sum p, 1e-30). Differentiable by autograd. Returns (out [b, h, s,
    d] in q's dtype, lse [b, h, s] fp32; a row that keeps nothing: 0 and
    -1e30)."""
    layout = _layout(layout, q.device)
    _check(q, k, layout, block)
    b, h, s, d = q.shape
    kf, vf = k.float(), v.float()
    sc = _scale(q, scale)
    outs, lses = [], []
    for r0, r1 in _row_chunks(b, h, s, s):
        keep = _kept(layout, block, causal, r0, r1, s)
        logits = torch.einsum("bhqd,bhkd->bhqk", q[:, :, r0:r1].float(), kf) * sc
        logits = logits.masked_fill(~keep, NEG_INF)
        m = logits.amax(dim=-1, keepdim=True).detach()
        p = torch.where(logits > NEG_INF / 2, torch.exp(logits - m), torch.zeros_like(logits))
        ls = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vf) / ls)
        lses.append((m + torch.log(ls))[..., 0])
    return torch.cat(outs, dim=2).to(q.dtype), torch.cat(lses, dim=2)


def sparse_bwd_reference(q, k, v, out, do, lse, layout, block: int, causal: bool = False,
                         scale=None):
    """Plain backward from the recompute formulas over the kept pairs, with
    the kernels' arithmetic: p = exp(q k^T * scale - lse), delta = sum(do *
    o), ds = p * (do v^T - delta) rounded to q's dtype before its products,
    p rounded before p^T do; dq and dk scaled once. Returns (dq, dk, dv)."""
    layout = _layout(layout, q.device)
    _check(q, k, layout, block)
    b, h, s, d = q.shape
    kf, vf = k.float(), v.float()
    sc = _scale(q, scale)
    dqs = []
    dk = torch.zeros(b, h, s, d, device=q.device)
    dv = torch.zeros(b, h, s, d, device=q.device)
    for r0, r1 in _row_chunks(b, h, s, s):
        keep = _kept(layout, block, causal, r0, r1, s)
        qf, dof = q[:, :, r0:r1].float(), do[:, :, r0:r1].float()
        logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sc
        p = torch.where(keep, torch.exp(logits - lse[:, :, r0:r1].float()[..., None]),
                        torch.zeros_like(logits))
        del logits
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
        delta = (dof * out[:, :, r0:r1].float()).sum(dim=-1, keepdim=True)
        ds = (p * (dp - delta)).to(q.dtype).float()
        del dp
        dqs.append(torch.einsum("bhqk,bhkd->bhqd", ds, kf) * sc)
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qf)
        dv += torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).float(), dof)
    return torch.cat(dqs, dim=2).to(q.dtype), (dk * sc).to(k.dtype), dv.to(v.dtype)


def _sparse_dense(q, k, v, layout, block, causal, scale, bias):
    """``sparse_pallas._sparse_dense``: softmax over the layout's token mask
    (and the causal triangle), with an optional additive bias; rows that
    keep nothing give 0."""
    layout = _layout(layout, q.device)
    mask = (layout != 0).repeat_interleave(block, 1).repeat_interleave(block, 2)
    sc = _scale(q, scale)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sc
    if bias is not None:
        logits = logits + torch.as_tensor(bias, device=q.device).float()
    if causal:
        s = q.shape[2]
        cm = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(cm[None, None], logits, torch.full_like(logits, NEG_INF))
    logits = torch.where(mask[None], logits, torch.full_like(logits, NEG_INF))
    alive = (logits > NEG_INF / 2).any(dim=-1)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v)
    return torch.where(alive[..., None], out, torch.zeros_like(out))


def sparse_attention_reference(q, k, v, layout, block, causal=False, scale=None, bias=None):
    """Dense oracle for the kernel path: expands the block layout to a token
    mask. ``bias`` raises: the kernel cannot honor it; the biased dense
    path is ``sparse_attention_with_bias``."""
    _reject_bias(bias, "sparse_attention_reference")
    return _sparse_dense(q, k, v, layout, block, causal, scale, None)


def sparse_attention_with_bias(q, k, v, layout, block, causal=False, scale=None, bias=None):
    """Dense block-masked attention with an additive bias (broadcastable to
    [b, h, s, s]): the rpe / key-padding / attention-mask form that
    ``SparseSelfAttention`` takes. Plain torch on every device, as the JAX
    package's is plain XLA."""
    return _sparse_dense(q, k, v, layout, block, causal, scale, bias)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------
def _kernel_args(where, q, k, v, layout, block, *more):
    """Check what the kernels take; return contiguous, 16-byte aligned
    tensors (the layout last, int32 on q's device)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or k.shape != q.shape:
        raise ValueError(f"{where}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "must have one shape (expand GQA first)")
    b, h, s, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"{where}: head_dim {d}; the kernels take {KERNEL_HEAD_DIMS} "
            "(ROADMAP queue 2, item 1, which the flash family shares)"
        )
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise NotImplementedError(
            f"{where}: q/k/v {q.dtype}/{k.dtype}/{v.dtype}; the kernels take bf16 "
            "(ROADMAP queue 2, item 1, which the flash family shares)"
        )
    if block not in KERNEL_BLOCKS or s % block:
        raise NotImplementedError(
            f"{where}: a layout block of {block} over s {s}; the kernels take blocks "
            f"in {KERNEL_BLOCKS} that divide s"
        )
    tensors = (q, k, v) + tuple(more)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(
            f"{where}: every tensor must be on one CUDA device "
            f"(got {sorted({str(t.device) for t in tensors})})"
        )
    layout = _layout(layout, q.device)
    _check(q, k, layout, block)
    return [_aligned(t) for t in tensors] + [_aligned(layout)]


def _tail(q, block, scale, causal):
    b, h, s, d = q.shape
    return (b, h, s, d, ctypes.c_float(_scale(q, scale)), s // block, block.bit_length() - 1,
            int(bool(causal)), stream_ptr(q))


def sparse_fwd_cuda(q, k, v, layout, block: int, causal: bool = False, scale=None):
    """Launch the forward kernel. Returns (out bf16 [b, h, s, d], lse fp32
    [b, h, s])."""
    q, k, v, lay = _kernel_args("sparse_fwd_cuda", q, k, v, layout, block)
    b, h, s, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    if q.numel() == 0:
        return out, lse
    rc = FWD_KERNEL.fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lay.data_ptr(),
                         out.data_ptr(), lse.data_ptr(), *_tail(q, block, scale, causal))
    FWD_KERNEL.check(rc)
    FWD_KERNEL.launches += 1
    return out, lse


def sparse_bwd_dq_cuda(q, k, v, out, do, lse, layout, block: int, causal: bool = False,
                       scale=None):
    """Launch the dq kernel (walks the layout's row). Returns dq (bf16, q's
    shape)."""
    q, k, v, out, do, lse, lay = _kernel_args("sparse_bwd_dq_cuda", q, k, v, layout, block,
                                              out, do.to(q.dtype), lse.float())
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    rc = DQ_KERNEL.fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
                        lse.data_ptr(), lay.data_ptr(), dq.data_ptr(),
                        *_tail(q, block, scale, causal))
    DQ_KERNEL.check(rc)
    DQ_KERNEL.launches += 1
    return dq


def sparse_bwd_dkv_cuda(q, k, v, out, do, lse, layout, block: int, causal: bool = False,
                        scale=None):
    """Launch the dk/dv kernel (walks the layout's column: it reads the
    transposed layout, as the JAX package's ``layout_t``). Returns (dk,
    dv), bf16 in k's shape."""
    q, k, v, out, do, lse, lay = _kernel_args("sparse_bwd_dkv_cuda", q, k, v, layout, block,
                                              out, do.to(q.dtype), lse.float())
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    lay_t = lay.transpose(1, 2).contiguous()
    rc = DKV_KERNEL.fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         do.data_ptr(), lse.data_ptr(), lay_t.data_ptr(), dk.data_ptr(),
                         dv.data_ptr(), *_tail(q, block, scale, causal))
    DKV_KERNEL.check(rc)
    DKV_KERNEL.launches += 1
    return dk, dv


class SparseAttention(torch.autograd.Function):
    """The kernels (CUDA tensors) or their plain versions (CPU tensors)
    under one autograd node; saves q, k, v, out, the fp32 LSE and the
    layout."""

    @staticmethod
    def forward(ctx, q, k, v, layout, block, causal, scale):
        if q.device.type == "cpu":
            out, lse = sparse_fwd_reference(q, k, v, layout, block, causal, scale)
        else:
            out, lse = sparse_fwd_cuda(q, k, v, layout, block, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse, layout)
        ctx.block, ctx.causal, ctx.scale = block, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, layout = ctx.saved_tensors
        args = (q, k, v, out, do, lse, layout, ctx.block, ctx.causal, ctx.scale)
        if q.device.type == "cpu":
            dq, dk, dv = sparse_bwd_reference(*args)
        else:
            dq = sparse_bwd_dq_cuda(*args)
            dk, dv = sparse_bwd_dkv_cuda(*args)
        return dq, dk, dv, None, None, None, None


def sparse_attention(q, k, v, layout, block: int, causal: bool = False,
                     scale: Optional[float] = None, bias=None):
    """Block-sparse attention. q/k/v: [b, h, s, d] with matched heads;
    layout: [h, s / block, s / block] int32 (numpy or a tensor). The kernel
    blocks read the layout at its own block size. Rows that keep no key
    give 0. ``bias`` raises: the kernels cannot honor it. Differentiable."""
    _reject_bias(bias, "sparse_attention")
    layout = _layout(layout, q.device)
    # the JAX package's errors, raised before any work
    _check(q, k, layout, block)
    return SparseAttention.apply(q, k, v, layout, int(block), bool(causal), scale)
