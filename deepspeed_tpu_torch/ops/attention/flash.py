"""Flash attention for the port: hand-written CUDA forward and backward.

Counterpart of ``deepspeed_tpu/ops/attention/flash_pallas.py`` (the
single-device entry ``flash_attention`` and its ``custom_vjp``). Three
kernels, in ``ops/kernels/csrc/flash_fwd.cu`` and ``flash_bwd.cu``:

  * ``flash_fwd``     replaces ``_fwd_kernel``: out and an fp32 LSE [b, h, s];
  * ``flash_bwd_dq``  replaces ``_bwd_dq_kernel``: dq by recompute;
  * ``flash_bwd_dkv`` replaces ``_bwd_dkv_kernel``: dk, dv by recompute,
    summed over the GQA group inside the kernel.

``flash_attention`` is a ``torch.autograd.Function`` over them. It saves q,
k, v, out and the LSE, and returns no gradient for segment ids or the
window flag. Beside the kernels are their plain versions,
``flash_fwd_reference`` and ``flash_bwd_reference`` (written from the
recompute formulas, not through autograd, so each backward kernel has its
own counterpart). A CPU tensor takes the plain versions; a CUDA tensor
launches the kernels or raises for what they do not take (a dtype other
than bf16, a head_dim outside 64/128/256). Nothing falls back.

Layout as in the JAX package: q [b, h, s, d], k/v [b, h_kv, s, d], segment
ids [b, s]; self-attention (one s for queries and keys). Masks: causal
(key <= query), a sliding window (query sees keys in (q - window, q],
requires causal; ``window_flag`` 0 switches it off for a global layer, as
``attn_layer_pattern`` does) and packed segments (equal ids only).
"""

import ctypes
from typing import Optional

import torch

from deepspeed_tpu_torch.ops.attention.core import _repeat_kv, window_too_far
from deepspeed_tpu_torch.ops.kernels import KERNELS, stream_ptr

FWD_KERNEL = KERNELS["flash_fwd"]
DQ_KERNEL = KERNELS["flash_bwd_dq"]
DKV_KERNEL = KERNELS["flash_bwd_dkv"]
KERNEL_HEAD_DIMS = (64, 128, 256)


def _scale(q, scale):
    return float(scale) if scale is not None else q.shape[-1] ** -0.5


def _flag(window_flag) -> Optional[int]:
    return None if window_flag is None else int(window_flag)


def visible_mask(s, causal, window, window_flag, segment_ids, device):
    """[b or 1, 1, s, s] boolean: True where key k is visible to query q."""
    q_pos = torch.arange(s, device=device)[:, None]
    k_pos = torch.arange(s, device=device)[None, :]
    mask = q_pos >= k_pos if causal else torch.ones(s, s, dtype=torch.bool, device=device)
    if window:
        mask = mask & ~window_too_far(q_pos, k_pos, window, _flag(window_flag))
    mask = mask[None, None]
    if segment_ids is not None:
        seg = segment_ids.to(device)
        mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])
    return mask


def _check_window(causal, window):
    if window and not causal:
        raise ValueError("flash_attention: window > 0 requires causal=True")


def flash_fwd_reference(q, k, v, causal=True, segment_ids=None, scale=None, window=0,
                        window_flag=None):
    """Plain forward with the kernel's arithmetic: fp32 logits * scale,
    masked keys out, p = exp(logits - max) rounded to v's dtype before p @ v,
    divided by the fp32 sum. Returns (out [b, h, s, d] in q's dtype,
    lse [b, h, s] fp32)."""
    _check_window(causal, window)
    b, h, s, d = q.shape
    group = h // k.shape[1]
    kr = _repeat_kv(k, group).float()
    vr = _repeat_kv(v, group).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * _scale(q, scale)
    mask = visible_mask(s, causal, window, window_flag, segment_ids, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    pu = torch.exp(logits - m)
    l = pu.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", pu.to(v.dtype).float(), vr) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_bwd_reference(q, k, v, out, do, lse, causal=True, segment_ids=None, scale=None,
                        window=0, window_flag=None):
    """Plain backward from the recompute formulas, with the kernels'
    arithmetic: p = exp(q k^T * scale - lse), delta = sum(do * o),
    ds = p * (do v^T - delta) rounded to q's dtype before its products, p
    rounded before p^T do; dk and dv summed over the GQA group in fp32 and
    rounded once. Returns (dq, dk, dv)."""
    _check_window(causal, window)
    b, h, s, d = q.shape
    h_kv = k.shape[1]
    group = h // h_kv
    sc = _scale(q, scale)
    qf, dof = q.float(), do.float()
    kr = _repeat_kv(k, group).float()
    vr = _repeat_kv(v, group).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kr) * sc
    mask = visible_mask(s, causal, window, window_flag, segment_ids, q.device)
    p = torch.where(mask, torch.exp(logits - lse.float()[..., None]), torch.zeros_like(logits))
    del logits
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr)
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    del dp
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * sc
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf).reshape(b, h_kv, group, s, d).sum(dim=2) * sc
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).float(), dof)
    dv = dv.reshape(b, h_kv, group, s, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------
def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_args(where, q, k, v, segment_ids, causal, window, *more):
    """Check what the kernels take; return contiguous, 16-byte aligned
    tensors, the segment plane (int32 or None) and the shape."""
    _check_window(causal, window)
    tensors = (q, k, v) + tuple(more)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{where}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, s, d = q.shape
    h_kv = k.shape[1]
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d or h % h_kv:
        raise ValueError(
            f"{where}: q {tuple(q.shape)} and k/v {tuple(k.shape)} are not self-attention "
            "with a whole GQA group per kv head"
        )
    if d not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"{where}: head_dim {d}; the kernels take {KERNEL_HEAD_DIMS} "
            "(ROADMAP queue 2, item 1)"
        )
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise NotImplementedError(
            f"{where}: q/k/v {q.dtype}/{k.dtype}/{v.dtype}; the kernels take bf16 "
            "(ROADMAP queue 2, item 1)"
        )
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(
            f"{where}: every tensor must be on one CUDA device "
            f"(got {sorted({str(t.device) for t in tensors})})"
        )
    seg = None
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (b, s):
            raise ValueError(f"{where}: segment_ids {tuple(segment_ids.shape)}, expected {(b, s)}")
        seg = _aligned(segment_ids.to(device=q.device, dtype=torch.int32))
    return [_aligned(t) for t in tensors], seg, (b, h, h_kv, s, d)


def _tail(shape, scale, causal, window, window_flag, stream):
    b, h, h_kv, s, d = shape
    flag = _flag(window_flag)
    return (b, h, h_kv, s, d, ctypes.c_float(scale), int(bool(causal)), int(window or 0),
            -1 if flag is None else flag, stream)


def flash_fwd_cuda(q, k, v, causal=True, segment_ids=None, scale=None, window=0,
                   window_flag=None):
    """Launch the forward kernel. Returns (out bf16 [b, h, s, d], lse fp32
    [b, h, s])."""
    (q, k, v), seg, shape = _kernel_args("flash_fwd_cuda", q, k, v, segment_ids, causal, window)
    b, h, h_kv, s, d = shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    if q.numel() == 0:
        return out, lse
    rc = FWD_KERNEL.fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if seg is None else seg.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        *_tail(shape, _scale(q, scale), causal, window, window_flag, stream_ptr(q)),
    )
    FWD_KERNEL.check(rc)
    FWD_KERNEL.launches += 1
    return out, lse


def flash_bwd_dq_cuda(q, k, v, out, do, lse, causal=True, segment_ids=None, scale=None,
                      window=0, window_flag=None):
    """Launch the dq kernel. Returns dq (bf16, q's shape)."""
    (q, k, v, out, do, lse), seg, shape = _kernel_args(
        "flash_bwd_dq_cuda", q, k, v, segment_ids, causal, window, out, do.to(q.dtype),
        lse.float())
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    rc = DQ_KERNEL.fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), None if seg is None else seg.data_ptr(), dq.data_ptr(),
        *_tail(shape, _scale(q, scale), causal, window, window_flag, stream_ptr(q)),
    )
    DQ_KERNEL.check(rc)
    DQ_KERNEL.launches += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, out, do, lse, causal=True, segment_ids=None, scale=None,
                       window=0, window_flag=None):
    """Launch the dk/dv kernel. Returns (dk, dv), bf16 in k's shape, each
    summed over the kv head's GQA group."""
    (q, k, v, out, do, lse), seg, shape = _kernel_args(
        "flash_bwd_dkv_cuda", q, k, v, segment_ids, causal, window, out, do.to(q.dtype),
        lse.float())
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    rc = DKV_KERNEL.fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), None if seg is None else seg.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_tail(shape, _scale(q, scale), causal, window, window_flag, stream_ptr(q)),
    )
    DKV_KERNEL.check(rc)
    DKV_KERNEL.launches += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """The kernels (CUDA tensors) or their plain versions (CPU tensors)
    under one autograd node; saves q, k, v, out and the fp32 LSE."""

    @staticmethod
    def forward(ctx, q, k, v, causal, segment_ids, scale, window, window_flag):
        kw = dict(causal=causal, segment_ids=segment_ids, scale=scale, window=window,
                  window_flag=window_flag)
        if q.device.type == "cpu":
            out, lse = flash_fwd_reference(q, k, v, **kw)
        else:
            out, lse = flash_fwd_cuda(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.kw = dict(kw, segment_ids=None)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        kw = dict(ctx.kw, segment_ids=segment_ids)
        if q.device.type == "cpu":
            dq, dk, dv = flash_bwd_reference(q, k, v, out, do, lse, **kw)
        else:
            dq = flash_bwd_dq_cuda(q, k, v, out, do, lse, **kw)
            dk, dv = flash_bwd_dkv_cuda(q, k, v, out, do, lse, **kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, causal: bool = True, segment_ids=None, scale=None,
                    window: int = 0, window_flag=None):
    """Flash attention. q: [b, h, s, d]; k, v: [b, h_kv, s, d] -> [b, h, s, d].
    ``segment_ids`` [b, s] masks packed sequences; ``window`` is the static
    sliding window (requires causal) and ``window_flag`` (an int, 0 or 1)
    switches it per layer."""
    return FlashAttention.apply(q, k, v, causal, segment_ids, scale, int(window or 0),
                                _flag(window_flag))
