"""Flash attention for the port: hand-written CUDA forward and backward.

Counterpart of ``deepspeed_tpu/ops/attention/flash_pallas.py`` (the
single-device entry ``flash_attention`` and its ``custom_vjp``). Three
kernels, in ``ops/kernels/csrc/flash_fwd.cu`` and ``flash_bwd.cu``:

  * ``flash_fwd``     replaces ``_fwd_kernel``: out and an fp32 LSE [b, h, s]
    (wgmma fed by TMA on ``flash_hopper.cuh``'s CTA body, tiles per head
    dim in ``FWD_TILES``);
  * ``flash_bwd_dq``  replaces ``_bwd_dq_kernel``: dq by recompute;
  * ``flash_bwd_dkv`` replaces ``_bwd_dkv_kernel``: dk, dv by recompute,
    summed over the GQA group inside the kernel
    (both on ``flash_hopper_bwd.cuh``'s CTA bodies, wgmma fed by TMA, tiles
    per head dim in ``BWD_TILES``).

Three more, in ``flash_chunk.cu``, are the same bodies in carry mode for the
context-parallel ring (``ops/attention/sharded.py``): ``flash_fwd_chunk``,
``flash_dq_chunk`` and ``flash_dkv_chunk`` replace the JAX package's chunk
entries of the same names (see the section below).

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
# The forward kernels' tiles per head dim (``csrc/flash_hopper.cuh``
# ``FwdTiles``): query rows a CTA, key rows a tile, stages of the K/V ring.
# A row's result depends on where its key tiles start, so the ring matches
# the single kernel only over chunks of whole key tiles (sharded.py).
FWD_TILES = {64: dict(bq=128, bk=128, stages=2), 128: dict(bq=128, bk=128, stages=2),
             256: dict(bq=128, bk=64, stages=2)}
# The backward kernels' tiles per head dim (``csrc/flash_hopper_bwd.cuh``
# ``BwdTiles``): dq's query rows a CTA (bq) and key rows a stage (bk), dk/dv's
# key rows a CTA (kv_bk) and query rows a stage (kv_bq), the stages of each
# ring. dq's rows depend on where its key tiles start and dk/dv's on where
# its query tiles start (the GQA group's heads inner), so the ring matches
# the single kernels only over chunks of whole tiles of both (sharded.py).
BWD_TILES = {64: dict(bq=128, bk=64, kv_bk=128, kv_bq=64, stages=3, kv_stages=3),
             128: dict(bq=128, bk=64, kv_bk=128, kv_bq=64, stages=3, kv_stages=3),
             256: dict(bq=128, bk=32, kv_bk=64, kv_bq=64, stages=3, kv_stages=1)}


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


# ---------------------------------------------------------------------------
# carry mode: the context-parallel ring's chunk entries (ops/attention/sharded.py)
#
# The JAX package's flash_fwd_chunk / flash_dq_chunk / flash_dkv_chunk
# stream one chunk through the flash bodies and thread the raw softmax state
# or the raw gradient sums between calls. Here three kernels
# (``ops/kernels/csrc/flash_chunk.cu``) do the same on a card, and each has
# a plain version beside it. A chunk call is self-attention between two
# chunks of equal length s: ``causal=True`` marks the diagonal chunk (local
# positions), any other chunk sees every pair. ``segment_ids`` is a
# (query ids, key ids) pair of [b, s] planes. Carries are fp32: (m, l, acc)
# with m, l [b, h, s] and acc [b, h, s, d] (m starts at -inf, not JAX's
# -1e30 lane-broadcast to 128: the port's kernels seed -inf); dq [b, h, s,
# d] unscaled; dk, dv [b, h_kv, s, d] unscaled, each summed over the kv
# head's GQA group hop by hop (JAX keeps per-query-head partials and sums
# them in flash_dkv_finalize).
#
# The dispatch functions take ``carry=None`` for a fresh carry and
# ``final=True`` on a row's last hop, which returns the outputs (out and
# lse; dq; dk and dv in the inputs' dtype) through the finalize arithmetic
# instead of the carry. On a card the kernels update a given carry in
# place and finalize inside the last hop's kernel, through the single
# kernels' own epilogues. ALiBi is not ported (ROADMAP queue 2, item 1).
# ---------------------------------------------------------------------------
LOAD, FINAL = 1, 2
FWD_CHUNK_KERNEL = KERNELS["flash_fwd_chunk"]
DQ_CHUNK_KERNEL = KERNELS["flash_dq_chunk"]
DKV_CHUNK_KERNEL = KERNELS["flash_dkv_chunk"]


def flash_carry_init(b, h, s, d, device=None):
    """The fresh softmax carry (m, l, acc): -inf, 0, 0 in fp32."""
    return (torch.full((b, h, s), float("-inf"), dtype=torch.float32, device=device),
            torch.zeros((b, h, s), dtype=torch.float32, device=device),
            torch.zeros((b, h, s, d), dtype=torch.float32, device=device))


def flash_finalize(carry, dtype):
    """(out, lse) of a carry, with the single kernel's epilogue arithmetic:
    out = acc / max(l, 1e-30) rounded once to ``dtype``, lse = m +
    log(max(l, 1e-30))."""
    m, l, acc = carry
    ls = l.clamp_min(1e-30)
    return (acc / ls[..., None]).to(dtype), m + torch.log(ls)


def flash_dq_finalize(dq_acc, scale, dtype):
    """dq = the raw sum times the softmax scale, rounded once."""
    return (dq_acc * scale).to(dtype)


def flash_dkv_finalize(dk_acc, dv_acc, scale, dtype):
    """dk = the raw sum times the scale and dv the raw sum, rounded once
    (the carries are already summed over the GQA group)."""
    return (dk_acc * scale).to(dtype), dv_acc.to(dtype)


def chunk_mask(s, causal, segment_ids, device):
    """[b or 1, 1, s, s] boolean: key k of the visiting chunk visible to
    query q of the home chunk (the diagonal: k <= q; else every pair),
    within equal segment ids when a (query, key) id pair is given."""
    if causal:
        mask = torch.arange(s, device=device)[:, None] >= torch.arange(s, device=device)[None]
    else:
        mask = torch.ones(s, s, dtype=torch.bool, device=device)
    mask = mask[None, None]
    if segment_ids is not None:
        sq, sk = (t.to(device) for t in segment_ids)
        mask = mask & (sq[:, None, :, None] == sk[:, None, None, :])
    return mask


def _chunk_logits(q, k, causal, segment_ids, scale):
    group = q.shape[1] // k.shape[1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), _repeat_kv(k, group).float())
    mask = chunk_mask(q.shape[2], causal, segment_ids, q.device)
    return logits * _scale(q, scale), mask


def flash_fwd_chunk_reference(q, k, v, carry, causal=False, segment_ids=None, scale=None):
    """One k/v chunk into the carry (m, l, acc), plain: the new max over
    the chunk's visible logits, the old state rescaled by exp(m_old -
    m_new), p = exp(logits - m_new) rounded to v's dtype before p @ v.
    Returns the new carry."""
    m, l, acc = carry
    logits, mask = _chunk_logits(q, k, causal, segment_ids, scale)
    logits = logits.masked_fill(~mask, float("-inf"))
    m_new = torch.maximum(m, logits.amax(dim=-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    corr = torch.where(m == m_new, torch.ones_like(m), torch.exp(m - m_safe))
    p = torch.exp(logits - m_safe[..., None])
    vr = _repeat_kv(v, q.shape[1] // k.shape[1]).float()
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vr)
    return m_new, l * corr + p.sum(dim=-1), acc * corr[..., None] + pv


def _chunk_p_ds(q, k, v, out, do, lse, causal, segment_ids, scale):
    """p = exp(q k^T * scale - lse) on the visible pairs and ds = p * (do
    v^T - delta) rounded to q's dtype, [b, h, s, s] fp32 each."""
    logits, mask = _chunk_logits(q, k, causal, segment_ids, scale)
    p = torch.where(mask, torch.exp(logits - lse.float()[..., None]), torch.zeros_like(logits))
    del logits
    vr = _repeat_kv(v, q.shape[1] // k.shape[1]).float()
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vr)
    delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    return p, (p * (dp - delta)).to(q.dtype).float()


def flash_dq_chunk_reference(q, k, v, out, do, lse, dq_acc, causal=False, segment_ids=None,
                             scale=None):
    """One k/v chunk into the raw dq sum: dq_acc + ds @ k (unscaled)."""
    _, ds = _chunk_p_ds(q, k, v, out, do, lse, causal, segment_ids, scale)
    kr = _repeat_kv(k, q.shape[1] // k.shape[1]).float()
    return dq_acc + torch.einsum("bhqk,bhkd->bhqd", ds, kr)


def flash_dkv_chunk_reference(q, k, v, out, do, lse, dk_acc, dv_acc, causal=False,
                              segment_ids=None, scale=None):
    """One visiting q-side chunk (q, out, do, lse) into the home chunk's
    raw dk, dv sums: + ds^T q and + p^T do (p rounded to q's dtype), summed
    over the GQA group."""
    p, ds = _chunk_p_ds(q, k, v, out, do, lse, causal, segment_ids, scale)
    b, h_kv, s, d = k.shape
    group = q.shape[1] // h_kv
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()).reshape(b, h_kv, group, s, d).sum(2)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).float(), do.float())
    return dk_acc + dk, dv_acc + dv.reshape(b, h_kv, group, s, d).sum(2)


def _chunk_args(where, q, k, v, segment_ids, *more):
    """Check what the chunk kernels take; return contiguous aligned
    tensors, the two id planes (or None) and the shape."""
    if segment_ids is not None:
        if len(segment_ids) != 2:
            raise ValueError(f"{where}: segment_ids must be a (query ids, key ids) pair")
        seg = segment_ids[0]
    else:
        seg = None
    tensors, seg_q, shape = _kernel_args(where, q, k, v, seg, False, 0, *more)
    seg_k = None
    if segment_ids is not None:
        seg_k = segment_ids[1]
        if tuple(seg_k.shape) != tuple(seg_q.shape):
            raise ValueError(f"{where}: key ids {tuple(seg_k.shape)}, expected "
                             f"{tuple(seg_q.shape)}")
        seg_k = _aligned(seg_k.to(device=q.device, dtype=torch.int32))
    return tensors, (seg_q, seg_k), shape


def _carry_ptrs(where, carry, shapes, device):
    """Data pointers of an fp32 carry of the given shapes, or Nones."""
    if carry is None:
        return [None] * len(shapes)
    for t, shape in zip(carry, shapes):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"{where}: a carry must be contiguous fp32 {shape} on {device} "
                             f"(got {t.dtype} {tuple(t.shape)} on {t.device})")
    return [t.data_ptr() for t in carry]


def _seg_ptrs(segs):
    return [None if t is None else t.data_ptr() for t in segs]


def _chunk_tail(shape, scale, causal, flags, stream):
    b, h, h_kv, s, d = shape
    return (b, h, h_kv, s, d, ctypes.c_float(scale), int(bool(causal)), flags, stream)


def flash_fwd_chunk_cuda(q, k, v, carry=None, segment_ids=None, causal=False, scale=None,
                         final=False):
    """Launch the forward chunk kernel: the carry (updated in place, or
    made when None) or, with ``final``, (out, lse)."""
    (q, k, v), segs, shape = _chunk_args("flash_fwd_chunk_cuda", q, k, v, segment_ids)
    b, h, h_kv, s, d = shape
    ptrs = _carry_ptrs("flash_fwd_chunk_cuda", carry, [(b, h, s), (b, h, s), (b, h, s, d)],
                       q.device)
    flags = (LOAD if carry is not None else 0) | (FINAL if final else 0)
    if final:
        res = (torch.empty_like(q),
               torch.empty((b, h, s), device=q.device, dtype=torch.float32))
        dst = [t.data_ptr() for t in res]
    else:
        if carry is None:
            carry = (torch.empty((b, h, s), device=q.device, dtype=torch.float32),
                     torch.empty((b, h, s), device=q.device, dtype=torch.float32),
                     torch.empty((b, h, s, d), device=q.device, dtype=torch.float32))
            ptrs = [t.data_ptr() for t in carry]
        res, dst = carry, [None, None]
    rc = FWD_CHUNK_KERNEL.fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *_seg_ptrs(segs), *ptrs, *dst,
        *_chunk_tail(shape, _scale(q, scale), causal, flags, stream_ptr(q)))
    FWD_CHUNK_KERNEL.check(rc)
    FWD_CHUNK_KERNEL.launches += 1
    return res


def flash_dq_chunk_cuda(q, k, v, out, do, lse, dq_acc=None, segment_ids=None, causal=False,
                        scale=None, final=False):
    """Launch the dq chunk kernel: the raw dq sum (updated in place, or
    made when None) or, with ``final``, dq in q's dtype."""
    (q, k, v, out, do, lse), segs, shape = _chunk_args(
        "flash_dq_chunk_cuda", q, k, v, segment_ids, out, do.to(q.dtype), lse.float())
    b, h, h_kv, s, d = shape
    (ptr,) = _carry_ptrs("flash_dq_chunk_cuda", None if dq_acc is None else (dq_acc,),
                         [(b, h, s, d)], q.device)
    flags = (LOAD if dq_acc is not None else 0) | (FINAL if final else 0)
    if final:
        res = dq = torch.empty_like(q)
        dst = dq.data_ptr()
    else:
        if dq_acc is None:
            dq_acc = torch.empty((b, h, s, d), device=q.device, dtype=torch.float32)
            ptr = dq_acc.data_ptr()
        res, dst = dq_acc, None
    rc = DQ_CHUNK_KERNEL.fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), *_seg_ptrs(segs), ptr, dst,
        *_chunk_tail(shape, _scale(q, scale), causal, flags, stream_ptr(q)))
    DQ_CHUNK_KERNEL.check(rc)
    DQ_CHUNK_KERNEL.launches += 1
    return res


def flash_dkv_chunk_cuda(q, k, v, out, do, lse, carry=None, segment_ids=None, causal=False,
                         scale=None, final=False):
    """Launch the dk/dv chunk kernel (q, out, do, lse: the visiting chunk;
    k, v: the home chunk): the raw (dk, dv) sums (updated in place, or made
    when None) or, with ``final``, (dk, dv) in k's dtype."""
    (q, k, v, out, do, lse), segs, shape = _chunk_args(
        "flash_dkv_chunk_cuda", q, k, v, segment_ids, out, do.to(q.dtype), lse.float())
    b, h, h_kv, s, d = shape
    ptrs = _carry_ptrs("flash_dkv_chunk_cuda", carry, [(b, h_kv, s, d)] * 2, q.device)
    flags = (LOAD if carry is not None else 0) | (FINAL if final else 0)
    if final:
        res = torch.empty_like(k), torch.empty_like(v)
        dst = [t.data_ptr() for t in res]
    else:
        if carry is None:
            carry = tuple(torch.empty((b, h_kv, s, d), device=q.device, dtype=torch.float32)
                          for _ in range(2))
            ptrs = [t.data_ptr() for t in carry]
        res, dst = carry, [None, None]
    rc = DKV_CHUNK_KERNEL.fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), *_seg_ptrs(segs), *ptrs, *dst,
        *_chunk_tail(shape, _scale(q, scale), causal, flags, stream_ptr(q)))
    DKV_CHUNK_KERNEL.check(rc)
    DKV_CHUNK_KERNEL.launches += 1
    return res


def flash_fwd_chunk(q, k, v, carry=None, segment_ids=None, causal=False, scale=None,
                    final=False):
    """Stream one k/v chunk into the home queries' softmax carry (see the
    section's comment). Returns the carry, or (out, lse) with ``final``."""
    if q.device.type != "cpu":
        return flash_fwd_chunk_cuda(q, k, v, carry, segment_ids, causal, scale, final)
    if carry is None:
        carry = flash_carry_init(q.shape[0], q.shape[1], q.shape[2], q.shape[3], q.device)
    carry = flash_fwd_chunk_reference(q, k, v, carry, causal, segment_ids, scale)
    return flash_finalize(carry, q.dtype) if final else carry


def flash_dq_chunk(q, k, v, out, do, lse, dq_acc=None, segment_ids=None, causal=False,
                   scale=None, final=False):
    """Fold one k/v chunk into the home queries' raw dq sum. Returns the
    sum, or dq with ``final``."""
    if q.device.type != "cpu":
        return flash_dq_chunk_cuda(q, k, v, out, do, lse, dq_acc, segment_ids, causal, scale,
                                   final)
    if dq_acc is None:
        dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dq_acc = flash_dq_chunk_reference(q, k, v, out, do, lse, dq_acc, causal, segment_ids, scale)
    return flash_dq_finalize(dq_acc, _scale(q, scale), q.dtype) if final else dq_acc


def flash_dkv_chunk(q, k, v, out, do, lse, carry=None, segment_ids=None, causal=False,
                    scale=None, final=False):
    """Fold one visiting q-side chunk into the home keys' raw (dk, dv)
    sums. Returns the sums, or (dk, dv) with ``final``."""
    if q.device.type != "cpu":
        return flash_dkv_chunk_cuda(q, k, v, out, do, lse, carry, segment_ids, causal, scale,
                                    final)
    if carry is None:
        carry = tuple(torch.zeros(k.shape, dtype=torch.float32, device=k.device)
                      for _ in range(2))
    carry = flash_dkv_chunk_reference(q, k, v, out, do, lse, *carry, causal=causal,
                                      segment_ids=segment_ids, scale=scale)
    return flash_dkv_finalize(*carry, _scale(q, scale), k.dtype) if final else carry
