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
    [b, h, s] over the layout's row, on the flash forward's CTA body
    (wgmma fed by TMA) with a walk that reads the layout
    (``layout_fwd_walk`` is its plain model: the key tiles a CTA of 128
    query rows visits, with a code per consumer warpgroup);
  * ``sparse_bwd_dq``  replaces ``_sparse_bwd_dq_kernel``: dq over the
    layout's row, on the flash dq CTA body with the same scan of the layout
    over dq's narrower key tiles (``layout_walk``);
  * ``sparse_bwd_dkv`` replaces ``_sparse_bwd_dkv_kernel``: dk, dv over the
    layout's column, on the flash dk/dv CTA body with a walk over the
    transposed layout (``layout_dkv_walk``).

The kernels read the layout itself, never a splash schedule: their choice
of tiles and their rule for a kept pair are their own. They run on the same
CTA bodies as the flash and splash kernels, so beside the splash kernels
over ``schedule_from_layout`` (``chip_smoke.py``'s ``splash_against_sparse``)
they check two walks over one body; the body is held by each kernel's plain
version and by the flash kernels' digests, and over a layout that keeps
every block (dense, or the causal triangle in blocks of the forward's tile
or more) the forward's out and lse equal the flash forward's.
Head counts must match: the caller expands GQA first
(``SparseSelfAttention`` does).

Beside the kernels are their plain versions, ``sparse_fwd_reference`` and
``sparse_bwd_reference``: the same function as masked softmax attention
over the layout's token mask, in chunks of query rows so that no [h, s, s]
tensor is formed. A CPU tensor takes the plain versions (any float dtype,
any block); a CUDA tensor launches the kernels or raises for what they do
not take (a dtype other than bf16, a head_dim outside 64/128/256, a block
outside 16/32/64/128/256 or one that does not divide s; the forward also a
scale that is not positive). Nothing falls back.

``sparse_attention`` is the differentiable entry (``SparseAttention``, an
autograd Function saving q, k, v, out and lse); the dense oracle
``sparse_attention_reference`` refuses a bias, as the JAX package's does,
and ``sparse_attention_with_bias`` is the biased form (plain torch, as it
is plain XLA in the JAX package).
"""

import ctypes
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.attention.core import NEG_INF
from deepspeed_tpu_torch.ops.attention.flash import BWD_TILES, FWD_TILES
from deepspeed_tpu_torch.ops.kernels import KERNELS, stream_ptr
# tensor helpers only: the plain versions' row chunks, the default scale and
# the kernels' 16-byte alignment (the sparse kernels never read a schedule)
from deepspeed_tpu_torch.ops.sparse_attention.splash import _aligned, _row_chunks, _scale

FWD_KERNEL = KERNELS["sparse_fwd"]
DQ_KERNEL = KERNELS["sparse_bwd_dq"]
DKV_KERNEL = KERNELS["sparse_bwd_dkv"]
KERNEL_HEAD_DIMS = (64, 128, 256)
KERNEL_BLOCKS = (16, 32, 64, 128, 256)
# the forward and dq walks' codes per consumer warpgroup (``flash_hopper.cuh``'s
# SCHEDULED_COLUMNS and SCHEDULED_WHOLE; 0 skip, 1 the layout's bit) and the
# dk/dv walk's flag on a stage kind that keeps every pair
WALK_COLUMNS = 3
WALK_WHOLE = 4
DKV_WHOLE = 1 << 16


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
# the kernels' walks
# ---------------------------------------------------------------------------
def walk_keep(knd, q, k, block: int, causal: bool, s: int):
    """``LayoutRowWalk.keep`` (the forward's and dq's): is the pair (query q, key k) kept under the
    code or column bitmask ``knd``? Bit i of ``knd``: the warpgroup's i-th
    row block of its 64 (the 0-th for blocks of 64 and more). Broadcasts
    over numpy arrays."""
    lg = block.bit_length() - 1
    on = ((np.asarray(knd) >> ((np.asarray(q) & 63) >> lg)) & 1) != 0
    return on & (q < s) & (k < s) & ((not causal) | (k <= q))


def dkv_walk_keep(kind, q, k, block: int, causal: bool, s: int):
    """``LayoutDkvWalk.keep``: is the pair (query q, key k) of a stage of
    this kind kept? Bit (i << sub) + j of ``kind``: the query tile's i-th
    block keeps the 64 keys' j-th block (sub = log2 of the blocks per 64,
    0 for blocks of 64 and more). Broadcasts over numpy arrays."""
    lg = block.bit_length() - 1
    sub = max(0, 6 - lg)
    at = (((np.asarray(q) & 63) >> lg) << sub) + ((np.asarray(k) & 63) >> lg)
    on = ((np.asarray(kind) >> at) & 1) != 0
    return on & (q < s) & (k < s) & ((not causal) | (k <= q))


def layout_walk(layout, block: int, causal: bool, s: int, d: int, head: int, q0: int,
                bk: Optional[int] = None):
    """The key tiles the dq kernel's CTA of query rows ``q0 .. q0 + 127``
    of head ``head`` walks, as ``sparse_common.cuh``'s ``LayoutRowWalk``
    does: a list of (k0, (code of warpgroup 0, of 1), (column bitmasks of
    warpgroup 0, of 1)), in ascending order, tiles of ``bk`` keys (dq's
    ``BWD_TILES[d]["bk"]`` unless given; when causal, none past the CTA's
    last row).

    Warpgroup w owns rows q0 + 64 w .. + 63. A code is 0 (no pair kept), 1
    (blocks of at least 64 and of the tile: its one row block keeps the
    tile's one key block; the causal bound applies), ``WALK_WHOLE`` (every
    pair kept) or ``WALK_COLUMNS`` (smaller blocks): then each column has a
    bitmask, bit i set where the warpgroup's i-th row block (of max(1, 64 /
    block)) keeps the column's block and the block's last row is not before
    the key (when causal), else None. A tile whose codes are both 0 is not
    walked."""
    lay = np.asarray(layout)[head] != 0
    nb = lay.shape[0]
    lg = block.bit_length() - 1
    bk = BWD_TILES[d]["bk"] if bk is None else bk
    k_end = min(q0 + 128, s) if causal else s
    tiles = []
    for t in range(-(-k_end // bk)):
        k0 = t * bk
        codes, cols = [], []
        for w in (0, 1):
            r_lo = q0 + 64 * w
            if block >= max(64, bk):
                on = bool(r_lo < s and lay[r_lo >> lg, k0 >> lg]
                          and (not causal or k0 <= r_lo + 63))
                whole = not causal or k0 + bk - 1 <= r_lo
                codes.append((WALK_WHOLE if whole else 1) if on else 0)
                cols.append(None)
                continue
            rows = max(1, 64 >> lg)
            col = [0] * bk
            for c in range(bk):
                key = k0 + c
                if r_lo >= s or key >= s:
                    continue
                for i in range(rows):
                    rb = (r_lo >> lg) + i
                    if rb < nb and lay[rb, key >> lg] and (not causal or key >> lg <= rb):
                        col[c] |= 1 << i
            every = (r_lo + 64 <= s and k0 + bk <= s and (not causal or k0 + bk - 1 <= r_lo)
                     and all(m == (1 << rows) - 1 for m in col))
            code = 0 if not any(col) else WALK_WHOLE if every else WALK_COLUMNS
            codes.append(code)
            cols.append(tuple(col) if code == WALK_COLUMNS else None)
        if any(codes):
            tiles.append((k0, tuple(codes), tuple(cols)))
    return tiles


def layout_fwd_walk(layout, block: int, causal: bool, s: int, d: int, head: int, q0: int):
    """The key tiles the forward kernel's CTA of query rows ``q0 .. q0 +
    127`` walks: ``layout_walk`` over the forward's tiles of
    ``FWD_TILES[d]["bk"]`` keys (128; 64 at d 256), so blocks of 64 take the
    per-column form at d 64 and 128."""
    return layout_walk(layout, block, causal, s, d, head, q0, bk=FWD_TILES[d]["bk"])


def layout_dkv_walk(layout, block: int, causal: bool, s: int, d: int, head: int, k0: int):
    """The stages the dk/dv kernel's CTA of keys ``k0 .. k0 + kv_bk`` of
    head ``head`` walks, as ``sparse_common.cuh``'s ``LayoutDkvWalk`` does
    (over the transposed layout): a list of (query tile start, (kind of
    each 64-key half)), query tiles of 64 rows in ascending order (when
    causal, none before k0). A kind is a bitmask (``dkv_walk_keep``) with
    ``DKV_WHOLE`` set where every pair of the tile and the half is kept; 0
    where none is; a bit is set only where its query block's last row is not
    before its key block's first key (when causal). A tile whose kinds are
    all 0 is not walked."""
    lay = np.asarray(layout)[head] != 0
    nb = lay.shape[0]
    lg = block.bit_length() - 1
    sub = max(0, 6 - lg)
    halves = BWD_TILES[d]["kv_bk"] // 64

    def half_kind(q0, k_lo):
        if k_lo >= s:
            return 0
        every = (not causal or k_lo + 63 <= q0) and q0 + 64 <= s and k_lo + 64 <= s
        if lg >= 6:
            on = lay[q0 >> lg, k_lo >> lg] and (not causal or k_lo <= q0 + 63)
            return (1 | DKV_WHOLE if every else 1) if on else 0
        n = 1 << sub
        m = 0
        for j in range(n):
            kb = (k_lo >> lg) + j
            for i in range(n):
                qb = (q0 >> lg) + i
                if kb < nb and qb < nb and lay[qb, kb] and (not causal or kb <= qb):
                    m |= 1 << ((i << sub) + j)
        return m | DKV_WHOLE if m == (1 << (n * n)) - 1 and every else m

    stages = []
    for t in range(k0 // 64 if causal else 0, -(-s // 64)):
        kinds = tuple(half_kind(t * 64, k0 + 64 * a) for a in range(halves))
        if any(kinds):
            stages.append((t * 64, kinds))
    return stages


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
    if not _scale(q, scale) > 0:
        raise NotImplementedError(f"sparse_fwd_cuda: scale {_scale(q, scale)}; the kernel "
                                  "takes a positive scale (its running max is taken before "
                                  "the scale)")
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
                        scale=None, cta_clock=None):
    """Launch the dk/dv kernel (walks the layout's column: it reads the
    transposed layout, as the JAX package's ``layout_t``). Returns (dk,
    dv), bf16 in k's shape. ``cta_clock``: None, or an int64 tensor of
    ``dkv_ctas(...)`` rows x 3 on q's device, into which each CTA writes
    its start and end (ns, the card's global timer) and its SM, in launch
    order (a measurement hook; None costs nothing)."""
    q, k, v, out, do, lse, lay = _kernel_args("sparse_bwd_dkv_cuda", q, k, v, layout, block,
                                              out, do.to(q.dtype), lse.float())
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    clock = None
    if cta_clock is not None:
        b, h, s, d = q.shape
        if (cta_clock.dtype != torch.int64 or cta_clock.device != q.device
                or tuple(cta_clock.shape) != (dkv_ctas(b, h, s, d), 3)
                or not cta_clock.is_contiguous()):
            raise ValueError("sparse_bwd_dkv_cuda: cta_clock must be a contiguous int64 "
                             f"[{dkv_ctas(b, h, s, d)}, 3] tensor on {q.device}")
        clock = cta_clock.data_ptr()
    lay_t = lay.transpose(1, 2).contiguous()
    rc = DKV_KERNEL.fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         do.data_ptr(), lse.data_ptr(), lay_t.data_ptr(), dk.data_ptr(),
                         dv.data_ptr(), *_tail(q, block, scale, causal)[:-1], clock,
                         stream_ptr(q))
    DKV_KERNEL.check(rc)
    DKV_KERNEL.launches += 1
    return dk, dv


def dkv_ctas(b: int, h: int, s: int, d: int) -> int:
    """CTAs of a dk/dv launch: (b h) x key tiles of ``BWD_TILES[d]["kv_bk"]``."""
    kv_bk = BWD_TILES[d]["kv_bk"]
    return b * h * (-(-s // kv_bk))


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
