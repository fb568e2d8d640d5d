"""Splash (scheduled block-sparse) attention: hand-written CUDA forward and
backward.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/splash_pallas.py``.
A ``BlockSchedule`` (schedule.py) lists, per query block, the kv blocks to
visit with a kind per step (0 skip, 1 partial, 2 full); the kernels visit
those blocks and no others. Three kernels, in
``ops/kernels/csrc/splash_fwd.cu`` and ``splash_bwd.cu``, each the flash
kernel's CTA body (wgmma fed by TMA) on a scheduled walk:

  * ``splash_fwd``     replaces ``_splash_fwd_kernel``: out and an fp32 LSE
    [b, h, sq];
  * ``splash_bwd_dq``  replaces ``_splash_bwd_dq_kernel``: dq over the row
    schedule (``row_walk`` is the plain model of both kernels' walk: the
    key tiles a CTA of 128 query rows visits, with a kind per key column
    and consumer warpgroup);
  * ``splash_bwd_dkv`` replaces ``_splash_bwd_dkv_kernel``: dk, dv over the
    transposed schedule, summed over the GQA group inside the kernel
    (``dkv_walk`` is its walk's plain model).

A kept pair: every pair of a FULL step; on a PARTIAL step the pairs that
pass the analytic predicate (causal ``q >= k``, window ``q - k < w``, and
the schedule's static segment ids); runtime ``segment_ids`` mask every step
(the JAX package's ``seg_mode`` "schedule" and "all"). A masked logit is
-1e30 and contributes exactly 0, so a row that keeps no key gives 0, with
lse = -1e30 + log(1e-30) (-1e30 in fp32).

Beside the kernels are their plain versions, ``splash_fwd_reference`` and
``splash_bwd_reference``: the same function as masked softmax attention
over the schedule's token mask, taken in chunks of query rows so that no
[h, s, s] tensor is ever formed. A CPU tensor takes the plain versions; a
CUDA tensor launches the kernels or raises for what they do not take (a
dtype other than bf16, a head_dim outside 64/128/256, a schedule block that
is neither a multiple of 64 nor its axis's only block; in the backward the
key block too). Nothing falls back.

``splash_attention`` is the differentiable entry (``SplashAttention``, an
autograd Function saving q, k, v, out and lse); ``splash_prefill_attention``
the serving entry (forward only): one schedule row built on the host from
the chunk start, as the JAX package builds it inside its jit.
"""

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.attention.core import NEG_INF, _repeat_kv
from deepspeed_tpu_torch.ops.attention.flash import BWD_TILES, FWD_TILES
from deepspeed_tpu_torch.ops.kernels import KERNELS, stream_ptr
from deepspeed_tpu_torch.ops.sparse_attention.mask import FULL, PARTIAL
from deepspeed_tpu_torch.ops.sparse_attention.schedule import (
    BlockSchedule,
    device_array,
    device_arrays,
)

FWD_KERNEL = KERNELS["splash_fwd"]
DQ_KERNEL = KERNELS["splash_bwd_dq"]
DKV_KERNEL = KERNELS["splash_bwd_dkv"]
KERNEL_HEAD_DIMS = (64, 128, 256)
KERNEL_TILE = 64
# the plain versions take query rows in chunks of at most this many
# (batch x head x row x key) logits (512 MB in fp32)
_CHUNK_ELEMS = 1 << 27


def _scale(q, scale):
    return float(scale) if scale is not None else q.shape[-1] ** -0.5


def _segments(schedule: BlockSchedule, segment_ids, b, sq, sk, device):
    """The JAX package's segment rules: (ids [b, s] int32 or None, seg_all).
    Static ids of the schedule mask partial steps only ("schedule"), runtime
    ids every step ("all"); both need square attention, and not both."""
    if schedule.segment_ids is not None:
        if sq != sk:
            raise ValueError("segment masking requires square attention")
        if segment_ids is not None:
            raise ValueError("schedule already carries segment ids; passing "
                             "runtime segment_ids too would silently compose")
        ids = torch.from_numpy(np.asarray(schedule.segment_ids, np.int32)).to(device)
        return ids[None].expand(b, sq), False
    if segment_ids is not None:
        if sq != sk:
            raise ValueError("segment masking requires square attention")
        return torch.as_tensor(segment_ids).to(device=device, dtype=torch.int32), True
    return None, False


def _check_schedule(q, k, schedule: BlockSchedule):
    b, h, sq, d = q.shape
    h_kv, sk = k.shape[1], k.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    if (schedule.seq_q, schedule.seq_kv) != (sq, sk):
        raise ValueError(f"schedule is for seq {(schedule.seq_q, schedule.seq_kv)}, "
                         f"got {(sq, sk)}")
    if schedule.num_heads not in (1, h):
        raise ValueError(f"schedule has {schedule.num_heads} heads, q has {h}")


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------
def _status(schedule: BlockSchedule) -> np.ndarray:
    """[heads, nq, nk] block status from the compacted forward arrays."""
    status = np.zeros((schedule.num_heads, schedule.nq, schedule.nk), np.uint8)
    hs, rows, steps = np.nonzero(schedule.step_kind)
    status[hs, rows, schedule.kv_index[hs, rows, steps]] = schedule.step_kind[hs, rows, steps]
    return status


def _status_tensor(schedule: BlockSchedule, device):
    """The plain versions' block status, uploaded once per (schedule,
    device) beside the kernels' arrays."""
    return device_array(schedule, "status", device, _status)


def _row_chunks(b, h, sq, sk):
    step = max(1, _CHUNK_ELEMS // max(1, b * h * sk))
    return [(r0, min(sq, r0 + step)) for r0 in range(0, sq, step)]


def _kept(schedule: BlockSchedule, status, r0, r1, sk, base, seg, seg_all):
    """[b or 1, heads, r1 - r0, sk] boolean: the pairs the kernels keep for
    query rows r0..r1 (global positions base + row)."""
    dev = status.device
    rows = torch.arange(r0, r1, device=dev)
    cols = torch.arange(sk, device=dev)
    st = status[:, rows // schedule.block_q][:, :, cols // schedule.block_kv]
    qpos = (rows + base)[:, None]
    kpos = cols[None, :]
    pred = torch.ones(r1 - r0, sk, dtype=torch.bool, device=dev)
    if schedule.causal:
        pred &= qpos >= kpos
    if schedule.window:
        pred &= (qpos - kpos) < schedule.window
    if seg is not None and not seg_all:
        pred = pred[None] & (seg[:, rows][:, :, None] == seg[:, None, :])  # [b, R, sk]
        return ((st == FULL)[None] | ((st == PARTIAL)[None] & pred[:, None]))
    keep = ((st == FULL) | ((st == PARTIAL) & pred))[None]
    if seg is not None:
        keep = keep & (seg[:, rows][:, None, :, None] == seg[:, None, None, :])
    return keep


def splash_fwd_reference(q, k, v, schedule: BlockSchedule, segment_ids=None, scale=None,
                         base: int = 0):
    """Plain forward with the kernel's arithmetic: fp32 logits * scale, the
    schedule's dropped pairs at -1e30, p = exp(logits - max) (0 for a
    dropped pair) rounded to v's dtype before p @ v, divided by max(sum p,
    1e-30). Query row i sits at position ``base + i``. Differentiable by
    autograd. Returns (out [b, h, sq, d] in q's dtype, lse [b, h, sq] fp32)."""
    _check_schedule(q, k, schedule)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    group = h // k.shape[1]
    seg, seg_all = _segments(schedule, segment_ids, b, sq, sk, q.device)
    status = _status_tensor(schedule, q.device)
    kr = _repeat_kv(k, group).float()
    vr = _repeat_kv(v, group).float()
    sc = _scale(q, scale)
    outs, lses = [], []
    for r0, r1 in _row_chunks(b, h, sq, sk):
        keep = _kept(schedule, status, r0, r1, sk, base, seg, seg_all)
        logits = torch.einsum("bhqd,bhkd->bhqk", q[:, :, r0:r1].float(), kr) * sc
        logits = logits.masked_fill(~keep, NEG_INF)
        m = logits.amax(dim=-1, keepdim=True).detach()
        p = torch.where(logits > NEG_INF / 2, torch.exp(logits - m), torch.zeros_like(logits))
        ls = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vr) / ls)
        lses.append((m + torch.log(ls))[..., 0])
    return torch.cat(outs, dim=2).to(q.dtype), torch.cat(lses, dim=2)


def splash_bwd_reference(q, k, v, out, do, lse, schedule: BlockSchedule, segment_ids=None,
                         scale=None):
    """Plain backward from the recompute formulas over the kept pairs, with
    the kernels' arithmetic: p = exp(q k^T * scale - lse), delta = sum(do *
    o), ds = p * (do v^T - delta) rounded to q's dtype before its products,
    p rounded before p^T do; dk and dv summed over the GQA group in fp32 and
    rounded once. Returns (dq, dk, dv)."""
    _check_schedule(q, k, schedule)
    b, h, sq, d = q.shape
    h_kv, sk = k.shape[1], k.shape[2]
    group = h // h_kv
    seg, seg_all = _segments(schedule, segment_ids, b, sq, sk, q.device)
    status = _status_tensor(schedule, q.device)
    kr = _repeat_kv(k, group).float()
    vr = _repeat_kv(v, group).float()
    sc = _scale(q, scale)
    dqs = []
    dk = torch.zeros(b, h, sk, d, device=q.device)
    dv = torch.zeros(b, h, sk, d, device=q.device)
    for r0, r1 in _row_chunks(b, h, sq, sk):
        keep = _kept(schedule, status, r0, r1, sk, 0, seg, seg_all)
        qf, dof = q[:, :, r0:r1].float(), do[:, :, r0:r1].float()
        logits = torch.einsum("bhqd,bhkd->bhqk", qf, kr) * sc
        logits = logits.masked_fill(~keep, NEG_INF)
        p = torch.where(keep, torch.exp(logits - lse[:, :, r0:r1].float()[..., None]),
                        torch.zeros_like(logits))
        del logits
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr)
        delta = (dof * out[:, :, r0:r1].float()).sum(dim=-1, keepdim=True)
        ds = (p * (dp - delta)).to(q.dtype).float()
        del dp
        dqs.append(torch.einsum("bhqk,bhkd->bhqd", ds, kr) * sc)
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qf)
        dv += torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).float(), dof)
    dk = dk.reshape(b, h_kv, group, sk, d).sum(dim=2) * sc
    dv = dv.reshape(b, h_kv, group, sk, d).sum(dim=2)
    return torch.cat(dqs, dim=2).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels' walks
# ---------------------------------------------------------------------------
def row_walk(schedule: BlockSchedule, d: int, head: int, q0: int, *, kernel: str = "fwd",
             seg=None, seg_all: bool = False, base: int = 0):
    """The key tiles the forward (``kernel="fwd"``) or dq (``"dq"``)
    kernel's CTA of query rows ``q0 .. q0 + 127`` of query head ``head``
    walks, as ``splash_common.cuh``'s ``RowWalk.walk`` does: a list of
    (k0, (kinds of warpgroup 0, of warpgroup 1), (whole 0, whole 1)).

    Warpgroup w owns rows q0 + 64 w .. + 63 and reads the schedule row of
    their query block. The two rows' blocks are merged in ascending key
    order as aligned tiles of the kernel's key tile (``FWD_TILES[d]["bk"]``
    or ``BWD_TILES[d]["bk"]`` keys): the next tile starts at the least key
    still listed, rounded down. A column's kind is its block's kind in the
    warpgroup's row (0 where the row lists no block, or where a PARTIAL
    step's causal bound or band leaves the column dead for every row of
    the warpgroup). A tile with no live column, or (runtime ids, ``seg``
    one batch row's ids [sq] with ``seg_all``) none of whose ids falls in
    the range of the query tile's ids, is not walked. ``whole``: every pair
    of the warpgroup's rows and the tile's columns is kept without a
    predicate. Query row i sits at position ``base + i``. (Where one block
    holds all of a tile's keys the kernel hands the warpgroup one code, the
    block's kind, for every column: the columns listed 0 here as dead for
    every row are then dropped by its predicate instead.)"""
    tile = (FWD_TILES if kernel == "fwd" else BWD_TILES)[d]["bk"]
    sq, sk = schedule.seq_q, schedule.seq_kv
    bq, bk, nq = schedule.block_q, schedule.block_kv, schedule.nq
    causal, window = schedule.causal, schedule.window
    hs = 0 if schedule.num_heads == 1 else head
    rows = []
    for w in (0, 1):
        first = q0 + 64 * w
        entries = []
        if first < sq:
            r = 0 if nq == 1 else first // bq
            for idx, kd in zip(schedule.kv_index[hs, r], schedule.step_kind[hs, r]):
                if kd == 0:
                    break  # padding: compacted left
                entries.append((int(idx) * bk, min(int(idx) * bk + bk, sk), int(kd)))
        rows.append(entries)
    if seg is not None:
        qids = np.asarray(seg)[q0:min(q0 + 128, sq)]
        qmin, qmax = int(qids.min()), int(qids.max())
    pos, nxt, tiles = [0, 0], 0, []
    while True:
        starts = [max(rows[w][pos[w]][0], nxt) for w in (0, 1) if pos[w] < len(rows[w])]
        if not starts:
            return tiles
        k0 = min(starts) // tile * tile
        k_end = k0 + tile
        kinds = []
        for w in (0, 1):
            r_lo, r_hi = base + q0 + 64 * w, base + min(q0 + 64 * w + 63, sq - 1)
            cols = [0] * tile
            for ks, ke, kd in rows[w][pos[w]:]:
                if ks >= k_end:
                    break
                for key in range(max(ks, k0), min(ke, k_end)):
                    if not (kd == PARTIAL and ((causal and key > r_hi)
                                               or (window and r_lo - key >= window))):
                        cols[key - k0] = kd
            kinds.append(tuple(cols))
        nxt = k_end
        for w in (0, 1):
            while pos[w] < len(rows[w]) and rows[w][pos[w]][1] <= nxt:
                pos[w] += 1
        if not any(any(cols) for cols in kinds):
            continue
        if seg is not None and seg_all:
            kids = np.asarray(seg)[k0:min(k_end, sk)]
            if not ((kids >= qmin) & (kids <= qmax)).any():
                continue
        wholes = []
        for w in (0, 1):
            r_lo = base + q0 + 64 * w
            ok = q0 + 64 * w + 64 <= sq and k_end <= sk and all(
                kd == FULL or (kd == PARTIAL and (not causal or k0 + c <= r_lo)
                               and (not window or r_lo + 63 - (k0 + c) < window))
                for c, kd in enumerate(kinds[w]))
            partial = PARTIAL in kinds[w]
            wholes.append(bool(ok and not (seg is not None and (seg_all or partial))))
        tiles.append((k0, tuple(kinds), tuple(wholes)))


def dkv_walk_rows(schedule: BlockSchedule, h: int, h_kv: int, d: int) -> int:
    """Rows of the transposed schedule one dk/dv CTA merges (its producer
    warp keeps a cursor on each in shared memory, 12 bytes a row, lane l
    owning rows l, l + 32, ...): the kv blocks of its 64-key halves (two
    where a block does not hold the CTA's ``kv_bk`` keys) times the
    schedule's heads of a GQA group."""
    kv_bk = BWD_TILES[d]["kv_bk"]
    blocks = 2 if kv_bk == 128 and schedule.nk > 1 and schedule.block_kv % kv_bk else 1
    return blocks * (1 if schedule.num_heads == 1 else h // h_kv)


def dkv_walk(schedule: BlockSchedule, h: int, h_kv: int, d: int, kvh: int, k0: int,
             seg=None, seg_all: bool = False):
    """The stages the dk/dv kernel's CTA of kv head ``kvh`` and keys ``k0 ..
    k0 + kv_bk`` walks, as ``splash_bwd.cu``'s ``SplashWalk.produce`` does:
    a list of (query tile start, query head, (step kind of each 64-key
    half)). Query blocks in ascending order, each as 64-row tiles, the GQA
    group's heads inner; a half's kind is its kv block's in the head's row
    of the transposed schedule (0 for a block the row does not list, or for
    a PARTIAL tile the causal bound or the band leaves empty); a (tile,
    head) whose halves are all 0 is not walked. ``seg``: one batch row's
    segment ids [s] (numpy), which with ``seg_all`` (runtime ids) also drop
    a tile none of whose ids falls in the range of the keys' ids."""
    kv_bk = BWD_TILES[d]["kv_bk"]
    sq, sk = schedule.seq_q, schedule.seq_kv
    bq, bk, nk = schedule.block_q, schedule.block_kv, schedule.nk
    group = h // h_kv
    halves = kv_bk // 64
    kb = [(0 if nk == 1 else (k0 + 64 * a) // bk) if k0 + 64 * a < sk else -1
          for a in range(halves)]
    heads = [0] if schedule.num_heads == 1 else [kvh * group + g for g in range(group)]

    def kind_of(hs, block, qb):
        row_q = schedule.q_index[hs, block]
        row_k = schedule.step_kind_t[hs, block]
        hit = (row_k != 0) & (row_q == qb)
        return int(row_k[hit][0]) if hit.any() else 0

    def dropped(q_lo, q_hi, k_lo, k_hi):
        return bool((schedule.causal and k_lo > q_hi)
                    or (schedule.window and q_lo - k_hi >= schedule.window))

    listed = sorted({int(qb) for hs in heads for b in set(kb) if b >= 0
                     for qb, kd in zip(schedule.q_index[hs, b], schedule.step_kind_t[hs, b])
                     if kd != 0})
    if seg is not None:
        kids = seg[k0:min(k0 + kv_bk, sk)]
        kmin, kmax = int(kids.min()), int(kids.max())
    stages = []
    for qb in listed:
        q_end = min(qb * bq + bq, sq)
        for q0 in range(qb * bq, q_end, 64):
            if seg is not None and seg_all:
                qids = seg[q0:min(q0 + 64, sq)]
                if not ((qids >= kmin) & (qids <= kmax)).any():
                    continue
            q_last = min(q0 + 64, q_end) - 1
            for g in range(group):
                hs = heads[0 if len(heads) == 1 else g]
                kinds = []
                for a in range(halves):
                    kd = kind_of(hs, kb[a], qb) if kb[a] >= 0 else 0
                    k_lo = k0 + 64 * a
                    if kd == PARTIAL and dropped(q0, q_last, k_lo, min(k_lo + 64, sk) - 1):
                        kd = 0
                    kinds.append(kd)
                if any(kinds):
                    stages.append((q0, kvh * group + g, tuple(kinds)))
    return stages


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------
def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_args(where, q, k, v, schedule, segment_ids, *more, backward=False):
    """Check what the kernels take; return contiguous, 16-byte aligned
    tensors, the segment plane (int32 or None) and seg_all."""
    _check_schedule(q, k, schedule)
    tensors = (q, k, v) + tuple(more)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{where}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{where}: q {tuple(q.shape)} and k/v {tuple(k.shape)} differ in "
                         "batch or head_dim")
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
    for block, n, axis in ((schedule.block_q, schedule.nq, "query"),
                           (schedule.block_kv, schedule.nk, "key")):
        if (axis == "query" or backward) and block % KERNEL_TILE and n != 1:
            raise NotImplementedError(
                f"{where}: a {axis} block of {block} in {n} blocks; the kernels take "
                f"blocks that are multiples of {KERNEL_TILE}, or a single block"
            )
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(
            f"{where}: every tensor must be on one CUDA device "
            f"(got {sorted({str(t.device) for t in tensors})})"
        )
    seg, seg_all = _segments(schedule, segment_ids, b, sq, k.shape[2], q.device)
    if seg is not None:
        seg = _aligned(seg)
    return [_aligned(t) for t in tensors], seg, seg_all


def _tail(q, k, schedule, scale, seg_all, rows, width):
    b, h, sq, d = q.shape
    return (b, h, k.shape[1], sq, k.shape[2], d, ctypes.c_float(_scale(q, scale)),
            schedule.num_heads, rows, width, schedule.block_q, schedule.block_kv,
            int(schedule.causal), int(schedule.window), int(seg_all))


def _ptr(t):
    return None if t is None else t.data_ptr()


def splash_fwd_cuda(q, k, v, schedule: BlockSchedule, segment_ids=None, scale=None,
                    base: int = 0):
    """Launch the forward kernel. Returns (out bf16 [b, h, sq, d], lse fp32
    [b, h, sq])."""
    (q, k, v), seg, seg_all = _kernel_args("splash_fwd_cuda", q, k, v, schedule, segment_ids)
    b, h, sq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    if q.numel() == 0:
        return out, lse
    kvi, kind = device_arrays(schedule, q.device, ("kv_index", "step_kind"))
    rc = FWD_KERNEL.fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg), kvi.data_ptr(), kind.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        *_tail(q, k, schedule, scale, seg_all, schedule.nq, schedule.grid_width),
        int(base), stream_ptr(q),
    )
    FWD_KERNEL.check(rc)
    FWD_KERNEL.launches += 1
    return out, lse


def splash_bwd_dq_cuda(q, k, v, out, do, lse, schedule: BlockSchedule, segment_ids=None,
                       scale=None):
    """Launch the dq kernel. Returns dq (bf16, q's shape)."""
    (q, k, v, out, do, lse), seg, seg_all = _kernel_args(
        "splash_bwd_dq_cuda", q, k, v, schedule, segment_ids, out, do.to(q.dtype), lse.float(),
        backward=True)
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    kvi, kind = device_arrays(schedule, q.device, ("kv_index", "step_kind"))
    rc = DQ_KERNEL.fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(),
        _ptr(seg), kvi.data_ptr(), kind.data_ptr(), dq.data_ptr(),
        *_tail(q, k, schedule, scale, seg_all, schedule.nq, schedule.grid_width),
        stream_ptr(q),
    )
    DQ_KERNEL.check(rc)
    DQ_KERNEL.launches += 1
    return dq


def splash_bwd_dkv_cuda(q, k, v, out, do, lse, schedule: BlockSchedule, segment_ids=None,
                        scale=None):
    """Launch the dk/dv kernel. Returns (dk, dv), bf16 in k's shape, each
    summed over the kv head's GQA group."""
    (q, k, v, out, do, lse), seg, seg_all = _kernel_args(
        "splash_bwd_dkv_cuda", q, k, v, schedule, segment_ids, out, do.to(q.dtype),
        lse.float(), backward=True)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    qi, kind_t = device_arrays(schedule, q.device, ("q_index", "step_kind_t"))
    rc = DKV_KERNEL.fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(),
        _ptr(seg), qi.data_ptr(), kind_t.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_tail(q, k, schedule, scale, seg_all, schedule.nk, schedule.grid_width_t),
        stream_ptr(q),
    )
    DKV_KERNEL.check(rc)
    DKV_KERNEL.launches += 1
    return dk, dv


class SplashAttention(torch.autograd.Function):
    """The kernels (CUDA tensors) or their plain versions (CPU tensors)
    under one autograd node; saves q, k, v, out and the fp32 LSE."""

    @staticmethod
    def forward(ctx, q, k, v, schedule, segment_ids, scale):
        if q.device.type == "cpu":
            out, lse = splash_fwd_reference(q, k, v, schedule, segment_ids, scale)
        else:
            out, lse = splash_fwd_cuda(q, k, v, schedule, segment_ids, scale)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.schedule, ctx.scale = schedule, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        args = (q, k, v, out, do, lse, ctx.schedule, segment_ids, ctx.scale)
        if q.device.type == "cpu":
            dq, dk, dv = splash_bwd_reference(*args)
        else:
            dq = splash_bwd_dq_cuda(*args)
            dk, dv = splash_bwd_dkv_cuda(*args)
        return dq, dk, dv, None, None, None


def splash_attention(q, k, v, schedule: BlockSchedule, *, segment_ids=None,
                     scale: Optional[float] = None):
    """Scheduled block-sparse attention. q: [b, h, sq, d]; k/v: [b, h_kv,
    sk, d] (GQA: kv is never repeated in memory on the kernel path).
    ``segment_ids`` [b, s] (runtime ids) mask every scheduled step; a
    schedule built with static ids (DocumentMask) masks its partial steps
    with them, and then runtime ids are refused. Differentiable."""
    b, h, sq, d = q.shape
    _check_schedule(q, k, schedule)
    if segment_ids is not None:
        segment_ids = torch.as_tensor(segment_ids)
    # the JAX package's errors, raised before any work
    _segments(schedule, segment_ids, b, sq, k.shape[2], q.device)
    return SplashAttention.apply(q, k, v, schedule, segment_ids, scale)


@functools.lru_cache(maxsize=256)
def prefill_schedule(start: int, t: int, S: int, window: int, block_kv: int) -> BlockSchedule:
    """The one-row schedule of a prefill chunk of ``t`` queries at global
    positions start .. start + t - 1 over a context of S keys: causal, plus
    the window band, built as ``splash_pallas.splash_prefill_attention``
    builds it (candidate blocks from the window's first block, kind 0 past
    the chunk's last block or behind the band, padding clamped to the last
    active block). One difference: a block past the context (a bucket's
    padded tail running beyond S) is kind 0 here, so only such padded rows,
    whose outputs no caller reads, can differ. Cached: one build and one
    upload (of the forward's two arrays) per chunk position, shared by every
    layer."""
    nk = S // block_kv
    width = min(nk, (t + window - 2) // block_kv + 2) if window else nk
    hi = start + t - 1                    # last q position in the chunk
    last = hi // block_kv                 # last kv block any row attends
    first = max(start - (window - 1), 0) // block_kv if window else 0
    idx = first + np.arange(width, dtype=np.int64)
    k_lo = idx * block_kv
    k_hi = k_lo + block_kv - 1
    in_range = (idx <= last) & (idx < nk)
    if window:
        full = (k_hi <= start) & ((hi - k_lo) < window)
        empty = ~in_range | ((start - k_hi) >= window)
    else:
        full = k_hi <= start
        empty = ~in_range
    kind = np.where(empty, 0, np.where(full, FULL, PARTIAL)).astype(np.int32)
    kvi = np.clip(idx, 0, min(max(last, 0), nk - 1)).astype(np.int32)
    # the transposed schedule of one query block: per kv block, query block
    # 0 with the block's kind (schedule._compact of the swapped status)
    step_kind_t = np.zeros((1, nk, 1), np.int32)
    step_kind_t[0, kvi[kind > 0], 0] = kind[kind > 0]
    return BlockSchedule(
        seq_q=t, seq_kv=S, block_q=t, block_kv=block_kv, causal=True, window=int(window),
        segment_ids=None, kv_index=kvi.reshape(1, 1, width), step_kind=kind.reshape(1, 1, width),
        q_index=np.zeros((1, nk, 1), np.int32), step_kind_t=step_kind_t,
    )


def splash_prefill_attention(q, k, v, start, *, window: int = 0, block_kv: int,
                             scale: Optional[float] = None):
    """Forward-only scheduled attention for serving chunked prefill. ``q``
    is one [b, h, t, d] chunk whose rows sit at global positions start ..
    start + t - 1; k/v are the gathered paged context [b, h_kv, S, d] at
    positions 0 .. S - 1. Causal, plus an optional sliding-window band; the
    kernel visits ~(window + t) / block_kv blocks instead of S / block_kv."""
    b, h, t, d = q.shape
    S = k.shape[2]
    if S % block_kv:
        raise ValueError(f"context length {S} not divisible by block_kv {block_kv}")
    start = int(start)
    schedule = prefill_schedule(start, t, S, int(window or 0), int(block_kv))
    if q.device.type == "cpu":
        return splash_fwd_reference(q, k, v, schedule, scale=scale, base=start)[0]
    return splash_fwd_cuda(q, k, v, schedule, scale=scale, base=start)[0]
