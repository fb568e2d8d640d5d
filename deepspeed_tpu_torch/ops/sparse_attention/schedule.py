"""Compacted block schedules: what the splash kernels iterate.

The port's copy of ``deepspeed_tpu/ops/sparse_attention/schedule.py``.
``build_schedule`` turns a [h, nq, nk] block-status matrix (mask.py) into
the int32 arrays the splash kernels read:

  * ``kv_index[h, nq, width]``  — for each q block, the kv-block indices it
    visits, compacted left (EMPTY blocks are absent: never loaded).
    ``width`` is the max active count over all rows, so the work scales
    with the layout's densest row, not with nk.
  * ``step_kind[h, nq, width]`` — {0 skip, 1 partial, 2 full} per step.
    Padding steps are ``skip`` and their kv_index repeats the row's last
    real index; the kernels skip them without loading anything.
  * the transposed pair ``q_index`` / ``step_kind_t`` [h, nk, width_t] for
    the dk/dv backward (per kv block: which q blocks touch it).

Everything here is numpy on the host. The one addition of the port is
``device_array`` / ``device_arrays``: each array a kernel reads uploaded
once per (schedule, device) and kept, never per step or per layer.
"""

import weakref
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np

from deepspeed_tpu_torch.ops.sparse_attention.mask import (
    EMPTY, PARTIAL, CausalMask, LayoutMask, Mask, MaskAnd, MultiHeadMask,
)


def _compact(status: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[h, rows, cols] status -> (index [h, rows, width], kind [h, rows, width])."""
    h, rows, cols = status.shape
    width = max(1, int((status != EMPTY).sum(-1).max()))
    index = np.zeros((h, rows, width), np.int32)
    kind = np.zeros((h, rows, width), np.int32)
    for hi in range(h):
        for r in range(rows):
            (act,) = np.nonzero(status[hi, r])
            n = act.size
            if n:
                index[hi, r, :n] = act
                kind[hi, r, :n] = status[hi, r, act]
                index[hi, r, n:] = act[-1]  # padding repeats the last index
            # rows with no active block keep index 0 / kind 0: the kernel
            # still writes them, as zeros (dead rows)
    return index, kind


@dataclass(frozen=True, eq=False)  # identity hash: a cache key
class BlockSchedule:
    """Host-side schedule for one (mask, block-size) pairing."""

    seq_q: int
    seq_kv: int
    block_q: int
    block_kv: int
    causal: bool
    window: int                       # 0 = no band predicate
    segment_ids: Optional[np.ndarray]  # static ids baked into the schedule
    kv_index: np.ndarray              # [h, nq, width] int32
    step_kind: np.ndarray             # [h, nq, width] int32
    q_index: np.ndarray               # [h, nk, width_t] int32
    step_kind_t: np.ndarray           # [h, nk, width_t] int32

    @property
    def num_heads(self) -> int:
        return self.kv_index.shape[0]

    @property
    def nq(self) -> int:
        return self.kv_index.shape[1]

    @property
    def nk(self) -> int:
        return self.q_index.shape[1]

    @property
    def grid_width(self) -> int:
        """Steps per q row: max active kv blocks over any q row."""
        return self.kv_index.shape[2]

    @property
    def grid_width_t(self) -> int:
        return self.q_index.shape[2]

    @property
    def num_active(self) -> int:
        """Total scheduled (non-skip) forward steps across heads."""
        return int((self.step_kind != EMPTY).sum())

    @property
    def num_partial(self) -> int:
        return int((self.step_kind == PARTIAL).sum())

    @property
    def density(self) -> float:
        return self.num_active / float(self.num_heads * self.nq * self.nk)


# (schedule -> {(array name, device): tensor}); a schedule that is dropped
# drops its tensors
_DEVICE_ARRAYS: "weakref.WeakKeyDictionary[BlockSchedule, Dict[Tuple[str, str], object]]" = (
    weakref.WeakKeyDictionary()
)
SCHEDULE_ARRAYS = ("kv_index", "step_kind", "q_index", "step_kind_t")


def device_array(schedule: BlockSchedule, name: str, device,
                 build: Optional[Callable[[BlockSchedule], np.ndarray]] = None):
    """The schedule's int32 array ``name`` (or, given ``build``, the array
    it derives from the schedule under that name) as a contiguous tensor on
    ``device``: uploaded on the first call for that (schedule, name, device)
    and kept beside the schedule for every later step and layer."""
    import torch

    per = _DEVICE_ARRAYS.setdefault(schedule, {})
    key = (name, str(torch.device(device)))
    if key not in per:
        a = build(schedule) if build else np.asarray(getattr(schedule, name), np.int32)
        per[key] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return per[key]


def device_arrays(schedule: BlockSchedule, device, names=SCHEDULE_ARRAYS):
    """``device_array`` of each of ``names`` (by default all four): the
    forward and dq kernels read kv_index and step_kind, dk/dv the
    transposed pair, so a forward-only schedule never uploads the latter."""
    return tuple(device_array(schedule, n, device) for n in names)


def build_schedule(status: np.ndarray, *, seq_q: int, seq_kv: int,
                   block_q: int, block_kv: int, causal: bool = False,
                   window: int = 0,
                   segment_ids: Optional[np.ndarray] = None) -> BlockSchedule:
    """Compact a [h, nq, nk] (or [nq, nk]) status matrix into a schedule."""
    status = np.asarray(status)
    if status.ndim == 2:
        status = status[None]
    h, nq, nk = status.shape
    if nq != seq_q // block_q or nk != seq_kv // block_kv:
        raise ValueError(f"status grid {status.shape[1:]} != "
                         f"{(seq_q // block_q, seq_kv // block_kv)}")
    kv_index, step_kind = _compact(status)
    q_index, step_kind_t = _compact(np.swapaxes(status, 1, 2))
    return BlockSchedule(
        seq_q=seq_q, seq_kv=seq_kv, block_q=block_q, block_kv=block_kv,
        causal=bool(causal), window=int(window), segment_ids=segment_ids,
        kv_index=kv_index, step_kind=step_kind,
        q_index=q_index, step_kind_t=step_kind_t,
    )


def schedule_from_mask(mask: Union[Mask, MultiHeadMask], block_q: int,
                       block_kv: Optional[int] = None) -> BlockSchedule:
    """Compile a mask (mask.py) into its compacted schedule."""
    block_kv = block_kv or block_q
    status = mask.block_status(block_q, block_kv)
    if status.ndim == 2:
        status = status[None]
    sq, sk = mask.shape
    return build_schedule(
        status, seq_q=sq, seq_kv=sk, block_q=block_q, block_kv=block_kv,
        causal=mask.causal, window=mask.window, segment_ids=mask.segment_ids,
    )


def schedule_from_layout(layout: np.ndarray, block: int, causal: bool = False,
                         block_q: Optional[int] = None,
                         block_kv: Optional[int] = None) -> BlockSchedule:
    """Route a SparsityConfig ``make_layout`` matrix [h, nq, nk] through the
    schedule builder: layout blocks become FULL/EMPTY status, optionally
    intersected with the causal predicate (which demotes diagonal blocks to
    PARTIAL and prunes the strict upper triangle entirely)."""
    layout = np.asarray(layout)
    if layout.ndim == 2:
        layout = layout[None]
    bq = block_q or block
    bk = block_kv or block
    heads = []
    for hl in layout:
        m: Mask = LayoutMask(hl, block)
        if causal:
            m = MaskAnd(m, CausalMask(m.shape))
        heads.append(m)
    return schedule_from_mask(MultiHeadMask(heads), bq, bk)
