"""Splash-style mask abstraction: masks that compile to block schedules.

The port's numpy copy of ``deepspeed_tpu/ops/sparse_attention/mask.py``.
Every mask reduces, on the host, to a per-(q-block, kv-block) STATUS in
{EMPTY, PARTIAL, FULL}. EMPTY blocks are never scheduled (the splash
kernels never load them), FULL blocks run without any in-kernel mask
application, and PARTIAL blocks re-derive the token-level predicate
analytically inside the kernel (causal edge / window edge / segment
boundary) — no dense [s, s] mask is ever materialized.

Masks compose by intersection (``&``): the status lattice combines as
EMPTY-dominates / FULL-requires-both, and the analytic predicates union.
``MultiHeadMask`` stacks per-head masks into the [h, nq, nk] status the
schedule builder (schedule.py) compacts.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np

EMPTY = 0
PARTIAL = 1
FULL = 2


def _block_grid(sq: int, sk: int, bq: int, bk: int) -> Tuple[int, int]:
    if sq % bq or sk % bk:
        raise ValueError(f"seq ({sq}, {sk}) not divisible by blocks ({bq}, {bk})")
    return sq // bq, sk // bk


class Mask:
    """Base mask over a [sq, sk] token grid.

    Subclasses implement ``block_status(bq, bk) -> np.ndarray [nq, nk]``
    (values in {EMPTY, PARTIAL, FULL}) and declare which analytic
    predicates the kernel must apply inside PARTIAL blocks via the
    ``causal`` / ``window`` / ``segment_ids`` properties.
    """

    def __init__(self, shape: Tuple[int, int]):
        self.shape = (int(shape[0]), int(shape[1]))

    # -- analytic predicate declaration (kernel-side, PARTIAL blocks only) --
    @property
    def causal(self) -> bool:
        return False

    @property
    def window(self) -> int:  # 0 = no sliding-window band
        return 0

    @property
    def segment_ids(self) -> Optional[np.ndarray]:
        return None

    def block_status(self, bq: int, bk: int) -> np.ndarray:
        raise NotImplementedError

    def token_mask(self) -> np.ndarray:
        """Dense [sq, sk] bool mask (True = attend) — oracle for tests."""
        sq, sk = self.shape
        m = np.ones((sq, sk), bool)
        qp = np.arange(sq)[:, None]
        kp = np.arange(sk)[None, :]
        if self.causal:
            m &= qp >= kp
        if self.window:
            # THE shared band convention (ops/attention/core.window_too_far):
            # key out of band iff q - k >= window
            m &= (qp - kp) < self.window
        if self.segment_ids is not None:
            ids = np.asarray(self.segment_ids)
            m &= ids[:sq, None] == ids[None, :sk]
        return m

    def __and__(self, other: "Mask") -> "Mask":
        return MaskAnd(self, other)


class FullMask(Mask):
    """Dense: every block FULL."""

    def block_status(self, bq: int, bk: int) -> np.ndarray:
        nq, nk = _block_grid(*self.shape, bq, bk)
        return np.full((nq, nk), FULL, np.uint8)


class CausalMask(Mask):
    """q attends k iff q >= k (square grids; the serving prefill path
    handles the offset case with its own schedule row, see splash.py)."""

    @property
    def causal(self) -> bool:
        return True

    def block_status(self, bq: int, bk: int) -> np.ndarray:
        nq, nk = _block_grid(*self.shape, bq, bk)
        q_lo = np.arange(nq)[:, None] * bq          # min q in block
        q_hi = q_lo + bq - 1                        # max q
        k_lo = np.arange(nk)[None, :] * bk
        k_hi = k_lo + bk - 1
        full = q_lo >= k_hi                         # every pair q >= k
        empty = q_hi < k_lo                         # every pair q < k
        return np.where(full, FULL, np.where(empty, EMPTY, PARTIAL)).astype(np.uint8)


class LocalMask(Mask):
    """Causal sliding-window band: q attends k iff k <= q and q - k < window
    (the repo-wide ``window_too_far`` convention)."""

    def __init__(self, shape: Tuple[int, int], window: int):
        super().__init__(shape)
        if window <= 0:
            raise ValueError("LocalMask needs window > 0")
        self._window = int(window)

    @property
    def causal(self) -> bool:
        return True

    @property
    def window(self) -> int:
        return self._window

    def block_status(self, bq: int, bk: int) -> np.ndarray:
        nq, nk = _block_grid(*self.shape, bq, bk)
        w = self._window
        q_lo = np.arange(nq)[:, None] * bq
        q_hi = q_lo + bq - 1
        k_lo = np.arange(nk)[None, :] * bk
        k_hi = k_lo + bk - 1
        # full: every pair satisfies k <= q AND q - k < window
        full = (k_hi <= q_lo) & ((q_hi - k_lo) < w)
        # empty: every pair in the causal future, or every pair too far back
        empty = (k_lo > q_hi) | ((q_lo - k_hi) >= w)
        return np.where(full, FULL, np.where(empty, EMPTY, PARTIAL)).astype(np.uint8)


class DocumentMask(Mask):
    """Intra-document attention from STATIC per-token segment ids [s]:
    q attends k iff seg[q] == seg[k]. For monotone (packed, contiguous)
    ids the block status is analytic from per-block id ranges; arbitrary
    ids fall back to an exact blockwise comparison."""

    def __init__(self, segment_ids: Sequence[int]):
        ids = np.asarray(segment_ids)
        if ids.ndim != 1:
            raise ValueError(f"DocumentMask wants 1-D segment ids, got {ids.shape}")
        super().__init__((ids.shape[0], ids.shape[0]))
        self._ids = ids.astype(np.int32)

    @property
    def segment_ids(self) -> Optional[np.ndarray]:
        return self._ids

    def block_status(self, bq: int, bk: int) -> np.ndarray:
        nq, nk = _block_grid(*self.shape, bq, bk)
        ids = self._ids
        if np.all(np.diff(ids) >= 0):
            q_min = ids.reshape(nq, bq).min(1)[:, None]
            q_max = ids.reshape(nq, bq).max(1)[:, None]
            k_min = ids.reshape(nk, bk).min(1)[None, :]
            k_max = ids.reshape(nk, bk).max(1)[None, :]
            full = (q_min == q_max) & (k_min == k_max) & (q_min == k_min)
            empty = (q_max < k_min) | (k_max < q_min)
            return np.where(full, FULL, np.where(empty, EMPTY, PARTIAL)).astype(np.uint8)
        # exact fallback, one block row at a time (avoids an s^2 temp)
        status = np.empty((nq, nk), np.uint8)
        ks = ids.reshape(nk, bk)
        for qi in range(nq):
            eq = ids[qi * bq:(qi + 1) * bq][None, :, None] == ks[:, None, :]
            status[qi] = np.where(eq.all((1, 2)), FULL,
                                  np.where(eq.any((1, 2)), PARTIAL, EMPTY))
        return status


class LayoutMask(Mask):
    """Block-granular layout from a SparsityConfig ``make_layout`` matrix
    [nq, nk] (single head). Blocks are all-or-nothing at the layout's own
    block size; the kernel block must equal it or divide it evenly."""

    def __init__(self, layout: np.ndarray, block: int):
        layout = np.asarray(layout)
        if layout.ndim != 2:
            raise ValueError(f"LayoutMask wants a single-head [nq, nk] layout, "
                             f"got {layout.shape}")
        super().__init__((layout.shape[0] * block, layout.shape[1] * block))
        self._layout = (layout != 0)
        self._block = int(block)

    def block_status(self, bq: int, bk: int) -> np.ndarray:
        B = self._block
        if B % bq or B % bk:
            raise ValueError(
                f"kernel blocks ({bq}, {bk}) must divide the layout block {B}: "
                "a layout block is all-or-nothing at token level, so a coarser "
                "kernel block could not be classified full/partial")
        lay = np.repeat(np.repeat(self._layout, B // bq, 0), B // bk, 1)
        return np.where(lay, FULL, EMPTY).astype(np.uint8)

    def token_mask(self) -> np.ndarray:
        return np.repeat(np.repeat(self._layout, self._block, 0), self._block, 1)


class MaskAnd(Mask):
    """Intersection of two masks (same token shape)."""

    def __init__(self, a: Mask, b: Mask):
        if a.shape != b.shape:
            raise ValueError(f"mask shapes differ: {a.shape} vs {b.shape}")
        if a.segment_ids is not None and b.segment_ids is not None:
            raise ValueError("at most one mask in an intersection may carry "
                             "segment ids")
        super().__init__(a.shape)
        self._a, self._b = a, b

    @property
    def causal(self) -> bool:
        return self._a.causal or self._b.causal

    @property
    def window(self) -> int:
        ws = [m.window for m in (self._a, self._b) if m.window]
        return min(ws) if ws else 0

    @property
    def segment_ids(self) -> Optional[np.ndarray]:
        return self._a.segment_ids if self._a.segment_ids is not None else self._b.segment_ids

    def block_status(self, bq: int, bk: int) -> np.ndarray:
        sa = self._a.block_status(bq, bk)
        sb = self._b.block_status(bq, bk)
        empty = (sa == EMPTY) | (sb == EMPTY)
        full = (sa == FULL) & (sb == FULL)
        return np.where(empty, EMPTY, np.where(full, FULL, PARTIAL)).astype(np.uint8)

    def token_mask(self) -> np.ndarray:
        return self._a.token_mask() & self._b.token_mask()


class MultiHeadMask:
    """Stack of per-head masks -> [h, nq, nk] status. All heads must agree
    on the analytic predicates (causal/window/segments are compiled into
    the kernel once); only the block layouts may differ per head."""

    def __init__(self, masks: Sequence[Mask]):
        if not masks:
            raise ValueError("MultiHeadMask needs at least one head mask")
        m0 = masks[0]
        for m in masks[1:]:
            if m.shape != m0.shape:
                raise ValueError("per-head masks must share the token shape")
            if (m.causal, m.window) != (m0.causal, m0.window):
                raise ValueError(
                    "per-head masks must share causal/window predicates (the "
                    "kernel compiles one predicate set; only layouts may vary)")
            sa, sb = m.segment_ids, m0.segment_ids
            if (sa is None) != (sb is None) or (
                    sa is not None and not np.array_equal(sa, sb)):
                raise ValueError("per-head masks must share segment ids")
        self.masks: List[Mask] = list(masks)
        self.shape = m0.shape

    @property
    def causal(self) -> bool:
        return self.masks[0].causal

    @property
    def window(self) -> int:
        return self.masks[0].window

    @property
    def segment_ids(self) -> Optional[np.ndarray]:
        return self.masks[0].segment_ids

    def block_status(self, bq: int, bk: int) -> np.ndarray:
        return np.stack([m.block_status(bq, bk) for m in self.masks])

    def token_mask(self) -> np.ndarray:
        return np.stack([m.token_mask() for m in self.masks])
