"""KV block allocator (reference inference/v2/ragged/blocked_allocator.py).

Free-list over a fixed pool of KV blocks; host-side numpy (allocation is a
scheduling decision, not device work).

Two departures from the reference, both serving-driven:

  * **Refcounts** — prefix caching (``prefix_cache.py``) lets many
    sequences share one physical block. ``allocate()`` hands out blocks at
    refcount 1; ``share()`` adds holders; ``free()`` drops one holder and
    only returns a block to the free list when its refcount reaches 0. The
    double-free guard survives: dropping a holder from a block with no
    holders is still the bug it always was (one KV block handed to two
    sequences) and still raises.
  * **Vectorized free list** — ``allocate()``/``free()`` sit on the
    per-step scheduling hot path (every prompt chunk and decode extension
    goes through them). The reference's linked-list walk is O(n) Python
    iterations; here the free list is a numpy stack so both operations are
    single array splices.
"""

from typing import Iterable

import numpy as np


class BlockedAllocator:
    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"need at least 1 block, got {num_blocks}")
        self._num_blocks = num_blocks
        # free list as a stack: _stack[:_top] are the free block ids.
        # allocate() pops a slice off the top, free() pushes one back —
        # numpy splices instead of per-block Python loops.
        self._stack = np.arange(num_blocks - 1, -1, -1, dtype=np.int64)
        self._top = num_blocks
        # per-block holder count: 0 = free, 1 = single owner, >1 = shared
        # (prefix cache and/or multiple sequences). A block is only spliced
        # back into the free list when its last holder releases it.
        self._refcount = np.zeros(num_blocks, dtype=np.int64)

    @property
    def free_blocks(self) -> int:
        return self._top

    @property
    def total_blocks(self) -> int:
        return self._num_blocks

    def refcount(self, block: int) -> int:
        return int(self._refcount[int(block)])

    def refcounts(self, blocks) -> np.ndarray:
        return self._refcount[np.atleast_1d(np.asarray(blocks, np.int64))].copy()

    def is_shared(self, block: int) -> bool:
        """More than one holder (e.g. a prefix-cache block a live sequence
        also references). Shared blocks must never be written by decode or
        speculative-verify steps, and spec rollback refuses to drop them."""
        return int(self._refcount[int(block)]) > 1

    @property
    def allocated_blocks(self) -> np.ndarray:
        """Ids of all blocks with at least one holder (sorted)."""
        return np.flatnonzero(self._refcount > 0).astype(np.int64)

    def idle_mask(self, blocks) -> np.ndarray:
        """Boolean mask of blocks with EXACTLY one holder — the prefix
        cache's spill/evict candidate test, vectorized (the host tier
        makes eviction a hot path; a per-block ``refcount()`` loop over
        the cached set is O(cached) Python calls per eviction)."""
        return self._refcount[np.atleast_1d(np.asarray(blocks, np.int64))] == 1

    def stats(self) -> dict:
        """Pool occupancy counters for health/metrics surfaces: ``held`` is
        blocks with at least one holder, ``shared`` the subset with more
        than one (prefix-cache + live-sequence overlap), ``idle`` the
        single-holder subset (with a prefix cache live these are the
        evict-and-spill candidates: cache-only KV no sequence shares)."""
        return {
            "total": self._num_blocks,
            "free": int(self._top),
            "held": int(np.count_nonzero(self._refcount > 0)),
            "shared": int(np.count_nonzero(self._refcount > 1)),
            "idle": int(np.count_nonzero(self._refcount == 1)),
        }

    def _validate(self, blocks: np.ndarray, op: str) -> None:
        """Validate the WHOLE set before mutating: a partial free on error
        would leave the list in an in-between state."""
        if blocks.size == 0:
            return
        if blocks.min() < 0 or blocks.max() >= self._num_blocks:
            bad = blocks[(blocks < 0) | (blocks >= self._num_blocks)][0]
            raise ValueError(f"invalid block {int(bad)}")
        if np.unique(blocks).size != blocks.size:
            vals, counts = np.unique(blocks, return_counts=True)
            dup = vals[counts > 1][0]
            raise ValueError(f"block {int(dup)} appears twice in one {op}() call")
        unheld = blocks[self._refcount[blocks] == 0]
        if unheld.size:
            raise ValueError(
                f"double free of block {int(unheld[0])}: freeing an unallocated "
                "block would hand one KV block to two sequences"
            )

    def allocate(self, num_blocks: int) -> np.ndarray:
        if num_blocks > self._top:
            raise ValueError(f"cannot allocate {num_blocks} blocks ({self._top} free)")
        if num_blocks == 0:
            return np.empty(0, np.int64)
        out = self._stack[self._top - num_blocks : self._top].copy()
        self._top -= num_blocks
        self._refcount[out] = 1
        return out

    def share(self, blocks: Iterable[int]) -> None:
        """Add one holder to each block (prefix-cache hit or cache
        registration). Blocks must already be allocated."""
        blocks = np.atleast_1d(np.asarray(blocks, np.int64))
        self._validate(blocks, "share")
        self._refcount[blocks] += 1

    def free(self, blocks: Iterable[int]) -> None:
        """Drop one holder from each block; blocks whose refcount reaches 0
        return to the free list. Raises on unheld or duplicated ids (the
        double-free guard) BEFORE any mutation."""
        blocks = np.atleast_1d(np.asarray(blocks, np.int64))
        self._validate(blocks, "free")
        if blocks.size == 0:
            return
        self._refcount[blocks] -= 1
        dead = blocks[self._refcount[blocks] == 0]
        n = dead.size
        if n:
            self._stack[self._top : self._top + n] = dead
            self._top += n
