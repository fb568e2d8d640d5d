"""Sequence state tracking for ragged batching.

Reference: ``DSStateManager``/``DSSequenceDescriptor``
(inference/v2/ragged/ragged_manager.py, sequence_descriptor.py): per-sequence
seen-token counts and KV block tables, backed by the BlockedAllocator.

The paged KV cache itself lives on device as
  k/v: [n_layers, num_blocks, block_size, n_kv_heads, head_dim]
and each sequence owns an ordered list of block ids; token t of a sequence
lives in block ``table[t // block_size]`` at row ``t % block_size``.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.inference.v2.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.inference.v2.prefix_cache import PrefixCache


@dataclass
class DSSequenceDescriptor:
    uid: int
    seen_tokens: int = 0  # tokens already in the KV cache
    tokens: List[int] = field(default_factory=list)  # full history (host)
    block_table: List[int] = field(default_factory=list)
    finished: bool = False

    @property
    def cur_allocated_blocks(self) -> int:
        return len(self.block_table)


class DSStateManager:
    def __init__(self, config, kv_config):
        self._config = config
        self._kv = kv_config
        self._alloc = BlockedAllocator(kv_config.num_blocks)
        self._seqs: Dict[int, DSSequenceDescriptor] = {}
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(
                kv_config.block_size,
                self._alloc,
                max_cached_blocks=int(getattr(kv_config, "prefix_cache_blocks", 0) or 0),
            )
            if getattr(kv_config, "prefix_cache", False)
            else None
        )
        # host-tier readmit hook (engine_v2._host_readmit): called by
        # seed_from_cache as fn(seq, prompt_tokens, n_cached) -> n_cached'
        # to extend trie coverage with re-imported host-tier blocks. None
        # when the host tier is off; the manager stays engine-agnostic.
        self.host_readmit = None

    # -- reference API --------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return self._alloc.free_blocks

    @property
    def n_tracked_sequences(self) -> int:
        return len(self._seqs)

    def get_sequence(self, uid: int) -> Optional[DSSequenceDescriptor]:
        return self._seqs.get(uid)

    def get_or_create_sequence(self, uid: int) -> DSSequenceDescriptor:
        if uid in self._seqs:
            return self._seqs[uid]
        if len(self._seqs) >= self._config.max_tracked_sequences:
            raise RuntimeError(
                f"tracked sequences exceed max_tracked_sequences="
                f"{self._config.max_tracked_sequences}"
            )
        seq = DSSequenceDescriptor(uid=uid)
        self._seqs[uid] = seq
        return seq

    def blocks_needed(self, seq: DSSequenceDescriptor, new_tokens: int) -> int:
        bs = self._kv.block_size
        total = seq.seen_tokens + new_tokens
        need = (total + bs - 1) // bs
        return max(0, need - len(seq.block_table))

    def seq_capped(self, seq: DSSequenceDescriptor, new_tokens: int) -> bool:
        """True if the per-sequence block cap makes this growth PERMANENTLY
        impossible (vs transient pool exhaustion, which frees up later)."""
        need = self.blocks_needed(seq, new_tokens)
        return len(seq.block_table) + need > self._kv.max_blocks_per_seq

    def check_admissible(self, total_tokens: int) -> None:
        """Raise if a sequence of this TOTAL length (prior + new tokens)
        could never be scheduled, even with the whole pool free (liveness
        guard at submit time)."""
        bs = self._kv.block_size
        need = (total_tokens + bs - 1) // bs
        limit = min(self._kv.max_blocks_per_seq, self._kv.num_blocks)
        if need > limit:
            raise ValueError(
                f"prompt needs {need} KV blocks but at most {limit} are "
                f"usable (max_blocks_per_seq={self._kv.max_blocks_per_seq}, "
                f"pool={self._kv.num_blocks})"
            )

    def extend(self, seq: DSSequenceDescriptor, new_tokens: int) -> bool:
        """Reserve blocks for new_tokens; False if pool exhausted. When the
        pool runs dry and a prefix cache is live, LRU cached blocks no
        sequence shares are evicted to make room — cached KV is a reuse
        *opportunity*, never a reason to stall live work."""
        need = self.blocks_needed(seq, new_tokens)
        if len(seq.block_table) + need > self._kv.max_blocks_per_seq:
            return False
        short = need - self._alloc.free_blocks
        if short > 0 and self.prefix_cache is not None:
            self.prefix_cache.evict(short)
        if need > self._alloc.free_blocks:
            return False
        if need:
            seq.block_table.extend(int(b) for b in self._alloc.allocate(need))
        return True

    # -- prefix cache bridge ---------------------------------------------
    def seed_from_cache(self, seq: DSSequenceDescriptor, prompt_tokens) -> int:
        """Seed a FRESH sequence's block table with cached blocks covering
        the longest block-aligned prefix of ``prompt_tokens`` present in
        the trie (taking one reference per block for this sequence).
        Returns the number of prompt tokens whose KV is already in the
        pool — prefill starts there. No-op (0) without a cache or for a
        non-fresh sequence.

        With a host tier live, the trie match is then extended through
        ``host_readmit``: the next contiguous run of full blocks resident
        in the host store is re-imported into freshly allocated pool
        blocks (double-buffered chunked scatter) and counted as cached —
        so downstream prefill charging (the scheduler's chunk budget)
        sees only the truly-cold tail."""
        if self.prefix_cache is None or seq.seen_tokens or seq.block_table:
            return 0
        blocks, n_tokens = self.prefix_cache.acquire(prompt_tokens)
        if n_tokens:
            seq.block_table.extend(int(b) for b in blocks)
            seq.seen_tokens = n_tokens
        if self.host_readmit is not None:
            n_tokens = self.host_readmit(seq, prompt_tokens, n_tokens)
        return n_tokens

    def cache_prefill_blocks(self, seq: DSSequenceDescriptor, upto_tokens: int) -> int:
        """Register the full blocks covering ``seq.tokens[:upto_tokens]``
        in the trie (their KV is written by the step that scheduled them).
        Shared path segments dedupe to the first writer's blocks."""
        if self.prefix_cache is None:
            return 0
        n_full = min(upto_tokens // self._kv.block_size, len(seq.block_table))
        if n_full == 0:
            return 0
        return self.prefix_cache.insert(
            seq.tokens[: n_full * self._kv.block_size], seq.block_table[:n_full]
        )

    def truncate_blocks(
        self, seq: DSSequenceDescriptor, keep_tokens: int, min_keep_blocks: int = 0
    ) -> int:
        """Roll a sequence's KV block cursor BACK: release table blocks past
        those needed to hold ``keep_tokens`` (speculative-decode rejection
        rollback). ``min_keep_blocks`` floors the cut at the pre-round table
        length, so only blocks allocated for the rolled-back tokens are ever
        candidates — in particular, prefix-cache-seeded shared blocks always
        sit below the floor and are never touched. Returns the number of
        blocks released.

        Freeing goes through the refcount-aware ``allocator.free``, but a
        dropped block being shared would still be a protocol violation
        (verify-round writes must never land in shared blocks: the cache
        would keep serving KV for tokens that were rolled back), so shared
        blocks in the drop set raise instead of silently decrementing."""
        bs = self._kv.block_size
        keep = max((keep_tokens + bs - 1) // bs, int(min_keep_blocks), 0)
        if keep >= len(seq.block_table):
            return 0
        drop = [int(b) for b in seq.block_table[keep:]]
        shared = [b for b in drop if self._alloc.refcount(b) > 1]
        if shared:
            raise RuntimeError(
                f"spec rollback would free shared KV block(s) {shared} of "
                f"uid={seq.uid}: rejected-draft blocks must be private "
                "(prefix-cache corruption guard)"
            )
        del seq.block_table[keep:]
        self._alloc.free(drop)
        return len(drop)

    def kv_block_accounting(self) -> Dict[str, int]:
        """The pool conservation law, for invariant checks: every block is
        exactly one of free / referenced by a live block table (deduped) /
        held only by the cache. Shared blocks (live AND cached) count once,
        on the live side."""
        live = set()
        for seq in self._seqs.values():
            live.update(int(b) for b in seq.block_table)
        cached = set(self.prefix_cache.cached_block_ids()) if self.prefix_cache else set()
        return {
            "total": self._alloc.total_blocks,
            "free": self._alloc.free_blocks,
            "live": len(live),
            "cached_only": len(cached - live),
        }

    def alloc_stats(self) -> Dict[str, int]:
        """Allocator occupancy counters (total/free/held/shared) for
        per-replica health surfaces."""
        return self._alloc.stats()

    def export_sequence(self, uid: int) -> Dict:
        """Host-side snapshot of a live sequence for cross-engine KV
        handoff: token history, KV cursor, and the block-table ids whose
        pool rows the exporter gathers. Pure read — ownership of the
        blocks stays with this manager until ``flush_sequence``."""
        seq = self._seqs.get(uid)
        if seq is None or seq.finished:
            raise KeyError(f"export_sequence({uid}): no live sequence")
        return {
            "uid": uid,
            "tokens": list(seq.tokens),
            "seen_tokens": seq.seen_tokens,
            "block_table": list(seq.block_table),
        }

    def flush_sequence(self, uid: int) -> None:
        """Release a finished sequence's blocks (reference flush)."""
        seq = self._seqs.pop(uid, None)
        if seq is not None and seq.block_table:
            self._alloc.free(seq.block_table)

    def block_table_array(self, seq: DSSequenceDescriptor) -> np.ndarray:
        out = np.zeros((self._kv.max_blocks_per_seq,), np.int32)
        out[: len(seq.block_table)] = seq.block_table
        return out
