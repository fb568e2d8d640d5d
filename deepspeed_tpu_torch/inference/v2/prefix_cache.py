"""Automatic prefix cache over the paged KV pool.

vLLM/RadixAttention-style, rebuilt host-side and TPU-shape-friendly: the
unit of sharing is one FULL KV block (``block_size`` tokens), so a cache
hit seeds a sequence's block table with already-populated physical blocks
and prefill starts at the first uncached block boundary — no device work,
no ragged shapes. A hit converts O(prompt) prefill FLOPs + blocks into an
O(1) block-table copy.

Structure: a token-block trie. Each node keys on the token tuple of one
block, given its parent chain — so a path from the root spells a
block-aligned token prefix and carries the physical block ids holding its
KV. Lookup walks full blocks of the query prompt; insert extends the path
with a finished sequence's prefill blocks.

Sharing protocol (with ``BlockedAllocator`` refcounts):

  * the cache itself holds ONE reference on every block it has registered
    (so cached KV survives its original sequence's flush);
  * ``acquire()`` (a hit) takes one extra reference per matched block for
    the new sequence — released later through the sequence's normal
    ``flush_sequence`` path;
  * a cached block whose only holder is the cache (refcount == 1: no live
    sequence) is *evictable*; ``evict()`` drops LRU leaves first, which
    returns those blocks to the allocator's free list. Interior nodes
    shared by live sequences always carry refcount >= 2 and are never
    touched.

Copy-on-write discipline: only FULL blocks are ever cached or matched, so
a shared block is never appended to in place — a prompt's partial tail
block is always recomputed into the sequence's own fresh block. And a full
prompt hit is capped at ``len(prompt) - 1`` tokens: the engine must still
prefill at least one token to produce next-token logits.

Tiering: every node carries the chain hash of its block-aligned prefix
(``host_tier.block_hash``), and an optional ``spill_fn`` hook fires on
eviction while the victim's pool rows are still valid — the engine wires
it to the host tier so evicted KV demotes to host memory instead of
vanishing (see ``host_tier.py``).
"""

import heapq
import itertools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.inference.v2.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.inference.v2.host_tier import block_hash


class _Node:
    __slots__ = ("key", "parent", "children", "block", "last_used", "hkey")

    def __init__(self, key: Tuple[int, ...], parent: Optional["_Node"], block: int):
        self.key = key  # token tuple of THIS block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.block = block
        self.last_used = 0
        # chain hash of the block-aligned prefix ending here — the block's
        # cluster-wide identity (host tier key, PrefixDirectory advert)
        self.hkey = block_hash(parent.hkey, key) if parent is not None else b""


class PrefixCache:
    """Token-block trie mapping block-aligned token prefixes to physical
    KV blocks, with LRU eviction of unreferenced cached blocks."""

    def __init__(self, block_size: int, allocator: BlockedAllocator,
                 max_cached_blocks: int = 0):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = int(block_size)
        self._alloc = allocator
        # 0 = bounded only by the pool itself
        self.max_cached_blocks = int(max_cached_blocks)
        self._root = _Node((), None, -1)
        self._by_block: Dict[int, _Node] = {}
        self._clock = itertools.count(1)
        # optional spill hook: called as spill_fn(chain_hash, block_id)
        # inside _drop BEFORE the block returns to the free list (its pool
        # rows are still valid KV). The engine wires this to the host tier
        # (engine_v2._spill_block); it must swallow its own failures — a
        # missed spill degrades to a re-prefill, never a stalled evict.
        self.spill_fn: Optional[Callable[[bytes, int], None]] = None
        # counters surfaced through stats() -> serving metrics
        self.queries = 0
        self.hits = 0
        self.hit_tokens = 0
        self.hit_blocks = 0
        self.inserted_blocks = 0
        self.evictions = 0

    # -- helpers ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._by_block)

    def cached_block_ids(self) -> List[int]:
        return sorted(self._by_block)

    def _block_keys(self, tokens, n_blocks: int):
        toks = np.asarray(tokens).reshape(-1)
        bs = self.block_size
        for i in range(n_blocks):
            yield tuple(int(t) for t in toks[i * bs : (i + 1) * bs])

    def _matchable_blocks(self, n_tokens: int) -> int:
        """Full blocks a prompt of n_tokens may match: at least one token
        must remain for the engine to prefill (next-token logits)."""
        if n_tokens <= 1:
            return 0
        return (n_tokens - 1) // self.block_size

    def _walk(self, tokens, limit: int) -> List[_Node]:
        path = []
        node = self._root
        for key in self._block_keys(tokens, limit):
            child = node.children.get(key)
            if child is None:
                break
            path.append(child)
            node = child
        return path

    # -- lookup -----------------------------------------------------------
    def peek(self, tokens) -> int:
        """Number of cached BLOCKS a prompt would hit, with no side effects
        (no refs, no LRU touch) — admission control's charging probe."""
        n = np.asarray(tokens).reshape(-1).shape[0]
        return len(self._walk(tokens, self._matchable_blocks(n)))

    def acquire(self, tokens) -> Tuple[np.ndarray, int]:
        """Match a prompt against the trie and take one reference per
        matched block for the caller's sequence. Returns
        ``(block_ids, n_cached_tokens)``; the caller seeds the sequence's
        block table with the ids and starts prefill at token
        ``n_cached_tokens``. Matching and ref-taking are one step so a
        concurrent eviction can never free a just-matched block."""
        toks = np.asarray(tokens).reshape(-1)
        self.queries += 1
        path = self._walk(toks, self._matchable_blocks(len(toks)))
        if not path:
            return np.empty(0, np.int64), 0
        blocks = np.asarray([n.block for n in path], np.int64)
        self._alloc.share(blocks)
        now = next(self._clock)
        for n in path:
            n.last_used = now
        self.hits += 1
        self.hit_blocks += len(path)
        self.hit_tokens += len(path) * self.block_size
        return blocks, len(path) * self.block_size

    # -- insert -----------------------------------------------------------
    def insert(self, tokens, block_table) -> int:
        """Register a sequence's prefilled FULL blocks: ``tokens`` is the
        block-aligned history whose KV is written, ``block_table`` the
        owning sequence's table. Existing nodes are kept (first writer
        wins — the duplicate physical block stays private to its
        sequence); new nodes take one cache-owned reference so the KV
        outlives the sequence. Returns the number of newly cached blocks."""
        toks = np.asarray(tokens).reshape(-1)
        n_full = len(toks) // self.block_size
        n_full = min(n_full, len(block_table))
        if n_full == 0:
            return 0
        node = self._root
        added = 0
        now = next(self._clock)
        for i, key in enumerate(self._block_keys(toks, n_full)):
            child = node.children.get(key)
            if child is None:
                if self.max_cached_blocks and len(self._by_block) >= self.max_cached_blocks:
                    if not self.evict(1):
                        break  # cache full of in-use blocks: stop extending
                block = int(block_table[i])
                self._alloc.share([block])
                child = _Node(key, node, block)
                node.children[key] = child
                self._by_block[block] = child
                added += 1
            child.last_used = now
            node = child
        self.inserted_blocks += added
        return added

    # -- eviction ---------------------------------------------------------
    def _evictable_leaves(self) -> List[_Node]:
        nodes = list(self._by_block.values())
        if not nodes:
            return []
        idle = self._alloc.idle_mask([n.block for n in nodes])
        return [n for n, i in zip(nodes, idle) if i and not n.children]

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` cached blocks, LRU leaves first (a
        parent freed before its child would orphan reachable KV; once a
        leaf goes, its parent becomes the next candidate). Only blocks
        whose sole holder is the cache are touched — anything a live
        sequence shares stays. Returns the number actually freed.

        The candidate set is computed ONCE per call (vectorized idle
        mask) and maintained as a heap — parents promoted as their last
        child drops — so a mass eviction is O(E log C) instead of the
        O(E·C) rescan-per-block the host tier's spill path can't afford.
        Refcounts cannot change underneath the heap: eviction runs under
        the engine's step serialization, and dropping a victim never
        alters another candidate's holder count."""
        if not self._by_block:
            return 0
        heap = [(n.last_used, n.block) for n in self._evictable_leaves()]
        heapq.heapify(heap)
        freed = 0
        while freed < n_blocks and heap:
            _, block = heapq.heappop(heap)
            node = self._by_block.get(block)
            if node is None or node.children:
                continue  # stale heap entry
            parent = node.parent
            self._drop(node)
            freed += 1
            if (parent is not self._root and not parent.children
                    and self._alloc.refcount(parent.block) == 1):
                heapq.heappush(heap, (parent.last_used, parent.block))
        self.evictions += freed
        return freed

    def _drop(self, node: _Node) -> None:
        if self.spill_fn is not None:
            # spill BEFORE free: once the block is back on the free list a
            # later allocation may overwrite its pool rows
            self.spill_fn(node.hkey, node.block)
        del node.parent.children[node.key]
        del self._by_block[node.block]
        self._alloc.free([node.block])

    def clear(self) -> int:
        """Drop every cached block that no live sequence shares (engine
        failure recovery: device KV may be garbage). Returns count freed;
        blocks still shared by live sequences are detached from the trie
        but their sequence references stay valid."""
        dropped = 0
        for block in list(self._by_block):
            node = self._by_block.pop(block)
            self._alloc.free([block])
            dropped += 1
        self._root = _Node((), None, -1)
        return dropped

    def prefix_hashes(self) -> set:
        """Chain hashes of every cached block (device-tier half of a
        replica's PrefixDirectory advertisement)."""
        return {n.hkey for n in self._by_block.values()}

    def blocks_by_hash(self) -> Dict[bytes, int]:
        """chain hash → physical block id for every cached block — the
        peer-pull exporter's lookup (a peer asks for prefixes by hash,
        the exporter gathers pool rows by block id)."""
        return {n.hkey: n.block for n in self._by_block.values()}

    # -- reporting --------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        cached = len(self._by_block)
        idle = (int(np.count_nonzero(
            self._alloc.idle_mask(list(self._by_block))))
            if self._by_block else 0)
        return {
            "cached_blocks": cached,
            "cached_blocks_idle": idle,
            "queries": self.queries,
            "hits": self.hits,
            "hit_tokens": self.hit_tokens,
            "hit_blocks": self.hit_blocks,
            "inserted_blocks": self.inserted_blocks,
            "evictions": self.evictions,
            "hit_rate": self.hits / self.queries if self.queries else 0.0,
        }
