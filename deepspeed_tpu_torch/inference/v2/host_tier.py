"""Host-memory KV block tier behind the prefix trie: HBM → host → peer.

The prefix trie (prefix_cache.py) dies at HBM pool eviction — once the
refcounted allocator reclaims a block, its KV is gone and the hot prefix
must be re-prefilled. For a platform whose hot-prefix working set (system
prompts, few-shot templates, shared documents) vastly exceeds one
device's pool, that recompute is the dominant TTFT cost. This module adds
the next rung of the hierarchy: LRU-evicted idle blocks spill their
contents — the ``export_kv_blocks`` host-numpy payload, int8 codes and
fp32 scale planes verbatim — into a bounded ``HostBlockStore``, and a
trie miss that hits the store re-imports through the donated
``import_kv_blocks`` scatter instead of re-prefilling.

Identity is a content hash, not a block id: each FULL block of a
block-aligned token prefix is named by a blake2b chain hash
(``block_hash(parent_digest, block_tokens)``), so the same prefix hashes
identically on every replica and across evict/readmit cycles. The same
keys feed the router-level ``PrefixDirectory`` (serving/cluster/), which
lets a replica pull a hot prefix from a peer that already holds it rather
than recomputing — KV content is a pure function of the token prefix and
the params, so a peer's bytes are bitwise the bytes local prefill would
have produced.

Density: payloads are stored exactly as exported, so an int8 pool's host
tier holds ~1.94x the blocks per byte of a bf16 pool for free
(``kv_pool.capacity_multiplier``). Byte accounting uses the actual
payload ``nbytes`` (codes + scale planes), matching ``kv_pool``'s
per-block math.

On CPU the "pinned host" buffers are plain numpy (the export payload
representation); on TPU the same arrays are what ``jax.device_put``
consumes for the double-buffered chunked re-import
(``engine_v2.import_kv_blocks_chunked``), which hides the PCIe copy
behind the step loop exactly like the streamed-AdamW window machinery in
``runtime/zero/``.
"""

import hashlib
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional

import numpy as np

__all__ = ["block_hash", "chain_hashes", "payload_nbytes", "HostBlockStore"]

# 16-byte digests: collision-safe for any realistic prefix population and
# half the directory-advertisement footprint of full blake2b
_DIGEST_SIZE = 16


def block_hash(parent: bytes, block_tokens) -> bytes:
    """Chain hash naming the block-aligned prefix that ENDS in this block:
    blake2b over the parent prefix's digest plus this block's tokens.
    Deterministic across processes/replicas (unlike Python's salted
    ``hash``), so the same prefix names the same entry cluster-wide."""
    h = hashlib.blake2b(parent, digest_size=_DIGEST_SIZE)
    h.update(np.asarray(block_tokens, dtype=np.int64).tobytes())
    return h.digest()


def chain_hashes(tokens, block_size: int, n_blocks: Optional[int] = None) -> List[bytes]:
    """Chain hashes for the first ``n_blocks`` FULL blocks of ``tokens``
    (default: every full block). ``out[i]`` names the prefix
    ``tokens[: (i + 1) * block_size]``."""
    toks = np.asarray(tokens).reshape(-1)
    if n_blocks is None:
        n_blocks = len(toks) // block_size
    out: List[bytes] = []
    parent = b""
    for i in range(n_blocks):
        parent = block_hash(parent, toks[i * block_size : (i + 1) * block_size])
        out.append(parent)
    return out


def payload_nbytes(payload: Dict[str, np.ndarray]) -> int:
    """Actual host bytes of a block payload (codes + any scale planes)."""
    return int(sum(int(p.nbytes) for p in payload.values()))


class HostBlockStore:
    """Bounded host-memory LRU of single-block KV payloads.

    Entries are ``{plane_name: ndarray}`` dicts shaped like one block
    column of an ``export_kv_blocks`` payload (``[n_layers, block_size,
    kv_heads(, head_dim)]``), keyed by the block's prefix chain hash.
    The byte budget counts actual payload nbytes, so an int8 pool's tier
    is ~2x denser than bf16 under the same ``--kv-host-tier-bytes``.

    Thread-safety: mutated only under the owning engine's step lock (the
    spill site is trie eviction inside ``extend``; the readmit site is
    ``seed_from_cache`` — both run while the caller serializes against
    stepping), so no internal lock is needed.
    """

    def __init__(self, budget_bytes: int, validate=None):
        if budget_bytes <= 0:
            raise ValueError(
                f"HostBlockStore budget_bytes must be > 0, got {budget_bytes}"
            )
        self.budget_bytes = int(budget_bytes)
        # optional per-entry contract check (kv_pool.check_kv_payload via
        # the owning engine): router peer pulls inject entries from the
        # wire, so a malformed plane must fail HERE, not at readmit time
        self._validate = validate
        self._entries: "OrderedDict[bytes, Dict[str, np.ndarray]]" = OrderedDict()
        self._nbytes: Dict[bytes, int] = {}
        self.bytes_used = 0
        # counters surfaced through stats() -> serving metrics
        self.hits = 0
        self.misses = 0
        self.spills = 0
        self.readmits = 0
        self.evictions = 0
        self.peer_pulled = 0

    # -- container protocol ------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: bytes) -> bool:
        return key in self._entries

    def keys(self) -> Iterable[bytes]:
        """Snapshot of resident chain hashes (directory advertisement)."""
        return list(self._entries)

    # -- write -------------------------------------------------------------
    def put(self, key: bytes, payload: Dict[str, np.ndarray],
            peer_pull: bool = False) -> bool:
        """Store (or refresh) one block payload, evicting LRU entries to
        stay under the byte budget. Returns False — and stores nothing —
        only when the single payload alone exceeds the whole budget.
        ``peer_pull`` marks entries injected by the router's directory
        pull rather than a local eviction spill (counter attribution)."""
        if self._validate is not None:
            self._validate(payload)
        nb = payload_nbytes(payload)
        if nb > self.budget_bytes:
            return False
        old = self._nbytes.pop(key, None)
        if old is not None:
            self.bytes_used -= old
            del self._entries[key]
        while self.bytes_used + nb > self.budget_bytes and self._entries:
            drop_key, _ = self._entries.popitem(last=False)
            self.bytes_used -= self._nbytes.pop(drop_key)
            self.evictions += 1
        self._entries[key] = payload
        self._nbytes[key] = nb
        self.bytes_used += nb
        if peer_pull:
            self.peer_pulled += 1
        else:
            self.spills += 1
        return True

    # -- read --------------------------------------------------------------
    def get(self, key: bytes) -> Optional[Dict[str, np.ndarray]]:
        """Fetch one payload and touch its LRU position; None on miss."""
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry

    def peek(self, key: bytes) -> Optional[Dict[str, np.ndarray]]:
        """Fetch without counters or LRU touch — the peer-pull exporter's
        read (a peer copying a block out must not look like local demand
        or perturb local eviction order)."""
        return self._entries.get(key)

    def match(self, keys: List[bytes], start: int = 0) -> int:
        """Length of the contiguous resident run of ``keys[start:]`` —
        the block count a readmit could cover. Pure probe: no counters,
        no LRU touch (admission/placement charging must not perturb
        eviction order)."""
        n = 0
        for key in keys[start:]:
            if key not in self._entries:
                break
            n += 1
        return n

    def discard(self, key: bytes) -> None:
        if key in self._entries:
            del self._entries[key]
            self.bytes_used -= self._nbytes.pop(key)

    # -- reporting ---------------------------------------------------------
    def note_readmits(self, n_blocks: int) -> None:
        """Credit ``n_blocks`` successfully re-imported into the device
        pool (called by the engine after the chunked scatter lands)."""
        self.readmits += int(n_blocks)

    def stats(self) -> Dict[str, float]:
        return {
            "bytes": self.bytes_used,
            "blocks": len(self._entries),
            "budget_bytes": self.budget_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "spills": self.spills,
            "readmits": self.readmits,
            "evictions": self.evictions,
            "peer_pulled": self.peer_pulled,
        }
