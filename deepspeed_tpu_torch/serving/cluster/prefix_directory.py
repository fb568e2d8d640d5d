"""Router-level prefix directory: which replica holds which prefix.

Copy of ``deepspeed_tpu/serving/cluster/prefix_directory.py``.

Replicas advertise the chain hashes (``host_tier.block_hash``) of every
prefix block they can seed from — device trie AND host tier — after each
worker step. At admission, the router consults the directory: if a peer
covers a strictly longer contiguous run of the request's prefix chain
than the chosen replica does, the uncovered tail is PULLED from the peer
(host-to-host payload copy, or a device export for trie-only blocks)
into the target's host tier before the request is submitted — so the
target's ``seed_from_cache`` re-imports the hot prefix instead of
re-prefilling it. This turns the trie-first handoff into a
cluster-wide prefix store: one replica prefilling a hot system prompt
makes it cheap everywhere.

Correctness: chain hashes are content addresses and KV is a pure
function of (token prefix, params), so a peer's bytes are bitwise the
bytes local prefill would produce — token streams are unchanged by
pulls (the bench/test parity gates pin this).

Thread safety: the directory itself is only touched under the router's
condition lock; advertisements are snapshots computed under the owning
core's step lock.
"""

from typing import Dict, List, Optional, Sequence, Set, Tuple

__all__ = ["PrefixDirectory"]


class PrefixDirectory:
    def __init__(self):
        self._held: Dict[str, Set[bytes]] = {}  # replica name -> hashes

    def advertise(self, name: str, hashes: Set[bytes]) -> None:
        """Replace ``name``'s advertisement with a fresh snapshot."""
        self._held[name] = set(hashes)

    def forget(self, name: str) -> None:
        self._held.pop(name, None)

    def holders(self, hkey: bytes) -> List[str]:
        return sorted(n for n, held in self._held.items() if hkey in held)

    def coverage(self, name: str, keys: Sequence[bytes]) -> int:
        """Contiguous run from the start of ``keys`` that ``name``'s last
        advertisement covers."""
        held = self._held.get(name)
        if not held:
            return 0
        n = 0
        for key in keys:
            if key not in held:
                break
            n += 1
        return n

    def best_peer(
        self, keys: Sequence[bytes], exclude: str, min_extra: int = 1
    ) -> Optional[Tuple[str, int]]:
        """The peer (not ``exclude``) covering the longest contiguous run
        of ``keys``, if that run is at least ``min_extra`` blocks. Ties
        break by name for determinism. Returns ``(name, run)`` or None."""
        best: Optional[Tuple[str, int]] = None
        for name in sorted(self._held):
            if name == exclude:
                continue
            run = self.coverage(name, keys)
            if run >= min_extra and (best is None or run > best[1]):
                best = (name, run)
        return best

    def stats(self) -> Dict[str, int]:
        return {
            "replicas": len(self._held),
            "advertised_hashes": sum(len(h) for h in self._held.values()),
        }
