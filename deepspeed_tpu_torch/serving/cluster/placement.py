"""SLO-aware placement: which decode replica gets the next request.

Copy of ``deepspeed_tpu/serving/cluster/placement.py``.

Placement cannot affect outputs — token streams are content-addressed by
(seed, uid, position), identical on every replica — so the policy is a
pure throughput/latency knob. All policies only consider replicas whose
per-replica free-block count (minus the router's in-flight handoff
reservations) admits the request's FULL token budget; they differ in how
they rank the admissible set.
"""

import time
from typing import List, Optional

from deepspeed_tpu_torch.serving.cluster.core import EngineCore


class PlacementPolicy:
    name = "base"

    def admissible(self, core: EngineCore, req, router) -> bool:
        reserved_blocks, reserved_seqs = router.reserved_for_locked(core)
        return core.admissible(
            req, reserved_blocks=reserved_blocks, reserved_seqs=reserved_seqs
        )

    def choose(self, cores: List[EngineCore], req, router) -> Optional[EngineCore]:
        raise NotImplementedError


class SLOPlacement(PlacementPolicy):
    """Rank replicas by free-block headroom AFTER placement, discounted by
    load (resident + reserved sequences vs the tracked-sequence cap); a
    deadline-tight request weights load more — deep queues cost it TTFT it
    cannot afford, so it prefers the emptier replica even at slightly
    worse headroom. With a prefix directory live, a replica that already
    holds a longer run of the request's prefix chain (device trie or host
    tier) earns an affinity bonus: seeding from resident blocks beats
    recomputing them, and beats pulling them from a peer.

    Tensor-parallel replicas: a tp=N decode replica spreads each step's
    attention/MLP across N devices, so the same resident depth costs
    roughly 1/N the per-step latency pressure of an unsharded replica —
    the load term is divided by ``tp_shards()``. Headroom needs no
    correction (``kv_total`` already counts logical blocks of the whole
    sharded pool), so a tp=2 replica competes on depth-per-device, not
    raw depth."""

    name = "slo"
    # affinity weight: full prefix coverage is worth a quarter of the
    # whole pool's headroom — enough to break near-ties toward the
    # replica that skips the prefill, never enough to pile every hot
    # request onto one overloaded replica
    prefix_affinity = 0.25

    def choose(self, cores, req, router):
        best, best_score = None, None
        now = time.monotonic()
        directory = getattr(router, "directory", None)
        keys = []
        if directory is not None and cores:
            keys = cores[0].prefix_chain(req.prompt_tokens)
        for core in cores:
            if not self.admissible(core, req, router):
                continue
            reserved_blocks, reserved_seqs = router.reserved_for_locked(core)
            free = core.free_blocks() - reserved_blocks
            total = max(1, core.kv_total)
            headroom = (free - core.blocks_needed(req)) / total
            depth = len(core.requests) + reserved_seqs
            max_tracked = int(core._sm_cfg("max_tracked_sequences", 0) or 0)
            load = depth / max_tracked if max_tracked else depth * 1.0
            load /= max(1, core.tp_shards())
            urgency = 0.0
            if req.deadline is not None:
                slack = max(0.0, req.deadline - now)
                urgency = 1.0 / (1.0 + slack)
            score = headroom - load * (1.0 + urgency)
            if keys:
                covered = directory.coverage(core.name, keys)
                score += self.prefix_affinity * (covered / len(keys))
            # strict > keeps ties deterministic: first (lowest-index) wins
            if best_score is None or score > best_score:
                best, best_score = core, score
        return best


class RoundRobinPlacement(PlacementPolicy):
    """Cycle through replicas, skipping inadmissible ones."""

    name = "round_robin"

    def __init__(self):
        self._cursor = 0

    def choose(self, cores, req, router):
        n = len(cores)
        for i in range(n):
            core = cores[(self._cursor + i) % n]
            if self.admissible(core, req, router):
                self._cursor = (self._cursor + i + 1) % n
                return core
        return None


class LeastLoadedPlacement(PlacementPolicy):
    """Fewest resident+reserved sequences wins; free blocks break ties."""

    name = "least_loaded"

    def choose(self, cores, req, router):
        best, best_key = None, None
        for core in cores:
            if not self.admissible(core, req, router):
                continue
            reserved_blocks, reserved_seqs = router.reserved_for_locked(core)
            key = (len(core.requests) + reserved_seqs,
                   -(core.free_blocks() - reserved_blocks))
            if best_key is None or key < best_key:
                best, best_key = core, key
        return best


PLACEMENTS = {
    "slo": SLOPlacement,
    "round_robin": RoundRobinPlacement,
    "least_loaded": LeastLoadedPlacement,
}


def get_placement(name: str) -> PlacementPolicy:
    try:
        return PLACEMENTS[name]()
    except KeyError:
        raise ValueError(
            f"unknown placement policy {name!r} (choices: {sorted(PLACEMENTS)})"
        ) from None
