"""Disaggregated prefill/decode serving (mirrors
``deepspeed_tpu/serving/cluster``).

A front-end :class:`Router` owns N engines split into prefill workers and
decode replicas. Each engine is wrapped in an :class:`EngineCore` — the
scheduling/admission loop the single-engine ``ServingDriver`` runs over
one engine. Prefill workers run chunked prefill and hand finished KV
blocks (paged block tables + int8 scale planes) to the decode replica
chosen by an SLO-aware placement policy; hot prefixes replicate through
each replica's token-block trie. Everything runs in one process: the
remote core and the replica agent (``RemoteEngineHandle``,
``ReplicaAgent``) are ROADMAP queue 1, item 5.
"""

from deepspeed_tpu_torch.serving.cluster.core import EngineCore
from deepspeed_tpu_torch.serving.cluster.handoff import (
    HandoffError,
    KVHandoff,
    export_sequence,
    import_sequence,
)
from deepspeed_tpu_torch.serving.cluster.placement import (
    PLACEMENTS,
    LeastLoadedPlacement,
    PlacementPolicy,
    RoundRobinPlacement,
    SLOPlacement,
    get_placement,
)
from deepspeed_tpu_torch.serving.cluster.router import Router

# the JAX package's cross-process names that a later slice ports
_LATER = ("ReplicaAgent", "RemoteEngineHandle")


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"deepspeed_tpu_torch.serving.cluster.{name} is not ported yet (ROADMAP "
            "queue 1, item 5: the remote core and the replica agent)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "EngineCore",
    "HandoffError",
    "KVHandoff",
    "export_sequence",
    "import_sequence",
    "PLACEMENTS",
    "PlacementPolicy",
    "SLOPlacement",
    "RoundRobinPlacement",
    "LeastLoadedPlacement",
    "get_placement",
    "Router",
]
