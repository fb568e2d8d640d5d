"""Disaggregated prefill/decode serving (mirrors
``deepspeed_tpu/serving/cluster``).

A front-end :class:`Router` owns N engines split into prefill workers and
decode replicas. Each engine is wrapped in an :class:`EngineCore` — the
scheduling/admission loop the single-engine ``ServingDriver`` runs over
one engine. Prefill workers run chunked prefill and hand finished KV
blocks (paged block tables + int8 scale planes) to the decode replica
chosen by an SLO-aware placement policy; hot prefixes replicate through
each replica's token-block trie. A decode replica may run in another
process: a :class:`ReplicaAgent` there joins the router's control plane,
which holds it as a :class:`RemoteEngineHandle`.
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
from deepspeed_tpu_torch.serving.cluster.agent import ReplicaAgent
from deepspeed_tpu_torch.serving.cluster.remote_core import RemoteEngineHandle

__all__ = [
    "ReplicaAgent",
    "RemoteEngineHandle",
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
