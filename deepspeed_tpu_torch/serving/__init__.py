"""The serving stack of the port (mirrors ``deepspeed_tpu/serving``).

  * ``request``    — ``Request`` lifecycle + per-request ``SamplingParams``
  * ``driver``     — background continuous-batching loop with KV-aware
                     admission control, timeouts, error isolation, drain
  * ``streaming``  — per-request token iterators + incremental detokenization
  * ``metrics``    — TTFT/TPOT/e2e histograms, queue/KV gauges, Prometheus
                     text exposition, Monitor-writer bridge
  * ``server``     — stdlib-only HTTP front end (/generate, /health, /metrics,
                     /debug/trace, /debug/events)
  * ``spec``       — speculative decoding: the n-gram proposer and the
                     adaptive draft length over the engine's verify rounds
  * ``cluster``    — disaggregated prefill/decode serving: the
                     multi-engine ``Router`` with KV-block handoff,
                     SLO-aware placement and the prefix directory; decode
                     replicas in other processes (``ReplicaAgent``)
  * ``net``        — the cross-process KV wire and control plane
  * ``resilience`` — fault injection, the replica health state machine,
                     bounded retries and bit-identical request recovery
  * ``elastic``    — autoscaling decode replicas from warm spares, QoS
                     preempt-and-resume, graceful load shedding
"""

from deepspeed_tpu_torch.serving.cluster import (
    EngineCore,
    HandoffError,
    KVHandoff,
    Router,
    get_placement,
)
from deepspeed_tpu_torch.serving.driver import RequestRejected, ServingDriver
from deepspeed_tpu_torch.serving.elastic import (
    DegradationLadder,
    ElasticController,
    ElasticServingConfig,
    WarmSparePool,
)
from deepspeed_tpu_torch.serving.metrics import ServingMetrics
from deepspeed_tpu_torch.serving.request import Request, RequestState, SamplingParams
from deepspeed_tpu_torch.serving.spec import (
    AdaptiveSpecController,
    DraftProposer,
    NgramProposer,
    SpecParams,
)
from deepspeed_tpu_torch.serving.streaming import IncrementalDetokenizer, TokenStream


__all__ = [
    "AdaptiveSpecController",
    "DegradationLadder",
    "DraftProposer",
    "ElasticController",
    "ElasticServingConfig",
    "EngineCore",
    "WarmSparePool",
    "HandoffError",
    "KVHandoff",
    "Router",
    "get_placement",
    "IncrementalDetokenizer",
    "NgramProposer",
    "Request",
    "RequestRejected",
    "RequestState",
    "SamplingParams",
    "ServingDriver",
    "ServingMetrics",
    "SpecParams",
    "TokenStream",
]
