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
  * ``cluster``    — disaggregated prefill/decode serving: the in-process
                     multi-engine ``Router`` with KV-block handoff,
                     SLO-aware placement and the prefix directory
  * ``resilience`` — fault injection, the replica health state machine,
                     bounded retries and bit-identical request recovery
  * ``elastic``    — autoscaling decode replicas from warm spares, QoS
                     preempt-and-resume, graceful load shedding

The cross-process pieces — the network transports, the remote core and the
replica agent — are ROADMAP queue 1, item 5: their names raise
``NotImplementedError`` saying so.
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

# the JAX package's cross-process serving names that a later slice ports
_LATER = ("ReplicaAgent", "RemoteEngineHandle")


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"deepspeed_tpu_torch.serving.{name} is not ported yet (ROADMAP queue 1, item 5: "
            "the remote core and the replica agent)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
