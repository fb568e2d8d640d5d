"""The serving stack of the port (mirrors ``deepspeed_tpu/serving``).

The single-replica path is ported: a background driver loop over one
``InferenceEngineV2``, with its HTTP front end, streaming and telemetry.

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
  * ``cluster``    — ``EngineCore``, the engine-facing half of the loop
  * ``resilience`` — fault injection and the replica health state machine

The multi-engine ``Router`` with its KV handoff and placement, the network
transports, the remote agent and the elastic control plane are ROADMAP
queue 1, item 5: their names raise ``NotImplementedError`` saying so.
"""

from deepspeed_tpu_torch.serving.cluster import EngineCore
from deepspeed_tpu_torch.serving.driver import RequestRejected, ServingDriver
from deepspeed_tpu_torch.serving.metrics import ServingMetrics
from deepspeed_tpu_torch.serving.request import Request, RequestState, SamplingParams
from deepspeed_tpu_torch.serving.spec import (
    AdaptiveSpecController,
    DraftProposer,
    NgramProposer,
    SpecParams,
)
from deepspeed_tpu_torch.serving.streaming import IncrementalDetokenizer, TokenStream

# the JAX package's serving names that later slices port
_LATER = (
    "Router", "KVHandoff", "HandoffError", "get_placement",
    "DegradationLadder", "ElasticController", "ElasticServingConfig", "WarmSparePool",
)


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"deepspeed_tpu_torch.serving.{name} is not ported yet (ROADMAP queue 1, item 5: "
            "the multi-engine router and the elastic control plane)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AdaptiveSpecController",
    "DraftProposer",
    "EngineCore",
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
