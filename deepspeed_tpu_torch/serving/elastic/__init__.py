"""Elastic serving control plane (copy of ``deepspeed_tpu/serving/elastic``).

Grows the cluster ``Router`` from a static placer into a manager of a
changing fleet — the serving-side activation of the reference project's
``elasticity/`` ambition. Four pillars:

  * ``config``     — ``ElasticServingConfig`` (replica bounds, control-loop
                     cadence, shed thresholds) with loud validation, plus
                     the bridge from the training-side ``ElasticityConfig``
  * ``controller`` — the ControlLoop thread: samples per-replica queue
                     depth / deadline-slack trends from ``replica_stats``
                     and scales decode replicas between min/max
  * ``spares``     — warm standby engines whose kernels are built or
                     loaded at spawn, so scale-up cost is admission-time,
                     not build-time (pinned by ``assert_no_new_traces``)
  * ``preemption`` — QoS preempt-and-requeue: a victim stream's KV blocks
                     export through the host-tier spill path, the request
                     re-enters the queue, and resume re-imports via the
                     chunked scatter + ``scheduler.adopt()`` — resumed
                     streams are bit-identical to never-preempted ones
  * ``shedding``   — the graceful-degradation ladder (cap max_new_tokens →
                     disable spec → reject the lowest tier with
                     Retry-After), so overload degrades before it rejects
"""

from deepspeed_tpu_torch.serving.elastic.config import ElasticServingConfig
from deepspeed_tpu_torch.serving.elastic.controller import (
    ElasticController,
    ScalingSignals,
    plan_scaling,
)
from deepspeed_tpu_torch.serving.elastic.preemption import (
    PreemptionError,
    preempt_sequence,
    preemptible,
    resume_sequence,
)
from deepspeed_tpu_torch.serving.elastic.shedding import DegradationLadder, ShedDecision
from deepspeed_tpu_torch.serving.elastic.spares import (
    WarmSparePool,
    assert_no_new_traces,
    trace_signature,
)

__all__ = [
    "DegradationLadder",
    "ElasticController",
    "ElasticServingConfig",
    "PreemptionError",
    "ScalingSignals",
    "ShedDecision",
    "WarmSparePool",
    "assert_no_new_traces",
    "plan_scaling",
    "preempt_sequence",
    "preemptible",
    "resume_sequence",
    "trace_signature",
]
