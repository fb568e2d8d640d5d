"""Fault tolerance for the serving cluster (mirrors
``deepspeed_tpu/serving/resilience``): deterministic fault injection
(``faults``), the replica health state machine (``health``), bounded
retry-with-backoff (``retry``), and bit-identical request recovery
(``recovery``)."""

from deepspeed_tpu_torch.serving.resilience.faults import (
    SITES,
    FaultInjector,
    FaultSpec,
    InjectedFault,
    NullFaultInjector,
    get_fault_injector,
    inject,
    seeded_schedule,
    set_fault_injector,
)
from deepspeed_tpu_torch.serving.resilience.health import (
    DEGRADED,
    HEALTHY,
    PROBATION,
    QUARANTINED,
    ReplicaHealth,
    ResilienceConfig,
)
from deepspeed_tpu_torch.serving.resilience.recovery import plan_recovery, replay_prompt
from deepspeed_tpu_torch.serving.resilience.retry import RetryPolicy, with_retries

__all__ = [
    "SITES",
    "FaultInjector",
    "FaultSpec",
    "InjectedFault",
    "NullFaultInjector",
    "get_fault_injector",
    "inject",
    "seeded_schedule",
    "set_fault_injector",
    "HEALTHY",
    "DEGRADED",
    "QUARANTINED",
    "PROBATION",
    "ReplicaHealth",
    "ResilienceConfig",
    "RetryPolicy",
    "with_retries",
    "plan_recovery",
    "replay_prompt",
]
