"""Fault tolerance for the serving stack (mirrors
``deepspeed_tpu/serving/resilience``): deterministic fault injection
(``faults``) and the replica's step-error streak (``health``). The
health state machine's probes and ``ResilienceConfig``, bounded retries
(``retry``) and request recovery (``recovery``) come with the
multi-engine router, ROADMAP queue 1, item 5."""

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
    QUARANTINED,
    ReplicaHealth,
)

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
    "ReplicaHealth",
]
