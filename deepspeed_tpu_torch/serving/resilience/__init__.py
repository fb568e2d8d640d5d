"""Fault injection for the serving cluster (mirrors
``deepspeed_tpu/serving/resilience``): ``faults`` is ported; health,
retry and recovery come with ROADMAP queue 1, item 5."""

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
]
