"""Request tracing, Perfetto export, and the control-plane event log.

This package is dependency-free (stdlib only).  The tracer is a global
singleton selected by :func:`configure_tracing`; when tracing is off the
singleton is a :class:`NullTracer` whose methods all return one shared
no-op span, so the disabled path costs an attribute check and zero
allocations per call.

Copy of ``deepspeed_tpu/observability``; the port's engine writes the
same spans (``engine.dispatch``, ``engine.device_wait``,
``host_tier.spill``, ``host_tier.readmit``).
"""

from deepspeed_tpu_torch.observability.events import (
    Event,
    EventLog,
    get_event_log,
    log_event,
)
from deepspeed_tpu_torch.observability.export import (
    to_chrome_trace,
    trace_to_chrome,
    validate_chrome_trace,
    write_trace,
)
from deepspeed_tpu_torch.observability.tracing import (
    NULL_TRACER,
    NullTracer,
    Span,
    SpanTracer,
    TraceContext,
    begin_request_trace,
    configure_tracing,
    finish_request_trace,
    get_tracer,
    mark_admitted,
    mark_first_token,
    mark_preempted,
    mark_resumed,
    set_tracer,
)

__all__ = [
    "Event",
    "EventLog",
    "NULL_TRACER",
    "NullTracer",
    "Span",
    "SpanTracer",
    "TraceContext",
    "begin_request_trace",
    "configure_tracing",
    "finish_request_trace",
    "get_event_log",
    "get_tracer",
    "log_event",
    "mark_admitted",
    "mark_first_token",
    "mark_preempted",
    "mark_resumed",
    "set_tracer",
    "to_chrome_trace",
    "trace_to_chrome",
    "validate_chrome_trace",
    "write_trace",
]
