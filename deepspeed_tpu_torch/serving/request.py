"""Request lifecycle for the serving driver.

Reference analogue: MII's ``RaggedRequest``/``RequestStatus`` around the
FastGen engine — a serving request is not a prompt array but a state
machine (queued → prefill → decode → terminal) carrying its own sampling
parameters, stop conditions, and deadline. The driver owns every
transition; the ``Request`` object is what callers (HTTP handlers, bench
clients, tests) hold while tokens stream out.

Copy of ``deepspeed_tpu/serving/request.py``.
"""

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from deepspeed_tpu_torch.serving.spec import SpecParams


# QoS tiers, lowest number = highest priority. Admission serves the
# best (priority, arrival) pair; preemption only ever evicts a STRICTLY
# lower tier, and load shedding rejects from the bottom up.
QOS_TIERS = {"interactive": 0, "standard": 1, "batch": 2}
QOS_LOWEST = max(QOS_TIERS, key=QOS_TIERS.get)


def _validate_label_value(name: str, value: str) -> str:
    """Bound user-supplied strings that end up as metric label values.

    These arrive straight off HTTP bodies and are interpolated into the
    Prometheus text exposition and trace args; rejecting control
    characters and unbounded lengths here keeps a hostile tenant string
    from smuggling label syntax or bloating every sample line (the
    renderer additionally escapes ``\\``, ``\"`` and newlines — this is
    defense in depth, not the only line).
    """
    if not value:
        raise ValueError(f"{name} must be non-empty")
    if len(value) > 64:
        raise ValueError(f"{name} too long ({len(value)} chars, max 64)")
    if any(ord(c) < 0x20 or ord(c) == 0x7F for c in value):
        raise ValueError(f"{name} contains control characters")
    return value


class RequestState:
    """Lifecycle states (string constants — cheap to compare and to export
    as a metric label; no enum dependency in hot paths)."""

    QUEUED = "queued"        # accepted into the admission queue
    PREFILL = "prefill"      # submitted to the scheduler, prompt in flight
    DECODE = "decode"        # first token produced, decoding
    FINISHED = "finished"    # completed normally (eos / stop / max tokens)
    CANCELLED = "cancelled"  # caller cancelled
    TIMED_OUT = "timed_out"  # deadline elapsed before completion
    REJECTED = "rejected"    # never admitted (queue full / inadmissible / draining)
    FAILED = "failed"        # isolated error (stop_fn raised, engine error)

    TERMINAL = frozenset({FINISHED, CANCELLED, TIMED_OUT, REJECTED, FAILED})
    ACTIVE = frozenset({PREFILL, DECODE})


@dataclass
class SamplingParams:
    """Per-request generation knobs.

    ``temperature``/``top_k``/``top_p`` are recorded per request for the
    serving front end, but the v2 engine draws with the knobs of its
    ENGINE config (``RaggedInferenceEngineConfig``, ``set_sampling``), as
    the JAX engine's compiled sampler does: requests inherit the engine's
    sampler, and stop handling
    (eos / stop ids / stop_fn / max_new_tokens) is fully per-request.
    """

    max_new_tokens: int = 64
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token_id: Optional[int] = None  # None = use the driver's default
    ignore_eos: bool = False
    stop_token_ids: Tuple[int, ...] = ()
    # speculative decoding override: None = inherit the driver's setting;
    # SpecParams(enabled=False) opts this request out; SpecParams(k=N) caps
    # its draft length. Never changes WHAT the request generates (verify
    # rounds are bit-identical to plain decode), only how fast.
    spec: Optional[SpecParams] = None
    # QoS class (QOS_TIERS) and billing/tenant label. The tier drives
    # admission order, preemption victimhood, and shed order; the tenant
    # only labels metrics (tenant=/tier= samples in /metrics).
    qos: str = "standard"
    tenant: str = "default"
    # caller-supplied correlation id, carried into the span tracer's root
    # span args so external systems can join their traces to ours
    trace_id: Optional[str] = None

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        self.stop_token_ids = tuple(int(t) for t in self.stop_token_ids)
        if isinstance(self.spec, dict):  # JSON bodies arrive as dicts
            self.spec = SpecParams(**self.spec)
        if self.qos not in QOS_TIERS:
            raise ValueError(
                f"unknown qos {self.qos!r} (one of {sorted(QOS_TIERS)})"
            )
        self.tenant = _validate_label_value("tenant", str(self.tenant))
        if self.trace_id is not None:
            self.trace_id = _validate_label_value("trace_id", str(self.trace_id))


@dataclass
class Request:
    """One serving request: prompt + params + lifecycle + timing.

    Timing fields are ``time.monotonic()`` stamps; latency metrics
    (TTFT/TPOT/e2e) derive from their differences, so wall-clock jumps
    cannot corrupt histograms.
    """

    uid: int
    prompt_tokens: np.ndarray
    params: SamplingParams = field(default_factory=SamplingParams)
    deadline: Optional[float] = None  # monotonic stamp; None = no timeout
    # Custom stop predicate called with (request, token) after each generated
    # token; True stops the request. Exceptions inside it fail ONLY this
    # request (driver error isolation).
    stop_fn: Optional[Callable[["Request", int], bool]] = None

    state: str = RequestState.QUEUED
    finish_reason: Optional[str] = None
    error: Optional[str] = None
    generated: List[int] = field(default_factory=list)

    t_submit: float = field(default_factory=time.monotonic)
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None

    stream: Optional["TokenStream"] = None  # attached by the driver
    _done: threading.Event = field(default_factory=threading.Event, repr=False)
    # preempt-and-resume (elastic serving): times this stream was evicted
    # for a higher tier, and — while re-queued — the KV checkpoint its
    # resume imports from (a ``KVHandoff``; None when never preempted or
    # already resumed).
    preemptions: int = 0
    _checkpoint: Optional[object] = field(default=None, repr=False)
    # replica-failure recovery: times this stream was rebuilt on another
    # replica, and — when the replay route was taken — the prompt the
    # engine actually prefills (original prompt + every delivered token;
    # sampling keys are position-addressed, so the first token sampled
    # past it IS the next token of the original stream).
    recoveries: int = 0
    _replay_prompt: Optional[np.ndarray] = field(default=None, repr=False)
    # span-tracer context (observability.TraceContext) — None when tracing
    # is off or after the trace is finalized; drivers guard every trace
    # touch on ``req.trace is not None`` so the off path stays free
    trace: Optional[object] = field(default=None, repr=False)

    def __post_init__(self):
        self.prompt_tokens = np.asarray(self.prompt_tokens, np.int32).reshape(-1)

    # -- state ----------------------------------------------------------
    @property
    def priority(self) -> int:
        """Admission rank from the QoS tier (lower = served first)."""
        return QOS_TIERS[self.params.qos]

    @property
    def is_terminal(self) -> bool:
        return self.state in RequestState.TERMINAL

    @property
    def num_generated(self) -> int:
        return len(self.generated)

    @property
    def remaining_tokens(self) -> int:
        return max(0, self.params.max_new_tokens - len(self.generated))

    @property
    def engine_prompt(self) -> np.ndarray:
        """What the engine prefills for this request: the replay prompt
        while a failure recovery is in flight, the original otherwise.
        Block accounting is unchanged by replay — ``len(engine_prompt) +
        remaining_tokens == len(prompt_tokens) + max_new_tokens``."""
        if self._replay_prompt is not None:
            return self._replay_prompt
        return self.prompt_tokens

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request reaches a terminal state."""
        return self._done.wait(timeout)

    # -- latency views (None until the underlying stamps exist) ---------
    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time-per-output-token over the decode phase."""
        if self.t_first_token is None or self.t_finish is None:
            return None
        n = len(self.generated) - 1
        if n < 1:
            return None
        return (self.t_finish - self.t_first_token) / n

    @property
    def e2e_s(self) -> Optional[float]:
        if self.t_finish is None:
            return None
        return self.t_finish - self.t_submit

    # -- stop-condition evaluation (driver calls after each token) ------
    def should_stop(self, token: int, default_eos: Optional[int]) -> Optional[str]:
        """Return a finish reason if ``token`` ends this request, else None.
        ``stop_fn`` exceptions propagate to the driver, which isolates them."""
        eos = self.params.eos_token_id if self.params.eos_token_id is not None else default_eos
        if not self.params.ignore_eos and eos is not None and token == int(eos):
            return "eos"
        if token in self.params.stop_token_ids:
            return "stop_token"
        if self.stop_fn is not None and self.stop_fn(self, token):
            return "stop_fn"
        if len(self.generated) >= self.params.max_new_tokens:
            return "max_tokens"
        return None
