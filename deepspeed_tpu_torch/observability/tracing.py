"""Monotonic-clock span tracer with per-request trees and a global ring.

Span model
----------

A :class:`Span` is a ``[t0, t1)`` interval on ``time.monotonic()`` with a
``span_id``/``parent_id`` pair, a ``track`` (timeline row: engine name or
``"request:<uid>"``), and an open ``args`` dict for payload (batch sizes,
drained-token counts, block counts, ...).

Spans live in one of two places:

* **request trees** — keyed by request uid; a single rooted tree covering
  queued -> admission/placement -> prefill -> handoff -> decode rounds ->
  finish (plus preempt/resume phases when the elastic planner fires).
  Trees move to a bounded completed-trace ring at ``end_trace``, subject
  to the capture policy (``all`` | ``slow``).
* **the engine ring** — spans with no request key (engine step rounds,
  dispatch vs device-wait brackets, host-tier readmits) in one bounded
  ``deque``; these render as per-engine timeline rows in the export.

Thread safety: one lock guards id allocation and every container
mutation; ``end()`` only stores into an already-published span and needs
no lock.

Disabled path: :data:`NULL_TRACER` is installed by default.  Every method
returns the shared :data:`_NULL_SPAN` singleton (its own no-op context
manager), so ``with get_tracer().span(...):`` costs no allocation when
tracing is off — callers only guard *args construction* behind
``tracer.enabled``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = [
    "NULL_TRACER",
    "NullTracer",
    "Span",
    "SpanTracer",
    "TraceContext",
    "begin_request_trace",
    "configure_tracing",
    "finish_request_trace",
    "get_tracer",
    "mark_admitted",
    "mark_first_token",
    "mark_preempted",
    "mark_resumed",
    "set_tracer",
]


class Span:
    """One timed interval.  ``t1 is None`` while the span is open."""

    __slots__ = ("span_id", "parent_id", "name", "track", "t0", "t1", "args")

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 track: str, t0: float, args: Optional[dict] = None):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.track = track
        self.t0 = t0
        self.t1: Optional[float] = None
        self.args = args

    @property
    def duration_s(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def to_dict(self) -> dict:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "track": self.track,
            "t0": self.t0,
            "t1": self.t1,
            "args": dict(self.args) if self.args else {},
        }

    def __repr__(self):  # pragma: no cover - debug aid
        dur = self.duration_s
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, "
                f"dur={'open' if dur is None else f'{dur * 1e3:.3f}ms'})")


class _SpanHandle:
    """Context manager returned by ``SpanTracer.span``."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "SpanTracer", span: Span):
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, exc_type, exc, tb):
        self._tracer.end(self.span)
        return False


class _NullSpan:
    """Shared do-nothing span: its own context manager, ends are no-ops."""

    __slots__ = ()

    span_id = -1
    parent_id = None
    name = ""
    track = ""
    t0 = 0.0
    t1 = 0.0
    args = None
    span = None  # mirror _SpanHandle.span for uniform `with ... as sp:` use
    duration_s = 0.0

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()
# `with null.span(...) as sp:` must hand back the same singleton
_NullSpan.span = _NULL_SPAN


class NullTracer:
    """Tracing-off singleton: every method is a constant-return no-op."""

    enabled = False

    def now(self) -> float:
        return 0.0

    def begin_trace(self, key, name, t0=None, args=None):
        return _NULL_SPAN

    def start(self, key, name, parent=None, t0=None, track=None, args=None):
        return _NULL_SPAN

    def end(self, span, t1=None, args=None):
        pass

    def complete(self, name, t0, t1=None, key=None, parent=None, track=None,
                 args=None):
        return _NULL_SPAN

    def instant(self, name, key=None, track=None, t=None, args=None):
        return _NULL_SPAN

    def span(self, name, key=None, parent=None, track=None, args=None):
        return _NULL_SPAN

    def end_trace(self, key, slow_hint=False, meta=None):
        return False

    def trace(self, key):
        return None

    def recent(self):
        return []

    def ring_spans(self):
        return []

    def stats(self):
        return {"enabled": False}


NULL_TRACER = NullTracer()


class SpanTracer:
    """Thread-safe bounded span tracer (see module docstring)."""

    enabled = True

    #: reservoir size for the slow-capture latency percentile
    RESERVOIR = 256
    #: keep everything until the reservoir has this many samples
    WARMUP = 32

    def __init__(self, max_events: int = 65536, capture: str = "all",
                 slow_quantile: float = 0.90):
        if capture not in ("all", "slow"):
            raise ValueError(f"capture must be 'all' or 'slow', got {capture!r}")
        if max_events < 256:
            max_events = 256
        self.max_events = int(max_events)
        self.capture = capture
        self.slow_quantile = float(slow_quantile)
        self._lock = threading.Lock()
        self._next_id = 1
        # uid -> list[Span]; first span is the root
        self._active: Dict[Any, List[Span]] = {}
        # completed request traces: list of dicts, bounded by total span budget
        self._done: deque = deque()
        self._done_events = 0
        # global engine/control spans (no request key)
        self._ring: deque = deque(maxlen=self.max_events)
        self._e2e_samples: deque = deque(maxlen=self.RESERVOIR)
        self.dropped_traces = 0
        self.dropped_spans = 0

    # ---- clock ----------------------------------------------------------

    def now(self) -> float:
        return time.monotonic()

    # ---- span lifecycle -------------------------------------------------

    def begin_trace(self, key, name: str, t0: Optional[float] = None,
                    args: Optional[dict] = None) -> Span:
        """Open a new request tree rooted at ``name``.

        Re-beginning an existing key discards the stale tree (a uid can
        only be live once; stale trees would otherwise leak forever).
        """
        t0 = self.now() if t0 is None else t0
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            root = Span(sid, None, name, f"request:{key}", t0, args)
            self._active[key] = [root]
        return root

    def start(self, key, name: str, parent: Optional[Span] = None,
              t0: Optional[float] = None, track: Optional[str] = None,
              args: Optional[dict] = None) -> Span:
        """Open a span.  ``key=None`` targets the global engine ring."""
        t0 = self.now() if t0 is None else t0
        pid = parent.span_id if parent is not None else None
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            if key is not None:
                tree = self._active.get(key)
                if tree is None:
                    # late span for an unknown/finished request: drop
                    self.dropped_spans += 1
                    return Span(sid, pid, name, track or f"request:{key}",
                                t0, args)
                if pid is None:
                    pid = tree[0].span_id
                sp = Span(sid, pid, name, track or tree[0].track, t0, args)
                if len(tree) < self.max_events:
                    tree.append(sp)
                else:
                    self.dropped_spans += 1
                return sp
            sp = Span(sid, pid, name, track or "engine", t0, args)
            self._ring.append(sp)
            return sp

    def end(self, span: Span, t1: Optional[float] = None,
            args: Optional[dict] = None) -> Span:
        span.t1 = self.now() if t1 is None else t1
        if args:
            if span.args is None:
                span.args = dict(args)
            else:
                span.args.update(args)
        return span

    def complete(self, name: str, t0: float, t1: Optional[float] = None,
                 key=None, parent: Optional[Span] = None,
                 track: Optional[str] = None,
                 args: Optional[dict] = None) -> Span:
        """Record an already-timed ``[t0, t1]`` span in one call."""
        sp = self.start(key, name, parent=parent, t0=t0, track=track, args=args)
        sp.t1 = self.now() if t1 is None else t1
        return sp

    def instant(self, name: str, key=None, track: Optional[str] = None,
                t: Optional[float] = None, args: Optional[dict] = None) -> Span:
        """Zero-duration marker (renders as a Perfetto instant event)."""
        t = self.now() if t is None else t
        sp = self.start(key, name, t0=t, track=track, args=args)
        sp.t1 = t
        return sp

    def span(self, name: str, key=None, parent: Optional[Span] = None,
             track: Optional[str] = None,
             args: Optional[dict] = None) -> _SpanHandle:
        """``with tracer.span("round.fused", args={...}) as sp:``"""
        return _SpanHandle(self, self.start(key, name, parent=parent,
                                            track=track, args=args))

    # ---- trace completion / retention ----------------------------------

    def end_trace(self, key, slow_hint: bool = False,
                  meta: Optional[dict] = None) -> bool:
        """Close a request tree; returns True iff the tree was retained."""
        with self._lock:
            tree = self._active.pop(key, None)
            if tree is None:
                return False
            root = tree[0]
            e2e = None if root.t1 is None else root.t1 - root.t0
            keep = self._should_keep_locked(e2e, slow_hint)
            if e2e is not None:
                self._e2e_samples.append(e2e)
            if not keep:
                self.dropped_traces += 1
                return False
            self._done.append({
                "key": key,
                "root": root.name,
                "e2e_s": e2e,
                "slow": bool(slow_hint),
                "meta": dict(meta) if meta else {},
                "spans": tree,
            })
            self._done_events += len(tree)
            while self._done_events > self.max_events and len(self._done) > 1:
                old = self._done.popleft()
                self._done_events -= len(old["spans"])
                self.dropped_traces += 1
            return True

    def _should_keep_locked(self, e2e: Optional[float], slow_hint: bool) -> bool:
        if self.capture == "all" or slow_hint:
            return True
        if len(self._e2e_samples) < self.WARMUP:
            return True  # warmup: no stable percentile yet
        if e2e is None:
            return True  # never finished cleanly — that IS interesting
        ordered = sorted(self._e2e_samples)
        idx = min(len(ordered) - 1,
                  int(self.slow_quantile * (len(ordered) - 1)))
        return e2e >= ordered[idx]

    # ---- read side ------------------------------------------------------

    def trace(self, key) -> Optional[dict]:
        """A single request tree (completed preferred, else in-flight)."""
        with self._lock:
            for rec in reversed(self._done):
                if rec["key"] == key:
                    return {**rec, "spans": list(rec["spans"]),
                            "complete": True}
            tree = self._active.get(key)
            if tree is not None:
                root = tree[0]
                return {"key": key, "root": root.name, "e2e_s": None,
                        "slow": False, "meta": {}, "spans": list(tree),
                        "complete": False}
        return None

    def traces(self) -> List[dict]:
        """All retained completed traces, oldest first (spans included)."""
        with self._lock:
            return [{**rec, "spans": list(rec["spans"]), "complete": True}
                    for rec in self._done]

    def recent(self) -> List[dict]:
        """Span-free summaries of retained traces, newest first."""
        with self._lock:
            return [{"key": rec["key"], "root": rec["root"],
                     "e2e_s": rec["e2e_s"], "slow": rec["slow"],
                     "meta": dict(rec["meta"]), "spans": len(rec["spans"])}
                    for rec in reversed(self._done)]

    def active_keys(self) -> List[Any]:
        with self._lock:
            return list(self._active.keys())

    def ring_spans(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "capture": self.capture,
                "max_events": self.max_events,
                "active_traces": len(self._active),
                "completed_traces": len(self._done),
                "completed_spans": self._done_events,
                "ring_spans": len(self._ring),
                "dropped_traces": self.dropped_traces,
                "dropped_spans": self.dropped_spans,
            }


# ---- module-level singleton --------------------------------------------

_TRACER: Any = NULL_TRACER


def get_tracer():
    return _TRACER


def set_tracer(tracer):
    global _TRACER
    _TRACER = tracer
    return tracer


def configure_tracing(enabled: bool = True, max_events: int = 65536,
                      capture: str = "all"):
    """Install the global tracer (SpanTracer when enabled, else the null)."""
    if enabled:
        return set_tracer(SpanTracer(max_events=max_events, capture=capture))
    return set_tracer(NULL_TRACER)


# ---- per-request trace context -----------------------------------------


class TraceContext:
    """Carried on ``Request.trace``: the root span plus the current
    lifecycle *phase* span (queued | prefill | decode | preempted), so
    round/handoff spans can parent onto the phase they occurred in."""

    __slots__ = ("uid", "tracer", "root", "phase", "t_first")

    def __init__(self, uid, tracer, root: Span, phase: Span):
        self.uid = uid
        self.tracer = tracer
        self.root = root
        self.phase = phase
        # first-token stamp, recorded at the prefill->decode switch so the
        # ServingMetrics.observe_trace bridge reads latencies off the SPAN
        # endpoints rather than re-deriving them from the Request
        self.t_first: Optional[float] = None

    def _switch_phase(self, name: str, t: Optional[float] = None,
                      args: Optional[dict] = None) -> Span:
        tr = self.tracer
        t = tr.now() if t is None else t
        tr.end(self.phase, t1=t, args=args)
        self.phase = tr.start(self.uid, name, parent=self.root, t0=t)
        return self.phase


def begin_request_trace(tracer, req, extra: Optional[dict] = None):
    """Root a new trace at ``req.t_submit`` and attach it to the request."""
    if not tracer.enabled:
        return None
    p = req.params
    args = {
        "uid": req.uid,
        "tenant": p.tenant,
        "qos": p.qos,
        "prompt_tokens": len(req.prompt_tokens),
        "max_new_tokens": p.max_new_tokens,
    }
    if getattr(p, "trace_id", None):
        args["trace_id"] = p.trace_id
    if extra:
        args.update(extra)
    root = tracer.begin_trace(req.uid, "request", t0=req.t_submit, args=args)
    phase = tracer.start(req.uid, "queued", parent=root, t0=req.t_submit)
    ctx = TraceContext(req.uid, tracer, root, phase)
    req.trace = ctx
    return ctx


def mark_admitted(req, core: Optional[str] = None):
    """queued -> prefill, stamped at ``req.t_admitted``."""
    ctx = req.trace
    if ctx is None:
        return
    args = {"core": core} if core else None
    ctx._switch_phase("prefill", t=req.t_admitted, args=args)


def mark_first_token(req):
    """prefill -> decode, stamped at ``req.t_first_token``."""
    ctx = req.trace
    if ctx is None:
        return
    ctx.t_first = req.t_first_token
    ctx._switch_phase("decode", t=req.t_first_token)


def mark_preempted(req, reason: str = "preempted"):
    """decode -> preempted (elastic planner took the replica)."""
    ctx = req.trace
    if ctx is None:
        return
    ctx._switch_phase("preempted", args={"reason": reason})


def mark_resumed(req, core: Optional[str] = None):
    """preempted -> decode on the resuming replica."""
    ctx = req.trace
    if ctx is None:
        return
    args = {"core": core} if core else None
    ctx._switch_phase("decode", args=args)


def finish_request_trace(req, reason: Optional[str] = None):
    """Close phase + root at ``req.t_finish`` and run retention policy."""
    ctx = req.trace
    if ctx is None:
        return False
    tr = ctx.tracer
    t = req.t_finish if req.t_finish is not None else tr.now()
    tr.end(ctx.phase, t1=t)
    reason = reason or getattr(req, "finish_reason", None) or "unknown"
    tr.end(ctx.root, t1=t, args={
        "finish_reason": reason,
        "tokens": len(req.generated),
        "preemptions": getattr(req, "preemptions", 0),
    })
    slow_hint = (reason not in ("stop", "max_tokens", "eos")
                 or getattr(req, "preemptions", 0) > 0)
    meta = {"finish_reason": reason, "tenant": req.params.tenant,
            "qos": req.params.qos, "tokens": len(req.generated)}
    kept = tr.end_trace(req.uid, slow_hint=slow_hint, meta=meta)
    req.trace = None
    return kept
