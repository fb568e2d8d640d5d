"""Chrome-trace / Perfetto JSON export for spans and control events.

The output is the Trace Event Format that ``chrome://tracing`` and
https://ui.perfetto.dev both open: ``{"traceEvents": [...],
"displayTimeUnit": "ms"}`` with complete ("X") events in microseconds.

Track layout:

* pid 1 ``requests`` — one tid per request uid; the span tree nests by
  timestamp containment (Perfetto stacks same-tid X events).
* pid 2 ``engines`` — one tid per engine/track name (step rounds,
  dispatch vs device_wait brackets, host-tier readmits).
* pid 3 ``control`` — instant events from the control-plane event log.
"""

from __future__ import annotations

import json
import math
from typing import Iterable, List, Optional

__all__ = [
    "to_chrome_trace",
    "trace_to_chrome",
    "validate_chrome_trace",
    "write_trace",
]

_PID_REQUESTS = 1
_PID_ENGINES = 2
_PID_CONTROL = 3


def _us(t: float) -> float:
    return round(t * 1e6, 3)


def _span_event(span, pid: int, tid: int, now: float) -> dict:
    t1 = span.t1 if span.t1 is not None else now
    ev = {
        "name": span.name,
        "ph": "X",
        "ts": _us(span.t0),
        "dur": max(0.0, _us(t1) - _us(span.t0)),
        "pid": pid,
        "tid": tid,
        "args": dict(span.args) if span.args else {},
    }
    ev["args"]["span_id"] = span.span_id
    if span.parent_id is not None:
        ev["args"]["parent_id"] = span.parent_id
    if span.t1 is None:
        ev["args"]["open"] = True
    return ev


def _meta(pid: int, name: str, tid: Optional[int] = None,
          tname: Optional[str] = None) -> List[dict]:
    out = [{"name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": name}}]
    if tid is not None:
        out.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                    "args": {"name": tname or str(tid)}})
    return out


def _req_tid(key) -> int:
    try:
        return int(key)
    except (TypeError, ValueError):
        return abs(hash(key)) % (1 << 30)


def to_chrome_trace(traces: Optional[Iterable[dict]] = None,
                    ring: Optional[Iterable] = None,
                    events: Optional[Iterable] = None,
                    tracer=None, event_log=None, now: Optional[float] = None) -> dict:
    """Build one timeline document.

    Either pass explicit ``traces`` (dicts from ``SpanTracer.trace[s]``),
    ``ring`` (engine Spans), and ``events`` (control Events) — or pass a
    ``tracer``/``event_log`` and everything retained is exported.
    """
    if tracer is not None:
        traces = tracer.traces() if traces is None else traces
        ring = tracer.ring_spans() if ring is None else ring
    if event_log is not None and events is None:
        events = event_log.events()
    traces = list(traces or [])
    ring = list(ring or [])
    events = list(events or [])

    if now is None:
        now = 0.0
        for tr in traces:
            for sp in tr["spans"]:
                now = max(now, sp.t0, sp.t1 or 0.0)
        for sp in ring:
            now = max(now, sp.t0, sp.t1 or 0.0)
        for ev in events:
            now = max(now, ev.t)

    out: List[dict] = []
    out += _meta(_PID_REQUESTS, "requests")
    for tr in traces:
        tid = _req_tid(tr["key"])
        out += _meta(_PID_REQUESTS, "requests", tid, f"request {tr['key']}")[1:]
        for sp in tr["spans"]:
            out.append(_span_event(sp, _PID_REQUESTS, tid, now))

    if ring:
        out += _meta(_PID_ENGINES, "engines")
        track_tids = {}
        for sp in ring:
            tid = track_tids.get(sp.track)
            if tid is None:
                tid = len(track_tids) + 1
                track_tids[sp.track] = tid
                out += _meta(_PID_ENGINES, "engines", tid, sp.track)[1:]
            out.append(_span_event(sp, _PID_ENGINES, tid, now))

    if events:
        out += _meta(_PID_CONTROL, "control", 1, "events")
        for ev in events:
            out.append({
                "name": ev.kind,
                "ph": "i",
                "s": "g",
                "ts": _us(ev.t),
                "pid": _PID_CONTROL,
                "tid": 1,
                "args": dict(ev.fields),
            })

    return {"traceEvents": out, "displayTimeUnit": "ms"}


def trace_to_chrome(trace: dict, now: Optional[float] = None) -> dict:
    """A single request tree as its own Chrome-trace document."""
    return to_chrome_trace(traces=[trace], now=now)


def validate_chrome_trace(doc) -> List[str]:
    """Schema check; returns a list of problems (empty == valid)."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return [f"document is {type(doc).__name__}, expected dict"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["missing/invalid traceEvents list"]
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not a dict")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "B", "E"):
            errs.append(f"event {i}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errs.append(f"event {i}: missing name")
        if "pid" not in ev:
            errs.append(f"event {i}: missing pid")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or not math.isfinite(ts):
            errs.append(f"event {i}: non-finite ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if (not isinstance(dur, (int, float)) or not math.isfinite(dur)
                    or dur < 0):
                errs.append(f"event {i}: bad dur {dur!r}")
        if len(errs) > 20:
            errs.append("... (truncated)")
            break
    return errs


def write_trace(path: str, doc: dict) -> str:
    """Validate and write a ``.trace.json`` Perfetto can open."""
    errs = validate_chrome_trace(doc)
    if errs:
        raise ValueError("invalid Chrome-trace document: " + "; ".join(errs[:5]))
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, separators=(",", ":"))
    return path
