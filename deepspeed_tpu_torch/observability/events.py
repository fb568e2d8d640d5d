"""Control-plane event log: a tiny always-on bounded journal.

Events are discrete control-plane facts — shed-ladder level changes,
preempt/resume, replica scale up/down, engine failures, handoff errors —
as opposed to spans, which are intervals.  The log is cheap enough to
leave on even when span tracing is off, and the exporter renders events
as Perfetto instant events on a dedicated "control" track.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional

__all__ = ["Event", "EventLog", "get_event_log", "log_event"]


class Event:
    __slots__ = ("t", "kind", "fields")

    def __init__(self, t: float, kind: str, fields: dict):
        self.t = t            # time.monotonic() — same clock as spans
        self.kind = kind
        self.fields = fields

    def to_dict(self) -> dict:
        return {"t": self.t, "kind": self.kind, **self.fields}

    def __repr__(self):  # pragma: no cover - debug aid
        return f"Event({self.kind!r}, t={self.t:.6f}, {self.fields})"


class EventLog:
    """Thread-safe bounded event journal."""

    def __init__(self, maxlen: int = 512):
        self._events: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self.total = 0
        # events silently evicted by the bounded deque; a nonzero value
        # on /debug/events means the journal wrapped and incident
        # timelines may be missing their oldest entries
        self.dropped = 0

    def emit(self, kind: str, **fields) -> Event:
        ev = Event(time.monotonic(), kind, fields)
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)
            self.total += 1
        return ev

    def stats(self) -> dict:
        with self._lock:
            return {
                "total": self.total,
                "retained": len(self._events),
                "dropped": self.dropped,
            }

    def recent(self, n: Optional[int] = None) -> List[dict]:
        """Newest-first event dicts (all retained when ``n`` is None)."""
        with self._lock:
            evs = list(self._events)
        evs.reverse()
        if n is not None:
            evs = evs[:n]
        return [e.to_dict() for e in evs]

    def events(self) -> List[Event]:
        """Retained events oldest-first (for the timeline exporter)."""
        with self._lock:
            return list(self._events)

    def clear(self):
        with self._lock:
            self._events.clear()

    def __len__(self):
        with self._lock:
            return len(self._events)


_LOG = EventLog()


def get_event_log() -> EventLog:
    return _LOG


def log_event(kind: str, **fields) -> Event:
    """Emit on the global control-plane log."""
    return _LOG.emit(kind, **fields)
