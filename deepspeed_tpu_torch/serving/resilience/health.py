"""Replica health: the step-error streak of one serving replica.

The part of ``deepspeed_tpu/serving/resilience/health.py`` the
single-replica driver runs: every ``EngineCore`` carries a
:class:`ReplicaHealth`, fed by its steps (a clean step resets the error
streak, a failed one advances it, ``healthy → degraded → quarantined``)
and reported under ``/health``. The detectors of worker crashes and hung
steps, the probation probes that re-admit a quarantined replica, and the
``ResilienceConfig`` that tunes them act through the multi-engine router
and come with it (ROADMAP queue 1, item 5). Until then quarantine is
sticky, as in the JAX package when no probe runs.
"""

import threading
import time
from typing import Dict, Optional

__all__ = ["HEALTHY", "DEGRADED", "QUARANTINED", "ReplicaHealth"]

HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"

# the JAX package's ResilienceConfig defaults: consecutive step errors
# before healthy -> degraded / -> quarantined, and the backoff before a
# quarantined replica's first probe (reported in its snapshot)
DEGRADE_AFTER = 1
QUARANTINE_AFTER = 3
PROBE_BACKOFF_S = 0.25


class ReplicaHealth:
    """Per-replica health state (see module docstring)."""

    def __init__(self, name: str, clock=time.monotonic):
        self.name = str(name)
        self._clock = clock
        self._lock = threading.Lock()
        self.state = HEALTHY
        self.consecutive_errors = 0
        self.last_error: Optional[str] = None
        self.last_error_t: Optional[float] = None
        self.quarantines = 0
        self.next_probe_at: Optional[float] = None

    def note_success(self) -> None:
        """A step completed cleanly: reset the error streak. Quarantine is
        sticky — only a probe exits it."""
        with self._lock:
            if self.state in (HEALTHY, DEGRADED):
                self.state = HEALTHY
                self.consecutive_errors = 0

    def note_error(self, error: str) -> str:
        """An engine step failed. Returns the new state."""
        with self._lock:
            self.consecutive_errors += 1
            self.last_error = str(error)
            self.last_error_t = self._clock()
            if self.state != QUARANTINED:
                if self.consecutive_errors >= QUARANTINE_AFTER:
                    self.state = QUARANTINED
                    self.quarantines += 1
                    self.next_probe_at = self._clock() + PROBE_BACKOFF_S
                elif self.consecutive_errors >= DEGRADE_AFTER:
                    self.state = DEGRADED
            return self.state

    def snapshot(self) -> Dict:
        with self._lock:
            out = {
                "state": self.state,
                "consecutive_errors": self.consecutive_errors,
                "quarantines": self.quarantines,
                # probes run under the router (item 5): none here
                "probes": 0,
                "probe_failures": 0,
                "last_error": self.last_error,
            }
            if self.state == QUARANTINED and self.next_probe_at is not None:
                out["next_probe_in_s"] = round(
                    max(0.0, self.next_probe_at - self._clock()), 3
                )
            return out
