"""Replica health: the failure-detection state machine.

Copy of ``deepspeed_tpu/serving/resilience/health.py``.

Every :class:`~deepspeed_tpu_torch.serving.cluster.core.EngineCore` carries a
:class:`ReplicaHealth`. Observations come from three detectors:

  * **step errors** — the engine step raised; per-request state is
    unknowable after a failed step, so the router also recovers the
    resident set (see ``resilience.recovery``). Consecutive errors walk
    the replica ``healthy → degraded → quarantined``.
  * **worker crashes** — the replica's worker thread threw outside the
    step (or the step wedged past the watchdog deadline): straight to
    ``quarantined``; no error streak earns that.
  * **step hangs** — the coordinator's watchdog saw a step exceed
    ``hung_step_s``; quarantined immediately (the wedged thread may
    never return).

Re-admission is a circuit breaker: a quarantined replica is excluded
from placement, prefix-directory pulls, and elastic replica counts until
an exponential-backoff **probation probe** passes — ``quarantined →
probation`` when the backoff elapses, ``probation → healthy`` on a
passed probe, back to ``quarantined`` (backoff doubled, capped) on a
failed one. Only a passed probe restores placements; a replica never
sneaks back in by merely going quiet.

The state machine itself is policy-free bookkeeping with an internal
lock (workers mutate it under their core's step lock, the coordinator
under the router condition — the two never nest around it), so tests
drive it directly with a fake clock.
"""

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = [
    "HEALTHY", "DEGRADED", "QUARANTINED", "PROBATION",
    "ResilienceConfig", "ReplicaHealth",
]

HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"
PROBATION = "probation"


@dataclass
class ResilienceConfig:
    """Failure-detection and recovery knobs for a Router fleet. Passing a
    config to ``Router(resilience=...)`` switches ``engine_failed`` from
    fail-the-residents to recover-the-residents and arms the watchdog,
    quarantine exclusion, probation probes, and bounded retries."""

    # watchdog: a step older than this is a hang (quarantine + recovery)
    hung_step_s: float = 5.0
    # consecutive step errors before healthy -> degraded / -> quarantined
    degrade_after: int = 1
    quarantine_after: int = 3
    # probation probe backoff: first probe after probe_backoff_s, doubled
    # (x probe_backoff_mult, capped) on every failed probe
    probe_backoff_s: float = 0.25
    probe_backoff_mult: float = 2.0
    probe_backoff_max_s: float = 30.0
    # bounded retry-with-backoff on handoff export/import and peer pulls
    retry_attempts: int = 3
    retry_backoff_s: float = 0.02
    retry_backoff_mult: float = 2.0
    # per-request recovery budget: a stream rebuilt more than this many
    # times fails instead of ping-ponging across dying replicas forever
    max_recoveries: int = 3

    def __post_init__(self):
        if self.hung_step_s <= 0:
            raise ValueError(f"hung_step_s must be > 0, got {self.hung_step_s}")
        if self.degrade_after < 1:
            raise ValueError(f"degrade_after must be >= 1, got {self.degrade_after}")
        if self.quarantine_after < self.degrade_after:
            raise ValueError(
                f"quarantine_after ({self.quarantine_after}) must be >= "
                f"degrade_after ({self.degrade_after})"
            )
        if self.probe_backoff_s <= 0:
            raise ValueError(f"probe_backoff_s must be > 0, got {self.probe_backoff_s}")
        if self.probe_backoff_mult < 1.0:
            raise ValueError(
                f"probe_backoff_mult must be >= 1, got {self.probe_backoff_mult}"
            )
        if self.probe_backoff_max_s < self.probe_backoff_s:
            raise ValueError("probe_backoff_max_s must be >= probe_backoff_s")
        if self.retry_attempts < 1:
            raise ValueError(f"retry_attempts must be >= 1, got {self.retry_attempts}")
        if self.retry_backoff_s < 0:
            raise ValueError(f"retry_backoff_s must be >= 0, got {self.retry_backoff_s}")
        if self.retry_backoff_mult < 1.0:
            raise ValueError(
                f"retry_backoff_mult must be >= 1, got {self.retry_backoff_mult}"
            )
        if self.max_recoveries < 0:
            raise ValueError(f"max_recoveries must be >= 0, got {self.max_recoveries}")

    @classmethod
    def from_dict(cls, d: Dict) -> "ResilienceConfig":
        known = set(cls.__dataclass_fields__)
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown resilience config key(s) {sorted(unknown)} "
                f"(known: {sorted(known)})"
            )
        return cls(**d)

    def retry_policy(self):
        from deepspeed_tpu_torch.serving.resilience.retry import RetryPolicy
        return RetryPolicy(
            attempts=self.retry_attempts,
            backoff_s=self.retry_backoff_s,
            backoff_mult=self.retry_backoff_mult,
        )


class ReplicaHealth:
    """Per-replica health state machine (see module docstring)."""

    def __init__(self, name: str, cfg: Optional[ResilienceConfig] = None,
                 clock=time.monotonic):
        self.name = str(name)
        self.cfg = cfg or ResilienceConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self.state = HEALTHY
        self.consecutive_errors = 0
        self.last_error: Optional[str] = None
        self.last_error_t: Optional[float] = None
        self.quarantines = 0
        self.probes = 0
        self.probe_failures = 0
        self._backoff_s = self.cfg.probe_backoff_s
        self.next_probe_at: Optional[float] = None

    def configure(self, cfg: ResilienceConfig) -> None:
        with self._lock:
            self.cfg = cfg
            if self.state not in (QUARANTINED, PROBATION):
                self._backoff_s = cfg.probe_backoff_s

    # -- placement gate ---------------------------------------------------
    @property
    def placeable(self) -> bool:
        """Whether this replica may receive placements: quarantined AND
        probation replicas are excluded — only a passed probe re-admits."""
        with self._lock:
            return self.state in (HEALTHY, DEGRADED)

    # -- observations -----------------------------------------------------
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
            if self.state == PROBATION:
                self._enter_quarantine_locked(double=True)
            elif self.state != QUARANTINED:
                if self.consecutive_errors >= self.cfg.quarantine_after:
                    self._enter_quarantine_locked()
                elif self.consecutive_errors >= self.cfg.degrade_after:
                    self.state = DEGRADED
            return self.state

    def note_crash(self, error: str) -> str:
        """The worker thread died outside the step: quarantine outright."""
        return self._hard_fail(f"worker crash: {error}")

    def note_hang(self, error: str) -> str:
        """The watchdog saw a step exceed the hung-step deadline."""
        return self._hard_fail(error)

    def _hard_fail(self, error: str) -> str:
        with self._lock:
            self.consecutive_errors += 1
            self.last_error = str(error)
            self.last_error_t = self._clock()
            if self.state != QUARANTINED:
                self._enter_quarantine_locked(double=self.state == PROBATION)
            return self.state

    def _enter_quarantine_locked(self, double: bool = False) -> None:
        if double:
            self._backoff_s = min(
                self._backoff_s * self.cfg.probe_backoff_mult,
                self.cfg.probe_backoff_max_s,
            )
        else:
            self._backoff_s = self.cfg.probe_backoff_s
        self.state = QUARANTINED
        self.quarantines += 1
        self.next_probe_at = self._clock() + self._backoff_s

    # -- probation probes -------------------------------------------------
    def probe_due(self, now: Optional[float] = None) -> bool:
        with self._lock:
            return (
                self.state == QUARANTINED
                and self.next_probe_at is not None
                and (now if now is not None else self._clock()) >= self.next_probe_at
            )

    def begin_probe(self) -> None:
        """Quarantined → probation while one probe is in flight (also
        stops a second coordinator pass double-probing)."""
        with self._lock:
            if self.state != QUARANTINED:
                raise RuntimeError(
                    f"begin_probe on {self.name}: state is {self.state}"
                )
            self.state = PROBATION
            self.probes += 1

    def probe_passed(self) -> None:
        with self._lock:
            self.state = HEALTHY
            self.consecutive_errors = 0
            self._backoff_s = self.cfg.probe_backoff_s
            self.next_probe_at = None

    def probe_failed(self, error: str) -> None:
        """Back to quarantine with the backoff doubled (capped)."""
        with self._lock:
            self.probe_failures += 1
            self.last_error = str(error)
            self.last_error_t = self._clock()
            self._enter_quarantine_locked(double=True)

    # -- observability ----------------------------------------------------
    def snapshot(self) -> Dict:
        with self._lock:
            out = {
                "state": self.state,
                "consecutive_errors": self.consecutive_errors,
                "quarantines": self.quarantines,
                "probes": self.probes,
                "probe_failures": self.probe_failures,
                "last_error": self.last_error,
            }
            if self.state == QUARANTINED and self.next_probe_at is not None:
                out["next_probe_in_s"] = round(
                    max(0.0, self.next_probe_at - self._clock()), 3
                )
            return out
