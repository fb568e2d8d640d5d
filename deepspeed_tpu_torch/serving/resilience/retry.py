"""Bounded retry-with-backoff for the cluster's transfer edges.

Copy of ``deepspeed_tpu/serving/resilience/retry.py``.

Handoff export/import and router peer prefix pulls are the three places
the cluster moves KV state between replicas; each gets the same wrapper:
try ``attempts`` times, sleeping ``backoff_s * mult**i`` between tries,
then re-raise the last error for the caller's recovery path to handle.
The sleep is injectable so the backoff-bound tests run in microseconds,
and ``on_retry`` gives the router a hook to count retries in metrics and
the event log without this module importing either.
"""

import time
from dataclasses import dataclass
from typing import Callable, Optional

__all__ = ["RetryPolicy", "with_retries"]


@dataclass(frozen=True)
class RetryPolicy:
    """``attempts`` total tries (1 = no retry); exponential backoff
    between them, capped at ``max_backoff_s``."""

    attempts: int = 3
    backoff_s: float = 0.02
    backoff_mult: float = 2.0
    max_backoff_s: float = 1.0

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts}")
        if self.backoff_s < 0:
            raise ValueError(f"backoff_s must be >= 0, got {self.backoff_s}")
        if self.backoff_mult < 1.0:
            raise ValueError(f"backoff_mult must be >= 1, got {self.backoff_mult}")
        if self.max_backoff_s < self.backoff_s:
            raise ValueError("max_backoff_s must be >= backoff_s")

    def delay(self, attempt: int) -> float:
        """Sleep before retry number ``attempt`` (1-based)."""
        return min(self.backoff_s * self.backoff_mult ** (attempt - 1),
                   self.max_backoff_s)


def with_retries(
    fn: Callable,
    policy: Optional[RetryPolicy] = None,
    *,
    label: str = "",
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Call ``fn()`` up to ``policy.attempts`` times. ``on_retry(attempt,
    err)`` runs before each retry (attempt is the 1-based try that just
    failed). The final failure re-raises unchanged so callers keep the
    original exception type (HandoffError, InjectedFault, ...)."""
    policy = policy or RetryPolicy()
    for attempt in range(1, policy.attempts + 1):
        try:
            return fn()
        except Exception as e:
            if attempt == policy.attempts:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(policy.delay(attempt))
    raise AssertionError(f"unreachable: with_retries({label!r}) fell through")
