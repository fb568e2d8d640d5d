"""The autoscaling control loop.

Copy of ``deepspeed_tpu/serving/elastic/controller.py``.

A single daemon thread samples the router's admission pressure — queue
depth per decode replica and the tightest deadline slack in the queue
(both already computed for the SLO placement score) — and scales the
decode fleet between the configured bounds. Decisions are made by the
pure :func:`plan_scaling` so hysteresis is unit-testable without threads:
scale-up needs sustained pressure across ``scale_up_after`` samples
(bursts shorter than a warm spare's admission cost are absorbed by the
queue), scale-down needs a much longer idle streak (``scale_down_after``)
so the fleet doesn't flap around the burst edges.
"""

import threading
from dataclasses import dataclass
from typing import Optional, Tuple

from deepspeed_tpu_torch.observability.events import log_event
from deepspeed_tpu_torch.serving.elastic.config import ElasticServingConfig
from deepspeed_tpu_torch.utils.logging import logger


@dataclass
class ScalingSignals:
    """One control-loop sample of the router's admission pressure."""

    queue_depth: int
    active_requests: int
    n_decode: int
    spares_available: int
    # tightest (deadline - now) among QUEUED requests; None when no queued
    # request carries a deadline
    min_queue_slack_s: Optional[float] = None
    # replicas excluded from placement by the health state machine; the
    # router reports n_decode as the PLACEABLE count so quarantined
    # capacity never suppresses a needed scale-up — this field only
    # surfaces the exclusion for logging/telemetry
    n_quarantined: int = 0


def plan_scaling(
    signals: ScalingSignals,
    cfg: ElasticServingConfig,
    up_streak: int = 0,
    down_streak: int = 0,
    urgent_slack_s: float = 1.0,
) -> Tuple[int, int, int]:
    """One control decision: returns (delta, up_streak, down_streak) where
    delta is +1 (add a replica), -1 (retire one), or 0. Pure — the caller
    threads the streak counters through consecutive samples."""
    pressured = (
        signals.queue_depth / max(1, signals.n_decode)
        >= cfg.scale_up_queue_per_replica
    )
    if (
        signals.min_queue_slack_s is not None
        and signals.min_queue_slack_s <= urgent_slack_s
        and signals.queue_depth > 0
    ):
        pressured = True  # deadline about to burn in the queue: act now
    surplus = (
        signals.queue_depth == 0
        and signals.active_requests < signals.n_decode
    )
    up_streak = up_streak + 1 if pressured else 0
    down_streak = down_streak + 1 if surplus else 0
    if (
        pressured
        and up_streak >= cfg.scale_up_after
        and signals.n_decode < cfg.max_decode_replicas
    ):
        return 1, 0, 0
    if (
        surplus
        and down_streak >= cfg.scale_down_after
        and signals.n_decode > cfg.min_decode_replicas
    ):
        return -1, 0, 0
    return 0, up_streak, down_streak


class ElasticController:
    """Daemon thread driving :func:`plan_scaling` against a router."""

    def __init__(self, router, cfg: ElasticServingConfig):
        self.router = router
        self.cfg = cfg
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._up_streak = 0
        self._down_streak = 0
        self.decisions = {"up": 0, "down": 0}

    def start(self) -> "ElasticController":
        if self._thread is not None:
            raise RuntimeError("controller already started")
        # the controller's scale-down re-warms engines: it runs in the
        # router's engine scope (no autograd, the engines' card)
        scope = getattr(self.router, "run_in_engine_scope", None)
        self._thread = threading.Thread(
            target=self._run if scope is None else scope, name="serving-elastic",
            args=() if scope is None else (self._run,), daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def step(self) -> int:
        """One sample+decide+act pass (the thread body; callable directly
        from tests for determinism). Returns the applied delta."""
        signals = self.router.scaling_signals()
        delta, self._up_streak, self._down_streak = plan_scaling(
            signals, self.cfg, self._up_streak, self._down_streak
        )
        if delta > 0:
            core = self.router.add_decode_replica()
            if core is not None:
                self.decisions["up"] += 1
                logger.info(
                    f"elastic: scaled up to {signals.n_decode + 1} decode "
                    f"replicas (queue {signals.queue_depth})"
                )
            else:
                delta = 0  # no spare and no factory: bounded by the fleet
        elif delta < 0:
            name = self.router.remove_decode_replica()
            if name is not None:
                self.decisions["down"] += 1
                logger.info(f"elastic: retired decode replica {name}")
            else:
                delta = 0  # nothing idle enough to retire this round
        return delta

    def _run(self):
        while not self._stop.wait(self.cfg.control_interval_s):
            try:
                self.step()
            except Exception as e:  # the control loop must outlive races
                logger.warning(
                    f"elastic: control step failed: {type(e).__name__}: {e}"
                )
                log_event("elastic_step_failed",
                          error=f"{type(e).__name__}: {e}")
