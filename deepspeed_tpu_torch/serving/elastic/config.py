"""Elastic serving configuration.

Copy of ``deepspeed_tpu/serving/elastic/config.py``.

One dataclass carries every control-plane knob: the decode-replica bounds
the autoscaler moves between, the control-loop cadence and hysteresis, and
the degradation-ladder thresholds. Validation is loud (``ValueError`` on
any inconsistent bound) — a silently-clamped elasticity config would make
scaling decisions nobody asked for.

``from_elasticity`` is the wiring that turns a training-side
``ElasticityConfig`` (any object with ``min_gpus`` / ``max_gpus`` chip
bounds) into serving replica bounds, so one elasticity section drives
both worlds.
"""

from dataclasses import dataclass, fields
from typing import Optional


@dataclass
class ElasticServingConfig:
    """Control-plane knobs for the elastic Router."""

    # -- autoscaling ----------------------------------------------------
    min_decode_replicas: int = 1
    max_decode_replicas: int = 1
    # control-loop sampling cadence; scale decisions use trends across
    # ``scale_up_after``/``scale_down_after`` consecutive samples
    control_interval_s: float = 0.05
    # scale up when queued work per decode replica exceeds this for
    # ``scale_up_after`` consecutive samples
    scale_up_queue_per_replica: float = 2.0
    scale_up_after: int = 2
    # scale down after this many consecutive samples with an idle surplus
    scale_down_after: int = 20
    # -- degradation ladder (fractions of the admission-queue bound) ----
    # occupancy >= degrade_at: cap max_new_tokens for non-interactive tiers
    shed_degrade_at: float = 0.5
    # occupancy >= spec_off_at: additionally disable speculative decoding
    shed_spec_off_at: float = 0.75
    # occupancy >= reject_at: reject the lowest tier with Retry-After
    shed_reject_at: float = 0.9
    shed_max_new_tokens: int = 32

    def __post_init__(self):
        if self.min_decode_replicas < 1:
            raise ValueError(
                f"min_decode_replicas must be >= 1, got {self.min_decode_replicas}"
            )
        if self.max_decode_replicas < self.min_decode_replicas:
            raise ValueError(
                f"max_decode_replicas ({self.max_decode_replicas}) must be >= "
                f"min_decode_replicas ({self.min_decode_replicas})"
            )
        if self.control_interval_s <= 0:
            raise ValueError(
                f"control_interval_s must be positive, got {self.control_interval_s}"
            )
        if self.scale_up_after < 1 or self.scale_down_after < 1:
            raise ValueError("scale_up_after/scale_down_after must be >= 1")
        if self.scale_up_queue_per_replica <= 0:
            raise ValueError(
                "scale_up_queue_per_replica must be positive, got "
                f"{self.scale_up_queue_per_replica}"
            )
        ladder = (self.shed_degrade_at, self.shed_spec_off_at, self.shed_reject_at)
        if not all(0.0 < t <= 1.0 for t in ladder):
            raise ValueError(f"shed thresholds must be in (0, 1], got {ladder}")
        if not (self.shed_degrade_at <= self.shed_spec_off_at <= self.shed_reject_at):
            raise ValueError(
                "shed thresholds must be ordered degrade <= spec_off <= reject, "
                f"got {ladder}"
            )
        if self.shed_max_new_tokens < 1:
            raise ValueError(
                f"shed_max_new_tokens must be >= 1, got {self.shed_max_new_tokens}"
            )

    @classmethod
    def from_dict(cls, d: dict) -> "ElasticServingConfig":
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown elastic serving keys: {unknown}")
        return cls(**d)

    @classmethod
    def from_elasticity(cls, ecfg, **overrides) -> "ElasticServingConfig":
        """Bridge from the training-side ``ElasticityConfig``: its chip
        bounds become decode-replica bounds (one serving replica per chip
        group). Keyword overrides win over the bridged values."""
        base = {
            "min_decode_replicas": max(1, int(ecfg.min_gpus)),
            "max_decode_replicas": max(1, int(ecfg.max_gpus)),
        }
        base.update(overrides)
        return cls(**base)

    def validate_fleet(self, n_decode: int, n_spares: int) -> None:
        """Check a concrete fleet against the bounds (router start-up)."""
        if n_decode < self.min_decode_replicas:
            raise ValueError(
                f"{n_decode} decode replicas < min_decode_replicas="
                f"{self.min_decode_replicas}"
            )
        if n_decode + n_spares < self.max_decode_replicas:
            raise ValueError(
                f"{n_decode} replicas + {n_spares} warm spares cannot reach "
                f"max_decode_replicas={self.max_decode_replicas}"
            )
