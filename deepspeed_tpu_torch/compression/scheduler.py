"""Compression scheduler (counterpart of
``deepspeed_tpu/compression/scheduler.py``; reference
``compression/scheduler.py``): each technique activates at its
``schedule_offset`` (and optionally ends at ``schedule_offset_end``);
weight-quantization bits can ramp down in stages (the MoQ-style
start→target halving). Plain Python, as in the JAX package."""

from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass
class TechniqueSchedule:
    enabled: bool = False
    schedule_offset: int = 0
    schedule_offset_end: Optional[int] = None
    # weight quantization extras
    start_bits: int = 8
    target_bits: int = 8
    quantize_period: int = 0  # steps between bit halvings (0 = jump to target)
    # pruning extras
    dense_ratio: float = 1.0
    num_heads: int = 0
    patterns: tuple = ("*",)

    def active(self, step: int) -> bool:
        if not self.enabled or step < self.schedule_offset:
            return False
        if self.schedule_offset_end is not None and step > self.schedule_offset_end:
            return False
        return True

    def bits_at(self, step: Optional[int]) -> int:
        """MoQ-style halving from start_bits toward target_bits every
        quantize_period steps after activation (reference quantize.py).
        ``step=None`` = fully ramped (export/bake time)."""
        if step is None:
            return self.target_bits
        if not self.active(step) or self.quantize_period <= 0:
            return self.target_bits if self.active(step) else self.start_bits
        halvings = (step - self.schedule_offset) // self.quantize_period
        bits = self.start_bits
        for _ in range(halvings):
            if bits <= self.target_bits:
                break
            bits = max(bits // 2, self.target_bits)
        return bits


class CompressionScheduler:
    """Holds per-technique schedules and answers 'what applies at step N'."""

    def __init__(self, techniques: Dict[str, TechniqueSchedule]):
        self.techniques = techniques

    @classmethod
    def from_config(cls, compression_cfg: Dict[str, Any]) -> "CompressionScheduler":
        techs = {}
        for name in (
            "weight_quantization",
            "activation_quantization",
            "sparse_pruning",
            "row_pruning",
            "head_pruning",
        ):
            section = compression_cfg.get(name, {}) or {}
            shared = section.get("shared_parameters", {}) or {}
            groups = section.get("different_groups", {}) or {}
            params: Dict[str, Any] = {
                "enabled": shared.get("enabled", False),
                "schedule_offset": shared.get("schedule_offset", 0),
                "schedule_offset_end": shared.get("schedule_offset_end"),
            }
            # first group supplies technique knobs (reference groups each
            # carry their own params; one group covers the common case)
            if groups:
                g = next(iter(groups.values()))
                gp = g.get("params", {})
                params["start_bits"] = gp.get("start_bits", 8)
                params["target_bits"] = gp.get("target_bits", gp.get("bits", 8))
                params["dense_ratio"] = gp.get("dense_ratio", 1.0)
                params["num_heads"] = gp.get("num_heads", 0)
                params["patterns"] = tuple(g.get("modules", ["*"]))
                params["quantize_period"] = shared.get("quantize_period", 0)
            tech = TechniqueSchedule(**params)
            if name == "head_pruning" and tech.enabled and tech.num_heads <= 0:
                raise ValueError(
                    "head_pruning requires 'num_heads' in its group params "
                    "(fail at config parse, not mid-training)"
                )
            techs[name] = tech
        return cls(techs)

    def active_techniques(self, step: int):
        return {n: t for n, t in self.techniques.items() if t.active(step)}
