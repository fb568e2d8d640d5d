"""Graceful load shedding: the degradation ladder.

Copy of ``deepspeed_tpu/serving/elastic/shedding.py``.

Overload must degrade before it rejects. As admission-queue occupancy
climbs past the configured thresholds, the ladder applies progressively
blunter instruments — each rung strictly contains the previous one:

  rung 1 (degrade):  cap ``max_new_tokens`` for non-interactive tiers
                     (shorter completions drain the queue faster)
  rung 2 (spec off): additionally disable speculative decoding for those
                     tiers (verify rounds burn batch budget that queued
                     prefills need more)
  rung 3 (reject):   shed the LOWEST tier outright, with a Retry-After
                     derived from the queue drain rate

Interactive-tier requests are never degraded by the ladder — protecting
the high tier's latency under burst is the whole point — and only the
bottom tier is ever rejected (everything above it still admits until the
queue is plain full).

The decision is computed at submit time from the queue occupancy the
router already tracks, so it is deterministic and lock-cheap; the
controller thread just republishes the current rung as a gauge.
"""

from dataclasses import dataclass, replace

from deepspeed_tpu_torch.serving.elastic.config import ElasticServingConfig
from deepspeed_tpu_torch.serving.request import QOS_LOWEST, QOS_TIERS, SamplingParams


@dataclass
class ShedDecision:
    """What the ladder did to one submission."""

    level: int  # 0 = untouched .. 3 = reject rung active
    params: SamplingParams  # possibly degraded copy (never mutated in place)
    reject: bool  # True: shed this request (lowest tier at rung 3)
    degraded: bool  # params differ from what the caller sent


class DegradationLadder:
    def __init__(self, cfg: ElasticServingConfig):
        self.cfg = cfg

    def level(self, queue_depth: int, max_queue: int) -> int:
        """Current rung from queue occupancy (0..3)."""
        if max_queue <= 0:
            return 0
        occ = queue_depth / max_queue
        if occ >= self.cfg.shed_reject_at:
            return 3
        if occ >= self.cfg.shed_spec_off_at:
            return 2
        if occ >= self.cfg.shed_degrade_at:
            return 1
        return 0

    def apply(self, params: SamplingParams, queue_depth: int,
              max_queue: int) -> ShedDecision:
        level = self.level(queue_depth, max_queue)
        if level == 0 or QOS_TIERS[params.qos] == 0:
            # interactive rides above the ladder until the queue is full
            return ShedDecision(level, params, reject=False, degraded=False)
        if level >= 3 and params.qos == QOS_LOWEST:
            return ShedDecision(level, params, reject=True, degraded=False)
        changes = {}
        if params.max_new_tokens > self.cfg.shed_max_new_tokens:
            changes["max_new_tokens"] = self.cfg.shed_max_new_tokens
        if level >= 2 and (params.spec is None or params.spec.enabled):
            from deepspeed_tpu_torch.serving.spec import SpecParams

            changes["spec"] = SpecParams(enabled=False)
        if not changes:
            return ShedDecision(level, params, reject=False, degraded=False)
        # copy, never mutate: callers share SamplingParams across submits
        return ShedDecision(level, replace(params, **changes),
                            reject=False, degraded=True)
