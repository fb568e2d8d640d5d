"""Adaptive draft length: back off to plain decode when acceptance dies.

A draft token that gets rejected still paid for its verify slot — embed,
QKV, attention, lm-head — so on a workload the proposer cannot predict,
speculation is pure overhead. The controller tracks a per-request
acceptance-rate EMA and:

  * serves the full draft length while the EMA stays healthy;
  * drops the request to ``k=0`` (plain decode riding the same verify
    step, or the fused decode round when NO request drafts) once the
    EMA falls below ``min_accept``;
  * re-probes with a full draft every ``probe_interval`` rounds, so a
    request that enters a predictable stretch (a quoted span, a
    repetition) wins speculation back.

Everything is deterministic host arithmetic — the controller changes only
how many drafts are ATTEMPTED, never what is accepted, so spec output
stays bit-identical to spec-off regardless of its decisions.
"""

from typing import Dict


class AdaptiveSpecController:
    def __init__(
        self,
        k: int,
        min_accept: float = 0.3,
        ema: float = 0.5,
        probe_interval: int = 8,
    ):
        if k < 1:
            raise ValueError(f"spec controller needs k >= 1, got {k}")
        if not 0.0 < ema <= 1.0:
            raise ValueError(f"ema weight must be in (0, 1], got {ema}")
        self.k = int(k)
        self.min_accept = float(min_accept)
        self.ema = float(ema)
        self.probe_interval = max(1, int(probe_interval))
        # per-uid: acceptance EMA (starts optimistic — the first rounds
        # carry full drafts) and a fallback cooldown counter (0 = drafting)
        self._rate: Dict[int, float] = {}
        self._cooldown: Dict[int, int] = {}

    def current_k(self, uid: int, k_cap: int = None) -> int:
        """Draft length to attempt for ``uid`` this round (0 = plain
        decode). Counts down the fallback cooldown; when it expires the
        request gets one full-length probe draft."""
        cap = self.k if k_cap is None else min(int(k_cap), self.k)
        if cap < 1:
            return 0
        cd = self._cooldown.get(uid, 0)
        if cd > 0:
            self._cooldown[uid] = cd - 1
            if cd > 1:
                return 0
            # probe round: neutral EMA so one good draft re-enables spec
            self._rate[uid] = self.min_accept
        return cap

    def update(self, uid: int, drafted: int, accepted: int) -> None:
        """Fold one verify round's outcome in; collapse starts the
        fallback cooldown."""
        if drafted < 1:
            return
        rate = accepted / drafted
        prev = self._rate.get(uid, 1.0)
        now = self.ema * rate + (1.0 - self.ema) * prev
        self._rate[uid] = now
        if now < self.min_accept:
            self._cooldown[uid] = self.probe_interval

    def acceptance_rate(self, uid: int) -> float:
        return self._rate.get(uid, 1.0)

    def is_fallback(self, uid: int) -> bool:
        return self._cooldown.get(uid, 0) > 0

    def forget(self, uid: int) -> None:
        """Drop a finished request's state (uids are reused by tests)."""
        self._rate.pop(uid, None)
        self._cooldown.pop(uid, None)
