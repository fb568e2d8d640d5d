"""Speculative decoding for the serving stack: draft-and-verify.

Copy of ``deepspeed_tpu/serving/spec``. Decode is memory-bandwidth-bound,
so one forward pass has idle FLOPs to score several tokens
for the price of one HBM sweep. The subsystem splits the classic
draft/verify loop across three owners:

  * ``proposer``   — where draft tokens come from. ``NgramProposer`` is the
                     model-free prompt-lookup drafter (matches the request's
                     own token history; zero extra weights); the
                     ``DraftProposer`` protocol leaves room for a
                     small-model drafter later.
  * ``controller`` — adaptive draft length per request: an acceptance-rate
                     EMA backs a request off to plain decode when drafting
                     stops paying, and periodically re-probes.
  * engine side    — ``InferenceEngineV2.spec_round()`` runs the
                     K+1-token verify step and rolls the per-row KV write
                     cursor back past rejected drafts (``ragged_manager.
                     truncate_blocks``).

Acceptance is exact-match against the engine's content-addressed sampler
(``sampling.row_keys``): the verify step samples the target token for every
draft position with the same (seed, uid, position) key plain decode would
use, and accepts a draft token only when it EQUALS that target — so spec-on
output is bit-identical to spec-off for greedy and sampled streams alike.
"""

from dataclasses import dataclass

from deepspeed_tpu_torch.serving.spec.controller import AdaptiveSpecController
from deepspeed_tpu_torch.serving.spec.proposer import DraftProposer, NgramProposer


@dataclass
class SpecParams:
    """Per-request speculative-decoding knobs (``SamplingParams.spec``).

    ``k`` is clamped to the driver's engine-level ``spec_k`` (the engine's
    verify width); ``enabled=False`` opts a request out entirely."""

    enabled: bool = True
    k: int = 4

    def __post_init__(self):
        self.k = int(self.k)
        if self.k < 0:
            raise ValueError(f"spec k must be >= 0, got {self.k}")


__all__ = [
    "AdaptiveSpecController",
    "DraftProposer",
    "NgramProposer",
    "SpecParams",
]
