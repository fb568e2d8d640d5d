"""Sequence-axis compute (mirrors deepspeed_tpu/parallel/sequence)."""

from deepspeed_tpu_torch.parallel.sequence.tiled import (
    tiled_compute,
    tiled_logits_loss,
    tiled_mlp,
)

__all__ = ["tiled_compute", "tiled_logits_loss", "tiled_mlp"]
