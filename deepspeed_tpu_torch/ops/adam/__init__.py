"""Fused Adam ops (mirrors deepspeed_tpu/ops/adam; the CPU-offload variants
are not ported)."""

from deepspeed_tpu_torch.ops.adam.fused_adam import (
    AdamParams,
    FusedAdam,
    fused_adam_step,
)

__all__ = ["AdamParams", "FusedAdam", "fused_adam_step"]
