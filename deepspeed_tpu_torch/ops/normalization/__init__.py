"""Normalization ops (mirrors deepspeed_tpu/ops/normalization)."""

from deepspeed_tpu_torch.ops.normalization.fused_norm import (
    fused_layer_norm,
    fused_rms_norm,
    layer_norm_reference,
    rms_norm,
    rms_norm_reference,
)

__all__ = [
    "fused_layer_norm", "fused_rms_norm", "layer_norm_reference", "rms_norm",
    "rms_norm_reference",
]
