"""Optimized linear / LoRA (counterpart of ``deepspeed_tpu/linear``;
reference deepspeed/linear/). ``optimized_linear_partition_specs``, the
tensor-parallel placement of the base, waits for the multi-GPU slice
(ROADMAP queue 1, item 6)."""

from deepspeed_tpu_torch.linear.optimized_linear import (
    LoRAConfig,
    QuantizationConfig,
    init_optimized_linear,
    lora_trainable_mask,
    merge_lora,
    optimized_linear,
)

__all__ = [
    "LoRAConfig",
    "QuantizationConfig",
    "init_optimized_linear",
    "lora_trainable_mask",
    "merge_lora",
    "optimized_linear",
]
