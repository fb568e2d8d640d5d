"""Adam ops (mirrors deepspeed_tpu/ops/adam): the fused device kernel and
the host optimizers of the offload tiers (``cpu_adam``)."""

from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
from deepspeed_tpu_torch.ops.adam.fused_adam import (
    AdamParams,
    FusedAdam,
    fused_adam_step,
)

__all__ = ["AdamParams", "DeepSpeedCPUAdam", "FusedAdam", "fused_adam_step"]
