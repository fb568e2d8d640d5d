"""Accelerator abstraction of the port (mirrors deepspeed_tpu/accelerator)."""

from deepspeed_tpu_torch.accelerator.abstract_accelerator import DeepSpeedAccelerator
from deepspeed_tpu_torch.accelerator.real_accelerator import (
    get_accelerator,
    is_current_accelerator_supported,
    set_accelerator,
)

__all__ = ["DeepSpeedAccelerator", "get_accelerator", "is_current_accelerator_supported",
           "set_accelerator"]
