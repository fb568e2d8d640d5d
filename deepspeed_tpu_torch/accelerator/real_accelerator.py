"""Accelerator singleton (counterpart of
``deepspeed_tpu/accelerator/real_accelerator.py``).

``get_accelerator()`` honours ``DS_ACCELERATOR`` in {cuda, cpu}; with no
override it is the CUDA accelerator, whose device calls raise without a
card (never a quiet switch to the CPU).
"""

import os

from deepspeed_tpu_torch.utils.logging import logger

_accelerator = None


def _detect():
    from deepspeed_tpu_torch.accelerator.cuda_accelerator import CPU_Accelerator, CUDA_Accelerator

    override = os.environ.get("DS_ACCELERATOR")
    if override is None or override == "cuda":
        return CUDA_Accelerator()
    if override == "cpu":
        return CPU_Accelerator()
    raise ValueError(f"DS_ACCELERATOR={override} not supported (cuda|cpu)")


def get_accelerator():
    global _accelerator
    if _accelerator is None:
        _accelerator = _detect()
        logger.info(f"Setting ds_accelerator to {_accelerator._name}")
    return _accelerator


def set_accelerator(accel):
    global _accelerator
    _accelerator = accel


def is_current_accelerator_supported():
    return True
