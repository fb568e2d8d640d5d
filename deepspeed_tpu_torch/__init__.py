"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, slice by slice. It imports ``torch``
and numpy, never ``jax`` and nothing of ``deepspeed_tpu``; module paths
mirror the JAX package so each counterpart is easy to find. Kernels that
the JAX package wrote in Pallas are hand-written CUDA C++ for Hopper
(``ops/kernels/csrc``), built with ``nvcc`` at first use.

This slice serves: ``inference.v2.engine_v2.InferenceEngineV2`` over
``models.transformer`` with the RMSNorm and paged-decode kernels.
"""

from deepspeed_tpu_torch.version import __version__
from deepspeed_tpu_torch.utils.logging import log_dist, logger

__all__ = ["__version__", "log_dist", "logger"]
