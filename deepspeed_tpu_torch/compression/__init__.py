"""Compression suite (counterpart of ``deepspeed_tpu/compression``;
reference deepspeed/compression/): QAT fake-quantization, sparse / row /
head pruning masks and layer reduction as transforms of a param tree,
on a schedule."""

from deepspeed_tpu_torch.compression.compress import init_compression, redundancy_clean
from deepspeed_tpu_torch.compression.scheduler import CompressionScheduler, TechniqueSchedule
from deepspeed_tpu_torch.compression.transforms import (
    fake_quantize,
    head_mask,
    prune_weights,
    quantize_activation,
    quantize_weights,
    reduce_layers,
    row_mask,
    sparse_mask,
    sparsity,
)

__all__ = [
    "CompressionScheduler",
    "TechniqueSchedule",
    "fake_quantize",
    "head_mask",
    "init_compression",
    "prune_weights",
    "quantize_activation",
    "quantize_weights",
    "redundancy_clean",
    "reduce_layers",
    "row_mask",
    "sparse_mask",
    "sparsity",
]
