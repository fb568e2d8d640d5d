"""Inference v2 for the port: paged KV cache + continuous batching.

Mirrors ``deepspeed_tpu/inference/v2``: the allocator, prefix cache, state
manager and scheduler are numpy-only copies; ``InferenceEngineV2`` runs its
steps in PyTorch.
"""

from deepspeed_tpu_torch.inference.v2.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.inference.v2.prefix_cache import PrefixCache
from deepspeed_tpu_torch.inference.v2.ragged_manager import DSSequenceDescriptor, DSStateManager
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.scheduler import RaggedBatch, RaggedScheduler

__all__ = [
    "BlockedAllocator",
    "DSSequenceDescriptor",
    "DSStateManager",
    "InferenceEngineV2",
    "PrefixCache",
    "RaggedBatch",
    "RaggedScheduler",
]
