"""Inference for the port (mirrors ``deepspeed_tpu/inference``): the v1
``InferenceEngine`` (contiguous KV cache) and, under ``v2``, the paged
continuous-batching ``InferenceEngineV2``."""

from deepspeed_tpu_torch.inference.engine import InferenceEngine

__all__ = ["InferenceEngine"]
