"""Checkpoint writers (mirrors deepspeed_tpu/runtime/checkpoint_engine)."""

from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
    AsyncCheckpointEngine,
    CheckpointEngine,
    DecoupledCheckpointEngine,
    TorchCheckpointEngine,
    create_checkpoint_engine,
    register_checkpoint_engine,
)

__all__ = [
    "AsyncCheckpointEngine", "CheckpointEngine", "DecoupledCheckpointEngine",
    "TorchCheckpointEngine", "create_checkpoint_engine", "register_checkpoint_engine",
]
