"""The engine-facing half of the serving loop (mirrors
``deepspeed_tpu/serving/cluster``). ``EngineCore`` is ported; the
multi-engine ``Router``, the KV handoff, placement, the prefix directory,
the remote core and the replica agent are ROADMAP queue 1, item 5."""

from deepspeed_tpu_torch.serving.cluster.core import EngineCore

__all__ = ["EngineCore"]
