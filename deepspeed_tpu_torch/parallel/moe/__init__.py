"""Mixture-of-Experts for the port.

Counterpart of ``deepspeed_tpu/parallel/moe/``: ``TopKGate`` with top-1,
top-2 and top-k gating (capacity, token dropping by three policies, the
load-balancing aux loss) and ``moe_mlp``, the capacity-padded GShard
dispatch -> per-expert MLP -> combine that ``models/transformer.py`` routes
an MoE layer through. One device: the einsum form of the JAX package's
single-device path, plain PyTorch (the JAX package computes it in XLA, not
in a Pallas body). Expert parallelism, and the int8 exchange inside it, are
not ported (ROADMAP queue 1, item 6).
"""

from deepspeed_tpu_torch.parallel.moe.mappings import drop_tokens, gather_tokens
from deepspeed_tpu_torch.parallel.moe.sharded_moe import (
    MoE,
    TopKGate,
    moe_mlp,
    top1gating,
    top2gating,
    topkgating,
)

__all__ = [
    "MoE",
    "TopKGate",
    "drop_tokens",
    "gather_tokens",
    "moe_mlp",
    "top1gating",
    "top2gating",
    "topkgating",
]
