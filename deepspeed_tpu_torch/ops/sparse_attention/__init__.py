"""Block-sparse attention for the port (``deepspeed_tpu/ops/sparse_attention``).

The sparsity configs, the masks and schedules they compile into (numpy
copies of the JAX package's), the splash kernels' entries
(``splash_attention``, ``splash_prefill_attention``) and a
``SparseSelfAttention`` module-equivalent on its ``use_splash=True`` path.
The layout-predicate kernel of ``sparse_pallas.py`` (the splash oracle and
the biased form) is not ported yet: ``use_splash=False`` and the ``rpe`` /
``key_padding_mask`` / ``attn_mask`` arguments raise ``NotImplementedError``
naming ROADMAP queue 2, item 9.
"""

from typing import Optional

import numpy as np

from deepspeed_tpu_torch.ops.sparse_attention.config import (
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    SparsityConfig,
    VariableSparsityConfig,
)
from deepspeed_tpu_torch.ops.sparse_attention.mask import (
    CausalMask,
    DocumentMask,
    FullMask,
    LayoutMask,
    LocalMask,
    Mask,
    MultiHeadMask,
)
from deepspeed_tpu_torch.ops.sparse_attention.schedule import (
    BlockSchedule,
    build_schedule,
    schedule_from_layout,
    schedule_from_mask,
)
from deepspeed_tpu_torch.ops.sparse_attention.splash import (
    splash_attention,
    splash_prefill_attention,
)

_LAYOUT_KERNEL = "ROADMAP queue 2, item 9: the layout-predicate sparse kernel"


class SparseSelfAttention:
    """Functional analogue of the reference ``SparseSelfAttention`` module:
    holds a sparsity config, builds and caches the compacted block schedule
    per sequence length, and applies the splash kernels (their plain
    versions on CPU tensors). ``__call__(q, k, v)`` with [b, h, s, d]
    tensors; GQA kv runs natively."""

    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 key_padding_mask_mode: str = "add", attn_mask_mode: str = "mul",
                 max_seq_length: int = 2048, use_splash: bool = True):
        if not use_splash:
            raise NotImplementedError(
                f"SparseSelfAttention(use_splash=False) is not ported yet ({_LAYOUT_KERNEL})")
        self.sparsity_config = sparsity_config or FixedSparsityConfig(num_heads=4)
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.max_seq_length = max_seq_length
        self.use_splash = use_splash
        self._layouts = {}
        self._schedules = {}

    def get_layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layouts[seq_len]

    def get_schedule(self, seq_len: int) -> BlockSchedule:
        # built once per sequence length, never per call
        if seq_len not in self._schedules:
            self._schedules[seq_len] = self.sparsity_config.make_schedule(seq_len)
        return self._schedules[seq_len]

    def __call__(self, query, key, value, rpe=None, key_padding_mask=None, attn_mask=None):
        b, h, s, d = query.shape
        if h != self.sparsity_config.num_heads:
            raise ValueError(f"query has {h} heads, sparsity config expects "
                             f"{self.sparsity_config.num_heads}")
        if rpe is not None or key_padding_mask is not None or attn_mask is not None:
            raise NotImplementedError(
                "SparseSelfAttention: rpe / key_padding_mask / attn_mask take the biased "
                f"layout kernel, which is not ported yet ({_LAYOUT_KERNEL})")
        return splash_attention(query, key, value, self.get_schedule(s))


__all__ = [
    "SparsityConfig",
    "DenseSparsityConfig",
    "FixedSparsityConfig",
    "BSLongformerSparsityConfig",
    "BigBirdSparsityConfig",
    "VariableSparsityConfig",
    "SparseSelfAttention",
    "Mask",
    "FullMask",
    "CausalMask",
    "LocalMask",
    "DocumentMask",
    "LayoutMask",
    "MultiHeadMask",
    "BlockSchedule",
    "build_schedule",
    "schedule_from_mask",
    "schedule_from_layout",
    "splash_attention",
    "splash_prefill_attention",
]
