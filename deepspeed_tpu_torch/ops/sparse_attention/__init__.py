"""Block-sparse attention for the port (``deepspeed_tpu/ops/sparse_attention``).

The sparsity configs, the masks and schedules they compile into (numpy
copies of the JAX package's), and the kernels' entries:

  * splash.py — the production path: a mask or layout compiles into a
    compacted per-query-block schedule of the kv blocks to visit
    (``splash_attention``, ``splash_prefill_attention``);
  * sparse.py — the layout-predicate kernels, the splash kernels' oracle:
    every block of the layout's row is read and the inactive ones skipped
    (``sparse_attention``, with the dense ``sparse_attention_reference`` and
    the biased ``sparse_attention_with_bias``).

``SparseSelfAttention`` is the module-equivalent over both.
"""

from typing import Optional

import numpy as np
import torch

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
from deepspeed_tpu_torch.ops.sparse_attention.sparse import (
    sparse_attention,
    sparse_attention_reference,
    sparse_attention_with_bias,
)
from deepspeed_tpu_torch.ops.sparse_attention.splash import (
    splash_attention,
    splash_prefill_attention,
)


class SparseSelfAttention:
    """Functional analogue of the reference ``SparseSelfAttention`` module:
    holds a sparsity config, builds and caches the compacted block schedule
    (and the layout) per sequence length, and applies the splash kernels
    (``use_splash=False``: the layout-predicate kernels); on CPU tensors
    their plain versions. ``__call__(q, k, v)`` with [b, h, s, d] tensors;
    GQA kv runs natively in the splash kernels and is expanded for the
    layout kernels. ``rpe``, ``key_padding_mask`` and ``attn_mask`` take the
    dense biased form whatever ``use_splash`` says, as in the JAX package."""

    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 key_padding_mask_mode: str = "add", attn_mask_mode: str = "mul",
                 max_seq_length: int = 2048, use_splash: bool = True):
        self.sparsity_config = sparsity_config or FixedSparsityConfig(num_heads=4)
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.max_seq_length = max_seq_length
        self.use_splash = use_splash
        self._layouts = {}
        self._device_layouts = {}
        self._schedules = {}

    def get_layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layouts[seq_len]

    def device_layout(self, seq_len: int, device) -> torch.Tensor:
        """``get_layout(seq_len)`` as an int32 tensor on ``device``, uploaded
        once per (sequence length, device)."""
        key = (seq_len, str(torch.device(device)))
        if key not in self._device_layouts:
            self._device_layouts[key] = torch.as_tensor(
                self.get_layout(seq_len), dtype=torch.int32, device=device)
        return self._device_layouts[key]

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
        causal = getattr(self.sparsity_config, "attention",
                         "bidirectional") == "unidirectional"
        if rpe is not None or key_padding_mask is not None or attn_mask is not None:
            # the masked variants take the dense biased form (the reference
            # applies them inside its softmax kernel)
            key, value = _expand_kv(key, value, h)
            bias = torch.zeros((1, 1, s, s), dtype=torch.float32, device=query.device)
            if rpe is not None:
                bias = bias + torch.as_tensor(rpe, device=query.device).float()
            if key_padding_mask is not None:  # [b, s] over keys
                kpm = torch.as_tensor(key_padding_mask, device=query.device).float()
                if self.key_padding_mask_mode == "add":
                    bias = bias + kpm[:, None, None, :]
                else:  # "mul": 0 = masked
                    bias = bias + _mul_mask(kpm[:, None, None, :])
            if attn_mask is not None:  # [s, s] (or broadcastable)
                am = torch.as_tensor(attn_mask, device=query.device).float()
                am = am[None, None] if am.dim() == 2 else am
                bias = bias + (am if self.attn_mask_mode == "add" else _mul_mask(am))
            return sparse_attention_with_bias(
                query, key, value, self.device_layout(s, query.device),
                self.sparsity_config.block, causal=causal, bias=bias)
        if self.use_splash:
            return splash_attention(query, key, value, self.get_schedule(s))
        key, value = _expand_kv(key, value, h)
        return sparse_attention(query, key, value, self.device_layout(s, query.device),
                                self.sparsity_config.block, causal=causal)


def _expand_kv(key, value, h):
    """GQA kv repeated to h heads, each kv head's group adjacent (the JAX
    package's ``jnp.repeat(axis=1)``)."""
    h_kv = key.shape[1]
    if h_kv == h:
        return key, value
    return (key.repeat_interleave(h // h_kv, dim=1), value.repeat_interleave(h // h_kv, dim=1))


def _mul_mask(m):
    """A "mul" mode mask as an additive bias: 0 where kept, -1e30 where 0."""
    return torch.where(m != 0, torch.zeros_like(m), torch.full_like(m, -1e30))


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
    "sparse_attention",
    "sparse_attention_reference",
    "sparse_attention_with_bias",
    "splash_attention",
    "splash_prefill_attention",
]
