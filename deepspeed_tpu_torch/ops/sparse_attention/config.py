"""Block-sparsity layout configs.

The port's numpy copy of ``deepspeed_tpu/ops/sparse_attention/config.py``
(reference ``deepspeed/ops/sparse_attention/sparsity_config.py``):
``SparsityConfig`` base plus Dense / Fixed / BSLongformer / BigBird /
Variable patterns, each producing a per-head block-level layout matrix
``[num_heads, num_blocks, num_blocks]`` (1 = the q-block attends to the
k-block). The layout is static (numpy, built once on the host); it drives
which kv blocks the splash kernels visit, so sparsity becomes skipped
work, not masked work. BigBird's random blocks come from
``np.random.default_rng(seed + head)``, the same bits as the JAX package's.
"""

from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base: dense layout (reference sparsity_config.py:SparsityConfig /
    DenseSparsityConfig)."""

    def __init__(self, num_heads: int, block: int = 128, different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block:
            raise ValueError(f"seq_len {seq_len} not divisible by block {self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), dtype=np.int32)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout

    def make_schedule(self, seq_len: int, block_q: Optional[int] = None,
                      block_kv: Optional[int] = None):
        """Compile this config's layout into a compacted BlockSchedule
        (schedule.py) — the form the scheduled splash kernel consumes.
        ``attention="unidirectional"`` configs get the causal predicate
        composed in (diagonal blocks demote to partial, the strict upper
        triangle is pruned before tril even sees it)."""
        from deepspeed_tpu_torch.ops.sparse_attention.schedule import schedule_from_layout

        causal = getattr(self, "attention", "bidirectional") == "unidirectional"
        return schedule_from_layout(
            self.make_layout(seq_len), self.block, causal=causal,
            block_q=block_q, block_kv=block_kv,
        )


DenseSparsityConfig = SparsityConfig


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformer 'fixed' pattern (reference FixedSparsityConfig):
    each q block attends its own local window of ``num_local_blocks`` and to
    the last ``num_global_blocks`` of every preceding window (the summary
    columns)."""

    def __init__(self, num_heads, block=128, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1, attention="bidirectional",
                 horizontal_global_attention=False, num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = (
            num_different_global_patterns if different_layout_per_head else 1
        )

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        L, G = self.num_local_blocks, self.num_global_blocks
        for h in range(self.num_heads):
            shift = (h % self.num_different_global_patterns) * G
            for qi in range(n):
                w0 = (qi // L) * L  # this q block's window start
                # local window
                for ki in range(w0, min(w0 + L, n)):
                    layout[h, qi, ki] = 1
                # global: last G blocks of each earlier window
                for ws in range(0, w0, L):
                    lo = max(ws, min(ws + L - G - shift, ws + L - G))
                    for ki in range(lo, min(lo + G, n)):
                        layout[h, qi, ki] = 1
                if self.horizontal_global_attention:
                    # global rows also attend everywhere
                    if (qi % L) >= L - G:
                        layout[h, qi, :] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class BSLongformerSparsityConfig(SparsityConfig):
    """Longformer block pattern (reference BSLongformerSparsityConfig):
    sliding window of ``num_sliding_window_blocks`` + symmetric global
    attention at ``global_block_indices`` (optionally ranges)."""

    def __init__(self, num_heads, block=128, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=(0,),
                 global_block_end_indices: Optional[List[int]] = None,
                 attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = list(global_block_indices)
        self.global_block_end_indices = (
            list(global_block_end_indices) if global_block_end_indices else None
        )
        self.attention = attention

    def _global_cols(self, n):
        cols = []
        if self.global_block_end_indices is None:
            cols = [i for i in self.global_block_indices if i < n]
        else:
            for s, e in zip(self.global_block_indices, self.global_block_end_indices):
                cols.extend(range(s, min(e, n)))
        return cols

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for qi in range(n):
            lo, hi = max(0, qi - w), min(n, qi + w + 1)
            layout[:, qi, lo:hi] = 1
        for c in self._global_cols(n):
            layout[:, :, c] = 1  # everyone attends the global block
            layout[:, c, :] = 1  # the global block attends everyone
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird block pattern (reference BigBirdSparsityConfig): sliding
    window + ``num_global_blocks`` leading globals + ``num_random_blocks``
    random blocks per row (seeded, static)."""

    def __init__(self, num_heads, block=128, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, attention="bidirectional", seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_heads):
            hh = h if self.different_layout_per_head else 0
            rs = np.random.default_rng(self.seed + hh)
            for qi in range(n):
                lo, hi = max(0, qi - w), min(n, qi + w + 1)
                layout[h, qi, lo:hi] = 1
                layout[h, qi, : min(self.num_global_blocks, n)] = 1
                k = min(self.num_random_blocks, n)
                layout[h, qi, rs.choice(n, size=k, replace=False)] = 1
            layout[h, : min(self.num_global_blocks, n), :] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class VariableSparsityConfig(SparsityConfig):
    """Variable pattern (reference VariableSparsityConfig): custom local
    window sizes and explicit global block indices."""

    def __init__(self, num_heads, block=128, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=(4,),
                 global_block_indices=(0,), global_block_end_indices=None,
                 attention="bidirectional", horizontal_global_attention=False,
                 seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = list(local_window_blocks)
        self.global_block_indices = list(global_block_indices)
        self.global_block_end_indices = (
            list(global_block_end_indices) if global_block_end_indices else None
        )
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        # consecutive local windows of the given sizes (last repeats)
        start = 0
        sizes = list(self.local_window_blocks)
        while start < n:
            size = sizes.pop(0) if len(sizes) > 1 else self.local_window_blocks[-1]
            end = min(start + size, n)
            layout[:, start:end, start:end] = 1
            start = end
        if self.global_block_end_indices is None:
            cols = [i for i in self.global_block_indices if i < n]
        else:
            cols = []
            for s, e in zip(self.global_block_indices, self.global_block_end_indices):
                cols.extend(range(s, min(e, n)))
        for c in cols:
            layout[:, :, c] = 1
            if self.horizontal_global_attention:
                layout[:, c, :] = 1
        if self.num_random_blocks:
            rs = np.random.default_rng(self.seed)
            for h in range(self.num_heads):
                for qi in range(n):
                    k = min(self.num_random_blocks, n)
                    layout[h, qi, rs.choice(n, size=k, replace=False)] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout
