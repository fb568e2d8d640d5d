"""MoQ — Mixture-of-Quantization (counterpart of
``deepspeed_tpu/runtime/quantize.py``; reference ``runtime/quantize.py``):
training-time quantization whose precision ramps down on a schedule,
optionally stretched per layer by Hessian eigenvalues (high-curvature
layers quantize later)."""

from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch.compression.transforms import _is_weight_leaf, fake_quantize
from deepspeed_tpu_torch.runtime.eigenvalue import quantize_period_scale
from deepspeed_tpu_torch.utils.pytree import path_str
from deepspeed_tpu_torch.utils.tree import tree_map_with_path


class Quantizer:
    """Reference Quantizer: start_bits → target_bits, halving every
    ``quantize_period`` steps; ``eigenvalues`` (per layer index) stretch each
    layer's period by its normalized curvature."""

    def __init__(
        self,
        q_start_bits: int = 16,
        q_target_bits: int = 8,
        q_period: int = 100,
        q_offset: int = 0,
        eigenvalues: Optional[Dict[int, float]] = None,
    ):
        self.q_start_bits = q_start_bits
        self.q_target_bits = q_target_bits
        self.q_period = q_period
        self.q_offset = q_offset
        self._scales = quantize_period_scale(eigenvalues) if eigenvalues else None

    def bits_for(self, step: int, layer: Optional[int] = None) -> int:
        if step < self.q_offset:
            return self.q_start_bits
        period = self.q_period
        if self._scales is not None and layer is not None:
            period = int(self.q_period * (1.0 + self._scales.get(layer, 0.0)))
        halvings = (step - self.q_offset) // max(period, 1)
        bits = self.q_start_bits
        for _ in range(halvings):
            if bits <= self.q_target_bits:
                break
            bits = max(bits // 2, self.q_target_bits)
        return bits

    def quantize(self, params: Any, step: int, layers_key: str = "layers") -> Any:
        """Fake-quantize the matmul WEIGHTS at the step's precision (norm
        scales, biases and embeddings excluded by name, as the compression
        transforms exclude them); with eigenvalues, each layer of a stacked
        leaf gets its own bits. On that path a top-level leaf (``embed``,
        ``lm_head``) is named by its empty path inside its own subtree, as
        the JAX package names it, so no exclusion matches it and ``embed``
        is fake-quantized too (ROADMAP section 3)."""

        def weights(bits_of):
            return lambda path, w: bits_of(w) if _is_weight_leaf(path_str(path), w) else w

        bits = self.bits_for(step)
        whole = weights(lambda w: fake_quantize(w, bits))
        if isinstance(params, dict) and layers_key in params and self._scales is not None:
            out = {k: tree_map_with_path(whole, v) if isinstance(v, dict) else whole((), v)
                   for k, v in params.items() if k != layers_key}

            def per_layer(w):
                return torch.stack([fake_quantize(w[i], self.bits_for(step, i))
                                    for i in range(w.shape[0])])

            out[layers_key] = tree_map_with_path(weights(per_layer), params[layers_key])
            return {k: out[k] for k in params}
        return tree_map_with_path(whole, params)
