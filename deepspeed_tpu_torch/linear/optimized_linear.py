"""OptimizedLinear: a frozen base weight + trainable LoRA adapters (+ an
int8 base), counterpart of ``deepspeed_tpu/linear/optimized_linear.py``
(reference ``linear/optimized_linear.py`` ``LoRAOptimizedLinear`` and
``linear/quantization.py`` ``QuantizedParameter``).

Functional form:
  params = init_optimized_linear(generator, in_f, out_f, lora, quant)
  y      = optimized_linear(params, x, lora, quant)
  mask   = lora_trainable_mask(params)                 # freeze the base

The base is stored [in, out] (with ``quant``: ``quantize_blockwise``'s
int8 payload and fp32 block scales) and enters the product detached, so
only ``lora_a`` [in, r] and ``lora_b`` [r, out] get gradients.
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch.ops.quantizer.block_quant import (
    QuantizedTensor,
    dequantize_blockwise,
    quantize_blockwise,
)
from deepspeed_tpu_torch.utils.tree import tree_map


@dataclass
class LoRAConfig:
    """Reference linear/config.py LoRAConfig."""

    lora_r: int = 64
    lora_alpha: float = 16.0
    base_weight_sharding: int = 1  # the base's shards over `model` (multi-GPU)


@dataclass
class QuantizationConfig:
    """Reference linear/config.py QuantizationConfig."""

    q_bits: int = 8
    group_size: int = 512
    quantized_weights: bool = True


def init_optimized_linear(
    generator: torch.Generator,
    in_features: int,
    out_features: int,
    lora: LoRAConfig = LoRAConfig(),
    quant: Optional[QuantizationConfig] = None,
    dtype=torch.float32,
    base_weight=None,
) -> Dict[str, Any]:
    """The param dict on ``generator``'s device: the frozen base [in, out]
    (int8 payload + scales with ``quant``), lora_a [in, r] drawn normal
    times in^-0.5, lora_b [r, out] zeros (the adapters start as the
    identity). Draws differ from the JAX package's for the same seed."""
    dev = generator.device
    if base_weight is None:
        base_weight = torch.randn((in_features, out_features), generator=generator,
                                  device=dev) * in_features ** -0.5
    base_weight = base_weight.to(dtype)
    if quant is not None and quant.quantized_weights:
        qt = quantize_blockwise(base_weight, bits=quant.q_bits, block_size=quant.group_size)
        base = {"values": qt.values, "scales": qt.scales}
    else:
        base = {"weight": base_weight}
    lora_a = torch.randn((in_features, lora.lora_r), generator=generator, device=dev)
    return {
        "base": base,
        "lora_a": (lora_a * in_features ** -0.5).to(dtype),
        "lora_b": torch.zeros((lora.lora_r, out_features), dtype=dtype, device=dev),
    }


def _base_weight(params, quant: Optional[QuantizationConfig], shape, dtype):
    base = params["base"]
    if "weight" in base:
        return base["weight"]
    qt = QuantizedTensor(values=base["values"], scales=base["scales"], shape=shape,
                         bits=quant.q_bits if quant else 8,
                         block_size=quant.group_size if quant else 512)
    return dequantize_blockwise(qt, dtype)


def optimized_linear(params: Dict[str, Any], x, lora: LoRAConfig = LoRAConfig(),
                     quant: Optional[QuantizationConfig] = None):
    """y = x @ W_base + (alpha / r) * (x @ A) @ B, the base detached (frozen,
    like the reference's requires_grad=False)."""
    in_f = params["lora_a"].shape[0]
    out_f = params["lora_b"].shape[1]
    w = _base_weight(params, quant, (in_f, out_f), x.dtype).detach()
    y = x @ w.to(x.dtype)
    scaling = lora.lora_alpha / lora.lora_r
    return y + scaling * (x @ params["lora_a"]) @ params["lora_b"]


def merge_lora(params: Dict[str, Any], lora: LoRAConfig = LoRAConfig(),
               quant: Optional[QuantizationConfig] = None):
    """Fold the adapters into a dense weight (the export path):
    W = W_base + (alpha / r) A @ B."""
    in_f = params["lora_a"].shape[0]
    out_f = params["lora_b"].shape[1]
    w = _base_weight(params, quant, (in_f, out_f), params["lora_a"].dtype)
    return w + (lora.lora_alpha / lora.lora_r) * (params["lora_a"] @ params["lora_b"])


def lora_trainable_mask(params: Dict[str, Any]) -> Dict[str, Any]:
    """True for the trainable leaves (the adapters), False for the frozen
    base."""
    return {"base": tree_map(lambda _: False, params["base"]), "lora_a": True, "lora_b": True}
