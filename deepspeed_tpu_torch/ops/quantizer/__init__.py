"""Block quantization ops (counterpart of deepspeed_tpu/ops/quantizer).

Symmetric per-block int8/int4 quantize/dequantize, the per-head-vector KV
quantizer, and the hand-written CUDA ``block_quant`` kernel behind them on
a card (``block_quant.py``). The JAX package's exports that exist in the
port; its quantized collectives and fp8 casts wait for later slices
(ROADMAP queue 1, items 6 and 8).
"""

from deepspeed_tpu_torch.ops.quantizer.block_quant import (
    QuantizedTensor,
    dequantize_blockwise,
    dequantize_kv,
    quantize_blockwise,
    quantize_blockwise_kernel,
    quantize_kv,
)

__all__ = [
    "QuantizedTensor",
    "quantize_blockwise",
    "dequantize_blockwise",
    "quantize_blockwise_kernel",
    "quantize_kv",
    "dequantize_kv",
]
