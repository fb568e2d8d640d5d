"""Block quantization ops (counterpart of deepspeed_tpu/ops/quantizer).

Symmetric per-block int8/int4 quantize/dequantize, the per-head-vector KV
quantizer, and the hand-written CUDA ``block_quant`` kernel behind them on
a card (``block_quant.py``), and the FP quantizer (fp8 scaled casts, fp6 /
fp8 / fp12 group quantization and packing, plain torch as the JAX
package's is plain jnp). The quantized collectives wait for the multi-GPU
slice (ROADMAP queue 1, item 6).
"""

from deepspeed_tpu_torch.ops.quantizer.block_quant import (
    QuantizedTensor,
    dequantize_blockwise,
    dequantize_kv,
    fp8_cast,
    fp8_uncast,
    fp_dequantize,
    fp_pack,
    fp_quantize,
    fp_unpack,
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
    "fp8_cast",
    "fp8_uncast",
    "fp_quantize",
    "fp_dequantize",
    "fp_pack",
    "fp_unpack",
]
