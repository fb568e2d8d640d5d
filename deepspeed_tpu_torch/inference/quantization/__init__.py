"""Weight-only quantized inference (counterpart of
``deepspeed_tpu/inference/quantization``; reference
``inference/quantization/``: ``module_quantize.py`` + the GroupQuantizer
in replace_module.py:44).

Matmul weights are stored as int8 (or packed int4) payloads with fp32
block scales, so the card holds the narrow form; the model widens ONE
layer's weights at a time as it runs that layer, never the model's."""

from deepspeed_tpu_torch.inference.quantization.quantize import (
    QuantizedWeight,
    dequantize_leaf,
    is_quantized_leaf,
    maybe_dequantize,
    model_memory_bytes,
    quantize_inference_params,
)

__all__ = [
    "QuantizedWeight",
    "dequantize_leaf",
    "is_quantized_leaf",
    "maybe_dequantize",
    "model_memory_bytes",
    "quantize_inference_params",
]
