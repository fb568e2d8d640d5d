"""fp16 loss scaling (mirrors deepspeed_tpu/runtime/fp16)."""
