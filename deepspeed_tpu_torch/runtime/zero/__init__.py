"""ZeRO configuration (mirrors deepspeed_tpu/runtime/zero)."""
