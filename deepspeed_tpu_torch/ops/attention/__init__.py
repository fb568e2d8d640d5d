"""Subpackage of deepspeed_tpu_torch (mirrors deepspeed_tpu/ops/attention)."""
