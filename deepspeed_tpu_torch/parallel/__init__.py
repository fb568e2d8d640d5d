"""Parallel and memory-reducing compute (mirrors deepspeed_tpu/parallel)."""
