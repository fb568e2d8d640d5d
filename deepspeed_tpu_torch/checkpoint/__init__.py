"""Checkpoint stores and offline tools (mirrors ``deepspeed_tpu/checkpoint``)."""
