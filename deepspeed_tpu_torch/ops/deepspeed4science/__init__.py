"""DeepSpeed4Science ops (counterpart of ``deepspeed_tpu/ops/deepspeed4science``)."""

from deepspeed_tpu_torch.ops.deepspeed4science.evoformer_attn import DS4Sci_EvoformerAttention

__all__ = ["DS4Sci_EvoformerAttention"]
