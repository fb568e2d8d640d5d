"""The port's model family (mirrors ``deepspeed_tpu/models``): the decoder
and encoder stacks of ``transformer``, HF checkpoint import (``hf``) and
adapters for user modules (``adapters``)."""

from deepspeed_tpu_torch.models.adapters import module_loss_fn
from deepspeed_tpu_torch.models.hf import config_from_hf, load_hf_llama, load_hf_model

__all__ = ["config_from_hf", "load_hf_llama", "load_hf_model", "module_loss_fn"]
