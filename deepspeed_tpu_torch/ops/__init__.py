"""The port's op layer (counterpart of deepspeed_tpu/ops).

Each op family has hand-written CUDA kernels beside their plain PyTorch
versions, and is registered in the op registry (``op_builder.py``) so that
``get_accelerator().create_op_builder(name).load()`` resolves it as the
JAX package's registry does. Importing this package builds nothing: the
kernels build when an op is loaded on a card, or at their first launch.
"""

from deepspeed_tpu_torch.ops.op_builder import (
    ALL_OPS,
    CUDAOpBuilder,
    NativeOpBuilder,
    OpBuilder,
    UnportedOpBuilder,
    register_op,
)


@register_op
class FlashAttnBuilder(CUDAOpBuilder):
    NAME = "flash_attn"
    KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

    def _build(self):
        from deepspeed_tpu_torch.ops.attention.core import attention

        return attention


@register_op
class FusedAdamBuilder(CUDAOpBuilder):
    NAME = "fused_adam"
    KERNELS = ("fused_adam",)

    def _build(self):
        from deepspeed_tpu_torch.ops.adam import FusedAdam

        return FusedAdam


@register_op
class QuantizerBuilder(CUDAOpBuilder):
    NAME = "quantizer"
    KERNELS = ("block_quant",)

    def _build(self):
        from deepspeed_tpu_torch.ops import quantizer

        return quantizer


@register_op
class FusedRMSNormBuilder(CUDAOpBuilder):
    NAME = "rms_norm"
    KERNELS = ("rms_norm_fwd", "rms_norm_bwd")

    def _build(self):
        from deepspeed_tpu_torch.ops.normalization import rms_norm

        return rms_norm


@register_op
class SparseAttnBuilder(CUDAOpBuilder):
    NAME = "sparse_attn"
    KERNELS = ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv",
               "splash_fwd", "splash_bwd_dq", "splash_bwd_dkv")

    def _build(self):
        # importlib: the package attribute `sparse_attention` is rebound to
        # the function by the re-export block below; the builder hands out
        # the module (as the reference's sparse_attn is a package)
        import importlib

        return importlib.import_module("deepspeed_tpu_torch.ops.sparse_attention")


@register_op
class FPQuantizerBuilder(CUDAOpBuilder):
    NAME = "fp_quantizer"
    KERNELS = ("block_quant",)

    def _build(self):
        from deepspeed_tpu_torch.ops.quantizer import block_quant

        return block_quant


@register_op
class EvoformerAttnBuilder(CUDAOpBuilder):
    NAME = "evoformer_attn"
    KERNELS = ("evoformer_fwd", "evoformer_bwd_dq", "evoformer_bwd_dkv")

    def _build(self):
        from deepspeed_tpu_torch.ops.deepspeed4science import DS4Sci_EvoformerAttention

        return DS4Sci_EvoformerAttention


@register_op
class SpatialInferenceBuilder(OpBuilder):
    """Plain torch (plain XLA in the JAX package): nothing to build."""

    NAME = "spatial_inference"

    def _build(self):
        from deepspeed_tpu_torch.ops import spatial

        return spatial


@register_op
class RandomLTDBuilder(OpBuilder):
    """Plain torch (plain XLA in the JAX package): nothing to build."""

    NAME = "random_ltd"

    def _build(self):
        from deepspeed_tpu_torch.ops import random_ltd

        return random_ltd


# host ops: g++ builds of csrc/ (NativeOpBuilder), loaded on either accelerator
from deepspeed_tpu_torch.ops.adam.cpu_adam import CPUAdamBuilder  # noqa: E402
from deepspeed_tpu_torch.ops.aio import AsyncIOBuilder  # noqa: E402

register_op(AsyncIOBuilder)
register_op(CPUAdamBuilder)


# Sparse attention is a first-class export, not just a builder target (the
# reference exposes these as deepspeed.ops.sparse_attention.*).
from deepspeed_tpu_torch.ops.sparse_attention import (  # noqa: E402,F401
    BigBirdSparsityConfig,
    BlockSchedule,
    BSLongformerSparsityConfig,
    CausalMask,
    DenseSparsityConfig,
    DocumentMask,
    FixedSparsityConfig,
    LocalMask,
    MultiHeadMask,
    SparseSelfAttention,
    SparsityConfig,
    VariableSparsityConfig,
    schedule_from_layout,
    schedule_from_mask,
    sparse_attention,
    sparse_attention_reference,
    splash_attention,
    splash_prefill_attention,
)

# Compatibility table (reference deepspeed.ops.__compatible_ops__): every
# op the port has
__compatible_ops__ = {name: not issubclass(cls, UnportedOpBuilder)
                      for name, cls in ALL_OPS.items()}
