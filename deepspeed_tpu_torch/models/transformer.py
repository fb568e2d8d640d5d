"""Decoder-only transformer family for the port (plain PyTorch).

Counterpart of ``deepspeed_tpu/models/transformer.py``. The config
(``TransformerConfig``, every field and check), the presets and the
parameter layout are the JAX package's: a flat dict of tensors whose layer
weights are stacked on a leading ``[n_layers]`` dim, projections stored
``[in, out]``. ``models/convert.params_from_numpy`` loads the JAX
package's parameters as they are, so both packages compute on identical
weights.

The port serves and trains every position scheme, MLP form and head of the
JAX model: the norms (RMSNorm through the CUDA kernels on a card), RoPE with
every scaling kind, learned positions and ALiBi (BLOOM: the flash kernels'
ALiBi form in training, a dense bias in the cached decode), projections at
the model dtype, the dense MLP and top-k MoE (``parallel/moe``: its aux
loss summed over the layers into the loss), the LM head and BERT's token
types and masked-LM head, and two forwards:

  * ``forward`` / ``forward_hidden``: the training path, as the JAX
    package's. Each layer casts its weights to the compute dtype, attention
    goes through ``ops.attention.core.attention`` (the flash kernels on a
    card; with ``attention_impl="splash"`` or ``attn_sparsity`` the splash
    kernels over the layer's block schedule) and RMSNorm through
    ``rms_norm`` (the kernels forward and backward on a card); ``remat``
    checkpoints each layer by ``remat_policy`` (``REMAT_POLICIES``).
    ``make_loss_fn``
    builds the causal-LM loss on top. ``attention_impl="flash_ring"`` (or
    "auto" on a topology whose ``context`` axis is above 1) takes the
    context-parallel ring (``ops/attention/sharded.py``); in the process
    form the model holds this rank's chunk of the sequence, with global
    positions and RoPE over the global length.
  * ``forward_reference``: the plain oracle on any device, with
    ``mha_reference`` (with ``attn_sparsity``, the splash kernels' plain
    forward over the layout) and ``rms_norm_reference``, never a kernel. The
    serving engine's tests and ``chip_smoke.py`` hold logits and gradients
    against it.

``decode_step`` / ``init_kv_cache`` are the v1 inference engine's cached
decode over contiguous KV caches (``inference/engine.py``).

With ``weight_stream`` and the training engine's ``offload_param``, the
streamed weights stay in host memory and each layer's are staged as it
runs (``models/weight_stream.py``). Features of later slices raise
``NotImplementedError`` naming their ROADMAP items.
"""

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.inference.quantization.quantize import QuantizedWeight, maybe_dequantize
from deepspeed_tpu_torch.models.weight_stream import active_streamer
from deepspeed_tpu_torch.ops.attention.core import alibi_bias, attention, mha_reference
from deepspeed_tpu_torch.ops.normalization import (
    fused_layer_norm,
    rms_norm,
    rms_norm_reference,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

# attn_sparsity spec kinds → SparsityConfig families (ops/sparse_attention)
_SPARSITY_KINDS = ("dense", "fixed", "bigbird", "bslongformer", "variable")


@functools.lru_cache(maxsize=32)
def _sparsity_schedule(spec, n_heads, seq_len, block, causal):
    """attn_sparsity spec → compacted BlockSchedule, built once per (spec,
    seq_len) and reused by every layer and step. The model's causal flag is
    ANDed in: a bidirectional sparsity family under a causal LM must not
    leak future positions."""
    from deepspeed_tpu_torch.ops.sparse_attention import config as sa_config
    from deepspeed_tpu_torch.ops.sparse_attention.schedule import schedule_from_layout

    cls = {
        "dense": sa_config.DenseSparsityConfig,
        "fixed": sa_config.FixedSparsityConfig,
        "bigbird": sa_config.BigBirdSparsityConfig,
        "bslongformer": sa_config.BSLongformerSparsityConfig,
        "variable": sa_config.VariableSparsityConfig,
    }[spec[0]]
    kwargs = dict(spec[1]) if len(spec) > 1 else {}
    cfg = cls(num_heads=n_heads, **kwargs)
    uni = getattr(cfg, "attention", "bidirectional") == "unidirectional"
    return schedule_from_layout(
        cfg.make_layout(seq_len), cfg.block, causal=causal or uni,
        block_q=block or None, block_kv=block or None,
    )


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Architecture config. Defaults give a Llama-style decoder."""

    vocab_size: int = 32000
    hidden_size: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: Optional[int] = None  # None → MHA; < n_heads → GQA; 1 → MQA
    ffn_hidden_size: Optional[int] = None  # None → 4x (gelu) / 8/3x rounded (swiglu)
    max_seq_len: int = 2048
    norm: str = "rmsnorm"  # rmsnorm | rmsnorm_1p (gemma zero-centered) | layernorm
    # swiglu | geglu (gemma) | gelu (tanh) | gelu_exact (erf) | relu |
    # quick_gelu (CLIP: x * sigmoid(1.702 x))
    activation: str = "swiglu"
    position: str = "rope"  # rope | learned | alibi (bloom) | none
    rope_theta: float = 10000.0
    # Scaled RoPE (HF rope_scaling; reference AutoTP serves these checkpoints
    # via the wrapped HF module — module_inject/auto_tp.py:193 — so parity
    # requires native support): canonical hashable form, a sorted tuple of
    # (key, value) pairs with list values as tuples. Build it with
    # ``rope_scaling_from_hf``. Supported rope_type: linear, dynamic, yarn,
    # longrope, llama3. None → plain theta RoPE.
    rope_scaling: Optional[Tuple[Tuple[str, Any], ...]] = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- per-arch variations (reference module_inject/containers/ +
    # inference/v2/model_implementations/ breadth) -------------------------
    # decoupled head dim (mistral-nemo / qwen3 style): projections become
    # [h, n_heads*head_dim] with head_dim != h/n_heads
    head_dim_override: Optional[int] = None
    # q/k normalization over head_dim, applied to the head-reshaped
    # projections BEFORE rope. "rmsnorm" (qwen3): one [d] weight per layer
    # shared across heads. "layernorm_per_head" (stablelm-2 qk_layernorm):
    # biasless LayerNorm with PER-HEAD weights ([nh, d] / [nkv, d]).
    # "layernorm" (phi qk_layernorm): one affine LayerNorm ([d] weight +
    # bias) shared across heads.
    qk_norm: bool = False
    qk_norm_kind: str = "rmsnorm"
    attn_qkv_bias: bool = False  # qwen2-style bias on q/k/v projections
    attn_out_bias: bool = False  # phi-style bias on the output projection
    mlp_bias: bool = False  # phi-style bias on MLP projections
    lm_head_bias: bool = False  # phi ships a biased lm_head
    # falcon/phi parallel block: x + attn(norm1(x)) + mlp(norm2(x)) — one
    # residual stream, attention and MLP branches computed from pre-attn
    # state (falcon-7b/phi share one norm: import the same weights into both)
    parallel_block: bool = False
    # phi partial rotary: rope applies to the first rope_frac*head_dim dims
    rope_frac: float = 1.0
    # softmax scale override: None → 1/sqrt(head_dim); gpt_neo uses 1.0
    # (HF GPTNeoSelfAttention never divides the logits)
    attn_scale: Optional[float] = None
    # --- encoder family (bert/distilbert — reference module_inject/
    # containers/{bert,distil_bert}.py serve these through kernel injection;
    # the training transformer kernel, csrc/transformer/, is BERT-shaped) ---
    # False → bidirectional self-attention (encoder)
    attn_causal: bool = True
    # "pre" (GPT/llama: norm before each block) | "post" (BERT: norm AFTER
    # each residual add — x = LN(x + attn(x)); x = LN(x + mlp(x)))
    norm_scheme: str = "pre"
    # > 0: token-type (segment) embeddings added into the stem (BERT);
    # forward takes token_type_ids (defaults to all-zeros)
    type_vocab_size: int = 0
    # BERT has no final norm (the post-LN layers end normalized already)
    final_norm: bool = True
    # masked-LM head: dense[h,h] + activation + LN before the tied decoder
    # (+ per-vocab bias) — BertForMaskedLM's cls.predictions transform
    mlm_head: bool = False
    # sliding-window attention (mistral/starcoder2 sliding_window, gpt_neo
    # local attention): query i sees keys in (i - window, i]. 0 = full
    # causal. Applies to every layer unless attn_layer_pattern says which.
    sliding_window: int = 0
    # per-layer window flags for alternating local/global stacks (gpt_neo
    # attention_types): tuple of n_layers ints, 1 = windowed, 0 = global.
    # None with sliding_window > 0 → all layers windowed.
    attn_layer_pattern: Optional[Tuple[int, ...]] = None
    # gemma scales embeddings by sqrt(hidden_size) after lookup
    embed_scale: bool = False
    # bloom applies a LayerNorm to the embedding output
    # (word_embeddings_layernorm); params carry embed_norm/embed_norm_b
    embed_norm: bool = False
    # layer-projection matmul precision (VERDICT fp8 lever; ops/qmatmul.py):
    # "default" = model dtype; "fp8" = e4m3 tensor-scaled forward operands;
    # "int8" = symmetric int8 forward (native 2x MXU rate on v5e). Backward
    # stays full precision (straight-through vjp). Head/embed stay dense.
    matmul_precision: str = "default"
    dtype: str = "bfloat16"
    remat: bool = True
    # remat policy knob (reference activation_checkpointing config; VERDICT
    # asked for this to be tunable): see remat_policy() for the names
    remat_policy: str = "dots_with_no_batch_dims"
    # fused head + CE (ops/fused_ce.py): the [b*s, V] logits are never
    # materialized. The kernels on a card (bf16), their plain versions on
    # the CPU; a biased head takes the dense path.
    fused_ce: bool = False
    # MoE (0 → dense). When n_experts > 0 the MLP becomes a top-k gated MoE
    # over the `expert` mesh axis (parallel/moe/).
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01
    # Residual-MoE (reference moe/layer.py:29 use_residual, arXiv 2201.05596):
    # out = expert_out·coef₀ + dense_mlp(x)·coef₁ with coef = softmax of a
    # learned [h, 2] projection per token
    moe_residual: bool = False
    # qwen2-moe shared expert: a dense expert of this ffn width runs on every
    # token, added as sigmoid(shared_gate(x))·shared_mlp(x) (0 → none)
    moe_shared_expert_dim: int = 0
    # renormalize top-k combine weights over surviving experts (mixtral /
    # qwen2 norm_topk_prob=True); False keeps raw softmax mass (qwen1.5-moe)
    moe_norm_topk_prob: bool = True
    vocab_parallel: bool = True  # shard embedding/lm_head vocab dim on `model`
    # sequence-parallel attention: "ulysses" (all-to-all head scatter) or
    # "ring" (ppermute blockwise — O(s/N) per-device memory, unbounded SP
    # degree; no segment_ids support)
    seq_impl: str = "ulysses"
    # attention backend seam (ops.attention.core dispatch): "auto" picks the
    # flash ring when the mesh's `context` axis is >1, else the platform
    # best; "flash_ring" / "flash_head_sharded" / "flash" / "reference"
    # force a specific path (hard error when shapes/mesh don't support it);
    # "splash" routes through the scheduled block-sparse kernels
    # (ops/sparse_attention/splash.py) — masked kv blocks are never
    # scheduled, cost scales with mask density not s²
    attention_impl: str = "auto"
    # splash mask family as a hashable spec: (kind, ((kwarg, value), ...))
    # with kind ∈ "fixed" | "bigbird" | "bslongformer" | "variable" |
    # "dense" (the SparsityConfig families). The spec is compiled into a
    # compacted per-q-block schedule at trace time (a Python constant —
    # never rebuilt per step). None with attention_impl="splash" derives
    # the schedule from attn_causal/sliding_window instead.
    attn_sparsity: Optional[Tuple] = None
    # kernel block edge for splash schedules; 0 → the op-layer default
    # (DSTPU_SPLASH_BLOCK env or 512, shrunk to fit the sequence)
    splash_block: int = 0
    # >1: compute the LM loss per sequence tile so [b, s, vocab] logits never
    # materialize (ALST TiledFusedLogitsLoss, ulysses_sp.py:960) — frees
    # ~b*s*vocab bytes of activations at the cost of recomputing the head
    # matmul in backward (~1pp MFU at 32k vocab); enable when memory-bound
    loss_tiles: int = 0
    # quantized collectives seam (comm/quantized.py): "int8" moves the MoE
    # expert-parallel dispatch/combine exchange (and, via the pipe/serving
    # configs that read it, the pipeline activation sends and the serving TP
    # psum) as int8 payloads + fp32 block scales INSIDE the collective;
    # "none" keeps full-width GSPMD collectives (bit-identical to before)
    comm_quant: str = "none"
    # ZeRO-Infinity weight streaming (reference partition_parameters.py
    # remote_device + partitioned_param_coordinator prefetch): the streamed
    # params rest in page-locked host memory; each layer's weights are staged
    # to the device one layer ahead on a copy stream, remat re-stages them in
    # backward, and their grads go back to the host (models/weight_stream.py).
    # The device then holds two layers' weights + activations. Takes effect
    # under the training engine's offload_param (its stream_scope); a no-op
    # elsewhere.
    weight_stream: bool = False

    def __post_init__(self):
        if self.norm_scheme not in ("pre", "post"):
            raise ValueError(f"norm_scheme={self.norm_scheme!r}: expected 'pre' or 'post'")
        if self.qk_norm_kind not in ("rmsnorm", "layernorm", "layernorm_per_head"):
            raise ValueError(
                f"qk_norm_kind={self.qk_norm_kind!r}: expected 'rmsnorm', "
                "'layernorm' or 'layernorm_per_head'"
            )
        if self.position == "alibi" and (self.sliding_window > 0 or self.attn_scale is not None):
            # the alibi training branch rides the flash kernel's rank-1 bias
            # and takes no window/scale — silently ignoring them would train
            # full-context and then DECODE windowed (train/serve mismatch)
            raise ValueError(
                "alibi attention does not compose with sliding_window or "
                "attn_scale (no supported arch combines them)"
            )
        if self.seq_impl not in ("ulysses", "ring"):
            raise ValueError(
                f"seq_impl={self.seq_impl!r}: expected 'ulysses' or 'ring' "
                "(a typo would silently fall back to the wrong parallelism)"
            )
        if self.attention_impl not in (
            "auto", "flash", "flash_head_sharded", "flash_ring", "reference",
            "splash",
        ):
            raise ValueError(
                f"attention_impl={self.attention_impl!r}: expected 'auto', "
                "'flash', 'flash_head_sharded', 'flash_ring', 'reference' "
                "or 'splash'"
            )
        if self.attn_sparsity is not None:
            if self.attention_impl not in ("auto", "splash"):
                raise ValueError(
                    f"attn_sparsity set with attention_impl="
                    f"{self.attention_impl!r} — the sparsity schedule only "
                    "routes through 'splash' (or 'auto' promotion)"
                )
            kind = self.attn_sparsity[0] if self.attn_sparsity else None
            if kind not in _SPARSITY_KINDS:
                raise ValueError(
                    f"attn_sparsity kind {kind!r}: expected one of "
                    f"{sorted(_SPARSITY_KINDS)}"
                )
            if self.sliding_window > 0:
                raise ValueError(
                    "attn_sparsity and sliding_window are mutually "
                    "exclusive — the sparsity layout replaces the window "
                    "band (silently ignoring the window would train a "
                    "different mask than configured)"
                )
        if self.attention_impl == "splash" or self.attn_sparsity is not None:
            if self.attn_layer_pattern is not None:
                raise ValueError(
                    "splash attention does not compose with "
                    "attn_layer_pattern — the per-layer window flag is a "
                    "traced scalar inside the layer scan, but splash "
                    "schedules are trace-time constants"
                )
            if self.position == "alibi":
                raise ValueError(
                    "splash attention does not compose with alibi (the "
                    "scheduled kernel takes no positional bias)"
                )
        if self.attn_layer_pattern is not None:
            if self.sliding_window <= 0:
                raise ValueError(
                    "attn_layer_pattern set without sliding_window — the "
                    "pattern flags which layers use the window"
                )
            if len(self.attn_layer_pattern) != self.n_layers:
                raise ValueError(
                    f"attn_layer_pattern has {len(self.attn_layer_pattern)} "
                    f"entries for {self.n_layers} layers"
                )
        if self.comm_quant not in ("none", "int8"):
            raise ValueError(
                f"comm_quant={self.comm_quant!r}: expected 'none' or 'int8' "
                "(a typo would silently serve full-width collectives)"
            )
        if self.matmul_precision not in ("default", "fp8", "int8", "int8_tensor"):
            raise ValueError(
                f"matmul_precision={self.matmul_precision!r}: expected "
                "'default', 'fp8', 'int8' (per-token/per-channel scales) or "
                "'int8_tensor' (legacy per-tensor scales)"
            )

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        if self.hidden_size % self.n_heads != 0:
            raise ValueError(f"hidden_size {self.hidden_size} not divisible by "
                             f"n_heads {self.n_heads}")
        return self.hidden_size // self.n_heads

    @property
    def ffn_dim(self) -> int:
        if self.ffn_hidden_size:
            return self.ffn_hidden_size
        if self.activation in ("swiglu", "geglu"):
            # llama-style 2/3 * 4h rounded up to a multiple of 256
            d = int(8 * self.hidden_size / 3)
            return ((d + 255) // 256) * 256
        return 4 * self.hidden_size


# Presets: the JAX package's, plus this port's flagship serving width.
PRESETS: Dict[str, Dict[str, Any]] = {
    "tiny": dict(vocab_size=512, hidden_size=128, n_layers=2, n_heads=4, max_seq_len=256),
    "gpt2-small": dict(
        vocab_size=50257, hidden_size=768, n_layers=12, n_heads=12, max_seq_len=1024,
        norm="layernorm", activation="gelu", position="learned", tie_embeddings=True,
    ),
    "llama-7b": dict(
        vocab_size=32000, hidden_size=4096, n_layers=32, n_heads=32, max_seq_len=4096,
        ffn_hidden_size=11008,
    ),
    "llama-1b": dict(
        vocab_size=32000, hidden_size=2048, n_layers=16, n_heads=16, n_kv_heads=8,
        max_seq_len=4096, ffn_hidden_size=5632,
    ),
    "bench-767m": dict(
        vocab_size=32000, hidden_size=2304, n_layers=10, n_heads=18,
        n_kv_heads=6, ffn_hidden_size=6912, max_seq_len=2048,
        remat_policy="flash",
    ),
    "mixtral-tiny": dict(
        vocab_size=1024, hidden_size=256, n_layers=2, n_heads=4, n_kv_heads=2,
        max_seq_len=512, n_experts=4, moe_top_k=2,
    ),
    # mistralai/Mistral-7B-v0.1 config.json: GQA 32/8 heads of 128, SwiGLU
    # ffn 14336, rope_theta 1e4, rms eps 1e-5, sliding_window 4096 (the
    # mapping of deepspeed_tpu/models/hf.py config_from_hf)
    "mistral-7b": dict(
        vocab_size=32000, hidden_size=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        ffn_hidden_size=14336, max_seq_len=32768, rope_theta=10000.0, norm_eps=1e-5,
        sliding_window=4096,
    ),
    # bigscience/bloom-7b1 config.json (the mapping of deepspeed_tpu/models/
    # hf.py config_from_hf): 30 layers, 32 heads of 128, ffn 4h, vocab
    # 250880, LayerNorm eps 1e-5, tanh GELU, ALiBi, tied embeddings, the
    # embedding LayerNorm, biased qkv/out/MLP projections
    "bloom-7b1": dict(
        vocab_size=250880, hidden_size=4096, n_layers=30, n_heads=32, ffn_hidden_size=16384,
        max_seq_len=2048, norm="layernorm", activation="gelu", position="alibi",
        norm_eps=1e-5, tie_embeddings=True, embed_norm=True, attn_qkv_bias=True,
        attn_out_bias=True, mlp_bias=True,
    ),
    # mistralai/Mixtral-8x7B-v0.1 config.json (the same mapping): 32 layers,
    # GQA 32/8 heads of 128, SwiGLU ffn 14336 in 8 experts, top-2 renormalized,
    # rope_theta 1e6, rms eps 1e-5, router aux coef 0.02, capacity factor E/k
    # (capacity = tokens: HF never drops)
    "mixtral-8x7b": dict(
        vocab_size=32000, hidden_size=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        ffn_hidden_size=14336, max_seq_len=32768, rope_theta=1e6, norm_eps=1e-5,
        n_experts=8, moe_top_k=2, moe_norm_topk_prob=True, moe_capacity_factor=4.0,
        moe_aux_loss_coef=0.02,
    ),
    # bert-large-uncased config.json (the same mapping): 24 layers, 16 heads
    # of 64, ffn 4096, vocab 30522, 512 positions, 2 token types, post-norm
    # LayerNorm eps 1e-12, exact GELU, bidirectional, the embedding
    # LayerNorm, the MLM head over tied embeddings, no final norm
    "bert-large": dict(
        vocab_size=30522, hidden_size=1024, n_layers=24, n_heads=16, ffn_hidden_size=4096,
        max_seq_len=512, norm="layernorm", activation="gelu_exact", position="learned",
        norm_eps=1e-12, tie_embeddings=True, attn_qkv_bias=True, attn_out_bias=True,
        mlp_bias=True, attn_causal=False, norm_scheme="post", embed_norm=True,
        type_vocab_size=2, final_norm=False, mlm_head=True,
    ),
}


def get_config(preset: str = "tiny", **overrides) -> TransformerConfig:
    kw = dict(PRESETS[preset])
    kw.update(overrides)
    return TransformerConfig(**kw)


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------
def init_params(config: TransformerConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Seeded random parameters in the JAX package's layout: layer weights
    stacked on a leading [n_layers] dim, projections [in, out], normal
    init scaled by 1/sqrt(fan_in), embeddings by 0.02. Draws come from
    ``generator`` (on ``device``), so they differ from the JAX package's
    for the same seed; tests that compare the two load the JAX parameters
    through ``models.convert.params_from_numpy``."""
    c = config
    dtype = DTYPES[c.dtype]
    dev = torch.device(device)
    h, d, nh, nkv = c.hidden_size, c.head_dim, c.n_heads, c.kv_heads
    ffn = c.ffn_dim
    L = c.n_layers

    def normal(shape, std):
        out = torch.empty(shape, device=dev, dtype=dtype)
        # one layer at a time keeps the fp32 draw small at full width
        for i in range(shape[0]):
            out[i] = torch.randn(shape[1:], generator=generator, device=dev).mul_(std).to(dtype)
        return out

    def dense(shape, fan_in):
        return normal(shape, 1.0 / math.sqrt(fan_in))

    def const(shape, value):
        return torch.full(shape, value, device=dev, dtype=dtype)

    # rmsnorm_1p's effective scale is (1 + w): identity init is zeros there
    one = 0.0 if c.norm == "rmsnorm_1p" else 1.0
    gated = c.activation in ("swiglu", "geglu")
    layers: Dict[str, Any] = {
        "attn_norm": const((L, h), one),
        "wq": dense((L, h, nh * d), h),
        "wk": dense((L, h, nkv * d), h),
        "wv": dense((L, h, nkv * d), h),
        "wo": dense((L, nh * d, h), nh * d),
        "mlp_norm": const((L, h), one),
    }
    if c.n_experts > 0:
        E = c.n_experts
        layers["router"] = dense((L, h, E), h)
        layers["w_up"] = dense((L, E, h, ffn), h)
        layers["w_down"] = dense((L, E, ffn, h), ffn)
        if gated:
            layers["w_gate"] = dense((L, E, h, ffn), h)
        if c.moe_residual:
            layers["res_up"] = dense((L, h, ffn), h)
            layers["res_down"] = dense((L, ffn, h), ffn)
            if gated:
                layers["res_gate"] = dense((L, h, ffn), h)
            layers["res_coef"] = dense((L, h, 2), h)
        if c.moe_shared_expert_dim > 0:
            sd = c.moe_shared_expert_dim
            layers["shared_up"] = dense((L, h, sd), h)
            layers["shared_down"] = dense((L, sd, h), sd)
            if gated:
                layers["shared_gate"] = dense((L, h, sd), h)
            layers["shared_gate_proj"] = dense((L, h, 1), h)
    else:
        layers["w_up"] = dense((L, h, ffn), h)
        layers["w_down"] = dense((L, ffn, h), ffn)
        if gated:
            layers["w_gate"] = dense((L, h, ffn), h)
    if c.norm == "layernorm":
        layers["attn_norm_b"] = const((L, h), 0.0)
        layers["mlp_norm_b"] = const((L, h), 0.0)
    if c.attn_qkv_bias:
        layers["wq_b"] = const((L, nh * d), 0.0)
        layers["wk_b"] = const((L, nkv * d), 0.0)
        layers["wv_b"] = const((L, nkv * d), 0.0)
    if c.qk_norm:
        if c.qk_norm_kind == "layernorm_per_head":
            layers["q_norm"] = const((L, nh, d), 1.0)
            layers["k_norm"] = const((L, nkv, d), 1.0)
        else:
            layers["q_norm"] = const((L, d), 1.0)
            layers["k_norm"] = const((L, d), 1.0)
            if c.qk_norm_kind == "layernorm":
                layers["q_norm_b"] = const((L, d), 0.0)
                layers["k_norm_b"] = const((L, d), 0.0)
    if c.attn_out_bias:
        layers["wo_b"] = const((L, h), 0.0)
    if c.mlp_bias and c.n_experts == 0:
        layers["w_up_b"] = const((L, ffn), 0.0)
        layers["w_down_b"] = const((L, h), 0.0)
        if gated:
            layers["w_gate_b"] = const((L, ffn), 0.0)
    params: Dict[str, Any] = {"embed": normal((c.vocab_size, h), 0.02), "layers": layers}
    if c.final_norm:
        params["final_norm"] = const((h,), one)
        if c.norm == "layernorm":
            params["final_norm_b"] = const((h,), 0.0)
    if c.position == "learned":
        params["pos_embed"] = normal((c.max_seq_len, h), 0.02)
    if c.type_vocab_size > 0:
        params["type_embed"] = normal((c.type_vocab_size, h), 0.02)
    if c.embed_norm:
        params["embed_norm"] = const((h,), 1.0)
        params["embed_norm_b"] = const((h,), 0.0)
    if c.mlm_head:
        params["mlm_dense"] = dense((1, h, h), h)[0]
        params["mlm_dense_b"] = const((h,), 0.0)
        params["mlm_norm"] = const((h,), 1.0)
        params["mlm_norm_b"] = const((h,), 0.0)
        params["mlm_bias"] = const((c.vocab_size,), 0.0)
    if not c.tie_embeddings:
        params["lm_head"] = dense((h, c.vocab_size), h)
        if c.lm_head_bias:
            params["lm_head_b"] = const((c.vocab_size,), 0.0)
    return params


# ---------------------------------------------------------------------------
# layer pieces
# ---------------------------------------------------------------------------
def _norm(x, w, b, kind, eps, rms=rms_norm):
    """One definition of the model's norms. RMSNorm goes through ``rms``:
    the engine's ``rms_norm`` (the CUDA kernel on a card, the plain version
    on the CPU), or ``rms_norm_reference`` in the plain ``forward``."""
    if kind == "rmsnorm":
        y = rms(x, w, eps)
        return y + b if b is not None else y
    if kind == "rmsnorm_1p":
        # gemma zero-centered weight: y = rms(x) * (1 + w), the add in fp32;
        # the kernel takes the fp32 weight
        y = rms(x, 1.0 + w.float(), eps)
        return y + b if b is not None else y
    return fused_layer_norm(x, w, b if b is not None else torch.zeros_like(w), eps)


def rope_params(c: TransformerConfig, rot: int, seq_len: Optional[int] = None):
    """Inverse frequencies [rot//2] (fp32 numpy) and the cos/sin attention
    factor, faithful to HF ``modeling_rope_utils`` for every scaling kind
    (linear, dynamic, yarn, longrope, llama3). ``seq_len`` is the live
    sequence length (HF's max(position_ids)+1); the port's callers know it
    on the host, so it is a Python int here, never a device value."""
    theta = float(c.rope_theta)
    dims = np.arange(0, rot, 2, dtype=np.float32) / rot
    inv_freq = 1.0 / (theta**dims)
    sc = dict(c.rope_scaling) if c.rope_scaling else None
    if not sc:
        return inv_freq.astype(np.float32), 1.0
    kind = sc["rope_type"]
    factor = float(sc.get("factor", 1.0))
    if kind == "linear":
        return (inv_freq / factor).astype(np.float32), 1.0
    if kind == "dynamic":
        maxp = c.max_seq_len
        seq = np.float32(max(float(seq_len if seq_len is not None else maxp), maxp))
        base = np.float32(theta) * ((np.float32(factor) * seq / np.float32(maxp))
                                    - np.float32(factor - 1)) ** np.float32(rot / (rot - 2))
        return (np.float32(1.0) / (base ** dims)).astype(np.float32), 1.0
    if kind == "llama3":
        old_len = float(sc["original_max_position_embeddings"])
        low_wl = old_len / float(sc["low_freq_factor"])
        high_wl = old_len / float(sc["high_freq_factor"])
        wavelen = 2 * math.pi / inv_freq
        scaled = np.where(wavelen > low_wl, inv_freq / factor, inv_freq)
        smooth = (old_len / wavelen - float(sc["low_freq_factor"])) / (
            float(sc["high_freq_factor"]) - float(sc["low_freq_factor"])
        )
        mid = (1 - smooth) * scaled / factor + smooth * scaled
        is_mid = (wavelen >= high_wl) & (wavelen <= low_wl)
        return np.where(is_mid, mid, scaled).astype(np.float32), 1.0
    if kind == "yarn":
        old_len = float(sc.get("original_max_position_embeddings") or c.max_seq_len)
        attn = sc.get("attention_factor")
        mscale, mscale_all = sc.get("mscale"), sc.get("mscale_all_dim")

        def get_mscale(scale, m=1.0):
            return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

        if attn is None:
            attn = (
                get_mscale(factor, mscale) / get_mscale(factor, mscale_all)
                if mscale and mscale_all
                else get_mscale(factor)
            )
        beta_fast = float(sc.get("beta_fast") or 32)
        beta_slow = float(sc.get("beta_slow") or 1)

        def corr_dim(n_rot):
            return rot * math.log(old_len / (n_rot * 2 * math.pi)) / (2 * math.log(theta))

        low, high = corr_dim(beta_fast), corr_dim(beta_slow)
        if sc.get("truncate", True):
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0), min(high, rot - 1)
        if low == high:
            high += 0.001
        ramp = np.clip((np.arange(rot // 2, dtype=np.float32) - low) / (high - low), 0, 1)
        extrap = 1.0 - ramp  # 1 → keep base freq, 0 → interpolate by factor
        return (
            (inv_freq / factor * (1 - extrap) + inv_freq * extrap).astype(np.float32),
            float(attn),
        )
    # longrope: per-dim factor lists, chosen by seq length vs pretrain length
    old_len = int(sc.get("original_max_position_embeddings") or c.max_seq_len)
    if factor == 1.0 and sc.get("original_max_position_embeddings"):
        factor = c.max_seq_len / old_len
    attn = sc.get("attention_factor")
    if attn is None:
        attn = 1.0 if factor <= 1.0 else math.sqrt(1 + math.log(factor) / math.log(old_len))
    short = 1.0 / (np.asarray(sc["short_factor"], np.float32) * theta**dims)
    long = 1.0 / (np.asarray(sc["long_factor"], np.float32) * theta**dims)
    return (long if (seq_len or 0) > old_len else short).astype(np.float32), float(attn)


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes (HF ``build_alibi_tensor``'s formula, with its
    interpolation for a head count that is no power of 2), fp32 [n_heads],
    as the JAX package's."""
    closest = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = base ** np.arange(1, closest + 1, dtype=np.float32)
    if closest != n_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        extra = extra_base ** np.arange(1, 2 * (n_heads - closest) + 1, 2, dtype=np.float32)
        slopes = np.concatenate([slopes, extra])
    return slopes.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _alibi_slopes_on(n_heads: int, device: torch.device):
    """``alibi_slopes`` as an fp32 tensor on ``device``, copied once."""
    return torch.as_tensor(alibi_slopes(n_heads), device=device)


def _rope_freqs_uncached(c: TransformerConfig, rot: int, seq_len: Optional[int],
                         device: torch.device):
    inv_freq, attn_factor = rope_params(c, rot, seq_len)
    return torch.as_tensor(inv_freq, device=device), attn_factor


_rope_freqs_cached = functools.lru_cache(maxsize=64)(_rope_freqs_uncached)


def _rope_freqs(c: TransformerConfig, rot: int, seq_len: Optional[int], device: torch.device):
    """``rope_params`` as a tensor on ``device``, built once per (config,
    rot, seq_len, device): a step's RoPE calls then copy nothing from the
    host (``seq_len`` is None unless the scaling depends on it). A config
    that cannot be hashed (lists inside ``rope_scaling``) builds them per
    call."""
    try:
        return _rope_freqs_cached(c, rot, seq_len, device)
    except TypeError:
        return _rope_freqs_uncached(c, rot, seq_len, device)


def _rope(x, positions, c: TransformerConfig, seq_len: Optional[int] = None):
    """Rotary embedding on [b, h, s, d] given positions [b, s] or [s]
    (rope_frac < 1: only the first frac*d dims rotate)."""
    d = x.shape[-1]
    frac = c.rope_frac
    rot = d if frac >= 1.0 else (int(d * frac) // 2) * 2
    tail = None
    if rot < d:
        x, tail = x[..., :rot], x[..., rot:]
    seq_dependent = c.rope_scaling is not None and dict(c.rope_scaling)["rope_type"] in (
        "dynamic", "longrope")
    freqs, attn_factor = _rope_freqs(c, rot, seq_len if seq_dependent else None, x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # [b, s, rot/2]
    cos = torch.cos(angles)[:, None] * attn_factor  # [b, 1, s, rot/2]
    sin = torch.sin(angles)[:, None] * attn_factor
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = out.to(tail.dtype if tail is not None else x.dtype)
    return out if tail is None else torch.cat([out, tail], dim=-1)


def _scale_embed(x, c: TransformerConfig, dtype):
    """gemma sqrt(h) embedding normalizer, rounded to the model dtype before
    the multiply (as HF does)."""
    if not c.embed_scale:
        return x
    # a 0-dim CPU tensor enters a device op as a scalar (no host-to-device copy)
    return x * torch.tensor(math.sqrt(c.hidden_size), dtype=dtype)


def _proj(c: TransformerConfig, x, w):
    """Layer projection honoring ``matmul_precision``: "default" is ``x @
    w``; "int8", "int8_tensor" and "fp8" run the forward on quantized
    operands and the backward as the exact wide vjp (``ops/qmatmul.py``)."""
    if c.matmul_precision == "default":
        return x @ w
    from deepspeed_tpu_torch.ops.qmatmul import qmatmul

    return qmatmul(x, w, c.matmul_precision)


def qk_norm_apply(c: TransformerConfig, x, w, head_axis: int, b=None):
    """q/k normalization over head_dim (qwen3 rmsnorm, phi affine
    layernorm, stablelm-2 per-head layernorm), plain torch."""
    if c.qk_norm_kind == "rmsnorm":
        return rms_norm_reference(x, w, c.norm_eps)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + c.norm_eps)
    if c.qk_norm_kind == "layernorm":
        y = y * w.float()
        if b is not None:
            y = y + b.float()
        return y.to(x.dtype)
    shape = [1] * x.ndim
    shape[head_axis] = w.shape[0]
    shape[-1] = w.shape[1]
    return (y * w.float().reshape(shape)).to(x.dtype)


def _activation(c: TransformerConfig, up, gate=None):
    F = torch.nn.functional
    if c.activation in ("swiglu", "geglu"):
        return (F.gelu(gate, approximate="tanh") if c.activation == "geglu" else F.silu(gate)) * up
    if c.activation == "relu":
        return F.relu(up)
    if c.activation == "quick_gelu":
        return up * torch.sigmoid(1.702 * up)
    return F.gelu(up, approximate="none" if c.activation == "gelu_exact" else "tanh")


def _mlp_block(c: TransformerConfig, lp, x):
    """The dense MLP, or with ``n_experts`` the MoE block
    (``parallel.moe.moe_mlp``: x [b, s, h] or the engine's [t, h]);
    returns (out, aux_loss) like the JAX package's."""
    if c.n_experts > 0:
        from deepspeed_tpu_torch.parallel.moe import moe_mlp

        return moe_mlp(c, lp, x)
    up = _proj(c, x, lp["w_up"])
    if c.mlp_bias:
        up = up + lp["w_up_b"]
    gate = None
    if c.activation in ("swiglu", "geglu"):
        gate = _proj(c, x, lp["w_gate"])
        if c.mlp_bias:
            gate = gate + lp["w_gate_b"]
    out = _proj(c, _activation(c, up, gate), lp["w_down"])
    if c.mlp_bias:
        out = out + lp["w_down_b"]
    return out, 0.0


def _embed_norm(params, c: TransformerConfig, x):
    """bloom word_embeddings_layernorm applied to the embedding output."""
    return _norm(x, params["embed_norm"], params["embed_norm_b"], "layernorm", c.norm_eps)


def _dequant_tree(lp, dtype):
    """Weight-only quantized inference: ``QuantizedWeight`` leaves of one
    layer's params (a dict, or one leaf) widen to ``dtype`` here, as the
    layer runs, so the wide copy is one layer's weights, never the model's."""
    if not isinstance(lp, dict):
        return maybe_dequantize(lp, dtype)
    if not any(isinstance(w, QuantizedWeight) for w in lp.values()):
        return lp
    return {k: maybe_dequantize(w, dtype) for k, w in lp.items()}


def _lm_head_matrix(params, config: TransformerConfig, dtype):
    if config.tie_embeddings:
        return params["embed"].to(dtype).t()
    return _dequant_tree(params["lm_head"], dtype)


def _apply_lm_head(params, x, config: TransformerConfig):
    w = _lm_head_matrix(params, config, x.dtype)
    if w.dtype != x.dtype:
        # the JAX package's matmul promotes mixed dtypes; torch's refuses them
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    logits = x @ w
    if config.lm_head_bias and not config.tie_embeddings:
        logits = logits + params["lm_head_b"].to(logits.dtype)
    return logits


def embed_tokens(params, tokens, positions, config: TransformerConfig, token_type_ids=None):
    """Token (+ learned position, + token type) embedding at the model
    dtype, the stem shared by ``forward`` and the engine's steps. With
    ``type_vocab_size`` the type embedding of ``token_type_ids`` (type 0
    when omitted, HF's default) is added before BLOOM's embedding norm."""
    c = config
    dtype = DTYPES[c.dtype]
    x = _scale_embed(params["embed"].to(dtype)[tokens.long()], c, dtype)
    if c.position == "learned":
        x = x + params["pos_embed"][positions.long().clamp(0, c.max_seq_len - 1)]
    if c.type_vocab_size > 0:
        te = params["type_embed"].to(x.dtype)
        x = x + (te[0] if token_type_ids is None else te[torch.as_tensor(token_type_ids).long()])
    if c.embed_norm:
        x = _embed_norm(params, c, x)
    return x


# ---------------------------------------------------------------------------
# forward: the training path and the plain oracle
# ---------------------------------------------------------------------------
def _attention_schedule(c: TransformerConfig, s: int):
    """The splash schedule a layer hands ``attention``: the attn_sparsity
    layout's, or with attention_impl="splash" and a ``splash_block`` the
    (causal, window) mask's at that block; else None (the seam derives one
    at its default block)."""
    if c.attn_sparsity is not None:
        return _sparsity_schedule(c.attn_sparsity, c.n_heads, s, c.splash_block, c.attn_causal)
    if c.attention_impl == "splash" and c.splash_block:
        from deepspeed_tpu_torch.ops.attention.core import _derived_splash_schedule

        return _derived_splash_schedule(s, s, c.attn_causal, c.sliding_window, c.splash_block)
    return None


def _attention_impl(c: TransformerConfig):
    """The layer's ``attention`` impl: "auto" becomes "flash_ring" on a
    topology whose context axis is above 1, and the ring's refusals (the
    JAX package's) raise here."""
    from deepspeed_tpu_torch.parallel.topology import get_topology

    topo = get_topology()
    impl = c.attention_impl
    if impl == "auto" and topo.context_parallel_size > 1:
        impl = "flash_ring"
    if impl == "flash_ring":
        if topo.sequence_parallel_size > 1:
            raise NotImplementedError(
                "ring context parallelism combined with sequence parallelism (Ulysses within "
                "a context shard) is not ported yet (ROADMAP queue 1, item 6)")
        if not c.attn_causal:
            raise NotImplementedError(
                "ring context parallelism is causal-only (the ring schedule streams the "
                "causal triangle)")
        if c.sliding_window:
            raise NotImplementedError(
                "sliding_window under ring context parallelism is not supported (band masks "
                "are global-position)")
    return impl


def _seq_len(c: TransformerConfig, s: int) -> int:
    """The sequence length RoPE sees: the global one. In the process form
    of a context ring the model holds s / N tokens of it."""
    from deepspeed_tpu_torch.parallel.topology import get_topology

    topo = get_topology()
    return s * topo.context_parallel_size if topo.distributed else s


def _cached_attention(c: TransformerConfig, q, k, v, kv_cache, local_flag):
    """The cached-decode branch of the JAX package's attention block: the
    new block's K/V written into the contiguous cache at its fill length
    (in place; the start clamps so the block fits, as
    ``dynamic_update_slice`` does), then attention over the whole cache
    with a dense bias: causal against global positions and bounded by the
    fill (query i at clen + i sees keys at positions <= clen + i), plus the
    window band (off for a global layer: ``local_flag`` 0), plus ALiBi's
    ``slope_h * key_position`` over the cache's positions. The flash
    kernels take no bias, and the JAX package's auto rule sends such a call
    to its plain reference, so this calls ``mha_reference`` on every
    device, as the v2 engine's dense decode does. Returns (out, new fill
    length)."""
    from deepspeed_tpu_torch.ops.attention.core import NEG_INF, window_too_far

    ck, cv, clen = kv_cache  # [b, nkv, S, d] x 2, a Python int
    s, S = q.shape[2], ck.shape[2]
    at = max(0, min(int(clen), S - s))
    ck[:, :, at : at + s] = k.to(ck.dtype)
    cv[:, :, at : at + s] = v.to(cv.dtype)
    q_glob = int(clen) + torch.arange(s, device=q.device)
    kpos = torch.arange(S, device=q.device)
    bias = torch.where(kpos[None, :] <= q_glob[:, None], 0.0, NEG_INF).float()
    if c.sliding_window > 0:
        far = window_too_far(q_glob[:, None], kpos[None, :], c.sliding_window, local_flag)
        bias = bias + torch.where(far, NEG_INF, 0.0).float()
    bias = bias[None, None]
    if c.position == "alibi":
        bias = bias + alibi_bias(_alibi_slopes_on(c.n_heads, q.device), kpos, S, q.device)
    out = mha_reference(q, ck, cv, causal=False, bias=bias, scale=c.attn_scale)
    return out, int(clen) + s


def _attention_block(c: TransformerConfig, lp, x, positions, segment_ids=None,
                     window_flag=None, reference=False, kv_cache=None):
    """Self-attention for one layer. x: [b, s, h]. ``reference`` takes the
    plain ``mha_reference`` (with attn_sparsity, the splash kernels' plain
    forward over the layout's schedule); otherwise
    ``attention(impl=c.attention_impl, schedule=...)``. ``kv_cache`` =
    (k [b, nkv, S, d], v, fill length): the cached decode
    (``_cached_attention``); returns (out, new fill length) then."""
    b, s, _ = x.shape
    impl = None if (reference or kv_cache is not None) else _attention_impl(c)
    nh, nkv, d = c.n_heads, c.kv_heads, c.head_dim
    q = _proj(c, x, lp["wq"])
    k = _proj(c, x, lp["wk"])
    v = _proj(c, x, lp["wv"])
    if c.attn_qkv_bias:
        q, k, v = q + lp["wq_b"], k + lp["wk_b"], v + lp["wv_b"]
    q = q.reshape(b, s, nh, d).transpose(1, 2)
    k = k.reshape(b, s, nkv, d).transpose(1, 2)
    v = v.reshape(b, s, nkv, d).transpose(1, 2)
    if c.qk_norm:
        q = qk_norm_apply(c, q, lp["q_norm"], head_axis=1, b=lp.get("q_norm_b"))
        k = qk_norm_apply(c, k, lp["k_norm"], head_axis=1, b=lp.get("k_norm_b"))
    if c.position == "rope":
        # the live sequence length (HF's max(position_ids)+1): in a cached
        # decode the cache's fill plus this block
        live = int(kv_cache[2]) + s if kv_cache is not None else _seq_len(c, s)
        q = _rope(q, positions, c, live)
        k = _rope(k, positions, c, live)
    if kv_cache is not None:
        out, clen = _cached_attention(c, q, k, v, kv_cache, window_flag)
        out = _proj(c, out.transpose(1, 2).reshape(b, s, nh * d), lp["wo"])
        if c.attn_out_bias:
            out = out + lp["wo_b"]
        return out, clen
    kw = dict(causal=c.attn_causal, segment_ids=segment_ids, scale=c.attn_scale,
              window=c.sliding_window, window_flag=window_flag)
    if c.position == "alibi":
        # the rank-1 form rides the flash kernels' ALiBi form (slope *
        # key_position added in the kernel), causal as in the JAX package;
        # the config refuses a window or a scale beside it
        kw = dict(causal=True, segment_ids=segment_ids,
                  alibi_slopes=_alibi_slopes_on(nh, q.device),
                  alibi_positions=positions)
        out = mha_reference(q, k, v, **kw) if reference else attention(q, k, v, impl=impl, **kw)
    elif reference and c.attn_sparsity is not None:
        from deepspeed_tpu_torch.ops.sparse_attention.splash import splash_fwd_reference

        out = splash_fwd_reference(q, k, v, _attention_schedule(c, s), segment_ids=segment_ids,
                                   scale=c.attn_scale)[0]
    elif reference:
        out = mha_reference(q, k, v, **kw)
    else:
        out = attention(q, k, v, impl=impl, schedule=_attention_schedule(c, s), **kw)
    out = _proj(c, out.transpose(1, 2).reshape(b, s, nh * d), lp["wo"])
    if c.attn_out_bias:
        out = out + lp["wo_b"]
    return out


def _layer(c: TransformerConfig, lp, x, positions, segment_ids=None, local_flag=None,
           reference=False):
    """One decoder layer on [b, s, h]; returns (x, aux_loss). Floating
    weights are cast to the compute dtype first, so wider params (fp32
    masters) never promote the residual stream."""
    dt = DTYPES[c.dtype]
    lp = _dequant_tree(lp, dt)
    lp = {k: w.to(dt) if w.is_floating_point() and w.dtype != dt else w for k, w in lp.items()}
    rms = rms_norm_reference if reference else rms_norm

    def norm(y, name):
        return _norm(y, lp[name], lp.get(name + "_b"), c.norm, c.norm_eps, rms=rms)

    def attn(y):
        return _attention_block(c, lp, y, positions, segment_ids, local_flag, reference)

    if c.norm_scheme == "post":
        x = norm(x + attn(x), "attn_norm")
        mlp_out, aux = _mlp_block(c, lp, x)
        return norm(x + mlp_out, "mlp_norm"), aux
    attn_out = attn(norm(x, "attn_norm"))
    if c.parallel_block:
        mlp_out, aux = _mlp_block(c, lp, norm(x, "mlp_norm"))
        return x + attn_out + mlp_out, aux
    x = x + attn_out
    mlp_out, aux = _mlp_block(c, lp, norm(x, "mlp_norm"))
    return x + mlp_out, aux


def _streamer(params, c: TransformerConfig):
    """The engine's weight streamer when this model streams and the params
    are its own, else None."""
    if not c.weight_stream:
        return None
    st = active_streamer()
    return st if st is not None and st.owns_layers(params.get("layers", {})) else None


def _stream_top(params, c: TransformerConfig):
    """The params with the streamed 2-D leaves (embeddings, the LM head)
    staged to the device; the stacked layers stay on the host, staged a
    layer at a time by ``forward_hidden``."""
    st = _streamer(params, c)
    if st is None:
        return params
    return {k: st.whole(v) for k, v in params.items()}


# The JAX package's remat policies (``remat_policy``), cheapest memory
# first. The port's forms:
#   * "nothing": the layer under ``torch.utils.checkpoint``, only its input
#     kept; the backward runs it again;
#   * "flash" / "flash_qkv": as "nothing", but the flash forward's out and
#     lse of the first pass are kept and handed to the recompute
#     (``ops.attention.flash.flash_stash``), so the backward never launches
#     the flash forward kernel again. The JAX package saves the roped q/k/v
#     too under "flash_qkv", sparing the projections' recompute; torch's
#     checkpoint re-runs the layer's code either way, so "flash_qkv" is
#     "flash" here (same memory, same recompute);
#   * "dots_with_no_batch_dims" / "dots": selective checkpointing that keeps
#     the outputs of the matrix products without (``aten.mm``,
#     ``aten.addmm``) or also with (``aten.bmm``, ``aten.baddbmm``) batch
#     dims and recomputes the rest;
#   * "everything": nothing recomputed (the layer runs as with remat off).
# A policy changes memory and recompute, never values.
REMAT_POLICIES = ("nothing", "flash", "flash_qkv", "dots_with_no_batch_dims", "dots",
                  "everything")


def remat_policy(name: str) -> str:
    """Check a remat policy name (``REMAT_POLICIES``); an unknown one
    raises ValueError, as in the JAX package."""
    if name not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {sorted(REMAT_POLICIES)}, got {name!r}")
    return name


def _dot_saver(batched: bool):
    """Selective-checkpoint contexts that keep the matrix products'
    outputs (with batch dims too when ``batched``) and recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    aten = torch.ops.aten
    keep = {aten.mm.default, aten.addmm.default}
    if batched:
        keep |= {aten.bmm.default, aten.baddbmm.default}

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in keep else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _remat_layer(policy: str, layer, x):
    """One layer ``layer(x) -> (x, aux)`` under the remat policy."""
    checkpoint = functools.partial(torch.utils.checkpoint.checkpoint, use_reentrant=False)
    if policy == "everything":
        return layer(x)
    if policy in ("dots", "dots_with_no_batch_dims"):
        return checkpoint(layer, x, context_fn=_dot_saver(policy == "dots"))
    if policy == "nothing":
        return checkpoint(layer, x)
    from deepspeed_tpu_torch.ops.attention.flash import FlashStash, flash_stash

    stash = FlashStash()

    def run(y):
        stash.rewind()
        with flash_stash(stash):
            return layer(y)

    out = checkpoint(run, x)
    stash.replay = True  # the recompute takes the first pass's out and lse
    return out


def forward_hidden(params: Dict[str, Any], tokens, config: TransformerConfig, positions=None,
                   segment_ids=None, token_type_ids=None, reference: bool = False):
    """Body forward: tokens [b, s] -> (final-norm'd hidden [b, s, h],
    aux_loss: the MoE layers' load-balancing losses summed, 0.0 without
    MoE). ``positions`` [s] or [b, s] (default arange), ``segment_ids``
    [b, s] for packed sequences, ``token_type_ids`` [b, s] (BERT; type 0
    when omitted). With ``config.remat``, when autograd records, each layer
    runs under ``config.remat_policy`` (``REMAT_POLICIES``; an unknown name
    raises ValueError whenever remat is on). ``reference`` selects the plain
    oracle path (see ``forward_reference``)."""
    c = config
    if c.remat:
        remat_policy(c.remat_policy)
    remat = c.remat and not reference and torch.is_grad_enabled()
    tokens = torch.as_tensor(tokens)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device, dtype=torch.int32)
    st = _streamer(params, c)
    params = _stream_top(params, c)
    x = embed_tokens(params, tokens, positions, c, token_type_ids=token_type_ids)
    # one unbind per stacked weight: its backward stacks the L layer grads
    # once, where indexing w[li] would give every layer's grad a full [L, ...]
    # zero buffer to add into (a quantized weight is sliced per layer);
    # streamed weights are staged a layer at a time instead
    streamed = st.layers if st is not None else {}
    stacked = {k: w.unbind(0) if isinstance(w, torch.Tensor) else w
               for k, w in params["layers"].items() if k not in streamed}
    aux_total = 0.0
    for li in range(c.n_layers):
        lp = {k: w[li] for k, w in stacked.items()}
        flag = None if c.attn_layer_pattern is None else int(c.attn_layer_pattern[li])
        kw = dict(positions=positions, segment_ids=segment_ids, local_flag=flag,
                  reference=reference)
        if st is None:
            layer = functools.partial(_layer, c, lp, **kw)
        else:
            # the device copy is taken inside the (remat'd) layer, so the
            # backward's recompute takes it again instead of keeping it; the
            # copies run outside: here, and in the backward from a hook on
            # the layer's output (before the recompute)
            st.ahead(li)
            layer = functools.partial(_streamed_layer, st, li, c, lp, streamed, **kw)
        x, aux = _remat_layer(c.remat_policy, layer, x) if remat else layer(x)
        if st is not None:
            st.layer_done(li)
            if remat:
                x.register_hook(st.backward_hook(li))
        aux_total = aux_total + aux
    if c.final_norm:
        x = _norm(x, params["final_norm"], params.get("final_norm_b"), c.norm, c.norm_eps,
                  rms=rms_norm_reference if reference else rms_norm)
    return x, aux_total


def _streamed_layer(st, li, c, lp, host_layer, x, **kw):
    """``_layer`` over ``lp`` (the unstreamed slices) and layer ``li``'s
    streamed slices of ``host_layer``, staged by ``st``."""
    return _layer(c, {**lp, **st.layer(li, host_layer)}, x, **kw)


def _mlm_transform(params, x, c: TransformerConfig):
    """BertForMaskedLM's cls.predictions transform: dense + the config's
    activation + LayerNorm (the tied decoder and its vocabulary bias
    follow)."""
    t = x @ params["mlm_dense"].to(x.dtype) + params["mlm_dense_b"].to(x.dtype)
    F = torch.nn.functional
    t = F.relu(t) if c.activation == "relu" else F.gelu(
        t, approximate="none" if c.activation == "gelu_exact" else "tanh")
    return _norm(t, params["mlm_norm"], params["mlm_norm_b"], "layernorm", c.norm_eps)


def _head(params, x, c: TransformerConfig):
    """Hidden -> logits: the LM head, or with ``mlm_head`` the MLM
    transform, the tied decoder and the vocabulary bias."""
    if c.mlm_head:
        return (_apply_lm_head(params, _mlm_transform(params, x, c), c)
                + params["mlm_bias"].to(x.dtype))
    return _apply_lm_head(params, x, c)


def forward(params: Dict[str, Any], tokens, config: TransformerConfig, positions=None,
            segment_ids=None, token_type_ids=None) -> Tuple[torch.Tensor, Any]:
    """Full forward: tokens [b, s] -> (logits [b, s, vocab], aux_loss),
    through ``attention`` and ``rms_norm`` (the kernels on a card)."""
    params = _stream_top(params, config)
    x, aux = forward_hidden(params, tokens, config, positions, segment_ids, token_type_ids)
    return _head(params, x, config), aux


def forward_reference(params: Dict[str, Any], tokens, config: TransformerConfig,
                      positions=None, segment_ids=None,
                      token_type_ids=None) -> Tuple[torch.Tensor, Any]:
    """The plain oracle: ``forward``'s function with ``mha_reference`` and
    ``rms_norm_reference`` on any device, never a kernel, and no remat.
    Differentiable, so its autograd gradients are the reference of the
    kernel path's."""
    params = _stream_top(params, config)
    x, aux = forward_hidden(params, tokens, config, positions, segment_ids, token_type_ids,
                            reference=True)
    return _head(params, x, config), aux


# ---------------------------------------------------------------------------
# cached decode (the v1 inference engine's path)
# ---------------------------------------------------------------------------
def decode_step(params, tokens, config: TransformerConfig, kv_caches, positions):
    """One decode step with contiguous KV caches, the JAX package's
    ``decode_step``: tokens [b, t] new tokens at ``positions`` [b, t];
    ``kv_caches`` = ``init_kv_cache``'s (k, v, lens), written in place.
    Returns (logits [b, t, vocab], new caches). Pre-norm layers (with
    ``parallel_block``), ``embed_norm`` and the per-layer window of
    ``attn_layer_pattern`` as in the JAX package; norms through
    ``rms_norm`` (the kernel on a card), attention through ``mha_reference``
    with a dense bias, on a card too."""
    c = config
    if not c.attn_causal:
        raise ValueError(
            "decode_step: bidirectional encoder models (attn_causal=False) "
            "do not autoregressively decode — call forward() instead"
        )
    tokens = torch.as_tensor(tokens)
    dt = DTYPES[c.dtype]
    ck, cv, lens = kv_caches
    x = embed_tokens(params, tokens, positions, c)
    new_lens = lens.clone()
    for li in range(c.n_layers):
        lp = _dequant_tree({k: w[li] for k, w in params["layers"].items()}, dt)
        lp = {k: w.to(dt) if w.is_floating_point() and w.dtype != dt else w
              for k, w in lp.items()}
        flag = None if c.attn_layer_pattern is None else int(c.attn_layer_pattern[li])
        a = _norm(x, lp["attn_norm"], lp.get("attn_norm_b"), c.norm, c.norm_eps)
        attn_out, new_lens[li] = _attention_block(
            c, lp, a, positions, window_flag=flag, kv_cache=(ck[li], cv[li], int(lens[li])))
        if c.parallel_block:
            m = _norm(x, lp["mlp_norm"], lp.get("mlp_norm_b"), c.norm, c.norm_eps)
            x = x + attn_out + _mlp_block(c, lp, m)[0]
            continue
        x = x + attn_out
        m = _norm(x, lp["mlp_norm"], lp.get("mlp_norm_b"), c.norm, c.norm_eps)
        x = x + _mlp_block(c, lp, m)[0]
    if c.final_norm:
        x = _norm(x, params["final_norm"], params.get("final_norm_b"), c.norm, c.norm_eps)
    return _apply_lm_head(params, x, c), (ck, cv, new_lens)


def init_kv_cache(config: TransformerConfig, batch: int, max_len: int, device="cuda"):
    """Stacked per-layer KV caches for ``decode_step``: k and v [L, batch,
    kv_heads, max_len, head_dim] at the model dtype on ``device``, and the
    fill lengths [L] as an int32 CPU tensor (host values: the step writes at
    them without a device read)."""
    c = config
    shape = (c.n_layers, batch, c.kv_heads, max_len, c.head_dim)
    dt = DTYPES[c.dtype]
    return (torch.zeros(shape, dtype=dt, device=device),
            torch.zeros(shape, dtype=dt, device=device),
            torch.zeros((c.n_layers,), dtype=torch.int32))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def split_lm_batch(batch):
    """Normalize a causal-LM batch dict to (inputs, labels, loss_mask,
    positions, segment_ids); labels default to shifted input_ids."""
    tokens = batch["input_ids"]
    labels = batch.get("labels")
    mask = batch.get("loss_mask")
    if labels is None:
        labels = tokens[:, 1:]
        inputs = tokens[:, :-1]
        if mask is not None and mask.shape[1] == tokens.shape[1]:
            mask = mask[:, 1:]  # align with shifted labels
    else:
        inputs = tokens
    return inputs, labels, mask, batch.get("positions"), batch.get("segment_ids")


def _masked_nll(logits, labels, mask):
    """Shared CE core: fp32 NLL -> (sum_loss, count), as label logit minus
    an fp32 logsumexp."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ll = picked.float() - lse
    mask = mask.float()
    return (-ll * mask).sum(), mask.sum()


def nll_loss(logits, labels, mask=None):
    """Masked next-token NLL from full logits."""
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=logits.device)
    total, count = _masked_nll(logits, labels, mask)
    return total / count.clamp_min(1.0)


def lm_head_loss(params, x, labels, mask, config: TransformerConfig, aux=None):
    """Final norm -> logits -> masked NLL (+ the MoE aux loss times its
    coefficient): the model's head."""
    c = config
    x = _norm(x, params["final_norm"], params.get("final_norm_b"), c.norm, c.norm_eps)
    loss = nll_loss(_apply_lm_head(params, x, c), labels, mask)
    if c.n_experts > 0 and aux is not None:
        loss = loss + c.moe_aux_loss_coef * aux
    return loss


def _fused_ce_head_loss(params, x, labels, mask, config: TransformerConfig):
    """Fused head + CE over the flattened rows: hidden -> [n, h], rows
    padded to a multiple of 256 with zero mask (n is often 2^k - b: the
    label shift drops a position), per-row loss * mask / count."""
    from deepspeed_tpu_torch.ops.fused_ce import fused_ce_loss

    b, s, h = x.shape
    w = _lm_head_matrix(params, config, x.dtype)
    if w.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    m = mask.float() if mask is not None else torch.ones(
        labels.shape, dtype=torch.float32, device=x.device)
    n = b * s
    pad = (-n) % 256
    flat_x, flat_l, flat_m = x.reshape(n, h), labels.reshape(-1), m.reshape(-1)
    if pad:
        flat_x = torch.cat([flat_x, flat_x.new_zeros((pad, h))])
        flat_l = torch.cat([flat_l, flat_l.new_zeros((pad,))])
        flat_m = torch.cat([flat_m, flat_m.new_zeros((pad,))])
    per_row = fused_ce_loss(flat_x, w, flat_l)
    return (per_row * flat_m).sum() / flat_m.sum().clamp_min(1.0)


def make_loss_fn(config: TransformerConfig):
    """Causal-LM loss over a batch dict {'input_ids': [b, s] (, 'labels',
    'loss_mask', 'segment_ids', 'positions')} of tensors. The engine's
    ``loss_fn(params, batch)`` contract. Three heads, as in the JAX
    package: ``fused_ce`` (the fused head + CE kernels on a card, their
    plain versions on the CPU: the JAX branch also asks for a TPU, the port
    takes it on any device), ``loss_tiles > 1`` (the tiled logits loss),
    else the dense head over full logits. A biased head, and the MLM head
    (its transform is in no fused kernel), fall through to the dense path.
    With ``n_experts`` the layers' aux loss times ``moe_aux_loss_coef`` is
    added, as in the JAX package.

    On a topology that spans processes (``Topology.distributed``) the batch
    is this data rank's rows, split into inputs and labels first and then
    cut to this rank's context chunk (positions global), and the loss is
    this rank's share of the global masked mean: the local mean times the
    local token count over the count summed over data x context. Summed
    over those ranks, the losses and gradients are the global mean's."""
    fused = config.fused_ce and not config.lm_head_bias and not config.mlm_head
    tiled = config.loss_tiles > 1 and not config.lm_head_bias and not config.mlm_head

    def loss_fn(params, batch):
        inputs, labels, mask, positions, segment_ids = split_lm_batch(batch)
        from deepspeed_tpu_torch.parallel.topology import get_topology

        topo = get_topology()
        if not topo.distributed:
            return head_loss(params, inputs, labels, mask, positions, segment_ids)
        inputs, labels, mask, positions, segment_ids = _context_chunk(
            topo, inputs, labels, mask, positions, segment_ids)
        share = _global_share(topo, labels, mask)
        return head_loss(params, inputs, labels, mask, positions, segment_ids) * share

    def head_loss(params, inputs, labels, mask, positions, segment_ids):
        loss, aux = head_nll(params, inputs, labels, mask, positions, segment_ids)
        return loss + config.moe_aux_loss_coef * aux if config.n_experts > 0 else loss

    def head_nll(params, inputs, labels, mask, positions, segment_ids):
        params = _stream_top(params, config)
        if fused or tiled:
            x, aux = forward_hidden(params, inputs, config, positions=positions,
                                    segment_ids=segment_ids)
            if fused:
                return _fused_ce_head_loss(params, x, labels, mask, config), aux
            from deepspeed_tpu_torch.parallel.sequence.tiled import tiled_logits_loss

            w = _lm_head_matrix(params, config, x.dtype)
            if w.dtype != x.dtype:
                dt = torch.promote_types(x.dtype, w.dtype)
                x, w = x.to(dt), w.to(dt)
            return tiled_logits_loss(_masked_nll, x, w, labels, num_tiles=config.loss_tiles,
                                     mask=mask), aux
        logits, aux = forward(params, inputs, config, positions=positions,
                              segment_ids=segment_ids)
        return nll_loss(logits, labels, mask), aux

    loss_fn.model_config = config
    return loss_fn


def _context_chunk(topo, inputs, labels, mask, positions, segment_ids):
    """This rank's chunk of a [b, s] batch along the context axis, with
    global positions (the given ones cut, or the chunk's arange)."""
    from deepspeed_tpu_torch.parallel.topology import CONTEXT_AXIS

    n = topo.context_parallel_size
    b, s = inputs.shape
    if n == 1:
        return inputs, labels, mask, positions, segment_ids
    if s % n:
        raise ValueError(f"make_loss_fn: sequence {s} does not divide over context {n}")
    sc = s // n
    lo = topo.axis_index(CONTEXT_AXIS) * sc

    def cut(t):
        return None if t is None else t[..., lo:lo + sc]

    if positions is None:
        positions = torch.arange(lo, lo + sc, device=inputs.device, dtype=torch.int32)
    else:
        positions = cut(positions)
    return cut(inputs), cut(labels), cut(mask), positions, cut(segment_ids)


def _global_share(topo, labels, mask):
    """Local token count over the count summed over data x context (0
    when no rank has a token): the factor that turns this rank's masked
    mean into its share of the global one."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.topology import PORTED_AXES

    count = (mask.float().sum() if mask is not None else
             torch.tensor(float(labels.numel()), device=labels.device))
    total = comm.all_reduce(count.clone(), axis=PORTED_AXES)
    return count / total.clamp_min(1.0)


def num_params(params) -> int:
    """Parameters of a tree (a quantized weight counts its wide shape)."""
    n = 0
    for v in params.values():
        n += num_params(v) if isinstance(v, dict) else math.prod(v.shape)
    return n


def flops_per_token(config: TransformerConfig, seq_len: Optional[int] = None) -> float:
    """Approximate training FLOPs per token (6ND rule + attention term), the
    JAX package's formula."""
    c = config
    s = seq_len or c.max_seq_len
    n_dense = (
        c.hidden_size * (c.n_heads + 2 * c.kv_heads) * c.head_dim  # qkv
        + c.n_heads * c.head_dim * c.hidden_size  # out proj
        + c.hidden_size * c.ffn_dim * (3 if c.activation in ("swiglu", "geglu") else 2)
    ) * c.n_layers + c.vocab_size * c.hidden_size
    attn = 2 * c.n_layers * s * c.hidden_size
    return 6.0 * (n_dense + attn / 2)
