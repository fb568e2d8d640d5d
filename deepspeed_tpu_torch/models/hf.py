"""HF checkpoint import into the port: per-architecture loaders -> the model family.

Counterpart of ``deepspeed_tpu/models/hf.py``: a HuggingFace checkpoint
directory becomes a (:class:`TransformerConfig`, params) pair in the port's
layout (``models/convert.py``: the JAX package's nested dict, layer weights
stacked on a leading ``[n_layers]`` dim, projections ``[in, out]``), as
torch tensors on ``device``, which trains through ``initialize`` and serves
through both inference engines unchanged.

Supported ``model_type``s are the JAX package's: llama, mistral, qwen2,
qwen2_moe, qwen3, qwen3_moe, mixtral, falcon (both layouts), phi, phi3,
gpt2, gpt_neo, opt, gemma, bloom, gptj, gpt_neox, internlm, stablelm,
starcoder2, megatron_gpt, bert, distilbert and clip_text_model, with the
same config translation (scaled RoPE through ``rope_scaling``, sliding
windows through ``sliding_window`` / ``attn_layer_pattern``) and the same
weight mapping:
  * HF Linear stores ``[out, in]``, the model ``[in, out]``: every
    projection is transposed;
  * layers are stacked along a leading ``[n_layers]`` dim;
  * HF's ``rotate_half`` is the model's half-split RoPE, so q/k map 1:1;
    gptj's interleaved rotary is permuted into it at load time;
  * falcon, bloom, gpt_neox and megatron_gpt fuse q/k/v per kv group and
    are de-interleaved.

The weights are read by ``models/safetensors_io.py`` (no ``safetensors``
package); each is moved to ``device`` as stored and cast there, so a bf16
checkpoint stays bf16 and no fp32 copy of it is made. No module here
imports ``transformers``: a config is a ``config.json`` dict or any object
with the same attributes.
"""

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.models.safetensors_io import load_state_dict as _load_state_dict
from deepspeed_tpu_torch.models.transformer import DTYPES, TransformerConfig
from deepspeed_tpu_torch.utils.logging import logger


def _getter(hf_cfg) -> Callable:
    return (lambda k, d=None: hf_cfg.get(k, d)) if isinstance(hf_cfg, dict) else (
        lambda k, d=None: getattr(hf_cfg, k, d)
    )


# ---------------------------------------------------------------------------
# per-arch config translation
# ---------------------------------------------------------------------------
def rope_scaling_from_hf(scaling, original_max_position_embeddings=None):
    """HF ``rope_scaling`` dict -> the canonical hashable config form (the
    JAX package's ``transformer.rope_scaling_from_hf``).

    Returns None for absent/default scaling. ``original_max_position_
    embeddings`` is the TOP-LEVEL HF config field (phi3 longrope keeps the
    pretraining length there, not in the dict); when given it is folded
    into the canonical dict so one structure carries all parameters.
    """
    if not scaling:
        return None
    if not isinstance(scaling, dict):
        raise ValueError(f"unsupported rope_scaling={scaling!r} (expected a dict)")
    kind = scaling.get("rope_type", scaling.get("type", "default"))
    if kind == "default":
        return None
    if kind not in ("linear", "dynamic", "yarn", "longrope", "llama3"):
        raise ValueError(
            f"unsupported rope_scaling type {kind!r}; supported: "
            "linear, dynamic, yarn, longrope, llama3"
        )
    out = {"rope_type": kind}
    for k, v in scaling.items():
        if k in ("rope_type", "type"):
            continue
        out[k] = tuple(float(x) for x in v) if isinstance(v, (list, tuple)) else v
    if kind == "longrope" and original_max_position_embeddings:
        # the top-level field wins (HF ignores any in-dict copy here)
        out["original_max_position_embeddings"] = int(original_max_position_embeddings)
    return tuple(sorted(out.items()))


def _parse_rope_scaling(get):
    """HF rope_scaling → the canonical hashable config form (llama3 / yarn /
    longrope / linear / dynamic — transformer.rope_params implements the
    math). Unknown types still fail fast: silently building plain-theta RoPE
    would load without error and produce wrong logits."""
    return rope_scaling_from_hf(
        get("rope_scaling", None), get("original_max_position_embeddings", None)
    )


def _llama_like_config(get, **extra) -> TransformerConfig:
    base = dict(
        rope_scaling=_parse_rope_scaling(get),
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        n_layers=get("num_hidden_layers"),
        n_heads=get("num_attention_heads"),
        n_kv_heads=get("num_key_value_heads", None),
        ffn_hidden_size=get("intermediate_size"),
        max_seq_len=get("max_position_embeddings", 2048),
        norm="rmsnorm",
        activation="swiglu",
        position="rope",
        rope_theta=float(get("rope_theta", 10000.0)),
        norm_eps=float(get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(get("tie_word_embeddings", False)),
    )
    base.update(extra)
    return TransformerConfig(**base)


def config_from_hf(hf_cfg) -> TransformerConfig:
    """HF config (object or dict) → TransformerConfig; dispatches on
    ``model_type`` (llama when absent)."""
    get = _getter(hf_cfg)
    mt = get("model_type", "llama")
    if mt in ("llama", "mistral"):
        head_dim = get("head_dim", None)
        derived = get("hidden_size") // get("num_attention_heads")
        override = int(head_dim) if head_dim is not None and int(head_dim) != derived else None
        bias = bool(get("attention_bias", False))
        # mistral sliding_window (None on v0.2+ checkpoints → full attention)
        window = int(get("sliding_window", None) or 0) if mt == "mistral" else 0
        if window >= get("max_position_embeddings", 2048):
            window = 0  # window beyond the position range is full attention
        return _llama_like_config(
            get, head_dim_override=override, attn_qkv_bias=bias,
            attn_out_bias=bias, sliding_window=window,
        )
    if mt == "internlm":
        # InternLM is llama + biased attention projections (reference
        # module_inject/containers/internlm.py). `bias` covers q/k/v AND o
        # (HF InternLM passes one flag to all four Linears). internlm2's
        # fused-wqkv export is not supported.
        bias = bool(get("bias", True))
        return _llama_like_config(get, attn_qkv_bias=bias, attn_out_bias=bias)
    if mt == "qwen2":
        return _llama_like_config(get, attn_qkv_bias=True)
    if mt == "qwen3":
        # qwen2 minus qkv bias, plus per-head q/k RMSNorm and a decoupled
        # head_dim (always 128 regardless of hidden/heads)
        head_dim = get("head_dim", None)
        derived = get("hidden_size") // get("num_attention_heads")
        return _llama_like_config(
            get,
            qk_norm=True,
            head_dim_override=int(head_dim) if head_dim is not None and int(head_dim) != derived else None,
        )
    if mt == "qwen3_moe":
        sparse_step = get("decoder_sparse_step", 1)
        mlp_only = get("mlp_only_layers", []) or []
        if sparse_step != 1 or mlp_only:
            raise ValueError(
                f"qwen3_moe: decoder_sparse_step={sparse_step}, mlp_only_layers="
                f"{mlp_only} — only uniform MoE stacks are supported"
            )
        head_dim = get("head_dim", None)
        derived = get("hidden_size") // get("num_attention_heads")
        return _llama_like_config(
            get,
            qk_norm=True,
            head_dim_override=int(head_dim) if head_dim is not None and int(head_dim) != derived else None,
            ffn_hidden_size=get("moe_intermediate_size"),
            n_experts=get("num_experts"),
            moe_top_k=get("num_experts_per_tok"),
            moe_norm_topk_prob=bool(get("norm_topk_prob", True)),
            # drop-free (HF semantics) — same capacity stance as qwen2_moe
            moe_capacity_factor=float(get("num_experts")) / float(get("num_experts_per_tok")),
            moe_aux_loss_coef=float(get("router_aux_loss_coef", 0.001)),
        )
    if mt == "qwen2_moe":
        sparse_step = get("decoder_sparse_step", 1)
        mlp_only = get("mlp_only_layers", []) or []
        if sparse_step != 1 or mlp_only:
            # the scan layout wants uniform layers; mixed dense/MoE stacks
            # would need a per-layer dispatch — fail with the real reason
            raise ValueError(
                f"qwen2_moe: decoder_sparse_step={sparse_step}, mlp_only_layers="
                f"{mlp_only} — only uniform MoE stacks are supported"
            )
        logger.warning(
            "qwen2_moe import sets moe_capacity_factor=E/k (drop-free, HF "
            "semantics): the dense dispatch/combine einsums are O(tokens² · "
            "experts · hidden) at this bound — for long-sequence training "
            "lower capacity_factor (accepting drops) or expect high memory"
        )
        return _llama_like_config(
            get,
            attn_qkv_bias=True,
            ffn_hidden_size=get("moe_intermediate_size"),
            n_experts=get("num_experts"),
            moe_top_k=get("num_experts_per_tok"),
            moe_norm_topk_prob=bool(get("norm_topk_prob", False)),
            # HF qwen2-moe never drops tokens. capacity = ceil(t·k·cf/E), and
            # a token contributes at most ONE slot per expert, so cf = E/k
            # gives capacity = t — the minimal drop-free bound (all tokens on
            # one expert). Dense dispatch is still O(t·E·t) at this bound;
            # lower cf (accepting drops) for long-sequence training runs.
            moe_capacity_factor=float(get("num_experts")) / float(get("num_experts_per_tok")),
            moe_shared_expert_dim=get("shared_expert_intermediate_size", 0) or 0,
            moe_aux_loss_coef=float(get("router_aux_loss_coef", 0.001)),
        )
    if mt == "mixtral":
        return _llama_like_config(
            get,
            ffn_hidden_size=get("intermediate_size"),
            n_experts=get("num_local_experts"),
            moe_top_k=get("num_experts_per_tok"),
            # HF mixtral ALWAYS renormalizes the top-k routing weights
            moe_norm_topk_prob=True,
            # dropless (HF never drops): cf = E/k gives capacity = tokens,
            # the minimal drop-free bound — same stance as qwen2_moe above
            moe_capacity_factor=float(get("num_local_experts")) / float(get("num_experts_per_tok")),
            moe_aux_loss_coef=float(get("router_aux_loss_coef", 0.001)),
        )
    if mt == "stablelm":
        return TransformerConfig(
            qk_norm=bool(get("qk_layernorm", False)),
            qk_norm_kind="layernorm_per_head",
            vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            n_layers=get("num_hidden_layers"),
            n_heads=get("num_attention_heads"),
            n_kv_heads=get("num_key_value_heads", None),
            ffn_hidden_size=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 4096),
            norm="layernorm",
            activation="swiglu",  # silu-gated MLP under LayerNorm
            position="rope",
            rope_theta=float(get("rope_theta", 10000.0)),
            rope_scaling=_parse_rope_scaling(get),
            rope_frac=float(get("partial_rotary_factor", 0.25)),
            norm_eps=float(get("layer_norm_eps", 1e-5)),
            tie_embeddings=bool(get("tie_word_embeddings", False)),
            attn_qkv_bias=bool(get("use_qkv_bias", False)),
            # parallel residual shares input_layernorm across both branches
            parallel_block=bool(get("use_parallel_residual", False)),
        )
    if mt == "starcoder2":
        act = get("hidden_act", "gelu_pytorch_tanh")
        act_map = {"gelu_pytorch_tanh": "gelu", "gelu_new": "gelu", "gelu": "gelu_exact"}
        if act not in act_map:
            raise ValueError(f"starcoder2: hidden_act={act!r} is not supported")
        bias = bool(get("use_bias", True))
        max_seq = get("max_position_embeddings", 4096)
        # released starcoder2 sets sliding_window=4096 with a 16k position
        # range — native banded masking (sliding_window) keeps the full range
        window = int(get("sliding_window", None) or 0)
        if window >= max_seq:
            window = 0
        return TransformerConfig(
            vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            n_layers=get("num_hidden_layers"),
            n_heads=get("num_attention_heads"),
            n_kv_heads=get("num_key_value_heads", None),
            ffn_hidden_size=get("intermediate_size"),
            max_seq_len=max_seq,
            norm="layernorm",
            activation=act_map[act],
            position="rope",
            rope_theta=float(get("rope_theta", 10000.0)),
            rope_scaling=_parse_rope_scaling(get),
            norm_eps=float(get("norm_epsilon", 1e-5)),
            tie_embeddings=bool(get("tie_word_embeddings", True)),
            attn_qkv_bias=bias,
            attn_out_bias=bias,
            mlp_bias=bias,
            sliding_window=window,
        )
    if mt == "gpt_neo":
        h = get("hidden_size")
        act = get("activation_function", "gelu_new")
        if act not in ("gelu_new", "gelu_pytorch_tanh"):
            raise ValueError(f"gpt_neo: activation_function={act!r} is not supported (gelu_new only)")
        n_layers = get("num_layers")
        # expand attention_types ([[types, repeat], ...]) the way
        # GPTNeoConfig.expand_attention_types_params does
        pattern: list = []
        for types, rep in get("attention_types", [[["global"], n_layers]]):
            for _ in range(rep):
                pattern.extend(types)
        if len(pattern) != n_layers:
            raise ValueError(
                f"gpt_neo: attention_types expands to {len(pattern)} layers, "
                f"config has {n_layers}"
            )
        bad = sorted(set(pattern) - {"global", "local"})
        if bad:
            raise ValueError(f"gpt_neo: unknown attention type(s) {bad}")
        any_local = "local" in pattern
        return TransformerConfig(
            vocab_size=get("vocab_size"),
            hidden_size=h,
            n_layers=n_layers,
            n_heads=get("num_heads"),
            ffn_hidden_size=get("intermediate_size", None) or 4 * h,
            max_seq_len=get("max_position_embeddings", 2048),
            norm="layernorm",
            activation="gelu",  # gelu_new = tanh approx
            position="learned",
            norm_eps=float(get("layer_norm_epsilon", 1e-5)),
            tie_embeddings=True,
            # q/k/v Linears carry no bias; out_proj and the MLP do
            attn_out_bias=True,
            mlp_bias=True,
            # GPTNeoSelfAttention never scales the logits by 1/sqrt(d)
            attn_scale=1.0,
            sliding_window=int(get("window_size", 256)) if any_local else 0,
            attn_layer_pattern=tuple(int(t == "local") for t in pattern) if any_local else None,
        )
    if mt == "clip_text_model":
        # CLIP's text encoder (reference module_inject/containers/clip.py —
        # the stable-diffusion text tower): causal pre-LN encoder, learned
        # positions, quick_gelu MLP, final LN, NO lm head (use
        # forward_hidden for features; tie_embeddings avoids a head param).
        act_map = {"quick_gelu": "quick_gelu", "gelu": "gelu_exact",
                   "gelu_new": "gelu", "gelu_pytorch_tanh": "gelu"}
        act = get("hidden_act", "quick_gelu")
        if act not in act_map:
            raise ValueError(f"clip_text_model: hidden_act={act!r} is not supported")
        return TransformerConfig(
            vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            n_layers=get("num_hidden_layers"),
            n_heads=get("num_attention_heads"),
            ffn_hidden_size=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 77),
            norm="layernorm",
            activation=act_map[act],
            position="learned",
            norm_eps=float(get("layer_norm_eps", 1e-5)),
            tie_embeddings=True,  # no lm head: features come from forward_hidden
            attn_qkv_bias=True,
            attn_out_bias=True,
            mlp_bias=True,
        )
    if mt == "bert":
        act_map = {"gelu": "gelu_exact", "gelu_new": "gelu", "gelu_pytorch_tanh": "gelu", "relu": "relu"}
        act = get("hidden_act", "gelu")
        if act not in act_map:
            raise ValueError(f"bert: hidden_act={act!r} is not supported")
        return TransformerConfig(
            vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            n_layers=get("num_hidden_layers"),
            n_heads=get("num_attention_heads"),
            ffn_hidden_size=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 512),
            norm="layernorm",
            activation=act_map[act],
            position="learned",
            norm_eps=float(get("layer_norm_eps", 1e-12)),
            tie_embeddings=True,  # cls.predictions.decoder ties to embeddings
            attn_qkv_bias=True,
            attn_out_bias=True,
            mlp_bias=True,
            attn_causal=False,
            norm_scheme="post",
            embed_norm=True,  # embeddings.LayerNorm after word+pos+type sum
            type_vocab_size=get("type_vocab_size", 2),
            final_norm=False,
            mlm_head=True,
        )
    if mt == "distilbert":
        if get("sinusoidal_pos_embds", False):
            raise ValueError("distilbert: sinusoidal_pos_embds is not supported (learned only)")
        act_map = {"gelu": "gelu_exact", "relu": "relu"}
        act = get("activation", "gelu")
        if act not in act_map:
            raise ValueError(f"distilbert: activation={act!r} is not supported")
        return TransformerConfig(
            vocab_size=get("vocab_size"),
            hidden_size=get("dim"),
            n_layers=get("n_layers"),
            n_heads=get("n_heads"),
            ffn_hidden_size=get("hidden_dim"),
            max_seq_len=get("max_position_embeddings", 512),
            norm="layernorm",
            activation=act_map[act],
            position="learned",
            norm_eps=1e-12,  # hardcoded in HF modeling_distilbert
            tie_embeddings=True,  # vocab_projector ties to embeddings
            attn_qkv_bias=True,
            attn_out_bias=True,
            mlp_bias=True,
            attn_causal=False,
            norm_scheme="post",
            embed_norm=True,
            final_norm=False,
            mlm_head=True,
        )
    if mt == "megatron_gpt":
        # Megatron-LM GPT checkpoints (reference module_inject/containers/
        # megatron_gpt.py): gpt2-architecture model, megatron state-dict
        # naming with per-head-interleaved fused query_key_value
        h = get("hidden_size") or get("n_embd")
        act = get("activation_function", "gelu_new")
        act_map = {"gelu_new": "gelu", "gelu_pytorch_tanh": "gelu", "gelu": "gelu_exact"}
        if act not in act_map:
            raise ValueError(f"megatron_gpt: activation_function={act!r} is not supported")
        return TransformerConfig(
            vocab_size=get("vocab_size"),
            hidden_size=h,
            n_layers=get("num_layers") or get("num_hidden_layers") or get("n_layer"),
            n_heads=get("num_attention_heads") or get("n_head"),
            ffn_hidden_size=get("ffn_hidden_size", None) or 4 * h,
            max_seq_len=get("max_position_embeddings") or get("n_positions") or 1024,
            norm="layernorm",
            activation=act_map[act],
            position="learned",
            norm_eps=float(get("layernorm_epsilon", 1e-5)),
            tie_embeddings=True,  # megatron GPT always ties the output head
            attn_qkv_bias=True,
            attn_out_bias=True,
            mlp_bias=True,
        )
    if mt == "falcon":
        if get("alibi", False):
            raise ValueError("falcon: alibi position encoding is not supported (rope checkpoints only)")
        nh = get("num_attention_heads")
        if get("new_decoder_architecture", False):
            n_kv = get("num_kv_heads", nh)
        else:
            n_kv = 1 if get("multi_query", True) else nh
        return TransformerConfig(
            vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            n_layers=get("num_hidden_layers"),
            n_heads=nh,
            n_kv_heads=n_kv,
            ffn_hidden_size=get("ffn_hidden_size", None) or 4 * get("hidden_size"),
            max_seq_len=get("max_position_embeddings", 2048),
            norm="layernorm",
            activation="gelu_exact",  # falcon's MLP is torch nn.GELU (erf)
            position="rope",
            rope_theta=float(get("rope_theta", 10000.0)),
            rope_scaling=_parse_rope_scaling(get),
            norm_eps=float(get("layer_norm_epsilon", 1e-5)),
            tie_embeddings=bool(get("tie_word_embeddings", True)),
            parallel_block=bool(get("parallel_attn", True)),
            attn_qkv_bias=bool(get("bias", False)),
            attn_out_bias=bool(get("bias", False)),
            mlp_bias=bool(get("bias", False)),
        )
    if mt == "phi":
        act = get("hidden_act", "gelu_new")
        if act not in ("gelu_new", "gelu_pytorch_tanh"):
            # a 'gelu' (erf) checkpoint would silently load with tanh GELU
            raise ValueError(f"phi: hidden_act={act!r} is not supported (gelu_new only)")
        return TransformerConfig(
            vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            n_layers=get("num_hidden_layers"),
            n_heads=get("num_attention_heads"),
            n_kv_heads=get("num_key_value_heads", None),
            ffn_hidden_size=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 2048),
            norm="layernorm",
            activation="gelu",
            position="rope",
            rope_theta=float(get("rope_theta", 10000.0)),
            rope_scaling=_parse_rope_scaling(get),
            norm_eps=float(get("layer_norm_eps", 1e-5)),
            tie_embeddings=bool(get("tie_word_embeddings", False)),
            parallel_block=True,
            attn_qkv_bias=True,
            attn_out_bias=True,
            mlp_bias=True,
            lm_head_bias=True,
            rope_frac=float(get("partial_rotary_factor", 0.5)),
            # phi-1/2 qk_layernorm: one affine LayerNorm(head_dim) shared
            # across heads
            qk_norm=bool(get("qk_layernorm", False)),
            qk_norm_kind="layernorm",
        )
    if mt == "phi3":
        return _llama_like_config(get)
    if mt == "gpt2":
        h = get("n_embd")
        act = get("activation_function", "gelu_new")
        if act not in ("gelu_new", "gelu_pytorch_tanh"):
            raise ValueError(f"gpt2: activation_function={act!r} is not supported (gelu_new only)")
        return TransformerConfig(
            vocab_size=get("vocab_size"),
            hidden_size=h,
            n_layers=get("n_layer"),
            n_heads=get("n_head"),
            ffn_hidden_size=get("n_inner", None) or 4 * h,
            max_seq_len=get("n_positions", 1024),
            norm="layernorm",
            activation="gelu",  # gpt2 gelu_new = tanh approx
            position="learned",
            norm_eps=float(get("layer_norm_epsilon", 1e-5)),
            tie_embeddings=True,
            attn_qkv_bias=True,
            attn_out_bias=True,
            mlp_bias=True,
        )
    if mt == "opt":
        h = get("hidden_size")
        if get("word_embed_proj_dim", h) != h:
            raise ValueError(
                "opt: word_embed_proj_dim != hidden_size (opt-350m-style "
                "embedding projection) is not supported"
            )
        if not get("do_layer_norm_before", True):
            raise ValueError("opt: post-layernorm (do_layer_norm_before=False) is not supported")
        # model_type "opt" covers relu (OPT) and gelu (Galactica) variants —
        # read the config instead of assuming, or gelu checkpoints would
        # silently run through relu
        act_map = {"relu": "relu", "gelu": "gelu_exact", "gelu_new": "gelu"}
        act = get("activation_function", "relu")
        if act not in act_map:
            raise ValueError(f"opt: activation_function={act!r} is not supported")
        return TransformerConfig(
            vocab_size=get("vocab_size"),
            hidden_size=h,
            n_layers=get("num_hidden_layers"),
            n_heads=get("num_attention_heads"),
            ffn_hidden_size=get("ffn_dim"),
            max_seq_len=get("max_position_embeddings", 2048),
            norm="layernorm",
            activation=act_map[act],
            position="learned",
            norm_eps=1e-5,
            tie_embeddings=bool(get("tie_word_embeddings", True)),
            attn_qkv_bias=True,
            attn_out_bias=True,
            mlp_bias=True,
        )
    if mt == "gemma":
        act = get("hidden_activation", None) or get("hidden_act", "gelu_pytorch_tanh")
        if act != "gelu_pytorch_tanh":
            # "gelu" would mean HF's EXACT erf GELU; geglu here is tanh —
            # reject rather than silently diverge (gpt2 loader does the same)
            raise ValueError(f"gemma: hidden_activation={act!r} is not supported (gelu_pytorch_tanh only)")
        head_dim = get("head_dim", 256)
        derived = get("hidden_size") // get("num_attention_heads")
        return _llama_like_config(
            get,
            norm="rmsnorm_1p",  # zero-centered (1 + w) weights
            activation="geglu",  # gelu-gated MLP
            embed_scale=True,  # sqrt(h) embedding normalizer
            tie_embeddings=True,  # gemma always ties
            head_dim_override=int(head_dim) if int(head_dim) != derived else None,
        )
    if mt == "bloom":
        h = get("hidden_size") or get("n_embed")
        return TransformerConfig(
            vocab_size=get("vocab_size"),
            hidden_size=h,
            n_layers=get("n_layer") or get("num_hidden_layers"),
            n_heads=get("n_head") or get("num_attention_heads"),
            ffn_hidden_size=4 * h,
            max_seq_len=get("seq_length", 2048) or 2048,
            norm="layernorm",
            activation="gelu",  # BloomGelu is the tanh approximation
            position="alibi",
            norm_eps=float(get("layer_norm_epsilon", 1e-5)),
            tie_embeddings=True,  # bloom always ties lm_head to embeddings
            embed_norm=True,  # word_embeddings_layernorm
            attn_qkv_bias=True,
            attn_out_bias=True,
            mlp_bias=True,
        )
    if mt == "gptj":
        h = get("n_embd")
        act = get("activation_function", "gelu_new")
        if act not in ("gelu_new", "gelu_pytorch_tanh"):
            raise ValueError(f"gptj: activation_function={act!r} is not supported (gelu_new only)")
        d = h // get("n_head")
        rotary_dim = get("rotary_dim", None) or d
        return TransformerConfig(
            vocab_size=get("vocab_size"),
            hidden_size=h,
            n_layers=get("n_layer"),
            n_heads=get("n_head"),
            ffn_hidden_size=get("n_inner", None) or 4 * h,
            max_seq_len=get("n_positions", 2048),
            norm="layernorm",
            activation="gelu",
            position="rope",
            # gptj's interleaved (rotate_every_two) rotary becomes the native
            # half-split convention via a load-time column permutation of
            # wq/wk (_gptj_layer) — the score q·k is permutation-invariant
            rope_frac=rotary_dim / d,
            norm_eps=float(get("layer_norm_epsilon", 1e-5)),
            tie_embeddings=False,
            parallel_block=True,  # shared ln_1 feeds both branches
            mlp_bias=True,
            lm_head_bias=True,  # GPTJForCausalLM's lm_head carries a bias
        )
    if mt == "gpt_neox":
        act = get("hidden_act", "gelu")
        act_map = {
            # HF ACT2FN: "gelu" is the ERF form; the others are tanh approx
            "gelu": "gelu_exact",
            "gelu_new": "gelu",
            "gelu_fast": "gelu",
            "gelu_pytorch_tanh": "gelu",
        }
        if act not in act_map:
            raise ValueError(f"gpt_neox: hidden_act={act!r} is not supported")
        return TransformerConfig(
            vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            n_layers=get("num_hidden_layers"),
            n_heads=get("num_attention_heads"),
            ffn_hidden_size=get("intermediate_size"),
            max_seq_len=get("max_position_embeddings", 2048),
            norm="layernorm",
            activation=act_map[act],
            position="rope",
            rope_theta=float(get("rope_theta", None) or get("rotary_emb_base", 10000.0)),
            rope_scaling=_parse_rope_scaling(get),
            rope_frac=float(get("rotary_pct", 1.0)),
            norm_eps=float(get("layer_norm_eps", 1e-5)),
            tie_embeddings=bool(get("tie_word_embeddings", False)),
            parallel_block=bool(get("use_parallel_residual", True)),
            attn_qkv_bias=bool(get("attention_bias", True)),
            attn_out_bias=bool(get("attention_bias", True)),
            mlp_bias=True,
        )
    raise ValueError(
        f"unsupported model_type {mt!r}; supported: llama, mistral, qwen2, "
        "qwen2_moe, mixtral, falcon, phi, phi3, gpt2, gpt_neo, opt, gemma, "
        "bloom, gptj, gpt_neox, internlm, stablelm, starcoder2, "
        "qwen3, qwen3_moe, megatron_gpt, bert, distilbert, clip_text_model"
    )


# ---------------------------------------------------------------------------
# per-arch weight extraction
# ---------------------------------------------------------------------------
class _Taker:
    """State-dict accessor: each tensor is popped, moved to the device as
    stored and cast there; ``linear`` gives the ``[out, in]`` -> ``[in, out]``
    view."""

    def __init__(self, state: Dict[str, Any], dtype: str, device):
        self.state = state
        self.dtype = DTYPES[dtype]
        self.device = torch.device(device)

    def __call__(self, name) -> torch.Tensor:
        return self.state.pop(name).to(self.device).to(self.dtype)

    def linear(self, name) -> torch.Tensor:
        return self(name).T


def _llama_layer(take: _Taker, cfg: TransformerConfig, p: str, layers: Dict[str, list]):
    layers["attn_norm"].append(take(f"{p}.input_layernorm.weight"))
    layers["wq"].append(take.linear(f"{p}.self_attn.q_proj.weight"))
    layers["wk"].append(take.linear(f"{p}.self_attn.k_proj.weight"))
    layers["wv"].append(take.linear(f"{p}.self_attn.v_proj.weight"))
    layers["wo"].append(take.linear(f"{p}.self_attn.o_proj.weight"))
    layers["mlp_norm"].append(take(f"{p}.post_attention_layernorm.weight"))
    if cfg.attn_qkv_bias:
        layers["wq_b"].append(take(f"{p}.self_attn.q_proj.bias"))
        layers["wk_b"].append(take(f"{p}.self_attn.k_proj.bias"))
        layers["wv_b"].append(take(f"{p}.self_attn.v_proj.bias"))
    if cfg.attn_out_bias:
        layers["wo_b"].append(take(f"{p}.self_attn.o_proj.bias"))
    if cfg.qk_norm:
        layers["q_norm"].append(take(f"{p}.self_attn.q_norm.weight"))
        layers["k_norm"].append(take(f"{p}.self_attn.k_norm.weight"))
    if cfg.n_experts > 0:
        # qwen2-moe: router gate [E, h] + per-expert FFNs + shared expert
        layers["router"].append(take.linear(f"{p}.mlp.gate.weight"))
        for name, hf in (("w_gate", "gate_proj"), ("w_up", "up_proj"), ("w_down", "down_proj")):
            layers[name].append(
                torch.stack([take.linear(f"{p}.mlp.experts.{e}.{hf}.weight") for e in range(cfg.n_experts)])
            )
        if cfg.moe_shared_expert_dim > 0:
            layers["shared_gate"].append(take.linear(f"{p}.mlp.shared_expert.gate_proj.weight"))
            layers["shared_up"].append(take.linear(f"{p}.mlp.shared_expert.up_proj.weight"))
            layers["shared_down"].append(take.linear(f"{p}.mlp.shared_expert.down_proj.weight"))
            layers["shared_gate_proj"].append(take.linear(f"{p}.mlp.shared_expert_gate.weight"))
    else:
        layers["w_gate"].append(take.linear(f"{p}.mlp.gate_proj.weight"))
        layers["w_up"].append(take.linear(f"{p}.mlp.up_proj.weight"))
        layers["w_down"].append(take.linear(f"{p}.mlp.down_proj.weight"))


def _phi3_layer(take: _Taker, cfg: TransformerConfig, p: str, layers: Dict[str, list]):
    # phi-3 fuses qkv_proj [q;k;v] and gate_up_proj [gate;up] — split rows
    layers["attn_norm"].append(take(f"{p}.input_layernorm.weight"))
    qkv = take(f"{p}.self_attn.qkv_proj.weight")  # [(nh+2*nkv)*d, h]
    q_rows = cfg.n_heads * cfg.head_dim
    kv_rows = cfg.kv_heads * cfg.head_dim
    layers["wq"].append(qkv[:q_rows].T)
    layers["wk"].append(qkv[q_rows : q_rows + kv_rows].T)
    layers["wv"].append(qkv[q_rows + kv_rows :].T)
    layers["wo"].append(take.linear(f"{p}.self_attn.o_proj.weight"))
    layers["mlp_norm"].append(take(f"{p}.post_attention_layernorm.weight"))
    gate_up = take(f"{p}.mlp.gate_up_proj.weight")  # [2*ffn, h]
    ffn = gate_up.shape[0] // 2
    layers["w_gate"].append(gate_up[:ffn].T)
    layers["w_up"].append(gate_up[ffn:].T)
    layers["w_down"].append(take.linear(f"{p}.mlp.down_proj.weight"))


def _split_falcon_qkv(fused: torch.Tensor, cfg: TransformerConfig) -> Tuple[torch.Tensor, ...]:
    """De-interleave falcon's fused query_key_value rows.

    Every falcon layout is the per-kv-group interleave
    [q·(nh/nkv), k, v] — HF's legacy ``_split_heads`` views are its
    degenerate cases: MHA is group-of-3 per head (view ``(nh, 3, d)``) and
    multi_query is nkv=1 (all q rows, then k, then v). fused: [rows, h]
    (or [rows] for the bias). Returns (q, k, v) row-major.
    """
    d, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.kv_heads
    group = nh // nkv + 2
    blocks = fused.reshape(nkv, group, d, *fused.shape[1:])
    q = blocks[:, :-2].reshape(nh * d, *fused.shape[1:])
    k = blocks[:, -2].reshape(nkv * d, *fused.shape[1:])
    v = blocks[:, -1].reshape(nkv * d, *fused.shape[1:])
    return q, k, v


def _falcon_layer(take: _Taker, cfg: TransformerConfig, p: str, layers: Dict[str, list]):
    if f"{p}.ln_attn.weight" in take.state:  # new_decoder_architecture
        layers["attn_norm"].append(take(f"{p}.ln_attn.weight"))
        layers["attn_norm_b"].append(take(f"{p}.ln_attn.bias"))
        layers["mlp_norm"].append(take(f"{p}.ln_mlp.weight"))
        layers["mlp_norm_b"].append(take(f"{p}.ln_mlp.bias"))
    else:
        ln_w = take(f"{p}.input_layernorm.weight")
        ln_b = take(f"{p}.input_layernorm.bias")
        layers["attn_norm"].append(ln_w)
        layers["attn_norm_b"].append(ln_b)
        if cfg.parallel_block:
            # falcon-7b shares one norm across both branches
            layers["mlp_norm"].append(ln_w)
            layers["mlp_norm_b"].append(ln_b)
        else:
            layers["mlp_norm"].append(take(f"{p}.post_attention_layernorm.weight"))
            layers["mlp_norm_b"].append(take(f"{p}.post_attention_layernorm.bias"))
    q, k, v = _split_falcon_qkv(take(f"{p}.self_attention.query_key_value.weight"), cfg)
    layers["wq"].append(q.T)
    layers["wk"].append(k.T)
    layers["wv"].append(v.T)
    layers["wo"].append(take.linear(f"{p}.self_attention.dense.weight"))
    layers["w_up"].append(take.linear(f"{p}.mlp.dense_h_to_4h.weight"))
    layers["w_down"].append(take.linear(f"{p}.mlp.dense_4h_to_h.weight"))
    if cfg.attn_qkv_bias:
        qb, kb, vb = _split_falcon_qkv(take(f"{p}.self_attention.query_key_value.bias"), cfg)
        layers["wq_b"].append(qb)
        layers["wk_b"].append(kb)
        layers["wv_b"].append(vb)
        layers["wo_b"].append(take(f"{p}.self_attention.dense.bias"))
        layers["w_up_b"].append(take(f"{p}.mlp.dense_h_to_4h.bias"))
        layers["w_down_b"].append(take(f"{p}.mlp.dense_4h_to_h.bias"))


def _phi_layer(take: _Taker, cfg: TransformerConfig, p: str, layers: Dict[str, list]):
    # phi: one shared input_layernorm feeds both parallel branches
    ln_w = take(f"{p}.input_layernorm.weight")
    ln_b = take(f"{p}.input_layernorm.bias")
    layers["attn_norm"].append(ln_w)
    layers["attn_norm_b"].append(ln_b)
    layers["mlp_norm"].append(ln_w)
    layers["mlp_norm_b"].append(ln_b)
    for name, hf in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj")):
        layers[name].append(take.linear(f"{p}.self_attn.{hf}.weight"))
        layers[f"{name}_b"].append(take(f"{p}.self_attn.{hf}.bias"))
    layers["wo"].append(take.linear(f"{p}.self_attn.dense.weight"))
    layers["wo_b"].append(take(f"{p}.self_attn.dense.bias"))
    if cfg.qk_norm:
        layers["q_norm"].append(take(f"{p}.self_attn.q_layernorm.weight"))
        layers["q_norm_b"].append(take(f"{p}.self_attn.q_layernorm.bias"))
        layers["k_norm"].append(take(f"{p}.self_attn.k_layernorm.weight"))
        layers["k_norm_b"].append(take(f"{p}.self_attn.k_layernorm.bias"))
    layers["w_up"].append(take.linear(f"{p}.mlp.fc1.weight"))
    layers["w_up_b"].append(take(f"{p}.mlp.fc1.bias"))
    layers["w_down"].append(take.linear(f"{p}.mlp.fc2.weight"))
    layers["w_down_b"].append(take(f"{p}.mlp.fc2.bias"))


def _gpt2_layer(take: _Taker, cfg: TransformerConfig, p: str, layers: Dict[str, list]):
    # GPT-2 Conv1D stores [in, out] — NO transpose; c_attn fuses qkv columns
    layers["attn_norm"].append(take(f"{p}.ln_1.weight"))
    layers["attn_norm_b"].append(take(f"{p}.ln_1.bias"))
    h = cfg.hidden_size
    w = take(f"{p}.attn.c_attn.weight")  # [h, 3h]
    b = take(f"{p}.attn.c_attn.bias")  # [3h]
    layers["wq"].append(w[:, :h])
    layers["wk"].append(w[:, h : 2 * h])
    layers["wv"].append(w[:, 2 * h :])
    layers["wq_b"].append(b[:h])
    layers["wk_b"].append(b[h : 2 * h])
    layers["wv_b"].append(b[2 * h :])
    layers["wo"].append(take(f"{p}.attn.c_proj.weight"))
    layers["wo_b"].append(take(f"{p}.attn.c_proj.bias"))
    layers["mlp_norm"].append(take(f"{p}.ln_2.weight"))
    layers["mlp_norm_b"].append(take(f"{p}.ln_2.bias"))
    layers["w_up"].append(take(f"{p}.mlp.c_fc.weight"))
    layers["w_up_b"].append(take(f"{p}.mlp.c_fc.bias"))
    layers["w_down"].append(take(f"{p}.mlp.c_proj.weight"))
    layers["w_down_b"].append(take(f"{p}.mlp.c_proj.bias"))


def _opt_layer(take: _Taker, cfg: TransformerConfig, p: str, layers: Dict[str, list]):
    layers["attn_norm"].append(take(f"{p}.self_attn_layer_norm.weight"))
    layers["attn_norm_b"].append(take(f"{p}.self_attn_layer_norm.bias"))
    for name, hf in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj")):
        layers[name].append(take.linear(f"{p}.self_attn.{hf}.weight"))
        layers[f"{name}_b"].append(take(f"{p}.self_attn.{hf}.bias"))
    layers["wo"].append(take.linear(f"{p}.self_attn.out_proj.weight"))
    layers["wo_b"].append(take(f"{p}.self_attn.out_proj.bias"))
    layers["mlp_norm"].append(take(f"{p}.final_layer_norm.weight"))
    layers["mlp_norm_b"].append(take(f"{p}.final_layer_norm.bias"))
    layers["w_up"].append(take.linear(f"{p}.fc1.weight"))
    layers["w_up_b"].append(take(f"{p}.fc1.bias"))
    layers["w_down"].append(take.linear(f"{p}.fc2.weight"))
    layers["w_down_b"].append(take(f"{p}.fc2.bias"))


def _mixtral_layer(take: _Taker, cfg: TransformerConfig, p: str, layers: Dict[str, list]):
    # llama attention + block-sparse MoE: w1=gate, w3=up, w2=down
    layers["attn_norm"].append(take(f"{p}.input_layernorm.weight"))
    layers["wq"].append(take.linear(f"{p}.self_attn.q_proj.weight"))
    layers["wk"].append(take.linear(f"{p}.self_attn.k_proj.weight"))
    layers["wv"].append(take.linear(f"{p}.self_attn.v_proj.weight"))
    layers["wo"].append(take.linear(f"{p}.self_attn.o_proj.weight"))
    layers["mlp_norm"].append(take(f"{p}.post_attention_layernorm.weight"))
    layers["router"].append(take.linear(f"{p}.block_sparse_moe.gate.weight"))
    for name, hf in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2")):
        layers[name].append(
            torch.stack([
                take.linear(f"{p}.block_sparse_moe.experts.{e}.{hf}.weight")
                for e in range(cfg.n_experts)
            ])
        )


def _stablelm_layer(take: _Taker, cfg: TransformerConfig, p: str, layers: Dict[str, list]):
    ln_w = take(f"{p}.input_layernorm.weight")
    ln_b = take(f"{p}.input_layernorm.bias")
    layers["attn_norm"].append(ln_w)
    layers["attn_norm_b"].append(ln_b)
    if cfg.parallel_block:
        # parallel residual shares input_layernorm (gpt-j-style)
        layers["mlp_norm"].append(ln_w)
        layers["mlp_norm_b"].append(ln_b)
    else:
        layers["mlp_norm"].append(take(f"{p}.post_attention_layernorm.weight"))
        layers["mlp_norm_b"].append(take(f"{p}.post_attention_layernorm.bias"))
    for name, hf in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj")):
        layers[name].append(take.linear(f"{p}.self_attn.{hf}.weight"))
        if cfg.attn_qkv_bias:
            layers[f"{name}_b"].append(take(f"{p}.self_attn.{hf}.bias"))
    layers["wo"].append(take.linear(f"{p}.self_attn.o_proj.weight"))
    if cfg.qk_norm:
        # stablelm-2 qk_layernorm: a ModuleList of biasless per-head
        # LayerNorms — stack the [d] weights into [n_heads, d]
        layers["q_norm"].append(
            torch.stack([take(f"{p}.self_attn.q_layernorm.norms.{h}.weight") for h in range(cfg.n_heads)])
        )
        layers["k_norm"].append(
            torch.stack([take(f"{p}.self_attn.k_layernorm.norms.{h}.weight") for h in range(cfg.kv_heads)])
        )
    layers["w_gate"].append(take.linear(f"{p}.mlp.gate_proj.weight"))
    layers["w_up"].append(take.linear(f"{p}.mlp.up_proj.weight"))
    layers["w_down"].append(take.linear(f"{p}.mlp.down_proj.weight"))


def _starcoder2_layer(take: _Taker, cfg: TransformerConfig, p: str, layers: Dict[str, list]):
    layers["attn_norm"].append(take(f"{p}.input_layernorm.weight"))
    layers["attn_norm_b"].append(take(f"{p}.input_layernorm.bias"))
    layers["mlp_norm"].append(take(f"{p}.post_attention_layernorm.weight"))
    layers["mlp_norm_b"].append(take(f"{p}.post_attention_layernorm.bias"))
    for name, hf in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj")):
        layers[name].append(take.linear(f"{p}.self_attn.{hf}.weight"))
        if cfg.attn_qkv_bias:  # use_bias=False checkpoints ship no biases
            layers[f"{name}_b"].append(take(f"{p}.self_attn.{hf}.bias"))
    layers["wo"].append(take.linear(f"{p}.self_attn.o_proj.weight"))
    if cfg.attn_out_bias:
        layers["wo_b"].append(take(f"{p}.self_attn.o_proj.bias"))
    layers["w_up"].append(take.linear(f"{p}.mlp.c_fc.weight"))
    layers["w_down"].append(take.linear(f"{p}.mlp.c_proj.weight"))
    if cfg.mlp_bias:
        layers["w_up_b"].append(take(f"{p}.mlp.c_fc.bias"))
        layers["w_down_b"].append(take(f"{p}.mlp.c_proj.bias"))


def _bloom_layer(take: _Taker, cfg: TransformerConfig, p: str, layers: Dict[str, list]):
    # bloom: MHA with per-head [q,k,v] interleaved fused qkv — the falcon
    # MHA degenerate case (group-of-3 per head) splits it
    layers["attn_norm"].append(take(f"{p}.input_layernorm.weight"))
    layers["attn_norm_b"].append(take(f"{p}.input_layernorm.bias"))
    layers["mlp_norm"].append(take(f"{p}.post_attention_layernorm.weight"))
    layers["mlp_norm_b"].append(take(f"{p}.post_attention_layernorm.bias"))
    q, k, v = _split_falcon_qkv(take(f"{p}.self_attention.query_key_value.weight"), cfg)
    layers["wq"].append(q.T)
    layers["wk"].append(k.T)
    layers["wv"].append(v.T)
    qb, kb, vb = _split_falcon_qkv(take(f"{p}.self_attention.query_key_value.bias"), cfg)
    layers["wq_b"].append(qb)
    layers["wk_b"].append(kb)
    layers["wv_b"].append(vb)
    layers["wo"].append(take.linear(f"{p}.self_attention.dense.weight"))
    layers["wo_b"].append(take(f"{p}.self_attention.dense.bias"))
    layers["w_up"].append(take.linear(f"{p}.mlp.dense_h_to_4h.weight"))
    layers["w_up_b"].append(take(f"{p}.mlp.dense_h_to_4h.bias"))
    layers["w_down"].append(take.linear(f"{p}.mlp.dense_4h_to_h.weight"))
    layers["w_down_b"].append(take(f"{p}.mlp.dense_4h_to_h.bias"))


def _gptj_rope_perm(w: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Permute a [h, nh*d] projection's per-head rotary columns from gptj's
    interleaved (rotate_every_two) layout to the half-split layout: new
    column i ← old 2i, new rot/2+i ← old 2i+1. Scores are invariant because
    q and k get the SAME permutation."""
    d = cfg.head_dim
    rot = (int(d * cfg.rope_frac) // 2) * 2
    perm = torch.cat([torch.arange(0, rot, 2), torch.arange(1, rot, 2), torch.arange(rot, d)])
    cols = w.reshape(w.shape[0], cfg.n_heads, d)
    return cols[:, :, perm].reshape(w.shape)


def _gptj_layer(take: _Taker, cfg: TransformerConfig, p: str, layers: Dict[str, list]):
    ln_w = take(f"{p}.ln_1.weight")
    ln_b = take(f"{p}.ln_1.bias")
    layers["attn_norm"].append(ln_w)
    layers["attn_norm_b"].append(ln_b)
    layers["mlp_norm"].append(ln_w)  # shared norm feeds both parallel branches
    layers["mlp_norm_b"].append(ln_b)
    layers["wq"].append(_gptj_rope_perm(take.linear(f"{p}.attn.q_proj.weight"), cfg))
    layers["wk"].append(_gptj_rope_perm(take.linear(f"{p}.attn.k_proj.weight"), cfg))
    layers["wv"].append(take.linear(f"{p}.attn.v_proj.weight"))
    layers["wo"].append(take.linear(f"{p}.attn.out_proj.weight"))
    layers["w_up"].append(take.linear(f"{p}.mlp.fc_in.weight"))
    layers["w_up_b"].append(take(f"{p}.mlp.fc_in.bias"))
    layers["w_down"].append(take.linear(f"{p}.mlp.fc_out.weight"))
    layers["w_down_b"].append(take(f"{p}.mlp.fc_out.bias"))


def _clip_text_layer(take: _Taker, cfg: TransformerConfig, p: str, layers: Dict[str, list]):
    layers["attn_norm"].append(take(f"{p}.layer_norm1.weight"))
    layers["attn_norm_b"].append(take(f"{p}.layer_norm1.bias"))
    for name, hf in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj")):
        layers[name].append(take.linear(f"{p}.self_attn.{hf}.weight"))
        layers[f"{name}_b"].append(take(f"{p}.self_attn.{hf}.bias"))
    layers["wo"].append(take.linear(f"{p}.self_attn.out_proj.weight"))
    layers["wo_b"].append(take(f"{p}.self_attn.out_proj.bias"))
    layers["mlp_norm"].append(take(f"{p}.layer_norm2.weight"))
    layers["mlp_norm_b"].append(take(f"{p}.layer_norm2.bias"))
    layers["w_up"].append(take.linear(f"{p}.mlp.fc1.weight"))
    layers["w_up_b"].append(take(f"{p}.mlp.fc1.bias"))
    layers["w_down"].append(take.linear(f"{p}.mlp.fc2.weight"))
    layers["w_down_b"].append(take(f"{p}.mlp.fc2.bias"))


def _bert_layer(take: _Taker, cfg: TransformerConfig, p: str, layers: Dict[str, list]):
    # post-LN encoder: attention.output.LayerNorm normalizes x + attn(x)
    # (→ attn_norm), output.LayerNorm normalizes + mlp (→ mlp_norm)
    for name, hf in (("wq", "query"), ("wk", "key"), ("wv", "value")):
        layers[name].append(take.linear(f"{p}.attention.self.{hf}.weight"))
        layers[f"{name}_b"].append(take(f"{p}.attention.self.{hf}.bias"))
    layers["wo"].append(take.linear(f"{p}.attention.output.dense.weight"))
    layers["wo_b"].append(take(f"{p}.attention.output.dense.bias"))
    layers["attn_norm"].append(take(f"{p}.attention.output.LayerNorm.weight"))
    layers["attn_norm_b"].append(take(f"{p}.attention.output.LayerNorm.bias"))
    layers["w_up"].append(take.linear(f"{p}.intermediate.dense.weight"))
    layers["w_up_b"].append(take(f"{p}.intermediate.dense.bias"))
    layers["w_down"].append(take.linear(f"{p}.output.dense.weight"))
    layers["w_down_b"].append(take(f"{p}.output.dense.bias"))
    layers["mlp_norm"].append(take(f"{p}.output.LayerNorm.weight"))
    layers["mlp_norm_b"].append(take(f"{p}.output.LayerNorm.bias"))


def _distilbert_layer(take: _Taker, cfg: TransformerConfig, p: str, layers: Dict[str, list]):
    for name, hf in (("wq", "q_lin"), ("wk", "k_lin"), ("wv", "v_lin")):
        layers[name].append(take.linear(f"{p}.attention.{hf}.weight"))
        layers[f"{name}_b"].append(take(f"{p}.attention.{hf}.bias"))
    layers["wo"].append(take.linear(f"{p}.attention.out_lin.weight"))
    layers["wo_b"].append(take(f"{p}.attention.out_lin.bias"))
    layers["attn_norm"].append(take(f"{p}.sa_layer_norm.weight"))
    layers["attn_norm_b"].append(take(f"{p}.sa_layer_norm.bias"))
    layers["w_up"].append(take.linear(f"{p}.ffn.lin1.weight"))
    layers["w_up_b"].append(take(f"{p}.ffn.lin1.bias"))
    layers["w_down"].append(take.linear(f"{p}.ffn.lin2.weight"))
    layers["w_down_b"].append(take(f"{p}.ffn.lin2.bias"))
    layers["mlp_norm"].append(take(f"{p}.output_layer_norm.weight"))
    layers["mlp_norm_b"].append(take(f"{p}.output_layer_norm.bias"))


def _gptneo_layer(take: _Taker, cfg: TransformerConfig, p: str, layers: Dict[str, list]):
    # GPT-Neo uses plain Linears ([out, in] — transpose), unlike gpt2's
    # Conv1D; q/k/v carry NO bias, out_proj and the MLP do
    layers["attn_norm"].append(take(f"{p}.ln_1.weight"))
    layers["attn_norm_b"].append(take(f"{p}.ln_1.bias"))
    for name, hf in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj")):
        layers[name].append(take.linear(f"{p}.attn.attention.{hf}.weight"))
    layers["wo"].append(take.linear(f"{p}.attn.attention.out_proj.weight"))
    layers["wo_b"].append(take(f"{p}.attn.attention.out_proj.bias"))
    layers["mlp_norm"].append(take(f"{p}.ln_2.weight"))
    layers["mlp_norm_b"].append(take(f"{p}.ln_2.bias"))
    layers["w_up"].append(take.linear(f"{p}.mlp.c_fc.weight"))
    layers["w_up_b"].append(take(f"{p}.mlp.c_fc.bias"))
    layers["w_down"].append(take.linear(f"{p}.mlp.c_proj.weight"))
    layers["w_down_b"].append(take(f"{p}.mlp.c_proj.bias"))


def _megatron_gpt_layer(take: _Taker, cfg: TransformerConfig, p: str, layers: Dict[str, list]):
    # megatron fuses qkv per head ([q_h, k_h, v_h] blocks) — the falcon MHA
    # de-interleave (group-of-3 per head) recovers row-major q/k/v
    layers["attn_norm"].append(take(f"{p}.input_layernorm.weight"))
    layers["attn_norm_b"].append(take(f"{p}.input_layernorm.bias"))
    q, k, v = _split_falcon_qkv(take(f"{p}.attention.query_key_value.weight"), cfg)
    layers["wq"].append(q.T)
    layers["wk"].append(k.T)
    layers["wv"].append(v.T)
    qb, kb, vb = _split_falcon_qkv(take(f"{p}.attention.query_key_value.bias"), cfg)
    layers["wq_b"].append(qb)
    layers["wk_b"].append(kb)
    layers["wv_b"].append(vb)
    layers["wo"].append(take.linear(f"{p}.attention.dense.weight"))
    layers["wo_b"].append(take(f"{p}.attention.dense.bias"))
    layers["mlp_norm"].append(take(f"{p}.post_attention_layernorm.weight"))
    layers["mlp_norm_b"].append(take(f"{p}.post_attention_layernorm.bias"))
    layers["w_up"].append(take.linear(f"{p}.mlp.dense_h_to_4h.weight"))
    layers["w_up_b"].append(take(f"{p}.mlp.dense_h_to_4h.bias"))
    layers["w_down"].append(take.linear(f"{p}.mlp.dense_4h_to_h.weight"))
    layers["w_down_b"].append(take(f"{p}.mlp.dense_4h_to_h.bias"))


def _gptneox_layer(take: _Taker, cfg: TransformerConfig, p: str, layers: Dict[str, list]):
    layers["attn_norm"].append(take(f"{p}.input_layernorm.weight"))
    layers["attn_norm_b"].append(take(f"{p}.input_layernorm.bias"))
    layers["mlp_norm"].append(take(f"{p}.post_attention_layernorm.weight"))
    layers["mlp_norm_b"].append(take(f"{p}.post_attention_layernorm.bias"))
    q, k, v = _split_falcon_qkv(take(f"{p}.attention.query_key_value.weight"), cfg)
    layers["wq"].append(q.T)
    layers["wk"].append(k.T)
    layers["wv"].append(v.T)
    if cfg.attn_qkv_bias:
        qb, kb, vb = _split_falcon_qkv(take(f"{p}.attention.query_key_value.bias"), cfg)
        layers["wq_b"].append(qb)
        layers["wk_b"].append(kb)
        layers["wv_b"].append(vb)
    layers["wo"].append(take.linear(f"{p}.attention.dense.weight"))
    if cfg.attn_out_bias:
        layers["wo_b"].append(take(f"{p}.attention.dense.bias"))
    layers["w_up"].append(take.linear(f"{p}.mlp.dense_h_to_4h.weight"))
    layers["w_up_b"].append(take(f"{p}.mlp.dense_h_to_4h.bias"))
    layers["w_down"].append(take.linear(f"{p}.mlp.dense_4h_to_h.weight"))
    layers["w_down_b"].append(take(f"{p}.mlp.dense_4h_to_h.bias"))


_LAYER_EXTRACTORS: Dict[str, Callable] = {
    "llama": _llama_layer,
    "mistral": _llama_layer,
    "qwen2": _llama_layer,
    "qwen2_moe": _llama_layer,
    "qwen3": _llama_layer,
    "qwen3_moe": _llama_layer,
    "falcon": _falcon_layer,
    "phi": _phi_layer,
    "phi3": _phi3_layer,
    "bert": _bert_layer,
    "clip_text_model": _clip_text_layer,
    "distilbert": _distilbert_layer,
    "gpt2": _gpt2_layer,
    "gpt_neo": _gptneo_layer,
    "internlm": _llama_layer,
    "opt": _opt_layer,
    "gemma": _llama_layer,  # same checkpoint layout as llama
    "bloom": _bloom_layer,
    "gptj": _gptj_layer,
    "gpt_neox": _gptneox_layer,
    "megatron_gpt": _megatron_gpt_layer,
    "mixtral": _mixtral_layer,
    "stablelm": _stablelm_layer,
    "starcoder2": _starcoder2_layer,
}

# per-arch (embed key, final-norm key, layer prefix, pos-embed key or None)
_TOPLEVEL_KEYS: Dict[str, Tuple[str, str, str, Optional[str]]] = {
    "llama": ("model.embed_tokens.weight", "model.norm", "model.layers", None),
    "mistral": ("model.embed_tokens.weight", "model.norm", "model.layers", None),
    "qwen2": ("model.embed_tokens.weight", "model.norm", "model.layers", None),
    "qwen2_moe": ("model.embed_tokens.weight", "model.norm", "model.layers", None),
    "qwen3": ("model.embed_tokens.weight", "model.norm", "model.layers", None),
    "qwen3_moe": ("model.embed_tokens.weight", "model.norm", "model.layers", None),
    "phi3": ("model.embed_tokens.weight", "model.norm", "model.layers", None),
    "phi": ("model.embed_tokens.weight", "model.final_layernorm", "model.layers", None),
    "falcon": ("transformer.word_embeddings.weight", "transformer.ln_f", "transformer.h", None),
    "gpt2": ("transformer.wte.weight", "transformer.ln_f", "transformer.h", "transformer.wpe.weight"),
    "gpt_neo": ("transformer.wte.weight", "transformer.ln_f", "transformer.h", "transformer.wpe.weight"),
    "internlm": ("model.embed_tokens.weight", "model.norm", "model.layers", None),
    "opt": (
        "model.decoder.embed_tokens.weight",
        "model.decoder.final_layer_norm",
        "model.decoder.layers",
        "model.decoder.embed_positions.weight",
    ),
    "gemma": ("model.embed_tokens.weight", "model.norm", "model.layers", None),
    "bloom": ("transformer.word_embeddings.weight", "transformer.ln_f", "transformer.h", None),
    "gptj": ("transformer.wte.weight", "transformer.ln_f", "transformer.h", None),
    "gpt_neox": ("gpt_neox.embed_in.weight", "gpt_neox.final_layer_norm", "gpt_neox.layers", None),
    "megatron_gpt": (
        "word_embeddings.weight",
        "transformer.final_layernorm",
        "transformer.layers",
        "position_embeddings.weight",
    ),
    "clip_text_model": (
        "text_model.embeddings.token_embedding.weight",
        "text_model.final_layer_norm",
        "text_model.encoder.layers",
        "text_model.embeddings.position_embedding.weight",
    ),
    "mixtral": ("model.embed_tokens.weight", "model.norm", "model.layers", None),
    "stablelm": ("model.embed_tokens.weight", "model.norm", "model.layers", None),
    "starcoder2": ("model.embed_tokens.weight", "model.norm", "model.layers", None),
}


def _expected_layer_keys(cfg: TransformerConfig) -> Dict[str, list]:
    """Empty stacking lists for exactly the keys this config's params carry."""
    keys = ["attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_up", "w_down"]
    if cfg.activation in ("swiglu", "geglu"):
        keys.append("w_gate")
    if cfg.norm == "layernorm":
        keys += ["attn_norm_b", "mlp_norm_b"]
    if cfg.attn_qkv_bias:
        keys += ["wq_b", "wk_b", "wv_b"]
    if cfg.attn_out_bias:
        keys.append("wo_b")
    if cfg.qk_norm:
        keys += ["q_norm", "k_norm"]
        if cfg.qk_norm_kind == "layernorm":
            keys += ["q_norm_b", "k_norm_b"]
    if cfg.mlp_bias and cfg.n_experts == 0:
        keys += ["w_up_b", "w_down_b"] + (["w_gate_b"] if cfg.activation in ("swiglu", "geglu") else [])
    if cfg.n_experts > 0:
        keys.append("router")
        if cfg.moe_shared_expert_dim > 0:
            keys += ["shared_gate", "shared_up", "shared_down", "shared_gate_proj"]
    return {k: [] for k in keys}


def _load_encoder(mt: str, cfg: TransformerConfig, take: _Taker, state: Dict[str, Any]):
    """bert / distilbert (reference module_inject/containers/{bert,
    distil_bert}.py): post-LN encoder stack + masked-LM head. A bare
    BertModel checkpoint (no cls.predictions / vocab_transform) loads with
    mlm_head=False and returns the final hidden states from forward_hidden."""
    # BertForMaskedLM prefixes the backbone with "bert." / "distilbert.";
    # a bare BertModel/DistilBertModel checkpoint saves root-level keys
    base = "" if "embeddings.word_embeddings.weight" in state else f"{mt}."
    stem = f"{base}embeddings"
    prefix = f"{base}encoder.layer" if mt == "bert" else f"{base}transformer.layer"
    head_probe = "cls.predictions.transform.dense.weight" if mt == "bert" else "vocab_transform.weight"
    if head_probe not in state:
        cfg = dataclasses.replace(cfg, mlm_head=False)
    layers = _expected_layer_keys(cfg)
    extract = _LAYER_EXTRACTORS[mt]
    for i in range(cfg.n_layers):
        extract(take, cfg, f"{prefix}.{i}", layers)
    params: Dict[str, Any] = {
        "embed": take(f"{stem}.word_embeddings.weight"),
        "pos_embed": take(f"{stem}.position_embeddings.weight"),
        "embed_norm": take(f"{stem}.LayerNorm.weight"),
        "embed_norm_b": take(f"{stem}.LayerNorm.bias"),
        "layers": {k: torch.stack(v) for k, v in layers.items()},
    }
    if cfg.type_vocab_size > 0:
        params["type_embed"] = take(f"{stem}.token_type_embeddings.weight")
    if cfg.mlm_head:
        if mt == "bert":
            params["mlm_dense"] = take.linear("cls.predictions.transform.dense.weight")
            params["mlm_dense_b"] = take("cls.predictions.transform.dense.bias")
            params["mlm_norm"] = take("cls.predictions.transform.LayerNorm.weight")
            params["mlm_norm_b"] = take("cls.predictions.transform.LayerNorm.bias")
            params["mlm_bias"] = take("cls.predictions.bias")
            state.pop("cls.predictions.decoder.weight", None)  # tied alias
            state.pop("cls.predictions.decoder.bias", None)  # alias of cls.predictions.bias
        else:
            params["mlm_dense"] = take.linear("vocab_transform.weight")
            params["mlm_dense_b"] = take("vocab_transform.bias")
            params["mlm_norm"] = take("vocab_layer_norm.weight")
            params["mlm_norm_b"] = take("vocab_layer_norm.bias")
            params["mlm_bias"] = take("vocab_projector.bias")
            state.pop("vocab_projector.weight", None)  # tied alias
    leftover = [
        k for k in state
        if not k.endswith("position_ids")  # non-persistent HF buffer
    ]
    if leftover:
        logger.warning(f"unmapped HF weights ignored: {leftover[:8]}{'...' if len(leftover) > 8 else ''}")
    return cfg, params


def _owned(params: Dict[str, Any]) -> Dict[str, Any]:
    """Every leaf outside the stacked layers as a contiguous tensor of its
    own: a leaf taken as stored may still be a view of the mapped file, and
    a transposed one (``lm_head``) is not contiguous."""
    return {k: v if k == "layers" else torch.empty(v.shape, dtype=v.dtype,
                                                    device=v.device).copy_(v)
            for k, v in params.items()}


def load_hf_model(
    model_name_or_path: str,
    dtype: str = "bfloat16",
    device="cuda",
) -> Tuple[TransformerConfig, Dict[str, Any]]:
    """Load a supported HF checkpoint directory into the model family's
    stacked layout on ``device`` (the card unless asked otherwise). Returns
    (config, params): feed them to ``make_loss_fn(config)`` +
    ``initialize(model_parameters=params)`` or the inference engines."""
    cfg_path = os.path.join(model_name_or_path, "config.json")
    if not os.path.isfile(cfg_path):
        raise FileNotFoundError(
            f"{model_name_or_path} is not a checkpoint dir (no config.json); "
            "download/snapshot the model first — there is no network access at load time"
        )
    hf_cfg = json.load(open(cfg_path))
    mt = hf_cfg.get("model_type", "llama")
    if mt not in _LAYER_EXTRACTORS:
        raise ValueError(f"unsupported model_type {mt!r}; supported: {sorted(_LAYER_EXTRACTORS)}")
    cfg = dataclasses.replace(config_from_hf(hf_cfg), dtype=dtype)
    state = _load_state_dict(model_name_or_path)
    take = _Taker(state, dtype, device)

    if mt in ("bert", "distilbert"):
        cfg, params = _load_encoder(mt, cfg, take, state)
        return cfg, _owned(params)

    embed_key, norm_key, layer_prefix, pos_key = _TOPLEVEL_KEYS[mt]
    extract = _LAYER_EXTRACTORS[mt]
    layers = _expected_layer_keys(cfg)
    for i in range(cfg.n_layers):
        extract(take, cfg, f"{layer_prefix}.{i}", layers)

    params: Dict[str, Any] = {
        "embed": take(embed_key),
        "final_norm": take(f"{norm_key}.weight"),
        "layers": {k: torch.stack(v) for k, v in layers.items()},
    }
    if cfg.norm == "layernorm":
        params["final_norm_b"] = take(f"{norm_key}.bias")
    if cfg.position == "learned":
        pe = take(pos_key)
        if mt == "opt":
            pe = pe[2:]  # OPT offsets learned positions by 2
        params["pos_embed"] = pe
    if cfg.embed_norm:
        params["embed_norm"] = take("transformer.word_embeddings_layernorm.weight")
        params["embed_norm_b"] = take("transformer.word_embeddings_layernorm.bias")
    if not cfg.tie_embeddings:
        if "embed_out.weight" in state:  # gpt_neox names its lm_head embed_out
            params["lm_head"] = take.linear("embed_out.weight")
        elif "lm_head.weight" in state:
            params["lm_head"] = take.linear("lm_head.weight")
            if cfg.lm_head_bias:
                params["lm_head_b"] = take("lm_head.bias")
        elif cfg.lm_head_bias:
            raise ValueError("checkpoint declares a biased lm_head but ships no lm_head.weight")
        else:
            logger.warning("no lm_head.weight in checkpoint; tying to embeddings")
            cfg = dataclasses.replace(cfg, tie_embeddings=True)
    else:
        state.pop("lm_head.weight", None)
    leftover = [k for k in state if not k.endswith("rotary_emb.inv_freq")]
    if leftover:
        logger.warning(f"unmapped HF weights ignored: {leftover[:8]}{'...' if len(leftover) > 8 else ''}")
    return cfg, _owned(params)


# legacy name (round-1 API); the registry now handles every supported arch
load_hf_llama = load_hf_model
