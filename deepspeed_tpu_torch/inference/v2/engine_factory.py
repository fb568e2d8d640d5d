"""Engine factory and the registry of per-architecture model loaders.

Counterpart of ``deepspeed_tpu/inference/v2/engine_factory.py``: a HF
checkpoint directory's declared architecture (``config.json``
``architectures[0]``) dispatches to a loader that gives the model family's
(config, params) (``models/hf.py``); the factory wraps them in the v1
engine or the paged continuous-batching v2 engine. The engines run on the
card unless the caller passes ``device="cpu"``.
"""

import json
import os
from typing import Callable, Dict

from deepspeed_tpu_torch.utils.logging import log_dist

# architecture name (HF config.json "architectures"[0]) -> loader(path, dtype,
# device) -> (TransformerConfig, params)
POLICY_REGISTRY: Dict[str, Callable] = {}

BUILTIN_ARCHITECTURES = (
    "LlamaForCausalLM",
    "MistralForCausalLM",
    "Qwen2ForCausalLM",
    "Qwen2MoeForCausalLM",
    "Qwen3ForCausalLM",
    "Qwen3MoeForCausalLM",
    "FalconForCausalLM",
    "PhiForCausalLM",
    "Phi3ForCausalLM",
    "GPT2LMHeadModel",
    "GPTNeoForCausalLM",
    "InternLMForCausalLM",
    "OPTForCausalLM",
    "GemmaForCausalLM",
    "BloomForCausalLM",
    "GPTJForCausalLM",
    "GPTNeoXForCausalLM",
    "MixtralForCausalLM",
    "StableLmForCausalLM",
    "Starcoder2ForCausalLM",
)


def register_model_implementation(*arch_names: str):
    """Decorator: register ``fn(path, dtype=..., device=...)`` as the loader
    of the named architectures."""

    def wrap(fn):
        for name in arch_names:
            POLICY_REGISTRY[name] = fn
        return fn

    return wrap


def _register_builtins():
    from deepspeed_tpu_torch.models.hf import load_hf_model

    for arch in BUILTIN_ARCHITECTURES:
        POLICY_REGISTRY.setdefault(arch, load_hf_model)


def load_model_implementation(path: str, dtype: str = "bfloat16", device="cuda"):
    """Resolve and run the loader for a HF checkpoint directory."""
    _register_builtins()
    cfg_path = os.path.join(path, "config.json")
    if not os.path.isfile(cfg_path):
        raise FileNotFoundError(f"{path} has no config.json")
    with open(cfg_path) as f:
        arch_list = json.load(f).get("architectures") or []
    arch = arch_list[0] if arch_list else None
    loader = POLICY_REGISTRY.get(arch)
    if loader is None:
        raise ValueError(
            f"no model implementation for architecture {arch!r}; registered: "
            f"{sorted(POLICY_REGISTRY)} (add one with register_model_implementation)"
        )
    log_dist(f"engine_factory: {arch} via {loader.__name__}", ranks=[0])
    return loader(path, dtype=dtype, device=device)


def build_hf_engine(path: str, engine_config=None, device="cuda"):
    """HF checkpoint directory -> :class:`InferenceEngineV2` on ``device``."""
    from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2

    cfg = engine_config or RaggedInferenceEngineConfig()
    if isinstance(cfg, dict):
        cfg = RaggedInferenceEngineConfig.from_dict(cfg)
    model_config, params = load_model_implementation(path, dtype=cfg.dtype, device=device)
    return InferenceEngineV2(model_config, params, cfg, device=device)


def build_engine_v1(path: str, engine_config=None, device="cuda"):
    """HF checkpoint directory -> the v1 :class:`InferenceEngine` on
    ``device``."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine

    cfg = engine_config or DeepSpeedInferenceConfig()
    if isinstance(cfg, dict):
        cfg = DeepSpeedInferenceConfig.from_dict(cfg)
    model_config, params = load_model_implementation(path, dtype=cfg.dtype, device=device)
    return InferenceEngine(model_config, cfg, params=params, device=device)


__all__ = ["POLICY_REGISTRY", "build_engine_v1", "build_hf_engine", "load_model_implementation",
           "register_model_implementation"]
