"""Compression entry points (counterpart of
``deepspeed_tpu/compression/compress.py``; reference
``compression/compress.py``): ``init_compression`` builds the per-step
param transform from the ``compression_training`` config section;
``redundancy_clean`` bakes the masks into trained weights."""

from typing import Any, Callable, Dict, Tuple

from deepspeed_tpu_torch.compression.scheduler import CompressionScheduler
from deepspeed_tpu_torch.compression.transforms import (
    prune_weights,
    quantize_weights,
    reduce_layers,
)
from deepspeed_tpu_torch.utils.logging import log_dist


def init_compression(
    params: Any, deepspeed_config: Dict[str, Any], teacher_model=None, mpu=None
) -> Tuple[Any, CompressionScheduler, Callable[..., Any]]:
    """Returns (params, scheduler, compress_fn) where
    ``compress_fn(params, step)`` applies the techniques active at ``step``
    (call it on the params fed to the loss: fake-quant and masks are pure
    transforms, the fake-quant straight-through for autograd). Layer
    reduction applies at once, like the reference's student init."""
    ccfg = deepspeed_config.get("compression_training", {}) or {}
    sched = CompressionScheduler.from_config(ccfg)

    aq = sched.techniques.get("activation_quantization")
    if aq is not None and aq.enabled:
        log_dist(
            "activation_quantization: wrap activations with "
            "compression.quantize_activation(x, sched.techniques"
            "['activation_quantization'].bits_at(step)) — a functional loss "
            "cannot be rewritten in place (reference QuantAct swap)",
            ranks=[0],
        )

    lr_cfg = ccfg.get("layer_reduction", {}) or {}
    if lr_cfg.get("enabled"):
        keep = lr_cfg.get("teacher_layer", lr_cfg.get("keep_layers"))
        if not keep:
            raise ValueError("layer_reduction requires 'teacher_layer' (kept layer indices)")
        params = reduce_layers(params, keep)
        log_dist(f"layer_reduction: kept layers {list(keep)}", ranks=[0])

    def compress_fn(p: Any, step=None, final: bool = False) -> Any:
        """Apply active techniques. ``final=True`` (or step=None) applies
        every ENABLED technique at its fully-ramped state — the bake path."""
        if final or step is None:
            active = {n: t for n, t in sched.techniques.items() if t.enabled}
            bits_step = None
        else:
            active = sched.active_techniques(step)
            bits_step = step
        wq = active.get("weight_quantization")
        if wq:
            p = quantize_weights(p, wq.patterns, wq.bits_at(bits_step))
        sp = active.get("sparse_pruning")
        if sp:
            p = prune_weights(p, sp.patterns, sp.dense_ratio, method="sparse")
        rp = active.get("row_pruning")
        if rp:
            p = prune_weights(p, rp.patterns, rp.dense_ratio, method="row")
        hp = active.get("head_pruning")
        if hp:
            p = prune_weights(p, hp.patterns, hp.dense_ratio, method="head", num_heads=hp.num_heads)
        return p

    return params, sched, compress_fn


def redundancy_clean(params: Any, deepspeed_config: Dict[str, Any], mpu=None) -> Any:
    """Bake the final masks into TRAINED weights (reference redundancy_clean;
    the reference also re-dims modules, functional params keep their
    shapes and zeros carry the pruning). Layer reduction already happened
    at init and is not re-applied; quantization bakes at target bits,
    pruning at its final masks whatever the schedule's windows."""
    cfg = dict(deepspeed_config)
    ccfg = dict(cfg.get("compression_training", {}) or {})
    ccfg.pop("layer_reduction", None)  # applied once, at init
    cfg["compression_training"] = ccfg
    _, _, compress_fn = init_compression(params, cfg)
    return compress_fn(params, final=True)
