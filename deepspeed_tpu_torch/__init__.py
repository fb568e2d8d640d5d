"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, slice by slice. It imports ``torch``
and numpy, never ``jax`` and nothing of ``deepspeed_tpu``; module paths
mirror the JAX package so each counterpart is easy to find. Kernels that
the JAX package wrote in Pallas are hand-written CUDA C++ for Hopper
(``ops/kernels/csrc``), built with ``nvcc`` at first use.

The port trains and serves the dense decoder on one device, and trains it
data x context parallel over processes (``Topology``, ``comm``):

  * train: ``initialize(model=make_loss_fn(cfg), model_parameters=params,
    config=...)`` -> ``engine.train_batch(batch=...)`` (or ``forward`` /
    ``backward`` / ``step``), with the flash attention (forward, dq, dk/dv)
    and RMSNorm (forward, backward) kernels, and at the fused configuration
    (``TransformerConfig(fused_ce=True)``, ``{"optimizer": {"type":
    "FusedAdam"}}``) the fused LM head + cross-entropy (forward, dx, dW) and
    FusedAdam kernels; npz checkpoints the JAX package reads and writes;
  * serve: ``inference.v2.engine_v2.InferenceEngineV2`` with the RMSNorm,
    paged-decode and (int8 pools) block-quant kernels, speculative
    decoding (``spec_round``) and the host block tier; the v1 engine
    through ``init_inference``;
  * ops: ``get_accelerator().create_op_builder(name).load()`` hands out an op
    of the registry (``ops/op_builder.py``; ``sparse_attn`` gives the
    block-sparse module, ``SparseSelfAttention`` over the splash or the
    layout-predicate kernels); ``python -m deepspeed_tpu_torch.env_report``
    prints the stack, the card and the op table.

Parameters live where ``models.transformer.init_params`` puts them (the
card by default; ``device="cpu"`` runs the kernels' plain versions).
"""

from typing import Any, Callable, Optional, Union

from deepspeed_tpu_torch.version import __version__
from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.utils.logging import log_dist, logger


def initialize(
    args=None,
    model: Optional[Callable] = None,
    optimizer=None,
    model_parameters: Any = None,
    training_data=None,
    lr_scheduler=None,
    distributed_port: int = 29500,
    mpu=None,
    dist_init_required: Optional[bool] = None,
    collate_fn=None,
    config: Union[str, dict, None] = None,
    mesh_param=None,
    config_params=None,
    param_specs=None,
):
    """Create a training engine on one device (the JAX package's
    ``initialize``). Returns ``(engine, optimizer, dataloader,
    lr_scheduler)``; the dataloader is a ``DeepSpeedDataLoader`` over
    ``training_data`` (batches of ``train_batch_size`` examples), or None.

    ``model`` is a loss function ``loss_fn(params, batch) -> loss`` and
    ``model_parameters`` the nested dict of tensors it takes; the engine
    runs on their device.

    The grid: ``mpu`` (a ``parallel.topology.Topology``, e.g. the loopback
    form ``Topology(context=4, loopback=True)``) or the config's ``mesh``
    section (``data`` and ``context``; one rank per process, so the default
    process group must hold their product of processes: it is initialized
    here from ``RANK`` / ``WORLD_SIZE`` when those name more than one) sets
    the topology; with neither, the current one stays. The batch arithmetic
    uses the grid's data size. Other mesh axes, tensor and pipeline
    parallelism, ``param_specs`` and the hybrid engine raise
    ``NotImplementedError`` naming their ROADMAP items."""
    import json
    import os

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.topology import (
        PORTED_AXES,
        Topology,
        get_topology,
        set_topology,
    )
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.config_utils import dict_raise_error_on_duplicate_keys
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    log_dist(f"deepspeed_tpu_torch info: version={__version__}", ranks=[0])
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model (loss function) is required")
    if model_parameters is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model_parameters is required")
    config = config if config is not None else config_params
    if config is None and args is not None and getattr(args, "deepspeed_config", None):
        config = args.deepspeed_config
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
    raw = config if isinstance(config, dict) else {}

    def later(what):
        return NotImplementedError(
            f"deepspeed_tpu_torch.initialize: {what} is not ported yet "
            "(ROADMAP queue 1, item 6: multi-GPU)"
        )

    mesh = dict(raw.get("mesh", {}) or {})
    if mesh_param is not None:
        mesh.update({"data": mesh_param[0], "sequence": mesh_param[1]}
                    if isinstance(mesh_param, (tuple, list)) else dict(mesh_param))
    big = {k: v for k, v in mesh.items() if k not in PORTED_AXES and v and int(v) > 1}
    if big:
        raise later(f"a mesh with axes other than data and context above 1 ({big})")
    tp = raw.get("tensor_parallel", {}) or {}
    if max(int(tp.get("autotp_size", 0) or 0), int(tp.get("tp_size", 1) or 1)) > 1:
        raise later("tensor parallelism > 1")
    if int((raw.get("pipeline", {}) or {}).get("stages", 1) or 1) > 1:
        raise later("pipeline parallelism > 1")
    if param_specs is not None:
        raise later("param_specs")
    if mpu is not None and not isinstance(mpu, Topology):
        raise later(f"an mpu of type {type(mpu).__name__} (pass a parallel.topology.Topology)")
    if (raw.get("hybrid_engine", {}) or {}).get("enabled"):
        raise NotImplementedError(
            "deepspeed_tpu_torch.initialize: the hybrid engine is not ported yet "
            "(ROADMAP queue 1, item 9)"
        )
    if mpu is not None:
        set_topology(mpu)
    elif any(v for v in mesh.values()):
        if not comm.is_initialized() and int(os.environ.get("WORLD_SIZE", 1)) > 1:
            comm.init_distributed(distributed_port=distributed_port)
        set_topology(Topology(**{k: int(v) for k, v in mesh.items() if v}))
    topo = get_topology()
    ds_config = DeepSpeedConfig.load(raw, dp_world_size=topo.dp_world_size)
    engine = DeepSpeedEngine(model, model_parameters, ds_config, optimizer=optimizer,
                             lr_scheduler=lr_scheduler, training_data=training_data,
                             collate_fn=collate_fn)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler


def init_inference(model=None, config=None, device="cuda", **kwargs):
    """Reference ``init_inference`` (__init__.py:302): the v1
    ``InferenceEngine`` over ``model`` = (TransformerConfig, params).
    ``config`` is a dict or a ``DeepSpeedInferenceConfig``; without one the
    keyword arguments are its fields. The engine runs on ``device``."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine

    if isinstance(config, dict):
        config = DeepSpeedInferenceConfig.from_dict(config)
    elif config is None:
        config = DeepSpeedInferenceConfig.from_dict(kwargs)
    return InferenceEngine(model, config, device=device)


__all__ = ["__version__", "get_accelerator", "init_inference", "initialize", "log_dist",
           "logger"]
