"""The training engine of the port, on one device.

Counterpart of ``deepspeed_tpu/runtime/engine.py``'s ``DeepSpeedEngine``
for one device: precision, the optimizer and lr scheduler from the config,
the fused ``train_batch`` (gradient accumulation, loss scaling, the grad
epilogue, clipping, the optimizer step), the imperative ``forward`` /
``backward`` / ``step`` over the same pieces, ``eval_batch``, the getters,
npz checkpoints (``save_checkpoint`` / ``load_checkpoint`` through the
writers of ``runtime/checkpoint_engine``), the dataloader
(``deepspeed_io``) and the wall-clock timers. The model is a loss function
``loss_fn(params, batch) -> loss`` over a nested dict of tensors
(``models.transformer.make_loss_fn``), or ``loss_fn(params, batch, rng)``,
whose third argument is a ``torch.Generator`` on the engine's device,
seeded per (config seed, step, micro-batch) through ``utils/counter_hash.py``
(its draws differ from the JAX engine's ``fold_in`` stream).

The optimizer is the config's, a ``DeepSpeedOptimizer``, or the client's
``torch.optim.Optimizer`` (built over the tensors passed as
``model_parameters``, or a callable ``params -> Optimizer``): the engine
re-points it at its fp32 masters and drives its ``param_groups``' lr with
its LR schedule (``runtime/optimizers.TorchOptimizer``).

How a step runs (the JAX package's ``train_step``, eagerly):

  * params are snapshot-cast to the compute dtype once, at construction;
    the optimizer keeps fp32 masters and writes new params from them;
  * each micro-batch's grads come from ``torch.autograd.grad`` of the loss
    times the loss scale, are cast to the ``grad_accum_dtype`` (fp32 by
    default; bf16 or fp16) and added into buffers of that dtype; nothing
    accumulates in ``.grad``;
  * the epilogue casts the buffers to fp32 and multiplies by ``1 / (gas *
    scale)``; when the overflow
    check runs (fp16, or ``check_grad_overflow``) or clipping is on,
    non-finite elements are zeroed first; the grad norm is NaN when nothing
    computed it;
  * an fp16 overflow skips the optimizer step, so params and optimizer
    state stay as they were, and the scaler adjusts.

``forward`` computes one micro-batch's loss and grads in one pass and
caches the grads, ``backward`` adds them into the fp32 buffers, ``step``
counts the micro-step and, at the accumulation boundary, runs the same
epilogue and update as ``train_batch``. A checkpoint holds the params, the
optimizer state (masters, then the transform's fields in the JAX package's
order), the scaler state and the counters, in the JAX package's archive
layout, so each engine loads the other's. With ``checkpoint.writer`` unset
the store is the sync writer's archive (``checkpoint/engine.py``); every
save also ships ``zero_to_fp32.py``.

ZeRO stages 0-3 hold the same tensors on one device and train identically.

Over processes (a ``Topology`` whose ``process_count`` is above 1: data x
context, one rank per process) every rank is given the global batch, as
the JAX engine's ``train_batch`` is, and takes its data rank's rows of
each micro-batch; the loss function takes its context chunk
(``models.transformer.make_loss_fn``) and returns its share of the global
mean. Gradients are summed over data x context before the epilogue, so
the overflow check, the clip norm and the update are the same on every
rank, and the reported loss is the global mean. There ZeRO stages above 0
and checkpoints raise (ROADMAP queue 1, item 6). The loopback form is one
process: nothing is reduced and every stage behaves as on one device.
Pipelines, curriculum learning and the flops profiler raise
``NotImplementedError`` naming their ROADMAP items, and so does loading the
JAX package's orbax store.

The offload tiers, chosen by the JAX engine's rules:

  * ``offload_optimizer.device: cpu`` (the pinned-host tier): the fp32
    masters and the optimizer's state live in page-locked host memory; each
    leaf's gradient comes down on a copy stream while the previous leaf's
    update runs on the host, in the configured optimizer's own torch math,
    and the params go back up. FusedAdam and Muon stage their state
    through the card a leaf at a time instead (as the JAX engine stages
    them through HBM). With ``ratio < 1`` (Twin-Flow) only that share of
    the state's bytes, largest leaves first, lives on the host and the
    update runs on the card.
  * ``offload_param.device: cpu``: the params rest in page-locked host
    memory between steps and are staged to the card when a step starts.
  * ``super_offload`` and ``nvme`` (the host-optimizer tiers): the step
    ends at gradients on the card, the overflow skip is decided, and the
    native CPU-Adam updates state resident in host memory
    (``runtime/superoffload.py``) or swapped through files
    (``runtime/swap_tensor.py``); a client optimizer, a non-Adam
    optimizer, ZenFlow, several processes or ``nvme`` without a path fall
    back to the pinned-host tier with the JAX engine's warning, and the
    imperative ``step()`` raises, as the JAX engine's does.
  * ``weight_stream`` (the model config's) with ``offload_param``: the
    model stages each layer's weights from host memory, one layer ahead,
    and sends their gradients back (``models/weight_stream.py``); the
    update is ``StreamedAdamW`` (``runtime/streamed_adam.py``) over
    host-resident state. JAX's guards stand: one micro-batch a step, no
    clipping, no fp16, Adam or AdamW.
  * ``zenflow``: the selective optimizer of ``runtime/zenflow.py``, its
    state on the card (as the JAX engine keeps it). The monitors
(``monitor.MonitorMaster``: csv, Prometheus, and TensorBoard / W&B / Comet
where their packages are installed) get the JAX engine's events at its
print steps; a monitor that fails to build or write never stops training.
"""

import contextlib
import inspect
import os
from typing import Any, Callable

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.parallel.topology import DATA_AXIS, PORTED_AXES, get_topology
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as ls
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_scheduler
from deepspeed_tpu_torch.runtime.optimizers import (
    DeepSpeedOptimizer,
    TorchOptimizer,
    _leaves,
    build_optimizer,
    clip_by_global_norm,
    global_grad_norm,
    tree_map,
)
from deepspeed_tpu_torch.utils import counter_hash
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import (
    BACKWARD_GLOBAL_TIMER,
    FORWARD_GLOBAL_TIMER,
    STEP_GLOBAL_TIMER,
    NoopTimer,
    SynchronizedWallClockTimer,
    ThroughputTimer,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
ACCUM_DTYPES = {None: torch.float32, "fp32": torch.float32, "bf16": torch.bfloat16,
                "fp16": torch.float16}


def _later(what: str, item: str):
    return NotImplementedError(f"DeepSpeedEngine: {what} is not ported yet ({item})")


def _check_config(config: DeepSpeedConfig):
    """Raise for every configured section this slice does not run."""
    z = config.zero_optimization
    checks = [
        (z.zero_quantized_gradients or z.zero_quantized_weights
         or z.zero_quantized_nontrainable_weights or z.zeropp_loco_param is not None,
         "ZeRO++ quantized exchange (qgZ/qwZ/LoCo)", "ROADMAP queue 1, item 6"),
        ((z.mics_shard_size or -1) > 0 or (z.zero_hpz_partition_size or 1) > 1,
         "MiCS / hpZ shard groups", "ROADMAP queue 1, item 6"),
        (config.pipeline.stages > 1, "pipeline parallelism", "ROADMAP queue 1, item 6"),
        (bool((config.curriculum_learning or {}).get("enabled"))
         or bool((config.data_efficiency or {}).get("enabled")),
         "curriculum learning / data efficiency", "ROADMAP queue 1, item 9"),
        (config.flops_profiler.enabled, "the flops profiler", "ROADMAP queue 1, item 9"),
        (config.comms_logger.enabled, "the comms logger", "ROADMAP queue 1, item 6"),
        (config.activation_checkpointing.partition_activations
         or config.activation_checkpointing.cpu_checkpointing,
         "partitioned / CPU activation checkpointing", "ROADMAP queue 1, item 6"),
        (config.comm_quant != "none" or config.comm_overlap != "none",
         "quantized / tiled collectives", "ROADMAP queue 1, item 6"),
    ]
    for bad, what, item in checks:
        if bad:
            raise _later(what, item)
    if config.eigenvalue.enabled:
        raise NotImplementedError(
            "DeepSpeedEngine: the eigenvalue section drives nothing in the engine (the JAX "
            "engine never reads it); compute eigenvalues with deepspeed_tpu_torch.runtime."
            "eigenvalue.Eigenvalue on a loss that runs the plain path")


def _leaves_of(tree):
    return [v for _, v in _leaves(tree)]


def _host_copy(t: torch.Tensor, pin: bool) -> torch.Tensor:
    """A host copy of ``t`` (page-locked when ``pin``), keeping
    requires_grad."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
    h.copy_(t.detach())
    return h.requires_grad_(t.requires_grad)


def _snapshot_cast(params, dtype, device):
    """A copy of the params in the compute dtype on ``device``: floating
    leaves cast, others copied; every leaf a fresh tensor."""
    def leaf(p):
        p = torch.as_tensor(p)
        if p.is_floating_point():
            return p.detach().to(device=device, dtype=dtype, copy=True)
        return p.detach().to(device=device, copy=True)

    return tree_map(leaf, params)


class DeepSpeedEngine:
    def __init__(self, loss_fn: Callable, params: Any, config: DeepSpeedConfig,
                 optimizer=None, lr_scheduler=None, training_data=None, collate_fn=None):
        _check_config(config)
        self.config = config
        self.loss_fn = loss_fn
        self.collate_fn = collate_fn
        self.training_dataloader = None
        self._loss_takes_rng = self._detect_rng_arg(loss_fn)

        # precision
        self.compute_dtype = DTYPES[config.precision_dtype]
        self.grad_accum_dtype = ACCUM_DTYPES[config.data_types.grad_accum_dtype]
        self.fp16_enabled = config.fp16.enabled
        self.zero_stage = config.zero_optimization.stage
        self.topology = get_topology()
        if self.topology.distributed and self.zero_stage > 0:
            raise _later(f"ZeRO stage {self.zero_stage} across processes (ZeRO sharded across "
                         "ranks)", "ROADMAP queue 1, item 6")

        # the engine runs where the params live (numpy params: the card)
        first = next(v for _, v in _leaves(params))
        self.device = first.device if isinstance(first, torch.Tensor) else torch.device("cuda")
        self._configure_tiers(config, optimizer, getattr(loss_fn, "model_config", None))
        self.params = _snapshot_cast(params, self.compute_dtype, self.device)
        for p in _leaves_of(self.params):
            if p.is_floating_point():
                p.requires_grad_(True)

        self.optimizer = self._configure_optimizer(optimizer, config, params)
        if self._weight_stream:
            self.optimizer = self._streamed_optimizer(config)
        self._host_opt = None
        self._streamer = None
        self._staged_params = None
        if self._host_opt_requested:
            # the state never exists as tensors of the engine: it is seeded
            # straight into the host optimizer (host memory or files)
            self._init_host_optimizer(config.zero_optimization)
            self.opt_state = None
        else:
            # offloaded state is made on the host: the device never holds it,
            # not even while it is made
            self.opt_state = self.optimizer.init(
                tree_map(lambda p: p.detach().cpu(), self.params) if self._offload_opt
                else self.params)
            self._place_state()
        self._place_params()

        self.scaler_cfg = ls.make_config(config.fp16) if self.fp16_enabled else ls.STATIC_UNIT
        self.scaler_state = ls.init_state(self.scaler_cfg)
        self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler, config)

        self.micro_steps = 0
        self.global_steps = 0
        self.global_samples = 0
        self.skipped_steps = 0
        self._boundary_override = None
        self._train_mode = True
        self._pending_grads = None
        self._acc_grads = None
        self._ckpt_writer = None
        self._ckpt_pending = None
        self.wall_clock_breakdown = config.wall_clock_breakdown
        self.timers = SynchronizedWallClockTimer() if self.wall_clock_breakdown else NoopTimer()
        self.tput_timer = ThroughputTimer(
            config=type("C", (), {"enabled": True})(),
            batch_size=config.train_batch_size,
            steps_per_output=config.steps_per_print,
        )
        self.monitor = self._configure_monitor(config)
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data)
        self._last_loss = None
        self._last_grad_norm = None
        self._last_overflow = None
        n = sum(p.numel() for p in _leaves_of(self.params))
        log_dist(
            f"DeepSpeedEngine: {n / 1e6:.2f}M params | zero_stage={self.zero_stage} "
            f"| dtype={config.precision_dtype} | device={self.device} "
            f"| micro_bsz={config.train_micro_batch_size_per_gpu} "
            f"gas={config.gradient_accumulation_steps}",
            ranks=[0],
        )

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------
    @staticmethod
    def _detect_rng_arg(loss_fn):
        try:
            sig = inspect.signature(loss_fn).parameters
        except (TypeError, ValueError):
            return False
        return len(sig) >= 3 or "rng" in sig

    def _configure_optimizer(self, client_optimizer, config,
                             model_parameters) -> DeepSpeedOptimizer:
        """The client's optimizer wins, else the config's. A client
        ``torch.optim.Optimizer`` must be built over leaves of
        ``model_parameters`` (or, from a callable, of the engine's params)."""
        if client_optimizer is not None:
            if isinstance(client_optimizer, DeepSpeedOptimizer):
                return client_optimizer
            if isinstance(client_optimizer, torch.optim.Optimizer):
                return TorchOptimizer(client_optimizer, [model_parameters, self.params])
            if callable(client_optimizer):
                return self._configure_optimizer(client_optimizer(self.params), config,
                                                 model_parameters)
            raise TypeError(f"Unsupported client optimizer {type(client_optimizer)}")
        if config.optimizer.type is None:
            raise ValueError(
                "No optimizer: pass `optimizer=` to initialize() or set the config "
                "'optimizer' section"
            )
        if config.zenflow:
            # ZenFlow's selective schedule (reference engine.py:351-356 +
            # runtime/zenflow/): Adam-family only, as the reference
            from deepspeed_tpu_torch.runtime.zenflow import build_zenflow_optimizer

            name = (config.optimizer.type or "").lower()
            if name not in ("adam", "adamw", "zenflowselectiveadam"):
                raise ValueError(f"zenflow requires an Adam-family optimizer, got {name}")
            return build_zenflow_optimizer(config.zenflow, config.optimizer)
        return build_optimizer(config.optimizer)

    def _configure_monitor(self, config):
        try:
            from deepspeed_tpu_torch.monitor.monitor import MonitorMaster

            return MonitorMaster(config)
        except Exception as e:  # a monitor never stops training
            logger.warning(f"Monitor disabled: {e}")
            return None

    def _configure_lr_scheduler(self, client_scheduler, config):
        if client_scheduler is not None:
            if callable(client_scheduler) and not hasattr(client_scheduler, "step"):
                return client_scheduler(self.optimizer)
            return client_scheduler
        if config.scheduler.type:
            sched = get_lr_scheduler(config.scheduler.type, optimizer=self.optimizer,
                                     **config.scheduler.params)
            if hasattr(sched, "set_base_lr"):
                sched.set_base_lr(self.optimizer.get_lr())
            return sched
        return None

    # ------------------------------------------------------------------
    # the offload tiers (the JAX engine's __init__ and _opt_apply)
    # ------------------------------------------------------------------
    def _configure_tiers(self, config, client_optimizer, model_config):
        """Resolve the tiers from the config, as the JAX engine does:
        ``_host_opt_requested`` (super_offload / nvme, with its fall back),
        ``_offload_opt`` (state in host memory), ``_offload_par`` (params in
        host memory between steps) and ``_weight_stream``."""
        zcfg = config.zero_optimization
        oo = zcfg.offload_optimizer
        self._super_offload = oo.device == "cpu" and bool(getattr(oo, "super_offload", False))
        self._host_opt_requested = oo.device == "nvme" or self._super_offload
        # the host tiers run CPU-Adam in one process; anything else falls
        # back to the pinned-host tier with a warning instead of refusing
        if self._host_opt_requested:
            opt_name = ((config.optimizer.type or "adamw").lower()
                        if client_optimizer is None else None)
            adam_family = opt_name in ("adam", "adamw", "deepspeedcpuadam")
            reason = None
            if config.zenflow:
                reason = "zenflow runs its own selective/offload schedule"
            elif client_optimizer is not None or not adam_family:
                reason = (f"optimizer {opt_name or type(client_optimizer).__name__} is not "
                          "CPU-Adam-compatible")
            elif self.topology.distributed:
                reason = "multi-process runs are not supported by the host tier yet"
            elif oo.device == "nvme" and not oo.nvme_path:
                reason = "offload_optimizer.nvme_path is not set"
            if reason is not None:
                log_dist(f"offload_optimizer.device={oo.device}: {reason}; falling back to the "
                         "pinned-host tier", ranks=[0])
                self._host_opt_requested = False
                self._super_offload = False
        self._offload_opt = oo.device in ("cpu", "nvme") and not self._host_opt_requested
        if config.zenflow and client_optimizer is not None:
            logger.warning("zenflow config section is ignored when a client optimizer is "
                           "passed to initialize(); remove one of the two")
        if config.zenflow and client_optimizer is None and self._offload_opt:
            log_dist("zenflow active: optimizer state stays device-resident; the "
                     "boundary-interval schedule replaces pinned-host placement", ranks=[0])
            self._offload_opt = False
        self._offload_par = zcfg.offload_param.device != "none"
        if zcfg.offload_param.device == "nvme":
            log_dist("offload_param device 'nvme' maps to the host-memory tier (param NVMe "
                     "swap not implemented)", ranks=[0])
        self._offload_ratio = float(oo.ratio)
        self._pin = self.device.type == "cuda"
        self._weight_stream = bool(getattr(model_config, "weight_stream", False)
                                   and self._offload_par)
        if self._weight_stream:
            if config.gradient_accumulation_steps != 1:
                raise NotImplementedError(
                    "weight_stream requires gradient_accumulation_steps == 1: accumulating "
                    "full-model grads needs a host-side buffer pass that would stage HBM temps "
                    "(grow the micro batch instead)")
            if config.gradient_clipping:
                raise NotImplementedError(
                    "gradient_clipping is unsupported with weight_stream: the global-norm pass "
                    "over host-resident grads would stage full-model fp32 temps in HBM")
            if self.fp16_enabled:
                raise NotImplementedError(
                    "fp16 dynamic loss scaling is unsupported with weight_stream (no overflow "
                    "scan over host grads) — use bf16")
            if not self._offload_opt:
                logger.warning(
                    "weight_stream without offload_optimizer: host-resident grads would be "
                    "pulled back to HBM for the device optimizer — enable "
                    "zero_optimization.offload_optimizer (device 'cpu') for models larger "
                    "than HBM")

    def _streamed_optimizer(self, config):
        """The weight-streaming tier's StreamedAdamW from the configured
        Adam / AdamW (the JAX engine's guards and messages)."""
        from deepspeed_tpu_torch.runtime.streamed_adam import StreamedAdamW

        name = self.optimizer.name
        if name not in ("adam", "adamw"):
            raise NotImplementedError(
                f"weight_stream supports Adam/AdamW only (got {name}): the chunk-streamed "
                "host-state update is AdamW-specific (runtime/streamed_adam.py)")
        d = self.optimizer.defaults
        if name == "adam" and d.get("weight_decay", 0.0):
            raise NotImplementedError(
                "weight_stream implements decoupled (AdamW) weight decay only; use AdamW or "
                "weight_decay=0")
        zcfg = config.zero_optimization
        return StreamedAdamW(
            lr=d.get("lr", 1e-3), betas=tuple(d.get("betas", (0.9, 0.999))),
            eps=d.get("eps", 1e-8), weight_decay=d.get("weight_decay", 0.0),
            quant_bits=int(getattr(zcfg.offload_optimizer, "stream_quant_bits", 0) or 0),
            overlap=zcfg.overlap_enabled, device=self.device)

    def _to_host(self, t):
        """A host (page-locked on a card) copy of a device tensor; a host
        tensor stays as it is, pinned if it must be."""
        if t.device.type == "cpu" and (not self._pin or t.is_pinned()):
            return t
        return _host_copy(t, self._pin)

    def _place_state(self):
        """Put each optimizer-state tensor where its tier says: with
        ``offload_optimizer`` the host for ``ratio`` of the state's bytes,
        largest leaves first (Twin-Flow; the JAX plan's
        ``_partial_offload_mask`` over the state in its flatten order),
        the device for the rest and for every other tier."""
        from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import tree_leaves

        self._host_state_bytes = 0
        if not self._offload_opt:
            return  # the state was made beside the params
        if isinstance(self.optimizer, TorchOptimizer):
            master = tree_map(self._to_host, self.opt_state.master)
            self.opt_state = self.opt_state._replace(master=master)
            self.optimizer.repoint(master)
            return
        flat = [t for t in tree_leaves(self._opt_state_payload()) if isinstance(t, torch.Tensor)]
        sizes = [t.numel() * t.element_size() for t in flat]
        budget = self._offload_ratio * sum(sizes)
        host, cum = set(), 0
        for i in sorted(range(len(flat)), key=lambda j: -sizes[j]):
            if self._offload_ratio < 1.0 and cum >= budget:
                break
            host.add(id(flat[i]))
            cum += sizes[i]
        self._host_state_bytes = sum(t.numel() * t.element_size() for t in flat
                                     if id(t) in host)

        def place(t):
            if not isinstance(t, torch.Tensor):
                return t
            return self._to_host(t) if id(t) in host else t.to(self.device)

        def place_tree(x):
            return tree_map(place, x) if isinstance(x, dict) else place(x)

        inner = {k: place_tree(v) for k, v in self.opt_state.inner.items()}
        self.opt_state = self.opt_state._replace(master=place_tree(self.opt_state.master),
                                                 inner=inner)

    def _place_params(self):
        """``offload_param``: params rest in host memory between steps (the
        streamed leaves only, under weight streaming, whose streamer is
        made here)."""
        if not self._offload_par:
            return
        if not self._weight_stream:
            self.params = tree_map(self._to_host, self.params)
            return
        from deepspeed_tpu_torch.models.weight_stream import WeightStreamer, streamed_leaf

        def place(p):
            return self._to_host(p) if streamed_leaf(tuple(p.shape), p.dtype) else p

        layers = self.params.get("layers", {})
        self.params = {k: ({n: place(w) for n, w in v.items()} if k == "layers"
                           else place(v) if isinstance(v, torch.Tensor) else v)
                       for k, v in self.params.items()}
        stacked = {k: w for k, w in self.params.get("layers", {}).items()
                   if w.device.type == "cpu" and layers[k].dim() >= 3}
        whole = [v for k, v in self.params.items()
                 if k != "layers" and isinstance(v, torch.Tensor) and v.device.type == "cpu"
                 and streamed_leaf(tuple(v.shape), v.dtype)]
        mc = getattr(self.loss_fn, "model_config", None)
        self._streamer = WeightStreamer(stacked, whole, self.device,
                                        remat=bool(getattr(mc, "remat", False)))

    def _compute_params(self):
        """The params the loss runs on: ``offload_param`` (not streamed)
        stages them to the device once per step (dropped after the
        update)."""
        if not self._offload_par or self._weight_stream or self.device.type == "cpu":
            return self.params
        if self._staged_params is None:
            def stage(p):
                d = p.detach().to(self.device, non_blocking=True)
                return d.requires_grad_(p.requires_grad)

            self._staged_params = tree_map(stage, self.params)
        return self._staged_params

    def _init_host_optimizer(self, zcfg):
        """The host-optimizer tiers (NVMe swap / SuperOffload resident): the
        fp32 masters and moments live outside the engine's tensors; each
        step runs the native CPU-Adam over them."""
        ocfg = zcfg.offload_optimizer
        if self.optimizer.name not in ("adam", "adamw"):
            raise RuntimeError(f"superoffload requires adam/adamw, got {self.optimizer.name}")
        d = self.optimizer.defaults
        kw = dict(lr=d.get("lr", 1e-3), betas=tuple(d.get("betas", (0.9, 0.999))),
                  eps=d.get("eps", 1e-8), weight_decay=d.get("weight_decay", 0.0),
                  adamw_mode=self.optimizer.name == "adamw")
        if self._super_offload:
            from deepspeed_tpu_torch.runtime.superoffload import SuperOffloadHostOptimizer

            self._host_opt = SuperOffloadHostOptimizer(
                cpuadam_cores_perc=getattr(ocfg, "cpuadam_cores_perc", 0.8), **kw)
        else:
            from deepspeed_tpu_torch.runtime.swap_tensor import NVMeOptimizerSwapper

            if not ocfg.nvme_path:
                raise ValueError("offload_optimizer.device=nvme requires nvme_path")
            self._host_opt = NVMeOptimizerSwapper(nvme_path=ocfg.nvme_path,
                                                  buffer_count=ocfg.buffer_count, **kw)
        self._host_leaf_paths = [path for path, p in _leaves(self.params)
                                 if p.is_floating_point()]
        self._host_opt.init_from_params((path.replace("/", "."), p)
                                        for path, p in _leaves(self.params)
                                        if p.is_floating_point())

    @torch.no_grad()
    def _offload_step(self, grads, lr):
        """The optimizer step of the pinned-host tier, a leaf at a time:
        on the host over host state (the gradient pulled one leaf ahead)
        when every state leaf lives there, else on the device with the
        host-resident state leaves staged in and written back."""
        from deepspeed_tpu_torch.runtime.superoffload import GradPuller

        opt = self.optimizer
        if isinstance(opt, TorchOptimizer):
            self.opt_state = opt.step(tree_map(lambda g: g.to("cpu"), grads), self.opt_state,
                                      self.params, lr)
            return
        host_compute = (self._offload_ratio >= 1.0
                        and opt.name not in ("muon", "fused_adam", "zenflow"))
        lr = float(np.float32(lr))
        state = self.opt_state
        fields = [f for f, v in state.inner.items() if isinstance(v, dict)]
        scalars = {f: v for f, v in state.inner.items() if f not in fields}
        inner_leaves = {f: dict(_leaves(state.inner[f])) for f in fields}
        grad_of = dict(_leaves(grads))
        param_of = dict(_leaves(self.params))
        paths = list(_leaves(state.master))
        pull = GradPuller() if host_compute else None
        if pull is not None and paths:
            pull.start(0, grad_of[paths[0][0]])
        out = scalars
        for i, (path, m) in enumerate(paths):
            if pull is not None:
                g = pull.take(i).view(m.shape)
                if i + 1 < len(paths):
                    pull.start(i + 1, grad_of[paths[i + 1][0]])
            else:
                g = grad_of[path]
            leaf = {f: inner_leaves[f][path] for f in fields}
            staged = []
            if not host_compute:
                def dev(t):
                    if t.device != self.device:
                        d = t.to(self.device, non_blocking=True)
                        staged.append((t, d))
                        return d
                    return t

                m_use, leaf = dev(m), {f: dev(t) for f, t in leaf.items()}
            else:
                m_use = m
            out = self.optimizer.tx.step(
                {"x": g}, dict(scalars, **{f: {"x": t} for f, t in leaf.items()}),
                {"x": m_use}, lr, {"x": param_of[path]})
            for host, d in staged:
                host.copy_(d, non_blocking=self._pin)
        if self._pin:
            torch.cuda.current_stream(self.device).synchronize()
        self.opt_state = state._replace(inner=dict(state.inner,
                                                   **{f: out[f] for f in scalars}))

    # ------------------------------------------------------------------
    # getters (reference engine.py:588-1146)
    # ------------------------------------------------------------------
    def train_batch_size(self):
        return self.config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    def zero_optimization_stage(self):
        return self.zero_stage

    def zero_optimization(self):
        return self.zero_stage > 0

    def get_lr(self):
        return [self._current_lr()]

    def get_global_grad_norm(self):
        """Last step's global grad norm, or None when nothing computed it."""
        n = self._last_grad_norm
        if n is None:
            return None
        f = float(n)
        return None if f != f else f

    @property
    def loss_scale(self):
        return float(self.scaler_state.scale)

    def gradient_clipping(self):
        return self.config.gradient_clipping

    @property
    def module(self):
        return self.loss_fn

    def is_gradient_accumulation_boundary(self):
        if self._boundary_override is not None:
            return self._boundary_override
        return (self.micro_steps + 1) % self.config.gradient_accumulation_steps == 0

    def set_gradient_accumulation_boundary(self, is_boundary):
        self._boundary_override = is_boundary

    @contextlib.contextmanager
    def no_sync(self):
        """Grads accumulate locally until a boundary step anyway; this
        context just forces the boundary off."""
        prev = self._boundary_override
        self._boundary_override = False
        try:
            yield
        finally:
            self._boundary_override = prev

    def train(self, mode=True):
        self._train_mode = mode
        return self

    def eval(self):
        self._train_mode = False
        return self

    def _current_lr(self):
        if self.lr_scheduler is not None:
            try:
                return float(self.lr_scheduler.get_last_lr()[0])
            except (RuntimeError, AssertionError, AttributeError):
                lr = self.lr_scheduler.get_lr()
                return float(lr[0] if isinstance(lr, (list, tuple)) else lr)
        return float(self.optimizer.get_lr())

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _stack_batch(self, batch_or_iter):
        """A dict of tensors with a leading [gas, micro, ...] dim, on the
        engine's device."""
        gas = self.config.gradient_accumulation_steps
        if hasattr(batch_or_iter, "__next__"):
            micro = [next(batch_or_iter) for _ in range(gas)]
            stacked = {k: torch.stack([torch.as_tensor(np.asarray(m[k])) for m in micro])
                       for k in micro[0]}
        else:
            stacked = {}
            for k, x in batch_or_iter.items():
                x = torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x))
                stacked[k] = x.reshape((gas, -1) + tuple(x.shape[1:]))
        return {k: self._data_rows(v, 1).to(self.device) for k, v in stacked.items()}

    def _data_rows(self, x, dim):
        """This data rank's equal share of the rows of a global batch
        (dimension ``dim``) over processes; the whole batch otherwise."""
        topo = self.topology
        n = topo.axis_size(DATA_AXIS)
        if not topo.distributed or n == 1:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"DeepSpeedEngine: {x.shape[dim]} batch rows do not divide over "
                             f"{n} data ranks")
        return x.chunk(n, dim=dim)[topo.axis_index(DATA_AXIS)]

    def _local_batch(self, batch):
        return {k: self._data_rows(torch.as_tensor(
            v if isinstance(v, torch.Tensor) else np.asarray(v)), 0).to(self.device)
            for k, v in batch.items()}

    def _global_loss(self, loss):
        """The sum of the ranks' shares over data x context: the global
        mean (the loss itself on one process)."""
        if self.topology.distributed:
            loss = comm.all_reduce(loss.detach().clone(), axis=PORTED_AXES)
        return loss

    def _grad_epilogue_flags(self):
        cfg = self.config
        check_overflow = (cfg.check_grad_overflow if cfg.check_grad_overflow is not None
                          else self.fp16_enabled)
        # None = auto: the norm is reduced when a monitor writes it
        monitor_norm = (cfg.monitor_grad_norm if cfg.monitor_grad_norm is not None
                        else bool(getattr(self.monitor, "enabled", False)))
        return check_overflow, monitor_norm

    def _rng(self, step, micro):
        """The generator handed to a loss that takes an rng: seeded by the
        counter hash of (config seed, step, micro-batch)."""
        h = counter_hash.mix32(torch.tensor(self.config.seed & counter_hash.M32))
        for word in (step, micro):
            h = counter_hash.fold(h, word)
        return torch.Generator(device=self.device).manual_seed(int(h))

    def _loss(self, params, batch, micro=0):
        if self._loss_takes_rng:
            out = self.loss_fn(params, batch, self._rng(self.global_steps, micro))
        else:
            out = self.loss_fn(params, batch)
        return out[0] if isinstance(out, tuple) else out

    def _scale(self):
        use_scale = self.scaler_cfg.dynamic or self.scaler_cfg.init_scale != 1.0
        return float(self.scaler_state.scale) if use_scale else 1.0

    def _micro_grads(self, mb, scale, micro=0):
        """One micro-batch: (loss, grads of loss * scale), in one pass."""
        params = self._compute_params()
        loss = self._loss(params, mb, micro)
        scaled = (loss * torch.tensor(scale, dtype=loss.dtype)).float()
        grads = torch.autograd.grad(scaled, _leaves_of(params), allow_unused=True)
        return scaled.detach() / scale, grads

    def _accumulate(self, acc, grads):
        """Add a micro-batch's grads, cast to the ``grad_accum_dtype``, into
        buffers of that dtype on the device (made on first use)."""
        if acc is None:
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=self.grad_accum_dtype,
                                                 device=self.device), self.params)
        for (_, a), g in zip(_leaves(acc), grads):
            if g is not None:
                a.add_(g.to(a.dtype))
        return acc

    def _grad_epilogue(self, acc, scale):
        """Accumulated grads -> (grads, overflow, grad_norm): unscale by
        1 / (gas * scale), check overflow, sanitize, clip."""
        gas = self.config.gradient_accumulation_steps
        clip = self.config.gradient_clipping
        check_overflow, monitor_norm = self._grad_epilogue_flags()
        if self.grad_accum_dtype != torch.float32:
            acc = tree_map(lambda a: a.float(), acc)
        acc_list = [a for _, a in _leaves(acc)]
        with torch.no_grad():
            inv = float(np.float32(1.0) / (np.float32(gas) * np.float32(scale)))
            for a in acc_list:
                a.mul_(inv)
            overflow = bool(ls.has_overflow(acc_list)) if check_overflow else False
            if check_overflow or clip > 0:
                for a in acc_list:
                    torch.nan_to_num_(a, nan=0.0, posinf=0.0, neginf=0.0)
            if clip > 0:
                _, grad_norm = clip_by_global_norm(acc, clip)
            elif monitor_norm:
                grad_norm = global_grad_norm(acc)
            else:
                grad_norm = torch.full((), float("nan"))
        return acc, overflow, grad_norm

    def _apply(self, acc, scale):
        """The update shared by ``train_batch`` and ``step``: the lr for
        this step, the epilogue, the optimizer step (skipped on an
        overflow) and the scaler. Returns (grad_norm, overflow)."""
        lr = self._lr_for_step()
        if self.topology.distributed:
            for _, a in _leaves(acc):
                comm.all_reduce(a, axis=PORTED_AXES)
        grads, overflow, grad_norm = self._grad_epilogue(acc, scale)
        if not overflow:
            if self._offload_opt:
                self._offload_step(grads, lr)
            else:
                self.opt_state = self.optimizer.step(grads, self.opt_state, self.params, lr)
        self._staged_params = None  # offload_param: the next step stages the new params
        self.scaler_state = ls.update_state(self.scaler_cfg, self.scaler_state, overflow)
        return grad_norm, overflow

    def train_batch(self, data_iter=None, batch=None):
        """Fused full step: gas micro-batches -> grads -> update. Returns the
        mean loss over the micro-batches (a 0-dim fp32 tensor)."""
        if (data_iter is None) == (batch is None):
            raise ValueError("pass exactly one of data_iter/batch")
        stacked = self._stack_batch(data_iter if data_iter is not None else batch)
        if self._host_opt is not None:
            return self._train_batch_hostopt(stacked)
        if self._weight_stream:
            return self._train_batch_streamed(stacked)
        self.tput_timer.start()
        self.timers(STEP_GLOBAL_TIMER).start()
        scale = self._scale()
        acc, losses = None, []
        for i in range(self.config.gradient_accumulation_steps):
            loss, grads = self._micro_grads({k: v[i] for k, v in stacked.items()}, scale, i)
            acc = self._accumulate(acc, grads)
            del grads
            losses.append(loss)
        grad_norm, overflow = self._apply(acc, scale)
        del acc
        self.timers(STEP_GLOBAL_TIMER).stop()
        loss = self._global_loss(torch.stack(losses).mean())
        self._after_step(loss, grad_norm, overflow)
        self.tput_timer.stop(global_step=True)
        return loss

    def _stream_scope(self):
        from deepspeed_tpu_torch.models.weight_stream import stream_scope

        if self._streamer is None:
            return contextlib.nullcontext()
        self._streamer.begin_step()
        return stream_scope(self._streamer)

    def _grads_only(self, stacked):
        """The step up to the grad epilogue (gas micro-batches, accumulated):
        (grads, overflow, grad_norm, loss, scale)."""
        scale = self._scale()
        acc, losses = None, []
        for i in range(self.config.gradient_accumulation_steps):
            loss, grads = self._micro_grads({k: v[i] for k, v in stacked.items()}, scale, i)
            acc = self._accumulate(acc, grads)
            del grads
            losses.append(loss)
        grads, overflow, grad_norm = self._grad_epilogue(acc, scale)
        return grads, overflow, grad_norm, torch.stack(losses).mean(), scale

    def _train_batch_hostopt(self, stacked):
        """train_batch for the host-optimizer tiers: the grads-only step on
        the device, the overflow skip decided here, then the host
        optimizer's update and the new params up to the device (reference
        stage3 step with _optimizer_states_and_gradient_swap_in/out)."""
        lr = self._lr_for_step()
        self.tput_timer.start()
        self.timers(STEP_GLOBAL_TIMER).start()
        grads, overflow, grad_norm, loss, _ = self._grads_only(stacked)
        if not overflow:
            leaf = dict(_leaves(grads))
            new = self._host_opt.step([(path.replace("/", "."), leaf[path])
                                       for path in self._host_leaf_paths], lr=lr)
            with torch.no_grad():
                param_of = dict(_leaves(self.params))
                for path in self._host_leaf_paths:
                    param_of[path].copy_(new[path.replace("/", ".")], non_blocking=self._pin)
        self._staged_params = None
        self.scaler_state = ls.update_state(self.scaler_cfg, self.scaler_state, overflow)
        self.timers(STEP_GLOBAL_TIMER).stop()
        self._after_step(loss, grad_norm, overflow)
        self.tput_timer.stop(global_step=True)
        return loss

    def _train_batch_streamed(self, stacked):
        """train_batch for the weight-streaming tier: one micro-batch whose
        forward stages the layers from host memory and whose backward sends
        their gradients to the host (``models/weight_stream.py``), then
        StreamedAdamW over the host state. No overflow check and no
        clipping (the tier's guards)."""
        lr = self._lr_for_step()
        self.tput_timer.start()
        self.timers(STEP_GLOBAL_TIMER).start()
        st = self._streamer
        params = self.params
        with self._stream_scope():
            loss = self._loss(params, {k: v[0] for k, v in stacked.items()}, 0)
        if st is not None:
            st.begin_backward()
        grads = torch.autograd.grad(loss.float(), _leaves_of(params), allow_unused=True)
        if st is not None:
            st.finish()
        by_id = {id(t): g for t, g in zip(_leaves_of(params), grads)}
        layers = st.layers if st is not None else {}

        def grad(path, p):
            g = by_id.get(id(p))
            if path.startswith("layers/") and path[7:] in layers:
                return st.grads[path[7:]]
            if g is None:
                return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            return g.float() if g.device.type != "cpu" else g

        grads = {}
        for path, p in _leaves(params):
            node = grads
            keys = path.split("/")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = grad(path, p)
        _, monitor_norm = self._grad_epilogue_flags()
        grad_norm = (global_grad_norm(tree_map(lambda g: g.float().cpu(), grads))
                     if monitor_norm else torch.full((), float("nan")))
        self.opt_state = self.optimizer.step(grads, self.opt_state, params, lr)
        if self._pin:
            torch.cuda.current_stream(self.device).synchronize()
        self.timers(STEP_GLOBAL_TIMER).stop()
        loss = loss.detach()
        self._after_step(loss, grad_norm, False)
        self.tput_timer.stop(global_step=True)
        return loss

    # ------------------------------------------------------------------
    # the imperative API
    # ------------------------------------------------------------------
    def forward(self, batch):
        """The loss of one micro-batch; its grads are computed in the same
        pass and cached for ``backward()`` (no second forward)."""
        self.timers(FORWARD_GLOBAL_TIMER).start()
        micro = self.micro_steps % self.config.gradient_accumulation_steps
        loss, self._pending_grads = self._micro_grads(self._local_batch(batch), self._scale(),
                                                      micro)
        loss = self._global_loss(loss)
        self.timers(FORWARD_GLOBAL_TIMER).stop()
        self._last_loss = loss
        return loss

    __call__ = forward

    def backward(self, loss=None, retain_graph=False, scale_wrt_gas=True):
        """Accumulate the cached grads into the fp32 buffers."""
        if self._pending_grads is None:
            raise RuntimeError("call forward() before backward()")
        self.timers(BACKWARD_GLOBAL_TIMER).start()
        grads, self._pending_grads = self._pending_grads, None
        self._acc_grads = self._accumulate(self._acc_grads, grads)
        self.timers(BACKWARD_GLOBAL_TIMER).stop()
        return loss

    def step(self, lr_kwargs=None):
        """Count the micro-step; at a gradient-accumulation boundary, update."""
        boundary = self.is_gradient_accumulation_boundary()
        self.micro_steps += 1
        self.global_samples += self.config.train_micro_batch_size_per_gpu
        if not boundary:
            return
        if self._acc_grads is None:
            raise RuntimeError("step() with no accumulated gradients")
        if self._host_opt is not None:
            raise NotImplementedError(
                "the NVMe optimizer tier supports the fused train_batch() API only (the "
                "imperative forward/backward/step path would leave accumulated grads "
                "on-device across the host update)")
        if self._weight_stream:
            raise AssertionError("streamed optimizer must run eagerly (train_batch streamed "
                                 "path), never inside the fused step jit")
        self.timers(STEP_GLOBAL_TIMER).start()
        acc, self._acc_grads = self._acc_grads, None
        grad_norm, overflow = self._apply(acc, self._scale())
        del acc
        self.timers(STEP_GLOBAL_TIMER).stop()
        self._after_step(self._last_loss, grad_norm, overflow)

    def _lr_for_step(self):
        if self.lr_scheduler is not None:
            lrs = self.lr_scheduler.step()
            return float(lrs[0] if isinstance(lrs, (list, tuple)) else lrs)
        return float(self.optimizer.get_lr())

    def _after_step(self, loss, grad_norm, overflow):
        self.global_steps += 1
        self.skipped_steps += int(bool(overflow))
        self._last_loss = loss
        self._last_grad_norm = grad_norm
        self._last_overflow = overflow
        if self.config.steps_per_print and self.global_steps % self.config.steps_per_print == 0:
            gn = float(grad_norm)
            gn_s = f"{gn:.3f}" if gn == gn else "n/a (set monitor_grad_norm)"
            log_dist(
                f"step={self.global_steps} loss={float(loss):.4f} lr={self._current_lr():.3e} "
                f"grad_norm={gn_s} scale={float(self.scaler_state.scale):.1f}"
                + (" OVERFLOW-SKIPPED" if overflow else ""),
                ranks=[0],
            )
            if self.monitor is not None and self.monitor.enabled:
                events = [
                    ("Train/Samples/train_loss", float(loss), self.global_samples),
                    ("Train/Samples/lr", self._current_lr(), self.global_samples),
                    ("Train/Samples/grad_norm", gn, self.global_samples),
                    ("Train/Samples/loss_scale", float(self.scaler_state.scale),
                     self.global_samples),
                ]
                try:
                    self.monitor.write_events(events)
                except Exception as e:  # a monitor never stops training
                    logger.warning(f"Monitor write failed: {e}")
        if (self.wall_clock_breakdown and self.config.steps_per_print
                and self.global_steps % self.config.steps_per_print == 0):
            self.timers.log([FORWARD_GLOBAL_TIMER, BACKWARD_GLOBAL_TIMER, STEP_GLOBAL_TIMER])

    def eval_batch(self, batch):
        """The loss of one batch (no grads, no update)."""
        batch = self._local_batch(batch)
        with torch.no_grad(), self._stream_scope():
            return self._global_loss(self._loss(self._compute_params(), batch))

    # ------------------------------------------------------------------
    # dataloader
    # ------------------------------------------------------------------
    def deepspeed_io(self, dataset, batch_size=None, route="train", data_sampler=None,
                     collate_fn=None, num_local_io_workers=None):
        from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader

        return DeepSpeedDataLoader(
            dataset,
            batch_size=batch_size or self.config.train_batch_size,
            collate_fn=collate_fn or self.collate_fn,
            seed=self.config.seed,
        )

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def _client_state(self):
        return {
            "micro_steps": self.micro_steps,
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "skipped_steps": self.skipped_steps,
            "lr_scheduler": (self.lr_scheduler.state_dict()
                             if hasattr(self.lr_scheduler, "state_dict") else None),
        }

    def _writer_name(self):
        from deepspeed_tpu_torch.checkpoint.engine import DEFAULT_WRITER

        return self.config.checkpoint.writer or DEFAULT_WRITER

    def _checkpoint_writer(self):
        if self._ckpt_writer is None:
            from deepspeed_tpu_torch.runtime.checkpoint_engine import create_checkpoint_engine

            self._ckpt_writer = create_checkpoint_engine(self._writer_name())
        return self._ckpt_writer

    def checkpoint_commit(self):
        """Join outstanding async checkpoint writes and publish their tag
        (two-phase commit). A failed commit DROPS the pending tag: 'latest'
        must never name a checkpoint that did not land."""
        if self._ckpt_pending is None:
            return
        save_dir, tag, save_latest = self._ckpt_pending
        self._ckpt_pending = None  # even on failure: never re-publish a failed tag
        self._ckpt_writer.commit(tag)  # raises if any write failed
        if save_latest:
            with open(os.path.join(save_dir, "latest"), "w") as f:
                f.write(tag)

    def _opt_state_payload(self):
        """The optimizer state as nested tuples whose leaves flatten in the
        JAX package's order: the masters, then the transform's fields. A
        host-optimizer tier's state is read back from its optimizer (masters
        first, so ``zero_to_fp32`` finds them); ZenFlow's is its own."""
        if self._host_opt is not None:
            return self._host_payload(self._host_opt.as_state_tree())
        if hasattr(self.optimizer, "checkpoint_payload"):
            return self.optimizer.checkpoint_payload(self.opt_state)
        if isinstance(self.optimizer, TorchOptimizer):
            return (self.opt_state.master, {"state": self.optimizer.state_tree()})
        inner = self.opt_state.inner
        fields = getattr(self.optimizer.tx, "state_fields", tuple(inner))
        return (self.opt_state.master, tuple(
            inner[f] if isinstance(inner[f], (dict, torch.Tensor)) else np.int32(inner[f])
            for f in fields))

    def _host_payload(self, tree):
        """A host optimizer's {"name.key": tensor, "steps": n} as (masters,
        {"exp_avg", "exp_avg_sq", "steps"}), each a tree of the params'
        paths."""
        def nest(key):
            out = {}
            for path in self._host_leaf_paths:
                keys = path.split("/")
                node = out
                for k in keys[:-1]:
                    node = node.setdefault(k, {})
                node[keys[-1]] = tree[f"{path.replace('/', '.')}.{key}"]
            return out

        return (nest("master"), {"exp_avg": nest("exp_avg"), "exp_avg_sq": nest("exp_avg_sq"),
                                 "steps": np.int32(tree["steps"])})

    def _restore_host_opt(self, loaded):
        template = self._host_payload(self._host_opt.state_tree_template())
        (steps,) = self._restore_tree(template, loaded, "opt_state")
        masters, rest = template
        tree = {"steps": int(steps)}
        for key, part in (("master", masters), ("exp_avg", rest["exp_avg"]),
                          ("exp_avg_sq", rest["exp_avg_sq"])):
            for path, t in _leaves(part):
                tree[f"{path.replace('/', '.')}.{key}"] = t
        self._host_opt.load_state_tree(tree)

    def _no_checkpoint_across_processes(self):
        if self.topology.distributed:
            raise _later("checkpoints across processes", "ROADMAP queue 1, item 6")

    def save_checkpoint(self, save_dir, tag=None, client_state=None, save_latest=True,
                        exclude_frozen_parameters=False):
        self._no_checkpoint_across_processes()
        tag = tag or f"global_step{self.global_steps}"
        state = self._client_state()
        state.update(client_state or {})
        eng = self._checkpoint_writer()
        # an async writer returns after the device -> host snapshot; the
        # PREVIOUS save publishes here and a final checkpoint_commit()
        # publishes the last one
        self.checkpoint_commit()
        eng.create(tag)
        os.makedirs(save_dir, exist_ok=True)
        from deepspeed_tpu_torch.checkpoint.engine import copy_recovery_script

        copy_recovery_script(save_dir)
        sc = self.scaler_state
        eng.save(
            {
                "params": self.params,
                "opt_state": self._opt_state_payload(),
                "scaler_state": (np.float32(sc.scale), np.int32(sc.good_steps),
                                 np.int32(sc.hysteresis)),
                "__meta__": state,
            },
            os.path.join(save_dir, tag, "state"),
        )
        self._ckpt_pending = (save_dir, tag, save_latest)
        if self._writer_name() in ("sync", "torch"):
            self.checkpoint_commit()
        return True

    @torch.no_grad()
    def _restore_tree(self, template, loaded, what):
        """Order-based restore: the writer serialized leaves in tree-flatten
        order, so copy them back into the template's tensors in place.
        Returns the loaded values of the template's non-tensor leaves."""
        from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
            numpy_to_tensor,
            tree_leaves,
        )

        slots = tree_leaves(template)
        if len(slots) != len(loaded):
            raise ValueError(f"checkpoint {what} leaf count {len(loaded)} != "
                             f"template leaf count {len(slots)}")
        scalars = []
        for t, l in zip(slots, loaded):
            if not isinstance(t, torch.Tensor):
                scalars.append(np.asarray(l).item())
                continue
            if tuple(t.shape) != tuple(l.shape):
                raise ValueError(f"checkpoint {what} leaf shape {tuple(l.shape)} != "
                                 f"template shape {tuple(t.shape)}")
            t.copy_(numpy_to_tensor(l))
        return scalars

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True, load_lr_scheduler_states=True,
                        load_module_only=False, custom_load_fn=None):
        self._no_checkpoint_across_processes()
        eng = self._checkpoint_writer()
        self.checkpoint_commit()  # a just-written tag must be readable
        if tag is None:
            latest = os.path.join(load_dir, "latest")
            if not os.path.isfile(latest):
                return None, {}
            with open(latest) as f:
                tag = f.read().strip()
        from deepspeed_tpu_torch.checkpoint.engine import check_loadable

        state_path = os.path.join(load_dir, tag, "state")
        check_loadable(state_path)
        data = eng.load(state_path)
        self._restore_tree(self.params, data["params"], "params")
        self._staged_params = None
        want_opt = load_optimizer_states and not load_module_only and "opt_state" in data
        if want_opt and isinstance(self.optimizer, TorchOptimizer):
            self._restore_torch_optimizer(data)
        elif want_opt and self._host_opt is not None:
            self._restore_host_opt(data["opt_state"])
        elif want_opt:
            scalars = self._restore_tree(self._opt_state_payload(), data["opt_state"],
                                         "opt_state")
            if hasattr(self.optimizer, "restore_counts"):
                self.opt_state = self.optimizer.restore_counts(self.opt_state, scalars)
            else:
                inner = dict(self.opt_state.inner)
                counts = [k for k in getattr(self.optimizer.tx, "state_fields", tuple(inner))
                          if not isinstance(inner[k], (dict, torch.Tensor))]
                inner.update({k: int(v) for k, v in zip(counts, scalars)})
                self.opt_state = self.opt_state._replace(inner=inner)
        if "scaler_state" in data and not load_module_only:
            scale, good, hyst = (np.asarray(x).item() for x in data["scaler_state"])
            self.scaler_state = ls.LossScaleState(float(scale), int(good), int(hyst))
        client_state = data.get("__meta__", {})
        self._restore_client_state(client_state, load_module_only, load_lr_scheduler_states)
        return os.path.join(load_dir, tag), client_state

    @torch.no_grad()
    def _restore_torch_optimizer(self, data):
        """The masters in order, then the client optimizer's state by the
        archive's leaf names (``1.state.<param index>.<name>``)."""
        from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
            numpy_to_tensor,
            tree_leaves,
        )

        names = (data.get("__names__") or {}).get("opt_state")
        if names is None:
            raise ValueError("checkpoint has no leaf names (.names.json): a client torch "
                             "optimizer's state cannot be restored from it")
        n = len(tree_leaves(self.opt_state.master))
        self._restore_tree(self.opt_state.master, data["opt_state"][:n], "opt_state masters")
        tree = {}
        for path, leaf in zip(names[n:], data["opt_state"][n:]):
            _, _, idx, key = path.split(".", 3)
            # host tensors: the optimizer's load_state_dict places each state
            # as its own policy says (moments beside their params, AdamW's
            # step count on the host)
            tree.setdefault(idx, {})[key] = numpy_to_tensor(leaf)
        self.optimizer.load_state_tree(tree)

    def _restore_client_state(self, client_state, load_module_only, load_lr_scheduler_states):
        if load_module_only:
            return
        self.micro_steps = client_state.get("micro_steps", 0)
        self.global_steps = client_state.get("global_steps", 0)
        self.global_samples = client_state.get("global_samples", 0)
        self.skipped_steps = client_state.get("skipped_steps", 0)
        sched_sd = client_state.get("lr_scheduler")
        if load_lr_scheduler_states and sched_sd and hasattr(self.lr_scheduler, "load_state_dict"):
            self.lr_scheduler.load_state_dict(sched_sd)

    def save_16bit_model(self, save_dir, save_filename="pytorch_model.bin",
                         exclude_frozen_parameters=False):
        """Consolidated export of the params in their compute dtype: one
        ``.npz`` with dotted names (bf16 leaves as 2-byte void entries)."""
        from deepspeed_tpu_torch.checkpoint.engine import save_16bit_model

        return save_16bit_model(save_dir, save_filename, self.params)


__all__ = ["DeepSpeedEngine"]
