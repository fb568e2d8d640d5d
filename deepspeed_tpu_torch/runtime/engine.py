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
Offload, weight streaming, ZenFlow, pipelines, curriculum learning and the
flops profiler raise ``NotImplementedError`` naming their ROADMAP items,
and so does loading the JAX package's orbax store. The monitors
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
        (z.offload_optimizer.device != "none" or z.offload_param.device != "none",
         "ZeRO offload (offload_optimizer/offload_param)", "ROADMAP queue 1, item 7"),
        (z.zero_quantized_gradients or z.zero_quantized_weights
         or z.zero_quantized_nontrainable_weights or z.zeropp_loco_param is not None,
         "ZeRO++ quantized exchange (qgZ/qwZ/LoCo)", "ROADMAP queue 1, item 6"),
        ((z.mics_shard_size or -1) > 0 or (z.zero_hpz_partition_size or 1) > 1,
         "MiCS / hpZ shard groups", "ROADMAP queue 1, item 6"),
        (bool(config.zenflow), "ZenFlow", "ROADMAP queue 1, item 7"),
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
        self.params = _snapshot_cast(params, self.compute_dtype, self.device)
        self._param_list = [p for _, p in _leaves(self.params)]
        for p in self._param_list:
            if p.is_floating_point():
                p.requires_grad_(True)

        self.optimizer = self._configure_optimizer(optimizer, config, params)
        self.opt_state = self.optimizer.init(self.params)

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
        n = sum(p.numel() for p in self._param_list)
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
        loss = self._loss(self.params, mb, micro)
        scaled = (loss * torch.tensor(scale, dtype=loss.dtype)).float()
        grads = torch.autograd.grad(scaled, self._param_list, allow_unused=True)
        return scaled.detach() / scale, grads

    def _accumulate(self, acc, grads):
        """Add a micro-batch's grads, cast to the ``grad_accum_dtype``, into
        buffers of that dtype (made on first use)."""
        if acc is None:
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=self.grad_accum_dtype,
                                                 device=p.device), self.params)
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
            self.opt_state = self.optimizer.step(grads, self.opt_state, self.params, lr)
        self.scaler_state = ls.update_state(self.scaler_cfg, self.scaler_state, overflow)
        return grad_norm, overflow

    def train_batch(self, data_iter=None, batch=None):
        """Fused full step: gas micro-batches -> grads -> update. Returns the
        mean loss over the micro-batches (a 0-dim fp32 tensor)."""
        if (data_iter is None) == (batch is None):
            raise ValueError("pass exactly one of data_iter/batch")
        stacked = self._stack_batch(data_iter if data_iter is not None else batch)
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
        with torch.no_grad():
            return self._global_loss(self._loss(self.params, batch))

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
        JAX package's order: the masters, then the transform's fields."""
        if isinstance(self.optimizer, TorchOptimizer):
            return (self.opt_state.master, {"state": self.optimizer.state_tree()})
        inner = self.opt_state.inner
        fields = getattr(self.optimizer.tx, "state_fields", tuple(inner))
        return (self.opt_state.master, tuple(
            inner[f] if isinstance(inner[f], (dict, torch.Tensor)) else np.int32(inner[f])
            for f in fields))

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
        if (load_optimizer_states and not load_module_only and "opt_state" in data
                and isinstance(self.optimizer, TorchOptimizer)):
            self._restore_torch_optimizer(data)
        elif load_optimizer_states and not load_module_only and "opt_state" in data:
            scalars = self._restore_tree(self._opt_state_payload(), data["opt_state"],
                                         "opt_state")
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
