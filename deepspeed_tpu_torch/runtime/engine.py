"""The training engine of the port, on one device.

Counterpart of ``deepspeed_tpu/runtime/engine.py``'s ``DeepSpeedEngine``
for one device: precision, the optimizer and lr scheduler from the config,
the fused ``train_batch`` (gradient accumulation, loss scaling, the grad
epilogue, clipping, the optimizer step), ``eval_batch`` and the getters.
The model is a loss function ``loss_fn(params, batch) -> loss`` over a
nested dict of tensors (``models.transformer.make_loss_fn``).

How a step runs (the JAX package's ``train_step``, eagerly):

  * params are snapshot-cast to the compute dtype once, at construction;
    the optimizer keeps fp32 masters and writes new params from them;
  * each micro-batch's grads come from ``torch.autograd.grad`` of the loss
    times the loss scale and are added into fp32 buffers (the
    ``grad_accum_dtype``; others raise); nothing accumulates in ``.grad``;
  * the epilogue multiplies by ``1 / (gas * scale)``; when the overflow
    check runs (fp16, or ``check_grad_overflow``) or clipping is on,
    non-finite elements are zeroed first; the grad norm is NaN when nothing
    computed it;
  * an fp16 overflow skips the optimizer step, so params and optimizer
    state stay as they were, and the scaler adjusts.

ZeRO stages 0-3 hold the same tensors on one device and train identically.
Offload, weight streaming, ZenFlow, pipelines, curriculum learning, the
flops profiler, monitors, checkpoints and the imperative
``forward``/``backward``/``step`` raise ``NotImplementedError`` naming their
ROADMAP items.
"""

import inspect
from typing import Any, Callable

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as ls
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_scheduler
from deepspeed_tpu_torch.runtime.optimizers import (
    DeepSpeedOptimizer,
    _leaves,
    build_optimizer,
    clip_by_global_norm,
    global_grad_norm,
    tree_map,
)
from deepspeed_tpu_torch.utils.logging import log_dist

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


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
        (config.eigenvalue.enabled, "eigenvalue", "ROADMAP queue 1, item 9"),
        (any(m.enabled for m in (config.tensorboard, config.wandb, config.csv_monitor,
                                 config.comet, config.prometheus)),
         "monitors", "ROADMAP queue 1, item 5"),
        (config.comms_logger.enabled, "the comms logger", "ROADMAP queue 1, item 6"),
        (config.wall_clock_breakdown, "wall_clock_breakdown timers", "ROADMAP queue 1, item 9"),
        (config.activation_checkpointing.partition_activations
         or config.activation_checkpointing.cpu_checkpointing,
         "partitioned / CPU activation checkpointing", "ROADMAP queue 1, item 6"),
        (config.comm_quant != "none" or config.comm_overlap != "none",
         "quantized / tiled collectives", "ROADMAP queue 1, item 6"),
        (config.data_types.grad_accum_dtype not in (None, "fp32"),
         "grad_accum_dtype other than fp32", "ROADMAP queue 1, item 3"),
    ]
    for bad, what, item in checks:
        if bad:
            raise _later(what, item)


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
                 optimizer=None, lr_scheduler=None):
        _check_config(config)
        self.config = config
        self.loss_fn = loss_fn
        sig = inspect.signature(loss_fn).parameters if callable(loss_fn) else {}
        if len(sig) >= 3 or "rng" in sig:
            raise _later("loss functions that take an rng", "ROADMAP queue 1, item 3")

        # precision (grads accumulate in fp32: _check_config refuses others)
        self.compute_dtype = DTYPES[config.precision_dtype]
        self.fp16_enabled = config.fp16.enabled
        self.zero_stage = config.zero_optimization.stage

        # the engine runs where the params live (numpy params: the card)
        first = next(v for _, v in _leaves(params))
        self.device = first.device if isinstance(first, torch.Tensor) else torch.device("cuda")
        self.params = _snapshot_cast(params, self.compute_dtype, self.device)
        self._param_list = [p for _, p in _leaves(self.params)]
        for p in self._param_list:
            if p.is_floating_point():
                p.requires_grad_(True)

        self.optimizer = self._configure_optimizer(optimizer, config)
        self.opt_state = self.optimizer.init(self.params)

        self.scaler_cfg = ls.make_config(config.fp16) if self.fp16_enabled else ls.STATIC_UNIT
        self.scaler_state = ls.init_state(self.scaler_cfg)
        self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler, config)

        self.global_steps = 0
        self.skipped_steps = 0
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
    def _configure_optimizer(self, client_optimizer, config) -> DeepSpeedOptimizer:
        if client_optimizer is not None:
            if isinstance(client_optimizer, DeepSpeedOptimizer):
                return client_optimizer
            raise _later(f"client optimizer {type(client_optimizer).__name__}",
                         "ROADMAP queue 1, item 3")
        if config.optimizer.type is None:
            raise ValueError(
                "No optimizer: pass `optimizer=` to initialize() or set the config "
                "'optimizer' section"
            )
        return build_optimizer(config.optimizer)

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
        return {k: v.to(self.device) for k, v in stacked.items()}

    def _grad_epilogue_flags(self):
        cfg = self.config
        check_overflow = (cfg.check_grad_overflow if cfg.check_grad_overflow is not None
                          else self.fp16_enabled)
        monitor_norm = bool(cfg.monitor_grad_norm)
        return check_overflow, monitor_norm

    def _loss(self, params, batch):
        out = self.loss_fn(params, batch)
        return out[0] if isinstance(out, tuple) else out

    def _train_step(self, stacked):
        gas = self.config.gradient_accumulation_steps
        clip = self.config.gradient_clipping
        check_overflow, monitor_norm = self._grad_epilogue_flags()
        use_scale = self.scaler_cfg.dynamic or self.scaler_cfg.init_scale != 1.0
        scale = float(self.scaler_state.scale) if use_scale else 1.0

        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       self.params)
        acc_list = [a for _, a in _leaves(acc)]
        losses = []
        for i in range(gas):
            mb = {k: v[i] for k, v in stacked.items()}
            loss = self._loss(self.params, mb)
            scaled = (loss * torch.tensor(scale, dtype=loss.dtype)).float()
            grads = torch.autograd.grad(scaled, self._param_list, allow_unused=True)
            for a, g in zip(acc_list, grads):
                if g is not None:
                    a.add_(g)
            del grads
            losses.append(scaled.detach() / scale)

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
            return acc, overflow, grad_norm, torch.stack(losses).mean()

    def train_batch(self, data_iter=None, batch=None):
        """Fused full step: gas micro-batches -> grads -> update. Returns the
        mean loss over the micro-batches (a 0-dim fp32 tensor)."""
        if (data_iter is None) == (batch is None):
            raise ValueError("pass exactly one of data_iter/batch")
        stacked = self._stack_batch(data_iter if data_iter is not None else batch)
        lr = self._lr_for_step()
        grads, overflow, grad_norm, loss = self._train_step(stacked)
        if not overflow:
            self.opt_state = self.optimizer.step(grads, self.opt_state, self.params, lr)
        del grads
        self.scaler_state = ls.update_state(self.scaler_cfg, self.scaler_state, overflow)
        self._after_step(loss, grad_norm, overflow)
        return loss

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

    def eval_batch(self, batch):
        """The loss of one batch (no grads, no update)."""
        batch = {k: torch.as_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v)).to(
            self.device) for k, v in batch.items()}
        with torch.no_grad():
            return self._loss(self.params, batch)

    # ------------------------------------------------------------------
    # not in this slice
    # ------------------------------------------------------------------
    def forward(self, *a, **k):
        raise _later("the imperative forward/backward/step API (use train_batch)",
                     "ROADMAP queue 1, item 3")

    __call__ = forward
    backward = forward
    step = forward

    def save_checkpoint(self, *a, **k):
        raise _later("checkpoints", "ROADMAP queue 1, item 8")

    load_checkpoint = save_checkpoint


__all__ = ["DeepSpeedEngine"]
