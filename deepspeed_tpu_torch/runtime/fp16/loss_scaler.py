"""Loss scaling for fp16 training, in the port.

Counterpart of ``deepspeed_tpu/runtime/fp16/loss_scaler.py``: the same
static/dynamic config (``make_config`` from the ``fp16`` section), the same
state (scale, good steps, hysteresis) and the same update rule. The JAX
package threads the state through its jitted step as arrays; the port runs
eagerly, so the state is plain Python numbers on the host and
``has_overflow`` returns a 0-dim bool tensor the engine reads once per step
(only when it checks for overflow: fp16, or ``check_grad_overflow``).

  * grads are computed on ``loss * scale`` then multiplied by ``1/scale``;
  * overflow = any non-finite gradient element;
  * on overflow the optimizer step is skipped (params and optimizer state
    unchanged), the hysteresis is burnt or the scale divided by the factor
    (floored at ``min_scale``);
  * after ``scale_window`` good steps in a row the scale is multiplied by
    the factor.
"""

from typing import NamedTuple

import torch


class LossScaleState(NamedTuple):
    scale: float
    good_steps: int  # since the last overflow or raise
    hysteresis: int  # overflows still tolerated before the scale drops


class LossScalerConfig(NamedTuple):
    dynamic: bool
    init_scale: float
    scale_factor: float
    scale_window: int
    min_scale: float
    delayed_shift: int
    consecutive_hysteresis: bool


STATIC_UNIT = LossScalerConfig(False, 1.0, 2.0, 1000, 1.0, 1, False)


def make_config(fp16_cfg) -> LossScalerConfig:
    """From the fp16 config section: a positive ``loss_scale`` is static,
    0 is dynamic from ``2 ** initial_scale_power``."""
    static = float(fp16_cfg.loss_scale or 0.0)
    if static > 0:
        return LossScalerConfig(False, static, 2.0, 1000, 1.0, 1, False)
    return LossScalerConfig(
        True,
        2.0 ** fp16_cfg.initial_scale_power,
        2.0,
        fp16_cfg.loss_scale_window,
        fp16_cfg.min_loss_scale,
        fp16_cfg.hysteresis,
        fp16_cfg.consecutive_hysteresis,
    )


def init_state(cfg: LossScalerConfig) -> LossScaleState:
    return LossScaleState(scale=float(cfg.init_scale), good_steps=0,
                          hysteresis=int(cfg.delayed_shift))


def has_overflow(grads) -> torch.Tensor:
    """0-dim bool tensor: True if any element of any grad is NaN or Inf.
    ``grads``: a list of tensors."""
    leaves = list(grads)
    if not leaves:
        return torch.zeros((), dtype=torch.bool)
    bad = [~torch.isfinite(g).all() for g in leaves]
    return torch.stack(bad).any()


def update_state(cfg: LossScalerConfig, state: LossScaleState, overflow: bool) -> LossScaleState:
    """Post-step scale adjustment (reference DynamicLossScaler.update_scale)."""
    if not cfg.dynamic:
        return state
    if overflow:
        if state.hysteresis > 1:
            return LossScaleState(state.scale, 0, state.hysteresis - 1)
        return LossScaleState(max(state.scale / cfg.scale_factor, cfg.min_scale), 0,
                              state.hysteresis)
    window_hit = (state.good_steps + 1) % cfg.scale_window == 0
    scale = state.scale * cfg.scale_factor if window_hit else state.scale
    hyst = int(cfg.delayed_shift) if cfg.consecutive_hysteresis else state.hysteresis
    return LossScaleState(scale, state.good_steps + 1, hyst)
