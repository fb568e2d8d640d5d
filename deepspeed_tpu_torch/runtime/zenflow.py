"""ZenFlow: the stall-free selective optimizer.

Counterpart of ``deepspeed_tpu/runtime/zenflow.py`` (reference
``runtime/zenflow/``: ``ZenFlowConfig``, ``ZenFlowZeroOptimizer``, the
selective AdamW). The ``topk_ratio`` most important gradient columns of
each matrix are updated every step with a small selective Adam state;
everything else accumulates and reaches the fp32 master every
``update_interval`` steps.

Step semantics (c = the step count after this step):
  c <= warmup              : full AdamW on the master with this step's grads
  off-boundary step        : selective AdamW on the selected columns of each
                             2-D param (in its dtype); grads with the
                             selected columns zeroed add into ``acc``
  c % update_interval == 0 : fold the selected columns back into the master,
                             full AdamW with the mean accumulated grad,
                             params from the master, columns reselected from
                             this step's column norms when due, selective
                             moments and ``acc`` reset

The JAX module runs both branches in one compiled step under ``lax.cond``;
here the step count is a host integer, so the boundary is a host-side
branch. The state stays where the params live (the JAX engine keeps it on
the device too), and every update is in place.
"""

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.config_utils import ConfigError, DSConfigModel
from deepspeed_tpu_torch.runtime.optimizers import DeepSpeedOptimizer
from deepspeed_tpu_torch.utils.tree import leaves as _leaves, tree_map

LEAF_FIELDS = ("indices", "sel_m", "sel_v", "acc", "master", "m", "v")
COUNTS = ("count", "full_steps", "sel_steps", "acc_steps")


@dataclass
class ZenFlowConfig(DSConfigModel):
    """``zenflow`` config section (reference zenflow_config.py:12)."""

    topk_ratio: float = 0.1
    select_strategy: str = "auto"  # auto | step | epoch
    select_interval: Any = "auto"
    update_interval: Any = "auto"
    overlap_step: bool = False  # kept for the reference's config
    offload: bool = False
    auto_ratio: float = 0.99  # kept for the reference's config
    full_warm_up_rounds: int = 0
    steps_per_epoch: Any = None
    pt_reserved_cores_perc: float = 0.5  # kept for the reference's config

    def _validate(self):
        if not 0.0 <= self.topk_ratio <= 1.0:
            raise ConfigError("zenflow.topk_ratio must be in [0, 1]")
        if self.select_strategy not in ("auto", "step", "epoch"):
            raise ConfigError("zenflow.select_strategy must be auto|step|epoch")

    def resolved_intervals(self):
        """(select_interval, update_interval) in steps: "auto" reselects each
        epoch (steps_per_epoch, else every 100 steps) and applies the
        accumulator every 4 steps; selection is rounded to a multiple of
        the update interval."""
        sel = self.select_interval
        if sel == "auto" or sel is None:
            sel = self.steps_per_epoch or 100
        upd = self.update_interval
        if upd == "auto" or upd is None:
            upd = 4
        sel, upd = int(sel), int(upd)
        if sel % upd:
            sel = max(upd, (sel // upd) * upd)
        return sel, upd


def _is_matrix(p):
    return p.dim() == 2


def _div(a, c):
    """a / c by IEEE division on every device: CUDA divides by a host scalar
    as a product with its reciprocal, so the divisor is a 0-d tensor beside
    ``a`` (a card's step then equals the host's)."""
    return a / torch.tensor(float(c), dtype=a.dtype, device=a.device)


class ZenFlowOptimizer(DeepSpeedOptimizer):
    """A DeepSpeedOptimizer whose ``step`` runs the ZenFlow schedule. Its
    state is a dict: one tree per field of ``LEAF_FIELDS`` (the params'
    paths) and the four counts."""

    def __init__(self, cfg: ZenFlowConfig, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0):
        self.cfg = cfg
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps = float(eps)
        self.wd = float(weight_decay)
        self.select_interval, self.update_interval = cfg.resolved_intervals()
        self.warmup = int(cfg.full_warm_up_rounds)
        super().__init__(tx=None, name="zenflow", defaults={
            "lr": lr, "betas": betas, "eps": eps, "weight_decay": weight_decay})

    def _k(self, p):
        if not _is_matrix(p):
            return 0
        cols = p.shape[1]
        return min(max(1, int(round(self.cfg.topk_ratio * cols))), cols)

    def init(self, params):
        def field(name):
            def leaf(p):
                k, rows = self._k(p), (p.shape[0] if _is_matrix(p) else 0)
                f32 = dict(dtype=torch.float32, device=p.device)
                if name == "indices":
                    # distinct first columns: the scatter needs distinct indices
                    return torch.arange(k, dtype=torch.int64, device=p.device)
                if name in ("sel_m", "sel_v"):
                    return torch.zeros((rows, k), **f32)
                if name == "master":
                    return p.detach().to(torch.float32, copy=True)
                return torch.zeros(p.shape, **f32)
            return tree_map(leaf, params)

        state = {f: field(f) for f in LEAF_FIELDS}
        state.update({c: 0 for c in COUNTS})
        return state

    def _adam(self, g, m, v, t, lr):
        """In place on m, v; returns the update lr * mhat / (sqrt(vhat) + eps)."""
        b1, b2 = self.b1, self.b2
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        t = np.float32(max(t, 1))
        mhat = _div(m, np.float32(1) - np.float32(b1) ** t)
        vhat = _div(v, np.float32(1) - np.float32(b2) ** t)
        return lr * mhat / (vhat.sqrt() + self.eps)

    @torch.no_grad()
    def step(self, grads, state, params, lr):
        c = state["count"] + 1
        warm = c <= self.warmup
        boundary = warm or c % self.update_interval == 0
        # the first post-warmup boundary picks the first columns (in warmup
        # full_steps advances once a step, so equals warmup exactly there)
        resel_due = state["full_steps"] == self.warmup or c % self.select_interval == 0
        lr = float(np.float32(lr))
        rows = list(zip(*(dict(_leaves(t)).values() for t in (
            params, grads, *(state[f] for f in LEAF_FIELDS)))))
        sel_t = state["sel_steps"] + 1
        lr_wd = float(np.float32(lr) * np.float32(self.wd))  # lr * wd in fp32, as jnp's
        for p, g, idx, sel_m, sel_v, acc, master, m, v in rows:
            g32 = g.float()
            if warm or not _is_matrix(p):
                acc.add_(g32)
                continue
            gsel = g32[:, idx]
            psel = p[:, idx].float()
            upd = self._adam(gsel, sel_m, sel_v, sel_t, lr)
            if self.wd:
                upd = upd + lr_wd * psel
            p[:, idx] = (psel - upd).to(p.dtype)
            acc.add_(g32)
            acc[:, idx] -= gsel
        state = dict(state, count=c, acc_steps=state["acc_steps"] + 1,
                     sel_steps=state["sel_steps"] if warm else state["sel_steps"] + 1)
        if not boundary:
            return state
        nsteps = max(state["acc_steps"], 1)
        t = state["full_steps"] + 1
        for p, g, idx, sel_m, sel_v, acc, master, m, v in rows:
            if _is_matrix(p) and not warm:
                master[:, idx] = p[:, idx].float()
            upd = self._adam(_div(acc, nsteps), m, v, t, lr)
            if self.wd:
                upd = upd + lr_wd * master
            master.sub_(upd)
            p.copy_(master)
            if _is_matrix(p) and resel_due:
                imp = g.float().square().sum(dim=0)  # column importance
                idx.copy_(torch.topk(imp, idx.shape[0]).indices)
                sel_m.zero_()
                sel_v.zero_()
            acc.zero_()
        return dict(state, full_steps=t, acc_steps=0,
                    sel_steps=0 if resel_due else state["sel_steps"])

    # -- checkpoints: the JAX state's flatten order --
    def checkpoint_payload(self, state):
        """(per param path: the seven leaf fields in the JAX NamedTuple's
        order, then the four counts)."""
        per_leaf = tree_map(lambda *fs: tuple(fs), *(state[f] for f in LEAF_FIELDS))
        return (per_leaf, *(np.int32(state[c]) for c in COUNTS))

    def restore_counts(self, state, scalars):
        return dict(state, **{c: int(v) for c, v in zip(COUNTS, scalars)})


def build_zenflow_optimizer(zf_cfg_dict, opt_config) -> ZenFlowOptimizer:
    """The engine's hook: the ``zenflow`` section and an Adam-family
    ``optimizer`` section (reference engine.py:351-356)."""
    cfg = ZenFlowConfig.from_dict(dict(zf_cfg_dict))
    p = dict(opt_config.params or {})
    return ZenFlowOptimizer(cfg, lr=p.get("lr", 1e-3), betas=tuple(p.get("betas", (0.9, 0.999))),
                            eps=p.get("eps", 1e-8), weight_decay=p.get("weight_decay", 0.0))


__all__ = ["ZenFlowConfig", "ZenFlowOptimizer", "build_zenflow_optimizer"]
