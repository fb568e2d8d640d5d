"""Optimizers with fp32 master weights, in the port.

Counterpart of ``deepspeed_tpu/runtime/optimizers.py``: a
:class:`DeepSpeedOptimizer` keeps an fp32 master copy of the (possibly
bf16/fp16) model params and its moments; ``step`` consumes fp32 grads and
writes new half-precision params from the masters (never a half-precision
delta added to half-precision params).

Adam and AdamW follow the JAX package's optax chain in optax's order of
operations, written with plain torch:

    mu = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * g^2 + b2 * nu
    u  = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
    u  = u + wd * master                      (AdamW's decoupled decay)
    master = master + (-u) * lr               (scale by -1, then by lr)

(``torch.optim.AdamW`` folds the decay and the lr in another order and
rounds differently.) Adam with ``adam_w_mode=False`` adds ``wd * master`` to
the gradient first, as ``optax.chain(add_decayed_weights, adam)``.

The port runs eagerly, so ``step`` updates the masters, the moments and the
params in place, one leaf at a time (no whole-model temporaries); the
engine skips it on an fp16 overflow, which leaves everything unchanged.
FusedAdam (its Pallas kernel), Lamb, Lion, Adagrad, SGD, Muon and the 1-bit
family raise ``NotImplementedError``.
"""

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import logger

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
CPU_ADAM = "deepspeedcpuadam"
_LATER = {
    "fusedadam": "ROADMAP queue 2, item 7: the FusedAdam kernel",
    "lamb": "ROADMAP queue 1, item 3", "fusedlamb": "ROADMAP queue 1, item 3",
    "lion": "ROADMAP queue 1, item 3", "fusedlion": "ROADMAP queue 1, item 3",
    "adagrad": "ROADMAP queue 1, item 3", "sgd": "ROADMAP queue 1, item 3",
    "muon": "ROADMAP queue 1, item 3",
    "onebitadam": "ROADMAP queue 1, item 6", "zerooneadam": "ROADMAP queue 1, item 6",
    "onebitlamb": "ROADMAP queue 1, item 6", "zenflowselectiveadam": "ROADMAP queue 1, item 7",
}


class OptState(NamedTuple):
    master: Dict[str, Any]  # fp32 master params, the params' tree
    inner: Dict[str, Any]  # {"count": int, "mu": tree, "nu": tree}


def _leaves(tree, prefix=""):
    """(path, tensor) pairs of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def tree_map(fn, tree, *rest):
    return {
        k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
        else fn(v, *(r[k] for r in rest))
        for k, v in tree.items()
    }


class DeepSpeedOptimizer:
    """Adam/AdamW over fp32 masters. ``step(grads_fp32, state, params, lr)``."""

    def __init__(self, name: str, defaults: dict, adamw: bool = True):
        self.name = name
        self.defaults = dict(defaults)
        self.adamw = adamw
        self._lr = defaults.get("lr", 1e-3)

    def set_lr(self, lr):
        self._lr = lr

    def get_lr(self):
        return self._lr

    def init(self, params) -> OptState:
        master = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
        zeros = lambda m: torch.zeros_like(m)  # noqa: E731
        return OptState(master=master, inner={"count": 0, "mu": tree_map(zeros, master),
                                              "nu": tree_map(zeros, master)})

    @torch.no_grad()
    def step(self, grads, state: OptState, params, lr) -> OptState:
        """One update in place: masters, moments and the params (rounded
        from the masters to their own dtype). ``grads`` fp32, the params'
        tree."""
        d = self.defaults
        b1, b2 = (float(x) for x in d["betas"])
        eps, wd = float(d["eps"]), float(d["weight_decay"])
        count = state.inner["count"] + 1
        # bias corrections in fp32, as optax computes 1 - decay ** count
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        lr = float(np.float32(lr))
        for (_, m), (_, g), (_, mu), (_, nu), (_, p) in zip(
            _leaves(state.master), _leaves(grads), _leaves(state.inner["mu"]),
            _leaves(state.inner["nu"]), _leaves(params),
        ):
            g = g.float()
            if wd and not self.adamw:
                g = g + wd * m
            mu.mul_(b1).add_(g * (1 - b1))
            nu.mul_(b2).add_(g.square() * (1 - b2))
            u = (mu / bc1) / ((nu / bc2).sqrt() + eps)
            if wd and self.adamw:
                u.add_(m * wd)
            m.add_(u.neg_().mul_(lr))
            p.copy_(m)
        return OptState(master=state.master, inner=dict(state.inner, count=count))


def build_optimizer(opt_config) -> DeepSpeedOptimizer:
    """Map a DeepSpeed ``optimizer`` config section to a DeepSpeedOptimizer
    (Adam/AdamW/DeepSpeedCPUAdam as AdamW or Adam; others raise)."""
    name = (opt_config.type or ADAMW_OPTIMIZER).lower()
    params = dict(opt_config.params or {})
    lr = params.pop("lr", 1e-3)
    weight_decay = params.pop("weight_decay", 0.0)
    betas = tuple(params.pop("betas", (0.9, 0.999)))
    eps = params.pop("eps", 1e-8)
    adam_w_mode = params.pop("adam_w_mode", True)
    if name in _LATER:
        raise NotImplementedError(f"optimizer {opt_config.type!r} is not ported yet ({_LATER[name]})")
    if name not in (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, CPU_ADAM):
        raise ValueError(f"Unknown optimizer type {opt_config.type}")
    is_adamw = name == ADAMW_OPTIMIZER or adam_w_mode
    canonical = "adamw" if is_adamw else "adam"
    logger.info(f"Using optimizer: {canonical} (lr={lr}, wd={weight_decay})")
    return DeepSpeedOptimizer(
        canonical, {"lr": lr, "betas": betas, "eps": eps, "weight_decay": weight_decay},
        adamw=is_adamw,
    )


def global_grad_norm(grads) -> torch.Tensor:
    """Global L2 norm over the whole grad tree, in fp32 (leaf sums of
    squares added in tree order)."""
    leaves = [g for _, g in _leaves(grads)]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    sq = sum(g.float().square().sum() for g in leaves)
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm, norm=None):
    """Scale every grad in place by min(1, max_norm / (norm + 1e-6));
    returns (grads, norm)."""
    if norm is None:
        norm = global_grad_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for _, g in _leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


__all__ = [
    "DeepSpeedOptimizer", "OptState", "build_optimizer", "clip_by_global_norm",
    "global_grad_norm", "tree_map",
]
