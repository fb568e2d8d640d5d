"""Optimizers with fp32 master weights, in the port.

Counterpart of ``deepspeed_tpu/runtime/optimizers.py``: a
:class:`DeepSpeedOptimizer` keeps an fp32 master copy of the (possibly
bf16/fp16) model params and an inner transform's state; ``step`` consumes
fp32 grads and writes new half-precision params from the masters (never a
half-precision delta added to half-precision params).

The transforms, one class each, follow the JAX package's choices:

  * ``FusedAdam``: ``ops/adam/fused_adam.py`` (the CUDA kernel on a card),
    in ``_adam_math``'s order of operations. The JAX engine forms ``master +
    (p_new - master)``; the port writes ``p_new`` and the half-precision
    param in the same pass, a difference of at most one fp32 ulp.
  * Adam / AdamW / DeepSpeedCPUAdam, Lamb / FusedLamb, Lion / FusedLion,
    Adagrad, SGD: plain torch in optax's order of operations (they are plain
    optax in the JAX package, so no kernel). For Adam and AdamW:

        mu = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * g^2 + b2 * nu
        u  = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
        u  = u + wd * master                      (AdamW's decoupled decay)
        master = master + (-u) * lr               (scale by -1, then by lr)

    (``torch.optim.AdamW`` folds the decay and the lr in another order and
    rounds differently.) Adam with ``adam_w_mode=False`` adds ``wd *
    master`` to the gradient first, as ``optax.chain(add_decayed_weights,
    adam)``; SGD with decay likewise.
  * Muon: ``ops/muon.py`` (Newton-Schulz on 2-D leaves, Adam elsewhere).

The port runs eagerly, so ``step`` updates the masters, the inner state and
the params in place, one leaf at a time (no whole-model temporaries); the
engine skips it on an fp16 overflow, which leaves everything unchanged.
Each transform names its state's fields in the order the JAX package's
state flattens (``state_fields``), which is the order of a checkpoint's
entries. The 1-bit family raises ``NotImplementedError``;
``zenflowselectiveadam`` is Adam / AdamW here, as in the JAX package (the
engine's ``zenflow`` section builds ``runtime/zenflow.py``'s optimizer).

``TorchOptimizer`` takes a client's ``torch.optim.Optimizer`` (the JAX
package takes a raw optax transform there): its params are re-pointed at
the fp32 masters, so it steps them with torch's own math, and the engine's
learning rate drives its ``param_groups``.
"""

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.tree import leaves as _leaves, tree_map

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM = "fusedadam"
CPU_ADAM = "deepspeedcpuadam"
LAMB_OPTIMIZER = "lamb"
FUSED_LAMB = "fusedlamb"
LION_OPTIMIZER = "lion"
FUSED_LION = "fusedlion"
ADAGRAD_OPTIMIZER = "adagrad"
SGD_OPTIMIZER = "sgd"
MUON_OPTIMIZER = "muon"
ZENFLOW_ADAM = "zenflowselectiveadam"
_LATER = {
    "onebitadam": "ROADMAP queue 1, item 6", "zerooneadam": "ROADMAP queue 1, item 6",
    "onebitlamb": "ROADMAP queue 1, item 6",
}


class OptState(NamedTuple):
    master: Dict[str, Any]  # fp32 master params, the params' tree
    inner: Dict[str, Any]  # the transform's state, e.g. {"count": int, "mu": tree, "nu": tree}


def _bias_corrections(b1, b2, count):
    """1 - decay ** count in fp32, as optax computes them."""
    return (float(np.float32(1) - np.float32(b1) ** np.float32(count)),
            float(np.float32(1) - np.float32(b2) ** np.float32(count)))


def _zeros(master):
    return tree_map(torch.zeros_like, master)


class _Transform:
    """An inner optimizer: ``init(master) -> state`` (a dict) and
    ``step(grads, state, master, lr, params) -> state``, in place on the
    masters and the state's tensors; ``params`` (the model's copies) are
    rewritten from the masters."""

    state_fields = ()

    def init(self, master):
        raise NotImplementedError

    def step(self, grads, state, master, lr, params):
        raise NotImplementedError

    @staticmethod
    def _write_params(master, params):
        for (_, m), (_, p) in zip(_leaves(master), _leaves(params)):
            if p is not m:
                p.copy_(m)


class _Adam(_Transform):
    """optax.adamw, or optax.adam behind add_decayed_weights."""

    state_fields = ("count", "mu", "nu")

    def __init__(self, b1, b2, eps, wd, adamw):
        self.b1, self.b2, self.eps, self.wd, self.adamw = b1, b2, eps, wd, adamw

    def init(self, master):
        return {"count": 0, "mu": _zeros(master), "nu": _zeros(master)}

    def step(self, grads, state, master, lr, params):
        b1, b2, eps, wd = self.b1, self.b2, self.eps, self.wd
        count = state["count"] + 1
        bc1, bc2 = _bias_corrections(b1, b2, count)
        for (_, m), (_, g), (_, mu), (_, nu), (_, p) in zip(
            _leaves(master), _leaves(grads), _leaves(state["mu"]), _leaves(state["nu"]),
            _leaves(params),
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
            if p is not m:
                p.copy_(m)
        return dict(state, count=count)


class _FusedAdam(_Transform):
    """``ops.adam.FusedAdam``: the kernel writes masters, moments and the
    half-precision params in one pass."""

    state_fields = ("m", "v", "count")

    def __init__(self, fused):
        self.fused = fused

    def init(self, master):
        return self.fused.init(master)

    def step(self, grads, state, master, lr, params):
        return self.fused.step(grads, state, master, lr, params=params)


class _Lamb(_Transform):
    """optax.lamb: scale_by_adam, add_decayed_weights, scale_by_trust_ratio
    (per leaf: |param| / |update|, 1 when either norm is 0)."""

    state_fields = ("count", "mu", "nu")

    def __init__(self, b1, b2, eps, wd):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, wd

    init = _Adam.init

    def step(self, grads, state, master, lr, params):
        b1, b2 = self.b1, self.b2
        count = state["count"] + 1
        bc1, bc2 = _bias_corrections(b1, b2, count)
        for (_, m), (_, g), (_, mu), (_, nu) in zip(
            _leaves(master), _leaves(grads), _leaves(state["mu"]), _leaves(state["nu"]),
        ):
            g = g.float()
            mu.mul_(b1).add_(g * (1 - b1))
            nu.mul_(b2).add_(g.square() * (1 - b2))
            u = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
            if self.wd:
                u.add_(m * self.wd)
            p_norm, u_norm = torch.linalg.vector_norm(m), torch.linalg.vector_norm(u)
            ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                p_norm / u_norm)
            m.add_(u.mul_(ratio).neg_().mul_(lr))
        self._write_params(master, params)
        return dict(state, count=count)


class _Lion(_Transform):
    """optax.lion: sign((1 - b1) g + b1 mu), then mu = (1 - b2) g + b2 mu."""

    state_fields = ("count", "mu")

    def __init__(self, b1, b2, wd):
        self.b1, self.b2, self.wd = b1, b2, wd

    def init(self, master):
        return {"count": 0, "mu": _zeros(master)}

    def step(self, grads, state, master, lr, params):
        b1, b2 = self.b1, self.b2
        for (_, m), (_, g), (_, mu) in zip(_leaves(master), _leaves(grads),
                                           _leaves(state["mu"])):
            g = g.float()
            u = torch.sign((1.0 - b1) * g + b1 * mu)
            mu.mul_(b2).add_((1 - b2) * g)
            if self.wd:
                u.add_(m * self.wd)
            m.add_(u.neg_().mul_(lr))
        self._write_params(master, params)
        return dict(state, count=state["count"] + 1)


class _Adagrad(_Transform):
    """optax.adagrad: sum of squares from 0.1, update g * rsqrt(sum + eps)."""

    state_fields = ("sum_of_squares",)

    def __init__(self, eps, initial_accumulator_value=0.1):
        self.eps, self.init_value = eps, initial_accumulator_value

    def init(self, master):
        return {"sum_of_squares": tree_map(lambda m: torch.full_like(m, self.init_value), master)}

    def step(self, grads, state, master, lr, params):
        for (_, m), (_, g), (_, ss) in zip(_leaves(master), _leaves(grads),
                                           _leaves(state["sum_of_squares"])):
            g = g.float()
            ss.add_(g.square())
            inv = torch.where(ss > 0, torch.rsqrt(ss + self.eps), torch.zeros_like(ss))
            m.add_((inv * g).neg_().mul_(lr))
        self._write_params(master, params)
        return state


class _SGD(_Transform):
    """optax.sgd (a momentum trace, optionally Nesterov) behind
    add_decayed_weights."""

    def __init__(self, momentum, nesterov, wd):
        self.momentum, self.nesterov, self.wd = momentum, nesterov, wd
        self.state_fields = ("trace",) if momentum else ()

    def init(self, master):
        return {"trace": _zeros(master)} if self.momentum else {}

    def step(self, grads, state, master, lr, params):
        traces = _leaves(state["trace"]) if self.momentum else ((None, None) for _ in iter(int, 1))
        for (_, m), (_, g), (_, tr) in zip(_leaves(master), _leaves(grads), traces):
            u = g.float()
            if self.wd:
                u = u + self.wd * m
            if self.momentum:
                tr.mul_(self.momentum).add_(u)
                u = u + self.momentum * tr if self.nesterov else tr.clone()
            elif u is g:
                u = u.clone()
            m.add_(u.neg_().mul_(lr))
        self._write_params(master, params)
        return state


class DeepSpeedOptimizer:
    """An inner transform over fp32 masters.
    ``step(grads_fp32, state, params, lr) -> state``."""

    def __init__(self, tx: _Transform, name: str, defaults: dict):
        self.tx = tx
        self.name = name
        self.defaults = dict(defaults)
        self._lr = defaults.get("lr", 1e-3)

    def set_lr(self, lr):
        self._lr = lr

    def get_lr(self):
        return self._lr

    @property
    def param_groups(self):
        return [{"lr": self._lr, **self.defaults}]

    def init(self, params) -> OptState:
        master = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
        return OptState(master=master, inner=self.tx.init(master))

    @torch.no_grad()
    def step(self, grads, state: OptState, params, lr) -> OptState:
        """One update in place: masters, inner state and the params
        (rounded from the masters to their own dtype). ``grads`` fp32, the
        params' tree."""
        lr = float(np.float32(lr))
        inner = self.tx.step(grads, state.inner, state.master, lr, params)
        return OptState(master=state.master, inner=inner)


class TorchOptimizer(DeepSpeedOptimizer):
    """A client ``torch.optim.Optimizer`` over the engine's fp32 masters.

    The optimizer must be built over leaves of one of ``trees`` (the
    ``model_parameters`` the engine was given, or the engine's own params);
    ``init`` swaps each of them in ``param_groups`` for the master of the
    same leaf, so the user's tensors are never written. Leaves it does not
    hold stay frozen. ``step`` sets each group's lr to the engine's lr times
    the group's lr over the first group's at construction (so groups keep
    their ratios and, without a schedule, their own lr), hands the fp32
    grads over as ``.grad``, steps, and writes the params from the masters.
    Its state (``state_tree``) goes into a checkpoint after the masters."""

    def __init__(self, optimizer: torch.optim.Optimizer, trees):
        if optimizer.state:
            raise ValueError("TorchOptimizer: the client optimizer has stepped already; "
                             "pass a fresh one")
        self.optimizer = optimizer
        self.name = type(optimizer).__name__.lower()
        self.defaults = dict(optimizer.defaults)
        self.tx = None
        base = float(optimizer.param_groups[0]["lr"])
        self._lr = base
        self._ratios = [float(g["lr"]) / base if base else 1.0 for g in optimizer.param_groups]
        paths = {}
        for tree in trees:
            for path, leaf in _leaves(tree):
                paths.setdefault(id(leaf), path)
        self._paths = []
        for g in optimizer.param_groups:
            for p in g["params"]:
                if id(p) not in paths:
                    raise ValueError("TorchOptimizer: the client optimizer holds a tensor that "
                                     "is not one of model_parameters")
                self._paths.append(paths[id(p)])
        self._held = set(self._paths)

    def get_lr(self):
        return self._lr

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def init(self, params) -> OptState:
        state = OptState(master=tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                                         params), inner={})
        self.repoint(state.master)
        return state

    def repoint(self, master):
        """Point the optimizer's param groups at the leaves of ``master``
        (``init``'s masters, or their host copies under offload)."""
        masters = dict(_leaves(master))
        it = iter(self._paths)
        for g in self.optimizer.param_groups:
            g["params"] = [masters[next(it)] for _ in g["params"]]

    @torch.no_grad()
    def step(self, grads, state: OptState, params, lr) -> OptState:
        self._lr = float(lr)
        for g, ratio in zip(self.optimizer.param_groups, self._ratios):
            g["lr"] = self._lr * ratio
        pairs = [(path, m, g, p) for (path, m), (_, g), (_, p) in
                 zip(_leaves(state.master), _leaves(grads), _leaves(params))
                 if path in self._held]
        for _, m, g, _ in pairs:
            m.grad = g if g.dtype == m.dtype else g.to(m.dtype)
        self.optimizer.step()
        for _, m, _, p in pairs:
            m.grad = None
            if p is not m:
                p.copy_(m)
        return state

    def state_tree(self):
        """The torch optimizer's per-param state, keyed by param index (as
        ``state_dict()`` numbers them) and state name."""
        return {str(i): dict(st) for i, st in self.optimizer.state_dict()["state"].items()}

    def load_state_tree(self, tree):
        sd = self.optimizer.state_dict()
        sd["state"] = {int(i): st for i, st in tree.items()}
        self.optimizer.load_state_dict(sd)


def build_optimizer(opt_config) -> DeepSpeedOptimizer:
    """Map a DeepSpeed ``optimizer`` config section to a DeepSpeedOptimizer
    (the JAX package's ``build_optimizer``; the 1-bit family raises)."""
    name = (opt_config.type or ADAMW_OPTIMIZER).lower()
    params = dict(opt_config.params or {})
    lr = params.pop("lr", 1e-3)
    weight_decay = params.pop("weight_decay", 0.0)
    betas = tuple(params.pop("betas", (0.9, 0.999)))
    eps = params.pop("eps", 1e-8)
    adam_w_mode = params.pop("adam_w_mode", True)
    momentum = params.pop("momentum", 0.0)
    if name in _LATER:
        raise NotImplementedError(f"optimizer {opt_config.type!r} is not ported yet ({_LATER[name]})")
    if name == FUSED_ADAM:
        from deepspeed_tpu_torch.ops.adam import FusedAdam

        tx = _FusedAdam(FusedAdam(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                  adam_w_mode=adam_w_mode,
                                  bias_correction=params.pop("bias_correction", True)))
        canonical = "fused_adam"
    elif name in (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, CPU_ADAM, ZENFLOW_ADAM):
        is_adamw = name == ADAMW_OPTIMIZER or adam_w_mode
        tx = _Adam(float(betas[0]), float(betas[1]), float(eps), float(weight_decay), is_adamw)
        canonical = "adamw" if is_adamw else "adam"
    elif name in (LAMB_OPTIMIZER, FUSED_LAMB):
        tx = _Lamb(float(betas[0]), float(betas[1]), float(eps), float(weight_decay))
        canonical = "lamb"
    elif name in (LION_OPTIMIZER, FUSED_LION):
        b = betas if len(betas) == 2 else (0.9, 0.99)
        tx = _Lion(float(b[0]), float(b[1]), float(weight_decay))
        canonical = "lion"
    elif name == ADAGRAD_OPTIMIZER:
        tx = _Adagrad(max(float(eps), 1e-10))
        canonical = "adagrad"
    elif name == SGD_OPTIMIZER:
        tx = _SGD(float(momentum or 0.0), bool(params.pop("nesterov", False)), float(weight_decay))
        canonical = "sgd"
    elif name == MUON_OPTIMIZER:
        from deepspeed_tpu_torch.ops.muon import MuonTransform

        # the JAX package pops "momentum" once (above, default 0.0) and
        # again for Muon's beta, which therefore always takes its default
        tx = MuonTransform(beta=params.pop("momentum", 0.95), weight_decay=weight_decay,
                           adam_betas=betas, eps=eps)
        canonical = "muon"
    else:
        raise ValueError(f"Unknown optimizer type {opt_config.type}")
    logger.info(f"Using optimizer: {canonical} (lr={lr}, wd={weight_decay})")
    return DeepSpeedOptimizer(
        tx, canonical, {"lr": lr, "betas": betas, "eps": eps, "weight_decay": weight_decay})


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
    "DeepSpeedOptimizer", "OptState", "TorchOptimizer", "build_optimizer",
    "clip_by_global_norm", "global_grad_norm", "tree_map",
]
