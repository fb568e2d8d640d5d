"""Top-k gated MoE with capacity-padded einsum dispatch (plain PyTorch).

Counterpart of ``deepspeed_tpu/parallel/moe/sharded_moe.py``, with its
semantics (the reference's gate functions, moe/sharded_moe.py):

  * capacity = ceil(tokens * capacity_factor / experts), at least
    ``min_capacity`` (``_capacity``), of the tokens in one call;
  * ``top1gating``: optional Gumbel noise (``noisy_gate_policy="RSample"``,
    drawn from a ``torch.Generator``, so noisy gates do not repeat the JAX
    package's draws), the load-balancing aux loss E * mean(gates) .
    mean(mask);
  * ``top2gating``: top-k at k 2 with choice-priority drops and the
    reference's top-2 aux loss over the first choices;
  * ``topkgating``: general k, three drop policies, combine weights
    renormalized over the surviving experts (``normalize``);
  * tokens over capacity are dropped: their combine weights are zero.

Ties: the top k and the per-expert rankings come from stable sorts (lower
index first), as ``jax.lax.top_k`` and ``jnp.argsort`` order them;
``torch.topk`` does not promise an order among equal values. Dispatch and
combine are the GShard one-hot einsums of the JAX package's single-device
path ([t, e, c] masks; the combine weights rounded to the activation dtype
before the combine einsum, as ``combine.astype(x.dtype)``), not gathers.
"""

import math
from typing import Optional, Tuple

import torch

F = torch.nn.functional


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int = 4) -> int:
    """ceil(tokens * cf / experts), at least ``min_capacity``."""
    return max(math.ceil(num_tokens * capacity_factor / num_experts), min_capacity)


def _one_hot(idx, n: int):
    """fp32 one-hot of ``idx`` over ``n`` classes; an index outside [0, n)
    gives a zero row, as ``jax.nn.one_hot``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _top_k(gates, k: int):
    """The k largest values of each row and their indices, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _position_in_expert(expert_mask):
    """Each token's 0-based slot in its chosen expert: [s, e]."""
    return torch.cumsum(expert_mask, dim=0) - expert_mask


def top1gating(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
               noisy_gate_policy: Optional[str] = None,
               rng: Optional[torch.Generator] = None, drop_tokens: bool = True):
    """logits [s, e] -> (l_aux, combine [s, e, c], dispatch [s, e, c] bool,
    exp_counts [e]). ``drop_tokens=False`` sizes capacity for the worst
    case (every token to one expert)."""
    s, e = logits.shape
    c = s if not drop_tokens else _capacity(s, e, capacity_factor, min_capacity)
    if noisy_gate_policy == "RSample" and rng is not None:
        u = torch.rand(logits.shape, generator=rng, device=logits.device, dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        logits_w_noise = logits + gumbel.to(logits.dtype)
    else:
        logits_w_noise = logits
    gates = torch.softmax(logits.float(), dim=-1)
    mask1 = _one_hot(torch.argmax(logits_w_noise, dim=-1), e)
    exp_counts = mask1.sum(dim=0)
    me = gates.mean(dim=0)
    ce = mask1.mean(dim=0)
    l_aux = (me * ce).sum() * e
    locations1 = _position_in_expert(mask1)
    if drop_tokens:
        mask1 = mask1 * (locations1 < c).float()
    pos = (locations1 * mask1).sum(dim=-1).int()
    gates1 = (gates * mask1).sum(dim=-1)
    combine = gates1[:, None, None] * mask1[:, :, None] * _one_hot(pos, c)[:, None, :]
    return l_aux, combine, combine > 0, exp_counts


def top2gating(logits, capacity_factor: float = 1.0, min_capacity: int = 4):
    """The reference's top-2: ``topkgating`` at k 2 with choice-priority
    drops (first choices outrank second ones), and the aux loss over the
    first choices alone, E * mean(gates) . mean(first-choice mask)."""
    _, combine, dispatch, exp_counts = topkgating(
        logits, k=2, capacity_factor=capacity_factor, min_capacity=min_capacity,
        drop_policy="choice_priority")
    gates = torch.softmax(logits.float(), dim=-1)
    e = logits.shape[1]
    mask1 = _one_hot(torch.argmax(logits, dim=-1), e)
    l_aux = (gates.mean(dim=0) * mask1.mean(dim=0)).sum() * e
    return l_aux, combine, dispatch, exp_counts


def topkgating(logits, k: int, capacity_factor: float = 1.0, min_capacity: int = 4,
               drop_tokens: bool = True, drop_policy: str = "probs", normalize: bool = True):
    """General top-k with per-expert capacity. ``drop_policy``: which
    tokens lose when an expert overflows — "probs" (each expert keeps its
    top-capacity tokens by gate value), "position" (slots in token order)
    or "choice_priority" (every first choice before every second one, then
    token order). ``normalize`` renormalizes the combine weights over the
    surviving experts. Returns (l_aux, combine [s, e, c] fp32, dispatch
    [s, e, c] bool, exp_counts [e])."""
    s, e = logits.shape
    c = s * k if not drop_tokens else _capacity(s * k, e, capacity_factor, min_capacity)
    gates = torch.softmax(logits.float(), dim=-1)
    topk_vals, topk_idx = _top_k(gates, k)
    mask = _one_hot(topk_idx, e).sum(dim=1)
    l_aux = (gates.mean(dim=0) * mask.mean(dim=0)).sum() * e / k
    exp_counts = mask.sum(dim=0)

    if drop_policy == "probs":
        masked = torch.where(mask > 0, gates, torch.full_like(gates, float("-inf")))
        order = torch.argsort(-masked, dim=0, stable=True)
        pos_full = torch.argsort(order, dim=0, stable=True).float()
    elif drop_policy == "position":
        pos_full = torch.cumsum(mask, dim=0) - 1.0
    elif drop_policy == "choice_priority":
        pos_full = torch.zeros((s, e), dtype=torch.float32, device=logits.device)
        base = torch.zeros((e,), dtype=torch.float32, device=logits.device)
        for j in range(k):
            oh = _one_hot(topk_idx[:, j], e)
            pos_full = pos_full + (torch.cumsum(oh, dim=0) - 1.0 + base[None]) * oh
            base = base + oh.sum(dim=0)
    else:
        raise ValueError(f"unknown drop_policy {drop_policy!r}")
    keep = mask * (pos_full < c).float() if drop_tokens else mask

    combine = torch.zeros((s, e, c), dtype=torch.float32, device=logits.device)
    kept_total = torch.zeros((s,), dtype=torch.float32, device=logits.device)
    for j in range(k):
        oh = _one_hot(topk_idx[:, j], e)
        mask_j = oh * keep
        pos_j = (pos_full * oh).sum(dim=-1).int()
        w_j = topk_vals[:, j] * mask_j.sum(dim=-1)
        kept_total = kept_total + w_j
        combine = combine + w_j[:, None, None] * mask_j[:, :, None] * _one_hot(pos_j, c)[:, None, :]
    if normalize:
        combine = combine / kept_total.clamp_min(1e-9)[:, None, None]
    return l_aux, combine, combine > 0, exp_counts


class TopKGate:
    """The reference's ``TopKGate`` as an object: top-1 (with its noise and
    drop_tokens) for k 1, else ``topkgating``."""

    def __init__(self, k: int = 1, capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 noisy_gate_policy: Optional[str] = None, drop_tokens: bool = True,
                 drop_policy: str = "probs"):
        self.k = k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens = drop_tokens
        self.drop_policy = drop_policy

    def __call__(self, logits, train: bool = True, rng: Optional[torch.Generator] = None):
        cf = self.capacity_factor if train else self.eval_capacity_factor
        if self.k == 1:
            return top1gating(logits, cf, self.min_capacity,
                              self.noisy_gate_policy if train else None, rng, self.drop_tokens)
        return topkgating(logits, self.k, cf, self.min_capacity, self.drop_tokens,
                          self.drop_policy)


def _act(config, up, gate=None):
    """The expert MLP's activation, as the JAX package's ``moe_mlp``: silu
    or tanh GELU of the gate times up for the gated forms, else GELU of up
    (exact only for ``gelu_exact``)."""
    if config.activation in ("swiglu", "geglu"):
        g = F.gelu(gate, approximate="tanh") if config.activation == "geglu" else F.silu(gate)
        return g * up
    return F.gelu(up, approximate="none" if config.activation == "gelu_exact" else "tanh")


def _dense_mlp(config, lp, tokens, prefix):
    up = tokens @ lp[f"{prefix}_up"]
    gate = tokens @ lp[f"{prefix}_gate"] if config.activation in ("swiglu", "geglu") else None
    return _act(config, up, gate) @ lp[f"{prefix}_down"]


def moe_mlp(config, lp, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE MLP block of ``models/transformer.py``. lp: the layer's
    router [h, E], w_up / w_gate [E, h, f], w_down [E, f, h] (+ the
    residual expert's res_* and res_coef, the shared expert's shared_*).
    x: [b, s, h] or [t, h] (the serving engine's packed tokens); the
    capacity counts the rows of this call. Returns (out in x's shape,
    l_aux fp32)."""
    from deepspeed_tpu_torch.parallel.moe.mappings import quantized_ep_active
    from deepspeed_tpu_torch.parallel.topology import get_topology

    if quantized_ep_active(config) or get_topology().expert_parallel_size > 1:
        raise NotImplementedError(
            "MoE expert parallelism (an expert axis above 1, and its int8 exchange) is not "
            "ported yet (ROADMAP queue 1, item 6)")
    h = x.shape[-1]
    tokens = x.reshape(-1, h)
    logits = tokens @ lp["router"]
    l_aux, combine, dispatch, _ = topkgating(
        logits, k=config.moe_top_k, capacity_factor=config.moe_capacity_factor,
        normalize=getattr(config, "moe_norm_topk_prob", True))
    expert_in = torch.einsum("tec,th->ech", dispatch.to(x.dtype), tokens)
    up = torch.einsum("ech,ehf->ecf", expert_in, lp["w_up"])
    gate = (torch.einsum("ech,ehf->ecf", expert_in, lp["w_gate"])
            if config.activation in ("swiglu", "geglu") else None)
    expert_out = torch.einsum("ecf,efh->ech", _act(config, up, gate), lp["w_down"])
    out = torch.einsum("tec,ech->th", combine.to(x.dtype), expert_out)
    if getattr(config, "moe_residual", False) and "res_coef" in lp:
        coef = torch.softmax((tokens @ lp["res_coef"]).float(), dim=-1)
        out = (out * coef[:, 0:1].to(out.dtype)
               + _dense_mlp(config, lp, tokens, "res") * coef[:, 1:2].to(out.dtype))
    if getattr(config, "moe_shared_expert_dim", 0) > 0 and "shared_up" in lp:
        gate = torch.sigmoid((tokens @ lp["shared_gate_proj"]).float())
        out = out + gate.to(out.dtype) * _dense_mlp(config, lp, tokens, "shared")
    return out.reshape(x.shape), l_aux


class MoE:
    """The reference's ``MoE`` layer object over one layer's expert
    parameters: ``MoE(config, lp)(x)`` -> (out, l_aux, None). The model
    routes through ``moe_mlp`` directly (``TransformerConfig(n_experts=...)``)."""

    def __init__(self, config, layer_params):
        self.config = config
        self.lp = layer_params

    def __call__(self, x):
        out, l_aux = moe_mlp(self.config, self.lp, x)
        return out, l_aux, None
