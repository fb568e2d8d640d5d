"""Grouped (ragged) GEMM for MoE expert MLPs, plain PyTorch.

Counterpart of ``deepspeed_tpu/ops/moe_gemm.py``, whose ``grouped_gemm`` is
``jax.lax.ragged_dot`` (an XLA op, not a Pallas body): here one
``torch.matmul`` per group, over the rows that group owns. On top of it
``moe_mlp_dropless``, the MegaBlocks-style dropless expert MLP: tokens
sorted by their experts (a stable sort), two grouped GEMMs, the outputs
weighted by their gates and added back into their tokens' rows.
"""

from typing import Callable, Optional

import torch

F = torch.nn.functional


def grouped_gemm(x, weights, group_sizes):
    """x [n, h], sorted so the first group_sizes[0] rows belong to group 0,
    and so on; weights [E, h, f]; group_sizes [E] ints summing to at most
    n. Returns [n, f]: each row times its group's weight, zeros for rows
    past the groups (as ``ragged_dot``). The sizes are read on the host."""
    sizes = [int(v) for v in torch.as_tensor(group_sizes).tolist()]
    out = x.new_zeros((x.shape[0], weights.shape[-1]))
    start = 0
    for e, n in enumerate(sizes):
        if n:
            out[start:start + n] = x[start:start + n] @ weights[e]
        start += n
    return out


def _gates(logits, top_k):
    from deepspeed_tpu_torch.parallel.moe.sharded_moe import _top_k

    vals, idx = _top_k(torch.softmax(logits.float(), dim=-1), top_k)
    return vals / vals.sum(dim=-1, keepdim=True).clamp_min(1e-9), idx


def moe_mlp_dropless(tokens, logits, w_up, w_down, w_gate: Optional[torch.Tensor] = None,
                     top_k: int = 2, activation: Callable = F.silu):
    """Dropless top-k expert MLP: every token to its top-k experts with
    softmax weights renormalized over them, no capacity. tokens [t, h],
    logits [t, E], w_up (and w_gate) [E, h, f], w_down [E, f, h]. Returns
    (out [t, h], group_sizes [E] int32)."""
    t = tokens.shape[0]
    E = logits.shape[-1]
    vals, idx = _gates(logits, top_k)
    flat_expert = idx.reshape(-1)
    flat_weight = vals.reshape(-1)
    flat_token = torch.arange(t, device=tokens.device).repeat_interleave(top_k)
    order = torch.argsort(flat_expert, stable=True)
    sorted_tokens = tokens[flat_token[order]]
    group_sizes = torch.bincount(flat_expert, minlength=E).to(torch.int32)
    up = grouped_gemm(sorted_tokens, w_up, group_sizes)
    if w_gate is not None:
        up = activation(grouped_gemm(sorted_tokens, w_gate, group_sizes)) * up
    else:
        up = activation(up)
    down = grouped_gemm(up, w_down, group_sizes)
    down = down * flat_weight[order][:, None].to(down.dtype)
    out = torch.zeros_like(tokens).index_add_(0, flat_token[order], down)
    return out, group_sizes


def moe_mlp_dropless_reference(tokens, logits, w_up, w_down, w_gate=None, top_k: int = 2,
                               activation: Callable = F.silu):
    """The dense reference: every expert on every token, masked by the
    token's top-k weights."""
    vals, idx = _gates(logits, top_k)
    out = torch.zeros_like(tokens)
    for e in range(logits.shape[-1]):
        up = tokens @ w_up[e]
        up = activation(tokens @ w_gate[e]) * up if w_gate is not None else activation(up)
        y = up @ w_down[e]
        w = torch.where(idx == e, vals, torch.zeros_like(vals)).sum(dim=-1)
        out = out + y * w[:, None].to(y.dtype)
    return out
