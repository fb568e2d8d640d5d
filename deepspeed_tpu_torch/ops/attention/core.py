"""Attention building blocks for the port.

Counterpart of ``deepspeed_tpu/ops/attention/core.py``: the shared
sliding-window band convention and the plain reference attention. The
flash kernel (``attention(impl="flash")``) is not ported in this slice.

Layout as in the JAX package: q [batch, heads, seq, head_dim], k/v
[batch, kv_heads, seq, head_dim]; grouped-query attention repeats kv heads.
"""

from typing import Optional

import torch

NEG_INF = -1e30


def window_too_far(q_pos, k_pos, window: int, window_flag=None):
    """THE sliding-window band convention: key k is out of band for query q
    iff ``q - k >= window`` (query sees keys in ``(q - window, q]``).
    ``window_flag`` (0/1 per layer) gates the band; 0 means global. Returns
    a boolean tensor of ``broadcast(q_pos, k_pos)`` shape, True = mask."""
    far = (q_pos - k_pos) >= window
    if window_flag is not None:
        far = far & (torch.as_tensor(window_flag) > 0)
    return far


def _repeat_kv(k, n_rep: int):
    """[b, h_kv, s, d] -> [b, h_kv * n_rep, s, d] for grouped-query attention."""
    if n_rep == 1:
        return k
    b, h_kv, s, d = k.shape
    return k[:, :, None].expand(b, h_kv, n_rep, s, d).reshape(b, h_kv * n_rep, s, d)


def mha_reference(
    q,
    k,
    v,
    causal: bool = True,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    window: int = 0,
    window_flag=None,
):
    """Plain attention with an fp32 softmax. q: [b, h, sq, d]; k, v:
    [b, h_kv, sk, d]. Returns [b, h, sq, d] in v's dtype. ``causal`` offsets
    the mask so the last query sees all sk keys; ``window`` adds the band
    (requires causal)."""
    if window and not causal:
        raise ValueError("mha_reference: window > 0 requires causal=True")
    b, h, sq, d = q.shape
    h_kv = k.shape[1]
    k = _repeat_kv(k, h // h_kv)
    v = _repeat_kv(v, h // h_kv)
    scale = scale if scale is not None else (1.0 / (d ** 0.5))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    sk = k.shape[2]
    if causal:
        dev = q.device
        q_pos = torch.arange(sq, device=dev)[:, None] + (sk - sq)
        k_pos = torch.arange(sk, device=dev)[None, :]
        mask = q_pos >= k_pos
        if window:
            mask = mask & ~window_too_far(q_pos, k_pos, window, window_flag)
        logits = torch.where(mask[None, None], logits, torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)
