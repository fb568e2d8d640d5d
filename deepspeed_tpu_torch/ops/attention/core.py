"""Attention dispatch for the port.

Counterpart of ``deepspeed_tpu/ops/attention/core.py``: the shared
sliding-window band convention, the plain reference attention and the
``attention`` seam. ``impl``:

  * None / "auto": on a CUDA tensor the flash kernels
    (``ops/attention/flash.py``), which launch or raise for a shape they do
    not take; on a CPU tensor ``mha_reference``, as the JAX package's
    "auto" takes its jnp reference off the TPU;
  * "flash": ``flash_attention`` on any device (its plain versions on the
    CPU);
  * "splash": the scheduled block-sparse kernels
    (``ops/sparse_attention/splash.py``) over ``schedule`` or, absent one,
    the schedule the (causal, window) pair compiles into (lru-cached, built
    once per shape); None / "auto" with a ``schedule`` promotes to them and,
    where the arguments cannot take the scheduled path (a dense bias, a
    per-layer window flag), warns once and falls back to the dense chain;
  * "reference": ``mha_reference``;
  * "flash_ring": the context-parallel ring over the topology's
    ``context`` axis (``ops/attention/sharded.py``): the carry-mode chunk
    kernels on a card, their plain versions on the CPU (so the CPU runs the
    ring's schedule, not ``mha_reference``); None / "auto" promotes to it
    when the context axis is above 1 and the shapes fit (``_ring_eligible``:
    causal, no bias or window, head_dim 64/128/256, chunks of a multiple of
    128 rows, as in the JAX package);
  * "flash_head_sharded": flash over the batch rows this process holds
    (model and sequence are 1 in the port).

ALiBi (``alibi_slopes`` [h], ``alibi_positions`` [s] or [b, s]) goes to
the flash kernels' ALiBi form on a card and to ``mha_reference``'s dense
``slope * key_position`` term on a CPU tensor; splash and schedules refuse
it, and so do the ring and the head-sharded form (ROADMAP queue 2, item
1). A dense ``bias`` on the flash paths raises ``NotImplementedError``
naming its ROADMAP item, and so does splash on more than one process (head
sharding). On a card nothing here runs the plain version unless asked for
by "reference".

Layout as in the JAX package: q [batch, heads, seq, head_dim], k/v
[batch, kv_heads, seq, head_dim]; grouped-query attention repeats kv heads.
"""

import functools
import os
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


def alibi_bias(alibi_slopes, alibi_positions, sk: int, device):
    """ALiBi's ``slope_h * key_position`` as an fp32 [1|b, h, 1, sk] bias:
    BLOOM's absolute key positions, ``alibi_positions`` [sk] or [b, sk]
    (default arange(sk))."""
    kp = (torch.arange(sk, device=device) if alibi_positions is None
          else torch.as_tensor(alibi_positions, device=device)).float()
    if kp.ndim == 1:
        kp = kp[None]
    slopes = torch.as_tensor(alibi_slopes, device=device).float()
    return slopes[None, :, None, None] * kp[:, None, None, :]


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
    segment_ids: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    window: int = 0,
    window_flag=None,
    alibi_slopes=None,
    alibi_positions=None,
):
    """Plain attention with an fp32 softmax. q: [b, h, sq, d]; k, v:
    [b, h_kv, sk, d]. Returns [b, h, sq, d] in v's dtype. ``causal`` offsets
    the mask so the last query sees all sk keys; ``window`` adds the band
    (requires causal); ``segment_ids`` [b, s] (sq == sk) keeps attention
    inside each packed sequence. ``alibi_slopes`` [h] adds ``slope_h *
    key_position`` to the logits (BLOOM's absolute-position ALiBi; the
    positions ``alibi_positions`` [sk] or [b, sk], default arange(sk))."""
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
    if alibi_slopes is not None:
        logits = logits + alibi_bias(alibi_slopes, alibi_positions, k.shape[2], q.device)
    sk = k.shape[2]
    if causal:
        dev = q.device
        q_pos = torch.arange(sq, device=dev)[:, None] + (sk - sq)
        k_pos = torch.arange(sk, device=dev)[None, :]
        mask = q_pos >= k_pos
        if window:
            mask = mask & ~window_too_far(q_pos, k_pos, window, window_flag)
        logits = torch.where(mask[None, None], logits, torch.full_like(logits, NEG_INF))
    if segment_ids is not None:
        seg_mask = segment_ids[:, :, None] == segment_ids[:, None, :]
        logits = torch.where(seg_mask[:, None], logits, torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)


def _unported(what: str, item: str):
    return NotImplementedError(f"attention: {what} is not ported yet ({item})")


_warned_splash_fallback = False


@functools.lru_cache(maxsize=64)
def _derived_splash_schedule(sq: int, sk: int, causal: bool, window: int, block: int):
    """Schedule of the mask implied by (causal, window) alone: the
    impl="splash" path with no explicit mask. Cached: built once per shape,
    never per step."""
    from deepspeed_tpu_torch.ops.sparse_attention.mask import CausalMask, FullMask, LocalMask
    from deepspeed_tpu_torch.ops.sparse_attention.schedule import schedule_from_mask

    if window and causal:
        mask = LocalMask((sq, sk), window)
    elif causal:
        mask = CausalMask((sq, sk))
    else:
        mask = FullMask((sq, sk))
    return schedule_from_mask(mask, block)


def _pick_block(s: int, target: int) -> int:
    """The first of target, target / 2, ... (at most s) that divides s (the
    JAX package's ``flash_pallas._pick_block``): 512 at s 4096, 384 at s
    384."""
    b = min(target, s)
    while s % b:
        b //= 2
    return max(b, 1)


def _splash_block(s: int) -> int:
    return _pick_block(s, int(os.environ.get("DSTPU_SPLASH_BLOCK", 512)))


def _splash_dispatch(q, k, v, causal, segment_ids, bias, scale, window, window_flag, schedule,
                     strict):
    """impl="splash" (strict) or auto promotion (a schedule was configured).
    Returns None when the arguments cannot take the scheduled path (the
    caller falls back to the dense chain); strict mode raises instead."""
    from deepspeed_tpu_torch.ops.sparse_attention.splash import splash_attention

    def bail(msg):
        if strict:
            raise ValueError(f"attention(impl='splash'): {msg}")
        return None

    if bias is not None:
        return bail("dense bias is not supported on the scheduled path")
    if window_flag is not None:
        return bail("a per-layer window flag cannot alter a static schedule (use the "
                    "dense/flash path for flag-gated local layers)")
    sq, sk = q.shape[2], k.shape[2]
    if schedule is None:
        block = _splash_block(min(sq, sk))
        if sq % block or sk % block:
            return bail(f"seq ({sq}, {sk}) does not divide block {block}")
        schedule = _derived_splash_schedule(sq, sk, bool(causal), int(window or 0), block)
    if torch.distributed.is_available() and torch.distributed.is_initialized() and (
            torch.distributed.get_world_size() > 1):
        raise _unported("splash on more than one process (head-sharded splash)",
                        "ROADMAP queue 1, item 6: multi-GPU")
    return splash_attention(q, k, v, schedule, segment_ids=segment_ids, scale=scale)


def _ring_eligible(q, k, bias, causal, window):
    """Whether "auto" may take the ring: the topology's context axis is
    above 1 and the call fits the ring's contract (the JAX package's rule:
    causal, no bias or window, one s for queries and keys, head_dim
    64/128/256, chunks of a multiple of 128 rows, shapes dividing the grid).
    Such chunks are whole tiles of every flash kernel at every head dim
    (``sharded.ring_matches_flash``), so the ring it takes gives the single
    kernels' bits. In the process form q is this rank's chunk already."""
    from deepspeed_tpu_torch.ops.attention.sharded import _divisible, ring_matches_flash
    from deepspeed_tpu_torch.parallel.topology import get_topology

    topo = get_topology()
    n = topo.context_parallel_size
    if n <= 1 or bias is not None or not causal or window:
        return False
    b, h, s, d = q.shape
    if s != k.shape[2] or d not in (64, 128, 256):
        return False
    if topo.distributed:
        chunk = s
    elif s % n or not _divisible(topo, b, h, k.shape[1], s=s):
        return False
    else:
        chunk = s // n
    return chunk % 128 == 0 and ring_matches_flash(chunk, d)


def attention(
    q,
    k,
    v,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: Optional[str] = None,
    alibi_slopes=None,
    alibi_positions=None,
    window: int = 0,
    window_flag=None,
    schedule=None,
):
    """Dispatching attention entry point (the JAX package's signature).
    See the module docstring for ``impl``."""
    if alibi_slopes is not None and (impl == "splash" or schedule is not None):
        raise ValueError("attention: ALiBi is not supported on the splash scheduled path")
    alibi = dict(alibi_slopes=alibi_slopes, alibi_positions=alibi_positions)
    if impl == "splash" or (impl in (None, "auto") and schedule is not None):
        out = _splash_dispatch(q, k, v, causal, segment_ids, bias, scale, window, window_flag,
                               schedule, strict=impl == "splash")
        if out is not None:
            return out
        global _warned_splash_fallback
        if not _warned_splash_fallback:
            _warned_splash_fallback = True
            from deepspeed_tpu_torch.utils.logging import logger

            logger.warning(
                "configured splash schedule fell back to the dense dispatch chain "
                "(bias/window-flag constraints) — sparsity will be masked, not pruned")
    if impl == "reference":
        return mha_reference(q, k, v, causal=causal, segment_ids=segment_ids, bias=bias,
                             scale=scale, window=window, window_flag=window_flag, **alibi)
    if impl in ("flash_ring", "flash_head_sharded") or (
            impl in (None, "auto") and _ring_eligible(q, k, bias, causal, window)):
        from deepspeed_tpu_torch.ops.attention import sharded

        if bias is not None:
            raise _unported(f"a dense bias on impl={impl!r}",
                            "ROADMAP queue 2, item 1: biases on the flash kernel")
        if impl == "flash_head_sharded":
            return sharded.head_sharded_flash(q, k, v, causal=causal, segment_ids=segment_ids,
                                              scale=scale, window=window,
                                              window_flag=window_flag, **alibi)
        return sharded.ring_flash_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                                            scale=scale, window=window,
                                            alibi_slopes=alibi_slopes)
    if impl not in (None, "auto", "flash"):
        raise ValueError(f"attention: impl={impl!r}")
    if impl != "flash" and q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, segment_ids=segment_ids, bias=bias,
                             scale=scale, window=window, window_flag=window_flag, **alibi)
    if bias is not None:
        raise _unported("a dense bias on the flash path",
                        "ROADMAP queue 2, item 1: biases on the flash kernel")
    from deepspeed_tpu_torch.ops.attention.flash import flash_attention

    return flash_attention(q, k, v, causal=causal, segment_ids=segment_ids, scale=scale,
                           window=window, window_flag=window_flag, **alibi)
