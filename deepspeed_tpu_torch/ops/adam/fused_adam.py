"""Fused Adam for the port: one pass over each leaf as a CUDA kernel.

Counterpart of ``deepspeed_tpu/ops/adam/fused_adam.py``. ``_adam_math`` is
the update every path shares, in the JAX package's order of operations
(which is not optax's):

    g' = g + wd * p                          (L2 mode: adam_w_mode False)
    m  = b1 * m + (1 - b1) * g'
    v  = b2 * v + (1 - b2) * g'^2
    u  = (m / c1) / (sqrt(v / c2) + eps)     (c1 = 1 - b1^t, c2 = 1 - b2^t)
    u  = u + wd * p                          (AdamW mode)
    p  = p - lr * u

``fused_adam_step`` applies it to one leaf **in place**: on a CUDA tensor
the kernel ``ops/kernels/csrc/fused_adam.cu`` (which replaces the Pallas
``_fused_kernel``; it can also write the bf16/fp16 model parameter in the
same pass), on a CPU tensor ``_adam_math``. Nothing falls back. The
:class:`FusedAdam` class walks a parameter tree: leaves of at least
``1 << 16`` elements take ``fused_adam_step``, smaller ones ``_adam_math``,
as the JAX transform routes them. The per-shard form under a device mesh
waits for the multi-GPU slice.
"""

import ctypes
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.kernels import KERNELS, stream_ptr
from deepspeed_tpu_torch.utils.tree import tree_map, walk

KERNEL = KERNELS["fused_adam"]
# leaves below this many elements take the plain math (the JAX transform's
# ``p.size >= 1 << 16``)
KERNEL_MIN_ELEMENTS = 1 << 16
_LOWP_KIND = {torch.bfloat16: 1, torch.float16: 2}


class AdamParams(NamedTuple):
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    adam_w_mode: bool = True
    bias_correction: bool = True


def bias_corrections(hp: AdamParams, step) -> tuple:
    """``(1 - b1^t, 1 - b2^t)`` in fp32 on the host, as ``fused_adam_step``
    of the JAX package computes them outside its kernel."""
    t = np.float32(step)
    return (float(np.float32(1.0) - np.float32(hp.beta1) ** t),
            float(np.float32(1.0) - np.float32(hp.beta2) ** t))


def _adam_math(p, g, m, v, step, hp: AdamParams, lr, c1=None, c2=None):
    """The plain update: returns new ``(p, m, v)`` (p in its own dtype, m and
    v fp32); nothing is modified."""
    g = g.float()
    p32 = p.float()
    if not hp.adam_w_mode and hp.weight_decay:
        g = g + hp.weight_decay * p32
    m_new = hp.beta1 * m + (1 - hp.beta1) * g
    v_new = hp.beta2 * v + (1 - hp.beta2) * g.square()
    if hp.bias_correction:
        if c1 is None or c2 is None:
            c1, c2 = bias_corrections(hp, step)
        update = (m_new / c1) / ((v_new / c2).sqrt() + hp.eps)
    else:
        update = m_new / (v_new.sqrt() + hp.eps)
    if hp.adam_w_mode and hp.weight_decay:
        update = update + hp.weight_decay * p32
    return (p32 - float(np.float32(lr)) * update).to(p.dtype), m_new, v_new


def fused_adam_cuda(p, g, m, v, step, hp: AdamParams, lr, param_out=None):
    """Launch the kernel on one leaf, in place. ``p``, ``g``, ``m``, ``v``
    fp32, contiguous, one CUDA device; ``param_out`` (bf16 or fp16, p's
    shape) also receives the new p, rounded once."""
    tensors = [p, g, m, v] + ([] if param_out is None else [param_out])
    if any(t.device.type != "cuda" or t.device != p.device for t in tensors):
        raise ValueError("fused_adam_cuda: every tensor must be on one CUDA device "
                         f"(got {sorted({str(t.device) for t in tensors})})")
    if any(t.dtype != torch.float32 for t in (p, g, m, v)):
        raise NotImplementedError(
            "fused_adam_cuda: p, g, m and v must be fp32 (the fp32 master and its "
            f"moments); got {[str(t.dtype) for t in (p, g, m, v)]}")
    if any(t.shape != p.shape or not t.is_contiguous() for t in tensors):
        raise ValueError("fused_adam_cuda: tensors must share p's shape and be contiguous "
                         "(the update is in place)")
    if any(t.data_ptr() % 16 for t in (p, g, m, v)) or (
            param_out is not None and param_out.data_ptr() % 8):
        raise ValueError("fused_adam_cuda: tensors must be 16-byte aligned")
    kind = 0
    if param_out is not None:
        if param_out.dtype not in _LOWP_KIND:
            raise NotImplementedError(
                f"fused_adam_cuda: param_out {param_out.dtype}; the kernel writes bf16 or fp16")
        kind = _LOWP_KIND[param_out.dtype]
    if p.numel() == 0:
        return p, m, v
    c1, c2 = bias_corrections(hp, step) if hp.bias_correction else (1.0, 1.0)
    f = ctypes.c_float
    rc = KERNEL.fn()(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
        None if param_out is None else param_out.data_ptr(), p.numel(),
        f(lr), f(hp.beta1), f(hp.beta2), f(1 - hp.beta1), f(1 - hp.beta2), f(hp.eps),
        f(hp.weight_decay), f(c1), f(c2), int(bool(hp.adam_w_mode)),
        int(bool(hp.bias_correction)), kind, stream_ptr(p),
    )
    KERNEL.check(rc)
    KERNEL.launches += 1
    return p, m, v


@torch.no_grad()
def _plain_step_(p, g, m, v, step, hp, lr, param_out=None):
    p_new, m_new, v_new = _adam_math(p, g, m, v, step, hp, lr)
    p.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)
    if param_out is not None:
        param_out.copy_(p)
    return p, m, v


@torch.no_grad()
def fused_adam_step(params, grads, m, v, step, hp: AdamParams = AdamParams(), lr=None,
                    param_out=None):
    """One Adam step over one leaf, **in place** on ``params``, ``m`` and
    ``v`` (the JAX function returns new arrays). Returns ``(params, m, v)``.
    The kernel on a CUDA tensor, ``_adam_math`` on a CPU tensor."""
    lr = hp.lr if lr is None else lr
    if params.device.type == "cpu":
        return _plain_step_(params, grads, m, v, step, hp, lr, param_out)
    return fused_adam_cuda(params, grads, m, v, step, hp, lr, param_out)


class FusedAdam:
    """Hyper-parameters and the tree walk (``{"optimizer": {"type":
    "FusedAdam"}}``). ``init(master)`` gives ``{"m", "v", "count"}``;
    ``step(grads, state, master, lr, params=None)`` updates the masters and
    moments in place (and ``params``, the half-precision model copies, when
    given) and returns the state with its count raised."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 adam_w_mode=True, bias_correction=True, master_specs=None, mesh=None):
        if master_specs is not None or mesh is not None:
            raise NotImplementedError(
                "FusedAdam over a device mesh (the per-shard update) is not ported yet "
                "(ROADMAP queue 1, item 6: multi-GPU)")
        self.hp = AdamParams(lr=lr, beta1=betas[0], beta2=betas[1], eps=eps,
                             weight_decay=weight_decay, adam_w_mode=adam_w_mode,
                             bias_correction=bias_correction)

    def init(self, master) -> Dict[str, Any]:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return {"m": tree_map(zeros, master), "v": tree_map(zeros, master), "count": 0}

    @torch.no_grad()
    def step(self, grads, state, master, lr, params: Optional[dict] = None):
        count = int(state["count"]) + 1
        for p, g, m, v, out in walk(master, grads, state["m"], state["v"],
                                    master if params is None else params):
            # the kernel writes a bf16/fp16 param in its own pass; any other
            # separate param tensor is copied from the master afterwards
            lowp = out if out is not p and out.dtype in _LOWP_KIND else None
            step = fused_adam_step if p.numel() >= KERNEL_MIN_ELEMENTS else _plain_step_
            step(p, g, m, v, count, self.hp, lr, param_out=lowp)
            if out is not p and lowp is None:
                out.copy_(p)
        return dict(state, count=count)


__all__ = ["AdamParams", "FusedAdam", "KERNEL_MIN_ELEMENTS", "bias_corrections",
           "fused_adam_cuda", "fused_adam_step"]
