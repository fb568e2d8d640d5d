"""RMSNorm / LayerNorm for the port.

Counterpart of ``deepspeed_tpu/ops/normalization/fused_norm.py``. RMSNorm
forward and backward are hand-written CUDA kernels (``ops/kernels/csrc/
rms_norm.cu``, replacing the Pallas ``_rms_fwd_kernel`` and
``_rms_bwd_kernel``), joined by ``fused_rms_norm``, a
``torch.autograd.Function`` (the JAX package's ``custom_vjp``): the
backward launches the dx kernel and takes dw as a plain torch row
reduction, as the JAX package does. LayerNorm stays plain torch, as it is
plain jnp in the JAX package.

``rms_norm`` dispatches on where its input lies: a CPU tensor takes the
plain version under autograd (as the JAX package's CPU path differentiates
its jnp reference), a CUDA tensor goes through ``fused_rms_norm``, whose
kernels launch or raise. There is no fallback from the card to the plain
version.
"""

import ctypes

import torch

from deepspeed_tpu_torch.ops.kernels import KERNELS, stream_ptr

RMS_KERNEL = KERNELS["rms_norm_fwd"]
RMS_BWD_KERNEL = KERNELS["rms_norm_bwd"]
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def rms_norm_reference(x, w, eps=1e-5):
    """Plain RMSNorm: fp32 statistics, ``(x * inv) * w`` in fp32, rounded
    once to x's dtype (the order of the Pallas body)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def rms_norm_bwd_reference(x, w, g, eps=1e-5):
    """Plain RMSNorm input gradient, the Pallas ``_rms_bwd_kernel``'s
    formula in fp32: dx = inv * (g*w - xhat * mean(g*w * xhat)), rounded
    once to x's dtype."""
    xf = x.float()
    inv = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    gw = g.float() * w.float()
    dot = (gw * xhat).mean(dim=-1, keepdim=True)
    return (inv * (gw - xhat * dot)).to(x.dtype)


def rms_norm_dw(x, w, g, eps=1e-5):
    """Weight gradient: sum over rows of g * x * inv in fp32, in w's dtype
    (a plain torch reduction on every device, as in the JAX package)."""
    h = x.shape[-1]
    xf = x.reshape(-1, h).float()
    inv = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (g.reshape(-1, h).float() * xf * inv).sum(dim=0).to(w.dtype)


def layer_norm_reference(x, w, b, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def _rows(x, w, where):
    """Check the kernels' arguments and view x as contiguous [rows, h]."""
    h = x.shape[-1]
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"{where}: x and w must be on one CUDA device (x on {x.device}, w on {w.device})"
        )
    if x.dtype not in _KERNEL_DTYPES or w.dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(
            f"{where}: x {x.dtype}, w {w.dtype}; the kernel takes bf16 or fp32"
        )
    if tuple(w.shape) != (h,):
        raise ValueError(f"{where}: w shape {tuple(w.shape)}, expected ({h},)")
    return x.reshape(-1, h).contiguous(), w.contiguous()


def rms_norm_cuda(x, w, eps=1e-5):
    """Launch the RMSNorm kernel: x [..., h] bf16/fp32 on a card, w [h]
    bf16/fp32 on the same card. Returns a new tensor shaped like x."""
    x2, w = _rows(x, w, "rms_norm_cuda")
    out = torch.empty_like(x2)
    rows, h = x2.shape
    if rows == 0 or h == 0:
        return out.reshape(x.shape)
    vec = h % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (x2, w, out))
    fn = RMS_KERNEL.fn()
    rc = fn(
        x2.data_ptr(), w.data_ptr(), out.data_ptr(), rows, h, ctypes.c_float(eps),
        int(x2.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16), int(vec),
        stream_ptr(x2),
    )
    RMS_KERNEL.check(rc)
    RMS_KERNEL.launches += 1
    return out.reshape(x.shape)


def rms_norm_bwd_cuda(x, w, g, eps=1e-5):
    """Launch the RMSNorm backward kernel: dx for x [..., h], w [h] and the
    output gradient g (x's shape and dtype), all on one card."""
    x2, w = _rows(x, w, "rms_norm_bwd_cuda")
    g2 = g.reshape(x2.shape).to(x2.dtype).contiguous()
    dx = torch.empty_like(x2)
    rows, h = x2.shape
    if rows == 0 or h == 0:
        return dx.reshape(x.shape)
    vec = h % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (x2, w, g2, dx))
    fn = RMS_BWD_KERNEL.fn()
    rc = fn(
        x2.data_ptr(), w.data_ptr(), g2.data_ptr(), dx.data_ptr(), rows, h,
        ctypes.c_float(eps), int(x2.dtype == torch.bfloat16),
        int(w.dtype == torch.bfloat16), int(vec), stream_ptr(x2),
    )
    RMS_BWD_KERNEL.check(rc)
    RMS_BWD_KERNEL.launches += 1
    return dx.reshape(x.shape)


class FusedRMSNorm(torch.autograd.Function):
    """RMSNorm with the kernels' backward: dx from the dx kernel on a card
    (its plain version on the CPU), dw a plain row reduction."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        if x.device.type == "cpu":
            return rms_norm_reference(x, w, eps)
        return rms_norm_cuda(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        eps = ctx.eps
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if x.device.type == "cpu":
                dx = rms_norm_bwd_reference(x, w, g, eps)
            else:
                dx = rms_norm_bwd_cuda(x, w, g, eps)
        if ctx.needs_input_grad[1]:
            dw = rms_norm_dw(x, w, g, eps)
        return dx, dw, None


def fused_rms_norm(x, w, eps=1e-5):
    """x: [..., h]; w: [h] (bf16 or fp32). The kernels on a card, their
    plain versions on the CPU; differentiable in x and w."""
    return FusedRMSNorm.apply(x, w, eps)


def rms_norm(x, w, eps=1e-5):
    """The entry point model code calls: on a CUDA tensor the kernels,
    through ``fused_rms_norm`` when autograd records a gradient and the
    forward kernel alone otherwise (serving); the plain version under
    autograd for a CPU tensor."""
    if x.device.type == "cpu":
        return rms_norm_reference(x, w, eps)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return fused_rms_norm(x, w, eps)
    return rms_norm_cuda(x, w, eps)


def fused_layer_norm(x, w, b, eps=1e-5):
    """LayerNorm: plain torch (the JAX package's is plain jnp too)."""
    return layer_norm_reference(x, w, b, eps)
