"""RMSNorm / LayerNorm for the port.

Counterpart of ``deepspeed_tpu/ops/normalization/fused_norm.py``. The
forward RMSNorm is a hand-written CUDA kernel (``ops/kernels/csrc/
rms_norm.cu``, replacing the Pallas ``_rms_fwd_kernel``); LayerNorm stays
plain torch, as it is plain jnp in the JAX package.

``rms_norm`` dispatches on where its input lies: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. There is no
fallback from the card to the plain version.
"""

import ctypes

import torch

from deepspeed_tpu_torch.ops.kernels import KERNELS, stream_ptr

RMS_KERNEL = KERNELS["rms_norm_fwd"]
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def rms_norm_reference(x, w, eps=1e-5):
    """Plain RMSNorm: fp32 statistics, ``(x * inv) * w`` in fp32, rounded
    once to x's dtype (the order of the Pallas body)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def layer_norm_reference(x, w, b, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def rms_norm_cuda(x, w, eps=1e-5):
    """Launch the RMSNorm kernel: x [..., h] bf16/fp32 on a card, w [h]
    bf16/fp32 on the same card. Returns a new tensor shaped like x."""
    h = x.shape[-1]
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"rms_norm_cuda: x and w must be on one CUDA device (x on {x.device}, "
            f"w on {w.device})"
        )
    if x.dtype not in _KERNEL_DTYPES or w.dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(
            f"rms_norm_cuda: x {x.dtype}, w {w.dtype}; the kernel takes bf16 or fp32"
        )
    if tuple(w.shape) != (h,):
        raise ValueError(f"rms_norm_cuda: w shape {tuple(w.shape)}, expected ({h},)")
    x2 = x.reshape(-1, h).contiguous()
    w = w.contiguous()
    out = torch.empty_like(x2)
    rows = x2.shape[0]
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


def rms_norm(x, w, eps=1e-5):
    """The entry point model code calls: the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return rms_norm_reference(x, w, eps)
    return rms_norm_cuda(x, w, eps)


def fused_layer_norm(x, w, b, eps=1e-5):
    """LayerNorm: plain torch (the JAX package's is plain jnp too)."""
    return layer_norm_reference(x, w, b, eps)
