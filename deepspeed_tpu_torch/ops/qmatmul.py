"""Quantized forward matmuls (fp8 / int8) with a full-precision backward.

Counterpart of ``deepspeed_tpu/ops/qmatmul.py`` (reference
``csrc/fp_quantizer/`` + the transformer-engine recipe): the FORWARD
projection runs on low-precision operands, the BACKWARD is the exact wide
vjp from the saved operands, so training follows the bf16 model while the
forward rides the card's int8 / fp8 tensor-core rate (twice bf16's on an
H100).

Modes, as in the JAX package:
  * ``int8`` — per-TOKEN activation scales (absmax over the contraction
    dim) x per-OUTPUT-CHANNEL weight scales; the int32 product gets the
    rank-1 rescale ``out * sx[..., 1] * sw[1, n]``;
  * ``int8_tensor`` — one scale per tensor;
  * ``fp8`` — per-tensor e4m3 (``float8_e4m3fn``).

The JAX package computes this product in plain XLA, outside any Pallas
body; on a card the port's int8 product is ``torch._int_mm`` (int32 out)
and its fp8 product ``torch._scaled_mm`` with tensorwise scales, the
library matmuls. ``_int_mm`` wants more than 16 rows and k, n multiples of
8; ``_scaled_mm`` wants dimensions that are multiples of 16; both take the
second operand column-major: rows (and, for other widths, k and n) are
zero-padded to fit, which changes no product. On CPU tensors the products
are their plain versions: the int8 codes multiplied in float64, which is
exact for k <= 2^53 / 127^2, and the fp8 codes upcast and multiplied in
fp32.

Scales follow the JAX package's compiled form (its training step runs
under ``jit``, where XLA turns ``absmax / qmax`` into a product with the
fp32 reciprocal of the constant qmax), so the int8 codes equal the jitted
JAX function's bit for bit.
"""

import numpy as np
import torch

MODES = ("fp8", "int8", "int8_tensor")

_FP8 = torch.float8_e4m3fn
# fl32(1 / qmax): XLA's compiled form of a division by the constant qmax
_INV_I8 = float(np.float32(1.0) / np.float32(127.0))
_INV_FP8 = float(np.float32(1.0) / np.float32(torch.finfo(_FP8).max))


def _scale(absmax, inv):
    return torch.where(absmax > 0, absmax * inv, torch.ones_like(absmax))


def _cast_i8(a, dim=None):
    """Symmetric int8 codes with absmax scales along ``dim`` (kept), or
    one scale for the tensor when ``dim`` is None."""
    af = a.float()
    absmax = af.abs().amax() if dim is None else af.abs().amax(dim=dim, keepdim=True)
    scale = _scale(absmax, _INV_I8)
    return torch.clamp(torch.round(af / scale), -127, 127).to(torch.int8), scale


def _cast_fp8(a):
    """Tensor-scaled e4m3 codes (scaled into the format's range first)."""
    af = a.float()
    scale = _scale(af.abs().amax(), _INV_FP8)
    return (af / scale).to(_FP8), scale


def _pad(t, rows, cols):
    r, c = t.shape
    if rows == r and cols == c:
        return t
    return torch.nn.functional.pad(t, (0, cols - c, 0, rows - r))


def _up(n, m):
    return -(-n // m) * m


def int8_product(xq, wq):
    """xq [m, k] int8 @ wq [k, n] int8 -> int32 [m, n]. A card:
    ``torch._int_mm`` on operands zero-padded to more than 16 rows and k, n
    multiples of 8; CPU tensors: the plain version, ``int8_product_reference``."""
    if xq.device.type == "cpu":
        return int8_product_reference(xq, wq)
    return _int8_library(xq, wq)


def _int8_library(xq, wq):
    """``torch._int_mm`` on the padded operands (any device that has it),
    the second column-major (cuBLASLt's int8 products take the "TN"
    layout)."""
    m, k = xq.shape
    n = wq.shape[1]
    mp, kp, np_ = max(_up(m, 8), 24), _up(k, 8), _up(n, 8)
    out = torch._int_mm(_pad(xq, mp, kp), _pad(wq.t().contiguous(), np_, kp).t())
    return out[:m, :n]


def int8_product_reference(xq, wq):
    """The int8 product's plain version: exact in float64 (each term at
    most 127^2, k of them)."""
    return (xq.to(torch.float64) @ wq.to(torch.float64)).to(torch.int32)


def fp8_product(xq, wq, sx, sw, dtype):
    """(xq [m, k] @ wq [k, n]) * (sx * sw) in ``dtype``, fp8 e4m3 codes,
    fp32 accumulation. A card: ``torch._scaled_mm`` (tensorwise scales, the
    second operand column-major, every dimension zero-padded to a multiple
    of 16); CPU tensors: the plain version, ``fp8_product_reference``."""
    if xq.device.type == "cpu":
        return fp8_product_reference(xq, wq, sx, sw, dtype)
    return _fp8_library(xq, wq, sx, sw, dtype)


def _fp8_library(xq, wq, sx, sw, dtype):
    """``torch._scaled_mm`` on the padded operands (any device that has it)."""
    m, k = xq.shape
    n = wq.shape[1]
    mp, kp, np_ = _up(m, 16), _up(k, 16), _up(n, 16)
    a = _pad(xq.view(torch.uint8), mp, kp).view(_FP8)
    b = _pad(wq.t().contiguous().view(torch.uint8), np_, kp).view(_FP8).t()
    out = torch._scaled_mm(a, b, scale_a=sx.reshape(()).float(), scale_b=sw.reshape(()).float(),
                           out_dtype=dtype)
    return out[:m, :n]


def fp8_product_reference(xq, wq, sx, sw, dtype):
    """The fp8 product's plain version: the codes upcast, an fp32 product,
    the scales, one cast."""
    return ((xq.float() @ wq.float()) * (sx * sw)).to(dtype)


def qmatmul_forward(x, w, mode: str):
    """x [..., k] @ w [k, n] on quantized operands, in x's dtype."""
    if mode not in MODES:
        raise ValueError(f"qmatmul mode must be one of {MODES}, got {mode!r}")
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    if mode == "fp8":
        (xq, sx), (wq, sw) = _cast_fp8(x2), _cast_fp8(w)
        out = fp8_product(xq, wq, sx, sw, x.dtype)
    elif mode == "int8":
        # per-token rows x per-channel columns: the scales stay OUTSIDE the
        # int8 product (an exact rank-1 rescale of the int32 accumulator)
        (xq, sx), (wq, sw) = _cast_i8(x2, dim=-1), _cast_i8(w, dim=0)
        out = (int8_product(xq, wq).float() * sx * sw).to(x.dtype)
    else:
        (xq, sx), (wq, sw) = _cast_i8(x2), _cast_i8(w)
        out = (int8_product(xq, wq).float() * (sx * sw)).to(x.dtype)
    return out.reshape(*lead, w.shape[-1])


def qmatmul_vjp(x, w, g):
    """The exact wide vjp: dx = g @ w.T in x's dtype, dw accumulated in
    fp32 and cast to w's dtype (the JAX package's ``_qmm_bwd``)."""
    dt = torch.promote_types(g.dtype, w.dtype)
    dx = (g.to(dt) @ w.t().to(dt)).to(x.dtype)
    k, n = x.shape[-1], g.shape[-1]
    dw = (x.reshape(-1, k).t().float() @ g.reshape(-1, n).float()).to(w.dtype)
    return dx, dw


class _QMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mode):
        ctx.save_for_backward(x, w)
        return qmatmul_forward(x, w, mode)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = qmatmul_vjp(x, w, g)
        return dx, dw, None


def qmatmul(x, w, mode: str):
    """Quantized-forward matmul x [..., k] @ w [k, n]; the backward is the
    exact wide vjp (``qmatmul_vjp``). An unknown mode raises ValueError.
    An ``autograd.Function``: it takes no forward-mode AD (``torch.func.jvp``)."""
    if mode not in MODES:
        raise ValueError(f"qmatmul mode must be one of {MODES}, got {mode!r}")
    return _QMatmul.apply(x, w, mode)
