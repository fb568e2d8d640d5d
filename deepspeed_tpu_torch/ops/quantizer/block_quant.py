"""Symmetric block quantization (PyTorch).

Counterpart of the single-device part of
``deepspeed_tpu/ops/quantizer/block_quant.py`` (reference
csrc/quantization/pt_binding.cpp ds_quantize, symmetric path): values are
grouped into fixed-size blocks; each block stores int8 values (int4 packed
two per byte) and one fp32 scale = absmax / qmax. Dequant is ``q * scale``.

  * ``quantize_blockwise`` / ``dequantize_blockwise``, ``_quantize_rows`` /
    ``_dequantize_rows``: plain torch, as the JAX package's are plain jnp.
    Stochastic rounding draws its noise from an explicit
    ``torch.Generator`` and raises without one.
  * ``block_quant``: the wrapper of the hand-written CUDA kernel
    (``ops/kernels/csrc/block_quant.cu``, replacing the Pallas
    ``_quant_kernel``): rows [n, block] -> int8 codes [n, block] and fp32
    scales [n]. A CPU tensor takes its plain version,
    ``block_quant_reference``; a CUDA tensor launches the kernel or raises.
  * ``block_quant_pair``: two planes of one shape (the K and the V of one
    write) in one launch, each as ``block_quant`` of it.
  * ``quantize_kv`` / ``dequantize_kv``: per-head-vector int8 for the paged
    KV pools, i.e. ``block_quant`` with a block of d; ``quantize_kv_pair``
    quantizes K and V of one write in one launch (the engine's
    quantize-on-write: on a card every write launches the kernel once).
  * ``quantize_blockwise_kernel``: the counterpart of
    ``quantize_blockwise_pallas`` (rows padded to a multiple of 8, the int4
    pack a torch post-pass), with its plain version
    ``quantize_blockwise_kernel_reference`` beside it.

Deterministic codes and scales equal the JAX package's, compiled as its
engine and its Pallas kernel run them, bit for bit: the scale is absmax
times the fp32 reciprocal of qmax (XLA's form of ``absmax / qmax``), the
inverse ``1 / max(scale, 1e-30)`` an IEEE division (0 for a zero block),
then ``round(x * inv)`` half to even and a clip to +-qmax. The kernels'
stochastic mode adds ``u - 0.5`` before the rounding, where u is the top
24 bits of a counter-based hash (``utils/counter_hash.py``) of (seed,
element index) over 2^24: the kernel and its plain version agree bit for
bit, but the bits are not the TPU PRNG's, so stochastic codes agree with
the JAX package only in distribution.

The qgZ/qwZ collectives (``quantized_reduce_scatter*``,
``quantized_allreduce``, ``loco_*``, ``quantized_all_gather_along``) wait
for the multi-GPU slice (ROADMAP queue 1, item 6).

The FP quantizer (the reference's csrc/fp_quantizer, plain XLA in the JAX
package, plain torch here): ``fp8_cast`` / ``fp8_uncast`` (tensor-scaled
casts to torch's ``float8_e4m3fn``), ``fp_quantize`` / ``fp_dequantize``
(group-scaled rounding to fp6 e3m2, fp8 e4m3 or fp12 e4m7, simulated in
fp32) and ``fp_pack`` / ``fp_unpack`` (the codes packed to bytes: fp6 four
codes in three bytes, fp12 two in three). Scales divide as the JAX
package's eager ops do (``absmax / max``). Exponents and powers of two are
exact (``frexp``, the exponent field), so the codes are the same on every
device.
"""

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.kernels import KERNELS, stream_ptr
from deepspeed_tpu_torch.utils.counter_hash import M32, fold, mix32

_QMAX = {8: 127.0, 4: 7.0}
QUANT_KERNEL = KERNELS["block_quant"]


class QuantizedTensor(NamedTuple):
    values: torch.Tensor  # int8 payload; for bits=4, two biased nibbles per byte
    scales: torch.Tensor  # fp32 per block
    shape: tuple  # original shape
    bits: int
    block_size: int


def _pad_to(x, multiple):
    n = x.shape[0]
    pad = (-n) % multiple
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x, pad


def _pack_int4(q):
    """[-7, 7] int values -> two biased nibbles per byte ([nb, block/2])."""
    biased = (q + 7).to(torch.uint8)  # 0..14
    lo, hi = biased[:, ::2], biased[:, 1::2]
    return (lo | (hi << 4)).view(torch.int8)


def _unpack_int4(packed):
    u = packed.view(torch.uint8)
    lo = (u & 0xF).float() - 7.0
    hi = (u >> 4).float() - 7.0
    nb, half = u.shape
    return torch.stack([lo, hi], dim=-1).reshape(nb, half * 2)


def _scales_and_inverse(absmax, qmax):
    """scale = absmax * fl32(1 / qmax), as XLA compiles the JAX package's
    ``absmax / qmax`` (a division by a constant becomes a product with its
    fp32 reciprocal under jit, where the engine and the Pallas kernel run
    it; JAX's eager op divides, and differs in the last bit of ~4% of the
    scales), and its inverse 1 / max(scale, 1e-30) by IEEE division, 0
    where the block is all zero."""
    scales = absmax * torch.full_like(absmax, float(np.float32(1.0) / np.float32(qmax)))
    inv = torch.where(scales > 0, torch.reciprocal(scales.clamp_min(1e-30)),
                      torch.zeros_like(scales))
    return scales, inv


def quantize_blockwise(x, bits: int = 8, block_size: int = 2048, stochastic: bool = False,
                       rng: Optional[torch.Generator] = None) -> QuantizedTensor:
    """Symmetric per-block quantization. Flattens, pads to block_size.
    ``stochastic`` adds uniform noise in [-0.5, 0.5) from ``rng`` before
    rounding."""
    qmax = _QMAX[bits]
    flat = x.reshape(-1).float()
    flat, _pad = _pad_to(flat, block_size)
    blocks = flat.reshape(-1, block_size)
    scales, inv = _scales_and_inverse(blocks.abs().amax(dim=-1, keepdim=True), qmax)
    scaled = blocks * inv
    if stochastic:
        if rng is None:
            raise ValueError("stochastic=True requires an rng generator (silent "
                             "deterministic fallback would bias gradients)")
        noise = torch.rand(scaled.shape, generator=rng, device=rng.device) - 0.5
        scaled = scaled + noise.to(scaled.device)
    q = torch.clamp(torch.round(scaled), -qmax, qmax)
    values = _pack_int4(q) if bits == 4 else q.to(torch.int8)
    return QuantizedTensor(values=values, scales=scales[:, 0], shape=tuple(x.shape),
                           bits=bits, block_size=block_size)


def dequantize_blockwise(qt: QuantizedTensor, dtype=torch.float32):
    vals = _unpack_int4(qt.values) if qt.bits == 4 else qt.values.float()
    flat = (vals * qt.scales[:, None]).reshape(-1)
    n = 1
    for d in qt.shape:
        n *= d
    return flat[:n].reshape(qt.shape).to(dtype)


def _quantize_rows(rows, bits: int, block_size: int):
    """Per-row blockwise quantization: rows [R, m] (m % block == 0) ->
    (payload int8 [R, nb, bs or bs/2], scales fp32 [R, nb, 1])."""
    qmax = _QMAX[bits]
    R, m = rows.shape
    blocks = rows.float().reshape(R, m // block_size, block_size)
    scales, inv = _scales_and_inverse(blocks.abs().amax(dim=-1, keepdim=True), qmax)
    q = torch.clamp(torch.round(blocks * inv), -qmax, qmax)
    if bits == 4:
        payload = _pack_int4(q.reshape(-1, block_size)).reshape(R, m // block_size,
                                                                 block_size // 2)
    else:
        payload = q.to(torch.int8)
    return payload, scales


def _dequantize_rows(payload, scales, bits: int, block_size: int):
    R, nb = payload.shape[0], payload.shape[1]
    if bits == 4:
        vals = _unpack_int4(payload.reshape(-1, block_size // 2)).reshape(R, nb, block_size)
    else:
        vals = payload.float()
    return (vals * scales).reshape(R, nb * block_size)


# ---------------------------------------------------------------------------
# the block_quant kernel and its plain version
# ---------------------------------------------------------------------------
def stochastic_noise(n: int, block: int, seed: int, device):
    """The kernel's rounding noise for rows [n, block]: u - 0.5 with u the
    top 24 bits of fold(fold(mix32(seed), i >> 32), i) over 2^24, i the
    element's index in the row-major [n, block] array."""
    idx = torch.arange(n * block, device=device, dtype=torch.int64).view(n, block)
    key = mix32(torch.tensor(int(seed) & M32, device=device, dtype=torch.int64))
    bits = fold(fold(key, idx >> 32), idx)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) - 0.5


def block_quant_reference(rows, qmax: float = 127.0, stochastic: bool = False, seed: int = 0):
    """The block_quant kernel's plain version: rows [n, block] (bf16 or
    fp32) -> (int8 codes [n, block], fp32 scales [n])."""
    x = rows.float()
    scales, inv = _scales_and_inverse(x.abs().amax(dim=-1, keepdim=True), qmax)
    scaled = x * inv
    if stochastic:
        scaled = scaled + stochastic_noise(x.shape[0], x.shape[1], seed, x.device)
    q = torch.clamp(torch.round(scaled), -qmax, qmax).to(torch.int8)
    return q, scales[:, 0]


def _kernel_rows(rows, where):
    """Check what the kernel takes; return the rows contiguous."""
    if rows.device.type != "cuda":
        raise ValueError(f"{where}: rows on {rows.device}; expected a CPU or CUDA tensor")
    if rows.dim() != 2 or rows.shape[1] % 8 or rows.shape[1] == 0:
        raise ValueError(f"{where}: rows {tuple(rows.shape)}; expected [n, block] with "
                         "block a positive multiple of 8")
    if rows.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"{where}: {rows.dtype} rows; the kernel takes bf16 or fp32")
    rows = rows.contiguous()
    if rows.numel() and rows.data_ptr() % 16:
        raise ValueError(f"{where}: rows must be 16-byte aligned")
    return rows


def _launch(planes, qmax, stochastic, seed):
    """One launch of the kernel over one or two planes of one shape and
    dtype; returns [(codes, scales)] a plane."""
    n, block = planes[0].shape
    out = [(torch.empty((n, block), dtype=torch.int8, device=x.device),
            torch.empty((n,), dtype=torch.float32, device=x.device)) for x in planes]
    if n == 0:
        return out
    ptrs = [(x.data_ptr(), q.data_ptr(), sc.data_ptr()) for x, (q, sc) in zip(planes, out)]
    second = ptrs[1] if len(ptrs) == 2 else (None, None, None)
    rc = QUANT_KERNEL.fn()(*ptrs[0], *second, n, block, ctypes.c_float(qmax),
                           int(bool(stochastic)), ctypes.c_uint32(int(seed) & M32),
                           int(planes[0].dtype == torch.bfloat16), stream_ptr(planes[0]))
    QUANT_KERNEL.check(rc)
    QUANT_KERNEL.launches += 1
    return out


def block_quant(rows, qmax: float = 127.0, stochastic: bool = False, seed: int = 0):
    """The block_quant kernel's wrapper. A CPU tensor takes the plain
    version (``block_quant_reference``); a CUDA tensor launches the kernel
    or raises. rows: [n, block] bf16 or fp32, block a multiple of 8."""
    if rows.device.type == "cpu":
        return block_quant_reference(rows, qmax, stochastic, seed)
    return _launch([_kernel_rows(rows, "block_quant")], qmax, stochastic, seed)[0]


def block_quant_pair(a, b, qmax: float = 127.0, stochastic: bool = False, seed: int = 0):
    """Two planes of rows of one shape and dtype (the K and the V of one
    write) in one launch: ((codes, scales) of a, of b), each what
    ``block_quant`` of it gives (stochastic noise indexed within each
    plane). CPU tensors take the plain version, ``block_quant_reference``
    of each; CUDA tensors launch the kernel once or raise."""
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"block_quant_pair: planes {tuple(a.shape)} {a.dtype} {a.device} and "
                         f"{tuple(b.shape)} {b.dtype} {b.device}; expected one shape, dtype "
                         "and device")
    if a.device.type == "cpu":
        return (block_quant_reference(a, qmax, stochastic, seed),
                block_quant_reference(b, qmax, stochastic, seed))
    planes = [_kernel_rows(x, "block_quant_pair") for x in (a, b)]
    return tuple(_launch(planes, qmax, stochastic, seed))


def quantize_kv(x):
    """Symmetric per-head-vector int8 quantization for paged KV-cache
    payloads: ``x`` [..., d] -> (int8 payload [..., d], fp32 scales [...]),
    scale = absmax/127 over each head vector's d components, dequant
    ``q * scale``. Per-vector granularity lets quantize-on-write append a
    token without touching its neighbours' scales. On a card: one
    ``block_quant`` launch with a block of d."""
    d = x.shape[-1]
    q, scales = block_quant(x.reshape(-1, d), _QMAX[8])
    return q.view(x.shape), scales.view(x.shape[:-1])


def quantize_kv_pair(k, v):
    """``quantize_kv`` of K and of V of one write (one shape): ((k payload,
    k scales), (v payload, v scales)). On a card: one ``block_quant``
    launch over both planes (the engine's quantize-on-write)."""
    d = k.shape[-1]
    (qk, sk), (qv, sv) = block_quant_pair(k.reshape(-1, d), v.reshape(-1, d), _QMAX[8])
    return (qk.view(k.shape), sk.view(k.shape[:-1])), (qv.view(v.shape), sv.view(v.shape[:-1]))


def dequantize_kv(values, scales, dtype=torch.float32):
    """Inverse of :func:`quantize_kv`: int8 payload [..., d] + fp32 scales
    [...] -> dense [..., d] in ``dtype``."""
    return (values.float() * scales[..., None].float()).to(dtype)


def _blockwise(rows_fn, x, bits, block_size, stochastic, seed) -> QuantizedTensor:
    flat, _ = _pad_to(x.reshape(-1), block_size * 8)
    values, scales = rows_fn(flat.view(-1, block_size), _QMAX[bits], stochastic, seed)
    if bits == 4:
        values = _pack_int4(values.float())
    return QuantizedTensor(values=values, scales=scales, shape=tuple(x.shape), bits=bits,
                           block_size=block_size)


def quantize_blockwise_kernel(x, bits: int = 8, block_size: int = 2048,
                              stochastic: bool = False, seed: int = 0) -> QuantizedTensor:
    """Counterpart of ``quantize_blockwise_pallas``: flattened x padded to
    a multiple of 8 blocks, one ``block_quant`` launch on a card (int8
    layout; the int4 pack is a torch post-pass)."""
    return _blockwise(block_quant, x, bits, block_size, stochastic, seed)


def quantize_blockwise_kernel_reference(x, bits: int = 8, block_size: int = 2048,
                                        stochastic: bool = False,
                                        seed: int = 0) -> QuantizedTensor:
    """``quantize_blockwise_kernel``'s plain version, on any device."""
    return _blockwise(block_quant_reference, x, bits, block_size, stochastic, seed)


# ---------------------------------------------------------------------------
# fp8 scaled casts and low-bit float quantization (reference csrc/fp_quantizer)
# ---------------------------------------------------------------------------
def true_div(a, c: float):
    """a / c by IEEE division on every device. CUDA computes a division by
    a Python scalar as a product with its reciprocal (and so does XLA
    under jit); a tensor divisor keeps the division the JAX package's
    eager ops do, so a card's scales equal the host's."""
    return a / torch.full_like(a, c)


def fp8_cast(x, dtype=torch.float8_e4m3fn):
    """Tensor-scaled fp8 cast: returns (fp8 values, fp32 scale). x is
    scaled into the format's range first: torch saturates an out-of-range
    cast where the JAX package gives NaN, and inside the range the two
    casts agree."""
    xf = x.float()
    absmax = xf.abs().amax()
    scale = torch.where(absmax > 0, true_div(absmax, torch.finfo(dtype).max),
                        torch.ones_like(absmax))
    return (xf / scale).to(dtype), scale


def fp8_uncast(values, scale, dtype=torch.float32):
    return (values.float() * scale).to(dtype)


_FP_FORMATS = {6: (3, 2), 8: (4, 3), 12: (4, 7)}  # bits -> (exp_bits, man_bits)


def _floor_log2(ax):
    """floor(log2(ax)) of positive values, exactly (frexp's exponent - 1),
    as a float tensor; below 1e-38 the exponent of 1e-38."""
    return (torch.frexp(ax.clamp_min(1e-38)).exponent - 1).to(ax.dtype)


def _pow2(e):
    """2^e for integral e in fp32's normal range, exactly: the exponent
    field written directly (exp2 may be off by an ulp on some devices, as
    XLA's CPU exp2 is at integers beyond +-12)."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _round_to_fp(x, exp_bits, man_bits):
    """Round |x| to the nearest representable e{exp_bits}m{man_bits} value
    (half to even on the mantissa grid), flushing values below half the
    smallest subnormal to zero and saturating at the format max."""
    bias = (1 << (exp_bits - 1)) - 1
    emin = 1 - bias  # smallest normal exponent
    emax = bias  # the reference formats are finite: no inf/nan codes
    ax = x.abs()
    e = _floor_log2(ax).clamp(emin, emax)
    step = _pow2(e - man_bits)
    q = torch.round(ax / step) * step
    q = q.clamp_max(2.0 ** emax * (2.0 - 2.0 ** -man_bits))
    q = torch.where(ax < 2.0 ** (emin - man_bits) / 2, torch.zeros_like(q), q)
    return torch.sign(x) * q


def fp_quantize(x, q_bits: int = 6, group_size: int = 128):
    """Group-scaled low-bit float quantization (reference
    FP_Quantize.quantize): per-group absmax scaling into the format's
    range, then e/m rounding. Returns (values fp32 [groups, group_size]
    simulated in the format, scales fp32 [groups, 1], the original shape);
    the memory-format pack lives in ``fp_pack``."""
    if q_bits not in _FP_FORMATS:
        raise ValueError(f"q_bits must be one of {sorted(_FP_FORMATS)}, got {q_bits}")
    exp_bits, man_bits = _FP_FORMATS[q_bits]
    orig_shape = tuple(x.shape)
    flat, _ = _pad_to(x.float().reshape(-1), group_size)
    groups = flat.reshape(-1, group_size)
    bias = (1 << (exp_bits - 1)) - 1
    fmt_max = 2.0 ** bias * (2.0 - 2.0 ** (-man_bits))
    absmax = groups.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, true_div(absmax, fmt_max), torch.ones_like(absmax))
    return _round_to_fp(groups / scale, exp_bits, man_bits), scale, orig_shape


def fp_dequantize(q, scale, orig_shape, dtype=torch.float32):
    n = 1
    for s in orig_shape:
        n *= s
    return (q * scale).reshape(-1)[:n].reshape(orig_shape).to(dtype)


def fp_pack(q, q_bits: int, exp_bits: int = None, man_bits: int = None):
    """Encode format-rounded values into integer codes and pack them to
    uint8: fp6 packs 4 codes into 3 bytes, fp12 packs 2 codes into 3 bytes,
    fp8 one code a byte (the reference's packing, csrc/fp_quantizer)."""
    if exp_bits is None:
        exp_bits, man_bits = _FP_FORMATS[q_bits]
    bias = (1 << (exp_bits - 1)) - 1
    sign = (q < 0).to(torch.int64)
    ax = q.abs()
    e = _floor_log2(ax).clamp(1 - bias, bias)
    # subnormals: values below 2^emin encode with biased exponent 0
    is_sub = ax < 2.0 ** (1 - bias)
    man = torch.where(is_sub, ax * 2.0 ** (bias - 1 + man_bits),
                      (ax / _pow2(e) - 1.0) * 2.0 ** man_bits)
    man = torch.round(man).clamp(0, (1 << man_bits) - 1).to(torch.int64)
    biased = torch.where(is_sub, torch.zeros_like(man), (e + bias).to(torch.int64))
    flat = ((sign << (exp_bits + man_bits)) | (biased << man_bits) | man).reshape(-1)
    if q_bits == 6:
        flat = _pad_to(flat, 4)[0].reshape(-1, 4)
        b0 = flat[:, 0] | ((flat[:, 1] & 0x3) << 6)
        b1 = (flat[:, 1] >> 2) | ((flat[:, 2] & 0xF) << 4)
        b2 = (flat[:, 2] >> 4) | (flat[:, 3] << 2)
        return (torch.stack([b0, b1, b2], -1) & 0xFF).to(torch.uint8).reshape(-1)
    if q_bits == 12:
        flat = _pad_to(flat, 2)[0].reshape(-1, 2)
        b0 = flat[:, 0] & 0xFF
        b1 = (flat[:, 0] >> 8) | ((flat[:, 1] & 0xF) << 4)
        b2 = flat[:, 1] >> 4
        return (torch.stack([b0, b1, b2], -1) & 0xFF).to(torch.uint8).reshape(-1)
    return (flat & 0xFF).to(torch.uint8)


def fp_unpack(packed, n: int, q_bits: int):
    """Inverse of ``fp_pack`` -> fp32 values (before the scale)."""
    exp_bits, man_bits = _FP_FORMATS[q_bits]
    bias = (1 << (exp_bits - 1)) - 1
    trip = packed.to(torch.int64)
    if q_bits == 6:
        trip = trip.reshape(-1, 3)
        c0 = trip[:, 0] & 0x3F
        c1 = ((trip[:, 0] >> 6) | (trip[:, 1] << 2)) & 0x3F
        c2 = ((trip[:, 1] >> 4) | (trip[:, 2] << 4)) & 0x3F
        c3 = (trip[:, 2] >> 2) & 0x3F
        codes = torch.stack([c0, c1, c2, c3], -1).reshape(-1)[:n]
    elif q_bits == 12:
        trip = trip.reshape(-1, 3)
        c0 = trip[:, 0] | ((trip[:, 1] & 0xF) << 8)
        c1 = (trip[:, 1] >> 4) | (trip[:, 2] << 4)
        codes = torch.stack([c0, c1], -1).reshape(-1)[:n]
    else:
        codes = trip[:n]
    sign = torch.where(((codes >> (exp_bits + man_bits)) & 1).bool(), -1.0, 1.0)
    biased = (codes >> man_bits) & ((1 << exp_bits) - 1)
    man = (codes & ((1 << man_bits) - 1)).float()
    mag = torch.where(biased == 0, man * 2.0 ** (1 - bias - man_bits),
                      (1.0 + man * 2.0 ** (-man_bits)) * _pow2(biased - bias))
    return sign * mag
