"""Host-side (CPU) optimizer steps for the offload tiers.

Counterpart of ``deepspeed_tpu/ops/adam/cpu_adam.py``: the native library
is ``csrc/adam/cpu_adam.cpp`` (shared with the JAX package, read-only),
OpenMP loops over flat fp32 arrays, built by ``CPUAdamBuilder`` at first
use and bound with ctypes. Every entry point takes contiguous CPU tensors
(fp32; the casts' bf16 side as int16 / uint16 / bfloat16), pinned where a
card is present, and hands their ``data_ptr()`` to the library; there is
no fallback. Each function's plain version (``*_reference``: the JAX
module's numpy math, on numpy views of the same tensors) is what the tests
hold the library against.

The library runs on every core (OpenMP); ``set_num_threads`` bounds it,
as tests that run side by side must (``omp_set_num_threads`` of the
library's OpenMP runtime, for the calling thread).
"""

import ctypes
import itertools

import numpy as np
import torch

from deepspeed_tpu_torch.ops.op_builder import NativeOpBuilder


class CPUAdamBuilder(NativeOpBuilder):
    NAME = "cpu_adam"
    SOURCES = ("adam/cpu_adam.cpp",)

    @staticmethod
    def _bind(lib):
        f32, i32, i64 = ctypes.c_float, ctypes.c_int, ctypes.c_int64
        p = ctypes.c_void_p
        lib.dstpu_create_adam.restype = i32
        lib.dstpu_create_adam.argtypes = [i32, f32, f32, f32, f32, f32, i32]
        lib.dstpu_destroy_adam.restype = i32
        lib.dstpu_destroy_adam.argtypes = [i32]
        lib.dstpu_adam_update.restype = i32
        lib.dstpu_adam_update.argtypes = [i32, i64, f32, p, p, p, p, i64]
        lib.dstpu_adagrad_update.restype = i32
        lib.dstpu_adagrad_update.argtypes = [f32, f32, f32, p, p, p, i64]
        lib.dstpu_lion_update.restype = i32
        lib.dstpu_lion_update.argtypes = [f32, f32, f32, f32, p, p, p, i64]
        lib.dstpu_bf16_to_fp32.restype = i32
        lib.dstpu_bf16_to_fp32.argtypes = [p, p, i64]
        lib.dstpu_fp32_to_bf16.restype = i32
        lib.dstpu_fp32_to_bf16.argtypes = [p, p, i64]
        lib.omp_set_num_threads.restype = None
        lib.omp_set_num_threads.argtypes = [i32]
        lib.omp_get_max_threads.restype = i32
        lib.omp_get_max_threads.argtypes = []


_IDS = itertools.count(1)
_HALF = (torch.bfloat16, torch.int16, torch.uint16)


def set_num_threads(n: int) -> int:
    """Bound the library's OpenMP threads (for the calling thread's later
    calls); returns the previous bound."""
    lib = CPUAdamBuilder.lib()
    prev = lib.omp_get_max_threads()
    lib.omp_set_num_threads(max(1, int(n)))
    return prev


def _ptr(t: torch.Tensor, dtypes=(torch.float32,)) -> int:
    if not isinstance(t, torch.Tensor) or t.device.type != "cpu":
        raise ValueError("cpu adam buffers must be CPU tensors")
    if t.dtype not in dtypes or not t.is_contiguous():
        raise ValueError(f"cpu adam buffers must be contiguous {dtypes[0]} tensors, "
                         f"got {t.dtype}{'' if t.is_contiguous() else ' (strided)'}")
    return t.data_ptr()


def _same_size(n, *ts):
    if any(t.numel() != n for t in ts):
        raise ValueError(f"param size {n} != " + " / ".join(str(t.numel()) for t in ts))


class DeepSpeedCPUAdam:
    """Host Adam/AdamW over flat fp32 tensors (the JAX package's
    ``DeepSpeedCPUAdam``). ``step(params, grads, exp_avg, exp_avg_sq,
    lr=, step=)`` updates the tensors in place and returns the step count."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 adamw_mode=True):
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.steps = 0
        self._id = next(_IDS)
        self._lib = CPUAdamBuilder.lib()
        self._lib.dstpu_create_adam(self._id, lr, self.beta1, self.beta2, eps, weight_decay,
                                    int(adamw_mode))

    def step(self, params, grads, exp_avg, exp_avg_sq, lr=None, step=None):
        lr = self.lr if lr is None else float(lr)
        self.steps = int(step) if step is not None else self.steps + 1
        ptrs = [_ptr(t) for t in (params, grads, exp_avg, exp_avg_sq)]
        n = params.numel()
        _same_size(n, grads, exp_avg, exp_avg_sq)
        rc = self._lib.dstpu_adam_update(self._id, self.steps, lr, *ptrs, n)
        if rc != 0:
            raise RuntimeError(f"cpu adam_update failed rc={rc}")
        return self.steps

    def step_reference(self, params, grads, exp_avg, exp_avg_sq, lr=None, step=None):
        """The plain version of ``step`` (the JAX module's numpy math)."""
        lr = self.lr if lr is None else float(lr)
        self.steps = int(step) if step is not None else self.steps + 1
        params, grads, exp_avg, exp_avg_sq = (t.numpy() for t in (params, grads, exp_avg,
                                                                  exp_avg_sq))
        b1, b2, eps, wd = self.beta1, self.beta2, self.eps, self.weight_decay
        t = self.steps
        g = grads
        if not self.adamw_mode and wd != 0.0:
            g = grads + wd * params
        np.multiply(exp_avg, b1, out=exp_avg)
        exp_avg += (1.0 - b1) * g
        np.multiply(exp_avg_sq, b2, out=exp_avg_sq)
        exp_avg_sq += (1.0 - b2) * np.square(g)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        denom = np.sqrt(exp_avg_sq) / np.sqrt(bc2) + eps
        if self.adamw_mode and wd != 0.0:
            params *= 1.0 - lr * wd
        params -= (lr / bc1) * (exp_avg / denom)
        return self.steps

    def __del__(self):
        try:
            self._lib.dstpu_destroy_adam(self._id)
        except Exception:  # interpreter shutdown
            pass


def cpu_adagrad_step(params, grads, exp_avg_sq, lr, eps=1e-8, weight_decay=0.0):
    """Host Adagrad step (reference csrc/adagrad/cpu_adagrad.cpp)."""
    ptrs = [_ptr(t) for t in (params, grads, exp_avg_sq)]
    n = params.numel()
    _same_size(n, grads, exp_avg_sq)
    rc = CPUAdamBuilder.lib().dstpu_adagrad_update(lr, eps, weight_decay, *ptrs, n)
    if rc != 0:
        raise RuntimeError(f"cpu adagrad_update failed rc={rc}")


def cpu_adagrad_step_reference(params, grads, exp_avg_sq, lr, eps=1e-8, weight_decay=0.0):
    params, grads, exp_avg_sq = params.numpy(), grads.numpy(), exp_avg_sq.numpy()
    g = grads + weight_decay * params if weight_decay else grads
    exp_avg_sq += np.square(g)
    params -= lr * g / (np.sqrt(exp_avg_sq) + eps)


def cpu_lion_step(params, grads, exp_avg, lr, betas=(0.9, 0.99), weight_decay=0.0):
    """Host Lion step (reference csrc/lion/cpu_lion.cpp)."""
    ptrs = [_ptr(t) for t in (params, grads, exp_avg)]
    n = params.numel()
    _same_size(n, grads, exp_avg)
    rc = CPUAdamBuilder.lib().dstpu_lion_update(lr, betas[0], betas[1], weight_decay, *ptrs, n)
    if rc != 0:
        raise RuntimeError(f"cpu lion_update failed rc={rc}")


def cpu_lion_step_reference(params, grads, exp_avg, lr, betas=(0.9, 0.99), weight_decay=0.0):
    params, grads, exp_avg = params.numpy(), grads.numpy(), exp_avg.numpy()
    c = betas[0] * exp_avg + (1.0 - betas[0]) * grads
    params -= lr * (np.sign(c) + weight_decay * params)
    exp_avg *= betas[1]
    exp_avg += (1.0 - betas[1]) * grads


def _bits(t):
    """A 16-bit tensor's bits as uint16 numpy (bfloat16 included)."""
    return t.view(torch.int16).numpy().view(np.uint16)


def bf16_to_fp32(src, dst=None):
    """Widen bf16 (a bfloat16, int16 or uint16 tensor of its bits) into an
    fp32 tensor, made when ``dst`` is None."""
    sp = _ptr(src, _HALF)
    n = src.numel()
    if dst is None:
        dst = torch.empty(n, dtype=torch.float32)
    _same_size(n, dst)
    CPUAdamBuilder.lib().dstpu_bf16_to_fp32(sp, _ptr(dst), n)
    return dst


def bf16_to_fp32_reference(src, dst=None):
    if dst is None:
        dst = torch.empty(src.numel(), dtype=torch.float32)
    dst.numpy().reshape(-1)[:] = (_bits(src).reshape(-1).astype(np.uint32) << 16).view(np.float32)
    return dst


def fp32_to_bf16(src, dst=None):
    """Round fp32 to bf16 (round-to-nearest-even) into a 16-bit tensor
    (bfloat16 when made here)."""
    sp = _ptr(src)
    n = src.numel()
    if dst is None:
        dst = torch.empty(n, dtype=torch.bfloat16)
    _same_size(n, dst)
    CPUAdamBuilder.lib().dstpu_fp32_to_bf16(sp, _ptr(dst, _HALF), n)
    return dst


def fp32_to_bf16_reference(src, dst=None):
    if dst is None:
        dst = torch.empty(src.numel(), dtype=torch.bfloat16)
    bits = src.numpy().reshape(-1).view(np.uint32)
    rounding = np.uint32(0x7FFF) + ((bits >> 16) & 1)
    _bits(dst).reshape(-1)[:] = ((bits + rounding) >> 16).astype(np.uint16)
    return dst


__all__ = [
    "CPUAdamBuilder", "DeepSpeedCPUAdam", "bf16_to_fp32", "bf16_to_fp32_reference",
    "cpu_adagrad_step", "cpu_adagrad_step_reference", "cpu_lion_step",
    "cpu_lion_step_reference", "fp32_to_bf16", "fp32_to_bf16_reference", "set_num_threads",
]
