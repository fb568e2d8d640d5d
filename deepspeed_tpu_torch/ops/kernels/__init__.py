"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source exposes plain C entry points (one source may hold
several, e.g. the two flash-backward kernels) and builds into its
own shared library with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC`` at first use, into ``build/torch_kernels/`` at
the root of the checkout (listed in ``.gitignore``). Libraries are named by
a digest of their sources and flags, so an edited source rebuilds. The
library is bound with ``ctypes``; nothing includes PyTorch's headers, so a
build takes seconds.

Nothing here runs at import time: CPU-only installs import every module,
and ``nvcc`` and a card are needed only when a kernel is first launched. ``build()`` starts one ``nvcc`` per source, all together,
for callers that want the builds up front (``chip_smoke.py``).

Every entry point returns ``cudaGetLastError()`` after its launch;
``Kernel.check`` raises on anything but 0. Each ``Kernel`` carries
``launches``, a plain count its wrapper raises by one per launch.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


class Kernel:
    """One CUDA source, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes, replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self._lib = None
        self._fn = None
        self._lock = threading.Lock()

    @property
    def source_path(self) -> Path:
        return CSRC / self.source

    @property
    def loaded(self) -> bool:
        """Whether this process has built or loaded the library and bound
        the entry point (the first ``fn()`` does)."""
        return self._fn is not None

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for p in [self.source_path, *sorted(CSRC.glob("*.cuh"))]:
            h.update(p.name.encode())
            h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source_path.stem}-{h.hexdigest()[:12]}.so"

    def fn(self):
        """The bound C entry point, building the library on first use."""
        if self._fn is None:
            with self._lock:
                if self._fn is None:
                    path = self.library_path()
                    if not path.exists():
                        build([self])
                    lib = ctypes.CDLL(str(path))
                    fn = getattr(lib, self.symbol)
                    fn.argtypes = self.argtypes
                    fn.restype = ctypes.c_int
                    err = lib.dstt_error_string
                    err.argtypes = [ctypes.c_int]
                    err.restype = ctypes.c_char_p
                    self._lib = lib
                    self._fn = fn
        return self._fn

    def check(self, rc: int) -> None:
        if rc != 0:
            msg = self._lib.dstt_error_string(rc).decode() if self._lib else "?"
            raise RuntimeError(f"{self.name}: CUDA launch failed with error {rc} ({msg})")


KERNELS: Dict[str, Kernel] = {
    k.name: k
    for k in (
        Kernel(
            "rms_norm_fwd", "rms_norm.cu", "dstt_rms_norm_fwd",
            # x, w, out, rows, h, eps, x_bf16, w_bf16, vec, stream
            [_P, _P, _P, ctypes.c_longlong, _I, ctypes.c_float, _I, _I, _I, _P],
            "deepspeed_tpu/ops/normalization/fused_norm.py:30",
        ),
        Kernel(
            "paged_decode", "paged_decode.cu", "dstt_paged_decode",
            # q, k, v, tables, qpos, limit, ke, ve, epos, out, part_acc, part_ml,
            # n_tok, nh, nkv, d, bs, B, E, x_stride, e_stride, trash, window,
            # split_keys, pool_splits, extra_splits, scale, bf16, stream
            [_P] * 12 + [_I] * 7 + [_L] * 2 + [_I] * 5 + [ctypes.c_float, _I, _P],
            "deepspeed_tpu/ops/attention/paged_pallas.py:84",
        ),
        Kernel(
            "paged_decode_int8", "paged_decode.cu", "dstt_paged_decode_int8",
            # q, k, v, k_scale, v_scale, tables, qpos, limit, ke, ve, epos, out,
            # part_acc, part_ml, then as paged_decode
            [_P] * 14 + [_I] * 7 + [_L] * 2 + [_I] * 5 + [ctypes.c_float, _I, _P],
            "deepspeed_tpu/ops/attention/paged_pallas.py:84",
        ),
        Kernel(
            "block_quant", "block_quant.cu", "dstt_block_quant",
            # x, q, scales, x2, q2, scales2 (a second plane, or null), rows,
            # block, qmax, stochastic, seed, x_bf16, stream
            [_P] * 6 + [ctypes.c_longlong, _I, ctypes.c_float, _I, ctypes.c_uint32, _I, _P],
            "deepspeed_tpu/ops/quantizer/block_quant.py:519",
        ),
        Kernel(
            "rms_norm_bwd", "rms_norm.cu", "dstt_rms_norm_bwd",
            # x, w, g, dx, rows, h, eps, x_bf16, w_bf16, vec, stream
            [_P] * 4 + [ctypes.c_longlong, _I, ctypes.c_float, _I, _I, _I, _P],
            "deepspeed_tpu/ops/normalization/fused_norm.py:36",
        ),
        Kernel(
            "flash_fwd", "flash_fwd.cu", "dstt_flash_fwd",
            # q, k, v, seg, out, lse, b, h, h_kv, s, d, scale,
            # causal, window, window_flag, stream
            [_P] * 6 + [_I] * 5 + [ctypes.c_float] + [_I] * 3 + [_P],
            "deepspeed_tpu/ops/attention/flash_pallas.py:69",
        ),
        Kernel(
            "flash_bwd_dq", "flash_bwd.cu", "dstt_flash_bwd_dq",
            # q, k, v, o, do, lse, seg, dq, b, h, h_kv, s, d, scale,
            # causal, window, window_flag, stream
            [_P] * 8 + [_I] * 5 + [ctypes.c_float] + [_I] * 3 + [_P],
            "deepspeed_tpu/ops/attention/flash_pallas.py:152",
        ),
        Kernel(
            "flash_bwd_dkv", "flash_bwd.cu", "dstt_flash_bwd_dkv",
            # q, k, v, o, do, lse, seg, dk, dv, b, h, h_kv, s, d, scale,
            # causal, window, window_flag, stream
            [_P] * 9 + [_I] * 5 + [ctypes.c_float] + [_I] * 3 + [_P],
            "deepspeed_tpu/ops/attention/flash_pallas.py:220",
        ),
        Kernel(
            "flash_fwd_alibi", "flash_fwd.cu", "dstt_flash_fwd_alibi",
            # q, k, v, seg, slopes, kpos, out, lse, b, h, h_kv, s, d, scale,
            # causal, window, window_flag, stream
            [_P] * 8 + [_I] * 5 + [ctypes.c_float] + [_I] * 3 + [_P],
            "deepspeed_tpu/ops/attention/flash_pallas.py:69",
        ),
        Kernel(
            "flash_bwd_dq_alibi", "flash_bwd.cu", "dstt_flash_bwd_dq_alibi",
            # q, k, v, o, do, lse, seg, slopes, kpos, dq, b, h, h_kv, s, d,
            # scale, causal, window, window_flag, stream
            [_P] * 10 + [_I] * 5 + [ctypes.c_float] + [_I] * 3 + [_P],
            "deepspeed_tpu/ops/attention/flash_pallas.py:152",
        ),
        Kernel(
            "flash_bwd_dkv_alibi", "flash_bwd.cu", "dstt_flash_bwd_dkv_alibi",
            # q, k, v, o, do, lse, seg, slopes, kpos, dk, dv, b, h, h_kv, s, d,
            # scale, causal, window, window_flag, stream
            [_P] * 11 + [_I] * 5 + [ctypes.c_float] + [_I] * 3 + [_P],
            "deepspeed_tpu/ops/attention/flash_pallas.py:220",
        ),
        Kernel(
            "flash_fwd_chunk", "flash_chunk.cu", "dstt_flash_fwd_chunk",
            # q, k, v, seg_q, seg_k, m, l, acc, out, lse, b, h, h_kv, s, d,
            # scale, causal, flags, stream
            [_P] * 10 + [_I] * 5 + [ctypes.c_float] + [_I] * 2 + [_P],
            "deepspeed_tpu/ops/attention/flash_pallas.py:694",
        ),
        Kernel(
            "flash_dq_chunk", "flash_chunk.cu", "dstt_flash_dq_chunk",
            # q, k, v, o, do, lse, seg_q, seg_k, dq_c, dq, b, h, h_kv, s, d,
            # scale, causal, flags, stream
            [_P] * 10 + [_I] * 5 + [ctypes.c_float] + [_I] * 2 + [_P],
            "deepspeed_tpu/ops/attention/flash_pallas.py:775",
        ),
        Kernel(
            "flash_dkv_chunk", "flash_chunk.cu", "dstt_flash_dkv_chunk",
            # q, k, v, o, do, lse, seg_q, seg_k, dk_c, dv_c, dk, dv, b, h,
            # h_kv, s, d, scale, causal, flags, stream
            [_P] * 12 + [_I] * 5 + [ctypes.c_float] + [_I] * 2 + [_P],
            "deepspeed_tpu/ops/attention/flash_pallas.py:835",
        ),
        Kernel(
            "splash_fwd", "splash_fwd.cu", "dstt_splash_fwd",
            # q, k, v, seg, kv_index, step_kind, out, lse, b, h, h_kv, sq, sk,
            # d, scale, sched_heads, nq, width, block_q, block_kv, causal,
            # window, seg_all, base, stream
            [_P] * 8 + [_I] * 6 + [ctypes.c_float] + [_I] * 9 + [_P],
            "deepspeed_tpu/ops/sparse_attention/splash_pallas.py:100",
        ),
        Kernel(
            "splash_bwd_dq", "splash_bwd.cu", "dstt_splash_bwd_dq",
            # q, k, v, o, do, lse, seg, kv_index, step_kind, dq, b, h, h_kv,
            # sq, sk, d, scale, sched_heads, nq, width, block_q, block_kv,
            # causal, window, seg_all, stream
            [_P] * 10 + [_I] * 6 + [ctypes.c_float] + [_I] * 8 + [_P],
            "deepspeed_tpu/ops/sparse_attention/splash_pallas.py:169",
        ),
        Kernel(
            "splash_bwd_dkv", "splash_bwd.cu", "dstt_splash_bwd_dkv",
            # q, k, v, o, do, lse, seg, q_index, step_kind_t, dk, dv, b, h,
            # h_kv, sq, sk, d, scale, sched_heads, nk, width_t, block_q,
            # block_kv, causal, window, seg_all, stream
            [_P] * 11 + [_I] * 6 + [ctypes.c_float] + [_I] * 8 + [_P],
            "deepspeed_tpu/ops/sparse_attention/splash_pallas.py:231",
        ),
        Kernel(
            "sparse_fwd", "sparse_fwd.cu", "dstt_sparse_fwd",
            # q, k, v, layout, out, lse, b, h, s, d, scale, nb, log2(block),
            # causal, stream
            [_P] * 6 + [_I] * 4 + [ctypes.c_float] + [_I] * 3 + [_P],
            "deepspeed_tpu/ops/sparse_attention/sparse_pallas.py:32",
        ),
        Kernel(
            "sparse_bwd_dq", "sparse_bwd.cu", "dstt_sparse_bwd_dq",
            # q, k, v, o, do, lse, layout, dq, b, h, s, d, scale, nb,
            # log2(block), causal, stream
            [_P] * 8 + [_I] * 4 + [ctypes.c_float] + [_I] * 3 + [_P],
            "deepspeed_tpu/ops/sparse_attention/sparse_pallas.py:78",
        ),
        Kernel(
            "sparse_bwd_dkv", "sparse_bwd.cu", "dstt_sparse_bwd_dkv",
            # q, k, v, o, do, lse, layout_t, dk, dv, b, h, s, d, scale, nb,
            # log2(block), causal, cta_clock, stream
            [_P] * 9 + [_I] * 4 + [ctypes.c_float] + [_I] * 3 + [_P, _P],
            "deepspeed_tpu/ops/sparse_attention/sparse_pallas.py:118",
        ),
        Kernel(
            "evoformer_fwd", "evoformer_fwd.cu", "dstt_evoformer_fwd",
            # q, k, v, b1, b2, out, lse, b1 strides (batch, head, row), b2
            # strides, B, h, s, d, scale, fp32, vec, group, stream
            [_P] * 7 + [_L] * 6 + [_I] * 4 + [ctypes.c_float, _I, _I, _I, _P],
            "deepspeed_tpu/ops/deepspeed4science/evoformer_attn.py:27",
        ),
        Kernel(
            "evoformer_bwd_dq", "evoformer_bwd.cu", "dstt_evoformer_bwd_dq",
            # q, k, v, o, do, lse, b1, b2, dq, delta, ds, row partials (each of
            # the last two or null), b1 strides, b2 strides, B, h, s, d, scale,
            # fp32, vec, group, stream
            [_P] * 12 + [_L] * 6 + [_I] * 4 + [ctypes.c_float] + [_I] * 3 + [_P],
            "deepspeed_tpu/ops/deepspeed4science/evoformer_attn.py:60",
        ),
        Kernel(
            "evoformer_bwd_dkv", "evoformer_bwd.cu", "dstt_evoformer_bwd_dkv",
            # q, k, v, do, lse, delta, b1, b2, dk, dv, column partials (or
            # null), b1 strides, b2 strides, B, h, s, d, scale, fp32, vec,
            # group, stream
            [_P] * 11 + [_L] * 6 + [_I] * 4 + [ctypes.c_float] + [_I] * 3 + [_P],
            "deepspeed_tpu/ops/deepspeed4science/evoformer_attn.py:90",
        ),
        Kernel(
            # the second pass of _bwd_dq_kernel's bias gradient (its dS plane
            # is summed to each bias's shape in XLA)
            "evoformer_bias_grad_merge", "evoformer_bwd.cu", "dstt_evoformer_bias_grad_merge",
            # src0, dst0, a0, a1, a2, n, flags0, src1, dst1, c0, c1, c2, m,
            # flags1, jobs, stream
            [_P] * 2 + [_I] * 5 + [_P] * 2 + [_I] * 6 + [_P],
            "deepspeed_tpu/ops/deepspeed4science/evoformer_attn.py:60",
        ),
        Kernel(
            "fused_ce_fwd", "fused_ce.cu", "dstt_fused_ce_fwd",
            # x, w, labels, pm, pl, tgt, loss, lse, n, h, V, span, stream
            [_P] * 8 + [_I] * 4 + [_P],
            "deepspeed_tpu/ops/fused_ce.py:56",
        ),
        Kernel(
            "fused_ce_dx", "fused_ce_bwd.cu", "dstt_fused_ce_dx",
            # x, w, labels, lse, g, dx32, n, h, V, stream
            [_P] * 6 + [_I] * 3 + [_P],
            "deepspeed_tpu/ops/fused_ce.py:95",
        ),
        Kernel(
            "fused_ce_dw", "fused_ce_bwd.cu", "dstt_fused_ce_dw",
            # x, w, labels, lse, g, dw32, n, h, V, stream
            [_P] * 6 + [_I] * 3 + [_P],
            "deepspeed_tpu/ops/fused_ce.py:127",
        ),
        Kernel(
            "fused_adam", "fused_adam.cu", "dstt_fused_adam",
            # p, g, m, v, lowp, n, lr, b1, b2, 1-b1, 1-b2, eps, wd, c1, c2,
            # adamw, bias_correction, lowp_kind, stream
            [_P] * 5 + [ctypes.c_longlong] + [ctypes.c_float] * 9 + [_I] * 3 + [_P],
            "deepspeed_tpu/ops/adam/fused_adam.py:55",
        ),
    )
}


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the port's CUDA kernels build from source at first use"
        )
    return found


def build(kernels: Optional[Iterable[Kernel]] = None) -> List[dict]:
    """Compile each kernel's library that is not built yet, one ``nvcc``
    per source, all started together. Returns one record per source, named
    by its kernels: library path, seconds (0 when it was already built) and
    the ``-Xptxas -v`` report. Raises if any build fails."""
    by_source: Dict[str, List[Kernel]] = {}
    for k in KERNELS.values() if kernels is None else kernels:
        by_source.setdefault(k.source, []).append(k)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = []
    for ks in by_source.values():
        k = ks[0]
        out = k.library_path()
        if out.exists():
            jobs.append((k, out, None, None, 0.0))
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(k.source_path)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((k, out, tmp, proc, time.perf_counter()))
    records = []
    failures = []
    for k, out, tmp, proc, t0 in jobs:
        name = "+".join(x.name for x in by_source[k.source])
        if proc is None:
            records.append({"name": name, "library": str(out), "seconds": 0.0, "ptxas": ""})
            continue
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{k.source}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        records.append({"name": name, "library": str(out), "seconds": secs, "ptxas": log})
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return records


def stream_ptr(tensor) -> int:
    """PyTorch's current stream on the tensor's device, as an int handle."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
