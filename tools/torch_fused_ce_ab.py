#!/usr/bin/env python3
"""The port's fused-CE backward kernels of several checkouts, timed in turns
on one card, and the rate of the reductions they are built on.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_fused_ce_ab.py [OTHER_ROOT ...] [--rounds 1] [--reduce] [--profile]

Each OTHER_ROOT is another checkout of the repo (e.g. the parent commit
unpacked with ``git archive``). Each round times ``fused_ce_fwd``,
``fused_ce_dx`` and ``fused_ce_dw`` at the train step's shape (n 4096, h
4096, V 32000; ``chip_smoke.py``'s ``ce_inputs`` and CUDA-graph
``time_ms``) once in a fresh process per checkout, in turns: the others,
this one, this one again, the others in reverse (each builds its own
kernels into its own ``build/``).

``--reduce`` first builds ``tools/fused_ce_reduce_bench.cu`` and prints the
rate at which CTAs add [64 x 256] fp32 tiles into planes of row stride 4096
floats (dx's plane at h 4096), by three means (``red.global.add.v4.f32``
from registers, one bulk reduce-add per tile row from shared memory,
``red.global.add.v2.f32``), into a 2 MB plane (L2-resident), a 64 MB one (dx's plane)
and a 512 MB one (dW's). ``--profile`` then splits one call of each of this
checkout's dx and dW wrappers, by torch.profiler, into the device time of
each kernel it launches (the plane's zeroing, the kernel, the rounding).
Prints the card's name and power limit first, and one JSON object per
measurement.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from deepspeed_tpu_torch.ops import kernels as K
from deepspeed_tpu_torch.ops import fused_ce as C
names = ("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw")
K.build([K.KERNELS[n] for n in names])
dev = torch.device("cuda", 0)
n = h = 4096; V = 32000
x, w, labels, g = chip_smoke.ce_inputs(torch, dev, n, h, V, seed=30)
_, lse = C.fused_ce_fwd_cuda(x, w, labels)
rdx, rdw = C.fused_ce_bwd_reference(x, w, labels, lse, g)
err = {"fused_ce_dx": float((C.fused_ce_dx_cuda(x, w, labels, lse, g).float() - rdx.float()).abs().max()),
       "fused_ce_dw": float((C.fused_ce_dw_cuda(x, w, labels, lse, g).float() - rdw.float()).abs().max())}
del rdx, rdw
ms = {"fused_ce_fwd": chip_smoke.time_ms(torch, lambda: C.fused_ce_fwd_cuda(x, w, labels), iters=5),
      "fused_ce_dx": chip_smoke.time_ms(torch, lambda: C.fused_ce_dx_cuda(x, w, labels, lse, g), iters=5),
      "fused_ce_dw": chip_smoke.time_ms(torch, lambda: C.fused_ce_dw_cuda(x, w, labels, lse, g), iters=5)}
flops = {"fused_ce_fwd": 2 * n * h * V, "fused_ce_dx": 4 * n * h * V, "fused_ce_dw": 4 * n * h * V}
print(json.dumps({"root": sys.argv[1], "ms": ms, "max_abs_err": err,
                  "tflops_per_s": {k: flops[k] / (ms[k] * 1e-3) / 1e12 for k in ms}}))
"""

REDUCE_MODES = {0: "red.global.add.v4.f32", 1: "cp.reduce.async.bulk add.f32 per row",
                2: "red.global.add.v2.f32"}


def reduce_rates(torch, root, out_dir):
    """GB/s of fp32 values added into planes of three sizes by each mode."""
    from deepspeed_tpu_torch.ops.kernels import nvcc_path

    src = Path(root) / "tools" / "fused_ce_reduce_bench.cu"
    lib_path = Path(out_dir) / "libreduce_bench.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.reduce_bench
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stride, row_floats, rows_per_tile, iters = 4096, 256, 64, 64
    ctas = torch.cuda.get_device_properties(0).multi_processor_count * 8
    out = []
    for mb in (2, 64, 512):
        plane_rows = mb * 2 ** 20 // (4 * stride)
        plane = torch.zeros((plane_rows, stride), device="cuda", dtype=torch.float32)
        stream = torch.cuda.current_stream().cuda_stream
        for mode, name in REDUCE_MODES.items():
            def run():
                rc = fn(plane.data_ptr(), plane_rows, stride, row_floats, mode, ctas, iters, stream)
                if rc:
                    raise RuntimeError(f"reduce_bench mode {mode}: CUDA error {rc}")
            run()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                run()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 3
            added = ctas * iters * rows_per_tile * row_floats * 4
            out.append({"plane_mb": mb, "mode": name, "bytes_added": added, "ms": ms,
                        "gb_per_s": added / (ms * 1e-3) / 1e9})
        del plane
        torch.cuda.empty_cache()
    return out


def profile_calls(torch):
    """chip_smoke.device_profile over one call of each backward wrapper at the
    train step's shape, after a warm-up call."""
    import chip_smoke
    from deepspeed_tpu_torch.ops import fused_ce as C

    dev = torch.device("cuda", 0)
    x, w, labels, g = chip_smoke.ce_inputs(torch, dev, 4096, 4096, 32000, seed=30)
    _, lse = C.fused_ce_fwd_cuda(x, w, labels)
    calls = {"fused_ce_dx": lambda: C.fused_ce_dx_cuda(x, w, labels, lse, g),
             "fused_ce_dw": lambda: C.fused_ce_dw_cuda(x, w, labels, lse, g)}
    for fn in calls.values():
        fn()
    return chip_smoke.device_profile(torch, calls)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="*", help="roots of the other checkouts")
    ap.add_argument("--rounds", type=int, default=1,
                    help="each round runs the others, this twice, the others in reverse")
    ap.add_argument("--reduce", action="store_true", help="measure the reduction rates first")
    ap.add_argument("--profile", action="store_true",
                    help="device time of each kernel of one dx and one dW call")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_fused_ce_ab: no CUDA device", file=sys.stderr)
        return 2
    this = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, this)
    others = [str(Path(o).resolve()) for o in args.others]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    if args.reduce:
        for rec in reduce_rates(torch, this, Path(this) / "build" / "tools"):
            print(json.dumps(rec), flush=True)
    if args.profile:
        print(json.dumps({"profile": profile_calls(torch)}), flush=True)
    ms = {root: [] for root in [this] + others}
    for _ in range(args.rounds):
        for root in others + [this, this] + others[::-1]:
            out = subprocess.run([sys.executable, "-c", CHILD, root], cwd=root,
                                 capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                print(out.stderr[-4000:], file=sys.stderr)
                return 1
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(rec), flush=True)
            ms[root].append(rec["ms"])
    print(json.dumps({"card": card, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
