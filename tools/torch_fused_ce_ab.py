#!/usr/bin/env python3
"""The port's fused-CE kernels of several checkouts, timed in turns on one
card, the forward's span sweep, and the rate of the reductions the backward
is built on.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_fused_ce_ab.py [OTHER_ROOT ...] [--rounds 1] [--reduce] [--profile]
                                       [--sweep] [--train]

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
checkout's forward, dx and dW wrappers, by torch.profiler, into the device
time of each kernel it launches (the forward: its span kernel and the merge;
dx and dW: the plane's zeroing, the kernel, the rounding). ``--sweep`` times
this checkout's forward at vocabulary spans of 512 to 2048 columns a CTA
(``fused_ce_fwd_cuda(span=)``), and at h 2048, 4096 and 8192 (what a pass costs
beside its products: t(h) = fixed + per-h), each point twice, in turns,
beside the library's ``x @ w`` alone at h 4096 (the logits' GEMM with bf16
output, no reduction). ``--train`` then runs ``chip_smoke.py``'s ``train_fused`` timed leg
(Mistral-7B width, 8 layers, seq 4096, gas 2, ``fused_ce=True``, FusedAdam)
once in a fresh process per checkout, in turns as above: 1 warm-up and 3
timed ``train_batch`` steps (step seconds), then one step under
torch.profiler with the fused-CE kernels' device ms and launches summed
(the forward's kernels under ``ce_fwd``, dx and dW under ``ce_bwd``). Prints the card's name and power limit first, and one JSON object per
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
loss, lse = C.fused_ce_fwd_cuda(x, w, labels)
loss2, lse2 = C.fused_ce_fwd_cuda(x, w, labels)
ref_loss, ref_lse = C.fused_ce_fwd_reference(x, w, labels)
repeats = bool(torch.equal(loss, loss2) and torch.equal(lse, lse2))
rdx, rdw = C.fused_ce_bwd_reference(x, w, labels, lse, g)
err = {"fused_ce_fwd": float(torch.maximum((loss - ref_loss).abs().max(), (lse - ref_lse).abs().max())),
       "fused_ce_dx": float((C.fused_ce_dx_cuda(x, w, labels, lse, g).float() - rdx.float()).abs().max()),
       "fused_ce_dw": float((C.fused_ce_dw_cuda(x, w, labels, lse, g).float() - rdw.float()).abs().max())}
del rdx, rdw
ms = {"fused_ce_fwd": chip_smoke.time_ms(torch, lambda: C.fused_ce_fwd_cuda(x, w, labels), iters=5),
      "fused_ce_dx": chip_smoke.time_ms(torch, lambda: C.fused_ce_dx_cuda(x, w, labels, lse, g), iters=5),
      "fused_ce_dw": chip_smoke.time_ms(torch, lambda: C.fused_ce_dw_cuda(x, w, labels, lse, g), iters=5)}
flops = {"fused_ce_fwd": 2 * n * h * V, "fused_ce_dx": 4 * n * h * V, "fused_ce_dw": 4 * n * h * V}
print(json.dumps({"root": sys.argv[1], "ms": ms, "max_abs_err": err, "fwd_repeats_bits": repeats,
                  "tflops_per_s": {k: flops[k] / (ms[k] * 1e-3) / 1e12 for k in ms}}))
"""

TRAIN_CHILD = r"""
import json, sys, time, torch
import numpy as np
sys.path.insert(0, sys.argv[1])
import chip_smoke as C
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.ops import kernels as K
K.build()
dev = torch.device("cuda", 0)
cfg = T.get_config(C.MODEL, n_layers=C.TRAIN_LAYERS, dtype="bfloat16", fused_ce=True, remat=False)
params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(C.SEED), dev)
rng = np.random.default_rng(C.SEED)
config = dict(C.TRAIN_CONFIG, optimizer=C.FUSED_OPTIMIZER)
gas = config["gradient_accumulation_steps"]
batches = [{"input_ids": torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(gas, C.SEQ + 1)),
                                         device=dev)} for _ in range(5)]
eng, *_ = deepspeed_tpu_torch.initialize(model=T.make_loss_fn(cfg), model_parameters=params,
                                         config=config)
del params
step_s = []
for b in batches[:4]:
    t0 = time.perf_counter()
    float(eng.train_batch(batch=b))
    torch.cuda.synchronize()
    step_s.append(time.perf_counter() - t0)
prof = C.device_profile(torch, {"step": lambda: float(eng.train_batch(batch=batches[4]))},
                        sums=("ce_fwd", "ce_bwd"))["step"]
prof.pop("host_top", None)
print(json.dumps({"root": sys.argv[1], "leg": "train_fused", "step_seconds": step_s,
                  "mean_step_seconds": sum(step_s[1:]) / 3, "profile": prof}))
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
    """chip_smoke.device_profile over one call of each wrapper at the train
    step's shape, after a warm-up call."""
    import chip_smoke
    from deepspeed_tpu_torch.ops import fused_ce as C

    dev = torch.device("cuda", 0)
    x, w, labels, g = chip_smoke.ce_inputs(torch, dev, 4096, 4096, 32000, seed=30)
    _, lse = C.fused_ce_fwd_cuda(x, w, labels)
    calls = {"fused_ce_fwd": lambda: C.fused_ce_fwd_cuda(x, w, labels),
             "fused_ce_dx": lambda: C.fused_ce_dx_cuda(x, w, labels, lse, g),
             "fused_ce_dw": lambda: C.fused_ce_dw_cuda(x, w, labels, lse, g)}
    for fn in calls.values():
        fn()
    return chip_smoke.device_profile(torch, calls)


SWEEP_SPANS = (512, 768, 1024, 1536, 2048)
SWEEP_H = (2048, 4096, 8192)


def sweep_forward(torch):
    """The forward's ms and TFLOP/s at each span (h 4096) and at each h (the
    default span), n 4096, V 32000; every point timed twice, the second
    time in reverse order, and ``x @ w`` between the two. Loss and lse must
    be the same at every span."""
    import chip_smoke
    from deepspeed_tpu_torch.ops import fused_ce as C

    dev = torch.device("cuda", 0)
    n, V = 4096, 32000
    inputs = {hh: chip_smoke.ce_inputs(torch, dev, n, hh, V, seed=30) for hh in SWEEP_H}
    points = [(4096, s) for s in SWEEP_SPANS] + [(hh, C.FWD_SPAN) for hh in SWEEP_H if hh != 4096]
    want = {hh: C.fused_ce_fwd_cuda(*inputs[hh][:3]) for hh in SWEEP_H}
    ms = {p: [] for p in points}
    for i, order in enumerate((points, points[::-1])):
        if i:
            xm, wm = inputs[4096][:2]
            matmul_ms = chip_smoke.time_ms(torch, lambda: xm @ wm, iters=5)
        for hh, span in order:
            x, w, labels, _ = inputs[hh]
            loss, lse = C.fused_ce_fwd_cuda(x, w, labels, span=span)
            if hh == 4096:
                same = bool(torch.allclose(loss, want[hh][0], rtol=0, atol=1e-5)
                            and torch.allclose(lse, want[hh][1], rtol=0, atol=1e-5))
                if not same:
                    raise AssertionError(f"span {span}: loss/lse differ from span {C.FWD_SPAN}")
            ms[(hh, span)].append(chip_smoke.time_ms(
                torch, lambda: C.fused_ce_fwd_cuda(x, w, labels, span=span), iters=5))
    out = [{"h": hh, "span": span, "ctas": -(-n // 128) * -(-V // span), "ms": ms[(hh, span)],
            "tflops_per_s": [2 * n * hh * V / (t * 1e-3) / 1e12 for t in ms[(hh, span)]]}
           for hh, span in points]
    out.append({"h": 4096, "library": "x @ w (bf16 logits, no reduction)", "ms": matmul_ms,
                "tflops_per_s": 2 * n * 4096 * V / (matmul_ms * 1e-3) / 1e12})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="*", help="roots of the other checkouts")
    ap.add_argument("--rounds", type=int, default=1,
                    help="each round runs the others, this twice, the others in reverse")
    ap.add_argument("--reduce", action="store_true", help="measure the reduction rates first")
    ap.add_argument("--profile", action="store_true",
                    help="device time of each kernel of one forward, one dx and one dW call")
    ap.add_argument("--sweep", action="store_true",
                    help="the forward's time at spans of 512-2048 and at h 2048 / 4096 / 8192")
    ap.add_argument("--train", action="store_true",
                    help="then a train_fused leg per checkout, in turns")
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
    if args.sweep:
        for rec in sweep_forward(torch):
            print(json.dumps({"sweep": rec}), flush=True)
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
    if args.train:
        steps = {root: [] for root in [this] + others}
        for root in others + [this, this] + others[::-1]:
            out = subprocess.run([sys.executable, "-c", TRAIN_CHILD, root], cwd=root,
                                 capture_output=True, text=True, timeout=1200)
            if out.returncode != 0:
                print(out.stderr[-4000:], file=sys.stderr)
                return 1
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(rec), flush=True)
            steps[root].append(rec["mean_step_seconds"])
        print(json.dumps({"card": card, "train_fused_mean_step_seconds": steps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
