#!/usr/bin/env python3
"""The port's layout-predicate sparse kernels of several checkouts, timed
in turns on one card, and the ``SparseSelfAttention`` call they run in.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_sparse_ab.py [OTHER_ROOT ...] [--rounds 1] [--profile]

Each OTHER_ROOT is another checkout of the repo (e.g. the parent commit
unpacked with ``git archive``). Each round runs, once in a fresh process per
checkout, in turns (the others, this one, this one again, the others in
reverse; each builds its own kernels into its own ``build/``):
``sparse_fwd``, ``sparse_bwd_dq`` and ``sparse_bwd_dkv`` at
``chip_smoke.py``'s timed sparse shape (b 1, 32 heads, s 16384, Fixed(128,
4 local, 1 global, unidirectional), causal) at head dims 128 and 256, with
the causal flash kernels on the same inputs (the dense work the layout
prunes); CUDA-graph ``time_ms``, TFLOP/s over the kept pairs. Then the
op-registry call ``SparseSelfAttention(Fixed(...), use_splash=False)`` at
Mistral-7B's attention (32 query heads over 8 kv heads, 128 wide), forward
and backward: seconds a call (host clock to a synchronize, the mean of 5
after a warm-up). With ``--profile`` one more call under torch.profiler
(``chip_smoke.device_profile``: wall and device ms, the idle share, the
sparse kernels by name), and, where the checkout's dk/dv wrapper has the
``cta_clock`` hook, the dk/dv grid's tail at d 128: each CTA's start, end
and SM from the card's global timer, the share of SM time idle after each
SM's last CTA, and the grid's span against its longest CTA. Prints the
card's name and power limit first, one JSON object per process and a
summary by checkout.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import inspect, json, sys, time, torch
import numpy as np
sys.path.insert(0, sys.argv[1])
import chip_smoke as C
from deepspeed_tpu_torch import get_accelerator
from deepspeed_tpu_torch.ops import kernels as K
from deepspeed_tpu_torch.ops.attention import flash as F
from deepspeed_tpu_torch.ops.sparse_attention import sparse as SA
K.build([K.KERNELS[n] for n in ("sparse_fwd", "sparse_bwd_dq", "flash_fwd", "flash_bwd_dq")])
dev = torch.device("cuda", 0)
profile = sys.argv[2] == "1"
t = C.SPARSE_TIMED
s, block = t["s"], t["block"]
layout = C.sparse_fixed(32).make_layout(s)
lay = torch.as_tensor(layout, dtype=torch.int32, device=dev)
ms, tflops, tail = {}, {}, None
for d in (128, 256):
    q, k, v, do = C.flash_inputs(torch, dev, 1, 32, 32, s, d, seed=90)
    out, lse = SA.sparse_fwd_cuda(q, k, v, lay, block, True)
    args = (q, k, v, out, do, lse, lay, block, True)
    fout, flse = F.flash_fwd_cuda(q, k, v, causal=True)
    _, flops, _ = C.sparse_work(layout, block, True, 1, 32, s, d)
    fns = {"sparse_fwd": lambda: SA.sparse_fwd_cuda(q, k, v, lay, block, True),
           "sparse_bwd_dq": lambda: SA.sparse_bwd_dq_cuda(*args),
           "sparse_bwd_dkv": lambda: SA.sparse_bwd_dkv_cuda(*args),
           "flash_fwd_causal": lambda: F.flash_fwd_cuda(q, k, v, causal=True),
           "flash_bwd_dq_causal": lambda: F.flash_bwd_dq_cuda(q, k, v, fout, do, flse,
                                                              causal=True),
           "flash_bwd_dkv_causal": lambda: F.flash_bwd_dkv_cuda(q, k, v, fout, do, flse,
                                                                causal=True)}
    for name, fn in fns.items():
        key = f"{name}_d{d}"
        ms[key] = C.time_ms(torch, fn, iters=10)
        if name in flops:
            tflops[key] = flops[name] / (ms[key] * 1e-3) / 1e12
    if profile and d == 128 and "cta_clock" in inspect.signature(
            SA.sparse_bwd_dkv_cuda).parameters:
        n = SA.dkv_ctas(1, 32, s, d)
        clk = torch.zeros(n, 3, dtype=torch.int64, device=dev)
        SA.sparse_bwd_dkv_cuda(*args, cta_clock=clk)
        torch.cuda.synchronize()
        c = clk.cpu().numpy()
        start, end, sm = c[:, 0], c[:, 1], c[:, 2]
        t0, t1 = int(start.min()), int(end.max())
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        last = np.full(n_sm, t0, np.int64)
        np.maximum.at(last, sm, end)
        span = t1 - t0
        dur = end - start
        tail = {"ctas": n, "sms": n_sm, "span_ms": span / 1e6,
                "tail_idle_share": float((t1 - last).sum() / (n_sm * span)),
                "idle_share": float(1 - dur.sum() / (n_sm * span)),
                "longest_cta_ms": float(dur.max() / 1e6),
                "last_start_ms_before_end": float((t1 - start.max()) / 1e6),
                "cta_ms_by_key_tile": [float(x) for x in
                                       (dur.reshape(-1, 32).mean(axis=1) / 1e6)[:8]]}
    del q, k, v, do, out, lse, fout, flse
    torch.cuda.empty_cache()
sa = get_accelerator().create_op_builder("sparse_attn").load(verbose=False)
attn = sa.SparseSelfAttention(sa.FixedSparsityConfig(
    num_heads=32, block=block, num_local_blocks=t["num_local_blocks"],
    num_global_blocks=t["num_global_blocks"], attention="unidirectional"), use_splash=False)
gen = torch.Generator(device=dev).manual_seed(C.SEED)
shapes = ((1, 32, s, 128), (1, 8, s, 128), (1, 8, s, 128))
leaves = [torch.randn(*sh, generator=gen, device=dev).bfloat16().requires_grad_(True)
          for sh in shapes]
do = torch.randn(1, 32, s, 128, generator=gen, device=dev).bfloat16()

def call():
    for x in leaves:
        x.grad = None
    attn(*leaves).backward(do)

call()
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(5):
    call()
torch.cuda.synchronize()
rec = {"root": sys.argv[1], "ms": ms, "tflops_per_s": tflops,
       "call_s": (time.perf_counter() - t0) / 5}
if profile:
    rec["call_profile"] = C.device_profile(
        torch, {"sparse_attn_call": call},
        sums=("sparse_fwd_kernel", "sparse_dq_kernel", "sparse_dkv_kernel"))["sparse_attn_call"]
    rec["dkv_tail"] = tail
print(json.dumps(rec))
"""


def run_child(code, root, timeout, *extra):
    out = subprocess.run([sys.executable, "-c", code, root, *extra], cwd=root,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
        raise SystemExit(1)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="*", help="roots of the other checkouts")
    ap.add_argument("--rounds", type=int, default=1,
                    help="each round runs the others, this twice, the others in reverse")
    ap.add_argument("--profile", action="store_true",
                    help="the call under torch.profiler, and the dk/dv grid's tail")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_sparse_ab: no CUDA device", file=sys.stderr)
        return 2
    this = str(Path(__file__).resolve().parents[1])
    others = [str(Path(o).resolve()) for o in args.others]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    order = others + [this, this] + others[::-1]
    ms = {root: [] for root in [this] + others}
    call_s = {root: [] for root in [this] + others}
    for _ in range(args.rounds):
        for root in order:
            rec = run_child(CHILD, root, 900, "1" if args.profile else "0")
            ms[root].append(rec["ms"])
            call_s[root].append(rec["call_s"])
    print(json.dumps({"card": card, "ms": ms, "call_s": call_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
