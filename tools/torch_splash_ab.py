#!/usr/bin/env python3
"""The port's splash kernels of several checkouts, timed in turns on one
card, beside the flash kernels with the same window, and the train step
they run in.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_splash_ab.py [OTHER_ROOT ...] [--rounds 1] [--train] [--profile]
        [--per-row]

Each OTHER_ROOT is another checkout of the repo (e.g. the parent commit
unpacked with ``git archive``). Each round times, once in a fresh process
per checkout, in turns (the others, this one, this one again, the others in
reverse; each builds its own kernels into its own ``build/``):
``splash_fwd``, ``splash_bwd_dq`` and ``splash_bwd_dkv`` at ``chip_smoke.py``'s
timed splash shape (b 1, 32/8 heads, s 16384, a LocalMask of 4096 in
512-blocks: Mistral-7B's window) and ``flash_fwd``, ``flash_bwd_dq`` and
``flash_bwd_dkv`` with the same causal window on the same inputs (splash's
out and lse feed both backward kernels), at head dims 128 and 256. Each
checkout's splash out, lse, dq, dk and dv are compared with its flash
kernels' on the same inputs (``splash_equals_flash``: as values), and its
flash kernels' outputs are digested (this checkout's
``chip_smoke.flash_digests``; the summary says whether every checkout's
digests are the same). CUDA-graph ``time_ms``; TFLOP/s over the kept
pairs.

``--train`` then runs, in turns as above, the ``train_splash`` timed leg
(Mistral-7B width, 8 layers, seq 16384, ``attention_impl="splash"``, remat):
``initialize`` -> 1 warm-up and 3 timed ``train_batch`` steps (step
seconds); with ``--profile`` one more step under torch.profiler
(``chip_smoke.device_profile``: wall and device ms, the idle share, the
splash kernels summed by name). ``--per-row`` then runs, in turns as
above, ``chip_smoke.engine_per_row_phase`` (Mistral-7B width, 32 layers,
``_step_per_row`` with the splash prefill over 4 prompts of 6144-8176
tokens): prefill seconds and tokens per second. Prints the card's name and
power limit first, one JSON object per process and a summary by checkout.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import importlib.util, json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as C
from deepspeed_tpu_torch.ops import kernels as K
from deepspeed_tpu_torch.ops.attention import flash as F
from deepspeed_tpu_torch.ops.sparse_attention import LocalMask, schedule_from_mask
from deepspeed_tpu_torch.ops.sparse_attention import splash as SP
# this tool's chip_smoke (its flash_digests) over the checkout's flash kernels
spec = importlib.util.spec_from_file_location("chip_smoke_tool", sys.argv[2])
H = importlib.util.module_from_spec(spec)
spec.loader.exec_module(H)
K.build([K.KERNELS[n] for n in ("splash_fwd", "splash_bwd_dq", "flash_fwd", "flash_bwd_dq")])
dev = torch.device("cuda", 0)
t = C.SPLASH_TIMED
s, w = t["s"], t["window"]
sched = schedule_from_mask(LocalMask((s, s), w), t["block"])
ms, tflops, equal = {}, {}, {}
for d in (128, 256):
    q, k, v, do = C.flash_inputs(torch, dev, 1, 32, 8, s, d, seed=71)
    out, lse = SP.splash_fwd_cuda(q, k, v, sched)
    kw = dict(causal=True, window=w)
    fout, flse = F.flash_fwd_cuda(q, k, v, **kw)
    got = {"out": out, "lse": lse, "dq": SP.splash_bwd_dq_cuda(q, k, v, out, do, lse, sched)}
    want = {"out": fout, "lse": flse, "dq": F.flash_bwd_dq_cuda(q, k, v, out, do, lse, **kw)}
    got["dk"], got["dv"] = SP.splash_bwd_dkv_cuda(q, k, v, out, do, lse, sched)
    want["dk"], want["dv"] = F.flash_bwd_dkv_cuda(q, k, v, out, do, lse, **kw)
    equal[f"d{d}"] = {name: bool(torch.equal(got[name], want[name])) for name in got}
    del fout, flse, got, want
    pairs, flops, _ = C.splash_work(sched, 1, 32, 8, d)
    fns = {"splash_fwd": (lambda: SP.splash_fwd_cuda(q, k, v, sched), 4),
           "splash_bwd_dq": (lambda: SP.splash_bwd_dq_cuda(q, k, v, out, do, lse, sched), 6),
           "splash_bwd_dkv": (lambda: SP.splash_bwd_dkv_cuda(q, k, v, out, do, lse, sched), 8),
           "flash_fwd": (lambda: F.flash_fwd_cuda(q, k, v, **kw), 4),
           "flash_bwd_dq": (lambda: F.flash_bwd_dq_cuda(q, k, v, out, do, lse, **kw), 6),
           "flash_bwd_dkv": (lambda: F.flash_bwd_dkv_cuda(q, k, v, out, do, lse, **kw), 8)}
    for name, (fn, per_pair) in fns.items():
        key = f"{name}_d{d}"
        ms[key] = C.time_ms(torch, fn, iters=10)
        tflops[key] = per_pair * pairs * d / (ms[key] * 1e-3) / 1e12
    del q, k, v, do, out, lse
    torch.cuda.empty_cache()
print(json.dumps({"root": sys.argv[1], "ms": ms, "tflops_per_s": tflops,
                  "splash_equals_flash": equal,
                  "flash_digests": H.flash_digests(torch, dev, F)}))
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
profile = sys.argv[2] == "1"
seq = C.SPLASH_TIMED_SEQ
cfg = T.get_config(C.MODEL, n_layers=C.TRAIN_LAYERS, dtype="bfloat16", attention_impl="splash",
                   remat=True, remat_policy="nothing")
params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(C.SEED + 1), dev)
rng = np.random.default_rng(C.SEED)
gas = C.TRAIN_CONFIG["gradient_accumulation_steps"]
batches = [{"input_ids": torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(gas, seq + 1)),
                                         device=dev)} for _ in range(5)]
eng, *_ = deepspeed_tpu_torch.initialize(model=T.make_loss_fn(cfg), model_parameters=params,
                                         config=dict(C.TRAIN_CONFIG))
del params
step_s, losses = [], []
for b in batches[:4]:
    t0 = time.perf_counter()
    losses.append(float(eng.train_batch(batch=b)))
    torch.cuda.synchronize()
    step_s.append(time.perf_counter() - t0)
rec = {"root": sys.argv[1], "window": cfg.sliding_window, "seq": seq, "layers": C.TRAIN_LAYERS,
       "step_seconds": step_s, "mean_step_seconds": sum(step_s[1:]) / 3, "losses": losses}
if profile:
    sums = ("splash_fwd_kernel", "splash_dq_kernel", "splash_dkv_kernel")
    rec["profile"] = C.device_profile(
        torch, {"train_splash_step": lambda: float(eng.train_batch(batch=batches[4]))},
        sums=sums)["train_splash_step"]
print(json.dumps(rec))
"""


PER_ROW_CHILD = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as C
from deepspeed_tpu_torch.ops import kernels as K
K.build()
rec, launches = C.engine_per_row_phase(torch, torch.device("cuda", 0), K)
print(json.dumps({"root": sys.argv[1], "launches": launches, **{
    key: rec[key] for key in ("prefill_seconds", "prefill_tok_s", "seconds_main_path", "row_steps",
                              "blocks_visited", "logit_rel_err")}}))
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
    ap.add_argument("--train", action="store_true",
                    help="then time the train_splash step of each checkout in turns")
    ap.add_argument("--profile", action="store_true",
                    help="with --train: one more step of each under torch.profiler")
    ap.add_argument("--per-row", action="store_true",
                    help="then time the engine_per_row leg of each checkout in turns")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_splash_ab: no CUDA device", file=sys.stderr)
        return 2
    this = str(Path(__file__).resolve().parents[1])
    others = [str(Path(o).resolve()) for o in args.others]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    order = others + [this, this] + others[::-1]
    ms = {root: [] for root in [this] + others}
    tool_smoke = str(Path(this) / "chip_smoke.py")
    equal, digests = {}, {}
    for _ in range(args.rounds):
        for root in order:
            rec = run_child(CHILD, root, 900, tool_smoke)
            ms[root].append(rec["ms"])
            equal[root], digests[root] = rec["splash_equals_flash"], rec["flash_digests"]
    summary = {"card": card, "ms": ms, "splash_equals_flash": equal,
               "flash_digests_equal_across_checkouts": len(
                   {json.dumps(d, sort_keys=True) for d in digests.values()}) == 1}
    if args.train:
        steps = {root: [] for root in [this] + others}
        for _ in range(args.rounds):
            for root in order:
                rec = run_child(TRAIN_CHILD, root, 1200, "1" if args.profile else "0")
                steps[root].append(rec["mean_step_seconds"])
        summary["train_splash_mean_step_seconds"] = steps
    if args.per_row:
        prefill = {root: [] for root in [this] + others}
        for _ in range(args.rounds):
            for root in order:
                prefill[root].append(run_child(PER_ROW_CHILD, root, 1200)["prefill_seconds"])
        summary["engine_per_row_prefill_seconds"] = prefill
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
