#!/usr/bin/env python3
"""The port's flash kernels of several checkouts, timed in turns on one
card, and the train steps they run in.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_flash_ab.py [OTHER_ROOT ...] [--rounds 1] [--profile]

Each OTHER_ROOT is another checkout of the repo (e.g. the parent commit
unpacked with ``git archive``). Each round times, once in a fresh process
per checkout, in turns (the others, this one, this one again, the others in
reverse; each builds its own kernels into its own ``build/``):
``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` at ``chip_smoke.py``'s
train shape (b 1, 32/8 heads of 128, s 4096, causal, window 4096) and at
head dims 64 and 256 (same heads and mask), and ``flash_fwd_chunk``,
``flash_dq_chunk`` and ``flash_dkv_chunk`` at the non-diagonal hop of 4096
with the carry loaded and stored (``chip_smoke.py``'s inputs and CUDA-graph
``time_ms``); each kernel's first output is held against its plain version
(max abs err printed; the carries relative to their largest element).

``--profile`` then runs, in one fresh process per checkout (this one, then
the others), the ``train_fused`` timed leg (Mistral-7B width, 8 layers, seq
4096, ``fused_ce=True``, FusedAdam) and the ``train_ring`` timed leg
(llama-7b width, 8 layers, seq 16384 in 4 loopback context chunks, remat):
``initialize`` -> 1 warm-up and 3 timed ``train_batch`` steps each (step
seconds), then one more step under torch.profiler (``chip_smoke.
device_profile``: wall and device ms, the idle share, the device time of
each kernel, the flash kernels summed by name, and the flash backward's
ms and share of the step's device time). Prints the card's name and power
limit first, and one JSON object per measurement.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as C
from deepspeed_tpu_torch.ops import kernels as K
from deepspeed_tpu_torch.ops.attention import flash as F
K.build([K.KERNELS[n] for n in ("flash_fwd", "flash_bwd_dq", "flash_fwd_chunk")])
dev = torch.device("cuda", 0)
ms, err, tflops = {}, {}, {}

def rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())

for d in (128, 64, 256):
    q, k, v, do = C.flash_inputs(torch, dev, 1, 32, 8, 4096, d, seed=10)
    kw = dict(causal=True, window=4096)
    out, lse = F.flash_fwd_cuda(q, k, v, **kw)
    ref_out, ref_lse = F.flash_fwd_reference(q, k, v, **kw)
    err[f"flash_fwd_d{d}"] = max(float((out.float() - ref_out.float()).abs().max()),
                                 float((lse - ref_lse).abs().max()))
    del ref_out, ref_lse
    dq = F.flash_bwd_dq_cuda(q, k, v, out, do, lse, **kw)
    dk, dv = F.flash_bwd_dkv_cuda(q, k, v, out, do, lse, **kw)
    rdq, rdk, rdv = F.flash_bwd_reference(q, k, v, out, do, lse, **kw)
    err[f"flash_bwd_dq_d{d}"] = rel(dq, rdq)
    err[f"flash_bwd_dkv_d{d}"] = max(rel(dk, rdk), rel(dv, rdv))
    del dq, dk, dv, rdq, rdk, rdv
    torch.cuda.empty_cache()
    pairs = 32 * C.flash_pairs(4096, True, 4096, None, None)
    for name, fn, per_pair in (
            ("flash_fwd", lambda: F.flash_fwd_cuda(q, k, v, **kw), 4),
            ("flash_bwd_dq", lambda: F.flash_bwd_dq_cuda(q, k, v, out, do, lse, **kw), 6),
            ("flash_bwd_dkv", lambda: F.flash_bwd_dkv_cuda(q, k, v, out, do, lse, **kw), 8)):
        key = f"{name}_d{d}"
        ms[key] = C.time_ms(torch, fn, iters=10)
        tflops[key] = per_pair * pairs * d / (ms[key] * 1e-3) / 1e12
    del q, k, v, do, out, lse
    torch.cuda.empty_cache()
q, k, v, do = C.flash_inputs(torch, dev, 1, 32, 8, 4096, 128, seed=40)
c0 = F.flash_carry_init(1, 32, 4096, 128, dev)
got = F.flash_fwd_chunk_cuda(q, k, v, tuple(t.clone() for t in c0))
err["flash_fwd_chunk"] = rel(got[2], F.flash_fwd_chunk_reference(q, k, v, c0)[2])
out, lse = F.flash_fwd_reference(q, k, v, causal=False)
zq = torch.zeros(q.shape, device=dev)
zk = torch.zeros(k.shape, device=dev)
got = F.flash_dq_chunk_cuda(q, k, v, out, do, lse, zq.clone())
err["flash_dq_chunk"] = rel(got, F.flash_dq_chunk_reference(q, k, v, out, do, lse, zq))
got = F.flash_dkv_chunk_cuda(q, k, v, out, do, lse, (zk.clone(), zk.clone()))
want = F.flash_dkv_chunk_reference(q, k, v, out, do, lse, zk, zk)
err["flash_dkv_chunk"] = max(rel(got[0], want[0]), rel(got[1], want[1]))
del got, want
carry = F.flash_fwd_chunk_cuda(q, k, v)
dq_acc = F.flash_dq_chunk_cuda(q, k, v, out, do, lse)
dkv = F.flash_dkv_chunk_cuda(q, k, v, out, do, lse)
for name, fn, per_pair in (
        ("flash_fwd_chunk", lambda: F.flash_fwd_chunk_cuda(q, k, v, carry), 4),
        ("flash_dq_chunk", lambda: F.flash_dq_chunk_cuda(q, k, v, out, do, lse, dq_acc), 6),
        ("flash_dkv_chunk", lambda: F.flash_dkv_chunk_cuda(q, k, v, out, do, lse, dkv), 8)):
    ms[name] = C.time_ms(torch, fn, iters=10)
    tflops[name] = per_pair * 32 * 4096 * 4096 * 128 / (ms[name] * 1e-3) / 1e12
print(json.dumps({"root": sys.argv[1], "ms": ms, "tflops_per_s": tflops, "max_abs_err": err,
                  "max_abs_err_note": "backward and chunks: relative to the largest element"}))
"""

PROFILE_CHILD = r"""
import json, sys, time, torch
import numpy as np
sys.path.insert(0, sys.argv[1])
import chip_smoke as C
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.ops import kernels as K
from deepspeed_tpu_torch.parallel.topology import Topology, reset_topology
K.build()
dev = torch.device("cuda", 0)
SUMS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel", "flash_fwd_chunk_kernel",
        "flash_dq_chunk_kernel", "flash_dkv_chunk_kernel")

def leg(name, model, seq, over, config, mpu=None):
    cfg = T.get_config(model, n_layers=C.TRAIN_LAYERS, dtype="bfloat16", **over)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(C.SEED), dev)
    rng = np.random.default_rng(C.SEED)
    gas = config["gradient_accumulation_steps"]
    batches = [{"input_ids": torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(gas, seq + 1)),
                                             device=dev)} for _ in range(5)]
    try:  # initialize sets the topology of an mpu
        eng, *_ = deepspeed_tpu_torch.initialize(model=T.make_loss_fn(cfg), model_parameters=params,
                                                 config=config, mpu=mpu)
        del params
        step_s = []
        for b in batches[:4]:
            t0 = time.perf_counter()
            float(eng.train_batch(batch=b))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        prof = C.device_profile(torch, {name + "_step": lambda: float(eng.train_batch(batch=batches[4]))},
                                sums=SUMS)[name + "_step"]
        bwd = sum(v["ms"] for k, v in prof["sums"].items() if "_dq_" in k or "_dkv_" in k)
        prof["flash_bwd_ms"] = bwd
        prof["flash_bwd_share_of_device"] = bwd / prof["device_busy_ms"]
    finally:
        if mpu is not None:
            reset_topology()
    del eng
    torch.cuda.empty_cache()
    timed = step_s[1:]
    return {"leg": name, "step_seconds": step_s, "mean_step_seconds": sum(timed) / len(timed),
            "profile": prof}

fused_config = dict(C.TRAIN_CONFIG, optimizer=C.FUSED_OPTIMIZER)
out = [leg("train_fused", C.MODEL, C.SEQ, {"fused_ce": True, "remat": False}, fused_config)]
out.append(leg("train_ring", C.RING_MODEL, C.RING_TRAIN_SEQ,
               {"attention_impl": "flash_ring", "remat": True, "remat_policy": "nothing",
                "max_seq_len": C.RING_TRAIN_SEQ}, dict(C.TRAIN_CONFIG),
               mpu=Topology(context=C.RING_N, loopback=True)))
print(json.dumps({"root": sys.argv[1], "legs": out}))
"""


def run_child(code, root, timeout):
    out = subprocess.run([sys.executable, "-c", code, root], cwd=root, capture_output=True,
                         text=True, timeout=timeout)
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
        raise SystemExit(1)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="*", help="roots of the other checkouts")
    ap.add_argument("--rounds", type=int, default=1,
                    help="each round runs the others, this twice, the others in reverse")
    ap.add_argument("--profile", action="store_true",
                    help="then time and profile a train_fused and a train_ring step per checkout")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 2
    this = str(Path(__file__).resolve().parents[1])
    others = [str(Path(o).resolve()) for o in args.others]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    ms = {root: [] for root in [this] + others}
    for _ in range(args.rounds):
        for root in others + [this, this] + others[::-1]:
            rec = run_child(CHILD, root, 900)
            print(json.dumps(rec), flush=True)
            ms[root].append(rec["ms"])
    print(json.dumps({"card": card, "ms": ms}), flush=True)
    if args.profile:
        for root in [this] + others:
            rec = run_child(PROFILE_CHILD, root, 1800)
            rec["card"] = card
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
