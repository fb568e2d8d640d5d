#!/usr/bin/env python3
"""The port's evoformer kernels of several checkouts, timed in turns on one card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_evoformer_ab.py [OTHER_ROOT ...] [--rounds 1] [--fwd] [--call] [--sweep]

Each OTHER_ROOT is another checkout of the repo (e.g. the parent commit
unpacked with ``git archive``). Each round runs, once in a fresh process per
checkout, in turns (the others, this one, this one again, the others in
reverse; each builds its own kernels into its own ``build/``):

  * by default ``chip_smoke.py``'s ``evoformer_timings`` (the kernels held
    against their plain versions at the evoformer phase's msa_row shape, then
    CUDA-graph times in bf16 and fp32, beside their bounds);
  * with ``--fwd`` instead the forward kernel alone at msa_row and
    triangle (``evo_inputs``: AlphaFold's mask and a pair bias) in bf16 and
    fp32, CUDA-graph times beside SDPA's forward with the summed mask on
    the same inputs (bf16; memory-efficient backend) in the same process,
    and a digest of out and lse;
  * with ``--call`` instead the op call a user makes: ``DS4Sci_EvoformerAttention``
    forward + backward at msa_row and triangle in bf16, AlphaFold's mask and a
    pair bias both needing gradients (``evo_inputs``), its time (CUDA events
    around eager calls, host work included), its peak device memory above
    its inputs, and a digest of the forward kernel's out and lse on those
    inputs (the summary says whether the checkouts' forwards give the same
    bits). This compares like with like across checkouts whatever their
    backward kernels' signatures (the parent's dq writes the dS plane).

``--sweep`` (this checkout only, after the turns) times the backward kernels
at msa_row in the reduced form over the batch rows a CTA walks (G, which
``evoformer_attn.rows_per_cta`` picks for a call; the sweep sets it in its
own process). Prints the card's name and power limit, then one JSON object
per process and a summary by checkout.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from deepspeed_tpu_torch.ops import kernels as K
K.build([K.KERNELS[n] for n in chip_smoke.EVOFORMER_KERNELS])
dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
errs = {n: {} for n in chip_smoke.EVOFORMER_KERNELS}
tiles = {n: {} for n in chip_smoke.EVOFORMER_KERNELS}
rec = chip_smoke.evoformer_timings(torch, dev, errs, tiles)
print(json.dumps({"root": sys.argv[1], "timings": rec,
                  "max_abs_err": {n: max(e.values()) for n, e in errs.items()}}))
"""

CALL_CHILD = r"""
import hashlib, json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from deepspeed_tpu_torch.ops import kernels as K
from deepspeed_tpu_torch.ops.deepspeed4science import DS4Sci_EvoformerAttention as evo
from deepspeed_tpu_torch.ops.deepspeed4science import evoformer_attn as E
K.build([K.KERNELS[n] for n in chip_smoke.EVOFORMER_KERNELS])
dev = torch.device("cuda", 0)
res = {}
for name, sh in chip_smoke.EVOFORMER_SHAPES.items():
    q, k, v, do, b1, b2 = chip_smoke.evo_inputs(torch, dev, sh["n"], sh["s"], sh["h"], sh["d"],
                                                torch.bfloat16, 300)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, b1, b2)]

    def call():
        for t in leaves:
            t.grad = None
        evo(*leaves[:3], leaves[3:]).backward(do)

    call()
    for t in leaves:
        t.grad = None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    call()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    n, s, h, d = sh["n"], sh["s"], sh["h"], sh["d"]
    ops = E._operands([b1, b2], (1, n), h, s)
    out, lse = E.evoformer_fwd_cuda(*(t.reshape(n, s, h, d) for t in (q, k, v)), ops)
    digest = hashlib.sha256(out.contiguous().view(torch.int16).cpu().numpy().tobytes()
                            + lse.cpu().numpy().tobytes()).hexdigest()
    res[name] = {"call_ms": chip_smoke.eager_ms(torch, call, iters=10),
                 "peak_over_inputs_gb": peak, "fwd_sha256": digest}
    del ops, out, lse
    del q, k, v, do, b1, b2, leaves
    torch.cuda.empty_cache()
print(json.dumps({"root": sys.argv[1], "call": res}))
"""

FWD_CHILD = r"""
import hashlib, json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from deepspeed_tpu_torch.ops import kernels as K
from deepspeed_tpu_torch.ops.deepspeed4science import evoformer_attn as E
from torch.nn.attention import SDPBackend, sdpa_kernel
K.build([K.KERNELS["evoformer_fwd"]])
dev = torch.device("cuda", 0)
res = {}
for name, sh in chip_smoke.EVOFORMER_SHAPES.items():
    n, s, h, d = sh["n"], sh["s"], sh["h"], sh["d"]
    for dtype in (torch.bfloat16, torch.float32):
        tag = f"{name}_{'bf16' if dtype == torch.bfloat16 else 'fp32'}"
        q, k, v, do, b1, b2 = chip_smoke.evo_inputs(torch, dev, n, s, h, d, dtype, 300)
        q, k, v = (t.reshape(n, s, h, d) for t in (q, k, v))
        ops = E._operands([b1, b2], (1, n), h, s)
        out, lse = E.evoformer_fwd_cuda(q, k, v, ops)
        r = {"ms": chip_smoke.time_ms(torch, lambda: E.evoformer_fwd_cuda(q, k, v, ops),
                                      iters=10),
             "sha256": hashlib.sha256(out.contiguous().view(torch.int8).cpu().numpy().tobytes()
                                      + lse.cpu().numpy().tobytes()).hexdigest()}
        if dtype == torch.bfloat16:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            mask = (b1[0] + b2[0]).to(dtype).expand(n, h, s, s).contiguous()

            def sdpa():
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                                            attn_mask=mask)

            r["sdpa_ms"] = chip_smoke.time_ms(torch, sdpa, iters=10)
            del mask
        res[tag] = r
        del q, k, v, do, b1, b2, ops, out, lse
        torch.cuda.empty_cache()
print(json.dumps({"root": sys.argv[1], "fwd": res}))
"""

SWEEP_CHILD = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from deepspeed_tpu_torch.ops import kernels as K
from deepspeed_tpu_torch.ops.deepspeed4science import evoformer_attn as E
K.build([K.KERNELS[n] for n in chip_smoke.EVOFORMER_KERNELS])
dev = torch.device("cuda", 0)
sh = chip_smoke.EVOFORMER_SHAPES["msa_row"]
n, s, h, d = sh["n"], sh["s"], sh["h"], sh["d"]
q, k, v, do, b1, b2 = chip_smoke.evo_inputs(torch, dev, n, s, h, d, torch.bfloat16, 300)
q, k, v, do = (t.reshape(n, s, h, d) for t in (q, k, v, do))
ops = E._operands([b1, b2], (1, n), h, s)
out, lse = E.evoformer_fwd_cuda(q, k, v, ops)
_, delta, _, _ = E.evoformer_bwd_dq_cuda(q, k, v, out, do, lse, ops)
res = {"default_group": E.rows_per_cta(n, h, s), "dq": {}, "dkv": {}}
for group in (4, 8, 16, 24, 32, 64):
    E.rows_per_cta = lambda B, h, s: min(B, group)
    key = f"group {group}"
    res["dq"][key] = chip_smoke.time_ms(torch, lambda: E.evoformer_bwd_dq_cuda(
        q, k, v, out, do, lse, ops, rows=True), iters=5)
    res["dkv"][key] = chip_smoke.time_ms(torch, lambda: E.evoformer_bwd_dkv_cuda(
        q, k, v, do, lse, delta, ops, cols=True), iters=5)
print(json.dumps({"root": sys.argv[1], "sweep": res}))
"""


def run(child, root):
    out = subprocess.run([sys.executable, "-c", child, root], cwd=root, capture_output=True,
                         text=True, timeout=900)
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
    ap.add_argument("--fwd", action="store_true",
                    help="time the forward kernel alone (and SDPA's forward) instead")
    ap.add_argument("--call", action="store_true",
                    help="time the op call (forward + backward) instead of the kernels")
    ap.add_argument("--sweep", action="store_true",
                    help="then time this checkout's backward kernels over the rows a CTA walks")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_evoformer_ab: no CUDA device", file=sys.stderr)
        return 2
    this = str(Path(__file__).resolve().parents[1])
    others = [str(Path(o).resolve()) for o in args.others]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    ms = {root: [] for root in [this] + others}
    for _ in range(args.rounds if others or not args.sweep else 0):
        for root in others + [this, this] + others[::-1]:
            rec = run(FWD_CHILD if args.fwd else CALL_CHILD if args.call else CHILD, root)
            if args.fwd:
                ms[root].append(rec["fwd"])
            elif args.call:
                ms[root].append(rec["call"])
            else:
                ms[root].append({k: {dt: r[dt]["ms"] for dt in r}
                                 for k, r in rec["timings"].items()})
    summary = {"card": card, "ms": ms}
    if args.fwd and ms[this]:
        summary["fwd_same_bits"] = {
            tag: len({run[tag]["sha256"] for runs in ms.values() for run in runs}) == 1
            for tag in ms[this][0]}
    if args.call and ms[this]:
        summary["fwd_same_bits"] = all(
            run[name]["fwd_sha256"] == ms[this][0][name]["fwd_sha256"]
            for runs in ms.values() for run in runs for name in run)
    if args.sweep:
        summary["sweep"] = run(SWEEP_CHILD, this)["sweep"]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
