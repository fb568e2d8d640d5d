#!/usr/bin/env python3
"""The port's evoformer kernels of several checkouts, timed in turns on one card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_evoformer_ab.py OTHER_ROOT [OTHER_ROOT ...] [--rounds 1]

Each OTHER_ROOT is another checkout of the repo (e.g. the parent commit
unpacked with ``git archive``). Each round runs ``chip_smoke.py``'s
``evoformer_timings`` (the three kernels held against their plain versions
at the evoformer phase's msa_row shape, then CUDA-graph times in bf16 and
fp32, beside their bounds) once in a fresh process per checkout, in turns:
the others, this one, this one again, the others in reverse (each builds
its own kernels into its own ``build/``). Prints the card's name and power
limit, then one JSON object per process and a summary of the kernel ms by
checkout.
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="+", help="roots of the other checkouts")
    ap.add_argument("--rounds", type=int, default=1,
                    help="each round runs the others, this twice, the others in reverse")
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
    for _ in range(args.rounds):
        for root in others + [this, this] + others[::-1]:
            out = subprocess.run([sys.executable, "-c", CHILD, root], cwd=root,
                                 capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                print(out.stderr[-4000:], file=sys.stderr)
                return 1
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(rec), flush=True)
            ms[root].append({k: {dt: r[dt]["ms"] for dt in r} for k, r in rec["timings"].items()})
    print(json.dumps({"card": card, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
