#!/usr/bin/env python3
"""The offload and streaming phases of ``chip_smoke.py`` alone, on one CUDA card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_offload_phases.py [--only host_ops,train_offload,train_stream]

Builds the training kernels (RMSNorm, flash) and the two host libraries
from ``csrc/`` (CPU-Adam, async I/O), then runs ``chip_smoke``'s
``host_ops`` (the native ops against their plain versions, ``AioHandle``
and ``io_bench``), ``train_offload`` (every offload tier through
``train_batch`` at Mistral-7B width against the run without offload) and
``train_stream`` (bench.py's streamed 7B against the same engine with every
leaf on the card). Prints the card's name and power limit first, then one
JSON object per phase.
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("host_ops", "train_offload", "train_stream")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma-separated phases (default {','.join(PHASES)})")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_offload_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import kernels as K

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_info()
    print(card, flush=True)
    t0 = time.perf_counter()
    K.build([K.KERNELS[n] for n in cs.TRAIN_KERNELS])
    cs.emit({"phase": "setup", "card": card, "seconds": time.perf_counter() - t0})
    for name in args.only.split(","):
        t0 = time.perf_counter()
        if name == "host_ops":
            rec = cs.host_ops_phase(torch, dev)
        elif name == "train_offload":
            rec = cs.train_offload_phase(torch, dev, K)
        elif name == "train_stream":
            rec = cs.train_stream_phase(torch, dev, K)
        else:
            raise SystemExit(f"unknown phase {name!r} (one of {PHASES})")
        rec.update(card=card, seconds=time.perf_counter() - t0)
        cs.emit(rec)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
