#!/usr/bin/env python3
"""The serving stack's phases of ``chip_smoke.py`` alone, on one CUDA card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_serving_phase.py [--skip-int8] [--skip-cli] [--clients N]

Builds the kernels, builds the engine phase's engine (Mistral-7B width, all
32 layers, seeded random bf16 weights, ``chip_smoke.ENGINE_CONFIG``)
through ``chip_smoke.engine_phase``, then runs ``chip_smoke.serving_phase``
on it: the ``ServingDriver`` behind ``start_server(port=0)`` with N
concurrent HTTP clients (timed, profiled, traced, speculative and planted
passes), every stream held against the engine's steps replayed on the
driver's schedule and against ``engine.generate()``, and a planted driver
fault caught by both. Then the same over the int8 pool
(``serving_int8``), and ``dstpu serve`` as a subprocess on
hf_import's 4-layer checkpoint (``serve_cli``, under a fresh ``build/``
directory, removed after). Prints the card's name and power limit first,
then one JSON object per phase and the serving phases' summary lines.
"""

import argparse
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-int8", action="store_true", help="no serving_int8 phase")
    ap.add_argument("--skip-cli", action="store_true", help="no serve_cli phase")
    ap.add_argument("--clients", type=int, default=None, help="clients (default 32)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_serving_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import kernels as K

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_info()
    print(card, flush=True)
    t0 = time.perf_counter()
    K.build()
    cs.emit({"phase": "setup", "card": card, "seconds": time.perf_counter() - t0})
    kw = {}
    if args.clients:
        kw["prompts"] = cs.serve_prompts(32000, n=args.clients)
    for int8 in (False, True):
        if int8 and args.skip_int8:
            continue
        held = {}
        t0 = time.perf_counter()
        rec, _ = cs.engine_phase(torch, dev, K, kv_cache_dtype="int8" if int8 else "bf16",
                                 hold=held, bench_repeats=1)
        cs.emit({"phase": rec["phase"], "card": card, "launches": rec["launches"],
                 "round_tok_s": rec["round_tok_s"], "gen_tok_s": rec["gen_tok_s"],
                 "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        rec, _ = cs.serving_phase(torch, dev, K, held["engine"], int8=int8, **kw)
        rec.update(card=card, seconds=time.perf_counter() - t0)
        cs.emit(rec)
        print(cs.serving_note(rec, card), flush=True)
        held.clear()
        torch.cuda.empty_cache()
    if not args.skip_cli:
        (ROOT / "build").mkdir(exist_ok=True)
        work = Path(tempfile.mkdtemp(prefix="serving_phase_", dir=ROOT / "build"))
        try:
            t0 = time.perf_counter()
            rec, _ = cs.hf_import_phase(torch, dev, K, work)
            cs.emit({"phase": "hf_import", "card": card, "seconds": time.perf_counter() - t0})
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            rec, _ = cs.serve_cli_phase(torch, dev, K, work, ROOT)
            rec.update(card=card, seconds=time.perf_counter() - t0)
            cs.emit(rec)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
