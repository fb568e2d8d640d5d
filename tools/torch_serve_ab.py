#!/usr/bin/env python3
"""The port's fused decode round with a bf16 and an int8 KV pool, side by side.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_serve_ab.py [OTHER_ROOT ...] [--pairs 3] [--steps 16]

Builds two ``InferenceEngineV2`` at Mistral-7B width (all 32 layers, seeded
random bf16 weights shared by both, ``chip_smoke.py``'s engine config), one
per pool dtype. Each engine first runs one short warm round; then, for each
pair, both engines prefill the same 32 prompts and time one
``decode_round(steps)``, alternating which goes first. Then one 2-step round
of each under ``torch.cuda.set_sync_debug_mode("warn")`` counts the
operations that synchronize the host with the card, by source line, the
host time of one layer's K/V write (``_scatter_kv``) is timed eagerly for
both pools, and the int8 write's quantization of a split step's K and V
([1056, 8, 128] bf16 each) in a CUDA graph (``quantize_kv_pair`` where the
checkout has it, else ``quantize_kv`` of each). Prints one JSON object per
part, and the card's name and power limit first.

Each OTHER_ROOT is another checkout of the repo (e.g. the parent commit
unpacked with ``git archive``): then each checkout runs the above in a
fresh process of its own, in turns (the others, this one, this one again,
the others in reverse), and a summary by checkout follows.
"""

import argparse
import json
import sys
import time
import warnings
from pathlib import Path


def in_turns(others, args):
    """Runs this tool once per checkout in a fresh process, in turns;
    prints each part and a summary of the round and write times by
    checkout."""
    import subprocess

    this = str(Path(__file__).resolve().parents[1])
    roots = [str(Path(o).resolve()) for o in others]
    runs = {root: [] for root in [this] + roots}
    for root in roots + [this, this] + roots[::-1]:
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--root", root,
                              "--pairs", str(args.pairs), "--steps", str(args.steps)],
                             cwd=root, capture_output=True, text=True, timeout=1800)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return 1
        lines = out.stdout.strip().splitlines()
        print(f"[{root}]", *lines, sep="\n", flush=True)
        # the parts (the engines' log lines share stdout)
        parts = {rec.pop("part"): rec
                 for rec in map(json.loads, (ln for ln in lines if ln.startswith("{")))}
        runs[root].append(parts)
    print(json.dumps({"card": lines[0], "by_checkout": {
        root: {"median_tok_s": [r["rounds"]["median_tok_s"] for r in recs],
               "kv_write_quantize_ms": [r["kv_write_quantize"]["ms"] for r in recs],
               "scatter_kv_host_us": [r["scatter_kv_host_us"] for r in recs]}
        for root, recs in runs.items()}}), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="*", help="roots of the other checkouts")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--root", help="the checkout whose package this process runs "
                                   "(default: this one)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.others:
        return in_turns(args.others, args)
    root = Path(args.root).resolve() if args.root else Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke as C
    from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.ops import kernels as K

    print(C.card_info(), flush=True)
    K.build()
    dev = torch.device("cuda", 0)
    cfg = T.get_config(C.MODEL)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(C.SEED), dev)
    rng = np.random.default_rng(C.SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(64, 512, size=32)]

    def make(kv_dtype):
        ec = dict(C.ENGINE_CONFIG)
        ec["kv_cache"] = dict(ec["kv_cache"], kv_cache_dtype=kv_dtype)
        return InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig.from_dict(ec))

    def prefill(eng, base):
        for i, p in enumerate(prompts):
            eng.scheduler.submit(base + i, p)
        last = {}
        while eng.scheduler.has_pending():
            last.update(eng.step())
        for uid, lg in last.items():
            eng.scheduler.feedback(uid, int(np.argmax(lg)))
        torch.cuda.synchronize()

    def finish(eng):
        for uid in list(eng.scheduler.running_uids()):
            eng.scheduler.finish(uid)

    engines = {"bf16": make("bf16"), "int8": make("int8")}
    for eng in engines.values():
        prefill(eng, 0)
        eng.decode_round(4)
        finish(eng)
    seconds = {name: [] for name in engines}
    for pair in range(args.pairs):
        order = ("bf16", "int8") if pair % 2 == 0 else ("int8", "bf16")
        for name in order:
            eng = engines[name]
            prefill(eng, 100 * (pair + 1))
            t0 = time.perf_counter()
            eng.decode_round(args.steps)
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
            finish(eng)
    print(json.dumps({"part": "rounds", "steps": args.steps, "rows": 32, "seconds": seconds,
                      "median_tok_s": {n: 32 * args.steps / float(np.median(s))
                                       for n, s in seconds.items()}}), flush=True)

    syncs = {}
    for name, eng in engines.items():
        prefill(eng, 900)
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng.decode_round(2)
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        finish(eng)
        lines = {}
        for w in caught:
            if "synchroniz" in str(w.message):
                where = f"{Path(w.filename).name}:{w.lineno}"
                lines[where] = lines.get(where, 0) + 1
        syncs[name] = lines
    print(json.dumps({"part": "syncs_in_a_2_step_round", "by_line": syncs}), flush=True)

    # one layer's write of a round step's 32 tokens, eagerly, host clock
    k = torch.randn(32, cfg.kv_heads, cfg.head_dim, device=dev, dtype=torch.bfloat16)
    blk = torch.arange(32, device=dev, dtype=torch.int32) * 7
    row = blk % 128

    def us_per_call(fn, n=2000):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    print(json.dumps({"part": "scatter_kv_host_us", **{
        name: us_per_call(lambda e=eng: e._scatter_kv(3, blk, row, k, k))
        for name, eng in engines.items()}}), flush=True)

    # the int8 write's quantization at a split step's K and V (32 decode
    # slots + 4 chunks of 256 tokens), on the card
    from deepspeed_tpu_torch.ops.quantizer import block_quant as BQ

    gen = torch.Generator(device=dev).manual_seed(C.SEED)
    kv = [torch.randn(32 + 4 * 256, cfg.kv_heads, cfg.head_dim, generator=gen, device=dev,
                      dtype=torch.bfloat16) for _ in range(2)]
    pair = getattr(BQ, "quantize_kv_pair", None)
    write = (lambda: pair(*kv)) if pair else (lambda: [BQ.quantize_kv(x) for x in kv])
    K.reset_counts()
    write()
    print(json.dumps({"part": "kv_write_quantize", "form": "pair" if pair else "two calls",
                      "launches": K.counts()["block_quant"], "ms": C.time_ms(torch, write)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
