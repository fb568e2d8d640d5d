#!/usr/bin/env python3
"""The port's fused decode round with a bf16 and an int8 KV pool, side by side.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_serve_ab.py [--pairs 3] [--steps 16]

Builds two ``InferenceEngineV2`` at Mistral-7B width (all 32 layers, seeded
random bf16 weights shared by both, ``chip_smoke.py``'s engine config), one
per pool dtype. Each engine first runs one short warm round; then, for each
pair, both engines prefill the same 32 prompts and time one
``decode_round(steps)``, alternating which goes first. Then one 2-step round
of each under ``torch.cuda.set_sync_debug_mode("warn")`` counts the
operations that synchronize the host with the card, by source line, and the
host time of one layer's K/V write (``_scatter_kv``) is timed eagerly for
both pools. Prints one JSON object per part, and the card's name and power
limit first.
"""

import argparse
import json
import sys
import time
import warnings
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_ab: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parents[1]
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
