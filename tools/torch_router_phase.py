#!/usr/bin/env python3
"""The router phase of ``chip_smoke.py`` alone, on one CUDA card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_router_phase.py [--clients N] [--short N]

Builds the serving kernels (RMSNorm, paged decode and its int8 form,
block_quant), builds the engine phase's engine (Mistral-7B width, all 32
layers, seeded random bf16 weights, ``chip_smoke.ENGINE_CONFIG``), takes
greedy ``generate()`` on the serving phase's mix, then runs
``chip_smoke.router_phase`` over that engine's weights: one prefill
worker and two decode replicas behind ``start_server(port=0)`` (timed
pass over the ``device`` wire; short passes over every wire with each
handoff's blocks held bit for bit; the planted handoff fault; a worker
crash under ``ResilienceConfig``; a warm-spare scale-up; an int8-pool
pass). Prints the card's name and power limit first, then one JSON object
per phase and the router's summary line.
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clients", type=int, default=None, help="timed-pass clients (default 32)")
    ap.add_argument("--short", type=int, default=None, help="short-pass clients (default 8)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_router_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.ops import kernels as K

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_info()
    print(card, flush=True)
    t0 = time.perf_counter()
    K.build([K.KERNELS[n] for n in cs.SERVE_KERNELS + cs.INT8_KERNELS])
    cs.emit({"phase": "setup", "card": card, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    cfg = T.get_config(cs.MODEL)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(cs.SEED), dev)
    eng = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig.from_dict(cs.ENGINE_CONFIG),
                            device="cuda")
    del params
    prompts = cs.serve_prompts(cfg.vocab_size, n=args.clients or cs.SERVE_CLIENTS)
    want = [[int(t) for t in o[len(p):]]
            for o, p in zip(eng.generate(prompts, max_new_tokens=cs.SERVE_NEW_TOKENS), prompts)]
    torch.cuda.synchronize()
    cs.emit({"phase": "engine", "card": card, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    rec, launches = cs.router_phase(torch, dev, K, eng, prompts=prompts, want=want,
                                    short=args.short or cs.ROUTER_SHORT)
    rec.update(card=card, seconds=time.perf_counter() - t0,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    cs.emit(rec)
    cs.emit({"phase": "router_launches", "launches": launches})
    print(cs.router_note(rec, card), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
