#!/usr/bin/env python3
"""The remote and serve_agent_cli phases of ``chip_smoke.py`` alone, on one
CUDA card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_remote_phase.py [--clients N] [--short N] [--no-cli]

Builds the serving kernels (RMSNorm, paged decode and its int8 form,
block_quant), builds the engine phase's engine (Mistral-7B width, all 32
layers, seeded random bf16 weights, ``chip_smoke.ENGINE_CONFIG``), takes
greedy ``generate()`` on the serving phase's mix, then runs
``chip_smoke.remote_phase``: the router here with p0 over those weights,
a decode agent in its own process (``tools/torch_remote_agent.py``, which
rebuilds the weights from the seed) over the remote KV wire; the timed
pass, then at 4 layers the int8, planted, wire-fault and SIGKILL passes.
Then (unless ``--no-cli``) hf_import's 4-layer HF directory under
``build/`` and ``serve_agent_cli``: ``serve --control-port`` and
``serve-agent`` as two subprocesses. Prints the card's name and power
limit first, then one JSON object per phase and the remote phase's line.
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
    ap.add_argument("--clients", type=int, default=None, help="timed-pass clients (default 32)")
    ap.add_argument("--short", type=int, default=None, help="short-pass clients (default 8)")
    ap.add_argument("--no-cli", action="store_true", help="skip serve_agent_cli")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_remote_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import kernels as K

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_info()
    print(card, flush=True)
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    K.build([K.KERNELS[n] for n in cs.SERVE_KERNELS + cs.INT8_KERNELS])
    cs.emit({"phase": "setup", "card": card, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    cfg, params = cs.seeded_model(torch, dev)
    eng = cs.remote_model(torch, dev, cfg, params)
    del params
    prompts = cs.serve_prompts(eng._mc.vocab_size, n=args.clients or cs.SERVE_CLIENTS)
    want = [[int(t) for t in o[len(p):]]
            for o, p in zip(eng.generate(prompts, max_new_tokens=cs.SERVE_NEW_TOKENS), prompts)]
    torch.cuda.synchronize()
    cs.emit({"phase": "engine", "card": card, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    rec, launches = cs.remote_phase(torch, dev, K, eng, ROOT, prompts=prompts, want=want,
                                    short=args.short or cs.ROUTER_SHORT)
    rec.update(card=card, seconds=time.perf_counter() - t0,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    cs.emit(rec)
    cs.emit({"phase": "remote_launches", "launches": launches})
    print(cs.remote_note(rec, card), flush=True)
    del eng
    torch.cuda.empty_cache()
    if not args.no_cli:
        (ROOT / "build").mkdir(exist_ok=True)
        work = Path(tempfile.mkdtemp(prefix="remote_phase_", dir=ROOT / "build"))
        try:
            for name, run in (("hf_import", lambda: cs.hf_import_phase(torch, dev, K, work)),
                              ("serve_agent_cli",
                               lambda: cs.serve_agent_cli_phase(torch, dev, K, work, ROOT))):
                t0 = time.perf_counter()
                rec, _ = run()
                rec.update(card=card, seconds=time.perf_counter() - t0)
                cs.emit(rec)
                torch.cuda.empty_cache()
        finally:
            shutil.rmtree(work, ignore_errors=True)
    cs.emit({"phase": "done", "seconds": time.perf_counter() - t_all})
    return 0


if __name__ == "__main__":
    sys.exit(main())
