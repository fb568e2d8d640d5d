#!/usr/bin/env python3
"""A decode replica's agent in a process of its own: ``chip_smoke.py``'s
remote phase starts it, and so can anyone rehearsing that phase.

    python3 tools/torch_remote_agent.py [--prebuild '{"device": ..., "widths": ...}'] < passes.jsonl

Reads one pass a line on its standard input, a JSON object:

    {"join": [host, port], "name": "r0", "device": "cuda",
     "widths": {"n_layers": 4} or null, "engine_config": {...},
     "kv_cache_dtype": "bf16" | "int8", "decode_steps": 64,
     "new_tokens": 32, "replay": true, "planted": false,
     "faults": [[site, nth, replica], ...], "round_sleep_s": 0.0}

For each pass: the model ``chip_smoke.MODEL`` at ``widths``, its random
weights made from ``chip_smoke.SEED`` on the device
(``chip_smoke.seeded_model``, as the engine phase makes them; kept while the next
pass asks for the same widths), and the line ``WEIGHTS {"digest": ...}``
(``chip_smoke.weights_digest``); an ``InferenceEngineV2`` over them with
``engine_config`` (pool dtype and fused round as asked) in
``EngineCore(role="decode")``, and ``ReplicaAgent(core, join, name=name).run()``
against the router at ``join`` until its GOODBYE. While it runs, the
engine's calls and each handoff it imports are recorded
(``chip_smoke.recorded_schedule``; each import's blocks as a digest and as
a device copy), its kernel launches and the plain versions' calls counted;
``planted`` makes the importer adopt the pending token plus one (the
records keep the handoff as exported), ``faults`` installs the port's
fault injector, ``round_sleep_s`` delays every fused round. With
``replay`` the recorded calls and imports then run again on a fresh engine
over the same weights (``chip_smoke.replay_schedule``). Then the line
``RESULT {...}``: the agent's exit code, launches, plain calls, round
seconds, handoffs, pool, import retries, faults fired and the replay's
streams and round seconds. At the end of its input it exits 0.
``--prebuild`` makes the weights of that device and widths before the
first line arrives, so a caller can start the process ahead of its pass.
"""

import argparse
import contextlib
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def recorded_agent(torch, cs, eng, log, vocab=None, round_sleep_s=0.0):
    """While the block runs: each import the agent makes is appended to
    ``log`` as ("import", handoff) carrying its blocks as a device payload
    (``in_process``), with a digest of the blocks (``blocks_digest``);
    ``vocab`` plants the fault (the import adopts the pending token plus
    one; the record keeps the token as exported); each fused round that
    ran rows is timed, after ``round_sleep_s``. Yields {"handoffs": [...],
    "round_s": [...]}."""
    import deepspeed_tpu_torch.serving.cluster.agent as agent_mod

    import_ = agent_mod.import_sequence
    out = {"handoffs": [], "round_s": []}

    def rec_import(engine, ho):
        use = ho
        if vocab is not None:
            use = dataclasses.replace(ho, pending_token=(int(ho.pending_token) + 1) % vocab)
        copied = import_(engine, use)
        table = [int(b) for b in engine.state_manager.get_sequence(ho.uid).block_table]
        table = table[:ho.n_blocks]
        idx = torch.as_tensor(table, device=engine.device)
        planes = {k: p.index_select(1, idx) for k, p in engine._kv_pool_planes().items()}
        out["handoffs"].append({"uid": int(ho.uid), "blocks": int(ho.n_blocks),
                                "copied": int(copied), "planes": sorted(planes),
                                "windows": -(-int(copied) // max(1, int(ho.chunk_blocks))),
                                "digest": cs.bits_digest(torch, [planes[k] for k in sorted(planes)])})
        log.append(("import", dataclasses.replace(ho, payload=planes, transport="in_process",
                                                  endpoint=None, transfer_id=None)))
        return copied

    rounds = eng.decode_round

    def timed_round(n_steps=None):
        if round_sleep_s:
            time.sleep(round_sleep_s)
        t0 = time.perf_counter()
        res = rounds(n_steps)
        if res:
            out["round_s"].append(time.perf_counter() - t0)
        return res

    agent_mod.import_sequence = rec_import
    eng.decode_round = timed_round
    try:
        yield out
    finally:
        agent_mod.import_sequence = import_
        eng.decode_round = rounds  # recorded_schedule's exit deletes it


def run_pass(torch, cs, K, spec, cfg, params):
    """One pass: the agent's run against the router, then the replay.
    Returns the RESULT object."""
    from deepspeed_tpu_torch.serving.cluster import EngineCore, ReplicaAgent
    from deepspeed_tpu_torch.serving.metrics import ServingMetrics
    from deepspeed_tpu_torch.serving.resilience import (
        FaultInjector,
        FaultSpec,
        set_fault_injector,
    )

    dev = torch.device(spec.get("device", "cuda"))
    ds = int(spec["decode_steps"])
    kv = spec.get("kv_cache_dtype", "bf16")
    make = lambda: cs.remote_model(torch, dev, cfg, params,  # noqa: E731
                                   engine_config=spec["engine_config"], kv_cache_dtype=kv,
                                   decode_steps=ds)
    eng = make()
    core = EngineCore(eng, name=spec["name"], role="decode", decode_steps=ds,
                      metrics=ServingMetrics())
    agent = ReplicaAgent(core, tuple(spec["join"]), name=spec["name"], metrics=core.metrics)
    vocab = cfg.vocab_size if spec.get("planted") else None
    injector = None
    out = {"name": spec["name"], "kv_cache_dtype": kv, "decode_steps": ds}
    with cs.recorded_schedule(eng) as log, \
            recorded_agent(torch, cs, eng, log, vocab, float(spec.get("round_sleep_s", 0.0))) \
            as rec, cs.plain_version_calls() as plain:
        if spec.get("faults"):
            injector = FaultInjector([FaultSpec(site, nth=int(nth), replica=replica)
                                      for site, nth, replica in spec["faults"]])
            set_fault_injector(injector)
        try:
            K.reset_counts()
            t0 = time.perf_counter()
            out["rc"] = agent.run()
            out["seconds"] = time.perf_counter() - t0
            out["launches"] = K.counts()
        finally:
            if injector is not None:
                set_fault_injector(None)
    out.update(plain_calls=dict(plain), round_s=rec["round_s"], handoffs=rec["handoffs"],
               free_blocks=eng.state_manager.free_blocks,
               num_blocks=eng.config.kv_cache.num_blocks, import_retries=agent.import_retries,
               handoffs_in=core.handoffs_in,
               faults_fired=[f["site"] for f in injector.fired()] if injector else [])
    del agent, core, eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if spec.get("replay", True):
        fresh = make()
        t0 = time.perf_counter()
        round_s = []
        replayed = cs.replay_schedule(torch, fresh, log, int(spec["new_tokens"]),
                                      round_s=round_s)
        out["replay"] = {"streams": [[list(p), toks] for p, toks in replayed.items()],
                         "round_s": round_s, "seconds": time.perf_counter() - t0}
        del fresh
    del log
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prebuild", default=None, help="JSON {device, widths}: weights now")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import kernels as K

    model = None  # (widths key, cfg, params, digest, seconds)

    def weights(spec):
        nonlocal model
        dev = torch.device(spec.get("device", "cuda"))
        if dev.type == "cuda":
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
        key = json.dumps(spec.get("widths") or {}, sort_keys=True)
        if model is None or model[0] != key:
            model = None
            gc.collect()
            t0 = time.perf_counter()
            cfg, params = cs.seeded_model(torch, dev, spec.get("widths"))
            model = (key, cfg, params, cs.weights_digest(torch, params),
                     time.perf_counter() - t0)

    if args.prebuild:
        weights(json.loads(args.prebuild))
    for line in sys.stdin:
        if not line.strip():
            continue
        spec = json.loads(line)
        weights(spec)
        print("WEIGHTS " + json.dumps({"digest": model[3], "n_layers": model[1].n_layers,
                                       "seconds": model[4]}), flush=True)
        with torch.no_grad():
            out = run_pass(torch, cs, K, spec, model[1], model[2])
        print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
