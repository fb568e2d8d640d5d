"""``generate`` and ``serve``: a local HF checkpoint directory, in the port.

Counterpart of ``deepspeed_tpu/inference/cli.py``. ``generate``:
``config.json`` and the safetensors weights through the architecture
importer (``models/hf.py``), ``tokenizer.json`` through the ``tokenizers``
runtime, text out through the v1 engine or the paged continuous-batching
v2 engine, on the card unless ``--device cpu`` is given; nothing is
fetched.

    python -m deepspeed_tpu_torch.inference.cli generate --model /path/to/hf_dir \\
        --prompt "Once upon a time" --max-new-tokens 64 [--engine v2] \\
        [--sample --temperature 0.8] [--dtype bfloat16] [--device cpu]

``serve`` runs the same v2 engine behind the long-lived serving driver and
HTTP front end (``deepspeed_tpu_torch/serving``), on one engine:

    python -m deepspeed_tpu_torch.inference.cli serve --model /path/to/hf_dir \\
        --port 8000 [--num-blocks 512] [--max-context 4096] [--timeout 120] \\
        [--decode-steps 8] [--spec-k 4] [--kv-cache-dtype int8] [--trace]

    curl -N -X POST http://127.0.0.1:8000/generate \\
        -d '{"prompt": "Once upon a time", "max_new_tokens": 64, "stream": true}'

Every kernel the served path launches is built or loaded (``warm_trace``)
before the first request is admitted. ``--tp`` above 1 raises (ROADMAP
queue 1, item 6). The multi-engine flags (``--num-decode-replicas`` above
1, ``--num-prefill-workers``, the elastic and resilience flags,
``--control-port``) and the ``serve-agent`` command raise (item 5).
"""

import argparse
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.inference.cli generate",
        description="generate text from a local HF checkpoint dir",
    )
    p.add_argument("--model", required=True, help="HF checkpoint directory")
    p.add_argument("--prompt", action="append", default=None,
                   help="prompt text (repeat for a batch)")
    p.add_argument("--prompt-file", default=None,
                   help="file with one prompt per line")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--engine", choices=["v1", "v2"], default="v1",
                   help="v1 = contiguous KV generate; v2 = paged continuous batching")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel ways (1 only)")
    p.add_argument("--sample", action="store_true",
                   help="temperature sampling instead of greedy")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-eos", action="store_true", help="ignore the eos token")
    p.add_argument("--tokens-only", action="store_true",
                   help="print token ids instead of decoded text")
    return p.parse_args(argv)


def _load(args):
    from deepspeed_tpu_torch.models import load_hf_model
    from deepspeed_tpu_torch.tokenizer import load_tokenizer

    cfg, params = load_hf_model(args.model, dtype=args.dtype, device=args.device)
    tok = load_tokenizer(args.model)
    return cfg, params, tok


def generate_main(argv=None) -> int:
    args = parse_args(argv)
    prompts = list(args.prompt or [])
    if args.prompt_file:
        with open(args.prompt_file) as f:
            prompts.extend(line.rstrip("\n") for line in f if line.strip())
    if not prompts:
        print("generate: pass --prompt and/or --prompt-file", file=sys.stderr)
        return 2
    if args.tp > 1:
        raise NotImplementedError(
            f"generate: --tp {args.tp} (tensor parallelism) is not ported yet "
            "(ROADMAP queue 1, item 6)")

    cfg, params, tok = _load(args)
    eos = None if args.no_eos else tok.eos_token_id
    enc = [tok.encode(p) for p in prompts]
    max_len = max(len(e) for e in enc) + args.max_new_tokens

    if args.engine == "v2":
        from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
        from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2

        bs = 128
        blocks_per_seq = (max_len + bs - 1) // bs + 1
        rc = RaggedInferenceEngineConfig.from_dict({
            "dtype": args.dtype,
            "decode_steps": min(32, args.max_new_tokens),
            "greedy": not args.sample, "temperature": args.temperature,
            "top_k": args.top_k, "top_p": args.top_p, "seed": args.seed,
            "kv_cache": {
                "block_size": bs,
                "num_blocks": max(64, blocks_per_seq * (len(enc) + 1)),
                "max_blocks_per_seq": blocks_per_seq,
            },
            "state_manager": {
                "max_tracked_sequences": max(64, len(enc)),
                "max_ragged_batch_size": 1024,
                "max_ragged_sequence_count": max(8, len(enc)),
                "max_context": max(1024, max_len),
            },
        })
        eng = InferenceEngineV2(cfg, params, rc, device=args.device)
        outs = eng.generate(enc, max_new_tokens=args.max_new_tokens, eos_token_id=eos)
        gen_ids = [np.asarray(o)[len(e):] for o, e in zip(outs, enc)]
    else:
        if args.top_k or args.top_p:
            print(
                "warning: --top-k/--top-p are ignored by --engine v1 "
                "(its sampler is temperature-only); use --engine v2 for "
                "filtered sampling",
                file=sys.stderr,
            )
        from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
        from deepspeed_tpu_torch.inference.engine import InferenceEngine

        ic = DeepSpeedInferenceConfig.from_dict({
            "dtype": args.dtype, "max_tokens": max(4096, max_len),
            "greedy": not args.sample, "temperature": args.temperature,
            "decode_steps": min(16, args.max_new_tokens),
        })
        eng = InferenceEngine(cfg, ic, params, device=args.device)
        gen_ids = []
        for e in enc:  # v1 batches need equal lengths; serve one at a time
            out = eng.generate(
                e[None], max_new_tokens=args.max_new_tokens,
                greedy=not args.sample, temperature=args.temperature,
                eos_token_id=eos, seed=args.seed,
            )
            gen_ids.append(np.asarray(out)[0, len(e):])

    for ids in gen_ids:
        if eos is not None and eos in ids:
            ids = ids[: list(ids).index(eos)]
        if args.tokens_only:
            print(" ".join(str(int(i)) for i in ids))
        else:
            print(tok.decode(ids))
    return 0


def _serve_parser(prog, description):
    """The serve argument surface of the JAX package's ``dstpu serve``,
    plus ``--device``. The flags that switch the multi-engine router on
    parse and are refused by ``build_serving_stack``; the ones that only
    tune it (placement, KV transport, load shedding, recovery limits, the
    control host) come with it (ROADMAP queue 1, item 5)."""
    p = argparse.ArgumentParser(prog=prog, description=description)
    p.add_argument("--model", required=True, help="HF checkpoint directory")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000, help="0 = ephemeral")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel ways (1 only)")
    p.add_argument("--block-size", type=int, default=128)
    p.add_argument("--num-blocks", type=int, default=512, help="KV pool size")
    p.add_argument("--kv-cache-dtype", default="bf16", choices=("bf16", "int8"),
                   help="KV pool payload dtype: int8 quantizes blocks on write")
    p.add_argument("--kv-pool-bytes", type=int, default=0,
                   help="size the KV pool from a byte budget instead of --num-blocks")
    p.add_argument("--paged-attention-impl", default="auto",
                   choices=("auto", "kernel", "dense"),
                   help="decode attention path: auto = the CUDA kernel on a card, "
                   "the plain gathers on the CPU")
    p.add_argument("--max-blocks-per-seq", type=int, default=32)
    p.add_argument("--max-context", type=int, default=4096)
    p.add_argument("--max-concurrent", type=int, default=64,
                   help="max tracked sequences (in-engine concurrency)")
    p.add_argument("--max-queue", type=int, default=128,
                   help="admission queue bound (further submits get 503)")
    p.add_argument("--kv-headroom", type=float, default=0.05,
                   help="fraction of KV blocks kept free at admission")
    p.add_argument("--timeout", type=float, default=None,
                   help="default per-request timeout in seconds")
    p.add_argument("--decode-steps", type=int, default=1,
                   help="fuse this many decode iterations per round")
    p.add_argument("--spec-k", type=int, default=0,
                   help="speculative decoding: verify up to this many n-gram-drafted "
                   "tokens per sequence per round (0 = off; the stream is unchanged)")
    p.add_argument("--spec-ngram", type=int, default=3,
                   help="max n-gram order for the prompt-lookup draft proposer")
    p.add_argument("--comm-quant", default="none", choices=("none", "int8"))
    p.add_argument("--comm-overlap", default="none", choices=("none", "tiled"))
    p.add_argument("--tp-overlap-tiles", type=int, default=4)
    p.add_argument("--num-prefill-workers", type=int, default=0,
                   help="disaggregated prefill engines (ROADMAP queue 1, item 5)")
    p.add_argument("--num-decode-replicas", type=int, default=1,
                   help="decode replicas behind a router (1 only; ROADMAP queue 1, item 5)")
    p.add_argument("--min-decode-replicas", type=int, default=0)
    p.add_argument("--max-decode-replicas", type=int, default=0)
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="disable automatic prefix caching (on by default when serving)")
    p.add_argument("--prefix-cache-blocks", type=int, default=0,
                   help="cap on trie-held KV blocks (0 = bounded by pool)")
    p.add_argument("--kv-host-tier-bytes", type=int, default=0,
                   help="host-memory KV tier budget in bytes (0 = off)")
    p.add_argument("--kv-host-tier-chunk-blocks", type=int, default=8,
                   help="blocks per re-import window")
    p.add_argument("--resilience", action="store_true",
                   help="fault-tolerant serving (ROADMAP queue 1, item 5)")
    p.add_argument("--trace", action="store_true",
                   help="request tracing: per-request span trees and the engine "
                   "timeline at /debug/trace")
    p.add_argument("--trace-buffer-events", type=int, default=65536,
                   help="total span budget across retained traces and the engine ring")
    p.add_argument("--trace-capture", default="all", choices=("all", "slow"),
                   help="retention policy: 'slow' keeps only requests at or above "
                   "the p90 e2e latency plus errors and preemptions")
    p.add_argument("--sample", action="store_true")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    return p


def serve_parse_args(argv=None):
    p = _serve_parser(
        prog="python -m deepspeed_tpu_torch.inference.cli serve",
        description="serve a local HF checkpoint dir over HTTP "
        "(continuous batching, streaming)",
    )
    p.add_argument("--control-port", type=int, default=None, metavar="PORT",
                   help="the multi-host control plane (ROADMAP queue 1, item 5)")
    return p.parse_args(argv)


def engine_config_from_args(args, cfg):
    """RaggedInferenceEngineConfig from parsed serve args: the one place
    the CLI surface maps onto engine config (the JAX package's mapping)."""
    from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig

    kv_dtype = getattr(args, "kv_cache_dtype", "bf16")
    num_blocks = args.num_blocks
    if int(getattr(args, "kv_pool_bytes", 0) or 0):
        from deepspeed_tpu_torch.inference.v2.kv_pool import blocks_for_budget

        num_blocks = blocks_for_budget(
            int(args.kv_pool_bytes), args.block_size, cfg.kv_heads,
            cfg.head_dim, cfg.n_layers, kv_dtype,
        )
    return RaggedInferenceEngineConfig.from_dict({
        "dtype": args.dtype, "tp_size": args.tp,
        "comm_quant": getattr(args, "comm_quant", "none"),
        "comm_overlap": getattr(args, "comm_overlap", "none"),
        "tp_overlap_tiles": getattr(args, "tp_overlap_tiles", 4),
        "decode_steps": args.decode_steps,
        "greedy": not args.sample, "temperature": args.temperature,
        "top_k": args.top_k, "top_p": args.top_p, "seed": args.seed,
        "spec_k": getattr(args, "spec_k", 0),
        "spec_ngram": getattr(args, "spec_ngram", 3),
        "paged_attention_impl": getattr(args, "paged_attention_impl", "auto"),
        "kv_cache": {
            "block_size": args.block_size,
            "num_blocks": num_blocks,
            "max_blocks_per_seq": args.max_blocks_per_seq,
            "prefix_cache": not getattr(args, "no_prefix_cache", False),
            "prefix_cache_blocks": getattr(args, "prefix_cache_blocks", 0),
            "kv_cache_dtype": kv_dtype,
            "host_tier_bytes": getattr(args, "kv_host_tier_bytes", 0),
            "host_tier_chunk_blocks": getattr(args, "kv_host_tier_chunk_blocks", 8),
        },
        "state_manager": {
            "max_tracked_sequences": args.max_concurrent,
            "max_ragged_batch_size": 1024,
            "max_ragged_sequence_count": min(32, args.max_concurrent),
            "max_context": args.max_context,
        },
    })


def _refuse_multi_engine(args):
    """The serve flags that build the JAX package's multi-engine router,
    its elastic control plane or its resilience layer: refused, naming
    the ROADMAP item that ports them."""
    n_prefill = int(getattr(args, "num_prefill_workers", 0) or 0)
    n_decode = int(getattr(args, "num_decode_replicas", 1) or 1)
    if n_prefill < 0 or n_decode < 1:
        raise ValueError(
            f"need num_prefill_workers >= 0 and num_decode_replicas >= 1 "
            f"(got {n_prefill}/{n_decode})")
    what = []
    if n_decode > 1:
        what.append(f"--num-decode-replicas {n_decode}")
    if n_prefill:
        what.append(f"--num-prefill-workers {n_prefill}")
    if int(getattr(args, "min_decode_replicas", 0) or 0) or int(
            getattr(args, "max_decode_replicas", 0) or 0):
        what.append("--min/--max-decode-replicas (elastic serving)")
    if getattr(args, "resilience", False):
        what.append("--resilience")
    if getattr(args, "control_port", None) is not None:
        what.append("--control-port")
    if what:
        raise NotImplementedError(
            f"serve: {', '.join(what)} needs the multi-engine router, which is not "
            "ported yet (ROADMAP queue 1, item 5)")
    if args.tp > 1:
        raise NotImplementedError(
            f"serve: --tp {args.tp} (tensor parallelism) is not ported yet "
            "(ROADMAP queue 1, item 6)")


def build_serving_stack(args, cfg=None, params=None, tok=None):
    """Engine + driver from parsed serve args (split out so tests build the
    stack without a socket). Pass cfg/params/tok to skip checkpoint
    loading. One engine serves behind ``ServingDriver``; its kernels are
    built or loaded by ``warm_trace`` before the driver admits anything.
    A directory without ``tokenizer.json`` (or a machine without the
    ``tokenizers`` package) serves token ids only, where the JAX package's
    command refuses to start. Returns (driver, tokenizer or None); the
    caller starts the driver."""
    from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.serving.driver import ServingDriver

    _refuse_multi_engine(args)
    if getattr(args, "trace", False):
        from deepspeed_tpu_torch.observability import configure_tracing

        configure_tracing(
            enabled=True,
            max_events=int(getattr(args, "trace_buffer_events", 65536)),
            capture=getattr(args, "trace_capture", "all"),
        )
    device = getattr(args, "device", "cuda")
    if cfg is None or params is None:
        from deepspeed_tpu_torch.models import load_hf_model

        cfg, params = load_hf_model(args.model, dtype=args.dtype, device=device)
    if tok is None and args.model:
        from deepspeed_tpu_torch.tokenizer import load_tokenizer

        try:
            tok = load_tokenizer(args.model)
        except (FileNotFoundError, ImportError) as e:
            # no tokenizer.json, or no tokenizers package on this machine:
            # serve token ids ("tokens" bodies); a "prompt" body gets a 400
            print(f"dstpu serve: no tokenizer ({e}); serving token ids only",
                  file=sys.stderr, flush=True)
    rc = engine_config_from_args(args, cfg)
    engine = InferenceEngineV2(cfg, params, rc, device=device)
    engine.warm_trace(decode_steps=args.decode_steps,
                      spec_k=int(getattr(args, "spec_k", 0) or 0))
    driver = ServingDriver(
        engine,
        eos_token_id=getattr(tok, "eos_token_id", None),
        max_queue=args.max_queue,
        kv_headroom=args.kv_headroom,
        default_timeout_s=args.timeout,
        decode_steps=args.decode_steps,
        spec_ngram=getattr(args, "spec_ngram", 3),
    )
    return driver, tok


def serve_main(argv=None) -> int:
    import time

    from deepspeed_tpu_torch.serving.server import start_server

    args = serve_parse_args(argv)
    driver, tok = build_serving_stack(args)
    driver.start()
    server = None
    try:
        server = start_server(driver, host=args.host, port=args.port, tokenizer=tok)
        host, port = server.server_address[:2]
        endpoints = "/generate, /health, /metrics"
        if getattr(args, "trace", False):
            endpoints += ", /debug/trace, /debug/events"
        print(f"dstpu serve: listening on http://{host}:{port} ({endpoints})",
              file=sys.stderr, flush=True)
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("dstpu serve: draining...", file=sys.stderr)
    finally:
        if server is not None:
            server.shutdown()
        driver.shutdown(drain=True, timeout=60)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        return serve_main(argv[1:])
    if argv and argv[0] == "serve-agent":
        raise NotImplementedError(
            "serve-agent: the remote replica agent is not ported yet "
            "(ROADMAP queue 1, item 5)")
    if argv and argv[0] == "generate":
        argv = argv[1:]
    return generate_main(argv)


if __name__ == "__main__":
    sys.exit(main())
