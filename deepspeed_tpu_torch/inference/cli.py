"""``generate``: text from a local HF checkpoint directory, in the port.

Counterpart of the ``generate`` half of ``deepspeed_tpu/inference/cli.py``:
``config.json`` and the safetensors weights through the architecture
importer (``models/hf.py``), ``tokenizer.json`` through the ``tokenizers``
runtime, text out through the v1 engine or the paged continuous-batching
v2 engine, on the card unless ``--device cpu`` is given; nothing is
fetched.

    python -m deepspeed_tpu_torch.inference.cli generate --model /path/to/hf_dir \\
        --prompt "Once upon a time" --max-new-tokens 64 [--engine v2] \\
        [--sample --temperature 0.8] [--dtype bfloat16] [--device cpu]

``--tp`` above 1 raises (ROADMAP queue 1, item 6), and so do the ``serve``
and ``serve-agent`` commands (item 5).
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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in ("serve", "serve-agent"):
        raise NotImplementedError(
            f"{argv[0]}: the serving stack is not ported yet (ROADMAP queue 1, item 5)")
    if argv and argv[0] == "generate":
        argv = argv[1:]
    return generate_main(argv)


if __name__ == "__main__":
    sys.exit(main())
