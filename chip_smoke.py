#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``deepspeed_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. setup: the card's name and power limit (``nvidia-smi``); the kernels
   built from ``deepspeed_tpu_torch/ops/kernels/csrc`` with ``nvcc`` for
   sm_90a, one process per source, all started together, with the
   ``-Xptxas -v`` report and the build seconds.
2. kernels: each kernel against its plain PyTorch version at the shapes
   the serving and training paths give it at Mistral-7B width, in bf16,
   with the tolerance stated (the flash kernels also at s 1024 with a
   static window, the window flag at 0 and 1, and packed segments with and
   without the window, at head dims 64 and 256, and at s 200 non-causal,
   all three also timed at head dims 64 and 256; their ALiBi forms with
   BLOOM's slopes at the train shape (32/8 heads of 128, s 4096, causal),
   over packed segments whose positions restart, at head dims 64 and 256
   and at s 200 non-causal, timed beside the no-ALiBi kernels on the same
   inputs and SDPA with a materialized bias; the
   fused-CE kernels also at sizes that divide no tile; FusedAdam at steps 1
   and 1000, AdamW and L2 decay, and on a leaf with a ragged tail; the
   splash kernels over a LocalMask, per-head Fixed layouts (at 64-blocks
   also over one kv head: 64 schedule rows a dk/dv CTA), packed segments,
   dead query blocks and the prefill form, and at two LocalMask shapes
   equal to the flash kernels with the same window; the flash kernels'
   outputs also as digests, equal to the recorded ones; the paged kernels at
   the split, round and causal forms, over shared-prefix tables, in the
   per-row form (256 queries over one table, stride-0 extras) and in the
   verify form of speculative decoding (R 32, k 4: 160 query rows, 5
   extras each; also timed, its bound counted as the kernel reads the pool
   and once per table), also per (row, head) as a relative Frobenius error, the int8 form over
   ``quantize_kv`` codes of seeded bf16 K/V; block_quant bit
   for bit at the engine's write shape and at a block of 2048 over a
   4096 x 14336 tensor, deterministic and stochastic; the layout-predicate
   sparse kernels over Fixed 16-blocks, per-head BigBird, dead rows and the
   dense layout at s 4096, the dense case also against the flash kernels and
   the Fixed and BigBird cases against the splash kernels over
   ``schedule_from_layout`` of the same layout; the evoformer kernels in
   bf16 and fp32 at d 16, 32, 64 and 128, s 100, no bias, one bias, a
   materialized pair bias and a fully masked row, and at the evoformer
   phase's msa_row shape, the bias gradients both as the dS plane and
   reduced (dq's partials folded by the merge kernel, which is also held
   against its plain version on them, bit for bit across two calls); the flash carry-mode chunk kernels, forward, dq
   and dk/dv, at Mistral-7B attention width over chunks of 4096, a
   non-diagonal and the diagonal hop with and without two packed segments,
   and at head dims 64 and 256 over chunks of 1024, each raw (the carry it
   leaves) and finalized); then CUDA-event times
   of the kernel, the plain version and one PyTorch library call computing
   the same function (a yardstick only: the port never calls it), beside
   the least time the card could take (``bound_ms``); the splash kernels
   also beside the port's flash kernels with the same window, the sparse
   kernels beside the causal flash kernels at the same shape.
3. engine: ``InferenceEngineV2`` at Mistral-7B width (seeded random bf16
   weights, all 32 layers) prefills 32 prompts through ``step()`` and runs
   one fused ``decode_round(64)``; logits are held against the plain
   ``forward_reference``; the serving kernels' launches are counted and
   checked; then ``serving_benchmark`` prints generated tokens per second.
   With ``--profile``, a torch.profiler breakdown of a split step and a
   decode round follows (and of one train step after each train leg).
3a. engine_spec, host_tier, inference_v1, on the engine phase's engine and
   weights. engine_spec: the same 32 prompts prefilled, then
   ``spec_round(4)`` with oracle drafts (the engine phase's own greedy
   stream), junk drafts (all rejected: one token a row), no drafts and
   oracle drafts again, then a plain ``decode_round(5)``: every emitted
   token the argmax of the verify step's logits at its slot, the verify
   logits against ``forward_reference`` on the same tokens (limit 0.05,
   int8 0.1), exact launches a verify step (paged decode L, RMSNorm 2L + 1;
   int8: block_quant L), the oracle tokens accepted, the verify step's ms
   and spec tokens/s against the plain round's. host_tier: an engine with
   the prefix cache and a host tier over a 64-block pool; a second batch
   of 8 prompts evicts the first batch's cached blocks (spilled), the first
   batch resubmitted readmits them: the prefill charges only the tails,
   each readmitted block's planes equal the spilled payload bit for bit,
   logits against ``forward_reference``, the chunked import's GB/s.
   inference_v1: ``init_inference`` at 4 prompts of 512 tokens, 16 greedy
   tokens at decode_steps 1 and 4 (equal streams), the first token's logits
   against ``forward_reference``, exactly 2L + 1 RMSNorm launches a forward
   step and no other kernel (its cached attention is ``mha_reference``).
3b. serving (after inference_v1, on the engine phase's engine): the
   serving stack as a user runs it. A ``ServingDriver`` (``decode_steps``
   64) behind ``start_server(port=0)``; 32 client threads POST
   ``/generate`` at once, every other one streamed, prompts of 128-600
   tokens (every 4th a 16-token motif repeated), 32 new tokens each. The
   driver's schedule (each prompt's submission and each engine call) is
   recorded and replayed on the engine with no driver, server or thread:
   every client's stream must equal the replay token for token
   (``replay_schedule``). Each stream is also held against greedy
   ``engine.generate()`` on the same prompts, whose batches hold other
   rows: equal, or leaving it only at a near-tie, every served token
   within 0.04 of the plain forward's largest logit on its served context
   (``compare_streams``). ``/health`` shows every block free once idle,
   ``/metrics`` parses as Prometheus text. Passes: timed (TTFT and TPOT p50
   / p99, tok/s), profiled (the same mix under torch.profiler's CUDA
   activity: the device's idle share), traced (``/debug/trace``: a valid
   Chrome trace with the engine's dispatch and device-wait spans and one
   tree per request), speculative (``NgramProposer``, k 4) and planted (a
   driver fault fed back: both checks must catch it). Each pass counts the
   served kernels' launches (RMSNorm, paged decode), and none of their
   plain versions may run. serving_int8 (after engine_spec_int8): the
   timed, profiled and planted passes over the int8 engine (paged decode
   int8, block_quant).
3c. engine_int8: the same engine and prompts with
   ``kv_cache_dtype="int8"``: logits against ``forward_reference`` (limit
   0.1), against the bf16 phase's rows computed from the same tokens, and
   against the same engine forced to ``paged_attention_impl="dense"``;
   exact counts (int8 paged decode L and block_quant L per forward step:
   K and V of a layer's write in one launch);
   ``serving_benchmark``; ``kv_pool_info`` beside the bf16 phase's. Then
   the int8 per-row check: ``_step_per_row`` at 4 layers, 2 prompts of
   ~1000 tokens, 8 new tokens, against the batched int8 step fed the same
   tokens, and one sequence's blocks exported and imported bit for bit.
   engine_spec_int8 (between the two): engine_spec on the int8 engine.
4. train: Mistral-7B width, bf16. Parity leg (2 layers, seq 4096, a
   batch packed into two segments with positions restarting): the loss and
   every leaf's gradient of ``make_loss_fn`` (the kernels) against autograd
   through ``forward_reference`` + ``nll_loss`` on the same weights, a
   control against another batch's gradients, then 8 engine steps on that
   batch (the loss must fall). Timed leg (8 layers, ``initialize`` ->
   ``train_batch``, micro-batch 1, 2 accumulation steps, AdamW, WarmupLR,
   clipping): 1 warm-up and 4 timed steps, losses, step seconds, tok/s,
   MFU, peak memory and the training kernels' exact launch counts.
5. train_fused: the same two legs at the fused configuration
   (``TransformerConfig(fused_ce=True)``, ``{"optimizer": {"type":
   "FusedAdam"}}``): the parity leg still compares with the dense head's
   autograd, and adds one FusedAdam step against the plain Adam math on the
   same grads and, after the 8 steps, a checkpoint save -> load -> step
   through the sync writer (the reloaded engine's params, masters,
   moments, count and learning rate equal the saved ones bit for bit, and
   so does its next loss); the timed leg counts the fused-CE and
   FusedAdam launches too.
6. train_splash: ``attention_impl="splash"``. Parity leg as in 4 at a
   window of 1024 (so the 4096-token schedule prunes blocks); timed leg at
   Mistral's window of 4096 over 16384 tokens, ``remat`` with policy
   "nothing" (the forward runs again in the backward); the flash kernels
   must not launch.
6a. the rest of the model, at published widths with the depth cut:
   train_alibi (bigscience/bloom-7b1, 2 layers, seq 2048: ALiBi on the
   flash kernels' ALiBi forms; the parity leg over a packed batch whose
   positions restart against ``forward_reference``, one v1 ``decode_step``
   after a 64-token prefill against the full forward, then 1 warm-up and 3
   ``train_batch`` steps with the ALiBi kernels' launches counted exactly),
   train_moe (mistralai/Mixtral-8x7B-v0.1, 1 layer, seq 4096: top-2 MoE
   with its aux loss; the rows whose top-2 set differs between the kernels'
   path and the plain one are counted and left out of the parity losses;
   then the steps, RMSNorm and flash launches counted), engine_moe
   (Mixtral at 4 layers in ``InferenceEngineV2``: 8 prompts through
   ``step()`` and ``decode_round(64)``, its logits held against
   ``forward_reference`` under the engine's routing, and each row routed
   otherwise than by the reference only where the reference's gate margin
   is within rounding; then capacity factor 1.25, where choices drop),
   train_mlm (bert-large-uncased at its 24 layers, seq 512: the MLM loss
   through the non-causal flash kernels at d 64 against
   ``forward_reference``; the gradients at 2 layers against it, at 2, 6,
   12 and 24 layers against the fp32 reference beside the kernels' plain
   versions; then the steps). Each prints its depth, its
   parameters and the bytes they take, and its peak memory.
7. engine_per_row: the engine's per-row step with splash at all 32 layers,
   an 8192-token context and 256-token chunks: 4 prompts of 6144-8176
   tokens prefilled and decoded for 16 tokens; every row step takes the
   splash prefill (launches counted exactly), logits against
   ``forward_reference`` and against the dense per-row path fed the same
   tokens, the kv blocks each chunk's schedule visits, prefill tok/s.
8. sparse_attn: the op-registry entry point. ``get_accelerator()
   .create_op_builder("sparse_attn").load()`` hands out the block-sparse
   module, whose ``SparseSelfAttention(FixedSparsityConfig(block 128, 4
   local, 1 global, unidirectional), use_splash=False)`` runs forward and
   backward on Mistral-7B's attention (32 query heads over 8 kv heads,
   expanded by the module, of 128) at 16384 tokens in bf16: exactly one
   launch of each sparse kernel and no other, out and gradients against
   the plain versions, peak memory and seconds; then a ``key_padding_mask``
   call at 4096 tokens (the dense biased form: no kernel) against
   ``sparse_attention_with_bias``.
9. evoformer: the op-registry entry point ``get_accelerator()
   .create_op_builder("evoformer_attn").load()`` hands out
   ``DS4Sci_EvoformerAttention``, which runs forward and backward at
   AlphaFold2's fine-tuning widths in bf16 with AlphaFold's mask (bias1 =
   1e9 * (mask - 1), the last rows and keys padded off) and a random pair
   bias: msa_row (Q/K/V [1, 512, 384, 8, 32]) and triangle ([1, 384, 384,
   4, 32]), both biases needing gradients; exactly one launch of each
   evoformer kernel per call (the bias-gradient merge included) and no
   other; out, dQ, dK, dV against the plain versions (elementwise and per
   64-row tile), db1 and db2 as relative Frobenius and bit for bit across
   two calls; peak memory above the inputs (below the [B, h, s, s] fp32
   plane's size: none is allocated), the merge's device time and seconds;
   then a call whose biases need no gradient, which must ask for neither
   the dS plane nor its partials.

10. ring_attn: the context-parallel ring in its loopback form (one
   process drives N = 4 context ranks: one card cannot hold an NCCL rank
   per chunk; a line says the process form was not run) through
   ``attention(impl="flash_ring")``, forward and backward at s 32768:
   Llama-2-7B attention (32 heads of 128, MHA) with out, lse, dq, dk and dv
   bit for bit against ``flash_attention`` on the same inputs, and
   Mistral-7B-v0.2 attention (32 over 8 heads) with all five bit for bit
   too; exactly N(N + 1) / 2 = 10 launches of each chunk kernel
   per call and no other; the call's ms against the single call's and
   SDPA's, and the peak memory of each.
11. train_ring: ``initialize(mpu=Topology(context=4, loopback=True))`` ->
   ``train_batch`` with ``attention_impl="flash_ring"`` at llama-7b width
   (8 of 32 layers, ``max_seq_len`` 16384, seq 16384 in 4 chunks of 4096,
   remat, bf16, micro-batch 1 x gas 2, AdamW as the train leg): the first
   step's loss and every gradient bit for bit equal to the same engine
   with ``attention_impl="flash"`` (built after it is freed), then 1
   warm-up and 4 timed steps: step seconds, tok/s, MFU, peak memory and
   the exact launches per optimizer step.

12. hf_import, train_import, graft_entry: the path from a HuggingFace
   checkpoint directory. hf_import: Mistral-7B-v0.1's published
   ``config.json`` (MistralForCausalLM, hidden 4096, 32/8 heads of 128,
   intermediate 14336, vocab 32000, rms eps 1e-5, rope theta 1e4, sliding
   window 4096) with ``num_hidden_layers`` cut from 32 to 4 and seeded
   random bf16 weights in HF names and layout (1.13 B parameters), written
   by the port's safetensors writer as 2 shards with an index under the
   checkout's ``build/``, loaded through ``build_hf_engine`` on the card
   (every leaf bit for bit against the written tensors, transposed and
   stacked; seconds, GB/s, peak memory), then 4 prompts prefilled through
   ``step()`` and decoded greedily (two steps and ``decode_round(64)``):
   last-prefill logits against ``forward_reference`` on the loaded params
   (limit 0.05), RMSNorm 2L + 1 and paged decode L launches per forward
   step. serve_cli: ``python -m deepspeed_tpu_torch.inference.cli serve
   --model <that directory> --port 0`` as a subprocess (killed in every
   case): once it prints its address, two ``tokens`` requests, one after
   the other, each equal to ``build_hf_engine``'s ``generate`` with the
   engine config its flags make. train_import: a 2-layer cut of that directory through
   ``load_hf_model`` into ``initialize`` with a client ``torch.optim.AdamW``
   and ``grad_accum_dtype`` "bf16", 2 ``train_batch`` steps (flash and
   RMSNorm launches exact, the loss falling), a save with
   ``checkpoint.writer`` unset and a load into a fresh engine (bit for bit),
   and ``zero_to_fp32`` on that archive equal to the engine's fp32 masters.
   graft_entry: ``graft_entry.entry()`` on the card, its logits against
   ``forward_reference``. The directories are removed afterwards.

13. quantization. qmatmul: ``ops/qmatmul.py`` at one ``train_fused``
   micro-batch through w_up (x [4096, 4096] bf16 @ w [4096, 14336]) and at
   8 decode rows (``_int_mm`` takes more than 16 rows: padded to 24;
   ``_scaled_mm`` to 16), each mode's forward against its plain version
   (int8 modes bit for bit: the int32 product and the rescaled output; fp8
   relative Frobenius 1e-3 against the plain fp32 product of the same
   codes, its bf16 output within 2^-6 of the largest element), the backward
   bit for bit against the wide vjp (dx also against
   autograd of ``x @ w``), the cast, product and call times beside ``x @
   w`` in bf16. train_qmm: ``train_batch`` at Mistral-7B width, 2 layers,
   seq 4096, gas 2, FusedAdam (AdamW mode) at a constant lr on one batch, for
   ``matmul_precision`` default, int8 and fp8: the first loss within 0.02
   of default's, the losses finite and falling over 1 + 3 steps, step
   seconds and tok/s, the flash, RMSNorm and FusedAdam launches exactly the
   default's.
   serve_wq8 / serve_wq4: the engine phase at ``quant: {enabled, bits 8 |
   4, group_size 128}`` on the same weights: ``model_memory_bytes``
   against the wide weights', logits against ``forward_reference`` over
   the same weights dequantized (limit 0.05), the prefill logits'
   correlation with the bf16 engine phase's (int8 at least 0.99; int4 at
   least 0.5, see QUANT_CORR_MIN), launches as in the engine phase, gen and
   round tok/s against the bf16 engine's, peak memory, and the ms the steps
   spend widening the weights. fp_quantizer: the registry's
   ``fp_quantizer`` at [4096, 14336] on the card, codes, scales and packed
   bytes equal to the host's bit for bit. lora: ``optimized_linear`` 4096
   -> 14336, r 64, int8 base, forward and backward: gradients reach the
   adapters only, ``merge_lora``'s product within bf16's bound of the call.
   These phases launch no kernel of their own: the quantized models' paths
   launch the serving and training kernels, counted.

Serving kernels must launch in the engine phase (the int8 pool's in
engine_int8 and its per-row check), in a verify step (engine_spec,
engine_spec_int8) and from the serving driver's thread (serving,
serving_int8), training kernels in the train legs,
the fused configuration's four in its leg, the splash kernels in the
splash leg (the forward also in the per-row leg), the sparse kernels in the
sparse_attn phase, the evoformer kernels in the evoformer phase, the chunk
kernels in the ring_attn and train_ring phases, the ALiBi kernels in
train_alibi: together every kernel (train_moe and train_mlm must launch the
flash kernels too, engine_moe and hf_import the serving kernels,
train_import the training kernels, graft_entry RMSNorm and the flash
forward; train_qmm the training kernels at every precision, serve_wq8 and
serve_wq4 the serving kernels). The line before the last lists the
kernels; the last line is the result object. With no card, or outside a
checkout, it exits non-zero and prints no result.
"""

import argparse
import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# bf16 results: a few units in the last place of values of magnitude ~1
# (the kernel and the plain version sum in fp32 in another order, then
# round once to bf16, whose spacing is 2^-8 near 1)
BF16_ATOL = 2.0 ** -6
BF16_RTOL = 2.0 ** -6
# fp32 results: fp32 sums in another order
FP32_ATOL = 2e-5
FP32_RTOL = 2e-5
# draft slots of the speculative decoding phases and of the verify form
SPEC_K = 4


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0].strip()


def time_ms(torch, fn, iters=20, warmup=3):
    """Device time of one call of ``fn``: ``iters`` calls captured in a CUDA
    graph, replayed between two CUDA events, so host overhead (Python,
    ctypes, argument checks) is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def eager_ms(torch, fn, iters=20, warmup=3):
    """Wall time of one eager call of ``fn`` (host overhead included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_close(torch, name, got, want, atol, rtol):
    got32, want32 = got.float(), want.float()
    if not bool(torch.isfinite(got32).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got32 - want32).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    bad = err > atol + rtol * want32.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements off (max abs err {max_abs}, "
            f"atol {atol}, rtol {rtol})"
        )
    return max_abs


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def kernel_rms_norm(torch, dev, h=4096, rows=32 + 4 * 256, eps=1e-5):
    """RMSNorm at the split step's shape: R + Rc * tq rows of width h."""
    from deepspeed_tpu_torch.ops.normalization.fused_norm import (
        rms_norm_cuda,
        rms_norm_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(rows, h, generator=gen, device=dev).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(h, generator=gen, device=dev)).to(torch.bfloat16)
    errs = {}
    errs["bf16"] = check_close(
        torch, "rms_norm bf16", rms_norm_cuda(x, w, eps), rms_norm_reference(x, w, eps),
        BF16_ATOL, BF16_RTOL,
    )
    w32 = 1 + w.float()  # rmsnorm_1p's fp32 weight
    errs["bf16_w32"] = check_close(
        torch, "rms_norm bf16/fp32 w", rms_norm_cuda(x, w32, eps),
        rms_norm_reference(x, w32, eps), BF16_ATOL, BF16_RTOL,
    )
    for r, hh in ((7, 96), (13, 128), (5, 100)):
        xs = torch.randn(r, hh, generator=gen, device=dev)
        ws = torch.randn(hh, generator=gen, device=dev)
        errs[f"fp32_{r}x{hh}"] = check_close(
            torch, f"rms_norm fp32 {r}x{hh}", rms_norm_cuda(xs, ws, eps),
            rms_norm_reference(xs, ws, eps), FP32_ATOL, FP32_RTOL,
        )
    torch.cuda.synchronize()

    # times: rotate through input copies larger than the 50 MB L2 together,
    # so each launch reads x from device memory
    n_buf = 8
    xs = [x.clone() for _ in range(n_buf)]
    it = iter(range(1 << 30))
    lib = torch.nn.functional.rms_norm
    ms = time_ms(torch, lambda: rms_norm_cuda(xs[next(it) % n_buf], w, eps))
    plain_ms = time_ms(torch, lambda: rms_norm_reference(xs[next(it) % n_buf], w, eps))
    library_ms = time_ms(torch, lambda: lib(xs[next(it) % n_buf], (h,), w, eps))
    call_ms = eager_ms(torch, lambda: rms_norm_cuda(xs[next(it) % n_buf], w, eps))
    moved = 2 * rows * h * x.element_size() + h * w.element_size()
    ops = 4 * rows * h  # square, sum, two multiplies per element
    bound_s = max(moved / HBM_BYTES_PER_S, ops / FP32_FLOPS)
    return {
        "name": "rms_norm_fwd",
        "shape": [rows, h],
        "max_abs_err": max(errs.values()),
        "max_abs_err_by_case": errs,
        "tolerance": {"bf16": [BF16_ATOL, BF16_RTOL], "fp32": [FP32_ATOL, FP32_RTOL]},
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library": "torch.nn.functional.rms_norm",
        "eager_call_ms": call_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops / FP32_FLOPS else "operations",
        "bytes": moved,
    }


def kernel_rms_norm_bwd(torch, dev, rows=4096, h=4096, eps=1e-5):
    """RMSNorm backward (dx) at the train step's shape: one micro-batch of
    4096 tokens at width 4096."""
    from deepspeed_tpu_torch.ops.normalization.fused_norm import (
        rms_norm_bwd_cuda,
        rms_norm_bwd_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(rows, h, generator=gen, device=dev).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(h, generator=gen, device=dev)).to(torch.bfloat16)
    g = torch.randn(rows, h, generator=gen, device=dev).to(torch.bfloat16)
    errs = {"bf16": check_close(torch, "rms_norm_bwd bf16", rms_norm_bwd_cuda(x, w, g, eps),
                                rms_norm_bwd_reference(x, w, g, eps), BF16_ATOL, BF16_RTOL)}
    w32 = 1 + w.float()  # rmsnorm_1p's fp32 weight
    errs["bf16_w32"] = check_close(
        torch, "rms_norm_bwd bf16/fp32 w", rms_norm_bwd_cuda(x, w32, g, eps),
        rms_norm_bwd_reference(x, w32, g, eps), BF16_ATOL, BF16_RTOL)
    for r, hh in ((7, 96), (13, 128), (5, 100)):
        xs = torch.randn(r, hh, generator=gen, device=dev)
        ws = torch.randn(hh, generator=gen, device=dev)
        gs = torch.randn(r, hh, generator=gen, device=dev)
        errs[f"fp32_{r}x{hh}"] = check_close(
            torch, f"rms_norm_bwd fp32 {r}x{hh}", rms_norm_bwd_cuda(xs, ws, gs, eps),
            rms_norm_bwd_reference(xs, ws, gs, eps), FP32_ATOL, FP32_RTOL)
    torch.cuda.synchronize()

    n_buf = 4  # x and g copies larger than the 50 MB L2 together
    xs = [x.clone() for _ in range(n_buf)]
    gs = [g.clone() for _ in range(n_buf)]
    it = iter(range(1 << 30))

    def rotating(fn):
        i = next(it) % n_buf
        return fn(xs[i], w, gs[i], eps)

    ms = time_ms(torch, lambda: rotating(rms_norm_bwd_cuda))
    plain_ms = time_ms(torch, lambda: rotating(rms_norm_bwd_reference), iters=5)
    xl = x.clone().requires_grad_(True)
    wl = w.clone().requires_grad_(True)
    y = torch.nn.functional.rms_norm(xl, (h,), wl, eps)
    library_ms = eager_ms(torch, lambda: torch.autograd.grad(y, (xl, wl), g, retain_graph=True))
    moved = 3 * rows * h * x.element_size() + h * w.element_size()
    ops = 10 * rows * h  # squares, sums, the dot and the dx formula, per element
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return {
        "name": "rms_norm_bwd",
        "shape": [rows, h],
        "max_abs_err": max(errs.values()),
        "max_abs_err_by_case": errs,
        "tolerance": {"bf16": [BF16_ATOL, BF16_RTOL], "fp32": [FP32_ATOL, FP32_RTOL]},
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library": "autograd backward of torch.nn.functional.rms_norm (dx and dw, eager)",
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": moved,
    }


# flash kernels: bf16 outputs against their plain versions (both round p
# and ds to bf16 before their products and sum in fp32 in another order;
# outputs round once): a few bf16 units of the largest element. The LSE is
# fp32: sums over up to 4096 keys in another order.
FLASH_LSE_ATOL = 1e-4
# The gradients' magnitudes fall along the sequence (causal: a key's dk/dv
# sums over the queries that see it, a query's dq over 1/i-sized weights),
# so an atol scaled by the largest element exceeds the typical late
# element. Each (batch, head, 64-row tile) of dq, dk and dv is also held to
# its own relative Frobenius error: two bf16 roundings of fp32 sums in
# another order give ~2^-9 relative per element (~0.002 over a tile).
FLASH_TILE = 64
FLASH_TILE_RTOL = 1e-2


def tile_rel_err(torch, name, got, want, tile=FLASH_TILE, limit=FLASH_TILE_RTOL):
    """Largest ||got - want||_F / ||want||_F over the (batch, head,
    ``tile``-row) tiles of [b, h, s, d] tensors (a tail tile is partial);
    raises above ``limit``. A tile whose reference is all zero must be zero."""
    b, h, s, d = want.shape
    pad = -s % tile

    def tiles(t):
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
        return t.reshape(b, h, -1, tile * d)

    g, w = tiles(got), tiles(want)
    err = (g - w).norm(dim=-1)
    ref = w.norm(dim=-1)
    rel = torch.where(ref > 0, err / ref.clamp_min(torch.finfo(torch.float32).tiny),
                      torch.where(err > 0, float("inf"), 0.0))
    worst = float(rel.max())
    if not worst <= limit:
        raise AssertionError(f"{name}: a {tile}-row tile is off by {worst} relative "
                             f"(Frobenius; limit {limit})")
    return worst


def hold(torch, errs, tile_errs, kname, tag, got, want):
    """``got`` against ``want`` elementwise (the bf16 tolerance scaled by
    the reference's largest element) and, where ``tile_errs`` has the
    kernel, per 64-row tile; records both under ``tag``, raises on a miss."""
    scale = max(1.0, float(want.float().abs().max()))
    errs[kname][tag] = check_close(torch, f"{kname} {tag}", got, want, BF16_ATOL * scale,
                                   BF16_RTOL)
    if kname in tile_errs:
        tile_errs[kname][tag] = tile_rel_err(torch, f"{kname} {tag}", got, want)


def flash_pairs(s, causal, window, window_flag, segment_ids):
    """Visible (query, key) pairs per (batch, head), summed over the batch:
    the work these inputs need."""
    import numpy as np

    q = np.arange(s)[:, None]
    k = np.arange(s)[None, :]
    vis = np.ones((s, s), bool) if not causal else q >= k
    if window and (window_flag is None or window_flag > 0):
        vis &= (q - k) < window
    if segment_ids is None:
        return int(vis.sum())
    total = 0
    for row in segment_ids.cpu().numpy():
        total += int((vis & (row[:, None] == row[None, :])).sum())
    return total


def flash_inputs(torch, dev, b, h, h_kv, s, d, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, s, d, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(b, h_kv, s, d, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(b, h_kv, s, d, generator=gen, device=dev).to(torch.bfloat16)
    do = torch.randn(b, h, s, d, generator=gen, device=dev).to(torch.bfloat16)
    return q, k, v, do


def two_segments(torch, dev, b, s, cut):
    seg = torch.zeros(b, s, dtype=torch.int32, device=dev)
    seg[:, cut:] = 1
    return seg


# the flash kernels' outputs on fixed inputs, as digests to compare across
# checkouts (their CTA bodies are shared with the splash kernels): per case
# (head dim, s, causal, window, segment cut or None), b 1, 8/2 heads
FLASH_DIGEST_CASES = ((128, 1000, True, 300, None), (128, 768, True, 0, 300),
                      (64, 512, False, 0, None), (256, 640, True, 200, None))
# ``flash_digests`` as the wgmma flash kernels give them (NVIDIA H100 80GB
# HBM3; the same before and after their CTA bodies took the splash walks as
# a policy). The kernels phase fails on any other: a change that moves the
# flash kernels' bits on purpose records its new digests here.
FLASH_DIGESTS = {"d128_s1000_causal1_w300_segNone": "aae60a2ffd5058df",
                 "d128_s768_causal1_w0_seg300": "f347c19b569c38ff",
                 "d64_s512_causal0_w0_segNone": "ffa3c8250fe5f428",
                 "d256_s640_causal1_w200_segNone": "c057366d7e6fa449"}


def flash_digests(torch, dev, F=None):
    """sha256 (16 hex digits) of out, lse, dq, dk and dv of the flash
    kernels (``F``: a checkout's ``ops.attention.flash``, this one's by
    default) on ``FLASH_DIGEST_CASES``; the inputs come from numpy's seeded
    generator, so every torch build makes the same ones."""
    import hashlib

    import numpy as np

    if F is None:
        from deepspeed_tpu_torch.ops.attention import flash as F
    digests = {}
    for i, (d, s, causal, window, cut) in enumerate(FLASH_DIGEST_CASES):
        rng = np.random.default_rng(1000 + i)
        q, k, v, do = (torch.from_numpy(rng.standard_normal((1, n, s, d), np.float32)).to(
            dev, torch.bfloat16) for n in (8, 2, 2, 8))
        kw = dict(causal=causal, window=window,
                  segment_ids=None if cut is None else two_segments(torch, dev, 1, s, cut))
        out, lse = F.flash_fwd_cuda(q, k, v, **kw)
        dq = F.flash_bwd_dq_cuda(q, k, v, out, do, lse, **kw)
        dk, dv = F.flash_bwd_dkv_cuda(q, k, v, out, do, lse, **kw)
        h = hashlib.sha256()
        for t in (out, lse, dq, dk, dv):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        digests[f"d{d}_s{s}_causal{int(causal)}_w{window}_seg{cut}"] = h.hexdigest()[:16]
    return digests


def flash_cases(torch, dev, b=1, h=32, h_kv=8, s=4096, d=128, window=4096, short=1024):
    """The flash kernels' cases, name -> dict(b, h, h_kv, s, d, causal, window,
    window_flag, seg): the train step's shape (causal, static window =
    seq), then at ``short`` tokens a static window of 256 (no flag, the
    flag at 0 and 1), two packed segments with and without the window,
    head dims 64 and 256 (the kernels' other tile shapes), and s 200
    non-causal (a tail that is no whole tile of any width)."""
    base = dict(b=b, h=h, h_kv=h_kv, d=d, causal=True, window=0, window_flag=None, seg=None)
    cut = short * 389 // 1024
    cases = {f"s{s}_causal_window{window}": dict(base, s=s, window=window)}
    for tag, flag in (("", None), ("_flag0", 0), ("_flag1", 1)):
        cases[f"s{short}_window256{tag}"] = dict(base, s=short, window=256, window_flag=flag)
    cases[f"s{short}_window256_segments2"] = dict(base, s=short, window=256,
                                                  seg=two_segments(torch, dev, b, short, cut))
    cases[f"s{short}_causal_segments2"] = dict(base, s=short,
                                               seg=two_segments(torch, dev, b, short, cut))
    for width in (64, 256):
        cases[f"d{width}_s{short}_causal"] = dict(base, s=short, d=width)
    cases["s200_noncausal"] = dict(base, b=2, s=200, causal=False)
    return cases


def check_flash_case(torch, dev, errs, tile_errs, name, c, seed):
    """One case through the three flash kernels against their plain
    versions: out and lse, then dq, dk and dv from the kernel's out and lse
    (elementwise and, for the gradients, per 64-row tile)."""
    from deepspeed_tpu_torch.ops.attention import flash as F

    q, k, v, do = flash_inputs(torch, dev, c["b"], c["h"], c["h_kv"], c["s"], c["d"], seed=seed)
    kw = dict(causal=c["causal"], segment_ids=c["seg"], window=c["window"],
              window_flag=c["window_flag"])
    out, lse = F.flash_fwd_cuda(q, k, v, **kw)
    ref_out, ref_lse = F.flash_fwd_reference(q, k, v, **kw)
    errs["flash_fwd"][name] = check_close(torch, f"flash_fwd {name}", out, ref_out, BF16_ATOL,
                                          BF16_RTOL)
    errs["flash_fwd"][name + "_lse"] = check_close(
        torch, f"flash_fwd lse {name}", lse, ref_lse, FLASH_LSE_ATOL, FP32_RTOL)
    del ref_out, ref_lse
    dq = F.flash_bwd_dq_cuda(q, k, v, out, do, lse, **kw)
    dk, dv = F.flash_bwd_dkv_cuda(q, k, v, out, do, lse, **kw)
    rdq, rdk, rdv = F.flash_bwd_reference(q, k, v, out, do, lse, **kw)
    for kname, got, want, tag in (("flash_bwd_dq", dq, rdq, name),
                                  ("flash_bwd_dkv", dk, rdk, name),
                                  ("flash_bwd_dkv", dv, rdv, name + "_dv")):
        hold(torch, errs, tile_errs, kname, tag, got, want)


def kernel_flash(torch, dev, b=1, h=32, h_kv=8, s=4096, d=128, window=4096):
    """The three flash kernels at the train step's shape (Mistral-7B: 32/8
    heads of 128, causal, static window 4096 = seq) and at the other cases
    of ``flash_cases``; each also timed at head dims 64 and 256 (their
    other tile shapes) at the train step's s, beside SDPA's forward or
    backward at that width. Returns one record per kernel."""
    from deepspeed_tpu_torch.ops.attention import flash as F

    errs = {"flash_fwd": {}, "flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    tile_errs = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    for i, (name, c) in enumerate(flash_cases(torch, dev, b, h, h_kv, s, d, window).items()):
        check_flash_case(torch, dev, errs, tile_errs, name, c, seed=10 + i)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # the three kernels at their other widths (same heads, s, mask)
    by_width = {name: {} for name in errs}
    for width in (64, 256):
        q, k, v, do = flash_inputs(torch, dev, b, h, h_kv, s, width, seed=20 + width)
        kw = dict(causal=True, window=window)
        out, lse = F.flash_fwd_cuda(q, k, v, **kw)
        pairs = b * h * flash_pairs(s, True, window, None, None)
        el = q.element_size()
        qb, kvb, lseb = q.numel() * el, k.numel() * el, b * h * s * 4
        library_bwd = sdpa_bwd_ms(torch, q, k, v, do)
        forms = {  # (call, FLOPs, bytes, library ms, tiles)
            "flash_fwd": (lambda: F.flash_fwd_cuda(q, k, v, **kw), 4 * pairs * width,
                          2 * qb + 2 * kvb + lseb, sdpa_fwd_ms(torch, q, k, v),
                          F.FWD_TILES[width]),
            "flash_bwd_dq": (lambda: F.flash_bwd_dq_cuda(q, k, v, out, do, lse, **kw),
                             6 * pairs * width, 4 * qb + 2 * kvb + lseb, library_bwd,
                             F.BWD_TILES[width]),
            "flash_bwd_dkv": (lambda: F.flash_bwd_dkv_cuda(q, k, v, out, do, lse, **kw),
                              8 * pairs * width, 3 * qb + 4 * kvb + lseb, library_bwd,
                              F.BWD_TILES[width]),
        }
        for name, (fn, flops, moved, library_ms, tiles) in forms.items():
            t = time_ms(torch, fn, iters=10)
            by_width[name][width] = {
                "ms": t, "tflops_per_s": flops / (t * 1e-3) / 1e12,
                "bound_ms": max(flops / BF16_FLOPS, moved / HBM_BYTES_PER_S) * 1e3,
                "library_ms": library_ms, "tiles": tiles}
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()

    # times at the train step's shape
    q, k, v, do = flash_inputs(torch, dev, b, h, h_kv, s, d, seed=10)
    kw = dict(causal=True, window=window)
    out, lse = F.flash_fwd_cuda(q, k, v, **kw)
    ms = {
        "flash_fwd": time_ms(torch, lambda: F.flash_fwd_cuda(q, k, v, **kw), iters=10),
        "flash_bwd_dq": time_ms(torch, lambda: F.flash_bwd_dq_cuda(q, k, v, out, do, lse, **kw),
                                iters=10),
        "flash_bwd_dkv": time_ms(
            torch, lambda: F.flash_bwd_dkv_cuda(q, k, v, out, do, lse, **kw), iters=10),
    }
    plain = {
        "flash_fwd": time_ms(torch, lambda: F.flash_fwd_reference(q, k, v, **kw), iters=2,
                             warmup=1),
    }
    # the plain backward computes dq, dk and dv together: its time stands
    # for both backward kernels
    plain["flash_bwd_dq"] = plain["flash_bwd_dkv"] = time_ms(
        torch, lambda: F.flash_bwd_reference(q, k, v, out, do, lse, **kw), iters=2, warmup=1)
    torch.cuda.empty_cache()
    library = sdpa_train_ms(torch, q, k, v, do)
    pairs = b * h * flash_pairs(s, True, window, None, None)
    el = q.element_size()
    qb, kvb, lseb = q.numel() * el, k.numel() * el, b * h * s * 4
    work = {  # (FLOPs, bytes: each input read once, each output written once)
        "flash_fwd": (4 * pairs * d, qb + 2 * kvb + qb + lseb),
        "flash_bwd_dq": (6 * pairs * d, 3 * qb + 2 * kvb + lseb + qb),
        "flash_bwd_dkv": (8 * pairs * d, 3 * qb + 2 * kvb + lseb + 2 * kvb),
    }
    records = {}
    for name, (flops, moved) in work.items():
        t_ops, t_bytes = flops / BF16_FLOPS, moved / HBM_BYTES_PER_S
        records[name] = {
            "name": name,
            "shape": {"b": b, "h": h, "h_kv": h_kv, "s": s, "d": d, "causal": True,
                      "window": window},
            "max_abs_err": max(errs[name].values()),
            "max_abs_err_by_case": errs[name],
            "tolerance": {"bf16": [BF16_ATOL, BF16_RTOL], "scaled_by": "max(1, max|ref|)",
                          "lse": [FLASH_LSE_ATOL, FP32_RTOL],
                          "tile_rel_frobenius": FLASH_TILE_RTOL if name in tile_errs else None},
            "tile_rel_frobenius_by_case": tile_errs.get(name),
            "ms": ms[name],
            "plain_ms": plain[name],
            "library_ms": library[name],
            "library": library["what"],
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops,
            "tflops_per_s": flops / (ms[name] * 1e-3) / 1e12,
        }
    records["flash_fwd"].update(tiles=F.FWD_TILES[d], by_width=by_width["flash_fwd"])
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        records[name].update(tiles=F.BWD_TILES[d], by_width=by_width[name])
    digests = flash_digests(torch, dev)
    if digests != FLASH_DIGESTS:
        raise AssertionError(f"flash kernels' digests {digests}, recorded {FLASH_DIGESTS}")
    for name in records:
        records[name]["digests"] = "equal to FLASH_DIGESTS"
    return records


# the flash kernels' ALiBi forms (BLOOM's rank-1 bias inside the same CTA
# bodies): each against its plain version with the flash tolerances
FLASH_ALIBI_KERNELS = ("flash_fwd_alibi", "flash_bwd_dq_alibi", "flash_bwd_dkv_alibi")


def alibi_cases(torch, dev, b=1, h=32, h_kv=8, s=4096, d=128, short=1024, train_s=None):
    """The ALiBi forms' cases, name -> dict(b, h, h_kv, s, d, causal, seg,
    pos): the timed shape (causal, BLOOM's slopes for h heads, positions
    arange), two packed segments whose positions restart at the cut, head
    dims 64 and 256, s 200 non-causal over two rows with positions of
    their own (the second offset by 37), and train_alibi's MHA shape."""
    base = dict(b=b, h=h, h_kv=h_kv, d=d, causal=True, seg=None, pos=None)
    cut = short * 389 // 1024
    restart = torch.cat([torch.arange(cut), torch.arange(short - cut)]).to(dev, torch.int32)
    cases = {f"s{s}_causal": dict(base, s=s),
             f"s{short}_segments2_positions_restart": dict(
                 base, s=short, seg=two_segments(torch, dev, b, short, cut),
                 pos=restart[None].expand(b, short))}
    for width in (64, 256):
        cases[f"d{width}_s{short}_causal"] = dict(base, s=short, d=width)
    rows = torch.arange(200, dtype=torch.int32, device=dev)
    cases["s200_noncausal"] = dict(base, b=2, s=200, causal=False,
                                   pos=torch.stack([rows, rows + 37]))
    # train_alibi's own shape: BLOOM-7b1's MHA (group 1) at its seq, packed
    # as ``packed_batch`` packs it (the cut at 3/8, positions restarting)
    ts = train_s or ALIBI_SEQ
    tcut = ts * 3 // 8
    tpos = torch.cat([torch.arange(tcut), torch.arange(ts - tcut)]).to(dev, torch.int32)
    cases[f"train_alibi_mha_s{ts}_packed"] = dict(
        base, b=1, h=h, h_kv=h, s=ts, seg=two_segments(torch, dev, 1, ts, tcut), pos=tpos[None])
    return cases


def check_alibi_case(torch, dev, errs, tile_errs, name, c, slopes, seed):
    """One case through the three ALiBi kernels against their plain
    versions, as ``check_flash_case``."""
    from deepspeed_tpu_torch.ops.attention import flash as F

    q, k, v, do = flash_inputs(torch, dev, c["b"], c["h"], c["h_kv"], c["s"], c["d"], seed=seed)
    alibi = F.alibi_operand(slopes, c["pos"], c["b"], c["h"], c["s"], dev)
    kw = dict(causal=c["causal"], segment_ids=c["seg"], alibi=alibi)
    out, lse = F.flash_fwd_cuda(q, k, v, **kw)
    ref_out, ref_lse = F.flash_fwd_reference(q, k, v, **kw)
    errs["flash_fwd_alibi"][name] = check_close(torch, f"flash_fwd_alibi {name}", out, ref_out,
                                                BF16_ATOL, BF16_RTOL)
    # lse is ~ slope * position here (thousands): FP32_RTOL of it is the
    # spacing of fp32 numbers of that size
    errs["flash_fwd_alibi"][name + "_lse"] = check_close(
        torch, f"flash_fwd_alibi lse {name}", lse, ref_lse, FLASH_LSE_ATOL, FP32_RTOL)
    del ref_out, ref_lse
    dq = F.flash_bwd_dq_cuda(q, k, v, out, do, lse, **kw)
    dk, dv = F.flash_bwd_dkv_cuda(q, k, v, out, do, lse, **kw)
    rdq, rdk, rdv = F.flash_bwd_reference(q, k, v, out, do, lse, **kw)
    for kname, got, want, tag in (("flash_bwd_dq_alibi", dq, rdq, name),
                                  ("flash_bwd_dkv_alibi", dk, rdk, name),
                                  ("flash_bwd_dkv_alibi", dv, rdv, name + "_dv")):
        hold(torch, errs, tile_errs, kname, tag, got, want)


def sdpa_bias_ms(torch, q, k, v, do, bias):
    """Yardsticks: ``scaled_dot_product_attention`` with a materialized
    float bias (ALiBi plus the causal mask, [1, h, s, s] in q's dtype)
    under the memory-efficient backend, kv heads repeated beforehand; the
    forward timed in a CUDA graph, its autograd backward (dq, dk and dv in
    one call) eagerly."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    group = q.shape[1] // k.shape[1]
    kr = k.repeat_interleave(group, dim=1)
    vr = v.repeat_interleave(group, dim=1)
    f = torch.nn.functional.scaled_dot_product_attention

    def fwd():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return f(q, kr, vr, attn_mask=bias)

    fwd_ms = time_ms(torch, fwd, iters=5)
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, kr, vr))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out = f(ql, kl, vl, attn_mask=bias)
    bwd_ms = eager_ms(torch, lambda: torch.autograd.grad(out, (ql, kl, vl), do,
                                                         retain_graph=True), iters=5)
    del out, ql, kl, vl, kr, vr
    torch.cuda.empty_cache()
    return {"flash_fwd_alibi": fwd_ms, "flash_bwd_dq_alibi": bwd_ms,
            "flash_bwd_dkv_alibi": bwd_ms}


def kernel_flash_alibi(torch, dev, b=1, h=32, h_kv=8, s=4096, d=128):
    """The three ALiBi kernels on ``alibi_cases`` (BLOOM's slopes for h
    heads), then timed at the first case's shape beside the no-ALiBi
    kernels on the same inputs, their plain versions and SDPA with a
    materialized float bias. The bound is the no-ALiBi kernels' (the term
    adds a multiply-add a pair). Returns one record per kernel."""
    from deepspeed_tpu_torch.models.transformer import alibi_slopes
    from deepspeed_tpu_torch.ops.attention import flash as F

    slopes = torch.from_numpy(alibi_slopes(h)).to(dev)
    errs = {name: {} for name in FLASH_ALIBI_KERNELS}
    tile_errs = {"flash_bwd_dq_alibi": {}, "flash_bwd_dkv_alibi": {}}
    for i, (name, c) in enumerate(alibi_cases(torch, dev, b, h, h_kv, s, d).items()):
        check_alibi_case(torch, dev, errs, tile_errs, name, c, slopes, seed=60 + i)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    q, k, v, do = flash_inputs(torch, dev, b, h, h_kv, s, d, seed=60)
    alibi = F.alibi_operand(slopes, None, b, h, s, dev)
    kw = dict(causal=True)
    out, lse = F.flash_fwd_cuda(q, k, v, alibi=alibi, **kw)
    out0, lse0 = F.flash_fwd_cuda(q, k, v, **kw)
    calls = {
        "flash_fwd_alibi": (lambda: F.flash_fwd_cuda(q, k, v, alibi=alibi, **kw),
                            lambda: F.flash_fwd_cuda(q, k, v, **kw)),
        "flash_bwd_dq_alibi": (
            lambda: F.flash_bwd_dq_cuda(q, k, v, out, do, lse, alibi=alibi, **kw),
            lambda: F.flash_bwd_dq_cuda(q, k, v, out0, do, lse0, **kw)),
        "flash_bwd_dkv_alibi": (
            lambda: F.flash_bwd_dkv_cuda(q, k, v, out, do, lse, alibi=alibi, **kw),
            lambda: F.flash_bwd_dkv_cuda(q, k, v, out0, do, lse0, **kw)),
    }
    ms, no_alibi_ms = {}, {}
    for name, (fn, fn0) in calls.items():  # in turns: ALiBi, none, ALiBi, none
        t = [time_ms(torch, f, iters=10) for f in (fn, fn0, fn, fn0)]
        ms[name], no_alibi_ms[name] = min(t[0], t[2]), min(t[1], t[3])
    plain = {"flash_fwd_alibi": time_ms(
        torch, lambda: F.flash_fwd_reference(q, k, v, alibi=alibi, **kw), iters=2, warmup=1)}
    plain["flash_bwd_dq_alibi"] = plain["flash_bwd_dkv_alibi"] = time_ms(
        torch, lambda: F.flash_bwd_reference(q, k, v, out, do, lse, alibi=alibi, **kw),
        iters=2, warmup=1)
    torch.cuda.empty_cache()
    pos = torch.arange(s, device=dev)
    bias = torch.where(pos[:, None] >= pos[None, :], slopes[:, None, None] * pos.float(),
                       float("-inf"))[None].to(q.dtype)
    library = sdpa_bias_ms(torch, q, k, v, do, bias)
    del bias
    torch.cuda.empty_cache()
    pairs = b * h * flash_pairs(s, True, 0, None, None)
    el = q.element_size()
    qb, kvb, lseb = q.numel() * el, k.numel() * el, b * h * s * 4
    ab = h * 4 + b * s * 4  # slopes and positions
    work = {
        "flash_fwd_alibi": (4 * pairs * d, qb + 2 * kvb + ab + qb + lseb),
        "flash_bwd_dq_alibi": (6 * pairs * d, 3 * qb + 2 * kvb + lseb + ab + qb),
        "flash_bwd_dkv_alibi": (8 * pairs * d, 3 * qb + 2 * kvb + lseb + ab + 2 * kvb),
    }
    records = {}
    for name, (flops, moved) in work.items():
        t_ops, t_bytes = flops / BF16_FLOPS, moved / HBM_BYTES_PER_S
        records[name] = {
            "name": name,
            "shape": {"b": b, "h": h, "h_kv": h_kv, "s": s, "d": d, "causal": True,
                      "slopes": f"BLOOM's for {h} heads"},
            "max_abs_err": max(errs[name].values()),
            "max_abs_err_by_case": errs[name],
            "tolerance": {"bf16": [BF16_ATOL, BF16_RTOL], "scaled_by": "max(1, max|ref|)",
                          "lse": [FLASH_LSE_ATOL, FP32_RTOL],
                          "tile_rel_frobenius": FLASH_TILE_RTOL if name in tile_errs else None},
            "tile_rel_frobenius_by_case": tile_errs.get(name),
            "ms": ms[name],
            "no_alibi_ms": no_alibi_ms[name],
            "plain_ms": plain[name],
            "library_ms": library[name],
            "library": "torch.nn.functional.scaled_dot_product_attention with a materialized "
                       "[1, h, s, s] bf16 bias, memory-efficient backend (backward: autograd, "
                       "dq+dk+dv in one call, eager)",
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops,
            "tflops_per_s": flops / (ms[name] * 1e-3) / 1e12,
        }
    return records


def sdpa_fwd_ms(torch, q, k, v):
    """``scaled_dot_product_attention``'s causal GQA forward under the
    flash backend in a CUDA graph, or None where that backend refuses the
    head dim (a yardstick only)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def fwd():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                             enable_gqa=True)

    try:
        fwd()
    except RuntimeError:
        return None
    return time_ms(torch, fwd, iters=10)


def sdpa_bwd_ms(torch, q, k, v, do):
    """The autograd backward (dq, dk and dv in one call, eager) of
    ``scaled_dot_product_attention``'s causal GQA forward under the flash
    backend, or None where that backend refuses the inputs (a yardstick
    only)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
    try:
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            out = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                                                   enable_gqa=True)
        torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True)
    except RuntimeError:
        return None
    return eager_ms(torch, lambda: torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True),
                    iters=10)


def sdpa_train_ms(torch, q, k, v, do):
    """Yardsticks: ``scaled_dot_product_attention`` (causal, GQA) under the
    flash backend (an error if that backend refuses the inputs); its
    forward timed in a CUDA graph, its autograd backward (dq, dk and dv in
    one call) timed eagerly."""
    bwd_ms = sdpa_bwd_ms(torch, q, k, v, do)
    if bwd_ms is None:
        raise RuntimeError("the SDPA flash backend refuses the train shape's inputs")
    return {"what": "torch.nn.functional.scaled_dot_product_attention, flash backend "
                    "(backward: autograd, dq+dk+dv in one call, eager)",
            "flash_fwd": sdpa_fwd_ms(torch, q, k, v), "flash_bwd_dq": bwd_ms,
            "flash_bwd_dkv": bwd_ms}


# flash carry kernels (the ring's chunk entries): each against its plain
# version on one hop, raw carry and finalized, with the flash tolerances.
# The raw carries: m (a max of fp32 logits) to FLASH_LSE_ATOL, l and the
# fp32 sums per 64-row tile (both round p or ds to bf16 against different
# running maxima).
CARRY_KERNELS = ("flash_fwd_chunk", "flash_dq_chunk", "flash_dkv_chunk")


def carry_case(torch, q, k, v, do, kw, errs=None, tile_errs=None, tag="case"):
    """One hop of each chunk kernel against its plain version: the carry
    going in is the plain version's over another seeded chunk (so the
    kernel loads a live state), the hop compared raw and finalized.
    ``kw``: causal (the diagonal) and segment_ids (a (query, key) pair or
    None). Returns {kernel tag: max abs err} and fills ``errs`` /
    ``tile_errs`` when given."""
    from deepspeed_tpu_torch.ops.attention import flash as F

    errs = errs if errs is not None else {n: {} for n in CARRY_KERNELS}
    tile_errs = tile_errs if tile_errs is not None else {n: {} for n in CARRY_KERNELS[1:]}
    b, h, s, d = q.shape
    gen = torch.Generator(device=q.device).manual_seed(s + d + int(kw["causal"]))
    k2, v2 = (torch.randn(*k.shape, generator=gen, device=q.device).to(k.dtype) for _ in "kv")
    q2, do2 = (torch.randn(*q.shape, generator=gen, device=q.device).to(q.dtype) for _ in "qd")
    seg = kw["segment_ids"]
    other = None if seg is None else (seg[0], seg[0])
    causal = kw["causal"]

    # forward: the carry of the other chunk, then this hop
    c0 = F.flash_fwd_chunk_reference(q, k2, v2, F.flash_carry_init(b, h, s, d, q.device),
                                     segment_ids=other)
    want = F.flash_fwd_chunk_reference(q, k, v, c0, causal=causal, segment_ids=seg)
    got = F.flash_fwd_chunk_cuda(q, k, v, tuple(t.clone() for t in c0), seg, causal)
    errs["flash_fwd_chunk"][tag + "_m"] = check_close(
        torch, f"flash_fwd_chunk {tag} m", got[0], want[0], FLASH_LSE_ATOL, FP32_RTOL)
    errs["flash_fwd_chunk"][tag + "_l"] = check_close(
        torch, f"flash_fwd_chunk {tag} l", got[1], want[1], BF16_ATOL, BF16_RTOL)
    errs["flash_fwd_chunk"][tag + "_acc_tile"] = tile_rel_err(
        torch, f"flash_fwd_chunk {tag} acc", got[2], want[2])
    out_w, lse_w = F.flash_finalize(want, q.dtype)
    out, lse = F.flash_fwd_chunk_cuda(q, k, v, tuple(t.clone() for t in c0), seg, causal,
                                      final=True)
    errs["flash_fwd_chunk"][tag + "_out"] = check_close(
        torch, f"flash_fwd_chunk {tag} out", out, out_w, BF16_ATOL, BF16_RTOL)
    errs["flash_fwd_chunk"][tag + "_lse"] = check_close(
        torch, f"flash_fwd_chunk {tag} lse", lse, lse_w, FLASH_LSE_ATOL, FP32_RTOL)
    del c0, want, got

    # dq: the raw sum over the other chunk, then this hop (out and lse of
    # this hop's finalize stand for the rows' global ones)
    a0 = F.flash_dq_chunk_reference(q, k2, v2, out_w, do, lse_w,
                                    torch.zeros(q.shape, device=q.device), segment_ids=other)
    want = F.flash_dq_chunk_reference(q, k, v, out_w, do, lse_w, a0, causal=causal,
                                      segment_ids=seg)
    got = F.flash_dq_chunk_cuda(q, k, v, out_w, do, lse_w, a0.clone(), seg, causal)
    hold(torch, errs, tile_errs, "flash_dq_chunk", tag + "_raw", got, want)
    sc = q.shape[-1] ** -0.5
    got = F.flash_dq_chunk_cuda(q, k, v, out_w, do, lse_w, a0.clone(), seg, causal, final=True)
    hold(torch, errs, tile_errs, "flash_dq_chunk", tag, got,
         F.flash_dq_finalize(want, sc, q.dtype))
    del a0, want, got

    # dk/dv: the home k/v; the raw sums over another visiting q chunk, then
    # this hop's visitor (q, out, do, lse)
    o2, l2 = F.flash_finalize(F.flash_fwd_chunk_reference(
        q2, k, v, F.flash_carry_init(b, h, s, d, q.device), segment_ids=other), q.dtype)
    zero = torch.zeros(k.shape, device=q.device)
    c0 = F.flash_dkv_chunk_reference(q2, k, v, o2, do2, l2, zero, zero.clone(),
                                     segment_ids=other)
    want = F.flash_dkv_chunk_reference(q, k, v, out_w, do, lse_w, *c0, causal=causal,
                                       segment_ids=seg)
    got = F.flash_dkv_chunk_cuda(q, k, v, out_w, do, lse_w, tuple(t.clone() for t in c0), seg,
                                 causal)
    hold(torch, errs, tile_errs, "flash_dkv_chunk", tag + "_raw_dk", got[0], want[0])
    hold(torch, errs, tile_errs, "flash_dkv_chunk", tag + "_raw_dv", got[1], want[1])
    got = F.flash_dkv_chunk_cuda(q, k, v, out_w, do, lse_w, tuple(t.clone() for t in c0), seg,
                                 causal, final=True)
    dk_w, dv_w = F.flash_dkv_finalize(*want, sc, k.dtype)
    hold(torch, errs, tile_errs, "flash_dkv_chunk", tag + "_dk", got[0], dk_w)
    hold(torch, errs, tile_errs, "flash_dkv_chunk", tag + "_dv", got[1], dv_w)
    return {f"{n} {t}": e for n, case in errs.items() for t, e in case.items()}


def kernel_flash_carry(torch, dev, b=1, h=32, h_kv=8, s=4096, d=128):
    """The three chunk kernels at Mistral-7B attention width (32/8 heads of
    128, bf16), home and visiting chunks of 4096: a non-diagonal hop and the
    diagonal hop, each with and without two packed segments; both hops at
    head dims 64 and 256 over chunks of 1024 (the kernels' other tile
    shapes), with and without segments; CUDA-graph
    times at the non-diagonal hop (a middle hop: the carry loaded and
    stored raw) beside the plain versions and the bound. Returns one record
    per kernel."""
    from deepspeed_tpu_torch.ops.attention import flash as F

    errs = {n: {} for n in CARRY_KERNELS}
    tile_errs = {n: {} for n in CARRY_KERNELS[1:]}
    for i, (name, causal, cut) in enumerate((("offdiag", False, None),
                                             ("offdiag_segments2", False, (1500, 2600)),
                                             ("diag", True, None),
                                             ("diag_segments2", True, (1500, 1500)))):
        q, k, v, do = flash_inputs(torch, dev, b, h, h_kv, s, d, seed=40 + i)
        seg = None
        if cut is not None:  # the home chunk's ids, the visitor's
            seg = (two_segments(torch, dev, b, s, cut[0]), two_segments(torch, dev, b, s, cut[1]))
        carry_case(torch, q, k, v, do, dict(causal=causal, segment_ids=seg), errs, tile_errs,
                   name)
        del q, k, v, do
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    # the kernels' other tile shapes: head dims 64 and 256, chunks of 1024
    for i, (width, causal, cut) in enumerate(((64, False, (300, 700)), (64, True, None),
                                             (256, False, None), (256, True, (300, 300)))):
        q, k, v, do = flash_inputs(torch, dev, b, h, h_kv, 1024, width, seed=50 + i)
        seg = None
        if cut is not None:
            seg = (two_segments(torch, dev, b, 1024, cut[0]),
                   two_segments(torch, dev, b, 1024, cut[1]))
        name = f"d{width}_{'diag' if causal else 'offdiag'}{'_segments2' if cut else ''}"
        carry_case(torch, q, k, v, do, dict(causal=causal, segment_ids=seg), errs, tile_errs,
                   name)
        del q, k, v, do
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    q, k, v, do = flash_inputs(torch, dev, b, h, h_kv, s, d, seed=40)
    out, lse = F.flash_fwd_reference(q, k, v, causal=False)
    carry = F.flash_fwd_chunk_cuda(q, k, v)
    dq_acc = F.flash_dq_chunk_cuda(q, k, v, out, do, lse)
    dkv = F.flash_dkv_chunk_cuda(q, k, v, out, do, lse)
    kw = dict(causal=False)
    ms = {
        "flash_fwd_chunk": time_ms(torch, lambda: F.flash_fwd_chunk_cuda(q, k, v, carry),
                                   iters=10),
        "flash_dq_chunk": time_ms(
            torch, lambda: F.flash_dq_chunk_cuda(q, k, v, out, do, lse, dq_acc), iters=10),
        "flash_dkv_chunk": time_ms(
            torch, lambda: F.flash_dkv_chunk_cuda(q, k, v, out, do, lse, dkv), iters=10),
    }
    c0 = F.flash_carry_init(b, h, s, d, dev)
    z = torch.zeros(k.shape, device=dev)
    plain = {
        "flash_fwd_chunk": time_ms(torch, lambda: F.flash_fwd_chunk_reference(q, k, v, c0, **kw),
                                   iters=2, warmup=1),
        "flash_dq_chunk": time_ms(torch, lambda: F.flash_dq_chunk_reference(
            q, k, v, out, do, lse, dq_acc, **kw), iters=2, warmup=1),
        "flash_dkv_chunk": time_ms(torch, lambda: F.flash_dkv_chunk_reference(
            q, k, v, out, do, lse, z, z, **kw), iters=2, warmup=1),
    }
    pairs = b * h * s * s
    el = q.element_size()
    qb, kvb, lseb = q.numel() * el, k.numel() * el, b * h * s * 4
    acc, kv_acc = q.numel() * 4, k.numel() * 4
    work = {  # (FLOPs, bytes: inputs read once, outputs written once, carries both)
        "flash_fwd_chunk": (4 * pairs * d, qb + 2 * kvb + 2 * (acc + 2 * lseb)),
        "flash_dq_chunk": (6 * pairs * d, 3 * qb + 2 * kvb + lseb + 2 * acc),
        "flash_dkv_chunk": (8 * pairs * d, 3 * qb + 2 * kvb + lseb + 2 * 2 * kv_acc),
    }
    records = {}
    for name, (flops, moved) in work.items():
        t_ops, t_bytes = flops / BF16_FLOPS, moved / HBM_BYTES_PER_S
        records[name] = {
            "name": name,
            "shape": {"b": b, "h": h, "h_kv": h_kv, "chunk": s, "d": d, "hop": "non-diagonal",
                      "carry": "loaded and stored raw"},
            "max_abs_err": max(v for t, v in errs[name].items() if not t.endswith("_tile")),
            "max_abs_err_by_case": errs[name],
            "tolerance": {"bf16": [BF16_ATOL, BF16_RTOL], "scaled_by": "max(1, max|ref|)",
                          "m_and_lse": [FLASH_LSE_ATOL, FP32_RTOL],
                          "tile_rel_frobenius": FLASH_TILE_RTOL},
            "tile_rel_frobenius_by_case": tile_errs.get(name),
            "ms": ms[name],
            "plain_ms": plain[name],
            "library_ms": None,
            "library": "none: no one PyTorch call carries a raw softmax state or raw "
                       "gradient sums from chunk to chunk",
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops,
            "tflops_per_s": flops / (ms[name] * 1e-3) / 1e12,
        }
    records["flash_fwd_chunk"]["tiles"] = F.FWD_TILES[d]
    records["flash_dq_chunk"]["tiles"] = records["flash_dkv_chunk"]["tiles"] = F.BWD_TILES[d]
    return records


def ring_against_flash(torch, q, k, v, do):
    """``attention(impl="flash_ring")`` forward and backward on the current
    (loopback) topology against the single flash call on the same inputs.
    On a card out, lse, dq, dk and dv (with GQA too: dk/dv walk query tiles
    outer and the group's heads inner in both forms) must be the single
    kernels' bits and every carry kernel launches exactly N(N + 1) / 2 times
    in the ring call, nothing else. On the CPU (a rehearsal: plain versions
    on both sides) fp32 tolerances stand in for bits. Returns the verdicts
    and the ring call's launch counts."""
    from deepspeed_tpu_torch.ops import kernels as K
    from deepspeed_tpu_torch.ops.attention import flash as F
    from deepspeed_tpu_torch.ops.attention import sharded as S
    from deepspeed_tpu_torch.ops.attention.core import attention
    from deepspeed_tpu_torch.parallel.topology import get_topology

    dev = q.device
    exact = dev.type == "cuda"
    n = get_topology().context_parallel_size
    chunk, d = q.shape[2] // n, q.shape[3]
    if exact and not S.ring_matches_flash(chunk, d):
        raise AssertionError(f"ring chunks of {chunk} rows at d {d} straddle the kernels' "
                             f"tiles: the ring promises no bits there")
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    single = F.flash_attention(*leaves)
    s_grads = torch.autograd.grad(single, leaves, do)
    s_lse = (F.flash_fwd_cuda if exact else F.flash_fwd_reference)(q, k, v)[1]
    _sync(torch, dev)
    K.reset_counts()
    ring = attention(*leaves, impl="flash_ring")
    r_grads = torch.autograd.grad(ring, leaves, do)
    _sync(torch, dev)
    launches = {name: c for name, c in K.counts().items() if c}
    ring_obj = S.loopback_ring(n)
    r_lse = torch.cat(S.ring_forward(ring_obj, *(list(x.chunk(n, 2)) for x in (q, k, v)),
                                     [None] * n, None)[1], dim=2)
    res = {"n": n, "launches": launches}
    pairs = (("out", ring, single), ("lse", r_lse, s_lse), ("dq", r_grads[0], s_grads[0]),
             ("dk", r_grads[1], s_grads[1]), ("dv", r_grads[2], s_grads[2]))
    for what, got, want in pairs:
        got, want = got.detach(), want.detach()
        same = bool(torch.equal(got, want))
        res[f"{what}_bitwise"] = same
        res[f"{what}_max_abs_err"] = float((got.float() - want.float()).abs().max())
        if exact and not same:
            raise AssertionError(f"ring {what} is not the single flash kernel's bits: {res}")
        elif not exact:
            check_close(torch, f"ring {what}", got, want, FP32_ATOL, FP32_RTOL)
    if exact:
        hops = n * (n + 1) // 2
        want_launches = {name: hops for name in CARRY_KERNELS}
        if launches != want_launches:
            raise AssertionError(f"ring call launches {launches}, expected {want_launches}")
    return res


# splash kernels: the flash kernels' tolerances (the same mainloop and the
# same roundings against a plain version over the schedule's token mask)
SPLASH_KERNELS = ("splash_fwd", "splash_bwd_dq", "splash_bwd_dkv")
# the timed leg's shape: Mistral's window over 16384 tokens in 512-blocks
SPLASH_TIMED = dict(s=16384, window=4096, block=512)


def splash_cases(torch, dev, s=4096, h=32, h_kv=8):
    """(name, schedule, segment ids or None, kv heads) for the kernels
    phase: (a) a LocalMask of 1024 in 512-blocks, (b) per-head Fixed layouts
    in 128-blocks (causal), (c) (a) with two packed segments as runtime ids,
    (d) a causal layout of 512-blocks with two dead query blocks, (f) (a)'s
    mask in 64-blocks (a 128-key tile spans two kv blocks; each consumer
    warpgroup of a 128-row forward or dq CTA reads its own schedule row),
    (g) (b) in 64-blocks (a dk/dv CTA merges two blocks of each of its GQA
    group's heads), (h) (g)'s schedule over one kv head (h rows a GQA
    group: at h 32 a dk/dv CTA merges 64 rows of the transposed schedule).
    All at ``h_kv`` kv heads but (h)."""
    import numpy as np

    from deepspeed_tpu_torch.ops.sparse_attention import (
        FixedSparsityConfig,
        LocalMask,
        schedule_from_layout,
        schedule_from_mask,
    )

    local = schedule_from_mask(LocalMask((s, s), 1024), 512)
    fixed = FixedSparsityConfig(num_heads=h, block=128, different_layout_per_head=True,
                                num_different_global_patterns=4,
                                attention="unidirectional").make_schedule(s)
    layout = np.tril(np.ones((s // 512, s // 512), np.int32))
    layout[2:4] = 0  # query blocks 2 and 3 keep nothing
    dead = schedule_from_layout(layout, 512, causal=True)
    fixed64 = FixedSparsityConfig(num_heads=h, block=64, different_layout_per_head=True,
                                  num_different_global_patterns=4,
                                  attention="unidirectional").make_schedule(s)
    return [("a_local1024_b512", local, None, h_kv),
            ("b_fixed_per_head_b128", fixed, None, h_kv),
            ("c_local1024_b512_segments2", local, two_segments(torch, dev, 1, s, 1500), h_kv),
            ("d_dead_rows_b512", dead, None, h_kv),
            ("f_local1024_b64", schedule_from_mask(LocalMask((s, s), 1024), 64), None, h_kv),
            ("g_fixed_per_head_b64", fixed64, None, h_kv),
            ("h_fixed_per_head_b64_kv1", fixed64, None, 1)]


def splash_work(schedule, b, h, h_kv, d, segment_ids=None):
    """(kept pairs, FLOPs fwd/dq/dkv, bytes fwd/dq/dkv) the three kernels
    need for these inputs: 4d / 6d / 8d FLOPs per kept pair, each input
    read once and each output written once (q, o, do, dq at h heads and k,
    v, dk, dv at h_kv heads in bf16, lse in fp32)."""
    import numpy as np

    from deepspeed_tpu_torch.ops.sparse_attention.splash import _status

    status = _status(schedule)
    sq, sk, bq, bk = schedule.seq_q, schedule.seq_kv, schedule.block_q, schedule.block_kv
    q = np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    pred = np.ones((sq, sk), bool)
    if schedule.causal:
        pred &= q >= k
    if schedule.window:
        pred &= (q - k) < schedule.window
    pairs = 0
    for hs in range(status.shape[0]):
        st = status[hs][np.arange(sq)[:, None] // bq, np.arange(sk)[None, :] // bk]
        keep = (st == 2) | ((st == 1) & pred)
        if segment_ids is not None:
            for row in segment_ids.cpu().numpy():
                pairs += int((keep & (row[:, None] == row[None, :])).sum())
        else:
            pairs += int(keep.sum()) * b
    if status.shape[0] == 1:
        pairs *= h
    qb = b * h * sq * d * 2
    kvb = b * h_kv * sk * d * 2
    lseb = b * h * sq * 4
    flops = {"splash_fwd": 4 * pairs * d, "splash_bwd_dq": 6 * pairs * d,
             "splash_bwd_dkv": 8 * pairs * d}
    moved = {"splash_fwd": qb + 2 * kvb + qb + lseb,
             "splash_bwd_dq": 3 * qb + 2 * kvb + lseb + qb,
             "splash_bwd_dkv": 3 * qb + 2 * kvb + lseb + 2 * kvb}
    return pairs, flops, moved


def check_splash(torch, errs, tile_errs, name, q, k, v, do, sched, seg=None):
    """The three splash kernels against their plain versions on these
    inputs: out and lse, then dq, dk and dv (elementwise, scaled by the
    reference's largest element, and per 64-row tile); records each error
    in ``errs`` / ``tile_errs`` under ``name`` and raises on a miss.
    Returns the kernel's (out, lse)."""
    from deepspeed_tpu_torch.ops.sparse_attention import splash as SP

    out, lse = SP.splash_fwd_cuda(q, k, v, sched, segment_ids=seg)
    ref_out, ref_lse = SP.splash_fwd_reference(q, k, v, sched, segment_ids=seg)
    errs["splash_fwd"][name] = check_close(torch, f"splash_fwd {name}", out, ref_out,
                                           BF16_ATOL, BF16_RTOL)
    errs["splash_fwd"][name + "_lse"] = check_close(
        torch, f"splash_fwd lse {name}", lse, ref_lse, FLASH_LSE_ATOL, FP32_RTOL)
    del ref_out, ref_lse
    dq = SP.splash_bwd_dq_cuda(q, k, v, out, do, lse, sched, segment_ids=seg)
    dk, dv = SP.splash_bwd_dkv_cuda(q, k, v, out, do, lse, sched, segment_ids=seg)
    rdq, rdk, rdv = SP.splash_bwd_reference(q, k, v, out, do, lse, sched, segment_ids=seg)
    for kname, got, want, tag in (("splash_bwd_dq", dq, rdq, name),
                                  ("splash_bwd_dkv", dk, rdk, name),
                                  ("splash_bwd_dkv", dv, rdv, name + "_dv")):
        hold(torch, errs, tile_errs, kname, tag, got, want)
    del dq, dk, dv, rdq, rdk, rdv
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out, lse


def splash_against_flash(torch, q, k, v, out, do, lse, sched, window):
    """The three splash kernels over a LocalMask schedule shared by every
    head against the flash kernels with the same causal window: ``out`` and
    ``lse`` (splash's) against the flash forward's on the same q, k, v;
    splash dq, dk and dv against flash dq and dk/dv, all fed splash's out,
    lse and the same dO. Equal as values: the splash walks visit flash's key
    tiles (forward, dq) and a superset of its query tiles (dk/dv, whose
    extra tiles add exactly 0), in flash's order, with the same arithmetic.
    Raises on any element that differs."""
    from deepspeed_tpu_torch.ops.attention import flash as F
    from deepspeed_tpu_torch.ops.sparse_attention import splash as SP

    kw = dict(causal=True, window=window)
    fout, flse = F.flash_fwd_cuda(q, k, v, **kw)
    dq = SP.splash_bwd_dq_cuda(q, k, v, out, do, lse, sched)
    fdq = F.flash_bwd_dq_cuda(q, k, v, out, do, lse, **kw)
    dk, dv = SP.splash_bwd_dkv_cuda(q, k, v, out, do, lse, sched)
    fdk, fdv = F.flash_bwd_dkv_cuda(q, k, v, out, do, lse, **kw)
    for kname, name, got, want in (("splash_fwd", "out", out, fout),
                                   ("splash_fwd", "lse", lse, flse),
                                   ("splash_bwd_dq", "dq", dq, fdq),
                                   ("splash_bwd_dkv", "dk", dk, fdk),
                                   ("splash_bwd_dkv", "dv", dv, fdv)):
        differ = int((got != want).sum())
        if differ:
            raise AssertionError(f"{kname} {name}: {differ} elements differ from flash "
                                 f"with the same window {window}")
    del fout, flse, dq, fdq, dk, dv, fdk, fdv
    return {"out": "equal", "lse": "equal", "dq": "equal", "dk": "equal", "dv": "equal",
            "window": window}


def splash_timings(torch, dev, b, h, h_kv, d, s, window, block, seed, errs, tile_errs):
    """The three kernels held against their plain versions on the inputs
    they are timed on (``check_splash``, case ``timed_s{s}_w{window}``);
    then CUDA-graph times of the kernels, their plain versions, the port's
    flash kernels with the same static window (the same function for a
    LocalMask) and, as a yardstick, SDPA with the boolean token mask;
    beside each kernel its bound for these inputs."""
    from deepspeed_tpu_torch.ops.attention import flash as F
    from deepspeed_tpu_torch.ops.sparse_attention import LocalMask, schedule_from_mask
    from deepspeed_tpu_torch.ops.sparse_attention import splash as SP

    sched = schedule_from_mask(LocalMask((s, s), window), block)
    q, k, v, do = flash_inputs(torch, dev, b, h, h_kv, s, d, seed)
    out, lse = check_splash(torch, errs, tile_errs, f"timed_s{s}_w{window}", q, k, v, do, sched)
    against_flash = splash_against_flash(torch, q, k, v, out, do, lse, sched, window)
    args = (q, k, v, out, do, lse, sched)
    ms = {"splash_fwd": time_ms(torch, lambda: SP.splash_fwd_cuda(q, k, v, sched), iters=10),
          "splash_bwd_dq": time_ms(torch, lambda: SP.splash_bwd_dq_cuda(*args), iters=10),
          "splash_bwd_dkv": time_ms(torch, lambda: SP.splash_bwd_dkv_cuda(*args), iters=10)}
    plain = {"splash_fwd": time_ms(torch, lambda: SP.splash_fwd_reference(q, k, v, sched),
                                   iters=2, warmup=1)}
    # the plain backward computes dq, dk and dv together: its time stands for both
    plain["splash_bwd_dq"] = plain["splash_bwd_dkv"] = time_ms(
        torch, lambda: SP.splash_bwd_reference(*args), iters=2, warmup=1)
    torch.cuda.empty_cache()
    kw = dict(causal=True, window=window)
    fout, flse = F.flash_fwd_cuda(q, k, v, **kw)
    flash = {"splash_fwd": time_ms(torch, lambda: F.flash_fwd_cuda(q, k, v, **kw), iters=10),
             "splash_bwd_dq": time_ms(
                 torch, lambda: F.flash_bwd_dq_cuda(q, k, v, fout, do, flse, **kw), iters=10),
             "splash_bwd_dkv": time_ms(
                 torch, lambda: F.flash_bwd_dkv_cuda(q, k, v, fout, do, flse, **kw), iters=10)}
    del fout, flse
    lib = sdpa_masked_ms(torch, q, k, v, do, window)
    pairs, flops, moved = splash_work(sched, b, h, h_kv, d)
    rec = {}
    for name in SPLASH_KERNELS:
        t_ops, t_bytes = flops[name] / BF16_FLOPS, moved[name] / HBM_BYTES_PER_S
        rec[name] = {"shape": {"b": b, "h": h, "h_kv": h_kv, "s": s, "d": d, "window": window,
                               "block": block, "density": sched.density},
                     "ms": ms[name], "plain_ms": plain[name], "flash_ms": flash[name],
                     "library_ms": lib[name], "bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "kept_pairs": pairs, "flops": flops[name],
                     "tflops_per_s": flops[name] / (ms[name] * 1e-3) / 1e12,
                     "against_flash": against_flash}
    del q, k, v, do, out, lse
    torch.cuda.empty_cache()
    return rec


def sdpa_masked_ms(torch, q, k, v, do, window):
    """Yardsticks: ``scaled_dot_product_attention`` with the boolean token
    mask of the causal window under the memory-efficient backend (kv heads
    repeated beforehand, outside the timed region); forward timed in a CUDA
    graph, its autograd backward (dq, dk and dv in one call) eagerly."""
    s = q.shape[2]
    group = q.shape[1] // k.shape[1]
    kr = k.repeat_interleave(group, dim=1)
    vr = v.repeat_interleave(group, dim=1)
    pos = torch.arange(s, device=q.device)
    mask = ((pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window))[None, None]
    from torch.nn.attention import SDPBackend, sdpa_kernel

    f = torch.nn.functional.scaled_dot_product_attention

    def fwd():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):  # never a dense [h, s, s] fallback
            return f(q, kr, vr, attn_mask=mask)

    fwd_ms = time_ms(torch, fwd, iters=5)
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, kr, vr))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out = f(ql, kl, vl, attn_mask=mask)
    bwd_ms = eager_ms(torch, lambda: torch.autograd.grad(out, (ql, kl, vl), do,
                                                         retain_graph=True), iters=5)
    del out, ql, kl, vl, kr, vr
    torch.cuda.empty_cache()
    return {"splash_fwd": fwd_ms, "splash_bwd_dq": bwd_ms, "splash_bwd_dkv": bwd_ms}


def kernel_splash(torch, dev, b=1, h=32, h_kv=8, d=128, s=4096, timed=SPLASH_TIMED):
    """The three splash kernels against their plain versions in bf16 at
    Mistral-7B's heads (32/8 of 128): cases (a)-(d) and (f)-(h) of
    ``splash_cases`` at s 4096 (forward, lse, dq, dk, dv; gradients also per
    64-row tile), and
    (e) the prefill form (forward) for t in {1, 8, 256} at starts {0, 3000,
    7936} over S 8192, window 4096, 128-key blocks (a 128-row CTA over a
    chunk of 1 or 8 rows: its query map reads zeros past them, and a row
    stored past t would land in the next head's rows, which are held too).
    Then, each on the inputs it is timed on, checked as (a)-(d) and timed:
    (a)'s shape and the timed leg's; at both, out, lse, dq, dk and dv also
    against the flash kernels with the same window, as values
    (``splash_against_flash``). Returns one record per kernel."""
    from deepspeed_tpu_torch.ops.sparse_attention import splash as SP

    errs = {n: {} for n in SPLASH_KERNELS}
    tile_errs = {"splash_bwd_dq": {}, "splash_bwd_dkv": {}}
    for i, (name, sched, seg, kv_heads) in enumerate(splash_cases(torch, dev, s, h, h_kv)):
        q, k, v, do = flash_inputs(torch, dev, b, h, kv_heads, s, d, seed=50 + i)
        out, lse = check_splash(torch, errs, tile_errs, name, q, k, v, do, sched, seg)
        if name.startswith("d_"):
            if bool(out[:, :, 1024:2048].float().abs().max() != 0):
                raise AssertionError("splash_fwd: the dead query blocks must give exactly 0")
            if bool((lse[:, :, 1024:2048] != -1e30).any()):
                raise AssertionError("splash_fwd: the dead rows' lse must be -1e30")
        del q, k, v, do, out, lse

    # (e) the prefill form: one schedule row from the chunk start
    S, window, bk = 8192, 4096, 128
    gen = torch.Generator(device=dev).manual_seed(60)
    k = torch.randn(b, h_kv, S, d, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(b, h_kv, S, d, generator=gen, device=dev).to(torch.bfloat16)
    visits = {}
    for t in (1, 8, 256):
        q = torch.randn(b, h, t, d, generator=gen, device=dev).to(torch.bfloat16)
        for start in (0, 3000, 7936):
            sched = SP.prefill_schedule(start, t, S, window, bk)
            got, lse = SP.splash_fwd_cuda(q, k, v, sched, base=start)
            want, ref_lse = SP.splash_fwd_reference(q, k, v, sched, base=start)
            tag = f"e_prefill_t{t}_start{start}"
            errs["splash_fwd"][tag] = check_close(torch, f"splash_fwd {tag}", got, want,
                                                  BF16_ATOL, BF16_RTOL)
            check_close(torch, f"splash_fwd lse {tag}", lse, ref_lse, FLASH_LSE_ATOL, FP32_RTOL)
            if SP.splash_prefill_attention(q, k, v, start, window=window, block_kv=bk).ne(
                    got).any():
                raise AssertionError(f"splash_prefill_attention {tag}: not the kernel's output")
            visits[tag] = sched.num_active
    del k, v
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # times: (a) and the timed leg's shape
    at_a = splash_timings(torch, dev, b, h, h_kv, d, s, 1024, 512, 70, errs, tile_errs)
    at_timed = splash_timings(torch, dev, b, h, h_kv, d, timed["s"], timed["window"],
                              timed["block"], 71, errs, tile_errs)
    records = {}
    for name in SPLASH_KERNELS:
        main = at_timed[name]
        records[name] = {
            "name": name,
            "shape": main["shape"],
            "max_abs_err": max(errs[name].values()),
            "max_abs_err_by_case": errs[name],
            "tolerance": {"bf16": [BF16_ATOL, BF16_RTOL], "scaled_by": "max(1, max|ref|)",
                          "lse": [FLASH_LSE_ATOL, FP32_RTOL],
                          "tile_rel_frobenius": FLASH_TILE_RTOL if name in tile_errs else None},
            "tile_rel_frobenius_by_case": tile_errs.get(name),
            "prefill_blocks_visited": visits if name == "splash_fwd" else None,
            **{key: main[key] for key in ("ms", "plain_ms", "flash_ms", "library_ms",
                                          "bound_ms", "bound_by", "flops", "tflops_per_s")},
            "library": "torch.nn.functional.scaled_dot_product_attention with the boolean "
                       "token mask, memory-efficient backend (kv heads repeated; backward: "
                       "autograd, dq+dk+dv in one call, eager)",
            "at_a": at_a[name],
            "against_flash": at_timed[name]["against_flash"],
        }
    return records


# layout-predicate sparse kernels: the flash kernels' tolerances (the same
# tile bodies and roundings, against a plain version over the layout's token
# mask)
SPARSE_KERNELS = ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")
# the sparse_attn phase's layout: Fixed, 128-blocks, 4 local and 1 global
# block per window, unidirectional, over Mistral-7B's attention (32 query
# heads, 8 kv heads expanded to 32, head_dim 128, bf16) at 16384 tokens
SPARSE_TIMED = dict(s=16384, block=128, num_local_blocks=4, num_global_blocks=1)


def sparse_fixed(h, block=SPARSE_TIMED["block"], num_local_blocks=SPARSE_TIMED["num_local_blocks"],
                 num_global_blocks=SPARSE_TIMED["num_global_blocks"]):
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig

    return FixedSparsityConfig(num_heads=h, block=block, num_local_blocks=num_local_blocks,
                               num_global_blocks=num_global_blocks, attention="unidirectional")


def sparse_cases(h=32, s=4096):
    """(name, layout [h, nb, nb] int32, block, causal) of the kernels group:
    (a) Fixed in 16-blocks (a 64-row tile spans 4 x 4 layout blocks),
    causal; (b) BigBird in 64-blocks, bidirectional, a layout per head
    (random blocks above the diagonal); (c) a causal layout in 64-blocks
    whose query block 1 keeps only key block 2 (its rows are dead) and whose
    query block 5 keeps nothing; (d) the dense layout in 128-blocks,
    bidirectional; (e) the sparse_attn phase's Fixed layout (128-blocks,
    causal); (f) the causal triangle in 128-blocks (every block on and
    below the diagonal). At d 128 the forward's 128-key tiles take the
    per-column form over (a)-(c), the scalar one over (d)-(f)."""
    import numpy as np

    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig

    dead = np.tril(np.ones((h, s // 64, s // 64), np.int32))
    dead[:, 1] = 0
    dead[:, 1, 2] = 1
    dead[:, 5] = 0
    return [
        ("a_fixed_b16_causal", sparse_fixed(h, 16, 4, 1).make_layout(s), 16, True),
        ("b_bigbird_b64_per_head", BigBirdSparsityConfig(
            num_heads=h, block=64, different_layout_per_head=True, num_random_blocks=2,
            num_sliding_window_blocks=3, num_global_blocks=1, seed=1).make_layout(s), 64, False),
        ("c_dead_rows_b64_causal", dead, 64, True),
        ("d_dense_b128", np.ones((h, s // 128, s // 128), np.int32), 128, False),
        ("e_fixed_b128_causal", sparse_fixed(h).make_layout(s), 128, True),
        ("f_tril_b128_causal", np.tril(np.ones((h, s // 128, s // 128), np.int32)), 128, True),
    ]


def sparse_work(layout, block, causal, b, h, s, d):
    """(kept pairs, FLOPs fwd/dq/dkv, bytes fwd/dq/dkv) the three kernels
    need for these inputs. A kept block holds block^2 pairs; when causal a
    kept diagonal block holds block * (block + 1) / 2 and one above the
    diagonal none. 4d / 6d / 8d FLOPs per kept pair, each input read once
    and each output written once (q, k, v, o, do, dq, dk, dv [b, h, s, d]
    bf16, lse fp32, the int32 layout)."""
    import numpy as np

    lay = np.asarray(layout) != 0
    if causal:
        nb = lay.shape[1]
        below = np.tril(np.ones((nb, nb), bool), -1)
        pairs = (int((lay & below).sum()) * block * block
                 + int((lay & np.eye(nb, dtype=bool)).sum()) * block * (block + 1) // 2) * b
    else:
        pairs = int(lay.sum()) * block * block * b
    t = b * h * s * d * 2
    lseb = b * h * s * 4
    layb = np.asarray(layout).size * 4
    flops = {"sparse_fwd": 4 * pairs * d, "sparse_bwd_dq": 6 * pairs * d,
             "sparse_bwd_dkv": 8 * pairs * d}
    moved = {"sparse_fwd": 3 * t + layb + t + lseb,
             "sparse_bwd_dq": 5 * t + lseb + layb + t,
             "sparse_bwd_dkv": 5 * t + lseb + layb + 2 * t}
    return pairs, flops, moved


def check_sparse(torch, errs, tile_errs, name, q, k, v, do, layout, block, causal):
    """The three sparse kernels against their plain versions on these
    inputs (heads matched): out (elementwise and per 64-row tile) and lse,
    then dq, dk and dv (elementwise, scaled by the reference's largest
    element, and per 64-row tile); records each error under ``name`` and
    raises on a miss. Returns the kernels' (out, lse, dq, dk, dv)."""
    from deepspeed_tpu_torch.ops.sparse_attention import sparse as SA

    out, lse = SA.sparse_fwd_cuda(q, k, v, layout, block, causal)
    ref_out, ref_lse = SA.sparse_fwd_reference(q, k, v, layout, block, causal)
    errs["sparse_fwd"][name] = check_close(torch, f"sparse_fwd {name}", out, ref_out,
                                           BF16_ATOL, BF16_RTOL)
    tile_errs["sparse_fwd"][name] = tile_rel_err(torch, f"sparse_fwd {name}", out, ref_out)
    errs["sparse_fwd"][name + "_lse"] = check_close(
        torch, f"sparse_fwd lse {name}", lse, ref_lse, FLASH_LSE_ATOL, FP32_RTOL)
    del ref_out, ref_lse
    dq = SA.sparse_bwd_dq_cuda(q, k, v, out, do, lse, layout, block, causal)
    dk, dv = SA.sparse_bwd_dkv_cuda(q, k, v, out, do, lse, layout, block, causal)
    rdq, rdk, rdv = SA.sparse_bwd_reference(q, k, v, out, do, lse, layout, block, causal)
    for kname, got, want, tag in (("sparse_bwd_dq", dq, rdq, name),
                                  ("sparse_bwd_dkv", dk, rdk, name),
                                  ("sparse_bwd_dkv", dv, rdv, name + "_dv")):
        hold(torch, errs, tile_errs, kname, tag, got, want)
    del rdq, rdk, rdv
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out, lse, dq, dk, dv


def splash_against_sparse(torch, errs, name, q, k, v, do, layout, block, causal, got):
    """The splash oracle: the splash kernels over ``schedule_from_layout``
    of the same layout, on the same inputs, held against the sparse
    kernels' (out, lse, dq, dk, dv) ``got`` (elementwise and per tile).
    The two backward runs share the flash CTA bodies, so for dq, dk and dv
    this holds two walks (a schedule's, the layout's) over one body; the
    body itself is held by each kernel's plain version and the flash
    digests."""
    from deepspeed_tpu_torch.ops.sparse_attention import schedule_from_layout
    from deepspeed_tpu_torch.ops.sparse_attention import splash as SP

    sched = schedule_from_layout(layout.cpu().numpy(), block, causal=causal)
    out, lse = SP.splash_fwd_cuda(q, k, v, sched)
    dq = SP.splash_bwd_dq_cuda(q, k, v, out, do, lse, sched)
    dk, dv = SP.splash_bwd_dkv_cuda(q, k, v, out, do, lse, sched)
    tiles = {n: {} for n in SPARSE_KERNELS}
    for kname, mine, theirs, tag in (("sparse_fwd", got[0], out, "out"),
                                     ("sparse_bwd_dq", got[2], dq, "dq"),
                                     ("sparse_bwd_dkv", got[3], dk, "dk"),
                                     ("sparse_bwd_dkv", got[4], dv, "dv")):
        hold(torch, errs, tiles, kname, f"{name}_splash_{tag}", theirs, mine)
    check_close(torch, f"splash lse {name}", lse, got[1], FLASH_LSE_ATOL, FP32_RTOL)
    del out, lse, dq, dk, dv
    torch.cuda.synchronize()


def flash_against_sparse(torch, errs, name, q, k, v, do, got, causal):
    """A layout that keeps every block (the dense one, or the causal
    triangle): the port's flash kernels on the same inputs held against the
    sparse kernels' outputs ``got``; on a card the sparse forward's out and
    lse must equal the flash forward's as values (the same tiles in the
    same order through the same body; the plain versions on the CPU differ
    in their arithmetic). Returns whether that was held."""
    from deepspeed_tpu_torch.ops.attention import flash as F

    out, lse = F.flash_fwd_cuda(q, k, v, causal=causal)
    check_close(torch, f"flash lse {name}", lse, got[1], FLASH_LSE_ATOL, FP32_RTOL)
    if q.is_cuda and not (torch.equal(got[0], out) and torch.equal(got[1], lse)):
        raise AssertionError(f"sparse_fwd {name}: out and lse must equal the flash forward's "
                             f"(out differs at {int((got[0] != out).sum())} elements, lse at "
                             f"{int((got[1] != lse).sum())} rows)")
    dq = F.flash_bwd_dq_cuda(q, k, v, out, do, lse, causal=causal)
    dk, dv = F.flash_bwd_dkv_cuda(q, k, v, out, do, lse, causal=causal)
    tiles = {n: {} for n in SPARSE_KERNELS}
    for kname, mine, theirs, tag in (("sparse_fwd", got[0], out, "out"),
                                     ("sparse_bwd_dq", got[2], dq, "dq"),
                                     ("sparse_bwd_dkv", got[3], dk, "dk"),
                                     ("sparse_bwd_dkv", got[4], dv, "dv")):
        hold(torch, errs, tiles, kname, f"{name}_flash_{tag}", theirs, mine)
    del out, lse, dq, dk, dv
    torch.cuda.synchronize()
    return q.is_cuda


def sparse_case_checks(torch, dev, b=1, h=32, d=128, s=4096):
    """The kernels group's checks at s 4096 (``sparse_cases``): each case
    against the plain versions; the dead rows exactly 0 (lse -1e30, finite
    gradients); the dense and the causal-triangle cases also against the
    flash kernels, the forward's out and lse equal to flash's; the Fixed
    (128-block) and BigBird cases also against the splash kernels over the
    same layout (the splash oracle). Returns (errs, tile_errs, oracle
    counts)."""
    errs = {n: {} for n in SPARSE_KERNELS}
    tile_errs = {n: {} for n in SPARSE_KERNELS}
    oracle = {"splash": [], "flash": [], "fwd_equal_flash": []}
    for i, (name, layout, block, causal) in enumerate(sparse_cases(h, s)):
        lay = torch.as_tensor(layout, dtype=torch.int32, device=dev)
        q, k, v, do = flash_inputs(torch, dev, b, h, h, s, d, seed=80 + i)
        got = check_sparse(torch, errs, tile_errs, name, q, k, v, do, lay, block, causal)
        if name.startswith("c_"):
            rows = torch.cat([torch.arange(64, 128), torch.arange(320, 384)]).to(dev)
            if bool(got[0][:, :, rows].float().abs().max() != 0):
                raise AssertionError("sparse_fwd: the dead rows must give exactly 0")
            if bool((got[1][:, :, rows] != -1e30).any()):
                raise AssertionError("sparse_fwd: the dead rows' lse must be -1e30")
            if bool(got[2][:, :, rows].float().abs().max() != 0):
                raise AssertionError("sparse_bwd_dq: the dead rows' dq must be exactly 0")
            if not all(bool(torch.isfinite(g).all()) for g in got[2:]):
                raise AssertionError("sparse backward: non-finite gradients")
        if name.startswith(("d_", "f_")):
            if flash_against_sparse(torch, errs, name, q, k, v, do, got, causal):
                oracle["fwd_equal_flash"].append(name)
            oracle["flash"].append(name)
        if name.startswith(("b_", "e_")):
            splash_against_sparse(torch, errs, name, q, k, v, do, lay, block, causal, got)
            oracle["splash"].append(name)
        del q, k, v, do, got
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return errs, tile_errs, oracle


def sdpa_layout_ms(torch, q, k, v, do, mask):
    """Yardsticks: ``scaled_dot_product_attention`` with the layout's
    boolean token mask (``mask`` [1 or h, s, s]) under the memory-efficient
    backend; forward timed in a CUDA graph, its autograd backward (dq, dk
    and dv in one call) eagerly."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    f = torch.nn.functional.scaled_dot_product_attention
    mask = mask[None]

    def fwd():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):  # never a dense [h, s, s] fallback
            return f(q, k, v, attn_mask=mask)

    fwd_ms = time_ms(torch, fwd, iters=5)
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out = f(ql, kl, vl, attn_mask=mask)
    bwd_ms = eager_ms(torch, lambda: torch.autograd.grad(out, (ql, kl, vl), do,
                                                         retain_graph=True), iters=5)
    del out, ql, kl, vl
    torch.cuda.empty_cache()
    return {"sparse_fwd": fwd_ms, "sparse_bwd_dq": bwd_ms, "sparse_bwd_dkv": bwd_ms}


def sparse_timings(torch, dev, errs, tile_errs, b=1, h=32, d=128, timed=SPARSE_TIMED,
                   seed=90):
    """At the sparse_attn phase's shape: the three kernels held against
    their plain versions and against the splash kernels on the inputs they
    are timed on; then CUDA-graph times of the kernels, their plain
    versions, the flash kernels (causal: the dense work the layout prunes)
    and, as a yardstick, SDPA with the layout's boolean token mask; beside
    each kernel its bound for these inputs."""
    from deepspeed_tpu_torch.ops.attention import flash as F
    from deepspeed_tpu_torch.ops.sparse_attention import sparse as SA

    s, block = timed["s"], timed["block"]
    layout = sparse_fixed(h).make_layout(s)
    lay = torch.as_tensor(layout, dtype=torch.int32, device=dev)
    q, k, v, do = flash_inputs(torch, dev, b, h, h, s, d, seed)
    name = f"timed_s{s}_fixed_b{block}"
    got = check_sparse(torch, errs, tile_errs, name, q, k, v, do, lay, block, True)
    splash_against_sparse(torch, errs, name, q, k, v, do, lay, block, True, got)
    out, lse = got[0], got[1]
    del got
    args = (q, k, v, out, do, lse, lay, block, True)
    ms = {"sparse_fwd": time_ms(torch, lambda: SA.sparse_fwd_cuda(q, k, v, lay, block, True),
                                iters=10),
          "sparse_bwd_dq": time_ms(torch, lambda: SA.sparse_bwd_dq_cuda(*args), iters=10),
          "sparse_bwd_dkv": time_ms(torch, lambda: SA.sparse_bwd_dkv_cuda(*args), iters=10)}
    plain = {"sparse_fwd": time_ms(
        torch, lambda: SA.sparse_fwd_reference(q, k, v, lay, block, True), iters=2, warmup=1)}
    # the plain backward computes dq, dk and dv together: its time stands for both
    plain["sparse_bwd_dq"] = plain["sparse_bwd_dkv"] = time_ms(
        torch, lambda: SA.sparse_bwd_reference(*args), iters=2, warmup=1)
    torch.cuda.empty_cache()
    fout, flse = F.flash_fwd_cuda(q, k, v, causal=True)
    flash = {"sparse_fwd": time_ms(torch, lambda: F.flash_fwd_cuda(q, k, v, causal=True),
                                   iters=10),
             "sparse_bwd_dq": time_ms(
                 torch, lambda: F.flash_bwd_dq_cuda(q, k, v, fout, do, flse, causal=True),
                 iters=10),
             "sparse_bwd_dkv": time_ms(
                 torch, lambda: F.flash_bwd_dkv_cuda(q, k, v, fout, do, flse, causal=True),
                 iters=10)}
    del fout, flse
    # one layout for every head here: a [1, s, s] token mask
    tok = (lay[0] != 0).repeat_interleave(block, 0).repeat_interleave(block, 1)
    tok &= torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    lib = sdpa_layout_ms(torch, q, k, v, do, tok[None])
    del tok
    pairs, flops, moved = sparse_work(layout, block, True, b, h, s, d)
    density = float((layout != 0).mean())
    rec = {}
    for kname in SPARSE_KERNELS:
        t_ops, t_bytes = flops[kname] / BF16_FLOPS, moved[kname] / HBM_BYTES_PER_S
        rec[kname] = {"shape": {"b": b, "h": h, "s": s, "d": d, "block": block, "causal": True,
                                "layout": "Fixed(num_local_blocks=4, num_global_blocks=1, "
                                          "unidirectional)", "density": density},
                      "ms": ms[kname], "plain_ms": plain[kname], "flash_ms": flash[kname],
                      "library_ms": lib[kname], "bound_ms": max(t_ops, t_bytes) * 1e3,
                      "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                      "kept_pairs": pairs, "flops": flops[kname],
                      "tflops_per_s": flops[kname] / (ms[kname] * 1e-3) / 1e12}
    del q, k, v, do, out, lse, lay
    torch.cuda.empty_cache()
    return rec


def kernel_sparse(torch, dev):
    """The three layout-predicate sparse kernels against their plain
    versions in bf16 at Mistral-7B's heads (32, kv expanded, d 128): the
    cases of ``sparse_cases`` at s 4096 with the flash and splash oracles
    (``sparse_case_checks``), then checked and timed at the sparse_attn
    phase's shape (``sparse_timings``). Returns one record per kernel."""
    errs, tile_errs, oracle = sparse_case_checks(torch, dev)
    at_timed = sparse_timings(torch, dev, errs, tile_errs)
    records = {}
    for name in SPARSE_KERNELS:
        main = at_timed[name]
        records[name] = {
            "name": name,
            "shape": main["shape"],
            "max_abs_err": max(errs[name].values()),
            "max_abs_err_by_case": errs[name],
            "tolerance": {"bf16": [BF16_ATOL, BF16_RTOL], "scaled_by": "max(1, max|ref|)",
                          "lse": [FLASH_LSE_ATOL, FP32_RTOL],
                          "tile_rel_frobenius": FLASH_TILE_RTOL if name in tile_errs else None},
            "tile_rel_frobenius_by_case": tile_errs.get(name),
            "held_against": {"plain": [c[0] for c in sparse_cases()], **oracle},
            **{key: main[key] for key in ("ms", "plain_ms", "flash_ms", "library_ms",
                                          "bound_ms", "bound_by", "kept_pairs", "flops",
                                          "tflops_per_s")},
            "library": "torch.nn.functional.scaled_dot_product_attention with the layout's "
                       "boolean token mask, memory-efficient backend (backward: autograd, "
                       "dq+dk+dv in one call, eager)",
        }
    return records


class PagedWorld:
    """A flat multi-layer K/V pool at the engine's layout, plus the row
    tables the split step and the fused round hand the kernel. ``dtype`` is
    the compute dtype (q, extras); with ``int8`` the pool holds
    ``quantize_kv`` codes of seeded ``dtype`` K/V and their fp32 planes."""

    def __init__(self, torch, dev, dtype, L, NB, bs, nkv, d, seed, int8=False):
        from deepspeed_tpu_torch.ops.quantizer.block_quant import quantize_kv

        self.torch, self.dev, self.dtype, self.int8 = torch, dev, dtype, int8
        self.L, self.NB, self.NBp, self.bs, self.nkv, self.d = L, NB, NB + 1, bs, nkv, d
        gen = torch.Generator(device=dev).manual_seed(seed)
        shape = (L * (NB + 1), bs, nkv, d)
        pool_dtype = torch.int8 if int8 else dtype
        self.k = torch.empty(shape, device=dev, dtype=pool_dtype)
        self.v = torch.empty(shape, device=dev, dtype=pool_dtype)
        self.ks = torch.empty(shape[:-1], device=dev) if int8 else None
        self.vs = torch.empty(shape[:-1], device=dev) if int8 else None
        # fill layer by layer: one fp32 layer at a time stays small
        for li in range(L):
            sl = slice(li * (NB + 1), (li + 1) * (NB + 1))
            for pool, plane in ((self.k, self.ks), (self.v, self.vs)):
                x = torch.randn((NB + 1,) + shape[1:], generator=gen, device=dev).to(dtype)
                if int8:
                    pool[sl], plane[sl] = quantize_kv(x)
                else:
                    pool[sl] = x

    def pool(self):
        """The pool keyword arguments of the paged functions."""
        kw = dict(k_cache=self.k, v_cache=self.v)
        if self.int8:
            kw.update(k_scale=self.ks, v_scale=self.vs)
        return kw

    def tables(self, rng, R, B, ctx, layer, active):
        """Distinct random blocks covering ``ctx[r]`` tokens per active row,
        trash elsewhere; layer-offset like the engine's tables."""
        import numpy as np

        t = np.full((R, B), self.NB, np.int32)
        perm = rng.permutation(self.NB)
        used = 0
        for r in range(R):
            if not active[r]:
                continue
            n = min(B, -(-int(ctx[r]) // self.bs))
            t[r, :n] = perm[used : used + n]
            used += n
        return self.torch.as_tensor(t + layer * self.NBp, device=self.dev)

    def trash(self, layer):
        return layer * self.NBp + self.NB


def paged_cases(torch, world, rng, R, nh, B, layer, E_round, k_verify=SPEC_K):
    """The kernel's call forms on the serving path: the split step's decode
    rows (E = 1, pool limit, padded slots at q_pos = -1) and a fused round's
    step (E = n_steps, pool limit at the round start, in-round extras,
    inactive rows with all-trash tables); plus the causal form with a
    window and a scale override, and a window on the round form; the last
    case is speculative decoding's verify form (``verify_case``)."""
    import numpy as np

    dev, dtype, d, nkv = world.dev, world.dtype, world.d, world.nkv
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    max_ctx = B * world.bs
    low = min(64, max_ctx // 4)  # shortest context
    cases = []

    # split step: rows 0..R-5 active, the last 4 padded (dec_pos = -1)
    active = np.arange(R) < R - 4
    pos = rng.integers(low, max_ctx - E_round - 1, size=R).astype(np.int32)
    pos = np.where(active, pos, -1).astype(np.int32)
    tables = world.tables(rng, R, B, np.where(active, pos + 1, 0), layer, active)
    q = torch.randn(R, nh, d, generator=gen, device=dev).to(dtype)
    ke = torch.randn(R, 1, nkv, d, generator=gen, device=dev).to(dtype)
    ve = torch.randn(R, 1, nkv, d, generator=gen, device=dev).to(dtype)
    p = torch.as_tensor(pos, device=dev)
    cases.append(("split_E1_limit", dict(
        q=q, block_tables=tables, q_pos=p, trash_block=world.trash(layer),
        extra_kv=(ke, ve, p[:, None]), pool_limit=p,
    )))

    # fused round at step s: pool limit = round start, extras 0..s valid
    s = 37
    pos0 = rng.integers(low, max_ctx - E_round, size=R).astype(np.int32)
    active = np.ones(R, bool)
    active[[3 % R, 17 % R]] = False
    pos0 = np.where(active, pos0, 0).astype(np.int32)
    tables = world.tables(rng, R, B, np.where(active, pos0 + E_round, 0), layer, active)
    j = np.arange(E_round)
    epos = np.where((j[None] <= s) & active[:, None], pos0[:, None] + j[None], -1).astype(np.int32)
    qpos = np.where(active, pos0 + s, 0).astype(np.int32)
    q = torch.randn(R, nh, d, generator=gen, device=dev).to(dtype)
    ke = torch.randn(R, E_round, nkv, d, generator=gen, device=dev).to(dtype)
    ve = torch.randn(R, E_round, nkv, d, generator=gen, device=dev).to(dtype)
    round_kw = dict(
        q=q, block_tables=tables, q_pos=torch.as_tensor(qpos, device=dev),
        trash_block=world.trash(layer),
        extra_kv=(ke, ve, torch.as_tensor(epos, device=dev)),
        pool_limit=torch.as_tensor(pos0, device=dev),
    )
    cases.append((f"round_E{E_round}_limit", round_kw))
    cases.append((f"round_E{E_round}_limit_window", dict(round_kw, window=200)))

    # causal form (no limit, no extras) with a window and a scale override
    active = np.ones(R, bool)
    active[0] = False  # an all-trash row: must give exactly 0
    pos = rng.integers(1, max_ctx - 1, size=R).astype(np.int32)
    tables = world.tables(rng, R, B, pos + 1, layer, active)
    q = torch.randn(R, nh, d, generator=gen, device=dev).to(dtype)
    cases.append(("causal_window_scale", dict(
        q=q, block_tables=tables, q_pos=torch.as_tensor(pos, device=dev),
        trash_block=world.trash(layer), window=100, scale=0.05,
    )))

    # shared prefix (prefix caching): every row's first blocks are row 0's,
    # then blocks of its own; the split form (E = 1, pool limit)
    n_pre = max(1, B // 2)
    pos = rng.integers(n_pre * world.bs, max_ctx - 1, size=R).astype(np.int32)
    tables = world.tables(rng, R, B, pos + 1, layer, np.ones(R, bool))
    tables[:, :n_pre] = tables[0, :n_pre]
    q = torch.randn(R, nh, d, generator=gen, device=dev).to(dtype)
    ke = torch.randn(R, 1, nkv, d, generator=gen, device=dev).to(dtype)
    ve = torch.randn(R, 1, nkv, d, generator=gen, device=dev).to(dtype)
    p = torch.as_tensor(pos, device=dev)
    cases.append(("shared_prefix", dict(
        q=q, block_tables=tables, q_pos=p, trash_block=world.trash(layer),
        extra_kv=(ke, ve, p[:, None]), pool_limit=p,
    )))

    # the per-row step (``_step_per_row`` over an int8 pool): a chunk of t
    # queries shares one row's table, the pool below the chunk start, the
    # chunk's own K/V as extras through stride-0 expand views with causal
    # epos (a padded tail at -1)
    t = 256 if max_ctx >= 512 else 16
    start = max_ctx // 2 + 3
    table = world.tables(rng, 1, B, np.array([start]), layer, np.ones(1, bool))
    i = np.arange(t)
    epos = torch.as_tensor(np.where(i < t - 5, start + i, -1).astype(np.int32), device=dev)
    chunk_k = torch.randn(t, nkv, d, generator=gen, device=dev).to(dtype)
    chunk_v = torch.randn(t, nkv, d, generator=gen, device=dev).to(dtype)
    cases.append((f"per_row_t{t}", dict(
        q=torch.randn(t, nh, d, generator=gen, device=dev).to(dtype),
        block_tables=table.expand(t, B),
        q_pos=torch.as_tensor((start + i).astype(np.int32), device=dev),
        trash_block=world.trash(layer),
        extra_kv=(chunk_k[None].expand(t, t, nkv, d), chunk_v[None].expand(t, t, nkv, d),
                  epos[None].expand(t, t)),
        pool_limit=torch.full((t,), start, dtype=torch.int32, device=dev),
    )))
    cases.append(verify_case(torch, world, rng, R, nh, B, layer, k_verify, gen))
    return cases


def verify_case(torch, world, rng, R, nh, B, layer, k, gen):
    """The verify form (``paged.verify_kwargs``, the engine's
    ``_verify_layer``): R rows of K1 = k + 1 tokens as R * K1 query rows,
    each with its row's table and write cursor (the pool limit) and its
    row's K1 fresh K/V as extras at the in-chunk causal positions; row 1
    carries one draft (its last K1 - 2 slots padded, q_pos -1), row 2 is
    inactive on trash tables. Returns (name, kwargs)."""
    import numpy as np

    from deepspeed_tpu_torch.ops.attention.paged import verify_kwargs

    dev, dtype, d, nkv = world.dev, world.dtype, world.d, world.nkv
    K1 = k + 1
    max_ctx = B * world.bs
    active = np.ones(R, bool)
    active[2 % R] = False
    pos0 = rng.integers(min(64, max_ctx // 4), max_ctx - K1, size=R)
    n_in = np.full(R, K1)
    n_in[1 % R] = 2
    j = np.arange(K1)
    qpos = np.where((j[None] < n_in[:, None]) & active[:, None], pos0[:, None] + j[None], -1)
    tables = world.tables(rng, R, B, np.where(active, pos0 + K1, 0), layer, active)
    q = torch.randn(R * K1, nh, d, generator=gen, device=dev).to(dtype)
    k_new = torch.randn(R * K1, nkv, d, generator=gen, device=dev).to(dtype)
    v_new = torch.randn(R * K1, nkv, d, generator=gen, device=dev).to(dtype)
    kw = verify_kwargs(q, k_new, v_new, tables,
                       torch.as_tensor(qpos.astype(np.int32), device=dev),
                       torch.as_tensor(np.where(active, pos0, 0).astype(np.int32), device=dev),
                       world.trash(layer))
    return f"verify_k{k}", kw


def verify_bytes_once(world, kw, K1):
    """Bytes the verify form must move at the least: each row's pool keys
    (below its write cursor, non-trash) and its valid fresh K/V read once,
    not once per query row as the kernel reads them; q, the output and the
    row tables. (``paged_bytes_ops`` counts them as the kernel reads them.)"""
    q = kw["q"]
    T, nh, d = q.shape
    nkv, bs = world.nkv, world.bs
    tables = kw["block_tables"].cpu().numpy()[::K1]
    limit = kw["pool_limit"].cpu().numpy()[::K1]
    qpos = kw["q_pos"].cpu().numpy().reshape(-1, K1)
    keys = 0
    for r in range(len(limit)):
        for kp in range(min(int(limit[r]), tables.shape[1] * bs)):
            if tables[r, kp // bs] % world.NBp != world.NB:
                keys += 1
    el = q.element_size()
    pool_row = d + 4 if world.int8 else d * el
    fresh = int((qpos >= 0).sum())
    return (keys * 2 * nkv * pool_row + fresh * 2 * nkv * d * el + 2 * q.numel() * el
            + tables.size * 4)


# per (row, query head) relative Frobenius error of the paged kernels
# against their plain version: a dropped or doubled split moves a row by
# far more (tests/test_torch_paged_attention.py)
PAGED_ROW_RTOL = {"bf16": 1e-2, "fp32": 1e-4}
PAGED_DESIGN = ("split-key decoding: grid (row, kv head x 16-head chunk, key split), splits of "
                "split_keys keys (>= 2 tiles) from the row's first valid key, the extras in "
                "splits of their own; a 2-stage ring of cp.async.cg 16-byte copies (masked keys "
                "zero-filled, int8 scales by 4-byte cp.async); each warp 16 keys of a tile with "
                "its own online softmax, S and P V on mma.sync m16n8k16 (int8 codes converted "
                "to bf16 in registers; fp32 on FFMA); warps merged in shared memory, splits "
                "merged in fp32 by a second kernel")


def check_rows(torch, name, got, want, rtol):
    """Relative Frobenius error of each (row, head) vector [..., d]; a
    vector that is exactly 0 in ``want`` must be exactly 0 in ``got``.
    Returns the largest error."""
    g, w = got.float(), want.float()
    num = (g - w).norm(dim=-1)
    den = w.norm(dim=-1)
    zero = den == 0
    if bool((num[zero] != 0).any()):
        raise AssertionError(f"{name}: {int((num[zero] != 0).sum())} rows must be exactly 0")
    rel = num[~zero] / den[~zero]
    worst = float(rel.max()) if rel.numel() else 0.0
    if worst > rtol:
        raise AssertionError(f"{name}: a (row, head) is off by {worst} relative (limit {rtol})")
    return worst


def paged_plan(world, kw):
    """The kernel's split plan for a call form: splits, launches per call."""
    from deepspeed_tpu_torch.ops.attention.paged import paged_decode_args

    a = paged_decode_args(**world.pool(), **kw)
    return {"splits": a.splits, "pool_splits": a.pool_splits, "extra_splits": a.extra_splits,
            "split_keys": a.split_keys, "launches_per_call": a.launches_per_call}


def paged_bytes_ops(world, kw):
    """Bytes the kernel must move and operations it must do for these
    inputs: each valid key's K and V row once (non-trash blocks inside the
    limit/causal/window range: d bytes and a 4-byte scale per head vector
    in an int8 pool, d elements of q's dtype otherwise; valid extras in q's
    dtype), q, the tables and the output; 4 * d FLOPs per valid key per
    query head."""
    import numpy as np

    q = kw["q"]
    R, nh, d = q.shape
    nkv = world.nkv
    tables = kw["block_tables"].cpu().numpy()
    qpos = kw["q_pos"].cpu().numpy()
    limit = kw.get("pool_limit")
    limit = None if limit is None else limit.cpu().numpy()
    window = int(kw.get("window", 0) or 0)
    bs = world.bs
    keys = 0
    for r in range(R):
        hi = (limit[r] if qpos[r] >= 0 else 0) if limit is not None else qpos[r] + 1
        hi = min(int(hi), tables.shape[1] * bs)
        lo = max(0, int(qpos[r]) - window + 1) if window else 0
        for kp in range(lo, max(lo, hi)):
            if tables[r, kp // bs] % world.NBp != world.NB:  # not the trash block
                keys += 1
    extras = 0
    extra = kw.get("extra_kv")
    if extra is not None:
        epos = extra[2].cpu().numpy()
        ok = (epos >= 0) & (epos <= qpos[:, None])
        if window:
            ok &= (qpos[:, None] - epos) < window
        extras = int(ok.sum())
    el = q.element_size()
    pool_row = d + 4 if world.int8 else d * el  # one head vector of the pool
    moved = (keys * 2 * nkv * pool_row + extras * 2 * nkv * d * el + 2 * q.numel() * el
             + tables.size * 4 + R * 4 * 2)
    ops = (keys + extras) * (nh // nkv) * nkv * 4 * d
    return moved, ops


def kernel_paged_decode(torch, dev, L=32, NB=512, bs=128, B=5, R=32, nh=32, nkv=8, d=128,
                        E_round=64, seed=0, int8=False):
    """The paged-decode kernel (``int8``: its int8 form, ``paged_decode_int8``,
    over a pool of ``quantize_kv`` codes and planes made from seeded bf16
    K/V) against its plain version at the engine's shapes, then timed."""
    import numpy as np

    from deepspeed_tpu_torch.ops.attention.paged import (
        paged_decode,
        paged_decode_attention_dense,
    )

    name_k = "paged_decode_int8" if int8 else "paged_decode"
    rng = np.random.default_rng(seed)
    errs = {}
    # full width: the Mistral-7B flat pool (> 2^31 elements), bf16, last layer
    world = PagedWorld(torch, dev, torch.bfloat16, L, NB, bs, nkv, d, seed, int8=int8)
    if world.k.numel() < 2 ** 31:
        raise AssertionError("the full-width pool should exceed 2^31 elements")
    cases = paged_cases(torch, world, rng, R, nh, B, L - 1, E_round)
    row_errs = {}
    for name, kw in cases:
        got = paged_decode(**world.pool(), **kw)
        want = paged_decode_attention_dense(**world.pool(), **kw)
        errs[name] = check_close(torch, f"{name_k} {name}", got, want, BF16_ATOL, BF16_RTOL)
        row_errs[name] = check_rows(torch, f"{name_k} {name}", got, want, PAGED_ROW_RTOL["bf16"])
        if name == "causal_window_scale" and bool(got[0].float().abs().max() != 0):
            raise AssertionError(f"{name_k}: an all-trash row must give exactly 0")
        if name.startswith("split") and bool(got[-4:].float().abs().max() != 0):
            raise AssertionError(f"{name_k}: padded slots (q_pos = -1) must give exactly 0")
        if name.startswith("verify") and bool(got[kw["q_pos"] < 0].float().abs().max() != 0):
            raise AssertionError(f"{name_k}: the verify form's padded slots and inactive row "
                                 "must give exactly 0")
    # the round forms again under a finer plan (5 pool splits of 128 keys
    # and the extras split): more partials to merge, the window ending
    # inside a split
    from deepspeed_tpu_torch.ops.attention import paged as paged_mod

    coarse = paged_mod.SPLIT_TARGET_CTAS
    paged_mod.SPLIT_TARGET_CTAS = 4096
    try:
        for name, kw in cases[1:3]:
            got = paged_decode(**world.pool(), **kw)
            want = paged_decode_attention_dense(**world.pool(), **kw)
            key = f"{name}_splits{paged_plan(world, kw)['splits']}"
            errs[key] = check_close(torch, f"{name_k} {key}", got, want, BF16_ATOL, BF16_RTOL)
            row_errs[key] = check_rows(torch, f"{name_k} {key}", got, want,
                                       PAGED_ROW_RTOL["bf16"])
    finally:
        paged_mod.SPLIT_TARGET_CTAS = coarse
    # other head dims, GQA groups and fp32, at a small pool
    for dt, dd, hh, kvh in ((torch.float32, 64, 8, 2), (torch.float32, 256, 4, 4),
                            (torch.bfloat16, 64, 32, 2), (torch.float32, 128, 12, 4)):
        small = PagedWorld(torch, dev, dt, 2, 24, 16, kvh, dd, seed + 1, int8=int8)
        tol = (FP32_ATOL, FP32_RTOL) if dt == torch.float32 else (BF16_ATOL, BF16_RTOL)
        for name, kw in paged_cases(torch, small, rng, 6, hh, 4, 1, 8):
            got = paged_decode(**small.pool(), **kw)
            want = paged_decode_attention_dense(**small.pool(), **kw)
            key = f"{name}_{str(dt).split('.')[-1]}_d{dd}_g{hh // kvh}"
            errs[key] = check_close(torch, f"{name_k} {key}", got, want, *tol)
            row_errs[key] = check_rows(torch, f"{name_k} {key}", got, want,
                                       PAGED_ROW_RTOL["fp32" if dt == torch.float32 else "bf16"])
        del small
    torch.cuda.synchronize()

    # times at the round form (E = n_steps) and the split form (E = 1),
    # rotating over 8 layers so each launch reads its K/V from device memory
    _, split_kw = cases[0]
    _, round_kw = cases[1]

    def by_layer(form_kw):
        layer_kw = []
        for li in range(8):
            kw = dict(form_kw)
            off = (li - (L - 1)) * world.NBp
            kw["block_tables"] = form_kw["block_tables"] + off
            kw["trash_block"] = world.trash(li)
            layer_kw.append(kw)
        return layer_kw

    layer_kw, split_layer_kw = by_layer(round_kw), by_layer(split_kw)
    it = iter(range(1 << 30))
    ms = time_ms(torch, lambda: paged_decode(**world.pool(), **layer_kw[next(it) % 8]))
    split_ms = time_ms(torch, lambda: paged_decode(**world.pool(),
                                                   **split_layer_kw[next(it) % 8]))
    verify_name, verify_kw = cases[-1]
    verify_layer_kw = by_layer(verify_kw)
    K1 = SPEC_K + 1
    verify = {
        "form": verify_name, "rows": R, "K1": K1, "query_rows": R * K1,
        "ms": time_ms(torch, lambda: paged_decode(**world.pool(),
                                                  **verify_layer_kw[next(it) % 8])),
        "plain_ms": time_ms(torch, lambda: paged_decode_attention_dense(
            **world.pool(), **verify_layer_kw[next(it) % 8]), iters=5),
        "library_ms": sdpa_ms(torch, world, verify_kw),
        **paged_plan(world, verify_kw),
        "max_abs_err": errs[verify_name],
        "row_rel_frobenius": row_errs[verify_name],
        # the extras' contiguous copy a layer (verify_extras): K and V
        "extras_copy_bytes": 2 * R * K1 * K1 * nkv * d * 2,
    }
    v_read, v_ops = paged_bytes_ops(world, verify_kw)
    v_once = verify_bytes_once(world, verify_kw, K1)
    t_ops = v_ops / BF16_FLOPS
    verify.update(bytes_as_read=v_read, bytes_once=v_once,
                  bound_ms_as_read=max(v_read / HBM_BYTES_PER_S, t_ops) * 1e3,
                  bound_ms=max(v_once / HBM_BYTES_PER_S, t_ops) * 1e3,
                  bound_by="bytes" if v_once / HBM_BYTES_PER_S >= t_ops else "operations")
    plain_ms = time_ms(torch, lambda: paged_decode_attention_dense(
        **world.pool(), **layer_kw[next(it) % 8]), iters=5)
    library_ms = sdpa_ms(torch, world, round_kw)
    call_ms = eager_ms(torch, lambda: paged_decode(**world.pool(), **layer_kw[next(it) % 8]))
    moved, ops = paged_bytes_ops(world, round_kw)
    split_moved, _ = paged_bytes_ops(world, cases[0][1])
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / BF16_FLOPS
    return {
        "name": name_k,
        "shape": {"R": R, "nh": nh, "nkv": nkv, "d": d, "bs": bs, "B": B, "E": E_round,
                  "pool": list(world.k.shape)},
        "max_abs_err": max(errs.values()),
        "max_abs_err_by_case": errs,
        "row_rel_frobenius_by_case": row_errs,
        "tolerance": {"bf16": [BF16_ATOL, BF16_RTOL], "fp32": [FP32_ATOL, FP32_RTOL],
                      "row_rel_frobenius": PAGED_ROW_RTOL},
        "ms": ms,
        "split_ms": split_ms,
        **paged_plan(world, round_kw),
        "split_form": paged_plan(world, split_kw),
        "design": PAGED_DESIGN,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library": "torch.nn.functional.scaled_dot_product_attention on the gathered context"
                   + (", already dequantized to bf16 (no one PyTorch call dequantizes and "
                      "attends)" if int8 else ""),
        "eager_call_ms": call_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": moved,
        "split_step_bound_ms": split_moved / HBM_BYTES_PER_S * 1e3,
        "verify_form": verify,
    }


def sdpa_ms(torch, world, kw):
    """One SDPA call over the round form's gathered context (pool blocks
    then extras, with the same mask as a boolean attn_mask): a yardstick,
    timed on pre-gathered (and, for an int8 pool, pre-dequantized)
    inputs."""
    q = kw["q"]
    R, nh, d = q.shape
    bs, nkv = world.bs, world.nkv
    tables = kw["block_tables"].long()
    B = tables.shape[1]
    S = B * bs

    def gathered(pool, plane):
        g = pool[tables]
        if plane is not None:  # int8: dequantized before the call
            g = (g.float() * plane[tables][..., None]).to(q.dtype)
        return g.permute(0, 3, 1, 2, 4).reshape(R, nkv, S, d)

    k, v = gathered(world.k, world.ks), gathered(world.v, world.vs)
    ke, ve, epos = kw["extra_kv"]
    k = torch.cat([k, ke.permute(0, 2, 1, 3)], dim=2).contiguous()
    v = torch.cat([v, ve.permute(0, 2, 1, 3)], dim=2).contiguous()
    kpos = torch.arange(S, device=q.device)
    qpos = kw["q_pos"]
    pool_ok = (kpos[None] < kw["pool_limit"][:, None]) & (
        tables != int(kw["trash_block"])).repeat_interleave(bs, dim=1)
    e_ok = (epos >= 0) & (epos <= qpos[:, None])
    mask = torch.cat([pool_ok, e_ok], dim=1)[:, None, None, :]
    qq = q[:, :, None, :]
    f = torch.nn.functional.scaled_dot_product_attention
    return time_ms(torch, lambda: f(qq, k, v, attn_mask=mask, enable_gqa=True))


# fused LM head + CE: fp32 per-row outputs (sums of 4096 bf16 products and
# of 32000 exponentials in fp32, in another order)
CE_ROW_ATOL = 2e-4
# dx and dW are bf16 roundings of fp32 sums of bf16-rounded d: a few bf16
# units of the largest element, and per 64-row tile a relative Frobenius
# error as for the flash gradients (d is recomputed from logits that differ
# in the last fp32 bits, so single elements of d round the other way)
CE_TILE_RTOL = 1e-2


def ce_inputs(torch, dev, n, h, V, seed):
    """x ~ N(0, 1), w ~ N(0, 1/h) (logits of order 1), random labels and a
    per-row cotangent with zeros (masked rows; the last row as a padded
    one)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, h, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(h, V, generator=gen, device=dev) * h ** -0.5).to(torch.bfloat16)
    labels = torch.randint(0, V, (n,), generator=gen, device=dev, dtype=torch.int32)
    g = torch.rand(n, generator=gen, device=dev) / n
    g = torch.where(torch.rand(n, generator=gen, device=dev) < 0.1, torch.zeros_like(g), g)
    g[-1] = 0.0
    return x, w, labels, g


# fused_ce_bwd.cu's SPAN: the vocabulary columns of a dx CTA, the rows of a
# dW CTA
CE_BWD_SPAN = 512
CE_BWD_DESIGN = ("wgmma (m64n256k16 logits, m64n128k16 gradient product, fp32 accumulators in "
                 "registers) on 128B-swizzled tiles brought by TMA into a 3-stage ring; 1 "
                 "producer thread, 2 consumer warpgroups (setmaxnreg); d resident in shared "
                 "memory as a wgmma operand; red.global.add.v2.f32 into the zeroed fp32 plane, "
                 "overlapped with the next chunk's products")


def ce_bwd_fields(n, h, V):
    """The fp32 elements each backward kernel adds into its plane at (n, h,
    V), its span and its design: dx adds each of its [n, h8] elements once
    per vocabulary span, dW each of its [h8, V8] once per row span (h8, V8:
    h and V padded to multiples of 8)."""
    h8, V8, span = -(-h // 8) * 8, -(-V // 8) * 8, CE_BWD_SPAN
    return {
        "fused_ce_dx": {"reduced_elements": n * h8 * -(-V // span),
                        "span": {"Vs": span}, "design": CE_BWD_DESIGN},
        "fused_ce_dw": {"reduced_elements": h8 * V8 * -(-n // span),
                        "span": {"Rs": span}, "design": CE_BWD_DESIGN},
    }


CE_FWD_DESIGN = ("wgmma (m64n256k16 logits: the pass dx and dW recompute, fused_ce_hopper.cuh; "
                 "fp32 accumulators in registers) on 128B-swizzled tiles brought by TMA into a "
                 "4-stage ring; 1 producer thread, 2 consumer warpgroups (setmaxnreg); per 256-column "
                 "pass an online (max, sum-exp) in registers, drained then reduced; per span a "
                 "(max, sum) pair per row into a [spans, n] fp32 plane, folded in span order by a "
                 "merge kernel; no atomics")


def ce_fwd_fields(n, V, span):
    """The forward's span (vocabulary columns of a CTA), its CTAs and the
    fp32 partials its merge folds at (n, V), and its design."""
    spans = -(-V // span)
    return {"span": {"Vs": span}, "ctas": -(-n // 128) * spans, "partials": 2 * spans * n,
            "design": CE_FWD_DESIGN}


def ce_head_forms(torch):
    """The LM head as a training step runs it, forward then the backward
    for x and w, in two forms: the fused kernels through ``fused_ce_loss``
    (no [n, V] logits kept) and the library's dense form (``cross_entropy``
    of ``x @ w``, whose autograd keeps the logits). Each returns (loss, dx,
    dW)."""
    from deepspeed_tpu_torch.ops import fused_ce as C

    def fused(x, w, labels, g):
        loss = C.fused_ce_loss(x, w, labels)
        return (loss,) + tuple(torch.autograd.grad(loss, (x, w), g))

    def library(x, w, labels, g):
        loss = torch.nn.functional.cross_entropy((x @ w).float(), labels.long(), reduction="none")
        return (loss,) + tuple(torch.autograd.grad(loss, (x, w), g))

    return {"fused": fused, "library": library}


def peak_bytes_above(torch, fn):
    """Device memory a call of ``fn`` holds at its peak above what was
    allocated before it (its result included)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - before


def fused_ce_head(torch, x, w, labels, g, kernel_ms, library_ms, call_ms, peak_bytes):
    """The whole head, fused against the library: the three kernels' summed
    times beside the library's forward and backward, each form's eager call
    (``call_ms(fn)``) and the memory it holds above its inputs
    (``peak_bytes(fn)``)."""
    forms = ce_head_forms(torch)
    xl, wl = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    kernels = {k: kernel_ms[k] for k in ("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw")}
    lib = {"fwd": library_ms["fused_ce_fwd"], "bwd": library_ms["fused_ce_dx"]}
    return {
        "name": "fused_ce_head",
        "shape": {"n": x.shape[0], "h": x.shape[1], "V": w.shape[1]},
        "kernels_ms": dict(kernels, sum=sum(kernels.values())),
        "library_ms": dict(lib, sum=lib["fwd"] + lib["bwd"],
                           call="torch.nn.functional.cross_entropy(x @ w), autograd backward"),
        "call_ms": {name: call_ms(lambda f=f: f(xl, wl, labels, g)) for name, f in forms.items()},
        "peak_bytes_above_inputs": {name: peak_bytes(lambda f=f: f(xl, wl, labels, g))
                                    for name, f in forms.items()},
        "holds": {"fused": "fp32 dx [n, h] and dW [h, V] planes and their bf16 roundings",
                  "library": "the [n, V] logits (bf16 and fp32) and their gradient"},
    }


def kernel_fused_ce(torch, dev, n=4096, h=4096, V=32000):
    """The three fused-CE kernels at the train step's shape (one micro-batch
    of 4096 rows at width 4096 against Mistral-7B's 32000-entry vocabulary)
    and at sizes that divide no tile; in every case two forward launches
    must give the same loss and lse bits. Returns one record per kernel."""
    from deepspeed_tpu_torch.ops import fused_ce as C

    cases = {f"n{n}_h{h}_V{V}": (n, h, V), "n777_h1000_V3001": (777, 1000, 3001),
             "n300_h520_V3000": (300, 520, 3000)}
    errs = {"fused_ce_fwd": {}, "fused_ce_dx": {}, "fused_ce_dw": {}}
    tile_errs = {"fused_ce_dx": {}, "fused_ce_dw": {}}
    for i, (name, (nn, hh, VV)) in enumerate(cases.items()):
        x, w, labels, g = ce_inputs(torch, dev, nn, hh, VV, seed=30 + i)
        loss, lse = C.fused_ce_fwd_cuda(x, w, labels)
        again = C.fused_ce_fwd_cuda(x, w, labels)
        if not (torch.equal(loss, again[0]) and torch.equal(lse, again[1])):
            raise AssertionError(f"fused_ce_fwd {name}: two launches gave other bits")
        del again
        ref_loss, ref_lse = C.fused_ce_fwd_reference(x, w, labels)
        errs["fused_ce_fwd"][name] = check_close(torch, f"fused_ce_fwd loss {name}", loss,
                                                 ref_loss, CE_ROW_ATOL, FP32_RTOL)
        errs["fused_ce_fwd"][name + "_lse"] = check_close(
            torch, f"fused_ce_fwd lse {name}", lse, ref_lse, CE_ROW_ATOL, FP32_RTOL)
        dense = C.fused_ce_reference(x, w, labels)
        check_close(torch, f"fused_ce_fwd vs dense {name}", loss, dense, CE_ROW_ATOL, FP32_RTOL)
        del ref_loss, ref_lse, dense
        rdx, rdw = C.fused_ce_bwd_reference(x, w, labels, lse, g)
        for kname, got, want in (
                ("fused_ce_dx", C.fused_ce_dx_cuda(x, w, labels, lse, g), rdx),
                ("fused_ce_dw", C.fused_ce_dw_cuda(x, w, labels, lse, g), rdw)):
            scale = float(want.float().abs().max())
            errs[kname][name] = check_close(torch, f"{kname} {name}", got, want,
                                            BF16_ATOL * scale, BF16_RTOL)
            tile_errs[kname][name] = tile_rel_err(torch, f"{kname} {name}", got[None, None],
                                                  want[None, None], limit=CE_TILE_RTOL)
            if kname == "fused_ce_dx" and bool(got[g == 0].float().abs().max() != 0):
                raise AssertionError(f"fused_ce_dx {name}: a row with zero cotangent must be 0")
        del rdx, rdw
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # times at the train step's shape
    x, w, labels, g = ce_inputs(torch, dev, n, h, V, seed=30)
    _, lse = C.fused_ce_fwd_cuda(x, w, labels)
    ms = {
        "fused_ce_fwd": time_ms(torch, lambda: C.fused_ce_fwd_cuda(x, w, labels), iters=5),
        "fused_ce_dx": time_ms(torch, lambda: C.fused_ce_dx_cuda(x, w, labels, lse, g), iters=5),
        "fused_ce_dw": time_ms(torch, lambda: C.fused_ce_dw_cuda(x, w, labels, lse, g), iters=5),
    }
    plain = {"fused_ce_fwd": time_ms(torch, lambda: C.fused_ce_fwd_reference(x, w, labels),
                                     iters=2, warmup=1)}
    # the plain backward computes dx and dW together: its time stands for both
    plain["fused_ce_dx"] = plain["fused_ce_dw"] = time_ms(
        torch, lambda: C.fused_ce_bwd_reference(x, w, labels, lse, g), iters=2, warmup=1)
    torch.cuda.empty_cache()
    # yardsticks: the dense head through the library's matmul and
    # cross_entropy; its autograd backward gives dx and dW in one call
    lib_ce = torch.nn.functional.cross_entropy
    lbl = labels.long()
    library = {"fused_ce_fwd": time_ms(
        torch, lambda: lib_ce((x @ w).float(), lbl, reduction="none"), iters=5)}
    xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    dense_loss = lib_ce((xl @ wl).float(), lbl, reduction="none")
    library["fused_ce_dx"] = library["fused_ce_dw"] = eager_ms(
        torch, lambda: torch.autograd.grad(dense_loss, (xl, wl), g, retain_graph=True), iters=5)
    del dense_loss, xl, wl
    torch.cuda.empty_cache()
    el = x.element_size()
    xb, wb, rows = x.numel() * el, w.numel() * el, n * 4
    work = {  # (FLOPs, bytes: each input read once, each output written once)
        "fused_ce_fwd": (2 * n * h * V, xb + wb + rows + 2 * rows),
        "fused_ce_dx": (4 * n * h * V, xb + wb + 3 * rows + xb),
        "fused_ce_dw": (4 * n * h * V, xb + wb + 3 * rows + wb),
    }
    emit(fused_ce_head(torch, x, w, labels, g, ms, library,
                       lambda fn: eager_ms(torch, fn, iters=3, warmup=1),
                       lambda fn: peak_bytes_above(torch, fn)))
    torch.cuda.empty_cache()
    fields = dict(ce_bwd_fields(n, h, V), fused_ce_fwd=dict(
        ce_fwd_fields(n, V, C.FWD_SPAN), repeats_bits=list(cases)))
    records = {}
    for name, (flops, moved) in work.items():
        t_ops, t_bytes = flops / BF16_FLOPS, moved / HBM_BYTES_PER_S
        records[name] = {
            "name": name,
            "shape": {"n": n, "h": h, "V": V},
            "max_abs_err": max(errs[name].values()),
            "max_abs_err_by_case": errs[name],
            "tolerance": {"rows_fp32": [CE_ROW_ATOL, FP32_RTOL],
                          "bf16": [BF16_ATOL, BF16_RTOL], "scaled_by": "max|ref|",
                          "tile_rel_frobenius": CE_TILE_RTOL if name in tile_errs else None},
            "tile_rel_frobenius_by_case": tile_errs.get(name),
            "ms": ms[name],
            "plain_ms": plain[name],
            "library_ms": library[name],
            "library": "torch.nn.functional.cross_entropy(x @ w)" + (
                "" if name == "fused_ce_fwd" else " autograd backward, dx + dW in one call, eager"),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops,
            "tflops_per_s": flops / (ms[name] * 1e-3) / 1e12,
            **fields[name],
        }
    return records


# FusedAdam against the plain math: the kernel rounds every operation on
# its own, in _adam_math's order; PyTorch divides by a scalar as a multiply
# by its reciprocal, so u differs by a few units in the last place: m, v
# and p within 4 fp32 ulp, p's error counted against |p| + |lr * u| (where
# v is tiny the step is far larger than p)
ADAM_RTOL = 4 * 2.0 ** -23
ADAM_LR = 1e-3


def check_adam_master(torch, name, got, want, before):
    """The updated master within 4 fp32 ulp of its new value and of the step
    taken to it; returns the largest absolute error."""
    err = (got - want).abs()
    bad = err > ADAM_RTOL * (want.abs() + (want - before).abs()) + 1e-12
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements off "
                             f"(max abs err {float(err.max())})")
    return float(err.max())


def kernel_fused_adam(torch, dev, shape=(4096, 14336)):
    """FusedAdam on one MLP weight of Mistral-7B (4096 x 14336 fp32 master
    with its bf16 copy) and on a leaf with a ragged tail; steps 1 and 1000,
    AdamW and L2 decay, with and without bias correction."""
    from deepspeed_tpu_torch.ops.adam import fused_adam as A

    gen = torch.Generator(device=dev).manual_seed(40)

    def leaf(numel_or_shape):
        p = torch.randn(numel_or_shape, generator=gen, device=dev)
        g = torch.randn(numel_or_shape, generator=gen, device=dev) * 0.1
        m = torch.randn(numel_or_shape, generator=gen, device=dev) * 0.1
        v = torch.rand(numel_or_shape, generator=gen, device=dev) * 0.01
        return p, g, m, v

    errs = {}
    for tag, shp in (("4096x14336", shape), ("tail_196611", (3 * 65536 + 3,))):
        p, g, m, v = leaf(shp)
        for step, adamw, bc in ((1, True, True), (1000, True, True), (1000, False, True),
                                (7, True, False)):
            hp = A.AdamParams(lr=ADAM_LR, weight_decay=0.01, adam_w_mode=adamw,
                              bias_correction=bc)
            want_p, want_m, want_v = A._adam_math(p, g, m, v, step, hp, ADAM_LR)
            kp, km, kv = p.clone(), m.clone(), v.clone()
            low = torch.empty(shp, device=dev, dtype=torch.bfloat16)
            A.fused_adam_cuda(kp, g, km, kv, step, hp, ADAM_LR, param_out=low)
            name = f"{tag}_step{step}_{'adamw' if adamw else 'l2'}{'' if bc else '_nobc'}"
            errs[name] = check_adam_master(torch, f"fused_adam p {name}", kp, want_p, p)
            check_close(torch, f"fused_adam m {name}", km, want_m, ADAM_RTOL, ADAM_RTOL)
            check_close(torch, f"fused_adam v {name}", kv, want_v, ADAM_RTOL, ADAM_RTOL)
            if not torch.equal(low, kp.to(torch.bfloat16)):
                raise AssertionError(f"fused_adam {name}: the bf16 copy is not the rounded master")
            del want_p, want_m, want_v, kp, km, kv, low
        del p, g, m, v
        torch.cuda.empty_cache()

    p, g, m, v = leaf(shape)
    low = torch.empty(shape, device=dev, dtype=torch.bfloat16)
    hp = A.AdamParams(lr=ADAM_LR, weight_decay=0.01)
    ms = time_ms(torch, lambda: A.fused_adam_cuda(p, g, m, v, 10, hp, ADAM_LR, param_out=low),
                 iters=10)
    plain_ms = time_ms(torch, lambda: A._adam_math(p, g, m, v, 10, hp, ADAM_LR), iters=3,
                       warmup=1)
    # yardstick: PyTorch's own fused AdamW on the same leaf (28 B per
    # element: it keeps no half-precision copy)
    lp = p.clone().requires_grad_(True)
    lp.grad = g.clone()
    opt = torch.optim.AdamW([lp], lr=ADAM_LR, weight_decay=0.01, fused=True)
    library_ms = eager_ms(torch, opt.step, iters=10)
    del opt, lp
    numel = p.numel()
    moved = numel * (4 * 4 + 3 * 4 + 2)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, 14 * numel / FP32_FLOPS
    return {
        "name": "fused_adam",
        "shape": list(shape),
        "max_abs_err": max(errs.values()),
        "max_abs_err_by_case": errs,
        "tolerance": {"p": "4 fp32 ulp of |p| + |step|", "m_v": [ADAM_RTOL, ADAM_RTOL]},
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library": "torch.optim.AdamW(fused=True).step on the same leaf (eager)",
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": moved,
        "gb_per_s": moved / (ms * 1e-3) / 1e9,
    }


# the block-quant kernel: the engine's quantize-on-write at a split step's
# shape (the K and the V of 32 decode slots + 4 chunks of 256 tokens: 8448
# head vectors of 128 each, one launch for the pair) and the JAX package's
# default block of 2048 over a 4096 x 14336 bf16 tensor (one Mistral-7B MLP
# weight), each in the deterministic and the stochastic mode
QUANT_WRITE_ROWS = (32 + 4 * 256) * 8
QUANT_SEED = 1234


def block_quant_inputs(torch, dev, rows=QUANT_WRITE_ROWS, d=128, shape=(4096, 14336)):
    """The engine's write (bf16 K and V [rows, d], K's first head vector
    zero) and a weight-sized bf16 tensor, from a seed."""
    gen = torch.Generator(device=dev).manual_seed(80)
    x_kv = torch.randn(rows, d, generator=gen, device=dev).to(torch.bfloat16)
    x_kv[0] = 0  # a zero head vector: scale 0, codes 0
    x_big = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    v_kv = torch.randn(rows, d, generator=gen, device=dev).to(torch.bfloat16)
    return (x_kv, v_kv), x_big


def block_quant_mismatches(torch, kv, x_big, block):
    """Elements where ``block_quant`` and ``block_quant_pair`` (codes, or
    scales by their bits) and ``quantize_kv_pair`` /
    ``quantize_blockwise_kernel`` differ from their plain versions, by
    case, in the deterministic and the stochastic mode."""
    from deepspeed_tpu_torch.ops.quantizer import block_quant as BQ

    x_kv, v_kv = kv
    d = x_kv.shape[1]

    def count(got, want):
        return int((got[0] != want[0]).sum()) + int(
            (got[1].view(torch.int32) != want[1].view(torch.int32)).sum())

    inputs = {f"kv_write_d{d}": x_kv, f"blockwise_{block}": x_big.view(-1, block),
              f"kv_write_d{d}_fp32": x_kv.float()}
    mismatches = {}
    for name, x in inputs.items():
        for stochastic in (False, True):
            got = BQ.block_quant(x, 127.0, stochastic, QUANT_SEED)
            want = BQ.block_quant_reference(x, 127.0, stochastic, QUANT_SEED)
            tag = f"{name}_{'stochastic' if stochastic else 'deterministic'}"
            mismatches[tag] = count(got, want)
            if stochastic:  # every code is the floor or the ceiling of x * inv
                scaled = x.float() * torch.where(want[1] > 0, 1 / want[1], 0)[:, None]
                off = (got[0].float() - scaled).abs().max()
                if float(off) >= 1:
                    raise AssertionError(f"block_quant {tag}: a code {float(off)} from x * inv")
            del got, want
    # the pair (one launch over K and V), each plane as a call of its own
    for dtype in (torch.bfloat16, torch.float32):
        a, b = x_kv.to(dtype), v_kv.to(dtype)
        for stochastic in (False, True):
            got = BQ.block_quant_pair(a, b, 127.0, stochastic, QUANT_SEED)
            tag = (f"pair_d{d}{'_fp32' if dtype == torch.float32 else ''}_"
                   f"{'stochastic' if stochastic else 'deterministic'}")
            mismatches[tag] = sum(
                count(g, BQ.block_quant_reference(x, 127.0, stochastic, QUANT_SEED))
                for g, x in zip(got, (a, b)))
    # the engine's entry (a [t, nkv, d] write, one plane and the pair) and
    # the int4 post-pass
    q, sc = BQ.quantize_kv(x_kv.view(-1, 8, d))
    mismatches["quantize_kv"] = count((q.view(-1, d), sc.reshape(-1)),
                                      BQ.block_quant_reference(x_kv, 127.0))
    (qk, sk), (qv, sv) = BQ.quantize_kv_pair(x_kv.view(-1, 8, d), v_kv.view(-1, 8, d))
    mismatches["quantize_kv_pair"] = sum(
        count((q.view(-1, d), sc.reshape(-1)), BQ.block_quant_reference(x, 127.0))
        for q, sc, x in ((qk, sk, x_kv), (qv, sv, v_kv)))
    got4 = BQ.quantize_blockwise_kernel(x_big, bits=4, block_size=block)
    want4 = BQ.quantize_blockwise_kernel_reference(x_big, bits=4, block_size=block)
    mismatches["blockwise_int4"] = int((got4.values != want4.values).sum()) + int(
        (got4.scales != want4.scales).sum())
    return mismatches


def kernel_block_quant(torch, dev, rows=QUANT_WRITE_ROWS, d=128, shape=(4096, 14336),
                       block=2048):
    """``block_quant`` bitwise against its plain version (codes and scales
    equal, no tolerance), then timed: the engine's pair (K and V of a write
    in one launch, the main record), one plane alone and as two launches,
    and the block of 2048."""
    from deepspeed_tpu_torch.ops.quantizer import block_quant as BQ

    (x_kv, v_kv), x_big = block_quant_inputs(torch, dev, rows, d, shape)
    mismatches = block_quant_mismatches(torch, (x_kv, v_kv), x_big, block)
    if any(mismatches.values()):
        raise AssertionError(f"block_quant differs from its plain version: {mismatches}")
    torch.cuda.synchronize()

    def moved(planes):
        n, blk = planes[0].shape
        return len(planes) * (n * blk * (planes[0].element_size() + 1) + n * 4)

    def timings(planes, plain_iters):
        if len(planes) == 2:
            fn = lambda stochastic=False, seed=0: BQ.block_quant_pair(*planes, 127.0,
                                                                     stochastic, seed)
            plain = lambda: [BQ.block_quant_reference(x, 127.0) for x in planes]
        else:
            fn = lambda stochastic=False, seed=0: BQ.block_quant(planes[0], 127.0, stochastic,
                                                                 seed)
            plain = lambda: BQ.block_quant_reference(planes[0], 127.0)
        return {
            "ms": time_ms(torch, fn),
            "stochastic_ms": time_ms(torch, lambda: fn(True, QUANT_SEED)),
            "plain_ms": time_ms(torch, plain, iters=plain_iters),
            "bound_ms": moved(planes) / HBM_BYTES_PER_S * 1e3,
            "bytes": moved(planes),
        }

    pair = timings((x_kv, v_kv), 20)
    single = timings((x_kv,), 20)
    single["two_launches_ms"] = time_ms(
        torch, lambda: (BQ.block_quant(x_kv, 127.0), BQ.block_quant(v_kv, 127.0)))
    big = timings((x_big.view(-1, block),), 5)
    # about ten operations per element (abs, max, two products, round,
    # clip, convert) against bytes at >= 3 per element: bytes bound it
    return {
        "name": "block_quant",
        "shape": {"write": [rows, d], "planes": 2, "blockwise": [*shape], "block": block},
        "max_abs_err": 0.0,
        "mismatches_by_case": mismatches,
        "tolerance": "bitwise (codes and scales equal)",
        **pair,
        "bound_by": "bytes",
        "library_ms": None,
        "library": None,
        "library_none_because": "no single PyTorch call quantizes to int8 with one absmax "
                                "scale per block",
        "one_plane": single,
        f"blockwise_{block}": big,
    }


# ---------------------------------------------------------------------------
# phase 3: the engine at Mistral-7B width
# ---------------------------------------------------------------------------
# bench.py's serving engine config (bench_serving): 256 x 4 prompt-chunk
# grid, 128-token blocks, 512 blocks, 5 blocks per sequence, 32 rows,
# 640-token contexts, 64-token fused rounds
ENGINE_CONFIG = {
    "dtype": "bfloat16", "decode_steps": 64,
    "prompt_chunk": 256, "max_prompt_chunks": 4,
    "kv_cache": {"block_size": 128, "num_blocks": 512, "max_blocks_per_seq": 5},
    "state_manager": {"max_tracked_sequences": 64, "max_ragged_batch_size": 1024,
                      "max_ragged_sequence_count": 32, "max_context": 640},
}
# the model the engine phase serves, and the seed of its weights and prompts
MODEL = "mistral-7b"
SEED = 0
# logits of the engine against the plain forward on the same tokens: the
# largest difference over a row, relative to the row's largest logit, for
# every slot's prefill row, single decode steps and every step of the
# fused round. bf16 weights and activations over 32 layers, with the
# engine's chunked / paged attention in fp32 and the reference's dense
# attention rounding its softmax weights to bf16, differ by a few bf16
# units in the last place (0.027 at most over the 32 slots on an H100);
# logits of another position differ by order 1 (0.53 at least there).
LOGIT_RTOL = 0.05
# the int8 pool's logits against the plain forward (which attends over
# unquantized K/V) and against the bf16 engine's: int8 codes carry a
# rounding error of up to absmax / 254 per head-vector element, on top of
# the bf16 differences above; the limit was set before the first run on the
# card, and the negative control (0.53 above) stays well outside it
INT8_LOGIT_RTOL = 0.1


def rows_rel_err(torch, got, want):
    """Largest over rows of max|got - want| / max|want| (rows on the last
    axis), computed on ``want``'s device."""
    want = torch.as_tensor(want).float()
    got = torch.as_tensor(got).to(want.device).float()
    return float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max())


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def serve_counted_path(torch, dev, eng, prompts):
    """Drive the serving main path: every prompt through ``step()``, two
    single decode steps, one fused ``decode_round(64)``, greedy tokens fed
    back. Returns the host logits of the prefill rows and the decode steps,
    the round's tokens and logits (on the device, as the engine hands them
    to its sampler: no copy and no launch), the token streams and the
    counts and seconds."""
    import numpy as np

    out = {"split_steps": 0}
    t0 = time.perf_counter()
    for uid, p in enumerate(prompts):
        eng.scheduler.submit(uid, p)
    prefill_logits = {}
    while eng.scheduler.has_pending():
        prefill_logits.update(eng.step())
        out["split_steps"] += 1
        if eng.last_scheduled_tokens == 0:
            raise AssertionError("prefill stalled: nothing schedulable")
    _sync(torch, dev)
    out["prefill_seconds"] = time.perf_counter() - t0
    out["prefill_steps"] = out["split_steps"]
    if sorted(prefill_logits) != list(range(len(prompts))):
        raise AssertionError(f"prefill completed {len(prefill_logits)} of {len(prompts)} prompts")
    seqs = {uid: list(p) for uid, p in enumerate(prompts)}
    decode_logits = []
    last = prefill_logits
    for _ in range(2):
        for uid, lg in last.items():
            tok = int(np.argmax(lg))
            seqs[uid].append(tok)
            eng.scheduler.feedback(uid, tok)
        last = eng.step()
        out["split_steps"] += 1
        decode_logits.append(last)
    for uid, lg in last.items():
        tok = int(np.argmax(lg))
        seqs[uid].append(tok)
        eng.scheduler.feedback(uid, tok)
    round_logits = []
    sample = eng._sample

    def keep_logits(logits, *a, **k):
        round_logits.append(logits)
        return sample(logits, *a, **k)

    eng._sample = keep_logits
    t0 = time.perf_counter()
    rounds = eng.decode_round(64)
    _sync(torch, dev)
    out["round_seconds"] = time.perf_counter() - t0
    del eng._sample  # back to the class's method
    out.update(prefill_logits=prefill_logits, decode_logits=decode_logits, rounds=rounds,
               round_logits=torch.stack(round_logits), seqs=seqs)
    return out


def logit_rows(torch, run, uid, row):
    """uid's 67 logits rows of a ``serve_counted_path`` run (prefill, two
    decode steps, 64 round steps: positions n_p - 1 ... n_p + 65) as one
    fp32 tensor on the round's device, and the 67 + n_p - 1 tokens they
    were computed from."""
    dev = run["round_logits"].device
    rows = [torch.as_tensor(run["prefill_logits"][uid], device=dev)[None]]
    rows += [torch.as_tensor(d[uid], device=dev)[None] for d in run["decode_logits"]]
    rows.append(run["round_logits"][:, row].float())
    return torch.cat([r.float() for r in rows]), run["seqs"][uid] + [
        int(t) for t in run["rounds"][uid]][:-1]


def common_rows_rel_err(torch, mine, other, n_p):
    """rows_rel_err over the rows two runs computed from the same tokens:
    ``mine``/``other`` are ``logit_rows`` results of one uid. Returns
    (error or None, rows compared)."""
    (a, ta), (b, tb) = mine, other
    same = 0
    while same < min(len(ta), len(tb)) and ta[same] == tb[same]:
        same += 1
    n = max(0, min(same - n_p + 1, a.shape[0]))
    if n == 0:
        return None, 0
    return rows_rel_err(torch, a[:n], torch.as_tensor(b[:n])), n


def engine_phase(torch, dev, K, widths=None, engine_config=None, profile=False,
                 kv_cache_dtype="bf16", keep=None, bf16_rows=None, hold=None, quant_bits=None,
                 bf16=None, bench_repeats=2):
    """The serving path, counted. ``widths``/``engine_config`` shrink the
    model and the engine for a rehearsal on the CPU; the card run uses
    neither, and serves the preset at its full depth. ``kv_cache_dtype=
    "int8"`` is the engine_int8 phase: the same prompts, logits also held
    against the bf16 phase's (``bf16_rows``, which a bf16 run fills through
    ``keep``) and against the same engine forced to the plain gathers.
    ``hold`` receives the engine, its prompts and each prompt's plain
    greedy stream (the prefill token, two decode steps, the 64-step round)
    for the phases that run on the same engine and weights. ``quant_bits``
    8 or 4 is the serve_wq8 / serve_wq4 phase: the same weights served with
    ``quant.enabled`` (group ``QUANT_GROUP``), its logits held against
    ``forward_reference`` over the same weights dequantized, and
    ``quant_checks`` against the bf16 engine's ``bf16`` record (its
    prefill rows, gen and round tok/s)."""
    import numpy as np

    from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.quantization import model_memory_bytes
    from deepspeed_tpu_torch.inference.v2.engine_v2 import (
        InferenceEngineV2,
        serving_benchmark,
    )
    from deepspeed_tpu_torch.models import transformer as T

    int8 = kv_cache_dtype == "int8"
    t0 = time.perf_counter()
    cfg = T.get_config(MODEL, **(widths or {}))
    phase = (f"serve_wq{quant_bits}" + ("_int8" if int8 else "") if quant_bits
             else "engine_int8" if int8 else "engine")
    rec = {"phase": phase, "model": MODEL, "n_layers": cfg.n_layers,
           "kv_cache_dtype": kv_cache_dtype}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = T.init_params(cfg, gen, dev)
    wide_bytes = model_memory_bytes(params)
    ec = dict(engine_config or ENGINE_CONFIG)
    ec["kv_cache"] = dict(ec["kv_cache"], kv_cache_dtype=kv_cache_dtype)
    if quant_bits:
        ec["quant"] = {"enabled": True, "bits": quant_bits, "group_size": QUANT_GROUP}
    rc = RaggedInferenceEngineConfig.from_dict(ec)
    # serve_wq: layer 0's and the head's wide weights, for quant_weight_check
    wide = None
    if quant_bits:
        wide = {k: w[0].clone() for k, w in params["layers"].items()}
        wide.update({k: params[k].clone() for k in ("lm_head",) if k in params})
    eng = InferenceEngineV2(cfg, params, rc, device=dev.type)
    del params  # a quantized engine's wide weights go with it
    if dev.type == "cuda" and eng.paged_attention_impl != "kernel":
        raise AssertionError(f"paged_attention_impl resolved to {eng.paged_attention_impl}")
    _sync(torch, dev)
    rec["params"] = T.num_params(eng.params)
    rec["setup_seconds"] = time.perf_counter() - t0
    rec["kv_pool_info"] = eng.kv_pool_info()
    if quant_bits:
        rec.update(quant=ec["quant"], model_memory_bytes=model_memory_bytes(eng.params),
                   wide_model_memory_bytes=wide_bytes)
        rec["memory_over_wide"] = rec["model_memory_bytes"] / wide_bytes
        quant_weight_check(torch, eng, wide, rec)
        del wide
    L = cfg.n_layers

    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 512, size=32)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32) for n in lens]

    # ---- the main path, counted: prefill through step(), two single
    # decode steps, one fused round
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    run = serve_counted_path(torch, dev, eng, prompts)
    launches = K.counts()
    split_steps, rounds = run["split_steps"], run["rounds"]
    for key in ("prefill_seconds", "prefill_steps", "round_seconds"):
        rec[key] = run[key]
    rec["round_tok_s"] = 32 * 64 / rec["round_seconds"]
    rec["launches"] = launches
    fwd_steps = split_steps + 64
    expected = {name: 0 for name in launches}
    expected["rms_norm_fwd"] = (2 * L + 1) * fwd_steps
    if int8:  # quantize-on-write: K and V of every layer of every forward step, one launch
        expected.update({"paged_decode_int8": L * fwd_steps, "block_quant": L * fwd_steps})
    else:
        expected["paged_decode"] = L * fwd_steps
    rec["launches_expected"] = expected
    rec["forward_steps"] = {"split": split_steps, "round": 64}
    if dev.type == "cuda" and launches != expected:  # the CPU runs the plain versions
        raise AssertionError(f"kernel launches {launches}, expected {expected}")
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
    if sorted(rounds) != list(range(32)) or any(len(g) != 64 for g in rounds.values()):
        raise AssertionError("decode_round did not give 64 tokens for each of 32 rows")
    for uid, g in rounds.items():
        if not all(0 <= int(t) < cfg.vocab_size for t in g):
            raise AssertionError("decode_round gave a token outside the vocabulary")

    # ---- the plain forward_reference (plain RMSNorm, dense attention: no kernel) on
    # the same tokens, for every slot
    rtol = INT8_LOGIT_RTOL if int8 else LOGIT_RTOL
    errs = {"prefill": [], "decode": [], "round": [], "shifted": []}
    agree = []
    rows_of = {}
    for row, uid in enumerate(rounds):
        got_tok = torch.as_tensor(np.asarray(rounds[uid], np.int64), device=dev)
        mine, toks_in = logit_rows(torch, run, uid, row)  # [67, V]
        rows_of[uid] = (mine, toks_in)
        if not bool((mine[3:].argmax(dim=-1) == got_tok).all()):
            raise AssertionError(f"uid {uid}: round tokens are not the argmax of its logits")
        n_p = len(prompts[uid])
        toks = torch.as_tensor(np.asarray(toks_in + [int(rounds[uid][-1])], np.int64),
                               device=dev)[None]
        with torch.no_grad():
            ref = T.forward_reference(eng.params, toks, cfg)[0][0].float()  # [s, V]
        if not bool(torch.isfinite(ref).all()):
            raise AssertionError("plain forward gave non-finite logits")
        errs["prefill"].append(rows_rel_err(torch, mine[0], ref[n_p - 1]))
        errs["decode"].append(rows_rel_err(torch, mine[1:3], ref[n_p : n_p + 2]))
        errs["round"].append(rows_rel_err(torch, mine[3:], ref[n_p + 2 : n_p + 66]))
        # negative control: the same comparison one position off
        errs["shifted"].append(rows_rel_err(torch, mine[0], ref[n_p - 2]))
        agree.append(float((ref[n_p + 2 : n_p + 66].argmax(dim=-1) == got_tok).float().mean()))
    rec["logit_rel_err"] = {k: max(v) for k, v in errs.items()}
    rec["logit_rel_err"]["shifted"] = min(errs["shifted"])
    rec["logit_rows_checked"] = {k: len(v) * {"round": 64, "decode": 2}.get(k, 1)
                                 for k, v in errs.items()}
    rec["logit_rtol"] = rtol
    # exact agreement with the reference's argmax is reported only: near-ties flip under bf16
    rec["round_argmax_agreement"] = min(agree)
    worst = max(rec["logit_rel_err"][k] for k in ("prefill", "decode", "round"))
    if worst > rtol:
        raise AssertionError(f"engine logits off the plain forward: {rec['logit_rel_err']}")
    if rec["logit_rel_err"]["shifted"] <= rtol:
        raise AssertionError("negative control passed: the logit check cannot tell positions apart")
    for uid in list(eng.scheduler.running_uids()):
        eng.scheduler.finish(uid)
    if hold is not None:
        hold.update(engine=eng, cfg=cfg, prompts=prompts, plain={
            uid: [int(t) for t in run["seqs"][uid][len(prompts[uid]):]]
            + [int(t) for t in run["rounds"][uid]] for uid in run["rounds"]})
    del ref, run
    if keep is not None:  # the bf16 rows on the host, for the int8 phase
        keep.update({uid: (m.cpu(), t) for uid, (m, t) in rows_of.items()})
        keep["prompt_lens"] = [len(p) for p in prompts]

    if int8:
        int8_checks(torch, dev, eng, prompts, rows_of, bf16_rows, rec)
    if quant_bits:
        quant_checks(torch, dev, eng, rows_of, bf16, rec)
    del rows_of

    # ---- serving throughput (generate: prefill + fused rounds)
    t0 = time.perf_counter()
    rec["gen_tok_s"] = serving_benchmark(eng, n_seq=32, max_new=64, repeats=bench_repeats)
    rec["serving_seconds"] = time.perf_counter() - t0
    rec["peak_mem_gb_serving"] = (torch.cuda.max_memory_allocated() / 1e9
                                   if dev.type == "cuda" else None)
    if quant_bits and bf16 is not None:
        rec["gen_tok_s_over_bf16"] = rec["gen_tok_s"] / bf16["gen_tok_s"]
        rec["round_tok_s_over_bf16"] = rec["round_tok_s"] / bf16["round_tok_s"]
    if profile:
        rec["profile"] = profile_engine(torch, eng, rng, cfg.vocab_size)
    return rec, launches


def int8_checks(torch, dev, eng, prompts, rows_of, bf16_rows, rec):
    """The int8 engine's logits against the bf16 phase's (``bf16_rows``:
    the rows each computed from the same tokens) and against the same
    engine forced to ``paged_attention_impl="dense"`` (the plain gathers
    over its own quantized pool) on the same prompts."""
    errs, n_rows = [], 0
    if bf16_rows is not None:
        for uid, mine in rows_of.items():
            err, n = common_rows_rel_err(torch, mine, bf16_rows[uid], len(prompts[uid]))
            if err is not None:
                errs.append(err)
                n_rows += n
        rec["bf16_logit_rel_err"] = max(errs)
        rec["bf16_rows_compared"] = n_rows
    impl = eng._attn_impl
    eng._attn_impl = "dense"
    try:
        dense = serve_counted_path(torch, dev, eng, prompts)
    finally:
        eng._attn_impl = impl
    errs, n_rows = [], 0
    for row, uid in enumerate(dense["rounds"]):
        err, n = common_rows_rel_err(torch, rows_of[uid], logit_rows(torch, dense, uid, row),
                                     len(prompts[uid]))
        if err is not None:
            errs.append(err)
            n_rows += n
    for uid in list(eng.scheduler.running_uids()):
        eng.scheduler.finish(uid)
    rec["dense_logit_rel_err"] = max(errs)
    rec["dense_rows_compared"] = n_rows
    rec["dense_round_seconds"] = dense["round_seconds"]
    if rec["dense_logit_rel_err"] > LOGIT_RTOL or rec.get("bf16_logit_rel_err", 0) > INT8_LOGIT_RTOL:
        raise AssertionError(f"int8 logits off: {rec['dense_logit_rel_err']} against the dense "
                             f"path, {rec.get('bf16_logit_rel_err')} against the bf16 engine")


# weight-only quantized serving (serve_wq8 / serve_wq4): the group of the
# fp32 block scales along each weight's last dim
QUANT_GROUP = 128
# serve_wq8_int8: weight-only int8 over an int8 KV pool (block_quant on
# every K/V write, the int8 paged decode), at Mistral-7B width and 2 of its
# layers: the launches and the logits, not the throughput
QUANT_INT8_POOL_LAYERS = 2
# the quantized engine's prefill logits against the bf16 engine's over the
# same prompts: their correlation. int8 is gated as the JAX package's
# test_forward_close_to_wide gates its (int8) engine: 0.999 there at fp32
# and a tiny width, 0.99 here for bf16 at Mistral-7B width. That JAX test
# gates no int4 model: random weights are Gaussian, and 4 bits over a
# block of 128 of them (a step of absmax / 7, ~0.37 sigma) leave ~11% noise
# on every weight, so an int4 model's logits correlate well below 0.99 with
# the wide model's (0.787 in serve_wq4 on an H100); int4 is held only above
# 0.5, where a wrong dequantization (correlation ~0) fails
QUANT_CORR_MIN = {8: 0.99, 4: 0.5}


# the widened weights against the wide ones they were quantized from,
# relative Frobenius: rounding to a step of absmax / qmax over blocks of
# 128 Gaussian values, then once to bf16, gives 0.0068 (int8) and 0.1174
# (int4) on the host's draws (512 x 4096 and 512 x 14336 at std 0.02); a
# code offset or a scale from the wrong block moves a weight by a step
QUANT_WEIGHT_RTOL = {8: 0.0075, 4: 0.125}


def _host_dequant(torch, qw, dtype):
    """A plain dequantization of ``qw``'s codes and scales on the host, in
    numpy, written apart from ``dequantize_leaf``: int4 bytes split by
    hand (low nibble first, less 7), fp32 products with the block scales,
    one cast to ``dtype``."""
    import numpy as np

    q = qw.q.cpu().numpy()
    if qw.bits == 4:
        u = q.view(np.uint8)
        codes = np.empty(u.shape[:-1] + (2 * u.shape[-1],), np.float32)
        codes[..., 0::2] = (u & 0xF).astype(np.float32) - 7.0
        codes[..., 1::2] = (u >> 4).astype(np.float32) - 7.0
    else:
        codes = q.astype(np.float32)
    s = qw.s.cpu().numpy().astype(np.float32)
    blocks = codes.reshape(codes.shape[:-1] + (-1, qw.group)) * s[..., None]
    return torch.from_numpy(blocks.reshape(codes.shape)).to(dtype)


def quant_weight_check(torch, eng, wide, rec):
    """serve_wq8 / serve_wq4's weights at the source: layer 0's and the
    head's quantized leaves, widened on the card by the engine's own path
    (``_lp``, the head's ``_dequant_tree``), equal bit for bit to
    ``_host_dequant`` of the same codes and scales, and within
    QUANT_WEIGHT_RTOL (relative Frobenius) of ``wide``, the weights they
    were quantized from."""
    from deepspeed_tpu_torch.models import transformer as T

    bits = rec["quant"]["bits"]
    stored, widened = dict(eng._layer_params[0]), dict(eng._lp(0))
    if "lm_head" in eng.params:
        stored["lm_head"] = eng.params["lm_head"]
        widened["lm_head"] = T._dequant_tree(eng.params["lm_head"], eng._dtype)
    out = {}
    for name, qw in stored.items():
        if not isinstance(qw, T.QuantizedWeight):
            continue
        got = widened[name]
        out[name] = {"mismatches": _bits_mismatch(torch, got, _host_dequant(torch, qw, got.dtype)),
                     "rel_frobenius": _rel_fro(torch, got, wide[name].to(got.dtype))}
    rec["weight_check"] = {"leaves": out, "rtol": QUANT_WEIGHT_RTOL[bits],
                           "max_rel_frobenius": max(r["rel_frobenius"] for r in out.values())}
    if (not out or any(r["mismatches"] for r in out.values())
            or rec["weight_check"]["max_rel_frobenius"] > QUANT_WEIGHT_RTOL[bits]):
        raise AssertionError(f"{rec['phase']}: widened weights off: {rec['weight_check']}")


def quant_checks(torch, dev, eng, rows_of, bf16, rec):
    """serve_wq8 / serve_wq4: the prefill logits' correlation with the bf16
    engine's on the same prompts (``bf16["prefill"]``: uid -> row), and
    the time the steps spend widening weights (every layer's and the
    head's, plain torch, timed with CUDA events: eager, as the steps run
    it)."""
    import numpy as np

    from deepspeed_tpu_torch.models import transformer as T

    if bf16 is not None:
        mine = np.concatenate([rows_of[u][0][0].float().cpu().numpy() for u in sorted(bf16["prefill"])])
        wide = np.concatenate([np.asarray(bf16["prefill"][u], np.float32)
                               for u in sorted(bf16["prefill"])])
        rec["bf16_prefill_corr"] = float(np.corrcoef(mine, wide)[0, 1])
        rec["bf16_prefill_rel_err"] = max(
            rows_rel_err(torch, rows_of[u][0][0], bf16["prefill"][u]) for u in bf16["prefill"])
        rec["bf16_prefill_corr_min"] = QUANT_CORR_MIN[rec["quant"]["bits"]]
        if rec["bf16_prefill_corr"] < rec["bf16_prefill_corr_min"]:
            raise AssertionError(f"{rec['phase']}: prefill logits' correlation with the bf16 "
                                 f"engine's {rec['bf16_prefill_corr']} < "
                                 f"{rec['bf16_prefill_corr_min']}")
    L = eng._mc.n_layers

    def widen_layers():
        for li in range(L):
            eng._lp(li)

    def widen_head():
        T._dequant_tree(eng.params["lm_head"], eng._dtype)

    if dev.type == "cuda":
        rec["dequant_layers_ms"] = eager_ms(torch, widen_layers, iters=3, warmup=1)
        rec["dequant_head_ms"] = eager_ms(torch, widen_head, iters=3, warmup=1)
        # a split or round step widens every layer once and the head once
        # (the split step's head twice: decode and chunk rows)
        rec["dequant_ms_per_round_step"] = rec["dequant_layers_ms"] + rec["dequant_head_ms"]
        rec["round_ms_per_step"] = rec["round_seconds"] / 64 * 1e3
        rec["dequant_share_of_round_step"] = (rec["dequant_ms_per_round_step"]
                                              / rec["round_ms_per_step"])


# ---------------------------------------------------------------------------
# speculative decoding, the host block tier, the v1 engine
# ---------------------------------------------------------------------------
# the verify rows whose logits are held against forward_reference in each
# spec round (the oracle round holds all of them)
SPEC_REF_ROWS = 8
SPEC_TIMED_ROUNDS = 5  # timed spec rounds, and as many plain fused rounds


def fmt_spread(d):
    return f"{d['median']:.2f} [{d['min']:.2f}, {d['max']:.2f}]"


def spread(xs):
    """Median, min and max of a list of samples."""
    ys = sorted(xs)
    mid = len(ys) // 2
    med = ys[mid] if len(ys) % 2 else (ys[mid - 1] + ys[mid]) / 2
    return {"median": med, "min": ys[0], "max": ys[-1], "n": len(ys)}


def spec_expected(names, L, int8):
    """A verify step's exact launches: paged decode (its int8 form on an
    int8 pool) L calls, RMSNorm 2L + 1, block_quant L on an int8 pool
    (K and V of each layer's write in one launch), nothing else."""
    expected = {name: 0 for name in names}
    expected["rms_norm_fwd"] = 2 * L + 1
    if int8:
        expected.update({"paged_decode_int8": L, "block_quant": L})
    else:
        expected["paged_decode"] = L
    return expected


def engine_spec_phase(torch, dev, K, eng, prompts, plain, int8=False):
    """Speculative decoding on the engine phase's engine (its weights, its
    prompts): prefill through ``step_tokens``, then ``spec_round(4)`` with
    oracle drafts (the tokens the engine phase's plain decode emitted for
    the same sequences), junk drafts (those tokens shifted by one: all
    rejected, one token a row), no drafts, oracle drafts again; then a plain
    ``decode_round(5)``. In each round every emitted token is the argmax of
    the verify step's own logits at its slot, and the verify logits of
    every valid slot are held against ``forward_reference`` over the same
    tokens (every row in the oracle rounds, ``SPEC_REF_ROWS`` otherwise);
    the first round's launches are counted exactly. Greedy streams are
    compared token for token on the CPU only (the tests): on a card the
    R * (k + 1)-row products may round otherwise than the R-row ones, so a
    near-tie can flip a token, and the oracle tokens accepted are printed
    instead."""
    import numpy as np

    from deepspeed_tpu_torch.models import transformer as T

    t_phase = time.perf_counter()
    sched, cfg = eng.scheduler, eng._mc
    L, V, K1 = cfg.n_layers, cfg.vocab_size, SPEC_K + 1
    rtol = INT8_LOGIT_RTOL if int8 else LOGIT_RTOL
    rec = {"phase": "engine_spec_int8" if int8 else "engine_spec", "k": SPEC_K,
           "n_layers": L, "rows": len(prompts), "logit_rtol": rtol}
    for uid, p in enumerate(prompts):
        sched.submit(uid, p)
    hist = {uid: [int(t) for t in p] for uid, p in enumerate(prompts)}
    first = {}
    while sched.has_pending():
        first.update(eng.step_tokens())
    for uid, tok in first.items():
        hist[uid].append(tok)
        sched.feedback(uid, tok)

    def oracle(uid):
        gen = hist[uid][len(prompts[uid]):]
        if gen != plain[uid][: len(gen)]:
            return None  # the stream left the plain one (a near-tie flipped)
        return plain[uid][len(gen) : len(gen) + SPEC_K]

    def spec(kind, counted=False, ref_rows=SPEC_REF_ROWS):
        if kind == "oracle":
            drafts = {uid: oracle(uid) or [] for uid in sched.running_uids()}
        elif kind == "junk":
            drafts = {uid: [(t + 1) % V for t in (oracle(uid) or hist[uid][-SPEC_K:])]
                      for uid in sched.running_uids()}
        else:
            drafts = {}
        before = {uid: list(h) for uid, h in hist.items()}
        seen = []
        sample = eng._sample

        def keep(logits, *a, **k):
            seen.append(logits)
            return sample(logits, *a, **k)

        eng._sample = keep
        try:
            if counted:
                K.reset_counts()
            _sync(torch, dev)
            t0 = time.perf_counter()
            res = eng.spec_round(SPEC_K, drafts=drafts)
            _sync(torch, dev)
            seconds = time.perf_counter() - t0
            launches = K.counts() if counted else None
        finally:
            del eng._sample  # back to the class's method
        logits = seen[0].float()  # [R * K1, V]
        out = {"kind": kind, "seconds": seconds, "drafted": eng.last_spec["drafted"],
               "accepted": eng.last_spec["accepted"],
               "emitted": sum(len(g) for g in res.values()), "launches": launches}
        errs, shifted = [], []
        for i, (uid, gen) in enumerate(res.items()):
            rows = logits[i * K1 : i * K1 + len(gen)]
            if not bool((rows.argmax(dim=-1).cpu() == torch.as_tensor(
                    np.asarray(gen, np.int64))).all()):
                raise AssertionError(f"{kind} round, uid {uid}: emitted tokens are not the "
                                     "argmax of the verify step's logits")
            if kind == "junk" and len(gen) != 1:
                raise AssertionError(f"junk drafts accepted for uid {uid}: {len(gen) - 1}")
            if i < ref_rows:
                n_in = 1 + len(drafts.get(uid) or [])
                toks = torch.as_tensor(np.asarray(before[uid] + list(drafts.get(uid) or []),
                                                  np.int64), device=dev)[None]
                with torch.no_grad():
                    ref = T.forward_reference(eng.params, toks, cfg)[0][0].float()
                p = len(before[uid]) - 1
                errs.append(rows_rel_err(torch, logits[i * K1 : i * K1 + n_in], ref[p : p + n_in]))
                shifted.append(rows_rel_err(torch, logits[i * K1], ref[p - 1]))
            hist[uid].extend(int(t) for t in gen)
        out["rows_checked"] = len(errs)
        if not errs:
            return out
        out["logit_rel_err"] = max(errs)
        out["logit_rel_err_shifted"] = min(shifted)
        if out["logit_rel_err"] > rtol:
            raise AssertionError(f"{kind} round: verify logits off forward_reference: "
                                 f"{out['logit_rel_err']} (limit {rtol})")
        if out["logit_rel_err_shifted"] <= rtol:
            raise AssertionError("negative control passed: the verify logit check cannot tell "
                                 "positions apart")
        return out

    rounds = [spec("oracle", counted=True, ref_rows=len(prompts)), spec("junk"), spec("none"),
              spec("oracle", ref_rows=len(prompts))]
    launches = rounds[0]["launches"]
    expected = spec_expected(launches, L, int8)
    if dev.type == "cuda" and launches != expected:  # the CPU runs the plain versions
        raise AssertionError(f"verify step launches {launches}, expected {expected}")
    rec.update(launches=launches, launches_expected=expected, rounds=rounds)
    if rounds[2]["emitted"] != rounds[2]["drafted"] + len(prompts) or rounds[2]["drafted"]:
        raise AssertionError("a round with no drafts must emit one token a row")
    oracle_drafted = sum(r["drafted"] for r in rounds if r["kind"] == "oracle")
    oracle_accepted = sum(r["accepted"] for r in rounds if r["kind"] == "oracle")
    if oracle_accepted == 0:
        raise AssertionError("no oracle draft was accepted")
    rec.update(oracle_drafted=oracle_drafted, oracle_accepted=oracle_accepted,
               oracle_acceptance=oracle_accepted / max(1, oracle_drafted))
    # timing: SPEC_TIMED_ROUNDS more oracle rounds (argmax-checked, no
    # reference), then as many plain fused rounds of k + 1 tokens a row on
    # the same engine and rows; each round on the host clock around a sync,
    # reported as median, min and max over the rounds
    timed = [spec("oracle", ref_rows=0) for _ in range(SPEC_TIMED_ROUNDS)]
    verify_ms = [r["seconds"] * 1e3 for r in timed]
    spec_tok_s = [r["emitted"] / r["seconds"] for r in timed]
    plain_ms, plain_tok_s, plain_tokens = [], [], []
    for _ in range(SPEC_TIMED_ROUNDS):
        _sync(torch, dev)
        t0 = time.perf_counter()
        res = eng.decode_round(K1)
        _sync(torch, dev)
        dt = time.perf_counter() - t0
        n_tok = sum(len(g) for g in res.values())
        plain_ms.append(dt * 1e3)
        plain_tok_s.append(n_tok / dt)
        plain_tokens.append(n_tok)
    rec.update(timed_rounds=SPEC_TIMED_ROUNDS,
               timed_oracle_drafted=sum(r["drafted"] for r in timed),
               timed_oracle_accepted=sum(r["accepted"] for r in timed),
               verify_ms=spread(verify_ms), spec_tok_s=spread(spec_tok_s),
               plain_round_tokens=plain_tokens, plain_round_ms=spread(plain_ms),
               plain_round_tok_s=spread(plain_tok_s))
    rec["spec_over_plain_tok_s"] = (rec["spec_tok_s"]["median"]
                                    / rec["plain_round_tok_s"]["median"])
    for uid in list(sched.running_uids()):
        sched.finish(uid)
    rec["seconds_in_phase"] = time.perf_counter() - t_phase
    return rec, launches


# the host-tier leg: 8 prompts of five 128-token blocks and a tail; a pool
# of 64 blocks holds one batch's 48, so a second batch evicts the first
# batch's cached blocks (spilled to the host tier), and resubmitting the
# first batch readmits them in windows of 2 blocks
HOST_TIER_CONFIG = {
    "dtype": "bfloat16", "decode_steps": 1, "prompt_chunk": 256, "max_prompt_chunks": 4,
    "kv_cache": {"block_size": 128, "num_blocks": 64, "max_blocks_per_seq": 8,
                 "prefix_cache": True, "host_tier_bytes": 8 << 30,
                 "host_tier_chunk_blocks": 2},
    "state_manager": {"max_tracked_sequences": 16, "max_ragged_batch_size": 1024,
                      "max_ragged_sequence_count": 8, "max_context": 1024},
}
HOST_TIER_PROMPTS = (8, 5, 17)  # prompts a batch, cached blocks a prompt, tail tokens


def host_tier_phase(torch, dev, K, cfg, params, engine_config=None, shape=HOST_TIER_PROMPTS,
                    kv_cache_dtype="bf16"):
    """The host block tier on the engine phase's weights: batch 1 served
    (its full prompt blocks cached), batch 2 evicts them (spilled), batch 1
    resubmitted readmits them through ``import_kv_blocks_chunked``. Checks:
    spills and readmits > 0, the resubmission's prefill schedules only the
    tails, each readmitted block's exported planes equal the spilled
    payload bit for bit, and the resubmitted prompts' logits are within the
    engine's tolerance of ``forward_reference``. Prints the chunked
    import's GB/s (staging into pinned memory, the windows' copies and
    scatters, on the host clock around each import) and the share of it
    the staging takes (on the host clock around ``_stage_windows``)."""
    import numpy as np

    from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.v2.host_tier import chain_hashes
    from deepspeed_tpu_torch.models import transformer as T

    t_phase = time.perf_counter()
    ec = dict(engine_config or HOST_TIER_CONFIG)
    ec["kv_cache"] = dict(ec["kv_cache"], kv_cache_dtype=kv_cache_dtype)
    eng = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig.from_dict(ec),
                            device=dev.type)
    bs = eng.config.kv_cache.block_size
    n, nblk, tail = shape
    rng = np.random.default_rng(SEED + 2)
    batches = [[rng.integers(0, cfg.vocab_size, size=nblk * bs + tail).astype(np.int32)
                for _ in range(n)] for _ in range(2)]
    store = eng.host_tier
    spilled, fetched = {}, []
    put, get = store.put, store.get

    def put_copy(key, payload, **kw):
        spilled[key] = {name: np.array(p) for name, p in payload.items()}
        return put(key, payload, **kw)

    def get_noted(key):
        fetched.append(key)
        return get(key)

    store.put, store.get = put_copy, get_noted
    imports = {"seconds": 0.0, "stage_seconds": 0.0, "bytes": 0, "calls": 0, "blocks": 0}
    chunked, stage = eng.import_kv_blocks_chunked, eng._stage_windows

    def timed_stage(*a, **kw):
        t0 = time.perf_counter()
        out = stage(*a, **kw)
        imports["stage_seconds"] += time.perf_counter() - t0
        return out

    def timed_import(block_ids, payload, chunk_blocks=0):
        _sync(torch, dev)
        t0 = time.perf_counter()
        chunked(block_ids, payload, chunk_blocks)
        _sync(torch, dev)
        imports["seconds"] += time.perf_counter() - t0
        imports["bytes"] += sum(p.nbytes for p in payload.values())
        imports["calls"] += 1
        imports["blocks"] += len(block_ids)

    eng.import_kv_blocks_chunked, eng._stage_windows = timed_import, timed_stage
    rec = {"phase": "host_tier", "kv_cache_dtype": kv_cache_dtype, "n_layers": cfg.n_layers,
           "prompts": [n, nblk * bs + tail], "num_blocks": eng.config.kv_cache.num_blocks}
    try:
        for b in batches:
            eng.generate(b, max_new_tokens=4)
        rec["spills_before_resubmit"] = store.stats()["spills"]
        sched = eng.scheduler
        for uid, p in enumerate(batches[0]):
            sched.submit(uid, p)
        scheduled, logits = 0, {}
        while sched.has_pending():
            logits.update(eng.step())
            scheduled += eng.last_scheduled_tokens
        st = store.stats()
        # the trie and the tier may cover every full block but the last
        # token's: the tails
        tails = sum(len(p) - (len(p) - 1) // bs * bs for p in batches[0])
        rec.update(spills=st["spills"], readmits=st["readmits"], prefill_tokens=scheduled,
                   prefill_tokens_tails=tails, store_blocks=st["blocks"],
                   store_bytes=st["bytes"])
        if not (st["spills"] > 0 and st["readmits"] > 0):
            raise AssertionError(f"the cycle spilled {st['spills']}, readmitted "
                                 f"{st['readmits']}: it tested nothing")
        if scheduled != tails:
            raise AssertionError(f"the resubmission prefilled {scheduled} tokens, expected "
                                 f"only the tails' {tails}")
        checked = 0
        for uid, p in enumerate(batches[0]):
            seq = eng.state_manager.get_sequence(uid)
            for i, key in enumerate(chain_hashes(p, bs, (len(p) - 1) // bs)):
                if key not in fetched:
                    continue
                got = eng.export_kv_blocks([seq.block_table[i]])
                for name, plane in got.items():
                    if not np.array_equal(plane[:, 0], spilled[key][name]):
                        raise AssertionError(f"uid {uid} block {i}: readmitted {name} plane "
                                             "differs from the spilled payload")
                checked += 1
        if checked != st["readmits"]:
            raise AssertionError(f"{checked} readmitted blocks checked of {st['readmits']}")
        rec["blocks_checked_bitwise"] = checked
        errs, shifted = [], []
        for uid, p in enumerate(batches[0]):
            toks = torch.as_tensor(p.astype(np.int64), device=dev)[None]
            with torch.no_grad():
                ref = T.forward_reference(eng.params, toks, cfg)[0][0].float()
            errs.append(rows_rel_err(torch, torch.as_tensor(logits[uid]), ref[-1].cpu()))
            shifted.append(rows_rel_err(torch, torch.as_tensor(logits[uid]), ref[-2].cpu()))
        rtol = INT8_LOGIT_RTOL if kv_cache_dtype == "int8" else LOGIT_RTOL
        rec.update(logit_rel_err=max(errs), logit_rel_err_shifted=min(shifted), logit_rtol=rtol)
        if rec["logit_rel_err"] > rtol or rec["logit_rel_err_shifted"] <= rtol:
            raise AssertionError(f"readmitted prompts' logits: {rec['logit_rel_err']} against "
                                 f"forward_reference, control {rec['logit_rel_err_shifted']}")
        for uid in list(sched.running_uids()):
            sched.finish(uid)
    finally:
        store.put, store.get = put, get
    rec["chunked_import"] = dict(imports, gb_s=imports["bytes"] / max(imports["seconds"], 1e-9)
                                 / 1e9, stage_share=imports["stage_seconds"]
                                 / max(imports["seconds"], 1e-9))
    rec["seconds_in_phase"] = time.perf_counter() - t_phase
    return rec


V1_PROMPTS = (4, 512)  # batch, prompt tokens
V1_NEW_TOKENS = 16
V1_NOTE = ("inference_v1: the v1 engine's cached decode attends with a dense bias, which the "
           "flash kernels do not take, so it calls mha_reference on a card too: no attention "
           "kernel launches; its norms are the RMSNorm kernel")


def inference_v1_phase(torch, dev, K, cfg, params, shape=V1_PROMPTS, new=V1_NEW_TOKENS):
    """The v1 engine through ``init_inference`` on the engine phase's
    weights: 4 prompts of 512 tokens, 16 greedy tokens, at decode_steps 1
    and 4. Checks: the first token's logits (the prefill's last row) against
    ``forward_reference``, equal streams at both settings, exactly 2L + 1
    RMSNorm launches a forward step and no other kernel."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import engine as v1
    from deepspeed_tpu_torch.models import transformer as T

    t_phase = time.perf_counter()
    b, s = shape
    L = cfg.n_layers
    toks = np.random.default_rng(SEED + 3).integers(0, cfg.vocab_size, size=(b, s)).astype(
        np.int32)
    rec = {"phase": "inference_v1", "n_layers": L, "prompts": [b, s], "new_tokens": new,
           "runs": {}}
    firsts = []
    draw = v1.sample_step

    def keep(logits, seed, step, *a, **k):
        if step == -1:
            firsts.append(logits)
        return draw(logits, seed, step, *a, **k)

    v1.sample_step = keep
    outs = {}
    try:
        for ds in (1, 4):
            eng = deepspeed_tpu_torch.init_inference(
                (cfg, params), {"dtype": cfg.dtype, "decode_steps": ds, "max_tokens": 1024},
                device=dev.type)
            K.reset_counts()
            _sync(torch, dev)
            t0 = time.perf_counter()
            outs[ds] = eng.generate(toks, max_new_tokens=new)
            _sync(torch, dev)
            dt = time.perf_counter() - t0
            launches = K.counts()
            steps = 1 + -(-(new - 1) // ds) * ds  # the prefill and the decode steps run
            expected = {name: 0 for name in launches}
            expected["rms_norm_fwd"] = (2 * L + 1) * steps
            if dev.type == "cuda" and launches != expected:
                raise AssertionError(f"v1 decode_steps {ds}: launches {launches}, expected "
                                     f"{expected}")
            rec["runs"][ds] = {"seconds": dt, "tok_s": b * new / dt, "forward_steps": steps,
                               "launches": launches, "launches_expected": expected}
            del eng
    finally:
        v1.sample_step = draw
    if not np.array_equal(outs[1], outs[4]):
        raise AssertionError("decode_steps 4 gave another stream than decode_steps 1")
    with torch.no_grad():
        ref = T.forward_reference(params, torch.as_tensor(toks.astype(np.int64), device=dev),
                                  cfg)[0].float()
    rec["logit_rel_err"] = rows_rel_err(torch, firsts[0], ref[:, -1])
    rec["logit_rel_err_shifted"] = rows_rel_err(torch, firsts[0], ref[:, -2])
    rec["first_token_agreement"] = float((ref[:, -1].argmax(-1).cpu().numpy()
                                          == outs[1][:, s]).mean())
    if rec["logit_rel_err"] > LOGIT_RTOL or rec["logit_rel_err_shifted"] <= LOGIT_RTOL:
        raise AssertionError(f"v1 first-token logits: {rec['logit_rel_err']} against "
                             f"forward_reference, control {rec['logit_rel_err_shifted']}")
    for t in outs[1][:, s:].reshape(-1):
        if not 0 <= int(t) < cfg.vocab_size:
            raise AssertionError("the v1 engine gave a token outside the vocabulary")
    rec["seconds_in_phase"] = time.perf_counter() - t_phase
    return rec


# ---------------------------------------------------------------------------
# phase 3b: the serving stack (driver, HTTP server, tracing) on the engine
# phase's engine
# ---------------------------------------------------------------------------
# 32 clients at once, every other one streamed; prompts of 128-600 tokens,
# every 4th a 16-token motif repeated (the n-gram proposer drafts there),
# 32 new tokens each (600 + 32 fits the 640-token context)
SERVE_CLIENTS = 32
SERVE_PROMPT_LENS = (128, 600)
SERVE_NEW_TOKENS = 32
SERVE_MOTIF_EVERY = 4
SERVE_WAIT_S = 120
# each served token's logit under the plain forward, below the row's
# largest, relative to the row's largest magnitude (``compare_streams``).
# Sound passes on an H100 read 0.0137-0.0189 over 1024 tokens, bf16 and
# int8 pools alike (the int8 codes' rounding does not show at this
# margin); the planted feedback fault (``feedback_fault``) reads 0.63 on
# both. The limit sits between: twice the largest sound reading.
SERVE_MARGIN_RTOL = 0.04
# the plain versions of the served kernels: none may run on the card
PLAIN_VERSIONS = (
    ("deepspeed_tpu_torch.ops.normalization.fused_norm", "rms_norm_reference"),
    ("deepspeed_tpu_torch.ops.attention.paged", "paged_decode_attention_dense"),
    ("deepspeed_tpu_torch.ops.attention.paged", "paged_attention_reference"),
    ("deepspeed_tpu_torch.ops.quantizer.block_quant", "block_quant_reference"),
)
# the dstpu serve subprocess on hf_import's checkpoint: its flags, two
# requests of this many tokens, and how long it may take to listen
SERVE_CLI_FLAGS = ("--num-blocks", "64", "--max-blocks-per-seq", "5", "--max-context", "640",
                   "--max-concurrent", "8")
SERVE_CLI_NEW = 16
SERVE_CLI_WAIT_S = 300


def serve_prompts(vocab, n=SERVE_CLIENTS, lens=SERVE_PROMPT_LENS, seed=SEED + 5):
    """The serving phase's prompts: lengths in ``lens``, every
    ``SERVE_MOTIF_EVERY``-th a 16-token motif repeated."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(lens[0], lens[1] + 1))
        if i % SERVE_MOTIF_EVERY == 0:
            p = np.resize(rng.integers(0, vocab, size=16), length)
        else:
            p = rng.integers(0, vocab, size=length)
        out.append(p.astype(np.int32))
    return out


def percentiles(xs, qs=(50, 99)):
    """{"p50": ..., "p99": ...} of ``xs`` (linear interpolation), None for
    an empty list."""
    import numpy as np

    xs = [float(x) for x in xs if x is not None]
    return {f"p{q}": (float(np.percentile(xs, q)) if xs else None) for q in qs}


def idle_share(busy_ms, wall_ms):
    """The share of ``wall_ms`` in which no kernel ran (None when the
    profiler saw no device time)."""
    if busy_ms is None or not wall_ms:
        return None
    return max(0.0, 1.0 - busy_ms / wall_ms)


def first_divergence(got, want):
    """Index of the first token where two streams differ (a shorter one
    differs where it ends); None when equal."""
    for i, (a, b) in enumerate(zip(got, want)):
        if int(a) != int(b):
            return i
    return None if len(got) == len(want) else min(len(got), len(want))


def compare_streams(torch, eng, prompts, got, want, rtol):
    """Served streams ``got`` against ``engine.generate()``'s ``want``, and
    every served token against the plain ``forward_reference`` on its
    prompt and the tokens served before it: the token's logit must be
    within ``rtol`` of the row's largest logit, relative to the row's
    largest magnitude (a greedy pick up to rounding). A batch of another
    composition sums in another order, so a bf16 stream may leave
    ``generate()``'s where two tokens are that close; each such first
    divergence is reported with the two tokens' margin. Returns {"equal":
    streams equal to generate()'s, "near_tie_flips": [...],
    "tokens_checked", "max_margin"}; raises on a token past the limit
    (``rtol`` None: reads the margins and raises on none) or a stream of
    another length."""
    import numpy as np

    from deepspeed_tpu_torch.models import transformer as T

    out = {"equal": 0, "near_tie_flips": [], "tokens_checked": 0, "max_margin": 0.0}
    for uid, (p, g, w) in enumerate(zip(prompts, got, want)):
        if len(g) != len(w):
            raise AssertionError(f"served stream {uid}: {len(g)} tokens, generate() {len(w)}")
        seq = np.concatenate([p, np.asarray(g[:-1], np.int32)]).astype(np.int64)
        with torch.no_grad():
            rows = T.forward_reference(eng.params, torch.as_tensor(seq, device=eng.device)[None],
                                       eng._mc)[0][0, len(p) - 1:].float()  # [len(g), V]
        idx = torch.as_tensor(np.asarray(g, np.int64), device=rows.device)
        scale = rows.abs().amax(-1)
        margins = (rows.amax(-1) - rows.gather(1, idx[:, None])[:, 0]) / scale
        worst = float(margins.max())
        out["tokens_checked"] += len(g)
        out["max_margin"] = max(out["max_margin"], worst)
        if rtol is not None and worst > rtol:
            i = int(margins.argmax())
            raise AssertionError(f"served stream {uid}: token {i} ({int(g[i])}) is {worst:.4f} "
                                 f"below the plain forward's largest logit (limit {rtol})")
        d = first_divergence(g, w)
        if d is None:
            out["equal"] += 1
            continue
        flip = float((rows[d, int(w[d])] - rows[d, int(g[d])]).abs() / scale[d])
        out["near_tie_flips"].append({"uid": uid, "at": d, "margin": flip})
    return out


@contextlib.contextmanager
def recorded_schedule(eng):
    """Records what the serving loop asks of ``eng`` while the block runs,
    in order: each prompt handed to its scheduler ("submit", (uid,
    tokens)) and each engine call: a split step ("step", None), a fused
    round ("round", n_steps), a verify round ("spec", (k, drafts)). The
    engine's own methods are back in place after."""
    import numpy as np

    log, sched = [], eng.scheduler
    submit, step, round_, spec = sched.submit, eng.step_tokens, eng.decode_round, eng.spec_round

    def rec_submit(uid, tokens):
        log.append(("submit", (int(uid), np.asarray(tokens, np.int32).reshape(-1).copy())))
        return submit(uid, tokens)

    def rec_step():
        log.append(("step", None))
        return step()

    def rec_round(n_steps=None):
        log.append(("round", n_steps))
        return round_(n_steps)

    def rec_spec(k=None, drafts=None):
        log.append(("spec", (k, {u: list(d) for u, d in (drafts or {}).items()})))
        return spec(k, drafts=drafts)

    sched.submit, eng.step_tokens, eng.decode_round, eng.spec_round = (
        rec_submit, rec_step, rec_round, rec_spec)
    try:
        yield log
    finally:
        del sched.submit, eng.step_tokens, eng.decode_round, eng.spec_round


def replay_schedule(torch, eng, log, new_tokens):
    """The engine's own steps on a recorded serving schedule, with no
    driver, server or thread: every prompt submitted where the loop
    submitted it and every call made as the loop made it, so each batch
    holds the rows the driver's did; the tokens are fed back, and a
    sequence finished at ``new_tokens``, here. Returns {prompt tuple:
    tokens}."""
    sched, out, prompt_of = eng.scheduler, {}, {}

    def take(uid, toks, feedback):
        got = out[uid]
        for t in toks:
            got.append(int(t))
            if len(got) == new_tokens:
                sched.finish(uid)
                return
        if feedback:
            sched.feedback(uid, got[-1])

    with torch.no_grad():
        for kind, arg in log:
            if kind == "submit":
                uid, prompt = arg
                sched.submit(uid, prompt)
                out[uid], prompt_of[uid] = [], tuple(int(t) for t in prompt)
            elif kind == "step":
                for uid, tok in eng.step_tokens().items():
                    take(uid, [tok], True)
            elif kind == "round":
                for uid, toks in eng.decode_round(arg).items():
                    take(uid, toks, False)
            else:
                for uid, toks in eng.spec_round(arg[0], drafts=arg[1]).items():
                    take(uid, toks, False)
    if sched.has_work():
        raise AssertionError("replayed schedule: sequences left in the scheduler")
    return {prompt_of[uid]: toks for uid, toks in out.items()}


def compare_replay(prompts, got, replayed):
    """Each client's stream against the engine's steps replayed on the
    driver's schedule (``replay_schedule``): token for token. Returns
    {"equal": streams equal, "diverged": [{"client", "at"}, ...]}."""
    out = {"equal": 0, "diverged": []}
    for i, (p, g) in enumerate(zip(prompts, got)):
        want = replayed.get(tuple(int(t) for t in p))
        d = 0 if want is None else first_divergence(g, want)
        if d is None:
            out["equal"] += 1
        else:
            out["diverged"].append({"client": i, "at": d})
    return out


@contextlib.contextmanager
def feedback_fault(vocab):
    """A planted driver fault, the serving checks' negative control: while
    the block runs, the driver streams each split-step token as computed
    but feeds the scheduler the next id in the vocabulary, so the engine
    goes on from a context the client never saw."""
    from deepspeed_tpu_torch.serving.driver import ServingDriver

    deliver = ServingDriver._deliver

    def faulty(self, req, token, feedback=True):
        if not feedback:
            return deliver(self, req, token, feedback=False)
        sched = self.engine.scheduler
        real = sched.feedback
        sched.feedback = lambda uid, tok: real(uid, (int(tok) + 1) % vocab)
        try:
            return deliver(self, req, token, feedback=True)
        finally:
            del sched.feedback

    ServingDriver._deliver = faulty
    try:
        yield
    finally:
        ServingDriver._deliver = deliver


@contextlib.contextmanager
def plain_version_calls():
    """Counts calls of the served kernels' plain versions while the block
    runs (each module attribute wrapped, then restored)."""
    import importlib

    calls, saved = {}, []
    for mod_name, attr in PLAIN_VERSIONS:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        calls[attr] = 0

        def counted(*a, _fn=fn, _attr=attr, **k):
            calls[_attr] += 1
            return _fn(*a, **k)

        saved.append((mod, attr, fn))
        setattr(mod, attr, counted)
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def parse_prometheus(text):
    """Exposition text -> {name{labels}: value}; raises on a malformed line."""
    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^}]*\})?) (\S+)$')
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("# TYPE "):
            continue
        m = sample.match(line)
        if m is None:
            raise AssertionError(f"/metrics: not Prometheus text: {line!r}")
        out[m.group(1)] = float(m.group(2))
    return out


def _http(url, body=None, timeout=SERVE_WAIT_S):
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def http_clients(base, prompts, new_tokens, timeout=SERVE_WAIT_S):
    """One client thread per prompt, all POSTing ``/generate`` at once,
    every other one streamed. Returns each client's tokens."""
    import threading

    out = [None] * len(prompts)
    errors = []

    def client(i):
        try:
            body = _http(f"{base}/generate", {"tokens": [int(t) for t in prompts[i]],
                                              "max_new_tokens": new_tokens, "ignore_eos": True,
                                              "stream": i % 2 == 1}, timeout)
            if i % 2:
                out[i] = [json.loads(line)["token"] for line in body.splitlines() if line]
            else:
                reply = json.loads(body)
                if reply["finish_reason"] != "max_tokens":
                    raise AssertionError(f"client {i}: {reply}")
                out[i] = reply["tokens"]
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serving clients failed: {errors[:4]}")
    return out


def device_busy_ms(torch, fn):
    """``fn()`` under torch.profiler with the CUDA activity alone (no host
    operator records): (its wall ms, the ms in which any device activity
    ran, None when the profiler saw none). The union of the device events'
    intervals is taken from the profiler's raw events: building its
    per-operator tables for a serving pass's ~10^5 kernels takes minutes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((ev.start_ns(), ev.end_ns()) for ev in prof.profiler.kineto_results.events()
                   if ev.device_type() == DeviceType.CUDA and ev.end_ns() > ev.start_ns())
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return wall, (busy / 1e6 if busy > 0 else None)


def served_pass(torch, dev, K, eng, prompts, new_tokens, decode_steps, spec_k=0, trace=False,
                profile=False, record=False, fault=False):
    """One pass of the serving stack: a ``ServingDriver`` over ``eng``
    behind ``start_server(port=0)``, every prompt from its own client
    thread at once; the driver and the server are shut down in every case.
    Returns the clients' tokens, the requests' TTFT / TPOT, the kernel
    launches (counted from the driver's start), the plain versions' calls,
    the wall seconds, /health once idle, /metrics parsed, with ``trace``
    the /debug/trace Chrome document, and with ``record`` the schedule the
    loop ran (``recorded_schedule``). ``fault`` plants ``feedback_fault``."""
    from deepspeed_tpu_torch.observability import configure_tracing
    from deepspeed_tpu_torch.serving import ServingDriver
    from deepspeed_tpu_torch.serving.server import start_server

    out = {}
    if trace:
        configure_tracing(enabled=True, max_events=1 << 18, capture="all")
    driver = ServingDriver(eng, decode_steps=decode_steps, spec_k=spec_k,
                           max_queue=2 * len(prompts))
    reqs = []
    submit = driver.submit

    def recorded(*a, **k):
        req = submit(*a, **k)
        reqs.append(req)
        return req

    driver.submit = recorded
    server = None
    with contextlib.ExitStack() as planted:
        log = planted.enter_context(recorded_schedule(eng)) if record else None
        if fault:
            planted.enter_context(feedback_fault(eng._mc.vocab_size))
        try:
            with plain_version_calls() as plain:
                K.reset_counts()
                driver.start()
                server = start_server(driver, host="127.0.0.1", port=0)
                base = "http://%s:%d" % server.server_address[:2]
                run = lambda: out.__setitem__("tokens", http_clients(base, prompts, new_tokens))  # noqa: E731
                t0 = time.perf_counter()
                if profile and dev.type == "cuda":
                    out["profiled_wall_ms"], out["device_busy_ms"] = device_busy_ms(torch, run)
                else:
                    run()
                out["seconds"] = time.perf_counter() - t0
                out["launches"] = K.counts()
            out["plain_calls"] = dict(plain)
            deadline = time.monotonic() + SERVE_WAIT_S
            while True:
                health = json.loads(_http(f"{base}/health"))
                if health["active_requests"] == 0 and health["queue_depth"] == 0:
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"the driver never went idle: {health}")
                time.sleep(0.01)
            out["health"] = health
            out["metrics"] = parse_prometheus(_http(f"{base}/metrics").decode())
            if trace:
                out["trace"] = json.loads(_http(f"{base}/debug/trace?format=chrome"))
        finally:
            if server is not None:
                server.shutdown()
                server.server_close()
            driver.shutdown(drain=False, timeout=60)
            if trace:
                configure_tracing(enabled=False)
    out["schedule"] = log
    out["snapshot"] = driver.metrics.snapshot()
    out["ttft_s"] = [r.ttft_s for r in reqs]
    out["tpot_s"] = [r.tpot_s for r in reqs]
    out["generated"] = sum(len(r.generated) for r in reqs)
    return out


def trace_summary(doc, n_requests):
    """The /debug/trace document's engine spans and request trees: the
    dispatch and device-wait spans (count, ms) on the engine track and the
    requests with a tree (their root span ``request``)."""
    from deepspeed_tpu_torch.observability import validate_chrome_trace

    errs = validate_chrome_trace(doc)
    if errs:
        raise AssertionError(f"/debug/trace: not a valid Chrome trace: {errs[:4]}")
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    out = {"events": len(doc["traceEvents"])}
    for name in ("engine.dispatch", "engine.device_wait", "step.split", "round.fused",
                 "round.verify"):
        spans = [e for e in xs if e["name"] == name and e["pid"] == 2]
        out[name] = {"count": len(spans), "ms": sum(e["dur"] for e in spans) / 1e3}
    roots = {e["tid"] for e in xs if e["pid"] == 1 and e["name"] == "request"}
    out["request_trees"] = len(roots)
    if not out["engine.dispatch"]["count"] or not out["engine.device_wait"]["count"]:
        raise AssertionError(f"/debug/trace holds no engine.dispatch / device_wait spans: {out}")
    if out["request_trees"] != n_requests:
        raise AssertionError(f"/debug/trace: {out['request_trees']} request trees for "
                             f"{n_requests} requests")
    wait = out["engine.device_wait"]["ms"]
    out["device_wait_share"] = wait / (wait + out["engine.dispatch"]["ms"])
    return out


def serving_phase(torch, dev, K, eng, int8=False, prompts=None, new_tokens=SERVE_NEW_TOKENS,
                  spec_k=SPEC_K):
    """The serving stack at the engine phase's engine (bf16 pool; ``int8``:
    the engine_int8 phase's): the requests' streams against
    ``engine.generate()`` on the same prompts (``compare_streams``), a timed
    pass (TTFT, TPOT, tok/s), a profiled pass (the device's idle share),
    a traced pass (/debug/trace valid, dispatch and device-wait spans, one
    tree per request), a speculative pass (``NgramProposer``, k ``spec_k``)
    and a planted pass (``feedback_fault``). The timed, speculative and
    planted passes record the driver's schedule and replay it on the
    engine (``replay_schedule``): the sound passes' streams must equal the
    replay token for token, the planted pass's must leave it and pass the
    margin limit. The int8 engine runs the timed, profiled and planted
    passes. Launches of the served kernels are counted in each pass; the
    plain versions must not run on a card. Returns (record, launches of
    the timed pass)."""
    ds = int(eng.config.decode_steps)
    prompts = prompts if prompts is not None else serve_prompts(eng._mc.vocab_size)
    rtol = SERVE_MARGIN_RTOL
    nb = eng.config.kv_cache.num_blocks
    rec = {"phase": "serving_int8" if int8 else "serving", "clients": len(prompts),
           "streamed": len(prompts) // 2, "new_tokens": new_tokens, "decode_steps": ds,
           "prompt_lens": [min(len(p) for p in prompts), max(len(p) for p in prompts)],
           "logit_rtol": rtol}
    t0 = time.perf_counter()
    want = [[int(t) for t in o[len(p):]]
            for o, p in zip(eng.generate(prompts, max_new_tokens=new_tokens), prompts)]
    _sync(torch, dev)
    rec["generate_seconds"] = time.perf_counter() - t0
    served = (SERVE_KERNELS if not int8 else ("rms_norm_fwd",) + INT8_KERNELS)
    passes = [("timed", dict(record=True)), ("profiled", dict(profile=True))]
    if not int8:
        passes += [("traced", dict(trace=True)), ("spec", dict(spec_k=spec_k, record=True))]
    passes += [("planted", dict(record=True, fault=True))]
    launches = None
    for name, kw in passes:
        run = served_pass(torch, dev, K, eng, prompts, new_tokens, ds, **kw)
        # the pass's driver and server sit in reference cycles (the handler
        # class closes over the driver, the driver over the engine): collect
        # them, so the engine's memory goes with the caller's last reference
        gc.collect()
        planted = kw.get("fault", False)
        p = {"seconds": run["seconds"], "launches": {k: run["launches"][k] for k in served},
             "plain_calls": run["plain_calls"],
             "streams": compare_streams(torch, eng, prompts, run["tokens"], want,
                                        None if planted else rtol)}
        if run["schedule"] is not None:
            t1 = time.perf_counter()
            replayed = replay_schedule(torch, eng, run["schedule"], new_tokens)
            p["replay"] = compare_replay(prompts, run["tokens"], replayed)
            p["replay"]["seconds"] = time.perf_counter() - t1
            if not planted and p["replay"]["equal"] != len(prompts):
                raise AssertionError(f"serving {name} pass: served streams leave the engine's "
                                     f"steps on the driver's schedule: {p['replay']['diverged']}")
        if planted:
            caught = {"replay": p["replay"]["equal"] < len(prompts),
                      "margin": p["streams"]["max_margin"] > rtol}
            p["caught"] = caught
            if not all(caught.values()):
                raise AssertionError(f"serving planted pass: the fault went unseen by {caught} "
                                     f"(largest margin {p['streams']['max_margin']}, limit {rtol})")
        if dev.type == "cuda":
            missing = [k for k in served if run["launches"][k] <= 0]
            if missing or any(run["plain_calls"].values()):
                raise AssertionError(f"serving {name} pass: kernels {run['launches']} "
                                     f"(none of {missing}), plain versions {run['plain_calls']}")
        h = run["health"]
        if not (h["kv_free_blocks"] == h["kv_total_blocks"] == nb):
            raise AssertionError(f"serving {name} pass: /health once idle {h}")
        finished = run["metrics"].get("dstpu_serving_requests_finished_total")
        if finished != len(prompts):
            raise AssertionError(f"serving {name} pass: /metrics finished {finished}")
        p["metrics_samples"] = len(run["metrics"])
        if name == "timed":
            launches = run["launches"]
            p.update(ttft_s=percentiles(run["ttft_s"]), tpot_s=percentiles(run["tpot_s"]),
                     tok_s=run["generated"] / run["seconds"], generated=run["generated"])
        if name == "profiled":
            p["device_busy_ms"] = run.get("device_busy_ms")
            p["wall_ms"] = run.get("profiled_wall_ms")
            p["idle_share"] = idle_share(p["device_busy_ms"], p["wall_ms"])
        if name == "traced":
            p["trace"] = trace_summary(run["trace"], len(prompts))
        if name == "spec":
            snap = run["snapshot"]
            p["spec"] = {k: snap[k] for k in ("spec_rounds_total", "spec_draft_tokens_total",
                                              "spec_accepted_tokens_total")}
            if p["spec"]["spec_rounds_total"] <= 0:
                raise AssertionError("serving spec pass: no verify round ran")
        rec[name] = p
    return rec, launches


def serving_note(rec, card):
    """The serving phase's line: TTFT and TPOT (p50 / p99), tok/s and the
    device's idle share, beside the card."""
    t = rec["timed"]
    idle = rec["profiled"]["idle_share"]
    ms = lambda d: "/".join("n/a" if v is None else f"{1e3 * v:.1f}" for v in d.values())  # noqa: E731
    return (f"{rec['phase']}: {rec['clients']} HTTP clients x {rec['new_tokens']} tokens: TTFT "
            f"p50/p99 {ms(t['ttft_s'])} ms, TPOT p50/p99 {ms(t['tpot_s'])} ms, "
            f"{t['tok_s']:.1f} tok/s, device idle share "
            f"{'not measured' if idle is None else f'{idle:.3f}'} (profiled pass), "
            f"streams equal to the engine's steps on the driver's schedule "
            f"{t['replay']['equal']}/{rec['clients']}, to generate() {t['streams']['equal']}/"
            f"{rec['clients']} (the rest leave it at near-ties; every served token within "
            f"{t['streams']['max_margin']:.4f} of the plain forward's largest logit, limit "
            f"{rec['logit_rtol']}; a planted feedback fault reads "
            f"{rec['planted']['streams']['max_margin']:.4f}), on {card}")


def serve_cli_phase(torch, dev, K, work, root, new_tokens=SERVE_CLI_NEW, prompt_lens=(64, 512),
                    flags=SERVE_CLI_FLAGS):
    """``python -m deepspeed_tpu_torch.inference.cli serve --model
    work/hf --port 0`` as a subprocess (killed in every case): its address
    read from its "listening on" line, then two ``tokens`` requests, one
    after the other, each equal to ``build_hf_engine``'s ``generate`` on the
    directory with the engine config those flags make. Returns (record,
    None: the subprocess's launches are its own)."""
    import queue
    import threading

    import numpy as np

    from deepspeed_tpu_torch.inference import cli
    from deepspeed_tpu_torch.inference.v2.engine_factory import build_hf_engine

    path = Path(work) / "hf"
    argv = ["serve", "--model", str(path), "--port", "0", "--device", dev.type, *flags]
    rec = {"phase": "serve_cli", "argv": ["python", "-m", "deepspeed_tpu_torch.inference.cli"]
           + argv[:2] + ["<hf_import dir>"] + argv[3:]}
    rng = np.random.default_rng(SEED + 7)
    cfg = json.loads((path / "config.json").read_text())
    prompts = [rng.integers(0, cfg["vocab_size"], size=int(n)).astype(np.int32)
               for n in rng.integers(*prompt_lens, size=2)]
    t0 = time.perf_counter()
    repo = Path(__file__).resolve().parent  # the checkout whose package is served
    proc = subprocess.Popen([sys.executable, "-m", "deepspeed_tpu_torch.inference.cli", *argv],
                            cwd=str(root), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True, env=dict(os.environ, PYTHONPATH=str(repo)))
    lines, tail = queue.Queue(), []
    threading.Thread(target=lambda: [lines.put(line) for line in proc.stderr],
                     daemon=True).start()
    got = []
    try:
        base, deadline = None, time.monotonic() + SERVE_CLI_WAIT_S
        while base is None:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                if proc.poll() is not None and lines.empty():
                    raise AssertionError(f"serve_cli exited {proc.returncode}: "
                                         f"{''.join(tail[-20:])}")
                if time.monotonic() > deadline:
                    raise AssertionError(f"serve_cli: no address in {SERVE_CLI_WAIT_S} s: "
                                         f"{''.join(tail[-20:])}")
                continue
            tail.append(line)
            m = re.search(r"listening on (http://[0-9.]+:[0-9]+)", line)
            base = m.group(1) if m else None
        rec["listening_seconds"] = time.perf_counter() - t0
        for p in prompts:
            t1 = time.perf_counter()
            reply = json.loads(_http(f"{base}/generate", {
                "tokens": [int(t) for t in p], "max_new_tokens": new_tokens,
                "ignore_eos": True}))
            got.append(reply["tokens"])
            rec.setdefault("request_seconds", []).append(time.perf_counter() - t1)
        health = json.loads(_http(f"{base}/health"))
    finally:
        proc.kill()
        proc.wait(timeout=60)
    args = cli.serve_parse_args(argv[1:])
    eng = build_hf_engine(str(path), cli.engine_config_from_args(args, None), device=dev.type)
    want = [[int(t) for t in eng.generate([p], max_new_tokens=new_tokens)[0][len(p):]]
            for p in prompts]
    rec.update(prompt_lens=[len(p) for p in prompts], new_tokens=new_tokens,
               kv_total_blocks=health["kv_total_blocks"], equal=got == want)
    if got != want:
        raise AssertionError(f"serve_cli: served {got} against generate() {want}")
    return rec, None


# the per-row leg: the engine's per-row step (_step_per_row) with
# attention_impl="splash" at Mistral's window of 4096 over an 8192-token
# context (64 blocks of 128), 256-token prompt chunks; 4 prompts of 6144 to
# 8176 tokens, each then decoding 16 tokens (the context holds them)
PER_ROW_CONFIG = {
    "dtype": "bfloat16", "decode_steps": 1, "prompt_chunk": 256, "max_prompt_chunks": 4,
    "kv_cache": {"block_size": 128, "num_blocks": 4 * 64, "max_blocks_per_seq": 64},
    "state_manager": {"max_tracked_sequences": 8, "max_ragged_batch_size": 1024,
                      "max_ragged_sequence_count": 4, "max_context": 8192},
}
PER_ROW_PROMPTS = (4, 6144, 8192 - 16)  # count, shortest, longest
PER_ROW_NEW_TOKENS = 16
# The splash per-row path against the dense per-row path fed the same
# tokens: both run the same bf16 projections and norms and differ only in
# the attention's arithmetic (the kernel's online softmax against the plain
# fp32 softmax), so their logits are held to LOGIT_RTOL row by row, and the
# share of equal greedy tokens is reported, not gated: with random weights a
# near-tie between the two largest logits flips under bf16 (60 of 64 agreed
# on an H100, as the engine phase's round_argmax_agreement shows the same)


def per_row_generate(eng, prompts, new_tokens, forced=None, step=None):
    """Greedy decoding through ``_step_per_row`` alone (or ``step``, e.g.
    the batched ``eng.step``): every prompt submitted, then steps until
    each row has ``new_tokens``. ``forced`` ({uid: tokens}) feeds those
    tokens back instead of the row's own argmax. Returns ({uid: own argmax
    tokens}, {uid: [logits rows]}, seconds until every prompt's first
    logits)."""
    import numpy as np

    step = step or eng._step_per_row
    for uid, p in enumerate(prompts):
        eng.scheduler.submit(uid, p)
    toks = {uid: [] for uid in range(len(prompts))}
    rows = {uid: [] for uid in range(len(prompts))}
    t0 = time.perf_counter()
    prefill_s = None
    while eng.scheduler.has_work():
        res = step()
        if eng.last_scheduled_tokens == 0:
            raise AssertionError("per-row step stalled: nothing schedulable")
        for uid, lg in res.items():  # host logits: the step has finished
            rows[uid].append(lg)
            toks[uid].append(int(np.argmax(lg)))
            if len(toks[uid]) >= new_tokens:
                eng.scheduler.finish(uid)
            else:
                eng.scheduler.feedback(uid, toks[uid][-1] if forced is None
                                       else forced[uid][len(toks[uid]) - 1])
        if prefill_s is None and all(toks.values()):
            prefill_s = time.perf_counter() - t0
    return toks, rows, prefill_s


def engine_per_row_phase(torch, dev, K, widths=None, engine_config=None,
                         prompt_lens=PER_ROW_PROMPTS, new_tokens=PER_ROW_NEW_TOKENS):
    """The engine's per-row step with attention_impl="splash", counted:
    every row step's windowed prefill (and decode token) takes
    ``splash_prefill_attention``. Holds each prompt's logits and every
    decode step's against ``forward_reference``, and the greedy stream
    against the same engine's dense per-row path (attention_impl="auto")
    fed the same tokens. ``widths``/``engine_config``/``prompt_lens`` shrink
    it for a rehearsal on the CPU."""
    import dataclasses

    import numpy as np

    from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2 import engine_v2 as E
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.ops.sparse_attention import splash as SP

    t0 = time.perf_counter()
    cfg = T.get_config(MODEL, attention_impl="splash", **(widths or {}))
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 2), dev)
    rc = RaggedInferenceEngineConfig.from_dict(engine_config or PER_ROW_CONFIG)
    kv = rc.kv_cache
    S = kv.max_blocks_per_seq * kv.block_size
    eng = E.InferenceEngineV2(cfg, params, rc, device=dev.type)
    L = cfg.n_layers
    rng = np.random.default_rng(SEED + 2)
    n, lo, hi = prompt_lens
    prompts = [rng.integers(0, cfg.vocab_size, size=int(m)).astype(np.int32)
               for m in rng.integers(lo, hi + 1, size=n)]
    rec = {"phase": "engine_per_row", "model": MODEL, "n_layers": L,
           "window": cfg.sliding_window, "context": S, "block_size": kv.block_size,
           "prompt_lens": [len(p) for p in prompts], "new_tokens": new_tokens}
    _sync(torch, dev)
    rec["setup_seconds"] = time.perf_counter() - t0

    # ---- the main path, counted; a spy records each layer's (start, t)
    calls = []
    real = E.splash_prefill_attention

    def spy(q, k, v, start, **kw):
        calls.append((int(start), q.shape[2]))
        return real(q, k, v, start, **kw)

    E.splash_prefill_attention = spy
    try:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        K.reset_counts()
        t0 = time.perf_counter()
        toks, rows, prefill_s = per_row_generate(eng, prompts, new_tokens)
        _sync(torch, dev)
        rec["seconds_main_path"] = time.perf_counter() - t0
        launches = K.counts()
    finally:
        E.splash_prefill_attention = real
    row_steps = len(calls) // L
    if len(calls) != row_steps * L or row_steps == 0:
        raise AssertionError(f"{len(calls)} splash prefill calls for {L} layers")
    expected = {name: 0 for name in launches}
    expected.update({"splash_fwd": L * row_steps, "rms_norm_fwd": (2 * L + 1) * row_steps})
    rec.update(launches=launches, launches_expected=expected, row_steps=row_steps)
    if dev.type == "cuda" and launches != expected:  # the CPU runs the plain versions
        raise AssertionError(f"per-row kernel launches {launches}, expected {expected}")
    rec["prefill_seconds"] = prefill_s
    rec["prefill_tok_s"] = sum(len(p) for p in prompts) / prefill_s
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
    # kv blocks each row step's schedule visits, of the context's S / block
    visited = {}
    for start, t in sorted(set(calls)):
        sched = SP.prefill_schedule(start, t, S, cfg.sliding_window, kv.block_size)
        visited.setdefault("chunk" if t > 1 else "decode", []).append(sched.num_active)
    rec["blocks_visited"] = {k: {"mean": float(np.mean(v)), "max": int(max(v)), "rows": len(v)}
                             for k, v in visited.items()}
    rec["blocks_in_context"] = S // kv.block_size

    # ---- the same engine's dense per-row path, fed the splash tokens
    dense = E.InferenceEngineV2(dataclasses.replace(cfg, attention_impl="auto"), eng.params, rc,
                                device=dev.type)
    d_toks, d_rows, _ = per_row_generate(dense, prompts, new_tokens, forced=toks)
    del dense
    agree = [a == b for u in toks for a, b in zip(toks[u], d_toks[u])]
    rec["dense_token_agreement"] = sum(agree) / len(agree)
    rec["dense_logit_rel_err"] = max(rows_rel_err(torch, np.stack(rows[u]), np.stack(d_rows[u]))
                                     for u in toks)

    # ---- the plain forward_reference on each prompt and its tokens
    errs, shifted = [], []
    for uid, p in enumerate(prompts):
        full = np.concatenate([p, np.asarray(toks[uid][:-1], np.int32)])
        with torch.no_grad():
            ref = T.forward_reference(eng.params, torch.as_tensor(full, device=dev)[None]
                                      .long(), cfg)[0][0].float()
        if not bool(torch.isfinite(ref).all()):
            raise AssertionError("plain forward gave non-finite logits")
        n_p = len(p)
        errs.append(rows_rel_err(torch, np.stack(rows[uid]), ref[n_p - 1:]))
        shifted.append(rows_rel_err(torch, rows[uid][0], ref[n_p - 2]))
        del ref
    rec["logit_rel_err"] = max(errs)
    rec["logit_rel_err_shifted"] = min(shifted)
    rec["logit_rows_checked"] = len(prompts) * new_tokens
    rec["logit_rtol"] = LOGIT_RTOL
    del eng
    if rec["logit_rel_err"] > LOGIT_RTOL or rec["dense_logit_rel_err"] > LOGIT_RTOL:
        raise AssertionError(f"per-row logits off: {rec['logit_rel_err']} against the plain "
                             f"forward, {rec['dense_logit_rel_err']} against the dense path")
    if rec["logit_rel_err_shifted"] <= LOGIT_RTOL:
        raise AssertionError("negative control passed: the logit check cannot tell positions apart")
    return rec, launches


# the int8 per-row check: 4 of Mistral-7B's layers, 2 prompts of ~1000
# tokens in 256-token chunks, 8 new tokens each, a 2048-token context
PER_ROW_INT8_LAYERS = 4
PER_ROW_INT8_CONFIG = {
    "dtype": "bfloat16", "decode_steps": 1, "prompt_chunk": 256, "max_prompt_chunks": 4,
    "kv_cache": {"block_size": 128, "num_blocks": 64, "max_blocks_per_seq": 16,
                 "kv_cache_dtype": "int8"},
    "state_manager": {"max_tracked_sequences": 8, "max_ragged_batch_size": 1024,
                      "max_ragged_sequence_count": 4, "max_context": 2048},
}
PER_ROW_INT8_PROMPTS = (2, 960, 1040)
PER_ROW_INT8_NEW_TOKENS = 8


def engine_per_row_int8_phase(torch, dev, K, widths=None, engine_config=None,
                              prompt_lens=PER_ROW_INT8_PROMPTS,
                              new_tokens=PER_ROW_INT8_NEW_TOKENS):
    """``_step_per_row`` over an int8 pool, counted: each row step attends
    before its write (the int8 paged-decode kernel, the chunk's own K/V as
    extra columns) and quantizes on write. Its logits against the batched
    int8 step's fed the same tokens (a second engine on the same weights),
    then one sequence's blocks exported from the batched engine and
    imported into the per-row one must reproduce the planes bit for bit."""
    import numpy as np

    from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import transformer as T

    cfg = T.get_config(MODEL, **(widths or {"n_layers": PER_ROW_INT8_LAYERS}))
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 3), dev)
    rc = RaggedInferenceEngineConfig.from_dict(engine_config or PER_ROW_INT8_CONFIG)
    eng = InferenceEngineV2(cfg, params, rc, device=dev.type)
    L = cfg.n_layers
    rng = np.random.default_rng(SEED + 3)
    n, lo, hi = prompt_lens
    prompts = [rng.integers(0, cfg.vocab_size, size=int(m)).astype(np.int32)
               for m in rng.integers(lo, hi + 1, size=n)]
    rec = {"phase": "engine_per_row_int8", "model": MODEL, "n_layers": L,
           "prompt_lens": [len(p) for p in prompts], "new_tokens": new_tokens}

    calls = []
    real = eng._row_step

    def count_rows(*a, **k):
        calls.append(1)
        return real(*a, **k)

    eng._row_step = count_rows
    K.reset_counts()
    toks, rows, _ = per_row_generate(eng, prompts, new_tokens)
    _sync(torch, dev)
    launches = K.counts()
    del eng._row_step
    row_steps = len(calls)
    expected = {name: 0 for name in launches}
    expected.update({"paged_decode_int8": L * row_steps, "block_quant": L * row_steps,
                     "rms_norm_fwd": (2 * L + 1) * row_steps})
    rec.update(launches=launches, launches_expected=expected, row_steps=row_steps)
    if dev.type == "cuda" and launches != expected:  # the CPU runs the plain versions
        raise AssertionError(f"per-row int8 kernel launches {launches}, expected {expected}")

    batched = InferenceEngineV2(cfg, eng.params, rc, device=dev.type)
    b_toks, b_rows, _ = per_row_generate(batched, prompts, new_tokens, forced=toks,
                                         step=batched.step)
    agree = [a == b for u in toks for a, b in zip(toks[u], b_toks[u])]
    rec["batched_token_agreement"] = sum(agree) / len(agree)
    rec["batched_logit_rel_err"] = max(
        rows_rel_err(torch, np.stack(rows[u]), np.stack(b_rows[u])) for u in toks)
    rec["logit_rows_checked"] = sum(len(r) for r in rows.values())
    rec["logit_rtol"] = LOGIT_RTOL
    if rec["batched_logit_rel_err"] > LOGIT_RTOL:
        raise AssertionError(f"per-row int8 logits {rec['batched_logit_rel_err']} off the "
                             "batched int8 step's")

    # export one sequence's blocks from the batched engine, import them
    # into the per-row engine's (now free) blocks, read them back
    batched.scheduler.submit(100, prompts[0])
    while batched.scheduler.has_pending():
        batched.step()
    blocks = list(batched.state_manager.get_sequence(100).block_table)
    payload = batched.export_kv_blocks(blocks)
    eng.import_kv_blocks(list(range(len(blocks))), payload)
    back = eng.export_kv_blocks(list(range(len(blocks))))
    if sorted(payload) != ["k", "k_scale", "v", "v_scale"] or any(
            payload[k].tobytes() != back[k].tobytes() for k in payload):
        raise AssertionError("int8 KV export -> import did not reproduce the planes' bytes")
    rec["export_blocks"] = len(blocks)
    rec["export_bytes"] = int(sum(a.nbytes for a in payload.values()))
    del eng, batched
    return rec, launches


def profile_engine(torch, eng, rng, vocab, steps=8):
    """torch.profiler over one split step with 32 decode rows and one fused
    round of ``steps`` tokens. Opt-in (``--profile``)."""
    import numpy as np

    for uid in range(32):
        eng.scheduler.submit(1000 + uid, rng.integers(0, vocab, size=int(rng.integers(64, 512))))
    last = {}
    while eng.scheduler.has_pending():
        last.update(eng.step())
    for uid, lg in last.items():
        eng.scheduler.feedback(uid, int(np.argmax(lg)))

    def split_step():
        for uid, lg in eng.step().items():
            eng.scheduler.feedback(uid, int(np.argmax(lg)))

    # the paged kernels' two launches of a call: split, then merge
    out = device_profile(torch, {"split_step_32_decode_rows": split_step,
                                 f"decode_round_{steps}": lambda: eng.decode_round(steps)},
                         sums=("paged_split_kernel", "paged_merge_kernel"))
    for uid in list(eng.scheduler.running_uids()):
        eng.scheduler.finish(uid)
    return out

# ---------------------------------------------------------------------------
# phase 4: training at Mistral-7B width
# ---------------------------------------------------------------------------
SEQ = 4096
# the timed leg: 8 of Mistral-7B's 32 layers. Full depth cannot train on one
# 80 GB card: 7.24 B params x (2 bf16 param + 4 fp32 master + 8 Adam
# moments + 4 fp32 grad accumulator + 2 bf16 micro-grad) bytes is ~145 GB;
# 8 layers are 2.007 B params, ~40 GB of the same
TRAIN_LAYERS = 8
PARITY_LAYERS = 2
TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": 2,
    "bf16": {"enabled": True},
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 2, "warmup_max_lr": 1e-4}},
    "gradient_clipping": 1.0, "zero_optimization": {"stage": 0}, "steps_per_print": 1000,
}
# kernel path (flash kernels, RMSNorm kernels) against autograd through the
# plain forward_reference, bf16 weights and activations on both sides: the
# two attentions round p to bf16 against different maxima and sum in
# another order, so each leaf's gradient differs by a few bf16 units
# relative (2^-8 = 0.004 each); the loss is an fp32 reduction of bf16
# logits. A gradient of another batch is off by order 1.
PARITY_LOSS_ATOL = 0.02
PARITY_GRAD_RTOL = 0.05
PARITY_CONTROL_MIN = 0.5
# the control over all gradients together (``train_parity(control_by="all")``):
# a random model's tied head and norms get a large batch-independent
# gradient, so two batches' gradients sit ~0.45 apart over all leaves
# (train_alibi at BLOOM-7b1 width on an H100, in this repo's runs); four
# times the gradient tolerance still tells them apart from a miss
PARITY_CONTROL_ALL_MIN = 4 * PARITY_GRAD_RTOL
TRAIN_KERNELS = ("rms_norm_fwd", "rms_norm_bwd", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
SERVE_KERNELS = ("rms_norm_fwd", "paged_decode")
# the engine_int8 phase's (and the int8 per-row check's)
INT8_KERNELS = ("paged_decode_int8", "block_quant")
# the fused leg: the same configuration with TransformerConfig(fused_ce=True)
# and FusedAdam (AdamW mode), which adds these four to the train kernels
FUSED_KERNELS = ("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw", "fused_adam")
# the per-row leg's kernels: the splash forward (windowed prefill and
# decode) and RMSNorm
PER_ROW_KERNELS = ("splash_fwd", "rms_norm_fwd")
FUSED_OPTIMIZER = {"type": "FusedAdam",
                   "params": {"lr": 1e-4, "weight_decay": 0.01, "adam_w_mode": True}}
# the splash leg: attention_impl="splash" with the same dense head and AdamW.
# Its parity leg cuts Mistral's window to 1024 so that the 4096-token
# schedule prunes blocks; its timed leg keeps the window of 4096 at seq
# 16384 under remat (policy "nothing": each layer's forward runs again in
# the backward, so the splash forward and the norms launch twice per layer)
SPLASH_PARITY_WINDOW = 1024
SPLASH_TIMED_SEQ = SPLASH_TIMED["s"]


def packed_batch(torch, dev, rng, b, s, vocab):
    """input_ids [b, s + 1] with two packed sequences per row: segment ids
    and positions that restart at the boundary (for the s inputs)."""
    import numpy as np

    toks = rng.integers(0, vocab, size=(b, s + 1)).astype(np.int64)
    cut = s * 3 // 8
    seg = np.zeros((b, s), np.int32)
    seg[:, cut:] = 1
    pos = np.tile(np.concatenate([np.arange(cut), np.arange(s - cut)]), (b, 1)).astype(np.int32)
    return {k: torch.as_tensor(v, device=dev) for k, v in
            (("input_ids", toks), ("segment_ids", seg), ("positions", pos))}


def leaves(tree):
    from deepspeed_tpu_torch.runtime.optimizers import _leaves

    return dict(_leaves(tree))


def adam_step_check(torch, eng, grads, lr=1e-4):
    """One step of the engine's FusedAdam on ``grads`` (a tree of fp32
    tensors) against ``_adam_math`` on the same masters and grads: masters
    and moments within 4 fp32 ulp (as the kernel check counts them), each
    half-precision param the rounded master."""
    from deepspeed_tpu_torch.ops.adam import fused_adam as A

    hp = eng.optimizer.tx.fused.hp
    before = {k: t.clone() for k, t in leaves(eng.opt_state.master).items()}
    count = eng.opt_state.inner["count"] + 1
    eng.opt_state = eng.optimizer.step(grads, eng.opt_state, eng.params, lr)
    worst = 0.0
    g = leaves(grads)
    m, v = leaves(eng.opt_state.inner["m"]), leaves(eng.opt_state.inner["v"])
    params = leaves(eng.params)
    for name, p0 in before.items():
        zero = torch.zeros_like(p0)
        want_p, want_m, want_v = A._adam_math(p0, g[name], zero, zero, count, hp, lr)
        got = leaves(eng.opt_state.master)[name]
        worst = max(worst, check_adam_master(torch, f"FusedAdam master {name}", got, want_p, p0))
        check_close(torch, f"FusedAdam m {name}", m[name], want_m, ADAM_RTOL, ADAM_RTOL)
        check_close(torch, f"FusedAdam v {name}", v[name], want_v, ADAM_RTOL, ADAM_RTOL)
        if not torch.equal(params[name], got.to(params[name].dtype)):
            raise AssertionError(f"FusedAdam step: param {name} is not its rounded master")
        del want_p, want_m, want_v, zero
    return worst


def checkpoint_leg(torch, dev, eng, make_engine, batch):
    """Save ``eng`` through the sync writer, take one more step; a fresh
    engine (other weights) loads the checkpoint and takes the same step.
    Right after the load its whole state (params, masters, the optimizer's
    moments and count, the learning rate, the step counters) must equal the
    saved engine's bit for bit, and so must the two steps' losses (a forward
    over the restored params: the backward's atomic sums come after it)."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import tree_leaves

    def state_of(e):
        """Every tensor of the engine's state, then its scalars."""
        flat = tree_leaves(e.params) + tree_leaves(e._opt_state_payload())
        tensors = [t for t in flat if isinstance(t, torch.Tensor)]
        scalars = [int(t) for t in flat if not isinstance(t, torch.Tensor)]
        return tensors, scalars + [e.get_lr(), e.global_steps, e.micro_steps, e.global_samples]

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        eng.save_checkpoint(ckpt_dir, tag="smoke")
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(ckpt_dir).rglob("*") if f.is_file())
        saved, saved_scalars = state_of(eng)
        saved = [t.clone() for t in saved]
        want = float(eng.train_batch(batch=batch))
        steps = eng.global_steps
        del eng
        _sync(torch, dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        other = make_engine()
        t0 = time.perf_counter()
        other.load_checkpoint(ckpt_dir)
        load_s = time.perf_counter() - t0
        loaded, loaded_scalars = state_of(other)
        differ = [i for i, (x, y) in enumerate(zip(saved, loaded, strict=True))
                  if x.dtype != y.dtype or not torch.equal(x, y)]
        if differ or loaded_scalars != saved_scalars:
            raise AssertionError(
                f"checkpoint: the reloaded state differs in tensors {differ} of {len(saved)} "
                f"(params, masters, moments, in tree order); scalars {loaded_scalars} against "
                f"{saved_scalars}")
        n_state = len(saved)
        del saved, loaded
        got = float(other.train_batch(batch=batch))
        rec = {"writer": "sync", "bytes": size, "save_seconds": save_s, "load_seconds": load_s,
               "state_tensors_equal": n_state,
               "state_scalars": loaded_scalars,
               "loss_uninterrupted": want, "loss_after_reload": got,
               "global_steps": other.global_steps}
        if got != want or other.global_steps != steps:
            raise AssertionError(f"checkpoint: the reloaded engine's step differs: {rec}")
        return rec
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


# leaves whose gradient is zero in exact arithmetic: a key bias shifts every
# logit of a query's row by the same q . b, which the softmax cancels; both
# paths give rounding noise there, whose relative difference means nothing
ZERO_GRAD_LEAVES = ("layers/wk_b",)


def train_parity(torch, cfg, params, loss_fn, batch, other, reference_loss=None,
                 control_by="leaf"):
    """The loss and every leaf's gradient of ``loss_fn`` (the kernels) on
    ``batch`` against autograd through ``forward_reference`` and the dense
    ``nll_loss`` (``reference_loss(params, batch)`` when given), and a
    control: the kernel path's gradients of ``other``. Raises outside
    PARITY_LOSS_ATOL / PARITY_GRAD_RTOL or when the control is closer than
    PARITY_CONTROL_MIN: for every leaf (``control_by="leaf"``), or over all
    gradients together ("all": the LayerNorm weights and biases of a random
    BLOOM or BERT get nearly the same gradient from any batch, so a
    per-leaf control cannot tell batches apart there). Returns (record, the
    kernel path's fp32 grads)."""
    import numpy as np

    from deepspeed_tpu_torch.models import transformer as T

    for t in leaves(params).values():
        t.requires_grad_(True)
    names = list(leaves(params))
    flat = list(leaves(params).values())

    def kernel_grads(b):
        loss = loss_fn(params, b)
        return loss.detach(), [g.float() for g in torch.autograd.grad(loss, flat)]

    if reference_loss is None:
        def reference_loss(p, b):
            inputs, labels, mask, positions, segment_ids = T.split_lm_batch(b)
            logits, _ = T.forward_reference(p, inputs, cfg, positions=positions,
                                            segment_ids=segment_ids)
            return T.nll_loss(logits, labels, mask)

    k_loss, k_grads = kernel_grads(batch)
    _, c_grads = kernel_grads(other)
    r_loss = reference_loss(params, batch)
    r_grads = [g.float() for g in torch.autograd.grad(r_loss, flat)]
    rel = {}
    control = {}
    zero = {}
    diff_sq = ref_sq = 0.0
    for name, kg, cg, rg in zip(names, k_grads, c_grads, r_grads):
        if not bool(torch.isfinite(kg).all()):
            raise AssertionError(f"train parity: non-finite kernel-path grad for {name}")
        if name in ZERO_GRAD_LEAVES:
            zero[name] = {"kernels_norm": float(kg.norm()), "reference_norm": float(rg.norm())}
            continue
        ref_norm = float(rg.norm())
        rel[name] = float((kg - rg).norm()) / ref_norm
        control[name] = float((cg - rg).norm()) / ref_norm
        diff_sq += float((cg - rg).norm()) ** 2
        ref_sq += ref_norm ** 2
    del c_grads, r_grads
    control_min = PARITY_CONTROL_MIN
    if control_by == "all":
        control = {"all leaves": (diff_sq / ref_sq) ** 0.5}
        control_min = PARITY_CONTROL_ALL_MIN
    for t in flat:
        t.requires_grad_(False)
    rec = {
        "loss_kernels": float(k_loss), "loss_reference": float(r_loss.detach()),
        "loss_abs_diff": abs(float(k_loss) - float(r_loss.detach())),
        "loss_atol": PARITY_LOSS_ATOL,
        "grad_rel_frobenius": rel, "grad_rtol": PARITY_GRAD_RTOL,
        "control_rel_frobenius_min": min(control.values()),
        "control_min_required": control_min,
    }
    if zero:
        rec["zero_in_exact_arithmetic"] = zero
    if not np.isfinite(float(k_loss)) or rec["loss_abs_diff"] > PARITY_LOSS_ATOL:
        raise AssertionError(f"train parity: loss {rec}")
    if max(rel.values()) > PARITY_GRAD_RTOL:
        raise AssertionError(f"train parity: gradients off the plain oracle: {rel}")
    if min(control.values()) < control_min:
        raise AssertionError(f"train parity: the control is too close: {control}")
    return rec, k_grads


def train_phase(torch, dev, K, widths=None, seq=SEQ, layers=TRAIN_LAYERS,
                parity_layers=PARITY_LAYERS, profile=False, fused=False, timed_steps=4,
                splash=False, parity_window=SPLASH_PARITY_WINDOW, timed_seq=None):
    """The training path, counted. ``widths``/``seq``/``layers`` shrink it
    for a rehearsal on the CPU; the card run uses the defaults. ``fused``
    runs the fused configuration (``fused_ce=True``, FusedAdam): its parity
    leg still compares with autograd through ``forward_reference`` and the
    dense ``nll_loss``, and adds one optimizer step against the plain Adam
    math and a checkpoint save -> load -> step. ``splash`` runs
    ``attention_impl="splash"``: the parity leg at ``parity_window``, the
    timed leg at ``timed_seq`` (default SPLASH_TIMED_SEQ) under remat."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as T

    widths = dict(widths or {})
    widths.setdefault("dtype", "bfloat16")
    phase = "train_splash" if splash else "train_fused" if fused else "train"
    timed_seq = timed_seq or (SPLASH_TIMED_SEQ if splash else seq)
    rec = {"phase": phase, "model": MODEL, "seq": timed_seq, "parity_seq": seq,
           "dtype": widths["dtype"]}
    ds_config = dict(TRAIN_CONFIG)
    if fused:
        widths["fused_ce"] = True
        ds_config["optimizer"] = FUSED_OPTIMIZER
        ds_config["checkpoint"] = {"writer": "sync"}
    parity_over, timed_over = {}, {"remat": False}
    if splash:
        widths["attention_impl"] = "splash"
        parity_over["sliding_window"] = parity_window
        timed_over = {"remat": True, "remat_policy": "nothing"}
    if widths["dtype"] != "bfloat16":  # a CPU rehearsal in the model's own dtype
        del ds_config["bf16"]
    rng = np.random.default_rng(SEED)

    # ---- parity leg: kernels against the plain oracle, one micro-batch
    t0 = time.perf_counter()
    cfg = T.get_config(MODEL, n_layers=parity_layers, remat=False, **parity_over, **widths)
    rec["parity_window"] = cfg.sliding_window
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    batch = packed_batch(torch, dev, rng, 1, seq, cfg.vocab_size)
    other = packed_batch(torch, dev, rng, 1, seq, cfg.vocab_size)
    loss_fn = T.make_loss_fn(cfg)
    rec["parity"], k_grads = train_parity(torch, cfg, params, loss_fn, batch, other)
    rec["parity"].update(layers=parity_layers, batch=[1, seq], segments=2)
    flat = list(leaves(params).values())

    # 8 engine steps on that batch: the loss must fall
    for t in flat:
        t.requires_grad_(False)
    one = dict(ds_config, gradient_accumulation_steps=1)
    eng, *_ = deepspeed_tpu_torch.initialize(model=loss_fn, model_parameters=params,
                                             config=one)
    del params, flat
    if fused:
        # one FusedAdam step on the parity leg's grads against the plain math
        from deepspeed_tpu_torch.runtime.optimizers import tree_map

        it = iter(k_grads)
        K.reset_counts()
        rec["parity"]["adam_step_max_abs_err"] = adam_step_check(
            torch, eng, tree_map(lambda p: next(it), eng.params))
        big = sum(t.numel() >= (1 << 16) for t in leaves(eng.params).values())
        rec["parity"]["adam_step_launches"] = K.counts()["fused_adam"]
        if dev.type == "cuda" and K.counts()["fused_adam"] != big:
            raise AssertionError(f"FusedAdam launched {K.counts()['fused_adam']} kernels for "
                                 f"{big} leaves of at least 65536 elements")
    del k_grads
    fit = [float(eng.train_batch(batch=batch)) for _ in range(8)]
    rec["parity"]["fixed_batch_losses"] = fit
    if not all(np.isfinite(fit)) or not fit[-1] < fit[0]:
        raise AssertionError(f"train: the loss did not fall on a fixed batch: {fit}")
    if fused:
        def other_engine():
            p = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 7), dev)
            return deepspeed_tpu_torch.initialize(model=loss_fn, model_parameters=p,
                                                  config=one)[0]

        rec["checkpoint"] = checkpoint_leg(torch, dev, eng, other_engine, batch)
    del eng
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec["parity"]["seconds"] = time.perf_counter() - t0

    # ---- timed leg: initialize -> train_batch at TRAIN_LAYERS layers
    cfg = T.get_config(MODEL, n_layers=layers, **timed_over, **widths)
    rec["window"] = cfg.sliding_window
    rec["remat"] = cfg.remat
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 1), dev)
    gas = ds_config["gradient_accumulation_steps"]
    seq = timed_seq
    batches = [{"input_ids": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(gas, seq + 1)), device=dev)}
        for _ in range(1 + timed_steps)]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    eng, *_ = deepspeed_tpu_torch.initialize(model=T.make_loss_fn(cfg), model_parameters=params,
                                             config=ds_config)
    del params
    rec["params"] = sum(t.numel() for t in leaves(eng.params).values())
    rec["layers"] = layers
    losses, step_s = [], []
    for i, b in enumerate(batches):
        t1 = time.perf_counter()
        losses.append(float(eng.train_batch(batch=b)))  # float() waits for the step
        _sync(torch, dev)
        step_s.append(time.perf_counter() - t1)
    launches = K.counts()
    steps = len(batches)
    # remat runs each layer's forward again in the backward
    fwd_runs = 2 if cfg.remat else 1
    attn = "splash" if splash else "flash"
    per_step = {f"{attn}_fwd": gas * layers * fwd_runs, f"{attn}_bwd_dq": gas * layers,
                f"{attn}_bwd_dkv": gas * layers,
                "rms_norm_fwd": gas * (2 * layers * fwd_runs + 1),
                "rms_norm_bwd": gas * (2 * layers + 1)}
    if fused:
        per_step.update({
            "fused_ce_fwd": gas, "fused_ce_dx": gas, "fused_ce_dw": gas,
            # one launch per leaf of at least 65536 elements; smaller
            # leaves (the norm weights) take the plain math
            "fused_adam": sum(t.numel() >= (1 << 16) for t in leaves(eng.params).values()),
        })
    expected = {name: 0 for name in launches}
    expected.update({k: v * steps for k, v in per_step.items()})
    rec["launches"] = launches
    rec["launches_expected"] = expected
    rec["launches_per_optimizer_step"] = per_step
    if dev.type == "cuda" and launches != expected:  # the CPU runs the plain versions
        raise AssertionError(f"train kernel launches {launches}, expected {expected}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: non-finite losses {losses}")
    timed = step_s[1:]
    tokens = gas * ds_config["train_micro_batch_size_per_gpu"] * seq
    rec["losses"] = losses
    rec["step_seconds"] = step_s
    rec["warmup_step_seconds"] = step_s[0]
    rec["mean_step_seconds"] = sum(timed) / len(timed)
    rec["tok_s"] = tokens / rec["mean_step_seconds"]
    rec["flops_per_token"] = T.flops_per_token(cfg, seq)
    rec["mfu"] = rec["flops_per_token"] * rec["tok_s"] / BF16_FLOPS
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
    if profile:
        rec["profile"] = device_profile(torch, {rec["phase"] + "_step": lambda: float(
            eng.train_batch(batch=batches[-1]))})
    del eng
    return rec, launches


# ---------------------------------------------------------------------------
# the rest of the model: ALiBi (BLOOM), top-k MoE (Mixtral), the encoder
# heads (BERT), at their published widths; depth cut to fit one card
# ---------------------------------------------------------------------------
# train_alibi: bigscience/bloom-7b1 at 2 of its 30 layers, seq 2048 (its
# seq_length): 1.43 B params (the 1.03 B of the tied 250880-row embedding
# among them), ~20 bytes each in training (bf16 param, fp32 master, Adam's
# m and v, fp32 and bf16 gradients): ~29 GB
ALIBI_MODEL, ALIBI_LAYERS, ALIBI_SEQ = "bloom-7b1", 2, 2048
# train_moe: mistralai/Mixtral-8x7B-v0.1 at 1 of its 32 layers (1.45 B
# params a layer: ~29 GB in training, so 2 layers would not leave room for
# the activations under 70 GB), seq 4096
MOE_MODEL, MOE_TRAIN_LAYERS, MOE_TRAIN_SEQ = "mixtral-8x7b", 1, 4096
# engine_moe: 4 layers (5.9 B params, ~12 GB in bf16), 8 prompts of 64 to
# 511 tokens, at the mapping's capacity factor E/k = 4 (capacity = the
# call's tokens: nothing dropped, so logits compare with forward_reference)
# and again at the config default 1.25 (choices dropped)
MOE_ENGINE_LAYERS, MOE_ENGINE_PROMPTS = 4, 8
MOE_DROP_CF = 1.25
# train_mlm: bert-large-uncased at its full 24 layers, seq 512 (its
# max_position_embeddings), micro-batch 8: 15% of the positions masked
MLM_MODEL, MLM_SEQ, MLM_MICRO, MLM_MASKED = "bert-large", 512, 8, 0.15
TRAIN_BYTES_PER_PARAM = 20  # bf16 param, fp32 master, m, v, fp32 + bf16 grads


def routes_spy(torch):
    """Records the top-k expert set of every row of every MoE gating call
    (``sharded_moe.topkgating``), each row's gate margin (its k-th router
    logit less its (k+1)-th, over the RMS of its logits), and the rows'
    (token, position) pairs of the last ``embed_tokens`` call before it.
    Returns (calls, undo)."""
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.parallel.moe import sharded_moe as M

    calls, rows = [], {}
    gate, embed = M.topkgating, T.embed_tokens

    def gating(logits, k, *a, **kw):
        res = gate(logits, k, *a, **kw)
        top = torch.sort(M._top_k(torch.softmax(logits.float(), -1), k)[1], -1).values
        lf = logits.float()
        ranked = torch.sort(lf, -1, descending=True).values
        margin = (ranked[:, k - 1] - ranked[:, k]) / lf.pow(2).mean(-1).sqrt().clamp_min(1e-30)
        calls.append({"top": top.cpu().numpy(), "rows": rows.get("last"),
                      "kept": int(res[2].sum()), "chosen": logits.shape[0] * k,
                      "margin": margin.cpu().numpy()})
        return res

    def embedding(params, tokens, positions, config, **kw):
        if torch.as_tensor(tokens).dim() == 1:
            rows["last"] = (torch.as_tensor(tokens).cpu().numpy(),
                            torch.as_tensor(positions).cpu().numpy())
        return embed(params, tokens, positions, config, **kw)

    M.topkgating, T.embed_tokens = gating, embedding

    def undo():
        M.topkgating, T.embed_tokens = gate, embed

    return calls, undo


def timed_train(torch, dev, K, cfg, ds_config, batches, per_step, rec, profile=False):
    """``initialize`` -> ``train_batch`` over ``batches`` (the first a
    warm-up), on freshly seeded weights: losses, step seconds, tok/s, MFU,
    peak memory and the exact kernel launches (``per_step`` an optimizer
    step, where a "fused_adam" of None counts the leaves of at least 65536
    elements, one launch each; every other kernel 0) into ``rec``. With
    ``profile`` (a card), one more step under ``device_profile`` after the
    counted ones. Returns the launches."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as T

    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 1), dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    eng, *_ = deepspeed_tpu_torch.initialize(model=T.make_loss_fn(cfg), model_parameters=params,
                                             config=ds_config)
    del params
    if per_step.get("fused_adam", 0) is None:
        per_step = dict(per_step, fused_adam=sum(
            t.numel() >= (1 << 16) for t in leaves(eng.params).values()))
    rec["params"] = sum(t.numel() for t in leaves(eng.params).values())
    rec["reckoned_train_gb"] = rec["params"] * TRAIN_BYTES_PER_PARAM / 1e9
    losses, step_s = [], []
    for b in batches:
        t1 = time.perf_counter()
        losses.append(float(eng.train_batch(batch=b)))
        _sync(torch, dev)
        step_s.append(time.perf_counter() - t1)
    launches = K.counts()
    expected = {name: 0 for name in launches}
    expected.update({k: v * len(batches) for k, v in per_step.items()})
    rec.update(launches=launches, launches_expected=expected,
               launches_per_optimizer_step=per_step)
    if dev.type == "cuda" and launches != expected:
        raise AssertionError(f"{rec['phase']} kernel launches {launches}, expected {expected}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{rec['phase']}: non-finite losses {losses}")
    first = batches[0]["input_ids"]
    tokens = first.shape[0] * (first.shape[1] - ("labels" not in batches[0]))
    timed = step_s[1:]
    rec.update(losses=losses, step_seconds=step_s, mean_step_seconds=sum(timed) / len(timed))
    rec["tok_s"] = tokens / rec["mean_step_seconds"]
    # the JAX package's formula: an MoE layer counts as one expert's MLP,
    # where a token runs k (so MFU is understated there)
    rec["flops_per_token"] = T.flops_per_token(cfg, first.shape[1])
    rec["mfu"] = rec["flops_per_token"] * rec["tok_s"] / BF16_FLOPS
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
    if profile and dev.type == "cuda":
        rec["profile"] = device_profile(
            torch, {rec["phase"] + "_step": lambda: float(eng.train_batch(batch=batches[-1]))},
            sums=QMM_PROFILE_SUMS)
    del eng
    return launches


def remat_check(torch, K, cfg, params, batch, fwd_kernel):
    """Every ``remat_policy`` on one micro-batch of ``cfg`` with
    ``params``: the loss and the gradients against ``remat=False``'s (a
    policy changes memory and recompute, never values) and the launches of
    ``fwd_kernel``, the flash forward: L, or 2L where the backward
    recomputes it ("nothing" and the dots policies). The loss and every
    leaf but the embedding must be equal bit for bit; the embedding's
    gradient is summed by atomic adds in the gather's backward, so it is
    held to four times the relative difference between two remat=False
    runs (or 2^-8). Raises on a miss."""
    import dataclasses

    from deepspeed_tpu_torch.models import transformer as T

    names = list(leaves(params))
    flat = list(leaves(params).values())
    for t in flat:
        t.requires_grad_(True)

    def run(c):
        K.reset_counts()
        loss = T.make_loss_fn(c)(params, batch)
        grads = torch.autograd.grad(loss, flat)
        return float(loss.detach()), dict(zip(names, grads)), K.counts()[fwd_kernel]

    def embed_rel(a, b):
        return float((a["embed"].float() - b["embed"].float()).norm() / b["embed"].float().norm())

    plain = dataclasses.replace(cfg, remat=False)
    base_loss, base, base_n = run(plain)
    floor = embed_rel(run(plain)[1], base)
    limit = max(4 * floor, 2.0 ** -8)
    out = {"remat_false_launches": base_n, "embed_rel_between_plain_runs": floor,
           "embed_rel_limit": limit, "policies": {}}
    L = cfg.n_layers
    for policy in T.REMAT_POLICIES:
        loss, grads, n = run(dataclasses.replace(cfg, remat=True, remat_policy=policy))
        unequal = [k for k in names if k != "embed" and not torch.equal(grads[k], base[k])]
        want = 2 * L if policy in ("nothing", "dots", "dots_with_no_batch_dims") else L
        out["policies"][policy] = {"launches": n, "expected": want,
                                   "loss_equal": loss == base_loss,
                                   "leaves_unequal": unequal,
                                   "embed_rel": embed_rel(grads, base)}
        if (n != want or loss != base_loss or unequal
                or out["policies"][policy]["embed_rel"] > limit):
            raise AssertionError(f"remat_policy {policy!r}: {out['policies'][policy]}")
        del grads
    for t in flat:
        t.requires_grad_(False)
    return out


def train_alibi_phase(torch, dev, K, widths=None, layers=ALIBI_LAYERS, seq=ALIBI_SEQ,
                      timed_steps=3):
    """BLOOM-7b1's width with ALiBi on the flash kernels' ALiBi forms: the
    parity leg (a batch packed into two segments whose positions, and so
    ALiBi's key positions, restart) against ``forward_reference``; on a
    card every ``remat_policy`` on that batch (``remat_check``); the v1
    engine's cached decode (``decode_step``: a 64-token prefill and one
    step, ALiBi as a dense term over the cache) against the full forward;
    then ``train_batch`` steps with the ALiBi kernels' launches counted
    exactly."""
    import numpy as np

    from deepspeed_tpu_torch.models import transformer as T

    widths = dict(widths or {})
    widths.setdefault("dtype", "bfloat16")
    cfg = T.get_config(ALIBI_MODEL, n_layers=layers, remat=False, **widths)
    rec = {"phase": "train_alibi", "model": ALIBI_MODEL, "n_layers": layers, "seq": seq,
           "dtype": cfg.dtype}
    ds_config = dict(TRAIN_CONFIG)
    if cfg.dtype != "bfloat16":
        del ds_config["bf16"]
    rng = np.random.default_rng(SEED + 20)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    batch = packed_batch(torch, dev, rng, 1, seq, cfg.vocab_size)
    other = packed_batch(torch, dev, rng, 1, seq, cfg.vocab_size)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    rec["parity"], grads = train_parity(torch, cfg, params, T.make_loss_fn(cfg), batch, other,
                                        control_by="all")
    del grads
    rec["parity"].update(batch=[1, seq], segments=2, launches=K.counts(),
                         seconds=time.perf_counter() - t0)
    if dev.type == "cuda":
        rec["remat"] = remat_check(torch, K, cfg, params, batch, "flash_fwd_alibi")

    # v1's cached decode: prefill 64 tokens, then one token, each against
    # the full forward's rows
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 65)), device=dev)
    caches = T.init_kv_cache(cfg, 1, 128, device=dev)
    with torch.no_grad():
        pre, caches = T.decode_step(params, toks[:, :64], cfg, caches,
                                    torch.arange(64, device=dev)[None])
        one, caches = T.decode_step(params, toks[:, 64:], cfg, caches,
                                    torch.tensor([[64]], device=dev))
        ref = T.forward_reference(params, toks, cfg)[0][0].float()
    got = torch.cat([pre[0], one[0]]).float()
    rec["decode"] = {"prefill": 64, "steps": 1,
                     "logit_rel_err": rows_rel_err(torch, got, ref),
                     "logit_rel_err_shifted": rows_rel_err(torch, got[1:], ref[:-1]),
                     "logit_rtol": LOGIT_RTOL}
    if (rec["decode"]["logit_rel_err"] > LOGIT_RTOL
            or rec["decode"]["logit_rel_err_shifted"] <= LOGIT_RTOL):
        raise AssertionError(f"train_alibi: decode_step logits {rec['decode']}")
    del params, ref, caches
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    gas = ds_config["gradient_accumulation_steps"]
    batches = [{"input_ids": torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(gas, seq + 1)),
                                             device=dev)} for _ in range(1 + timed_steps)]
    per_step = {"flash_fwd_alibi": gas * layers, "flash_bwd_dq_alibi": gas * layers,
                "flash_bwd_dkv_alibi": gas * layers}
    launches = timed_train(torch, dev, K, cfg, ds_config, batches, per_step, rec)
    return rec, launches


@contextlib.contextmanager
def forced_routes(torch, routes):
    """MoE gating inside takes the given top-k sets: ``routes[li]`` [rows,
    k] for the li-th gating call (a layer of one forward), the values the
    gates at those experts, in descending order."""
    from deepspeed_tpu_torch.parallel.moe import sharded_moe as M

    real = M._top_k
    calls = iter(routes)

    def top_k(gates, k):
        idx = torch.as_tensor(next(calls), device=gates.device).long()
        vals = gates.gather(-1, idx)
        order = vals.argsort(dim=-1, descending=True, stable=True)
        return vals.gather(-1, order), idx.gather(-1, order)

    M._top_k = top_k
    try:
        yield
    finally:
        M._top_k = real


# a row may take another top-k set than forward_reference's own only where
# the reference's gate margin there (relative to the RMS of the row's router
# logits) is within the rounding a bf16 kernel path puts on those logits:
# twice the logits tolerance the engine is held to, so about a tenth of the
# ~0.45 RMS that separates the 2nd and 3rd of 8 random logits
ROUTE_MARGIN_RTOL = 2 * LOGIT_RTOL


def route_flip_gate(natural, engine, margins):
    """Holds one sequence's engine routes against forward_reference's own,
    each a list over layers of [rows, k] sorted expert sets, ``margins`` the
    reference's [rows] gate margins per layer. A flip at (layer li, row p)
    is first where every row up to p took the reference's experts at every
    layer before li: only rounding then separates the two router inputs, so
    its margin must be within ``ROUTE_MARGIN_RTOL``. A later flip sees an
    input that another choice of experts moved, and is counted alone.
    Returns (first, later, largest first margin, largest margin of all)."""
    import numpy as np

    diff = np.stack([(e != n).any(-1) for e, n in zip(engine, natural)])  # [layers, rows]
    upstream = np.zeros_like(diff)
    upstream[1:] = np.logical_or.accumulate(np.logical_or.accumulate(diff, axis=0)[:-1], axis=1)
    first = diff & ~upstream
    mg = np.stack(margins)
    largest_first = float(mg[first].max()) if first.any() else 0.0
    if largest_first > ROUTE_MARGIN_RTOL:
        li, p = (int(i[0]) for i in np.nonzero(first & (mg > ROUTE_MARGIN_RTOL)))
        raise AssertionError(
            f"engine_moe: row {p} took experts {engine[li][p].tolist()} at layer {li} where "
            f"forward_reference took {natural[li][p].tolist()} with a gate margin of "
            f"{float(mg[li, p])} of its logits' RMS (> {ROUTE_MARGIN_RTOL})")
    return (int(first.sum()), int((diff & upstream).sum()), largest_first,
            float(mg[diff].max()) if diff.any() else 0.0)


def moe_flips(calls_a, calls_b):
    """Rows whose top-k expert set differs between two runs' gating calls
    over the same rows, per call: (count, a [rows] bool of flipped)."""
    flipped = None
    for a, b in zip(calls_a, calls_b):
        diff = (a["top"] != b["top"]).any(-1)
        flipped = diff if flipped is None else flipped | diff
    return int(flipped.sum()), flipped


def train_moe_phase(torch, dev, K, widths=None, layers=MOE_TRAIN_LAYERS, seq=MOE_TRAIN_SEQ,
                    timed_steps=3):
    """Mixtral-8x7B's width: the parity leg (the kernels path's loss, the
    aux loss included, and gradients against ``forward_reference``'s). A
    near-tie in routing may pick other experts under the kernels than under
    the plain path: the rows whose top-2 set differs are counted (a forward
    of each path with the gating recorded) and left out of both losses'
    masks, so the comparison holds the rows routed alike. Then
    ``train_batch`` steps with the RMSNorm and flash launches counted."""
    import numpy as np

    from deepspeed_tpu_torch.models import transformer as T

    widths = dict(widths or {})
    widths.setdefault("dtype", "bfloat16")
    cfg = T.get_config(MOE_MODEL, n_layers=layers, remat=False, **widths)
    rec = {"phase": "train_moe", "model": MOE_MODEL, "n_layers": layers, "seq": seq,
           "dtype": cfg.dtype, "capacity_factor": cfg.moe_capacity_factor}
    ds_config = dict(TRAIN_CONFIG)
    if cfg.dtype != "bfloat16":
        del ds_config["bf16"]
    rng = np.random.default_rng(SEED + 30)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    batch = packed_batch(torch, dev, rng, 1, seq, cfg.vocab_size)
    other = packed_batch(torch, dev, rng, 1, seq, cfg.vocab_size)
    inputs, labels, _, positions, segment_ids = T.split_lm_batch(batch)
    calls, undo = routes_spy(torch)
    try:
        with torch.no_grad():
            T.forward(params, inputs, cfg, positions=positions, segment_ids=segment_ids)
            n_kernel = len(calls)
            T.forward_reference(params, inputs, cfg, positions=positions, segment_ids=segment_ids)
    finally:
        undo()
    flips, flipped = moe_flips(calls[:n_kernel], calls[n_kernel:])
    mask = torch.as_tensor(~flipped.reshape(labels.shape), device=dev, dtype=torch.float32)
    batch = dict(batch, loss_mask=torch.cat([mask[:, :1], mask], dim=1))
    loss_fn = T.make_loss_fn(cfg)

    def reference_loss(p, b):
        inp, lab, msk, pos, seg = T.split_lm_batch(b)
        logits, aux = T.forward_reference(p, inp, cfg, positions=pos, segment_ids=seg)
        return T.nll_loss(logits, lab, msk) + cfg.moe_aux_loss_coef * aux

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rec["parity"], grads = train_parity(torch, cfg, params, loss_fn, batch, other,
                                        reference_loss=reference_loss, control_by="all")
    del grads, params
    rec["parity"].update(batch=[1, seq], segments=2, routing_flips=flips,
                         rows_held=int(mask.sum()), seconds=time.perf_counter() - t0,
                         peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                                      if dev.type == "cuda" else None))
    print(f"train_moe: {flips} of {labels.numel()} tokens routed to another top-2 set under "
          "the kernels than under forward_reference (left out of the parity losses)", flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    gas = ds_config["gradient_accumulation_steps"]
    batches = [{"input_ids": torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(gas, seq + 1)),
                                             device=dev)} for _ in range(1 + timed_steps)]
    per_step = {"flash_fwd": gas * layers, "flash_bwd_dq": gas * layers,
                "flash_bwd_dkv": gas * layers, "rms_norm_fwd": gas * (2 * layers + 1),
                "rms_norm_bwd": gas * (2 * layers + 1)}
    launches = timed_train(torch, dev, K, cfg, ds_config, batches, per_step, rec)
    return rec, launches


def engine_moe_phase(torch, dev, K, widths=None, engine_config=None, layers=MOE_ENGINE_LAYERS,
                     n_prompts=MOE_ENGINE_PROMPTS):
    """``InferenceEngineV2`` at Mixtral-8x7B's width (the MoE block through
    the engine's ``_layer_tail``): 8 prompts prefilled through ``step()``,
    two single steps and ``decode_round(64)``, launches counted exactly.
    The rows' routing is recorded in the engine and in ``forward_reference``
    over each sequence: bf16 rounding moves near-tied tokens to another
    top-2 set, and a moved token also changes later rows through
    attention. The rows whose own token moved are counted; every row's
    logits are held against ``forward_reference`` run again under the
    engine's routing (the kernels' numerics alone), and the rows routed
    alike against the plain reference (reported). Then the same prompts on
    an engine at capacity factor 1.25, where choices are dropped: finite
    logits, tokens in the vocabulary, the same launches."""
    import numpy as np

    from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import transformer as T

    t0 = time.perf_counter()
    cfg = T.get_config(MOE_MODEL, n_layers=layers, **(widths or {}))
    rec = {"phase": "engine_moe", "model": MOE_MODEL, "n_layers": layers,
           "capacity_factor": cfg.moe_capacity_factor}
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    rc = RaggedInferenceEngineConfig.from_dict(engine_config or ENGINE_CONFIG)
    rng = np.random.default_rng(SEED + 40)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(64, 512, size=n_prompts)]
    rec["params"] = T.num_params(params)
    rec["reckoned_weights_gb"] = rec["params"] * 2 / 1e9
    L = cfg.n_layers

    def serve(c):
        eng = InferenceEngineV2(c, params, rc, device=dev.type)
        rec.setdefault("kv_pool_info", eng.kv_pool_info())
        K.reset_counts()
        calls, undo = routes_spy(torch)
        try:
            run = serve_counted_path(torch, dev, eng, prompts)
        finally:
            undo()
        launches = K.counts()
        expected = {name: 0 for name in launches}
        fwd_steps = run["split_steps"] + 64
        expected.update({"rms_norm_fwd": (2 * L + 1) * fwd_steps, "paged_decode": L * fwd_steps})
        if dev.type == "cuda" and launches != expected:
            raise AssertionError(f"engine_moe kernel launches {launches}, expected {expected}")
        for uid in list(eng.scheduler.running_uids()):
            eng.scheduler.finish(uid)
        del eng
        return run, calls, launches, expected

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    run, calls, launches, expected = serve(cfg)
    rec.update(launches=launches, launches_expected=expected, prefill_steps=run["prefill_steps"],
               round_seconds=run["round_seconds"], prefill_seconds=run["prefill_seconds"])
    # the engine's route of every (token, position) row it ran, per layer
    seen = {}
    for i in range(0, len(calls), L):
        toks, pos = calls[i]["rows"]
        for r in range(len(toks)):
            seen.setdefault((int(toks[r]), int(pos[r])), []).append(
                [calls[i + li]["top"][r] for li in range(L)])
    errs, errs_own, shifted, flips, rows, unresolved = [], [], [], 0, 0, 0
    gate_flips = {"first": 0, "later": 0, "largest_first_margin": 0.0, "largest_margin": 0.0,
                  "margin_rtol": ROUTE_MARGIN_RTOL}
    for row, uid in enumerate(run["rounds"]):
        mine, toks_in = logit_rows(torch, run, uid, row)
        n_p = len(prompts[uid])
        full = toks_in + [int(run["rounds"][uid][-1])]
        toks = torch.as_tensor(np.asarray(full, np.int64), device=dev)[None]
        ref_calls, undo = routes_spy(torch)
        try:
            with torch.no_grad():
                ref = T.forward_reference(params, toks, cfg)[0][0].float()
        finally:
            undo()
        # the engine's routes of this sequence's rows (a position it never
        # ran, the last token, keeps the reference's own)
        # A (token, position) pair the engine ran more than once with other
        # routes (another sequence's row, a padded row at (0, 0)) is this
        # sequence's when one of them is the reference's own; where none is,
        # its route is unknown and rows from there on are not held.
        natural_routes = [np.array(ref_calls[li]["top"]) for li in range(L)]
        routes = [r.copy() for r in natural_routes]
        own = np.zeros(len(full), bool)  # the row's own token routed alike
        unknown_from = len(full)
        for p in range(len(full)):
            natural = [routes[li][p].copy() for li in range(L)]
            distinct = []
            for r in seen.get((full[p], p), []):
                if not any(all(np.array_equal(r[li], d[li]) for li in range(L)) for d in distinct):
                    distinct.append(r)
            same = any(all(np.array_equal(d[li], natural[li]) for li in range(L))
                       for d in distinct)
            own[p] = same or not distinct
            if len(distinct) == 1:
                for li in range(L):
                    routes[li][p] = distinct[0][li]
            elif distinct and not same:
                unknown_from = min(unknown_from, p)
        first, later, top_first, top_all = route_flip_gate(
            natural_routes, routes, [ref_calls[li]["margin"] for li in range(L)])
        gate_flips["first"] += first
        gate_flips["later"] += later
        gate_flips["largest_first_margin"] = max(gate_flips["largest_first_margin"], top_first)
        gate_flips["largest_margin"] = max(gate_flips["largest_margin"], top_all)
        # the reference again under the engine's routing: the kernels'
        # numerics alone against the plain path's, on every row
        with torch.no_grad(), forced_routes(torch, routes):
            forced = T.forward_reference(params, toks, cfg)[0][0].float()
        if not bool(torch.isfinite(ref).all() and torch.isfinite(forced).all()):
            raise AssertionError("engine_moe: non-finite reference logits")
        n_rows = max(0, min(mine.shape[0], unknown_from - (n_p - 1)))
        unresolved += mine.shape[0] - n_rows
        if n_rows:
            idx = n_p - 1 + torch.arange(n_rows, device=mine.device)
            errs.append(rows_rel_err(torch, mine[:n_rows], forced[idx]))
        keep = torch.as_tensor(np.flatnonzero(own[n_p - 1:n_p - 1 + mine.shape[0]]),
                               device=mine.device)
        if len(keep):
            errs_own.append(rows_rel_err(torch, mine[keep], ref[n_p - 1 + keep]))
        flips += int((~own[n_p - 1:n_p - 1 + mine.shape[0]]).sum())
        rows += mine.shape[0]
        shifted.append(rows_rel_err(torch, mine[0], forced[n_p - 2]))
    rec["routing_flips"] = flips
    rec["route_flips_by_layer_row"] = gate_flips
    rec["rows"] = rows
    rec["rows_route_unknown"] = unresolved
    rec["logit_rel_err"] = max(errs)
    rec["logit_rel_err_own_routing"] = max(errs_own)
    rec["logit_rel_err_shifted"] = min(shifted)
    rec["logit_rtol"] = LOGIT_RTOL
    print(f"engine_moe: {flips} of {rows} logits rows had their token routed to another top-2 "
          f"set in the engine than in forward_reference; {rows - unresolved} rows held against "
          "the reference under the engine's routing", flush=True)
    print(f"engine_moe: {gate_flips['first']} (layer, row) flips with the same experts "
          f"upstream, largest gate margin {gate_flips['largest_first_margin']} of the logits' "
          f"RMS (bound {ROUTE_MARGIN_RTOL}); {gate_flips['later']} after another flip, largest "
          f"margin of all flips {gate_flips['largest_margin']}", flush=True)
    if rec["logit_rel_err"] > LOGIT_RTOL or rec["logit_rel_err_shifted"] <= LOGIT_RTOL:
        raise AssertionError(f"engine_moe logits: {rec['logit_rel_err']} against "
                             f"forward_reference, control {rec['logit_rel_err_shifted']}")
    del run, calls, seen

    # capacity factor 1.25: the same prompts, choices dropped
    drop_cfg = T.get_config(MOE_MODEL, n_layers=layers, moe_capacity_factor=MOE_DROP_CF,
                            **(widths or {}))
    run, calls, launches, _ = serve(drop_cfg)
    logits = torch.cat([torch.as_tensor(v, device=dev).float().reshape(-1, cfg.vocab_size)
                        for v in run["prefill_logits"].values()]
                       + [run["round_logits"].float().reshape(-1, cfg.vocab_size)])
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("engine_moe at capacity factor 1.25: non-finite logits")
    if not all(0 <= int(t) < cfg.vocab_size for g in run["rounds"].values() for t in g):
        raise AssertionError("engine_moe at capacity factor 1.25: a token outside the vocabulary")
    rec["drop_run"] = {"capacity_factor": MOE_DROP_CF, "launches": launches,
                       "gating_calls": len(calls),
                       "calls_dropping": sum(c["kept"] < c["chosen"] for c in calls),
                       "choices_dropped": sum(c["chosen"] - c["kept"] for c in calls),
                       "round_seconds": run["round_seconds"]}
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
    rec["seconds_in_phase"] = time.perf_counter() - t0
    del params
    return rec, launches


def mlm_batch(torch, dev, rng, b, s, vocab):
    """A masked-LM batch: input_ids [b, s], labels = the ids, loss_mask on
    MLM_MASKED of the positions."""
    toks = rng.integers(0, vocab, size=(b, s))
    mask = (rng.random((b, s)) < MLM_MASKED).astype("float32")
    return {"input_ids": torch.as_tensor(toks, device=dev),
            "labels": torch.as_tensor(toks, device=dev),
            "loss_mask": torch.as_tensor(mask, device=dev)}


# train_mlm's gradient witness: the depths it reads (and the model's full
# depth), and how much farther from the fp32 reference than the flash
# Function's plain versions (the kernels' arithmetic) the kernel path may
# sit, where that is more than PARITY_GRAD_RTOL
MLM_WITNESS_DEPTHS, MLM_WITNESS_RATIO = (2, 6, 12), 1.25


@contextlib.contextmanager
def plain_flash(delta_fp32=False):
    """The flash Function's CUDA wrappers replaced by their plain versions
    (the kernels' arithmetic, nothing launched). With ``delta_fp32`` the
    backward's delta is sum(dO * O) over an fp32 O (P unrounded), which is
    sum(P * dP), in place of the bf16 O the kernels read."""
    from deepspeed_tpu_torch.ops.attention import flash as F

    real = F.flash_fwd_cuda, F.flash_bwd_dq_cuda, F.flash_bwd_dkv_cuda

    def bwd(q, k, v, out, do, lse, **kw):
        if delta_fp32:
            out = F.flash_fwd_reference(q.float(), k.float(), v.float(), **kw)[0]
        return F.flash_bwd_reference(q, k, v, out, do, lse, **kw)

    F.flash_fwd_cuda = F.flash_fwd_reference
    F.flash_bwd_dq_cuda = lambda *a, **kw: bwd(*a, **kw)[0]
    F.flash_bwd_dkv_cuda = lambda *a, **kw: bwd(*a, **kw)[1:]
    try:
        yield
    finally:
        F.flash_fwd_cuda, F.flash_bwd_dq_cuda, F.flash_bwd_dkv_cuda = real


def mlm_rounding_witness(torch, dev, widths, batch, full_depth):
    """Every gradient of the MLM loss at BERT-large's widths, at each of
    ``MLM_WITNESS_DEPTHS`` below ``full_depth`` and at ``full_depth``, on
    the same bf16 weights through: the kernels (``make_loss_fn``), the
    flash Function's plain versions, those with delta over an fp32 O
    (``plain_flash``), ``forward_reference`` in bf16, and the truth:
    ``forward_reference`` in fp32 on the weights widened. Per path the
    relative Frobenius gap to the truth, per leaf; raises where the
    kernels' gap exceeds both PARITY_GRAD_RTOL and ``MLM_WITNESS_RATIO``
    times the plain versions'. Returns {depth: record}."""
    import dataclasses

    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.utils.tree import tree_map

    inputs, labels, mask, _, _ = T.split_lm_batch(batch)

    def grads(cfg, params, loss):
        flat = list(leaves(params).values())
        for t in flat:
            t.requires_grad_(True)
        out = [g.float() for g in torch.autograd.grad(loss(cfg, params), flat)]
        for t in flat:
            t.requires_grad_(False)
        return out

    def reference(cfg, params):
        return T.nll_loss(T.forward_reference(params, inputs, cfg)[0], labels, mask)

    def model(cfg, params):
        return T.make_loss_fn(cfg)(params, batch)

    out = {}
    for depth in sorted({d for d in MLM_WITNESS_DEPTHS if d < full_depth} | {full_depth}):
        c16 = T.get_config(MLM_MODEL, remat=False, **dict(widths, n_layers=depth))
        p16 = T.init_params(c16, torch.Generator(device=dev).manual_seed(SEED), dev)
        names = [n for n in leaves(p16) if n not in ZERO_GRAD_LEAVES]
        truth = grads(dataclasses.replace(c16, dtype="float32"),
                      tree_map(lambda t: t.float(), p16), reference)
        paths = {"kernels": grads(c16, p16, model)}
        with plain_flash():
            paths["flash_plain"] = grads(c16, p16, model)
        with plain_flash(delta_fp32=True):
            paths["flash_plain_delta_fp32"] = grads(c16, p16, model)
        paths["bf16_reference"] = grads(c16, p16, reference)
        gaps = {}
        for path, g in paths.items():
            gaps[path] = {n: float((a - t).norm()) / float(t.norm())
                          for n, a, t in zip(leaves(p16), g, truth) if n in names}
        del p16, truth, paths
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        for n in names:
            kb, pb = gaps["kernels"][n], gaps["flash_plain"][n]
            if kb > max(MLM_WITNESS_RATIO * pb, PARITY_GRAD_RTOL):
                raise AssertionError(
                    f"train_mlm at {depth} layers: the kernels' {n} gradient sits {kb} from "
                    f"the fp32 reference's, the flash plain versions' {pb}")
        out[depth] = {"max_vs_fp32": {p: max(v.values()) for p, v in gaps.items()},
                      "wq_vs_fp32": {p: v.get("layers/wq") for p, v in gaps.items()},
                      "ratio_bound": MLM_WITNESS_RATIO}
    return out


def train_mlm_phase(torch, dev, K, widths=None, layers=None, seq=MLM_SEQ, micro=MLM_MICRO,
                    timed_steps=3, parity_layers=PARITY_LAYERS):
    """BERT-large through the non-causal flash kernels at d 64: the three
    kernels at its attention shape (micro-batch 8, 16 heads, s 512) against
    their plain versions; the parity leg at ``parity_layers`` layers, as
    the train phase's (the MLM loss and every gradient against
    ``forward_reference``'s: deeper, the flash backward's delta, summed
    over the bf16 O, moves the wq/wk gradients by more); the MLM
    loss at its full depth against ``forward_reference``'s; every gradient
    at 2, 6, 12 and 24 layers against ``forward_reference`` in fp32, the
    kernels held to their plain versions' gap (``mlm_rounding_witness``);
    then
    ``train_batch`` steps with the flash launches counted exactly
    (LayerNorm is plain: no RMSNorm kernel)."""
    import numpy as np

    from deepspeed_tpu_torch.models import transformer as T

    widths = dict(widths or {})
    widths.setdefault("dtype", "bfloat16")
    if layers is not None:
        widths["n_layers"] = layers
    cfg = T.get_config(MLM_MODEL, remat=False, **widths)
    rec = {"phase": "train_mlm", "model": MLM_MODEL, "n_layers": cfg.n_layers, "seq": seq,
           "micro_batch": micro, "dtype": cfg.dtype}
    ds_config = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=micro)
    if cfg.dtype != "bfloat16":
        del ds_config["bf16"]
    rng = np.random.default_rng(SEED + 50)
    t0 = time.perf_counter()

    # the kernels at BERT's attention shape, non-causal
    if cfg.dtype == "bfloat16" and dev.type == "cuda":
        errs = {name: {} for name in TRAIN_KERNELS[2:]}
        tile_errs = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}
        c = dict(b=micro, h=cfg.n_heads, h_kv=cfg.kv_heads, s=seq, d=cfg.head_dim,
                 causal=False, window=0, window_flag=None, seg=None)
        check_flash_case(torch, dev, errs, tile_errs, "bert", c, seed=SEED + 51)
        rec["kernels_at_shape"] = {"shape": {k: c[k] for k in ("b", "h", "s", "d", "causal")},
                                   "max_abs_err": errs, "tile_rel_frobenius": tile_errs}

    small = T.get_config(MLM_MODEL, remat=False, **dict(widths, n_layers=parity_layers))
    params = T.init_params(small, torch.Generator(device=dev).manual_seed(SEED), dev)
    batch = mlm_batch(torch, dev, rng, micro, seq, cfg.vocab_size)
    other = mlm_batch(torch, dev, rng, micro, seq, cfg.vocab_size)
    rec["parity"], grads = train_parity(torch, small, params, T.make_loss_fn(small), batch,
                                        other, control_by="all")
    del grads, params
    rec["parity"].update(layers=parity_layers, batch=[micro, seq],
                         seconds=time.perf_counter() - t0)

    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    with torch.no_grad():
        k_loss = float(T.make_loss_fn(cfg)(params, batch))
        logits, _ = T.forward_reference(params, batch["input_ids"], cfg)
        r_loss = float(T.nll_loss(logits, batch["labels"], batch["loss_mask"]))
    del logits, params
    rec["full_depth_loss"] = {"kernels": k_loss, "reference": r_loss,
                              "abs_diff": abs(k_loss - r_loss), "atol": PARITY_LOSS_ATOL}
    if not np.isfinite(k_loss) or abs(k_loss - r_loss) > PARITY_LOSS_ATOL:
        raise AssertionError(f"train_mlm: the full-depth loss {rec['full_depth_loss']}")
    rec["rounding_witness"] = mlm_rounding_witness(torch, dev, widths, batch, cfg.n_layers)
    for depth, w in rec["rounding_witness"].items():
        print(f"train_mlm gradients at {depth} layers, largest gap to the fp32 reference: "
              + ", ".join(f"{p} {g}" for p, g in w["max_vs_fp32"].items()), flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gas = ds_config["gradient_accumulation_steps"]
    batches = [mlm_batch(torch, dev, rng, gas * micro, seq, cfg.vocab_size)
               for _ in range(1 + timed_steps)]
    L = cfg.n_layers
    per_step = {"flash_fwd": gas * L, "flash_bwd_dq": gas * L, "flash_bwd_dkv": gas * L}
    launches = timed_train(torch, dev, K, cfg, ds_config, batches, per_step, rec)
    return rec, launches


# ---------------------------------------------------------------------------
# the context-parallel ring: loopback form, N = 4 context ranks on one card
# ---------------------------------------------------------------------------
RING_N = 4
# (a) Llama-2-7B attention (32 heads of 128, MHA) and (b) Mistral-7B-v0.2
# attention (32 query heads over 8 kv heads of 128; v0.2 has no sliding
# window and a 32k context), both at s 32768, b 1, bf16
RING_CASES = {"llama2_7b_mha": dict(h=32, h_kv=32), "mistral_7b_v02_gqa": dict(h=32, h_kv=8)}
RING_SEQ = 32768
# the ring's training leg: llama-7b width (h 4096, 32 heads of 128, MHA,
# ffn 11008, vocab 32000) at 8 of 32 layers (full depth is ~135 GB of
# params and optimizer state at 20 B a parameter), max_seq_len raised to
# 16384 and 4 chunks of 4096, remat with policy "nothing"
RING_MODEL = "llama-7b"
RING_TRAIN_SEQ = 16384


def ring_attn_phase(torch, dev, K, cases=None, seq=RING_SEQ, n=RING_N, d=128, seed=SEED):
    """``attention(impl="flash_ring")`` on a loopback ``Topology(context=N)``
    at each case's width: fwd + bwd bit for bit against ``flash_attention``
    in the same run (``ring_against_flash``), exact carry-kernel launches,
    the ring call's wall ms against the single call's and against SDPA at
    the same s (a yardstick), and the peak memory of each."""
    from deepspeed_tpu_torch.ops.attention import flash as F
    from deepspeed_tpu_torch.ops.attention.core import attention
    from deepspeed_tpu_torch.parallel.topology import Topology, reset_topology, set_topology

    cases = cases or RING_CASES
    rec = {"phase": "ring_attn", "n": n, "seq": seq, "form": "loopback", "cases": {}}
    set_topology(Topology(context=n, loopback=True))
    try:
        for i, (name, c) in enumerate(cases.items()):
            q, k, v, do = flash_inputs(torch, dev, 1, c["h"], c["h_kv"], seq, d, seed=seed + 60 + i)
            if dev.type != "cuda":
                q, k, v, do = (t.float() for t in (q, k, v, do))
            res = ring_against_flash(torch, q, k, v, do)
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

            def fwd_bwd(fn):
                out = fn()
                torch.autograd.grad(out, leaves, do)

            timed = {"ring": lambda: fwd_bwd(lambda: attention(*leaves, impl="flash_ring")),
                     "single": lambda: fwd_bwd(lambda: F.flash_attention(*leaves))}
            if dev.type == "cuda":
                from torch.nn.attention import SDPBackend, sdpa_kernel

                def sdpa():
                    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                        return torch.nn.functional.scaled_dot_product_attention(
                            *leaves, is_causal=True, enable_gqa=True)

                timed["sdpa"] = lambda: fwd_bwd(sdpa)
            for what, fn in timed.items():
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    res[f"{what}_ms"] = eager_ms(torch, fn, iters=3, warmup=1)
                    res[f"{what}_peak_extra_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
                else:
                    fn()
            if dev.type == "cuda":
                res["ring_over_single"] = res["ring_ms"] / res["single_ms"]
            res.update(h=c["h"], h_kv=c["h_kv"], d=d)
            rec["cases"][name] = res
            del q, k, v, do, leaves
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        reset_topology()
    launches = {name: rec["cases"][next(iter(cases))]["launches"].get(name, 0)
                for name in CARRY_KERNELS}
    return rec, launches


def train_ring_phase(torch, dev, K, widths=None, seq=RING_TRAIN_SEQ, layers=TRAIN_LAYERS, n=RING_N,
                     timed_steps=4, profile=False):
    """``initialize(mpu=Topology(context=N, loopback=True))`` ->
    ``train_batch`` with ``attention_impl="flash_ring"`` at llama-7b width.
    Parity first: on the same params and batch, the first step's loss and
    every gradient (the engine's ``forward`` / ``backward`` over the gas
    micro-batches, summed in its fp32 buffers) must equal those of the same
    engine with ``attention_impl="flash"`` bit for bit on a card (MHA makes
    the whole step bitwise; the engines are built one after the other).
    Then ``step``, 1 warm-up and ``timed_steps`` timed ``train_batch``
    steps: losses, step seconds, tok/s, MFU, peak memory and the exact
    launches per optimizer step (remat runs each layer's ring forward
    again in the backward)."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.parallel.topology import Topology, reset_topology, set_topology

    widths = dict(widths or {})
    widths.setdefault("dtype", "bfloat16")
    widths.setdefault("max_seq_len", seq)
    ds_config = dict(TRAIN_CONFIG)
    if widths["dtype"] != "bfloat16":  # a CPU rehearsal in the model's own dtype
        del ds_config["bf16"]
    gas = ds_config["gradient_accumulation_steps"]
    rec = {"phase": "train_ring", "model": RING_MODEL, "seq": seq, "n": n, "form": "loopback",
           "dtype": widths["dtype"], "layers": layers}
    rng = np.random.default_rng(SEED)
    batches = [{"input_ids": torch.as_tensor(
        rng.integers(0, T.get_config(RING_MODEL, **widths).vocab_size, size=(gas, seq + 1)),
        device=dev)} for _ in range(2 + timed_steps)]
    exact = dev.type == "cuda"

    def first_step(impl):
        """(engine, loss, grads on the host) of the first step's micro-batches."""
        cfg = T.get_config(RING_MODEL, n_layers=layers, attention_impl=impl, remat=True,
                           remat_policy="nothing", **widths)
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 2), dev)
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=T.make_loss_fn(cfg), model_parameters=params, config=ds_config,
            mpu=Topology(context=n, loopback=True) if impl == "flash_ring" else None)
        del params
        losses = []
        for i in range(gas):
            if i:
                eng.step()  # a micro-step: counts, no update before the boundary
            losses.append(eng.forward({k: v[i:i + 1] for k, v in batches[0].items()}))
            eng.backward(losses[-1])
        grads = {name: g.cpu() for name, g in leaves(eng._acc_grads).items()}
        return eng, torch.stack(losses).mean(), grads, cfg

    t0 = time.perf_counter()
    try:
        eng, f_loss, f_grads, _ = first_step("flash")
        del eng
        _sync(torch, dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        K.reset_counts()
        eng, r_loss, r_grads, cfg = first_step("flash_ring")
        first_launches = K.counts()
        diff = {name: float((r_grads[name] - g).abs().max()) for name, g in f_grads.items()}
        same = {name: bool(torch.equal(r_grads[name], g)) for name, g in f_grads.items()}
        rec["parity"] = {
            "loss_ring": float(r_loss), "loss_flash": float(f_loss),
            "loss_bitwise": bool(torch.equal(r_loss, f_loss)),
            "grads_bitwise": all(same.values()), "grad_leaves": len(same),
            "grad_max_abs_diff": max(diff.values()),
            "seconds": time.perf_counter() - t0,
        }
        if exact and not (rec["parity"]["loss_bitwise"] and rec["parity"]["grads_bitwise"]):
            off = [name for name, ok in same.items() if not ok]
            raise AssertionError(f"train_ring: the first step is not the flash engine's bits: "
                                 f"{rec['parity']}, leaves off {off}")
        if not exact and (abs(float(r_loss) - float(f_loss)) > 1e-5 or max(diff.values()) > 1e-4):
            raise AssertionError(f"train_ring rehearsal: ring and flash differ: {rec['parity']}")
        del f_grads, r_grads
        eng.step()  # the boundary: the first update
        if eng.global_steps != 1:
            raise AssertionError(f"train_ring: {eng.global_steps} optimizer steps after the first")

        K.reset_counts()
        losses, step_s = [], []
        for b in batches[1:]:
            t1 = time.perf_counter()
            losses.append(float(eng.train_batch(batch=b)))
            _sync(torch, dev)
            step_s.append(time.perf_counter() - t1)
        launches = K.counts()
    finally:
        reset_topology()
    steps = len(batches) - 1
    hops = n * (n + 1) // 2
    per_step = {"flash_fwd_chunk": gas * layers * 2 * hops, "flash_dq_chunk": gas * layers * hops,
                "flash_dkv_chunk": gas * layers * hops,
                "rms_norm_fwd": gas * (2 * layers * 2 + 1), "rms_norm_bwd": gas * (2 * layers + 1)}
    expected = {name: 0 for name in launches}
    expected.update({k: v * steps for k, v in per_step.items()})
    rec["launches"] = launches
    rec["launches_expected"] = expected
    rec["launches_per_optimizer_step"] = per_step
    rec["launches_first_step_micro_batches"] = {k: v for k, v in first_launches.items() if v}
    if exact and launches != expected:
        raise AssertionError(f"train_ring kernel launches {launches}, expected {expected}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train_ring: non-finite losses {losses}")
    timed = step_s[1:]
    tokens = gas * ds_config["train_micro_batch_size_per_gpu"] * seq
    rec["params"] = sum(t.numel() for t in leaves(eng.params).values())
    rec["losses"] = losses
    rec["step_seconds"] = step_s
    rec["warmup_step_seconds"] = step_s[0]
    rec["mean_step_seconds"] = sum(timed) / len(timed)
    rec["tok_s"] = tokens / rec["mean_step_seconds"]
    rec["flops_per_token"] = T.flops_per_token(cfg, seq)
    rec["mfu"] = rec["flops_per_token"] * rec["tok_s"] / BF16_FLOPS
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
    if profile:
        set_topology(Topology(context=n, loopback=True))
        try:
            rec["profile"] = device_profile(torch, {"train_ring_step": lambda: float(
                eng.train_batch(batch=batches[-1]))})
        finally:
            reset_topology()
    del eng
    return rec, launches


def sparse_attn_phase(torch, dev, K, h=32, h_kv=8, d=128, s=SPARSE_TIMED["s"], mask_s=4096,
                      dtype=None, block=SPARSE_TIMED["block"]):
    """The op-registry entry point at Mistral-7B's attention: ``get_accelerator()
    .create_op_builder("sparse_attn").load()`` hands out the block-sparse
    module; its ``SparseSelfAttention(Fixed(block 128, 4 local, 1 global,
    unidirectional), use_splash=False)`` runs forward and backward at b 1,
    ``h`` query heads over ``h_kv`` kv heads (expanded by the module), s
    ``s``. Launches are counted exactly (one of each sparse kernel per call,
    nothing else); out, dq, dk and dv are held against the plain versions
    (the kv gradients summed over each kv head's group). Then a
    ``key_padding_mask`` call at ``mask_s`` (the dense biased form: no
    kernel launches) against ``sparse_attention_with_bias`` in fp32 on the
    same inputs. ``h``/``s``/``dtype`` shrink it for a CPU rehearsal, where
    nothing launches."""
    from deepspeed_tpu_torch import get_accelerator
    from deepspeed_tpu_torch.ops.sparse_attention import sparse as SA

    dtype = dtype or torch.bfloat16
    t_phase = time.perf_counter()
    accel = get_accelerator()
    sa = accel.create_op_builder("sparse_attn").load(verbose=False)
    cfg = sa.FixedSparsityConfig(num_heads=h, block=block,
                                 num_local_blocks=SPARSE_TIMED["num_local_blocks"],
                                 num_global_blocks=SPARSE_TIMED["num_global_blocks"],
                                 attention="unidirectional")
    attn = sa.SparseSelfAttention(cfg, use_splash=False)
    rec = {"phase": "sparse_attn", "model": MODEL, "accelerator": accel._name,
           "entry": "get_accelerator().create_op_builder('sparse_attn').load()"
                    ".SparseSelfAttention(use_splash=False)",
           "shape": {"b": 1, "h": h, "h_kv": h_kv, "d": d, "s": s, "dtype": str(dtype),
                     "block": block, "causal": True},
           "density": float((attn.get_layout(s) != 0).mean())}
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def inputs(n):
        q = torch.randn(1, h, n, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(1, h_kv, n, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(1, h_kv, n, d, generator=gen, device=dev).to(dtype)
        do = torch.randn(1, h, n, d, generator=gen, device=dev).to(dtype)
        return q, k, v, do

    q, k, v, do = inputs(s)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _sync(torch, dev)
    K.reset_counts()
    t0 = time.perf_counter()
    out = attn(*leaves)
    out.backward(do)
    _sync(torch, dev)
    rec["first_call_s"] = time.perf_counter() - t0
    launches = K.counts()
    want = {n: int(on_card and n in SPARSE_KERNELS) for n in K.KERNELS}
    if launches != want:
        raise AssertionError(f"sparse_attn: launches {launches}, expected {want}")
    rec["launches"] = {n: c for n, c in launches.items() if c}
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9 if on_card else None

    # against the plain versions, GQA expanded as the module expands it
    group = h // h_kv
    ke, ve = (t.repeat_interleave(group, dim=1) for t in (k, v))
    lay = attn.device_layout(s, dev)
    ref_out, ref_lse = SA.sparse_fwd_reference(q, ke, ve, lay, block, True)
    errs = {"out": check_close(torch, "sparse_attn out", out.detach(), ref_out, BF16_ATOL,
                               BF16_RTOL)}
    tiles = {"out": tile_rel_err(torch, "sparse_attn out", out.detach(), ref_out)}
    rdq, rdk, rdv = SA.sparse_bwd_reference(q, ke, ve, ref_out, do, ref_lse, lay, block, True)
    del ref_out, ref_lse, out
    for tag, got, want_g in (
            ("dq", leaves[0].grad, rdq),
            ("dk", leaves[1].grad, rdk.float().reshape(1, h_kv, group, s, d).sum(2)),
            ("dv", leaves[2].grad, rdv.float().reshape(1, h_kv, group, s, d).sum(2))):
        scale = max(1.0, float(want_g.float().abs().max()))
        errs[tag] = check_close(torch, f"sparse_attn {tag}", got, want_g, BF16_ATOL * scale,
                                BF16_RTOL)
        tiles[tag] = tile_rel_err(torch, f"sparse_attn {tag}", got, want_g)
    del rdq, rdk, rdv, ke, ve
    rec["max_abs_err"], rec["tile_rel_frobenius"] = errs, tiles

    # seconds of a call (eager: host work included), the mean of three
    t0 = time.perf_counter()
    for _ in range(3):
        for t in leaves:
            t.grad = None
        attn(*leaves).backward(do)
    _sync(torch, dev)
    rec["call_s"] = (time.perf_counter() - t0) / 3
    del q, k, v, do, leaves
    if on_card:
        torch.cuda.empty_cache()

    # the key_padding_mask call: the dense biased form, no kernel
    q, k, v, _ = inputs(mask_s)
    kpm = torch.zeros(1, mask_s, device=dev)
    kpm[:, -mask_s // 8:] = -10000.0  # the last eighth of the keys padded ("add" mode)
    K.reset_counts()
    with torch.no_grad():
        got = attn(q, k, v, key_padding_mask=kpm)
    _sync(torch, dev)
    if any(K.counts().values()):
        raise AssertionError(f"sparse_attn: the key_padding_mask call launched {K.counts()}")
    ke, ve = (t.repeat_interleave(group, dim=1).float() for t in (k, v))
    ref = SA.sparse_attention_with_bias(q.float(), ke, ve, attn.device_layout(mask_s, dev),
                                        block, causal=True, bias=kpm[:, None, None, :])
    errs["key_padding_mask_out"] = check_close(torch, "sparse_attn key_padding_mask", got,
                                               ref, BF16_ATOL, BF16_RTOL)
    rec["key_padding_mask"] = {"s": mask_s, "padded_keys": mask_s // 8, "launches": 0}
    del q, k, v, ke, ve, got, ref
    if on_card:
        rec["peak_mem_gb_with_mask_call"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec, launches


# ---------------------------------------------------------------------------
# evoformer attention (the op registry's evoformer_attn)
# ---------------------------------------------------------------------------
EVOFORMER_KERNELS = ("evoformer_fwd", "evoformer_bwd_dq", "evoformer_bwd_dkv",
                     "evoformer_bias_grad_merge")
# AlphaFold2's Evoformer at its fine-tuning crop (Jumper et al. 2021, SI
# Algorithms 7 and 13-14, Table 4): N_seq 512, N_res 384; MSA row attention
# with pair bias (c_m 256: 8 heads x 32) and triangle attention (c_z 128: 4
# heads x 32). Leading dims [1, n]; bias1 the per-row mask [1, n, 1, 1, s],
# bias2 the pair bias [1, 1, h, s, s].
EVOFORMER_SHAPES = {"msa_row": dict(n=512, s=384, h=8, d=32),
                    "triangle": dict(n=384, s=384, h=4, d=32)}
# AlphaFold's mask convention, bias1 = 1e9 * (mask - 1), with the last
# residues (keys) and the last rows padded off
EVO_PAD_KEYS = 24
EVO_PAD_ROWS = 16
# the dS plane (fp32 in kernel and plain version: the same fp32 products
# summed in another order, through exp) and the fp32 kernels' outputs (FFMA
# in another order than torch's matmuls), both scaled by the reference's
# largest element
EVO_DS_ATOL = 1e-5
EVO_DS_RTOL = 1e-4
EVO_FP32_ATOL = 2e-5
EVO_FP32_RTOL = 2e-5


def evo_inputs(torch, dev, n, s, h, d, dtype, seed, pad_keys=EVO_PAD_KEYS,
               pad_rows=EVO_PAD_ROWS):
    """Q, K, V, dO [1, n, s, h, d] in ``dtype`` and the two fp32 biases:
    AlphaFold's mask (the last ``pad_keys`` keys and ``pad_rows`` rows off)
    and a random pair bias."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(1, n, s, h, d, generator=gen, device=dev).to(dtype)
                   for _ in range(4))
    mask = torch.ones(1, n, 1, 1, s, device=dev)
    mask[..., s - pad_keys:] = 0
    mask[:, n - pad_rows:] = 0
    b1 = 1e9 * (mask - 1)
    b2 = torch.randn(1, 1, h, s, s, generator=gen, device=dev) * 0.5
    return q, k, v, do, b1, b2


def rel_frobenius(torch, name, got, want, limit=FLASH_TILE_RTOL):
    """||got - want||_F / ||want||_F over the whole tensor; raises above
    ``limit``."""
    err = float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))
    if not err <= limit:
        raise AssertionError(f"{name}: off by {err} relative (Frobenius; limit {limit})")
    return err


def evo_hold(torch, errs, tiles, kname, tag, got, want, fp32, tile=True):
    """A [B, s, h, d] kernel output against its plain version: elementwise
    (bf16 or fp32 tolerance scaled by the reference's largest element) and,
    with ``tile``, per 64-row tile of each (row, head)."""
    scale = max(1.0, float(want.float().abs().max()))
    atol, rtol = (EVO_FP32_ATOL, EVO_FP32_RTOL) if fp32 else (BF16_ATOL, BF16_RTOL)
    errs[kname][tag] = check_close(torch, f"{kname} {tag}", got, want, atol * scale, rtol)
    if tile:
        tiles[kname][tag] = tile_rel_err(torch, f"{kname} {tag}", got.transpose(1, 2),
                                         want.transpose(1, 2))


def check_evoformer(torch, errs, tiles, name, q, k, v, do, ops, dead_row=None, plan=None):
    """The evoformer kernels against their plain versions on [B, s, h, d]
    inputs and bias operands ``ops``: out and lse, then dq, dk and dv, the dS
    plane (when there is a bias) and, when ``plan`` (``bias_grad_plan``) is
    the reduced form, the bias gradients from dq's partials and the merge
    (against the plain backward's sums; the merge also against its plain
    version on the same partials; two calls the same bits). ``dead_row``: a
    batch row whose logits are all -inf, which must give exactly 0, lse
    -1e30 and zero dq and dS. Returns the kernels' (out, lse)."""
    from deepspeed_tpu_torch.ops.deepspeed4science import evoformer_attn as E

    fp32 = q.dtype == torch.float32
    out, lse = E.evoformer_fwd_cuda(q, k, v, ops)
    ref_out, ref_lse = E.evoformer_fwd_reference(q, k, v, ops)
    evo_hold(torch, errs, tiles, "evoformer_fwd", name, out, ref_out, fp32, tile=False)
    errs["evoformer_fwd"][name + "_lse"] = check_close(
        torch, f"evoformer_fwd lse {name}", lse, ref_lse, FLASH_LSE_ATOL, FP32_RTOL)
    del ref_out, ref_lse
    want_ds = bool(ops)
    reduced = plan is not None and plan.form == "reduced"
    dq, delta, ds, _ = E.evoformer_bwd_dq_cuda(q, k, v, out, do, lse, ops, want_ds=want_ds)
    dk, dv, _ = E.evoformer_bwd_dkv_cuda(q, k, v, do, lse, delta, ops)
    rdq, rdk, rdv, rds, rsums = E.evoformer_bwd_reference(
        q, k, v, out, do, lse, ops, want_ds=want_ds, sums=plan.dims if reduced else ())
    for kname, got, want, tag in (("evoformer_bwd_dq", dq, rdq, name),
                                  ("evoformer_bwd_dkv", dk, rdk, name),
                                  ("evoformer_bwd_dkv", dv, rdv, name + "_dv")):
        evo_hold(torch, errs, tiles, kname, tag, got, want, fp32)
    if want_ds:
        scale = max(1.0, float(rds.abs().max()))
        errs["evoformer_bwd_dq"][name + "_dS"] = check_close(
            torch, f"evoformer_bwd_dq dS {name}", ds, rds, EVO_DS_ATOL * scale, EVO_DS_RTOL)
    elif ds is not None:
        raise AssertionError(f"evoformer_bwd_dq {name}: a dS plane with no bias")
    if reduced:
        dims = [dm for dm in plan.dims if dm is not None]
        runs = []
        for _ in range(2):
            rdq2, delta2, _, rp = E.evoformer_bwd_dq_cuda(q, k, v, out, do, lse, ops,
                                                          rows=plan.rows)
            rdk2, rdv2, cp = E.evoformer_bwd_dkv_cuda(q, k, v, do, lse, delta2, ops,
                                                      cols=plan.cols)
            jobs = [(rp if 2 not in dm else cp, E.merge_flags(dm)) for dm in dims]
            runs.append(((rdq2, rdk2, rdv2), E.evoformer_bias_grad_merge_cuda(jobs), jobs))
        (grads2, sums, jobs), (grads3, sums2, _) = runs
        if not (all(torch.equal(a, b) and torch.equal(a, c)
                    for a, b, c in zip((dq, dk, dv), grads2, grads3))
                and all(torch.equal(a, b) for a, b in zip(sums, sums2))):
            raise AssertionError(f"evoformer {name}: the reduced form's dq, dk, dv or bias "
                                 "gradients differ between calls (or from the plane form's)")
        want_sums = [x for x in rsums if x is not None]
        if dead_row is not None and any(2 in dm and 0 not in dm and bool(g[dead_row].any())
                                        for dm, g in zip(dims, sums)):
            raise AssertionError(f"evoformer {name}: the dead row must add exactly 0")
        for i, (got, want, (src, flags)) in enumerate(zip(sums, want_sums, jobs)):
            scale = max(1.0, float(want.abs().max()))
            errs["evoformer_bwd_dq"][f"{name}_db{i + 1}"] = check_close(
                torch, f"evoformer bias gradient {name} {i + 1}", got, want,
                EVO_DS_ATOL * scale, EVO_DS_RTOL)
            plain = E.evoformer_bias_grad_merge_reference(src, flags)
            scale = max(1.0, float(plain.abs().max()))
            errs["evoformer_bias_grad_merge"][f"{name}_{i + 1}"] = check_close(
                torch, f"evoformer_bias_grad_merge {name} {i + 1}", got, plain,
                EVO_DS_ATOL * scale, EVO_DS_RTOL)
        del runs, sums, sums2, jobs, grads2, grads3
    if dead_row is not None:
        r = dead_row
        if bool(out[r].float().abs().max() != 0) or bool((lse[r] != -1e30).any()):
            raise AssertionError(f"evoformer_fwd {name}: the dead row must give 0, lse -1e30")
        if bool(dq[r].float().abs().max() != 0) or bool(ds[r].abs().max() != 0):
            raise AssertionError(f"evoformer_bwd_dq {name}: the dead row's dq and dS must be 0")
        if not all(bool(torch.isfinite(g.float()).all()) for g in (dq, dk, dv, ds)):
            raise AssertionError(f"evoformer backward {name}: non-finite gradients")
    del rdq, rdk, rdv, rds, rsums, dq, dk, dv, ds
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out, lse


def evoformer_cases(torch, dev):
    """(name, [B, s, h, d] q, k, v, do, bias operands, dead row or None,
    ``bias_grad_plan`` with every bias needing a gradient) of the kernels
    group's small cases, built on demand: d 16, 64 and 128, s 100 and 130
    (neither a multiple of 64), no bias, one bias, a bias2 [2, 1, h, s, s]
    under leading dims [2, n] (materialized: the plane form), a fully masked
    row; bf16 and fp32. Every case with a mask or a pair bias [1, 1, h, s, s]
    takes the reduced form too."""
    from deepspeed_tpu_torch.ops.deepspeed4science import evoformer_attn as E

    specs = [  # name, leading dims, s, h, d, biases, dtype
        ("d16_bf16", (1, 12), 128, 4, 16, "12", torch.bfloat16),
        ("d64_fp32", (1, 6), 192, 4, 64, "12", torch.float32),
        ("s100_bf16", (1, 10), 100, 4, 32, "12", torch.bfloat16),
        ("s100_fp32", (1, 10), 100, 4, 32, "12", torch.float32),
        ("no_bias_bf16", (1, 8), 256, 8, 32, "", torch.bfloat16),
        ("one_bias_fp32", (1, 8), 256, 8, 32, "1", torch.float32),
        ("bias2_materialized_bf16", (2, 6), 160, 4, 32, "12M", torch.bfloat16),
        ("dead_row_bf16", (1, 8), 192, 8, 32, "12D", torch.bfloat16),
        ("d128_fp32", (1, 4), 130, 2, 128, "2", torch.float32),
        ("d128_s100_bf16", (1, 6), 100, 2, 128, "12", torch.bfloat16),
    ]
    for i, (name, lead, s, h, d, which, dtype) in enumerate(specs):
        gen = torch.Generator(device=dev).manual_seed(200 + i)
        B = lead[0] * lead[1]
        q, k, v, do = (torch.randn(B, s, h, d, generator=gen, device=dev).to(dtype)
                       for _ in range(4))
        biases = []
        if "1" in which:
            biases.append(torch.randn(*lead, 1, 1, s, generator=gen, device=dev) * 0.5)
            if "D" in which:
                biases[-1][0, 3] = float("-inf")
        if "2" in which:
            pair = (lead[0] if "M" in which else 1, 1, h, s, s)
            biases.append(torch.randn(*pair, generator=gen, device=dev) * 0.5)
        ops = E._operands(biases, lead, h, s)
        if "M" in which and ops[1].stride(0) == 0:
            raise AssertionError(f"{name}: bias2 should be materialized")
        plan = E.bias_grad_plan([b.shape for b in biases], ops, lead, h, s, [True] * len(biases))
        yield name, q, k, v, do, ops, 3 if "D" in which else None, plan


def evoformer_work(B, s, h, d, el, bias_bytes, grad_bytes, col_bytes=0, merged_bytes=0):
    """(FLOPs, bytes) per kernel for these inputs: 4d / 6d / 8d FLOPs per
    pair (every pair is computed: no mask prunes a tile); q, k, v, o, do,
    dq, dk, dv [B, s, h, d] at ``el`` bytes, lse and delta fp32 [B, h, s],
    the biases at the bytes they occupy; ``grad_bytes`` what dq writes of
    the bias gradient (the fp32 dS plane [B, h, s, s], or the reduced form's
    row partials), ``col_bytes`` what dk/dv writes of it (the reduced form's
    column partials); the merge reads both once (an add per element) to
    write ``merged_bytes`` of bias gradients. dk/dv reads dq's delta, not
    o."""
    pairs = B * h * s * s
    t = B * s * h * d * el
    lseb = B * h * s * 4
    flops = {"evoformer_fwd": 4 * pairs * d, "evoformer_bwd_dq": 6 * pairs * d,
             "evoformer_bwd_dkv": 8 * pairs * d,
             "evoformer_bias_grad_merge": (grad_bytes + col_bytes) // 4}
    moved = {"evoformer_fwd": 3 * t + bias_bytes + t + lseb,
             "evoformer_bwd_dq": 5 * t + lseb + bias_bytes + t + lseb + grad_bytes,
             "evoformer_bwd_dkv": 4 * t + 2 * lseb + bias_bytes + 2 * t + col_bytes,
             "evoformer_bias_grad_merge": grad_bytes + col_bytes + merged_bytes}
    return flops, moved


def sdpa_evoformer_ms(torch, q, k, v, do, b1, b2):
    """Yardsticks: ``scaled_dot_product_attention`` on [B, h, s, d] views
    with the float mask b1 + b2 ([B, h, s, s] in q's dtype) under the
    memory-efficient backend: the forward in a CUDA graph, the backward
    (dq, dk, dv and the mask's gradient in one autograd call) eagerly. If
    the backend refuses a mask that needs a gradient, the backward is timed
    with one that needs none, and the record says so."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    f = torch.nn.functional.scaled_dot_product_attention
    B, s, h, d = q.shape
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = (b1 + b2).to(q.dtype).expand(B, h, s, s).contiguous()

    def fwd():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return f(qt, kt, vt, attn_mask=mask)

    fwd_ms = time_ms(torch, fwd, iters=5)
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (qt, kt, vt))
    ml = mask.clone().requires_grad_(True)
    what = "mask gradient included"
    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            out = f(ql, kl, vl, attn_mask=ml)
        inputs = (ql, kl, vl, ml)
        torch.autograd.grad(out, inputs, do.transpose(1, 2), retain_graph=True)
    except RuntimeError as e:
        what = f"mask gradient refused ({str(e)[:120]}); backward without it"
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            out = f(ql, kl, vl, attn_mask=mask)
        inputs = (ql, kl, vl)
    bwd_ms = eager_ms(torch, lambda: torch.autograd.grad(out, inputs, do.transpose(1, 2),
                                                         retain_graph=True), iters=5)
    del out, ql, kl, vl, ml, mask
    torch.cuda.empty_cache()
    return {"evoformer_fwd": fwd_ms, "evoformer_bwd_dq": bwd_ms, "evoformer_bwd_dkv": bwd_ms,
            "what": what}


def evoformer_bound(flops, moved, peak):
    t_ops, t_bytes = flops / peak, moved / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def evoformer_timings(torch, dev, errs, tiles, shape=EVOFORMER_SHAPES["msa_row"], seed=300):
    """At the phase's msa_row shape, in bf16 and in fp32: the kernels held
    against their plain versions on the inputs they are timed on, then
    CUDA-graph times of the kernels in the form the op call runs (dq writing
    the reduced form's partials, the merge folding them) and of their plain
    versions, beside each kernel its bound for these inputs; dq in the plane
    form beside it with its own bound; SDPA with the summed mask as the
    library yardstick of the others (bf16), a torch sum of the partials as
    the merge's."""
    from deepspeed_tpu_torch.ops.deepspeed4science import evoformer_attn as E

    n, s, h, d = shape["n"], shape["s"], shape["h"], shape["d"]
    rec = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        q, k, v, do, b1, b2 = evo_inputs(torch, dev, n, s, h, d, dtype, seed)
        q, k, v, do = (t.reshape(n, s, h, d) for t in (q, k, v, do))
        ops = E._operands([b1, b2], (1, n), h, s)
        if any(o.stride(0) != 0 and o.stride(1) != 0 for o in ops):
            raise AssertionError("evoformer: a bias operand was materialized at msa_row")
        plan = E.bias_grad_plan([b1.shape, b2.shape], ops, (1, n), h, s, (True, True))
        if plan.form != "reduced":
            raise AssertionError(f"evoformer: msa_row's bias gradients take the {plan.form} form")
        out, lse = check_evoformer(torch, errs, tiles, f"msa_row_{tag}", q, k, v, do, ops,
                                   plan=plan)
        args = (q, k, v, out, do, lse, ops)

        def dq_reduced():
            return E.evoformer_bwd_dq_cuda(*args, rows=plan.rows)

        def dkv_reduced():
            return E.evoformer_bwd_dkv_cuda(q, k, v, do, lse, delta, ops, cols=plan.cols)

        _, delta, _, rp = dq_reduced()
        cp = dkv_reduced()[2]
        jobs = [(rp if 2 not in dm else cp, E.merge_flags(dm)) for dm in plan.dims]

        def torch_merge():
            return [E.evoformer_bias_grad_merge_reference(src, flags) for src, flags in jobs]

        ms = {"evoformer_fwd": time_ms(torch, lambda: E.evoformer_fwd_cuda(q, k, v, ops),
                                       iters=10),
              "evoformer_bwd_dq": time_ms(torch, dq_reduced, iters=10),
              "evoformer_bwd_dkv": time_ms(torch, dkv_reduced, iters=10),
              "evoformer_bias_grad_merge": time_ms(
                  torch, lambda: E.evoformer_bias_grad_merge_cuda(jobs), iters=10)}
        plane_ms = time_ms(torch, lambda: E.evoformer_bwd_dq_cuda(*args, want_ds=True), iters=3)
        plain = {"evoformer_fwd": time_ms(
            torch, lambda: E.evoformer_fwd_reference(q, k, v, ops), iters=2, warmup=1)}
        # the plain backward computes dq, dk, dv and the reduced gradients
        # together: its time stands for both backward kernels
        plain["evoformer_bwd_dq"] = plain["evoformer_bwd_dkv"] = time_ms(
            torch, lambda: E.evoformer_bwd_reference(*args, want_ds=False, sums=plan.dims),
            iters=2, warmup=1)
        plain["evoformer_bias_grad_merge"] = time_ms(torch, torch_merge, iters=10)
        torch.cuda.empty_cache()
        lib = sdpa_evoformer_ms(torch, q, k, v, do, b1[0], b2[0]) if tag == "bf16" else None
        if lib is not None:  # the merge's library call: a torch sum of each partial
            lib["evoformer_bias_grad_merge"] = time_ms(torch, torch_merge, iters=10)
        bias_bytes = (b1.numel() + b2.numel()) * 4
        flops, moved = evoformer_work(n, s, h, d, q.element_size(), bias_bytes, rp.numel() * 4,
                                      col_bytes=cp.numel() * 4, merged_bytes=bias_bytes)
        pflops, pmoved = evoformer_work(n, s, h, d, q.element_size(), bias_bytes,
                                        n * h * s * s * 4)
        peak = BF16_FLOPS if tag == "bf16" else FP32_FLOPS
        for kname in EVOFORMER_KERNELS:
            kpeak = FP32_FLOPS if kname == "evoformer_bias_grad_merge" else peak
            bound_ms, bound_by = evoformer_bound(flops[kname], moved[kname], kpeak)
            r = rec.setdefault(kname, {})
            r[tag] = {"ms": ms[kname], "plain_ms": plain[kname], "bound_ms": bound_ms,
                      "bound_by": bound_by, "flops": flops[kname], "bytes": moved[kname],
                      "tflops_per_s": flops[kname] / (ms[kname] * 1e-3) / 1e12,
                      "gb_per_s": moved[kname] / (ms[kname] * 1e-3) / 1e9}
            if lib is not None:
                r[tag].update(library_ms=lib[kname],
                              library=("torch sum of each partial (the plain version's call)"
                                       if kname == "evoformer_bias_grad_merge" else lib["what"]))
        bound_ms, bound_by = evoformer_bound(pflops["evoformer_bwd_dq"],
                                             pmoved["evoformer_bwd_dq"], peak)
        rec["evoformer_bwd_dq"][tag]["plane_form"] = {
            "ms": plane_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": pmoved["evoformer_bwd_dq"]}
        rec["evoformer_bwd_dq"][tag]["partial_bytes"] = rp.numel() * 4
        rec["evoformer_bwd_dkv"][tag]["partial_bytes"] = cp.numel() * 4
        del q, k, v, do, b1, b2, ops, out, lse, args, delta, rp, cp, jobs
        torch.cuda.empty_cache()
    return rec


def kernel_evoformer(torch, dev):
    """The evoformer kernels against their plain versions at the small
    cases of ``evoformer_cases`` (both bias-gradient forms where the plan is
    reduced), then checked and timed at msa_row in bf16 and fp32
    (``evoformer_timings``). Returns one record per kernel; its ms, plain,
    bound and library numbers are bf16's, fp32's beside them."""
    errs = {n: {} for n in EVOFORMER_KERNELS}
    tiles = {n: {} for n in EVOFORMER_KERNELS}
    names = []
    for name, q, k, v, do, ops, dead, plan in evoformer_cases(torch, dev):
        check_evoformer(torch, errs, tiles, name, q, k, v, do, ops, dead_row=dead, plan=plan)
        names.append(name)
        del q, k, v, do, ops
    timed = evoformer_timings(torch, dev, errs, tiles)
    sh = EVOFORMER_SHAPES["msa_row"]
    records = {}
    for kname in EVOFORMER_KERNELS:
        bf, fp = timed[kname]["bf16"], timed[kname]["fp32"]
        records[kname] = {
            "name": kname,
            "shape": {"lead": [1, sh["n"]], "s": sh["s"], "h": sh["h"], "d": sh["d"],
                      "dtype": "bfloat16", "biases": ["mask [1, n, 1, 1, s]",
                                                      "pair [1, 1, h, s, s]"]},
            "max_abs_err": max(errs[kname].values()),
            "max_abs_err_by_case": errs[kname],
            "tolerance": {"bf16": [BF16_ATOL, BF16_RTOL], "fp32": [EVO_FP32_ATOL, EVO_FP32_RTOL],
                          "scaled_by": "max(1, max|ref|)", "lse": [FLASH_LSE_ATOL, FP32_RTOL],
                          "dS": [EVO_DS_ATOL, EVO_DS_RTOL],
                          "bias_gradients_and_merge": [EVO_DS_ATOL, EVO_DS_RTOL],
                          "tile_rel_frobenius": FLASH_TILE_RTOL
                          if kname in ("evoformer_bwd_dq", "evoformer_bwd_dkv") else None},
            "tile_rel_frobenius_by_case": tiles[kname] or None,
            "held_against": {"plain": names + ["msa_row_bf16", "msa_row_fp32"]},
            **{key: bf[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "flops",
                                        "bytes", "tflops_per_s", "gb_per_s", "library_ms",
                                        "library")},
            **({"plane_form": bf["plane_form"]} if kname == "evoformer_bwd_dq" else {}),
            **({"partial_bytes": bf["partial_bytes"]}
               if kname in ("evoformer_bwd_dq", "evoformer_bwd_dkv") else {}),
            "fp32": fp,
        }
    return records


def evoformer_phase(torch, dev, K, shapes=None, dtype=None, seed=SEED):
    """The op-registry entry point at AlphaFold2's widths: ``get_accelerator()
    .create_op_builder("evoformer_attn").load()`` hands out
    ``DS4Sci_EvoformerAttention``, which runs forward and backward on the
    msa_row and triangle shapes (``EVOFORMER_SHAPES``) in bf16 with
    AlphaFold's mask and a random pair bias, both needing gradients.
    Launches are counted exactly (one of each evoformer kernel per call, the
    bias-gradient merge included, nothing else); out, dQ, dK, dV are held
    against the plain versions (elementwise and per 64-row tile), db1 and
    db2 as relative Frobenius over the whole tensor and bit for bit against
    a second call. On a card each call also records its peak memory above
    its inputs, which must stay below the [B, h, s, s] fp32 plane's size
    (the reduced form allocates none), and the merge's device time on the
    call's partials. Then a call whose biases need no gradient, which must
    ask for neither the dS plane nor its partials. ``shapes``/``dtype``
    shrink it for a CPU rehearsal, where nothing launches."""
    from deepspeed_tpu_torch import get_accelerator
    from deepspeed_tpu_torch.ops.deepspeed4science import evoformer_attn as E

    shapes = shapes or EVOFORMER_SHAPES
    dtype = dtype or torch.bfloat16
    t_phase = time.perf_counter()
    accel = get_accelerator()
    evo = accel.create_op_builder("evoformer_attn").load(verbose=False)
    on_card = dev.type == "cuda"
    rec = {"phase": "evoformer", "accelerator": accel._name,
           "entry": "get_accelerator().create_op_builder('evoformer_attn').load()",
           "dtype": str(dtype), "calls": {}}
    total = {name: 0 for name in K.KERNELS}
    for i, (cname, sh) in enumerate(shapes.items()):
        n, s, h, d = sh["n"], sh["s"], sh["h"], sh["d"]
        pad_rows, pad_keys = min(EVO_PAD_ROWS, n // 4), min(EVO_PAD_KEYS, s // 8)
        q, k, v, do, b1, b2 = evo_inputs(torch, dev, n, s, h, d, dtype, seed + i,
                                         pad_keys=pad_keys, pad_rows=pad_rows)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, b1, b2)]
        c = {"shape": {"q": list(q.shape), "bias1": list(b1.shape), "bias2": list(b2.shape)},
             "padded": {"rows": pad_rows, "keys": pad_keys}}
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        _sync(torch, dev)
        K.reset_counts()
        t0 = time.perf_counter()
        out = evo(*leaves[:3], leaves[3:])
        out.backward(do)
        _sync(torch, dev)
        c["first_call_s"] = time.perf_counter() - t0
        launches = K.counts()
        want = {name: int(on_card and name in EVOFORMER_KERNELS) for name in K.KERNELS}
        if launches != want:
            raise AssertionError(f"evoformer {cname}: launches {launches}, expected {want}")
        for name, cnt in launches.items():
            total[name] += cnt
        if on_card:
            plane_gb = n * h * s * s * 4 / 1e9
            c["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            c["peak_over_inputs_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
            c["plane_gb"] = plane_gb
            if not c["peak_over_inputs_gb"] < plane_gb:
                raise AssertionError(f"evoformer {cname}: {c['peak_over_inputs_gb']} GB above the "
                                     f"inputs, not below the {plane_gb} GB dS plane")
        grads = [t.grad.clone() for t in leaves]

        # against the plain versions
        q4, k4, v4, do4 = (t.reshape(n, s, h, d) for t in (q, k, v, do))
        ops = E._operands([b1, b2], (1, n), h, s)
        plan = E.bias_grad_plan([b1.shape, b2.shape], ops, (1, n), h, s, (True, True))
        c["bias_grad_form"] = plan.form
        ref_out, ref_lse = E.evoformer_fwd_reference(q4, k4, v4, ops)
        rdq, rdk, rdv, _, rsums = E.evoformer_bwd_reference(
            q4, k4, v4, ref_out, do4, ref_lse, ops, want_ds=False, sums=plan.dims)
        errs, tiles = {}, {}
        for tag, got, want_t in (("out", out.detach(), ref_out), ("dq", leaves[0].grad, rdq),
                                 ("dk", leaves[1].grad, rdk), ("dv", leaves[2].grad, rdv)):
            got = got.reshape(n, s, h, d)
            scale = max(1.0, float(want_t.float().abs().max()))
            errs[tag] = check_close(torch, f"evoformer {cname} {tag}", got, want_t,
                                    BF16_ATOL * scale, BF16_RTOL)
            tiles[tag] = tile_rel_err(torch, f"evoformer {cname} {tag}", got.transpose(1, 2),
                                      want_t.transpose(1, 2))
        del ref_out, ref_lse, out, rdq, rdk, rdv
        for tag, leaf, want_t in (("db1", leaves[3], rsums[0]), ("db2", leaves[4], rsums[1])):
            want_t = want_t.reshape(leaf.shape)
            tiles[tag] = rel_frobenius(torch, f"evoformer {cname} {tag}", leaf.grad, want_t)
            errs[tag] = float((leaf.grad - want_t).abs().max())
        del rsums
        c["max_abs_err"], c["rel_frobenius"] = errs, tiles

        # seconds of a call (eager: host work included), the mean of three;
        # every call's gradients the first's bits
        t0 = time.perf_counter()
        for _ in range(3):
            for t in leaves:
                t.grad = None
            evo(*leaves[:3], leaves[3:]).backward(do)
        _sync(torch, dev)
        c["call_s"] = (time.perf_counter() - t0) / 3
        same = [bool(torch.equal(t.grad, g)) for t, g in zip(leaves, grads)]
        if not all(same):
            raise AssertionError(f"evoformer {cname}: gradients of dq, dk, dv, db1, db2 repeat "
                                 f"bit for bit: {same}")
        c["grads_repeat_bit_for_bit"] = True
        if on_card:  # the merge's device time on this call's partials
            out, lse = E.evoformer_fwd_cuda(q4, k4, v4, ops)
            _, delta, _, rp = E.evoformer_bwd_dq_cuda(q4, k4, v4, out, do4, lse, ops,
                                                      rows=plan.rows)
            cp = E.evoformer_bwd_dkv_cuda(q4, k4, v4, do4, lse, delta, ops, cols=plan.cols)[2]
            jobs = [(rp if 2 not in dm else cp, E.merge_flags(dm)) for dm in plan.dims]
            c["merge_ms"] = time_ms(torch, lambda: E.evoformer_bias_grad_merge_cuda(jobs),
                                    iters=10)
            del out, lse, delta, rp, cp, jobs
        rec["calls"][cname] = c
        del leaves, grads
        if on_card:
            torch.cuda.empty_cache()

    # biases that need no gradient: dq is asked for neither the plane nor
    # its partials, and no merge launches
    first = next(iter(shapes))
    sh = shapes[first]
    q, k, v, do, b1, b2 = evo_inputs(torch, dev, sh["n"], sh["s"], sh["h"], sh["d"], dtype,
                                     seed, pad_keys=min(EVO_PAD_KEYS, sh["s"] // 8),
                                     pad_rows=min(EVO_PAD_ROWS, sh["n"] // 4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    asked = []
    if on_card:
        real = E.evoformer_bwd_dq_cuda

        def spy(*a, want_ds=False, rows=False, **kw):
            asked.append(bool(want_ds or rows))
            return real(*a, want_ds=want_ds, rows=rows, **kw)
    else:
        real = E.evoformer_bwd_reference

        def spy(*a, want_ds=True, sums=(), **kw):
            asked.append(bool(want_ds or sums))
            return real(*a, want_ds=want_ds, sums=sums, **kw)

    setattr(E, real.__name__, spy)
    try:
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        K.reset_counts()
        evo(*leaves, [b1, b2]).backward(do)
        _sync(torch, dev)
    finally:
        setattr(E, real.__name__, real)
    if asked != [False]:
        raise AssertionError(f"evoformer: biases with no gradient asked for a bias gradient: "
                             f"{asked}")
    launches = K.counts()
    if launches.get("evoformer_bias_grad_merge"):
        raise AssertionError("evoformer: biases with no gradient launched the merge")
    for name, cnt in launches.items():
        total[name] += cnt
    rec["no_bias_grad_call"] = {"shape": first, "dS_asked": False,
                                "launches": {n_: c_ for n_, c_ in launches.items() if c_},
                                "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                                                if on_card else None)}
    del q, k, v, do, b1, b2, leaves
    rec["launches"] = {n_: c_ for n_, c_ in total.items() if c_}
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec, total


# ---------------------------------------------------------------------------
# phase 12: a HuggingFace checkpoint directory into both engines
# ---------------------------------------------------------------------------
# mistralai/Mistral-7B-v0.1 config.json, as published, but num_hidden_layers
# (32 there) cut to 4 (``HF_REDUCED``); the weights are random
HF_CONFIG = {
    "architectures": ["MistralForCausalLM"], "model_type": "mistral", "hidden_act": "silu",
    "hidden_size": 4096, "intermediate_size": 14336, "num_attention_heads": 32,
    "num_key_value_heads": 8, "num_hidden_layers": 4, "vocab_size": 32000,
    "max_position_embeddings": 32768, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "sliding_window": 4096, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "bos_token_id": 1, "eos_token_id": 2, "initializer_range": 0.02,
}
HF_REDUCED = {"num_hidden_layers": [32, 4]}
HF_SHARDS = 2
# the serving engine for hf_import: 4 prompts of 64-511 tokens, 128-token
# blocks, contexts of up to 640 (prefill, 2 decode steps, a 64-step round)
HF_ENGINE_CONFIG = {
    "dtype": "bfloat16", "decode_steps": 64, "prompt_chunk": 256, "max_prompt_chunks": 4,
    "kv_cache": {"block_size": 128, "num_blocks": 32, "max_blocks_per_seq": 5},
    "state_manager": {"max_tracked_sequences": 8, "max_ragged_batch_size": 1024,
                      "max_ragged_sequence_count": 4, "max_context": 640},
}
HF_PROMPTS = 4
# train_import: a 2-layer cut of the same directory, a client torch AdamW,
# grads accumulated in bf16
IMPORT_TRAIN_LAYERS = 2
IMPORT_TRAIN_SEQ = 1024
IMPORT_TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": 2,
    "bf16": {"enabled": True}, "data_types": {"grad_accum_dtype": "bf16"},
    "gradient_clipping": 1.0, "steps_per_print": 1000,
}


def hf_layout_weights(torch, hf_cfg, dev, seed=SEED):
    """Seeded random bf16 weights of a Mistral-layout HF checkpoint, in HF
    names and the ``[out, in]`` layout of its Linears: normal / sqrt(fan
    in) for projections, 0.02 for the embeddings, norms near 1."""
    h, f, V = hf_cfg["hidden_size"], hf_cfg["intermediate_size"], hf_cfg["vocab_size"]
    d = h // hf_cfg["num_attention_heads"]
    kv = hf_cfg["num_key_value_heads"] * d
    shapes = {"model.embed_tokens.weight": ((V, h), 0.02), "model.norm.weight": ((h,), None),
              "lm_head.weight": ((V, h), h ** -0.5)}
    for i in range(hf_cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        shapes.update({
            f"{p}.input_layernorm.weight": ((h,), None),
            f"{p}.post_attention_layernorm.weight": ((h,), None),
            f"{p}.self_attn.q_proj.weight": ((h, h), h ** -0.5),
            f"{p}.self_attn.k_proj.weight": ((kv, h), h ** -0.5),
            f"{p}.self_attn.v_proj.weight": ((kv, h), h ** -0.5),
            f"{p}.self_attn.o_proj.weight": ((h, h), h ** -0.5),
            f"{p}.mlp.gate_proj.weight": ((f, h), h ** -0.5),
            f"{p}.mlp.up_proj.weight": ((f, h), h ** -0.5),
            f"{p}.mlp.down_proj.weight": ((h, f), f ** -0.5),
        })
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name in sorted(shapes):
        shape, std = shapes[name]
        x = torch.randn(shape, generator=gen, device=dev)
        out[name] = (1.0 + 0.1 * x if std is None else x * std).to(torch.bfloat16)
    return out


def expected_hf_params(torch, hf, n_layers):
    """The port's layout of a Mistral-layout state dict: the leaves that
    ``load_hf_model`` must give, bit for bit (projections transposed to
    ``[in, out]``, layers stacked)."""
    per_layer = {"attn_norm": ("input_layernorm", False),
                 "mlp_norm": ("post_attention_layernorm", False),
                 "wq": ("self_attn.q_proj", True), "wk": ("self_attn.k_proj", True),
                 "wv": ("self_attn.v_proj", True), "wo": ("self_attn.o_proj", True),
                 "w_gate": ("mlp.gate_proj", True), "w_up": ("mlp.up_proj", True),
                 "w_down": ("mlp.down_proj", True)}
    layers = {}
    for key, (name, linear) in per_layer.items():
        ws = [hf[f"model.layers.{i}.{name}.weight"] for i in range(n_layers)]
        layers[key] = torch.stack([w.t() if linear else w for w in ws])
    return {"embed": hf["model.embed_tokens.weight"], "final_norm": hf["model.norm.weight"],
            "lm_head": hf["lm_head.weight"].t(), "layers": layers}


def bits_mismatches(torch, got, want):
    """Leaves whose shape, dtype or bits differ (and leaves missing on
    either side)."""
    got, want = leaves(got), leaves(want)
    bad = sorted(set(got) ^ set(want))
    for k in set(got) & set(want):
        a, b = got[k], want[k].to(got[k].device)
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(
                a.contiguous().view(torch.int16), b.contiguous().view(torch.int16)):
            bad.append(k)
    return sorted(bad)


def write_hf_checkpoint(torch, path, hf_cfg, tensors, shards=HF_SHARDS):
    """The port's writer: ``config.json`` and ``shards`` safetensors files
    with their index. Returns (seconds, bytes)."""
    from deepspeed_tpu_torch.models import safetensors_io

    t0 = time.perf_counter()
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(hf_cfg, indent=1))
    files = safetensors_io.save_sharded(tensors, str(path), shards=shards,
                                        metadata={"format": "pt"})
    return time.perf_counter() - t0, sum(Path(f).stat().st_size for f in files)


def hf_import_phase(torch, dev, K, work, hf_config=None, engine_config=None,
                    n_prompts=HF_PROMPTS, prompt_lens=(64, 512)):
    """A HF checkpoint directory through ``build_hf_engine``: written by the
    port's safetensors writer (sharded, with an index), loaded on ``dev``
    with every leaf checked bit for bit, then prefill and a greedy decode
    through the engine's ``step()`` and ``decode_round``, logits against
    ``forward_reference`` on the loaded params, launches counted. Returns
    (record, launches); the checkpoint stays in ``work / "hf"``."""
    import numpy as np

    from deepspeed_tpu_torch.inference.v2.engine_factory import build_hf_engine
    from deepspeed_tpu_torch.models import transformer as T

    hf_cfg = dict(hf_config or HF_CONFIG)
    L = hf_cfg["num_hidden_layers"]
    rec = {"phase": "hf_import", "model": "mistralai/Mistral-7B-v0.1", "n_layers": L,
           "reduced": HF_REDUCED if hf_config is None else "rehearsal widths"}
    t0 = time.perf_counter()
    hf = hf_layout_weights(torch, hf_cfg, dev)
    rec["params"] = sum(t.numel() for t in hf.values())
    _sync(torch, dev)
    rec["generate_seconds"] = time.perf_counter() - t0
    path = Path(work) / "hf"
    rec["write_seconds"], rec["checkpoint_bytes"] = write_hf_checkpoint(torch, path, hf_cfg, hf)
    rec["shards"] = len(list(path.glob("*.safetensors")))
    if rec["shards"] < 2 or not (path / "model.safetensors.index.json").is_file():
        raise AssertionError("hf_import: the checkpoint is not sharded with an index")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_hf_engine(str(path), dict(engine_config or HF_ENGINE_CONFIG), device=dev.type)
    _sync(torch, dev)
    rec["load_seconds"] = time.perf_counter() - t0
    rec["load_gb_s"] = rec["checkpoint_bytes"] / 1e9 / rec["load_seconds"]
    rec["peak_mem_gb_load"] = (torch.cuda.max_memory_allocated() / 1e9
                               if dev.type == "cuda" else None)
    cfg = eng._mc
    if dev.type == "cuda" and eng.paged_attention_impl != "kernel":
        raise AssertionError(f"paged_attention_impl resolved to {eng.paged_attention_impl}")
    bad = bits_mismatches(torch, eng.params, expected_hf_params(torch, hf, L))
    rec["leaves_checked"] = len(leaves(eng.params))
    if bad:
        raise AssertionError(f"hf_import: leaves differ from the written checkpoint: {bad}")
    del hf

    rng = np.random.default_rng(SEED)
    lens = rng.integers(*prompt_lens, size=n_prompts)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32) for n in lens]
    K.reset_counts()
    run = serve_counted_path(torch, dev, eng, prompts)
    launches = K.counts()
    fwd_steps = run["split_steps"] + 64
    expected = {name: 0 for name in launches}
    expected.update(rms_norm_fwd=(2 * L + 1) * fwd_steps, paged_decode=L * fwd_steps)
    rec.update(launches=launches, launches_expected=expected,
               forward_steps={"split": run["split_steps"], "round": 64},
               prefill_seconds=run["prefill_seconds"], round_seconds=run["round_seconds"],
               round_tok_s=n_prompts * 64 / run["round_seconds"])
    if dev.type == "cuda" and launches != expected:
        raise AssertionError(f"hf_import kernel launches {launches}, expected {expected}")
    errs, shifted = [], []
    for row, uid in enumerate(run["rounds"]):
        mine, toks_in = logit_rows(torch, run, uid, row)
        got_tok = torch.as_tensor(np.asarray(run["rounds"][uid], np.int64), device=dev)
        if not bool((mine[3:].argmax(dim=-1) == got_tok).all()):
            raise AssertionError(f"hf_import uid {uid}: round tokens are not the argmax")
        n_p = len(prompts[uid])
        with torch.no_grad():
            ref = T.forward_reference(eng.params, torch.as_tensor(
                np.asarray(toks_in[:n_p], np.int64), device=dev)[None], cfg)[0][0].float()
        if not bool(torch.isfinite(ref).all()):
            raise AssertionError("hf_import: plain forward gave non-finite logits")
        errs.append(rows_rel_err(torch, mine[0], ref[n_p - 1]))
        shifted.append(rows_rel_err(torch, mine[0], ref[n_p - 2]))
    rec["prefill_logit_rel_err"] = max(errs)
    rec["shifted_logit_rel_err"] = min(shifted)
    rec["logit_rtol"] = LOGIT_RTOL
    if rec["prefill_logit_rel_err"] > LOGIT_RTOL:
        raise AssertionError(f"hf_import: prefill logits off the plain forward: {errs}")
    if rec["shifted_logit_rel_err"] <= LOGIT_RTOL:
        raise AssertionError("hf_import: negative control passed: positions not told apart")
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
    return rec, launches


def train_import_phase(torch, dev, K, work, layers=IMPORT_TRAIN_LAYERS, seq=IMPORT_TRAIN_SEQ,
                       steps=2, lr=1e-4):
    """A cut of ``work / "hf"`` to ``layers`` layers (its own config.json,
    the same shards) through ``load_hf_model`` into ``initialize`` with a
    client ``torch.optim.AdamW`` (``lr``: a tiny rehearsal's bf16 weights
    need a larger one to move) and bf16 gradient accumulation: ``steps``
    ``train_batch`` steps on one batch (flash and RMSNorm launches counted
    exactly, the loss must fall), a save with ``checkpoint.writer`` unset,
    a load into a fresh engine (params, masters and the client's state bit
    for bit), and ``zero_to_fp32`` on that archive against the masters.
    Returns (record, launches)."""
    import dataclasses

    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import (
        get_fp32_state_dict_from_zero_checkpoint,
    )
    from deepspeed_tpu_torch.models import load_hf_model
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
        tree_leaves,
        tree_paths,
    )

    src, cut = Path(work) / "hf", Path(work) / "hf_cut"
    cut.mkdir()
    hf_cfg = json.loads((src / "config.json").read_text())
    hf_cfg["num_hidden_layers"] = layers
    (cut / "config.json").write_text(json.dumps(hf_cfg))
    for f in src.iterdir():
        if f.name != "config.json":
            (cut / f.name).symlink_to(f)
    rec = {"phase": "train_import", "model": "mistralai/Mistral-7B-v0.1", "n_layers": layers,
           "seq": seq, "optimizer": "torch.optim.AdamW", "grad_accum_dtype": "bf16"}
    t0 = time.perf_counter()
    cfg, params = load_hf_model(str(cut), dtype="bfloat16", device=dev)
    cfg = dataclasses.replace(cfg, remat=False)
    rec["load_seconds"] = time.perf_counter() - t0
    rec["params"] = sum(t.numel() for t in leaves(params).values())

    def engine():
        opt = torch.optim.AdamW(list(leaves(params).values()), lr=lr, weight_decay=0.01)
        return deepspeed_tpu_torch.initialize(model=T.make_loss_fn(cfg), model_parameters=params,
                                              optimizer=opt, config=dict(IMPORT_TRAIN_CONFIG))[0]

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    eng = engine()
    gas = IMPORT_TRAIN_CONFIG["gradient_accumulation_steps"]
    rows = gas * IMPORT_TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    rng = np.random.default_rng(SEED + 2)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, size=(rows, seq + 1))
             .astype(np.int32)}
    K.reset_counts()
    losses, step_s = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        losses.append(float(eng.train_batch(batch=batch)))
        _sync(torch, dev)
        step_s.append(time.perf_counter() - t1)
    launches = K.counts()
    per_step = {"flash_fwd": gas * layers, "flash_bwd_dq": gas * layers,
                "flash_bwd_dkv": gas * layers, "rms_norm_fwd": gas * (2 * layers + 1),
                "rms_norm_bwd": gas * (2 * layers + 1)}
    expected = {name: 0 for name in launches}
    expected.update({k: v * steps for k, v in per_step.items()})
    rec.update(losses=losses, step_seconds=step_s, launches=launches,
               launches_expected=expected)
    if dev.type == "cuda" and launches != expected:
        raise AssertionError(f"train_import kernel launches {launches}, expected {expected}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train_import: losses {losses} (finite and falling expected)")
    if eng.grad_accum_dtype != torch.bfloat16:
        raise AssertionError("train_import: gradients did not accumulate in bf16")

    ckpt = Path(work) / "ckpt"
    t0 = time.perf_counter()
    eng.save_checkpoint(str(ckpt))
    rec["save_seconds"] = time.perf_counter() - t0
    rec["checkpoint_bytes"] = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    if eng.config.checkpoint.writer is not None or not (ckpt / "zero_to_fp32.py").is_file():
        raise AssertionError("train_import: not the default store, or no recovery script")
    fresh = engine()
    t0 = time.perf_counter()
    fresh.load_checkpoint(str(ckpt))
    _sync(torch, dev)
    rec["restore_seconds"] = time.perf_counter() - t0
    bad = bits_mismatches(torch, fresh.params, eng.params)
    bad += [f"master/{k}" for k in bits_mismatches(torch, fresh.opt_state.master,
                                                   eng.opt_state.master)]
    want, got = (e.optimizer.optimizer.state_dict()["state"] for e in (eng, fresh))
    bad += [f"state/{i}/{k}" for i in want for k in want[i]
            if want[i][k].device != got[i][k].device or not torch.equal(want[i][k], got[i][k])]
    if bad or sorted(want) != sorted(got) or fresh.global_steps != eng.global_steps:
        raise AssertionError(f"train_import: the reloaded engine differs: {bad[:8]}")
    del fresh
    t0 = time.perf_counter()
    fp32 = get_fp32_state_dict_from_zero_checkpoint(str(ckpt))
    rec["zero_to_fp32_seconds"] = time.perf_counter() - t0
    masters = dict(zip(tree_paths(eng.opt_state.master), tree_leaves(eng.opt_state.master)))
    off = [n for n, m in masters.items()
           if n not in fp32 or not np.array_equal(fp32[n], m.detach().cpu().numpy())]
    if off or sorted(fp32) != sorted(masters):
        raise AssertionError(f"train_import: zero_to_fp32 differs from the masters: {off[:8]}")
    rec["zero_to_fp32_tensors"] = len(fp32)
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
    return rec, launches


def graft_entry_phase(torch, dev, K):
    """``graft_entry.entry()`` on ``dev``: one forward through the kernels,
    its logits against ``forward_reference`` on the same params."""
    from deepspeed_tpu_torch.graft_entry import entry
    from deepspeed_tpu_torch.models import transformer as T

    fn, (params, tokens) = entry(device=dev.type)
    K.reset_counts()
    with torch.no_grad():
        logits = fn(params, tokens)
        _sync(torch, dev)
        launches = K.counts()
        ref = T.forward_reference(params, tokens, fn.config)[0]
    c = fn.config
    rec = {"phase": "graft_entry", "model": "tiny", "n_layers": c.n_layers,
           "heads": [c.n_heads, c.head_dim], "shape": list(logits.shape), "launches": launches}
    if tuple(logits.shape) != (2, 128, c.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"graft_entry: logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    rec["logit_rel_err"] = rows_rel_err(torch, logits[0], ref[0])
    rec["logit_rtol"] = LOGIT_RTOL
    if rec["logit_rel_err"] > LOGIT_RTOL:
        raise AssertionError(f"graft_entry: logits off the plain forward: {rec['logit_rel_err']}")
    expected = {name: 0 for name in launches}
    expected.update(rms_norm_fwd=2 * c.n_layers + 1, flash_fwd=c.n_layers)
    rec["launches_expected"] = expected
    if dev.type == "cuda" and launches != expected:
        raise AssertionError(f"graft_entry kernel launches {launches}, expected {expected}")
    return rec, launches


def import_phases(torch, dev, K, root, card, hf_kw=None, train_kw=None):
    """hf_import, serve_cli (``dstpu serve`` on hf_import's directory, in a
    subprocess), train_import and graft_entry, each emitted with its
    seconds; the checkpoints they write are removed. ``hf_kw`` / ``train_kw``
    shrink hf_import and train_import for a rehearsal on the CPU. Returns
    the launches of each phase of this process."""
    import shutil
    import tempfile

    # under the checkout's build/, which git ignores
    (Path(root) / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=Path(root) / "build"))
    launches = {}
    try:
        free = shutil.disk_usage(work).free
        for name, run in (("hf_import", lambda: hf_import_phase(torch, dev, K, work,
                                                                **(hf_kw or {}))),
                          ("serve_cli", lambda: serve_cli_phase(torch, dev, K, work, root)),
                          ("train_import", lambda: train_import_phase(torch, dev, K, work,
                                                                      **(train_kw or {}))),
                          ("graft_entry", lambda: graft_entry_phase(torch, dev, K))):
            t0 = time.perf_counter()
            rec, counted = run()
            if counted is not None:
                launches[name] = counted
            rec.update(card=card, seconds=time.perf_counter() - t0)
            if name == "hf_import":
                rec["disk_free_gb"] = free / 1e9
                peak = rec["peak_mem_gb"]
                print(f"hf_import: {rec['checkpoint_bytes'] / 1e9:.2f} GB in {rec['shards']} "
                      f"shards loaded through build_hf_engine in {rec['load_seconds']:.2f} s "
                      f"({rec['load_gb_s']:.2f} GB/s), peak "
                      f"{'not measured' if peak is None else f'{peak:.1f} GB'}, on {card}",
                      flush=True)
            if name == "serve_cli":
                print(f"serve_cli: listening after {rec['listening_seconds']:.1f} s, two "
                      f"requests of {rec['new_tokens']} tokens equal to generate(), on {card}",
                      flush=True)
            emit(rec)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# quantization: the quantized-forward products, matmul_precision through
# training, weight-only int8 / int4 serving, the FP quantizer, LoRA
# ---------------------------------------------------------------------------
# qmatmul at one train_fused micro-batch through w_up, and at a decode
# step's 8 rows through the same weight
QMM_SHAPES = {"train_w_up": (4096, 4096, 14336), "decode_w_up": (8, 4096, 14336)}
# fp8: the library's product (fp32 out) against the plain fp32 product of
# the same codes, relative Frobenius (fp32 sums in another order); the
# call's bf16 output within 2^-6 of the largest element of the plain one
QMM_FP8_RTOL = 1e-3
# the card's int8 and fp8 tensor-core peaks (H100 SXM data sheet, dense)
INT8_OPS = FP8_FLOPS = 1979e12
# train_qmm: 2 of Mistral-7B's layers at seq 4096, gas 2, FusedAdam (AdamW
# mode) at a constant lr on one batch; the first step's loss within 0.02 of
# the default precision's (the parity legs' loss tolerance)
QMM_TRAIN_LAYERS = 2
QMM_TRAIN_STEPS = 3
QMM_TRAIN_LR = 3e-4
QMM_LOSS_ATOL = PARITY_LOSS_ATOL
QMM_TRAIN_MODES = ("default", "int8", "fp8")
# train_qmm --profile: kernel-name substrings whose device time is summed
# (cuBLAS names its products by operand types: f32 the fp32 ones, bf16,
# s8/i8 the int8 ones, e4m3 the fp8 ones)
QMM_PROFILE_SUMS = ("gemm", "nvjet", "f32f32", "sgemm", "bf16", "s8", "i8", "e4m3",
                    "elementwise", "reduce")
# the FP quantizer at one w_up's shape; LoRA over the same projection
FPQ_SHAPE = (4096, 14336)
LORA_SHAPE = dict(in_f=4096, out_f=14336, r=64, tokens=4096)


def _bits_mismatch(torch, a, b):
    """Elements whose bits differ (same shape and dtype; any device)."""
    a, b = a.detach(), b.detach().to(a.device)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{tuple(a.shape)} {a.dtype} against {tuple(b.shape)} {b.dtype}")
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return int((a.contiguous().view(view) != b.contiguous().view(view)).sum())


def _rel_fro(torch, got, want):
    got, want = got.float(), want.float().to(got.device)
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def qmatmul_phase(torch, dev, K, shapes=None, seed=SEED):
    """``ops/qmatmul.py`` at the shapes the training and serving paths give
    it: for each mode, the forward against its plain version (int8 modes
    bit for bit: the int32 products and the rescaled outputs; fp8 relative
    Frobenius against the plain fp32 product of the same codes), the
    backward bit for bit against the wide vjp's formula (dx also against
    autograd of ``x @ w``), and CUDA-graph times of the cast, the product
    and the whole call beside ``x @ w`` in bf16. The library products pad
    rows (``_int_mm``: more than 16; ``_scaled_mm``: a multiple of 16)."""
    from deepspeed_tpu_torch.ops import qmatmul as Q

    cuda = dev.type == "cuda"
    rec = {"phase": "qmatmul", "shapes": {}}
    for name, (m, k, n) in (shapes or QMM_SHAPES).items():
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(m, k, generator=g, device=dev).bfloat16()
        w = (torch.randn(k, n, generator=g, device=dev) * k ** -0.5).bfloat16()
        gy = torch.randn(m, n, generator=g, device=dev).bfloat16()
        out = {"m": m, "k": k, "n": n, "modes": {},
               "int8_rows_padded_to": max(Q._up(m, 8), 24), "fp8_rows_padded_to": Q._up(m, 16),
               "bf16_ms": time_ms(torch, lambda: x @ w) if cuda else None,
               "bf16_bound_ms": max(2 * (m * k + k * n + m * n) / HBM_BYTES_PER_S,
                                    2 * m * k * n / BF16_FLOPS) * 1e3}
        xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        adx, adw = torch.autograd.grad(xr @ wr, (xr, wr), gy)
        for mode in Q.MODES:
            r = {}
            got = Q.qmatmul_forward(x, w, mode)
            if mode == "fp8":
                (xq, sx), (wq, sw) = Q._cast_fp8(x), Q._cast_fp8(w)
                plain32 = Q.fp8_product_reference(xq, wq, sx, sw, torch.float32)
                r["rel_frobenius"] = _rel_fro(
                    torch, Q.fp8_product(xq, wq, sx, sw, torch.float32), plain32)
                # the call's bf16 output: the library rounds its fp32 sums
                # (summed in another order) once, so last bits differ
                want = plain32.to(x.dtype)
                r["bf16_out_rel_frobenius"] = _rel_fro(torch, got, want)
                r["bf16_out_mismatches"] = _bits_mismatch(torch, got, want)
                r["bf16_out_max_abs_err"] = float((got.float() - want.float()).abs().max())
                r["bf16_out_bound"] = BF16_ATOL * float(want.float().abs().max())
                if (r["rel_frobenius"] > QMM_FP8_RTOL
                        or r["bf16_out_max_abs_err"] > r["bf16_out_bound"]):
                    raise AssertionError(f"qmatmul fp8 {name}: {r}")

                def product():
                    return Q.fp8_product(xq, wq, sx, sw, x.dtype)

                def library():
                    return Q._fp8_library(xq, wq, sx, sw, x.dtype)

                def cast():
                    return Q._cast_fp8(x), Q._cast_fp8(w)
            else:
                dims = (-1, 0) if mode == "int8" else (None, None)
                (xq, sx), (wq, sw) = Q._cast_i8(x, dims[0]), Q._cast_i8(w, dims[1])
                prod = Q.int8_product(xq, wq)
                plain = Q.int8_product_reference(xq, wq)
                if mode == "int8":
                    want = (plain.float() * sx * sw).to(x.dtype)
                else:
                    want = (plain.float() * (sx * sw)).to(x.dtype)
                r["int32_mismatches"] = _bits_mismatch(torch, prod, plain)
                r["mismatches"] = _bits_mismatch(torch, got, want)
                if r["int32_mismatches"] or r["mismatches"]:
                    raise AssertionError(f"qmatmul {mode} {name}: {r}")

                def product():
                    p = Q.int8_product(xq, wq).float()
                    return (p * sx * sw if mode == "int8" else p * (sx * sw)).to(x.dtype)

                def library():
                    return Q._int8_library(xq, wq)

                def cast():
                    return Q._cast_i8(x, dims[0]), Q._cast_i8(w, dims[1])
            r["max_abs_err_vs_bf16_product"] = float((got.float() - (x @ w).float()).abs().max())
            r["rel_frobenius_vs_bf16_product"] = _rel_fro(torch, got, x @ w)
            dx, dw = torch.autograd.grad(Q.qmatmul(xr, wr, mode), (xr, wr), gy)
            wdx, wdw = Q.qmatmul_vjp(x, w, gy)
            r["dx_mismatches"] = _bits_mismatch(torch, dx, wdx)
            r["dw_mismatches"] = _bits_mismatch(torch, dw, wdw)
            r["dx_mismatches_vs_autograd"] = _bits_mismatch(torch, dx, adx)
            # autograd's dw is a bf16 product; the vjp's sums in fp32, then casts
            r["dw_mismatch_share_vs_autograd"] = _bits_mismatch(torch, dw, adw) / dw.numel()
            if r["dx_mismatches"] or r["dw_mismatches"] or r["dx_mismatches_vs_autograd"]:
                raise AssertionError(f"qmatmul {mode} {name} backward: {r}")
            if cuda:
                r["ms"] = time_ms(torch, lambda: Q.qmatmul_forward(x, w, mode))
                r["quantize_ms"] = time_ms(torch, cast)
                r["product_ms"] = time_ms(torch, product)
                # the library call alone (its layout copy included; int8:
                # before the int32 -> fp32 rescale)
                r["library_ms"] = time_ms(torch, library)
                r["bf16_ms_over_ms"] = out["bf16_ms"] / r["ms"]
                r["bf16_ms_over_product_ms"] = out["bf16_ms"] / r["product_ms"]
            r["product_bound_ms"] = max((m * k + k * n + 2 * m * n) / HBM_BYTES_PER_S,
                                        2 * m * k * n / INT8_OPS) * 1e3
            out["modes"][mode] = r
        rec["shapes"][name] = out
        del x, w, gy, xr, wr, adx, adw
    return rec, K.counts()


def train_qmm_phase(torch, dev, K, widths=None, layers=QMM_TRAIN_LAYERS, seq=SEQ,
                    steps=QMM_TRAIN_STEPS, modes=QMM_TRAIN_MODES, profile=False):
    """``matmul_precision`` through ``initialize`` -> ``train_batch``: the
    same weights and one batch (gas 2 x seq tokens) for each mode, FusedAdam
    in AdamW mode at a constant lr, 1 warm-up and ``steps`` timed steps; the
    first loss within QMM_LOSS_ATOL of the default precision's, the losses
    finite and falling, the flash, RMSNorm and FusedAdam launches per step
    exactly the default's. ``profile``: each mode's step under
    ``device_profile``, its kernels summed by QMM_PROFILE_SUMS."""
    import numpy as np

    from deepspeed_tpu_torch.models import transformer as T

    widths = dict(widths or {})
    widths.setdefault("dtype", "bfloat16")
    ds_config = {k: v for k, v in TRAIN_CONFIG.items() if k != "scheduler"}
    ds_config["optimizer"] = dict(FUSED_OPTIMIZER,
                                  params=dict(FUSED_OPTIMIZER["params"], lr=QMM_TRAIN_LR))
    if widths["dtype"] != "bfloat16":
        del ds_config["bf16"]
    gas = ds_config["gradient_accumulation_steps"]
    rng = np.random.default_rng(SEED)
    cfg = T.get_config(MODEL, n_layers=layers, remat=False, **widths)
    batch = {"input_ids": torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(gas, seq + 1)),
                                          device=dev)}
    per_step = {"rms_norm_fwd": gas * (2 * layers + 1), "rms_norm_bwd": gas * (2 * layers + 1),
                "flash_fwd": gas * layers, "flash_bwd_dq": gas * layers,
                "flash_bwd_dkv": gas * layers, "fused_adam": None}
    rec = {"phase": "train_qmm", "model": MODEL, "n_layers": layers, "seq": seq, "gas": gas,
           "lr": QMM_TRAIN_LR, "modes": {}}
    launches = {}
    for mode in modes:
        cfg = T.get_config(MODEL, n_layers=layers, remat=False, matmul_precision=mode, **widths)
        sub = {"phase": f"train_qmm[{mode}]"}
        launches[mode] = timed_train(torch, dev, K, cfg, ds_config, [batch] * (1 + steps),
                                     per_step, sub, profile=profile)
        rec["modes"][mode] = {k: sub[k] for k in (
            "losses", "step_seconds", "mean_step_seconds", "tok_s", "mfu", "peak_mem_gb",
            "launches_per_optimizer_step", "profile") if k in sub}
        losses = sub["losses"]
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train_qmm {mode}: the loss did not fall: {losses}")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    first = rec["modes"]["default"]["losses"][0]
    rec["first_loss_diff"] = {m: abs(r["losses"][0] - first) for m, r in rec["modes"].items()}
    if max(rec["first_loss_diff"].values()) > QMM_LOSS_ATOL:
        raise AssertionError(f"train_qmm: first losses off the default's: {rec['first_loss_diff']}")
    if any(launches[m] != launches["default"] for m in modes):
        raise AssertionError(f"train_qmm: launches differ between precisions: {launches}")
    rec["launches"] = launches["default"]
    return rec, launches


def fp_quantizer_phase(torch, dev, K, shape=FPQ_SHAPE, seed=SEED):
    """The op registry's ``fp_quantizer``: ``fp8_cast``, ``fp_quantize``
    (fp6, fp8, fp12, groups of 128), ``fp_pack`` and ``fp_unpack`` on the
    card at one w_up's shape; codes, scales and packed bytes equal the same
    functions' on the host's copy bit for bit, and the bytes unpack to the
    values. Times are CUDA-event times of eager calls."""
    from deepspeed_tpu_torch.accelerator import get_accelerator

    op = get_accelerator().create_op_builder("fp_quantizer").load()
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev) * 3.0
    xc = x.cpu()
    rec = {"phase": "fp_quantizer", "shape": list(shape), "formats": {}}
    v, s = op.fp8_cast(x)
    vc, sc = op.fp8_cast(xc)
    rec["fp8_cast"] = {"mismatches": _bits_mismatch(torch, v, vc),
                       "scale_equal": float(s) == float(sc)}
    if dev.type == "cuda":
        rec["fp8_cast"]["ms"] = eager_ms(torch, lambda: op.fp8_cast(x), iters=5, warmup=1)
    bad = rec["fp8_cast"]["mismatches"] or not rec["fp8_cast"]["scale_equal"]
    for q_bits in (6, 8, 12):
        q, sq, shp = op.fp_quantize(x, q_bits=q_bits, group_size=128)
        qc, sqc, _ = op.fp_quantize(xc, q_bits=q_bits, group_size=128)
        p, pc = op.fp_pack(q, q_bits), op.fp_pack(qc, q_bits)
        r = {"value_mismatches": _bits_mismatch(torch, q, qc),
             "scale_mismatches": _bits_mismatch(torch, sq, sqc),
             "byte_mismatches": _bits_mismatch(torch, p, pc), "bytes": p.numel(),
             # by value: the codes keep no sign for a zero (q holds -0.0 for x < 0)
             "unpack_mismatches": int((op.fp_unpack(p, q.numel(), q_bits)
                                       != q.reshape(-1)).sum())}
        if dev.type == "cuda":
            r["quantize_pack_ms"] = eager_ms(
                torch, lambda: op.fp_pack(op.fp_quantize(x, q_bits, 128)[0], q_bits),
                iters=5, warmup=1)
        rec["formats"][f"fp{q_bits}"] = r
        bad = bad or any(v for k, v in r.items() if k.endswith("mismatches"))
        del q, qc, p, pc
    if bad:
        raise AssertionError(f"fp_quantizer: the card's codes differ from the host's: {rec}")
    return rec, K.counts()


def lora_phase(torch, dev, K, in_f=LORA_SHAPE["in_f"], out_f=LORA_SHAPE["out_f"],
               r=LORA_SHAPE["r"], tokens=LORA_SHAPE["tokens"], seed=SEED):
    """``optimized_linear`` with an int8 base (``quantize_blockwise``,
    blocks of 512) and rank-r adapters in bf16, forward and backward on the
    card: gradients reach ``lora_a`` and ``lora_b`` only; ``x @
    merge_lora(...)`` equals the call within bf16's bound (2^-6 of the
    largest element); the int8 base's error against the wide weight, the
    call's ms and peak memory."""
    from deepspeed_tpu_torch.linear import (
        LoRAConfig,
        QuantizationConfig,
        init_optimized_linear,
        lora_trainable_mask,
        merge_lora,
        optimized_linear,
    )
    from deepspeed_tpu_torch.linear.optimized_linear import _base_weight

    g = torch.Generator(device=dev).manual_seed(seed)
    lora, quant = LoRAConfig(lora_r=r, lora_alpha=16.0), QuantizationConfig(q_bits=8)
    wide = (torch.randn(in_f, out_f, generator=g, device=dev) * in_f ** -0.5).bfloat16()
    p = init_optimized_linear(g, in_f, out_f, lora, quant, dtype=torch.bfloat16,
                              base_weight=wide)
    p["lora_b"] = (torch.randn(r, out_f, generator=g, device=dev) * 0.02).bfloat16()
    x = torch.randn(tokens, in_f, generator=g, device=dev).bfloat16()
    gy = torch.randn(tokens, out_f, generator=g, device=dev).bfloat16()
    a, b = p["lora_a"].requires_grad_(True), p["lora_b"].requires_grad_(True)
    scales = p["base"]["scales"].requires_grad_(True)
    rec = {"phase": "lora", "in": in_f, "out": out_f, "r": r, "tokens": tokens,
           "base_bits": quant.q_bits, "base_block": quant.group_size,
           "mask": lora_trainable_mask(p)}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    y = optimized_linear(p, x, lora, quant)
    ga, gb, gs = torch.autograd.grad(y, (a, b, scales), gy, allow_unused=True)
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
    rec["base_grad"] = gs is not None
    rec["lora_grad_norms"] = [float(ga.float().norm()), float(gb.float().norm())]
    with torch.no_grad():
        merged = merge_lora(p, lora, quant)
        ym = x @ merged
        rec["merge_max_abs_err"] = float((ym.float() - y.float()).abs().max())
        rec["merge_bound"] = BF16_ATOL * float(y.float().abs().max())
        rec["base_rel_frobenius"] = _rel_fro(
            torch, _base_weight(p, quant, (in_f, out_f), torch.float32), wide)
    if dev.type == "cuda":
        def call():
            yy = optimized_linear(p, x, lora, quant)
            torch.autograd.grad(yy, (a, b), gy)

        rec["fwd_bwd_ms"] = eager_ms(torch, call, iters=5, warmup=1)
        rec["dense_fwd_bwd_ms"] = eager_ms(
            torch, lambda: torch.autograd.grad(x @ wide.requires_grad_(True), wide, gy),
            iters=5, warmup=1)
    if (gs is not None or not all(t > 0 and t == t for t in rec["lora_grad_norms"])
            or rec["merge_max_abs_err"] > rec["merge_bound"]):
        raise AssertionError(f"lora: {rec}")
    return rec, K.counts()


def quant_phases(torch, dev, K, card, bf16=None, profile=False, serve_kw=None, qmm_kw=None,
                 train_kw=None, fpq_kw=None, lora_kw=None):
    """qmatmul, train_qmm, serve_wq8, serve_wq4, serve_wq8_int8, fp_quantizer
    and lora, each emitted with its seconds and launches (counted from 0 just before
    it). ``bf16``: the bf16 engine's prefill rows and tok/s for the serving
    phases; the ``*_kw`` shrink the phases for a rehearsal on the CPU.
    Returns the launches of each phase."""
    launches = {}
    pool_kw = dict(serve_kw or {})
    pool_kw["widths"] = dict(pool_kw.get("widths") or {}, n_layers=QUANT_INT8_POOL_LAYERS)
    runs = (
        ("qmatmul", lambda: qmatmul_phase(torch, dev, K, **(qmm_kw or {}))),
        ("train_qmm", lambda: train_qmm_phase(torch, dev, K, profile=profile,
                                              **(train_kw or {}))),
        ("serve_wq8", lambda: engine_phase(torch, dev, K, quant_bits=8, bf16=bf16,
                                           profile=profile, bench_repeats=1,
                                           **(serve_kw or {}))),
        ("serve_wq4", lambda: engine_phase(torch, dev, K, quant_bits=4, bf16=bf16,
                                           profile=profile, bench_repeats=1,
                                           **(serve_kw or {}))),
        ("serve_wq8_int8", lambda: engine_phase(torch, dev, K, quant_bits=8,
                                                kv_cache_dtype="int8", bench_repeats=1,
                                                **pool_kw)),
        ("fp_quantizer", lambda: fp_quantizer_phase(torch, dev, K, **(fpq_kw or {}))),
        ("lora", lambda: lora_phase(torch, dev, K, **(lora_kw or {}))),
    )
    for name, run in runs:
        t0 = time.perf_counter()
        K.reset_counts()
        rec, launches[name] = run()
        rec.update(card=card, seconds=time.perf_counter() - t0)
        emit(rec)
        if name.startswith("serve_wq"):
            print(f"{name}: weights {rec['model_memory_bytes'] / 1e9:.3f} GB against "
                  f"{rec['wide_model_memory_bytes'] / 1e9:.3f} GB wide "
                  f"({rec['memory_over_wide']:.3f}x), gen {rec['gen_tok_s']:.1f} tok/s, round "
                  f"{rec['round_tok_s']:.1f} tok/s, widening "
                  f"{rec.get('dequant_ms_per_round_step', float('nan')):.2f} ms a step, on {card}",
                  flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return launches


def device_profile(torch, fns, sums=()):
    """torch.profiler over each named callable: device time by kernel name
    (the 24 kernels with the most), the device's busy share of the wall
    time, and the host operators with the most self time (opt-in,
    ``--profile``); ``sums``: substrings of kernel names whose device ms and
    launches are also summed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in fns.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = []
        for ev in prof.key_averages():
            # device-side kernel events only: op rows carry their kernels'
            # time too and would count it twice
            if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
                continue
            rows.append((ev.key, ev.self_device_time_total / 1e3, ev.count))
        rows.sort(key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        host = sorted(((ev.key, ev.self_cpu_time_total / 1e3, ev.count)
                       for ev in prof.key_averages() if ev.device_type == DeviceType.CPU),
                      key=lambda r: -r[1])
        counts = {}
        for ev in prof.key_averages():
            counts[ev.key] = counts.get(ev.key, 0) + ev.count
        out[name] = {
            "wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms if rows else None,
            "device_idle_share": (1 - busy_ms / (wall * 1e3)) if rows else None,
            # host-to-device copies (from pageable memory each waits for
            # the host) and the runtime's synchronizing calls, the closing
            # synchronize included
            "h2d_copies": sum(n for k, n in counts.items() if k.startswith("Memcpy HtoD")),
            "pageable_h2d_copies": sum(n for k, n in counts.items()
                                       if k.startswith("Memcpy HtoD (Pageable")),
            "d2h_copies": sum(n for k, n in counts.items() if k.startswith("Memcpy DtoH")),
            "syncs": sum(counts.get(k, 0) for k in ("cudaStreamSynchronize",
                                                    "cudaDeviceSynchronize",
                                                    "cudaEventSynchronize")),
            "top": [{"kernel": k[:90], "ms": ms, "count": n} for k, ms, n in rows[:24]],
            "sums": {pat: {"ms": sum(r[1] for r in rows if pat in r[0]),
                           "count": sum(r[2] for r in rows if pat in r[0])} for pat in sums},
            "host_top": [{"op": k[:60], "self_ms": ms, "count": n} for k, ms, n in host[:12]],
        }
    return out


# ---------------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="torch.profiler breakdowns: a split step and a decode round after "
                         "the engine phase, one optimizer step after the train phase")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "deepspeed_tpu_torch").is_dir():
        print(f"chip_smoke: no deepspeed_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from deepspeed_tpu_torch.ops import kernels as K

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_info()
    print(card, flush=True)
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    builds = K.build()
    # ptxas's -v report: spills (a "bytes spill" count above 0) and wgmma
    # serialisation (the C75xx performance notes) are counted per build
    # (0 and 0 when the library was already built: no report then)
    spill = re.compile(r"\b[1-9]\d* bytes spill")

    def ptxas_flags(b):
        lines = b["ptxas"].splitlines()
        return {"spill_lines": sum(bool(spill.search(ln)) for ln in lines),
                "c75_lines": sum("(C75" in ln for ln in lines)}

    emit({"phase": "setup", "card": card, "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "builds": [dict({k: b[k] for k in ("name", "seconds")}, **ptxas_flags(b))
                     for b in builds],
          "seconds": time.perf_counter() - t0})
    for b in builds:
        for line in b["ptxas"].splitlines():
            if ("(C75" in line or spill.search(line)
                    or ("ptxas info" in line and "registers" in line)):
                print(f"  [{b['name']}] {line.strip()}", flush=True)

    groups = {
        "rms_norm": lambda: {"rms_norm_fwd": kernel_rms_norm(torch, dev),
                             "rms_norm_bwd": kernel_rms_norm_bwd(torch, dev)},
        "paged": lambda: {"paged_decode": kernel_paged_decode(torch, dev, seed=SEED)},
        "paged_int8": lambda: {"paged_decode_int8": kernel_paged_decode(torch, dev, seed=SEED,
                                                                        int8=True)},
        "block_quant": lambda: {"block_quant": kernel_block_quant(torch, dev)},
        "flash": lambda: kernel_flash(torch, dev),
        "flash_alibi": lambda: kernel_flash_alibi(torch, dev),
        "fused_ce": lambda: kernel_fused_ce(torch, dev),
        "fused_adam": lambda: {"fused_adam": kernel_fused_adam(torch, dev)},
        "splash": lambda: kernel_splash(torch, dev),
        "sparse": lambda: kernel_sparse(torch, dev),
        "evoformer": lambda: kernel_evoformer(torch, dev),
        "flash_carry": lambda: kernel_flash_carry(torch, dev),
    }
    t0 = time.perf_counter()
    records = {}
    for name, run in groups.items():
        group = run()
        emit({"phase": "kernels", "group": name, "card": card, "kernels": list(group.values())})
        records.update(group)
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "card": card, "seconds": time.perf_counter() - t0,
          "names": list(records)})
    t0 = time.perf_counter()
    bf16_rows, held = {}, {}
    rec, serve_launches = engine_phase(torch, dev, K, profile=args.profile, keep=bf16_rows,
                                       hold=held)
    rec["card"] = card
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    bf16_info, bf16_gen, bf16_round = rec["kv_pool_info"], rec["gen_tok_s"], rec["round_tok_s"]
    # the serve_wq phases hold their prefill logits against these rows
    bf16 = {"gen_tok_s": bf16_gen, "round_tok_s": bf16_round,
            "prefill": {u: v[0][0].clone() for u, v in bf16_rows.items() if isinstance(u, int)}}
    torch.cuda.empty_cache()

    # speculative decoding, the host tier and the v1 engine on the engine
    # phase's engine and weights
    spec_launches = {}
    t0 = time.perf_counter()
    rec, spec_launches["bf16"] = engine_spec_phase(torch, dev, K, held["engine"],
                                                   held["prompts"], held["plain"])
    rec.update(card=card, seconds=time.perf_counter() - t0)
    emit(rec)
    print(f"engine_spec: oracle drafts accepted {rec['oracle_accepted']} of "
          f"{rec['oracle_drafted']}; over {SPEC_TIMED_ROUNDS} rounds each (median [min, max]): "
          f"verify step {fmt_spread(rec['verify_ms'])} ms; spec "
          f"{fmt_spread(rec['spec_tok_s'])} tok/s against plain decode_round "
          f"{fmt_spread(rec['plain_round_tok_s'])} tok/s on {card}", flush=True)
    t0 = time.perf_counter()
    rec = host_tier_phase(torch, dev, K, held["cfg"], held["engine"].params)
    rec.update(card=card, seconds=time.perf_counter() - t0)
    emit(rec)
    print(f"host_tier: {rec['readmits']} blocks readmitted, chunked import "
          f"{rec['chunked_import']['gb_s']:.2f} GB/s, of its time "
          f"{100 * rec['chunked_import']['stage_share']:.0f}% staging into pinned memory, "
          f"on {card}", flush=True)
    print(V1_NOTE, flush=True)
    t0 = time.perf_counter()
    rec = inference_v1_phase(torch, dev, K, held["cfg"], held["engine"].params)
    rec.update(card=card, seconds=time.perf_counter() - t0)
    emit(rec)
    # the serving stack (driver, HTTP server, tracing, spec) on the same engine
    serving_launches = {}
    t0 = time.perf_counter()
    rec, serving_launches["serving"] = serving_phase(torch, dev, K, held["engine"])
    rec.update(card=card, seconds=time.perf_counter() - t0)
    emit(rec)
    print(serving_note(rec, card), flush=True)
    held.clear()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rec, int8_launches = engine_phase(torch, dev, K, kv_cache_dtype="int8", bf16_rows=bf16_rows,
                                      profile=args.profile, hold=held)
    rec.update(card=card, seconds=time.perf_counter() - t0, kv_pool_info_bf16=bf16_info,
               gen_tok_s_over_bf16=rec["gen_tok_s"] / bf16_gen,
               round_tok_s_over_bf16=rec["round_tok_s"] / bf16_round)
    emit(rec)
    del bf16_rows
    t0 = time.perf_counter()
    rec, spec_launches["int8"] = engine_spec_phase(torch, dev, K, held["engine"],
                                                   held["prompts"], held["plain"], int8=True)
    rec.update(card=card, seconds=time.perf_counter() - t0)
    emit(rec)
    t0 = time.perf_counter()
    rec, serving_launches["serving_int8"] = serving_phase(torch, dev, K, held["engine"],
                                                          int8=True)
    rec.update(card=card, seconds=time.perf_counter() - t0)
    emit(rec)
    print(serving_note(rec, card), flush=True)
    held.clear()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec, per_row_int8_launches = engine_per_row_int8_phase(torch, dev, K)
    rec.update(card=card, seconds=time.perf_counter() - t0)
    emit(rec)
    torch.cuda.empty_cache()

    # the dense-head / eager-AdamW leg first, then the fused configuration,
    # then the splash leg: one run prints the steps side by side. Each
    # engine holds ~40 GB and is freed before the next.
    train_launches = {}
    for leg in ("train", "train_fused", "train_splash"):
        t0 = time.perf_counter()
        rec, launches = train_phase(torch, dev, K, profile=args.profile,
                                    fused=leg == "train_fused", splash=leg == "train_splash")
        train_launches[leg] = launches
        rec["card"] = card
        rec["seconds"] = time.perf_counter() - t0
        emit(rec)
        print(f"{rec['phase']} MFU {rec['mfu']:.4f} = flops_per_token "
              f"{rec['flops_per_token']:.4g} x {rec['tok_s']:.1f} tok/s / {BF16_FLOPS:.4g} FLOP/s "
              f"on {card}", flush=True)
        torch.cuda.empty_cache()

    # the rest of the model at the published widths: BLOOM's ALiBi, Mixtral's
    # MoE in training and serving, BERT's encoder heads
    model_launches = {}
    for name, run_phase in (("train_alibi", train_alibi_phase), ("train_moe", train_moe_phase),
                            ("engine_moe", engine_moe_phase), ("train_mlm", train_mlm_phase)):
        t0 = time.perf_counter()
        rec, model_launches[name] = run_phase(torch, dev, K)
        rec.update(card=card, seconds=time.perf_counter() - t0)
        emit(rec)
        reckoned = rec.get("reckoned_train_gb", rec.get("reckoned_weights_gb"))
        print(f"{name}: {rec['n_layers']} layers of {rec['model']}, params {rec['params']} "
              f"(reckoned {reckoned:.1f} GB), peak {rec['peak_mem_gb']:.1f} GB on {card}",
              flush=True)
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rec, per_row_launches = engine_per_row_phase(torch, dev, K)
    rec["card"] = card
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rec, sparse_launches = sparse_attn_phase(torch, dev, K)
    rec["card"] = card
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rec, evo_launches = evoformer_phase(torch, dev, K)
    rec["card"] = card
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    torch.cuda.empty_cache()

    print("ring: the loopback form (one process drives the N context ranks) runs here; the "
          "process form over NCCL (one rank per card) was not run: this machine has "
          f"{torch.cuda.device_count()} card(s)", flush=True)
    t0 = time.perf_counter()
    rec, ring_launches = ring_attn_phase(torch, dev, K)
    rec["card"] = card
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rec, train_ring_launches = train_ring_phase(torch, dev, K, profile=args.profile)
    rec["card"] = card
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    print(f"train_ring MFU {rec['mfu']:.4f} = flops_per_token {rec['flops_per_token']:.4g} x "
          f"{rec['tok_s']:.1f} tok/s / {BF16_FLOPS:.4g} FLOP/s on {card}", flush=True)
    torch.cuda.empty_cache()

    # a HuggingFace checkpoint directory into both engines, and the graft entry
    t0 = time.perf_counter()
    import_launches = import_phases(torch, dev, K, root, card)
    print(f"hf_import + train_import + graft_entry: {time.perf_counter() - t0:.1f} s on {card}",
          flush=True)

    # quantization: qmatmul, matmul_precision through training, weight-only
    # int8 / int4 serving on the engine phase's weights, the FP quantizer, LoRA
    t0 = time.perf_counter()
    quant_launches = quant_phases(torch, dev, K, card, bf16=bf16, profile=args.profile)
    print(f"qmatmul + train_qmm + serve_wq8 + serve_wq4 + serve_wq8_int8 + fp_quantizer + "
          f"lora: {time.perf_counter() - t0:.1f} s on {card}", flush=True)

    # serving kernels launch in the engine phase (the int8 pool's in the
    # engine_int8 phase and the int8 per-row check), training kernels in the
    # train legs, the fused leg's four in the fused leg, the splash kernels
    # in the splash leg (and the splash forward in the per-row leg), the
    # sparse kernels in the sparse_attn phase, the evoformer kernels in the
    # evoformer phase, and together they are every kernel
    launched = {name: serve_launches[name] for name in SERVE_KERNELS}
    launched.update({name: int8_launches[name] for name in INT8_KERNELS})
    launched.update({name: train_launches["train"][name] for name in TRAIN_KERNELS
                     if name not in SERVE_KERNELS})
    launched.update({name: train_launches["train_fused"][name] for name in FUSED_KERNELS})
    launched.update({name: train_launches["train_splash"][name] for name in SPLASH_KERNELS})
    launched.update({name: sparse_launches[name] for name in SPARSE_KERNELS})
    launched.update({name: evo_launches[name] for name in EVOFORMER_KERNELS})
    launched.update({name: train_ring_launches[name] for name in CARRY_KERNELS})
    launched.update({name: model_launches["train_alibi"][name] for name in FLASH_ALIBI_KERNELS})
    missing = [n for n, c in launched.items() if c <= 0]
    missing += [f"{n} (train_moe)" for n in TRAIN_KERNELS if model_launches["train_moe"][n] <= 0]
    missing += [f"{n} (engine_moe)" for n in SERVE_KERNELS
                if model_launches["engine_moe"][n] <= 0]
    missing += [f"{n} (train_mlm)" for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                if model_launches["train_mlm"][n] <= 0]
    missing += [f"{n} (ring_attn)" for n in CARRY_KERNELS if ring_launches[n] <= 0]
    missing += [n for n in TRAIN_KERNELS if train_launches["train_fused"][n] <= 0]
    missing += [f"{n} (engine_per_row)" for n in PER_ROW_KERNELS if per_row_launches[n] <= 0]
    missing += [f"{n} (engine_int8)" for n in ("rms_norm_fwd",) if int8_launches[n] <= 0]
    missing += [f"{n} (engine_per_row_int8)" for n in INT8_KERNELS
                if per_row_int8_launches[n] <= 0]
    missing += [f"{n} (engine_spec)" for n in SERVE_KERNELS if spec_launches["bf16"][n] <= 0]
    missing += [f"{n} (engine_spec_int8)" for n in INT8_KERNELS + ("rms_norm_fwd",)
                if spec_launches["int8"][n] <= 0]
    missing += [f"{n} (hf_import)" for n in SERVE_KERNELS
                if import_launches["hf_import"][n] <= 0]
    missing += [f"{n} (serving)" for n in SERVE_KERNELS
                if serving_launches["serving"][n] <= 0]
    missing += [f"{n} (serving_int8)" for n in ("rms_norm_fwd",) + INT8_KERNELS
                if serving_launches["serving_int8"][n] <= 0]
    missing += [f"{n} (train_import)" for n in TRAIN_KERNELS
                if import_launches["train_import"][n] <= 0]
    missing += [f"{n} (graft_entry)" for n in ("rms_norm_fwd", "flash_fwd")
                if import_launches["graft_entry"][n] <= 0]
    missing += [f"{n} (train_qmm {mode})" for mode, n in
                ((m, n) for m in QMM_TRAIN_MODES for n in TRAIN_KERNELS + ("fused_adam",))
                if quant_launches["train_qmm"][mode][n] <= 0]
    missing += [f"{n} ({phase})" for phase in ("serve_wq8", "serve_wq4") for n in SERVE_KERNELS
                if quant_launches[phase][n] <= 0]
    missing += [f"{n} (serve_wq8_int8)" for n in ("rms_norm_fwd",) + INT8_KERNELS
                if quant_launches["serve_wq8_int8"][n] <= 0]
    if missing or set(launched) != set(K.KERNELS):
        raise AssertionError(
            f"a kernel of the path was not launched: {missing}; serving {serve_launches}, "
            f"training {train_launches}, per-row {per_row_launches}, int8 {int8_launches}, "
            f"per-row int8 {per_row_int8_launches}, sparse_attn {sparse_launches}, "
            f"evoformer {evo_launches}, ring_attn {ring_launches}, train_ring "
            f"{train_ring_launches}, model {model_launches}, import {import_launches}, "
            f"kernels {sorted(K.KERNELS)}")

    kernels_line = []
    for name, k in K.KERNELS.items():
        rec = records[name]
        phase = ("engine" if name in SERVE_KERNELS
                 else "engine_int8" if name in INT8_KERNELS
                 else "train_fused" if name in FUSED_KERNELS
                 else "train_splash" if name in SPLASH_KERNELS
                 else "sparse_attn" if name in SPARSE_KERNELS
                 else "evoformer" if name in EVOFORMER_KERNELS
                 else "train_ring" if name in CARRY_KERNELS
                 else "train_alibi" if name in FLASH_ALIBI_KERNELS else "train")
        kernels_line.append({
            "name": name, "route": "cuda",
            "source": str(k.source_path.relative_to(root)),
            "replaces": k.replaces,
            "launches": launched[name],
            "launches_phase": phase,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            **({"flash_ms": rec["flash_ms"], "against_flash": rec["against_flash"],
                "launches_engine_per_row": per_row_launches.get(name, 0)}
               if name in SPLASH_KERNELS else {}),
            **({"flash_ms": rec["flash_ms"]} if name in SPARSE_KERNELS else {}),
            **({"fp32": {key: rec["fp32"][key] for key in ("ms", "plain_ms", "bound_ms",
                                                           "bound_by")}}
               if name in EVOFORMER_KERNELS else {}),
            **({"launches_engine_per_row_int8": per_row_int8_launches[name]}
               if name in INT8_KERNELS else {}),
            **({"launches_verify_step": spec_launches["int8" if name in INT8_KERNELS
                                                      else "bf16"][name]}
               if name in SERVE_KERNELS + INT8_KERNELS else {}),
            **({"verify_form": {key: rec["verify_form"][key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_ms_as_read",
                "max_abs_err", "launches_per_call")}} if "verify_form" in rec else {}),
            **({"launches_ring_attn_call": ring_launches[name]} if name in CARRY_KERNELS else {}),
            **({"no_alibi_ms": rec["no_alibi_ms"]} if name in FLASH_ALIBI_KERNELS else {}),
            **{f"launches_{phase_name}": n.get(name, 0)
               for phase_name, n in import_launches.items()},
            **{f"launches_{phase_name}": n.get(name, 0)
               for phase_name, n in serving_launches.items()},
            **{f"launches_{phase_name}": quant_launches[phase_name].get(name, 0)
               for phase_name in ("serve_wq8", "serve_wq4", "serve_wq8_int8")},
            **{f"launches_train_qmm_{mode}": quant_launches["train_qmm"][mode].get(name, 0)
               for mode in QMM_TRAIN_MODES},
            "matched": True,  # check_close raised otherwise
        })
    emit({"phase": "done", "seconds": time.perf_counter() - t_all})
    emit({"kernels": kernels_line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
