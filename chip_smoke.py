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
   the serving path gives it at Mistral-7B width, in bf16, with the
   tolerance stated; then CUDA-event times of the kernel, the plain
   version and one PyTorch library call computing the same function (a
   yardstick only: the port never calls it), beside the least time the
   card could take (``bound_ms``).
3. engine: ``InferenceEngineV2`` at Mistral-7B width (seeded random bf16
   weights, all 32 layers) prefills 32 prompts through ``step()`` and runs
   one fused ``decode_round(64)``; logits are held against the plain
   ``forward``; kernel launches are counted and checked; then
   ``serving_benchmark`` prints generated tokens per second. With
   ``--profile``, a torch.profiler breakdown of a split step and a decode
   round follows.

The line before the last lists the kernels; the last line is the result
object. With no card, or outside a checkout, it exits non-zero and prints
no result.
"""

import argparse
import json
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


class PagedWorld:
    """A flat multi-layer K/V pool at the engine's layout, plus the row
    tables the split step and the fused round hand the kernel."""

    def __init__(self, torch, dev, dtype, L, NB, bs, nkv, d, seed):
        self.torch, self.dev, self.dtype = torch, dev, dtype
        self.L, self.NB, self.NBp, self.bs, self.nkv, self.d = L, NB, NB + 1, bs, nkv, d
        gen = torch.Generator(device=dev).manual_seed(seed)
        shape = (L * (NB + 1), bs, nkv, d)
        self.k = torch.empty(shape, device=dev, dtype=dtype)
        self.v = torch.empty(shape, device=dev, dtype=dtype)
        # fill layer by layer: one fp32 layer at a time stays small
        for li in range(L):
            sl = slice(li * (NB + 1), (li + 1) * (NB + 1))
            self.k[sl] = torch.randn((NB + 1,) + shape[1:], generator=gen, device=dev).to(dtype)
            self.v[sl] = torch.randn((NB + 1,) + shape[1:], generator=gen, device=dev).to(dtype)

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


def paged_cases(torch, world, rng, R, nh, B, layer, E_round):
    """The kernel's call forms on the serving path: the split step's decode
    rows (E = 1, pool limit, padded slots at q_pos = -1) and a fused round's
    step (E = n_steps, pool limit at the round start, in-round extras,
    inactive rows with all-trash tables); plus the causal form with a
    window and a scale override, and a window on the round form."""
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
    return cases


def paged_bytes_ops(world, kw):
    """Bytes the kernel must move and operations it must do for these
    inputs: each valid key's K and V row once (non-trash blocks inside the
    limit/causal/window range, valid extras), q, the tables and the
    output; 4 * d FLOPs per valid key per query head."""
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
    extra = kw.get("extra_kv")
    if extra is not None:
        epos = extra[2].cpu().numpy()
        ok = (epos >= 0) & (epos <= qpos[:, None])
        if window:
            ok &= (qpos[:, None] - epos) < window
        keys += int(ok.sum())
    el = q.element_size()
    moved = keys * 2 * nkv * d * el + 2 * q.numel() * el + tables.size * 4 + R * 4 * 2
    ops = keys * (nh // nkv) * nkv * 4 * d
    return moved, ops


def kernel_paged_decode(torch, dev, L=32, NB=512, bs=128, B=5, R=32, nh=32, nkv=8, d=128,
                        E_round=64, seed=0):
    import numpy as np

    from deepspeed_tpu_torch.ops.attention.paged import (
        paged_decode,
        paged_decode_attention_dense,
    )

    rng = np.random.default_rng(seed)
    errs = {}
    # full width: the Mistral-7B flat pool (> 2^31 elements), bf16, last layer
    world = PagedWorld(torch, dev, torch.bfloat16, L, NB, bs, nkv, d, seed)
    if world.k.numel() < 2 ** 31:
        raise AssertionError("the full-width pool should exceed 2^31 elements")
    cases = paged_cases(torch, world, rng, R, nh, B, L - 1, E_round)
    for name, kw in cases:
        got = paged_decode(k_cache=world.k, v_cache=world.v, **kw)
        want = paged_decode_attention_dense(k_cache=world.k, v_cache=world.v, **kw)
        errs[name] = check_close(torch, f"paged_decode {name}", got, want, BF16_ATOL, BF16_RTOL)
        if name == "causal_window_scale" and bool(got[0].float().abs().max() != 0):
            raise AssertionError("paged_decode: an all-trash row must give exactly 0")
        if name.startswith("split") and bool(got[-4:].float().abs().max() != 0):
            raise AssertionError("paged_decode: padded slots (q_pos = -1) must give exactly 0")
    # other head dims, GQA groups and fp32, at a small pool
    for dt, dd, hh, kvh in ((torch.float32, 64, 8, 2), (torch.float32, 256, 4, 4),
                            (torch.bfloat16, 64, 32, 2), (torch.float32, 128, 12, 4)):
        small = PagedWorld(torch, dev, dt, 2, 24, 16, kvh, dd, seed + 1)
        tol = (FP32_ATOL, FP32_RTOL) if dt == torch.float32 else (BF16_ATOL, BF16_RTOL)
        for name, kw in paged_cases(torch, small, rng, 6, hh, 4, 1, 8):
            got = paged_decode(k_cache=small.k, v_cache=small.v, **kw)
            want = paged_decode_attention_dense(k_cache=small.k, v_cache=small.v, **kw)
            key = f"{name}_{str(dt).split('.')[-1]}_d{dd}_g{hh // kvh}"
            errs[key] = check_close(torch, f"paged_decode {key}", got, want, *tol)
        del small
    torch.cuda.synchronize()

    # times at the round form (E = n_steps), rotating over 8 layers so each
    # launch reads its K/V from device memory
    _, round_kw = cases[1]
    layer_kw = []
    for li in range(8):
        kw = dict(round_kw)
        off = (li - (L - 1)) * world.NBp
        kw["block_tables"] = round_kw["block_tables"] + off
        kw["trash_block"] = world.trash(li)
        layer_kw.append(kw)
    it = iter(range(1 << 30))
    ms = time_ms(torch, lambda: paged_decode(
        k_cache=world.k, v_cache=world.v, **layer_kw[next(it) % 8]))
    plain_ms = time_ms(torch, lambda: paged_decode_attention_dense(
        k_cache=world.k, v_cache=world.v, **layer_kw[next(it) % 8]), iters=5)
    library_ms = sdpa_ms(torch, world, round_kw)
    call_ms = eager_ms(torch, lambda: paged_decode(
        k_cache=world.k, v_cache=world.v, **layer_kw[next(it) % 8]))
    moved, ops = paged_bytes_ops(world, round_kw)
    split_moved, _ = paged_bytes_ops(world, cases[0][1])
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / BF16_FLOPS
    return {
        "name": "paged_decode",
        "shape": {"R": R, "nh": nh, "nkv": nkv, "d": d, "bs": bs, "B": B, "E": E_round,
                  "pool": list(world.k.shape)},
        "max_abs_err": max(errs.values()),
        "max_abs_err_by_case": errs,
        "tolerance": {"bf16": [BF16_ATOL, BF16_RTOL], "fp32": [FP32_ATOL, FP32_RTOL]},
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library": "torch.nn.functional.scaled_dot_product_attention on the gathered context",
        "eager_call_ms": call_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": moved,
        "split_step_bound_ms": split_moved / HBM_BYTES_PER_S * 1e3,
    }


def sdpa_ms(torch, world, kw):
    """One SDPA call over the round form's gathered context (pool blocks
    then extras, with the same mask as a boolean attn_mask): a yardstick,
    timed on pre-gathered inputs."""
    q = kw["q"]
    R, nh, d = q.shape
    bs, nkv = world.bs, world.nkv
    tables = kw["block_tables"].long()
    B = tables.shape[1]
    S = B * bs
    k = world.k[tables].permute(0, 3, 1, 2, 4).reshape(R, nkv, S, d)
    v = world.v[tables].permute(0, 3, 1, 2, 4).reshape(R, nkv, S, d)
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


def rows_rel_err(torch, got, want):
    """Largest over rows of max|got - want| / max|want| (rows on the last
    axis), computed on ``want``'s device."""
    want = torch.as_tensor(want).float()
    got = torch.as_tensor(got).to(want.device).float()
    return float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max())


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def engine_phase(torch, dev, K, widths=None, engine_config=None, profile=False):
    """The serving path, counted. ``widths``/``engine_config`` shrink the
    model and the engine for a rehearsal on the CPU; the card run uses
    neither, and serves the preset at its full depth."""
    import numpy as np

    from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import (
        InferenceEngineV2,
        serving_benchmark,
    )
    from deepspeed_tpu_torch.models import transformer as T

    t0 = time.perf_counter()
    cfg = T.get_config(MODEL, **(widths or {}))
    rec = {"phase": "engine", "model": MODEL, "n_layers": cfg.n_layers}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = T.init_params(cfg, gen, dev)
    rc = RaggedInferenceEngineConfig.from_dict(engine_config or ENGINE_CONFIG)
    eng = InferenceEngineV2(cfg, params, rc, device=dev.type)
    if dev.type == "cuda" and eng.paged_attention_impl != "kernel":
        raise AssertionError(f"paged_attention_impl resolved to {eng.paged_attention_impl}")
    _sync(torch, dev)
    rec["params"] = T.num_params(eng.params)
    rec["setup_seconds"] = time.perf_counter() - t0
    L = cfg.n_layers

    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 512, size=32)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32) for n in lens]

    # ---- the main path, counted: prefill through step(), two single
    # decode steps, one fused round
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    t0 = time.perf_counter()
    for uid, p in enumerate(prompts):
        eng.scheduler.submit(uid, p)
    prefill_logits = {}
    split_steps = 0
    while eng.scheduler.has_pending():
        prefill_logits.update(eng.step())
        split_steps += 1
        if eng.last_scheduled_tokens == 0:
            raise AssertionError("prefill stalled: nothing schedulable")
    _sync(torch, dev)
    rec["prefill_seconds"] = time.perf_counter() - t0
    rec["prefill_steps"] = split_steps
    if sorted(prefill_logits) != list(range(32)):
        raise AssertionError(f"prefill completed {len(prefill_logits)} of 32 prompts")
    seqs = {uid: list(p) for uid, p in enumerate(prompts)}
    decode_logits = []
    last = prefill_logits
    for _ in range(2):
        for uid, lg in last.items():
            tok = int(np.argmax(lg))
            seqs[uid].append(tok)
            eng.scheduler.feedback(uid, tok)
        last = eng.step()
        split_steps += 1
        decode_logits.append(last)
    for uid, lg in last.items():
        tok = int(np.argmax(lg))
        seqs[uid].append(tok)
        eng.scheduler.feedback(uid, tok)
    # the round's logits as the engine hands them to its sampler (a
    # reference kept, no copy and no launch), to hold every round step
    # against the plain forward
    round_logits = []
    sample = eng._sample

    def keep_logits(logits, *a, **k):
        round_logits.append(logits)
        return sample(logits, *a, **k)

    eng._sample = keep_logits
    t0 = time.perf_counter()
    rounds = eng.decode_round(64)
    _sync(torch, dev)
    rec["round_seconds"] = time.perf_counter() - t0
    del eng._sample  # back to the class's method
    rec["round_tok_s"] = 32 * 64 / rec["round_seconds"]
    launches = K.counts()
    rec["launches"] = launches
    fwd_steps = split_steps + 64
    expected = {"rms_norm_fwd": (2 * L + 1) * fwd_steps, "paged_decode": L * fwd_steps}
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

    # ---- the plain forward (plain RMSNorm, dense attention: no kernel) on
    # the same tokens, for every slot
    round_logits = torch.stack(round_logits)  # [64, R, V]; row i is the round's i-th uid
    errs = {"prefill": [], "decode": [], "round": [], "shifted": []}
    agree = []
    for row, uid in enumerate(rounds):
        got_tok = torch.as_tensor(np.asarray(rounds[uid], np.int64), device=dev)
        mine = round_logits[:, row].float()  # [64, V]
        if not bool((mine.argmax(dim=-1) == got_tok).all()):
            raise AssertionError(f"uid {uid}: round tokens are not the argmax of its logits")
        full = seqs[uid] + [int(t) for t in rounds[uid]]
        n_p = len(prompts[uid])
        toks = torch.as_tensor(np.asarray(full, np.int64), device=dev)[None]
        with torch.no_grad():
            ref = T.forward(eng.params, toks, cfg)[0][0].float()  # [s, V]
        if not bool(torch.isfinite(ref).all()):
            raise AssertionError("plain forward gave non-finite logits")
        errs["prefill"].append(rows_rel_err(torch, prefill_logits[uid], ref[n_p - 1]))
        for k, dl in enumerate(decode_logits):
            errs["decode"].append(rows_rel_err(torch, dl[uid], ref[n_p + k]))
        # the round: seqs[uid] ends with the round's input token
        base = len(seqs[uid]) - 1
        rows = ref[base : base + 64]
        errs["round"].append(rows_rel_err(torch, mine, rows))
        # negative control: the same comparison one position off
        errs["shifted"].append(rows_rel_err(torch, prefill_logits[uid], ref[n_p - 2]))
        agree.append(float((rows.argmax(dim=-1) == got_tok).float().mean()))
    rec["logit_rel_err"] = {k: max(v) for k, v in errs.items()}
    rec["logit_rel_err"]["shifted"] = min(errs["shifted"])
    rec["logit_rows_checked"] = {k: len(v) * (64 if k == "round" else 1) for k, v in errs.items()}
    rec["logit_rtol"] = LOGIT_RTOL
    # exact agreement with the reference's argmax is reported only: near-ties flip under bf16
    rec["round_argmax_agreement"] = min(agree)
    worst = max(rec["logit_rel_err"][k] for k in ("prefill", "decode", "round"))
    if worst > LOGIT_RTOL:
        raise AssertionError(f"engine logits off the plain forward: {rec['logit_rel_err']}")
    if rec["logit_rel_err"]["shifted"] <= LOGIT_RTOL:
        raise AssertionError("negative control passed: the logit check cannot tell positions apart")
    for uid in list(eng.scheduler.running_uids()):
        eng.scheduler.finish(uid)
    del ref, round_logits

    # ---- serving throughput (generate: prefill + fused rounds)
    t0 = time.perf_counter()
    rec["gen_tok_s"] = serving_benchmark(eng, n_seq=32, max_new=64, repeats=2)
    rec["serving_seconds"] = time.perf_counter() - t0
    rec["peak_mem_gb_serving"] = (torch.cuda.max_memory_allocated() / 1e9
                                   if dev.type == "cuda" else None)
    if profile:
        rec["profile"] = profile_engine(torch, eng, rng, cfg.vocab_size)
    return rec, launches


def profile_engine(torch, eng, rng, vocab, steps=8):
    """torch.profiler over one split step with 32 decode rows and one fused
    round of ``steps`` tokens: device time by kernel name, device busy
    share of the wall time. Opt-in (``--profile``)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for uid in range(32):
        eng.scheduler.submit(1000 + uid, rng.integers(0, vocab, size=int(rng.integers(64, 512))))
    last = {}
    while eng.scheduler.has_pending():
        last.update(eng.step())
    for uid, lg in last.items():
        eng.scheduler.feedback(uid, int(np.argmax(lg)))
    torch.cuda.synchronize()
    out = {}
    for name, fn in (("split_step_32_decode_rows", eng.step),
                     (f"decode_round_{steps}", lambda: eng.decode_round(steps))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if name.startswith("split"):
            for uid, lg in res.items():
                eng.scheduler.feedback(uid, int(np.argmax(lg)))
        rows = []
        for ev in prof.key_averages():
            # device-side kernel events only: op rows carry their kernels'
            # time too and would count it twice
            if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
                continue
            rows.append((ev.key, ev.self_device_time_total / 1e3, ev.count))
        rows.sort(key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        out[name] = {
            "wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms if rows else None,
            "device_idle_share": (1 - busy_ms / (wall * 1e3)) if rows else None,
            "top": [{"kernel": k[:90], "ms": ms, "count": n} for k, ms, n in rows[:12]],
        }
    for uid in list(eng.scheduler.running_uids()):
        eng.scheduler.finish(uid)
    return out

# ---------------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the engine phase, a torch.profiler breakdown of a split "
                         "step and a decode round")
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
    emit({"phase": "setup", "card": card, "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "builds": [{k: b[k] for k in ("name", "seconds")} for b in builds],
          "seconds": time.perf_counter() - t0})
    for b in builds:
        for line in b["ptxas"].splitlines():
            if "ptxas info" in line and ("registers" in line or "spill" in line):
                print(f"  [{b['name']}] {line.strip()}", flush=True)

    t0 = time.perf_counter()
    records = {
        "rms_norm_fwd": kernel_rms_norm(torch, dev),
        "paged_decode": kernel_paged_decode(torch, dev, seed=SEED),
    }
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "card": card, "seconds": time.perf_counter() - t0,
          "kernels": list(records.values())})

    t0 = time.perf_counter()
    rec, launches = engine_phase(torch, dev, K, profile=args.profile)
    rec["card"] = card
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    if set(launches) != set(K.KERNELS) or min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path was not launched: {launches}")

    kernels_line = []
    for name, k in K.KERNELS.items():
        rec = records[name]
        kernels_line.append({
            "name": name, "route": "cuda",
            "source": str(k.source_path.relative_to(root)),
            "replaces": k.replaces,
            "launches": launches[name],
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "matched": True,  # check_close raised otherwise
        })
    emit({"phase": "done", "seconds": time.perf_counter() - t_all})
    emit({"kernels": kernels_line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
