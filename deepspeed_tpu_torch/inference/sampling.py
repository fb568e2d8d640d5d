"""Token sampling for the port's engines.

Counterpart of ``deepspeed_tpu/inference/sampling.py``: greedy, temperature,
top-k and top-p over [R, vocab] fp32 logits, on whatever device the logits
lie. ``filter_logits`` and greedy ``sample_tokens`` match the JAX package.

Sampled draws are content-addressed like the JAX package's ``row_keys``:
each row's key depends only on (seed, uid, position of the logits source),
so a stream does not change with batch packing, prompt chunking or the
decode_steps partitioning. The random bits come from a counter-based hash
written in torch integer ops (``utils/counter_hash.py``), not from a device
generator, so the CPU and a card draw the same bits. They are not JAX's threefry bits: sampled
streams agree within the port, not with the JAX package (ROADMAP queue 1,
item 4).

The v1 engine (``inference/engine.py``) draws a whole batch per step, as
the JAX package's ``_sample`` does with one key per step: its rows' keys
come from (seed, absolute decode step, batch row), ``step_keys``, so its
fused rounds draw what its per-step loop draws.
"""

import torch

from deepspeed_tpu_torch.utils.counter_hash import M32, fold, mix32

NEG_INF = -1e30


def filter_logits(logits, top_k: int = 0, top_p: float = 0.0):
    """Mask logits outside the top-k set and/or the top-p nucleus (the
    crossing token stays, HF convention). logits: [..., vocab] fp32."""
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)
    if top_p and top_p > 0.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = cum - probs < top_p
        kth = torch.where(keep_sorted, sorted_logits, torch.full_like(sorted_logits, NEG_INF))
        kth = kth.max(dim=-1, keepdim=True).values
        logits = torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)
    return logits


def row_keys(seed: int, uids, positions):
    """Per-row 32-bit keys (int64 tensor [R]) from (seed, uid, position)."""
    uids = torch.as_tensor(uids).to(torch.int64)
    base = mix32(torch.full_like(uids, int(seed) & M32))
    return fold(fold(base, uids), positions)


def step_keys(seed: int, step: int, batch: int, device=None):
    """The v1 engine's per-row keys (int64 [batch]) for the draw after
    decode step ``step`` (-1: the prefill's draw), from (seed, step, row)."""
    rows = torch.arange(batch, device=device, dtype=torch.int64)
    return row_keys(seed, rows, torch.full_like(rows, int(step)))


def uniform(keys, n: int):
    """[R, n] fp32 draws in (0, 1): one per (row key, column)."""
    cols = torch.arange(n, device=keys.device, dtype=torch.int64)
    bits = fold(keys[:, None], cols[None, :])
    return ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def sample_tokens(logits, keys=None, temperature=1.0, greedy: bool = True,
                  top_k: int = 0, top_p: float = 0.0, return_logprobs: bool = False):
    """One token per row. logits: [R, vocab]; keys: ``row_keys`` output
    (needed unless greedy). Sampled rows draw by Gumbel-max over the
    filtered, tempered logits. Returns int32 [R] tokens, or (tokens,
    logprobs [R]) under the post-filter, post-temperature distribution."""
    logits = logits.float()
    if greedy:
        toks = torch.argmax(logits, dim=-1)
        dist = logits
    else:
        dist = filter_logits(logits / max(float(temperature), 1e-4), top_k=top_k, top_p=top_p)
        gumbel = -torch.log(-torch.log(uniform(keys, dist.shape[-1])))
        toks = torch.argmax(dist + gumbel, dim=-1)
    toks = toks.to(torch.int32)
    if not return_logprobs:
        return toks
    logp = torch.log_softmax(dist, dim=-1)
    return toks, logp.gather(-1, toks.long()[:, None])[:, 0]


def sample_step(logits, seed: int, step: int, temperature=1.0, greedy: bool = True):
    """The v1 engine's draw (the JAX package's ``inference/engine._sample``):
    argmax when greedy, else Gumbel-max over logits / max(temperature,
    1e-4) with ``step_keys(seed, step, rows)``. logits: [b, vocab]."""
    keys = None if greedy else step_keys(seed, step, logits.shape[0], logits.device)
    return sample_tokens(logits, keys, temperature=temperature, greedy=greedy)
