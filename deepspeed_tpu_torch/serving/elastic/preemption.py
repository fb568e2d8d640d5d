"""QoS preemption: checkpoint a DECODE-state stream off its engine.

Copy of ``deepspeed_tpu/serving/elastic/preemption.py``.

A preemption checkpoint is a :class:`KVHandoff` — the same snapshot a
prefill worker exports — but built from a DIFFERENT scheduler state. A
decode row in steady state carries its *pending* sampled token twice:
``seq.tokens`` already includes it (``feedback`` appended it) while
``seen_tokens`` — the KV write cursor — does not (its KV is written by the
NEXT step). ``export_sequence`` snapshots mid-prefill state where the two
agree, so preemption builds the handoff by hand: strip the pending token
from the history (``scheduler.adopt`` on resume demands
``seen_tokens == len(tokens)`` and re-appends it through the normal
feedback path), and export exactly the blocks the written KV covers.

Resume IS ``import_sequence``: seed from the target's trie/host tier,
chunked-scatter the uncovered payload, ``adopt()`` the pending token.
Sampling keys are content-addressed by (seed, uid, position), so the
resumed stream is bit-identical to one that was never preempted.

The victim's full blocks also spill through the host-tier spill path
(``chain_hashes`` keys, one block per entry) — best-effort: a resume on
the same replica then seeds from host memory instead of re-importing the
checkpoint payload, and the prefix stays warm for other requests. The
checkpoint always retains the full payload, so correctness never depends
on the tier (it may evict anything at any time).
"""

from typing import Optional

import numpy as np

from deepspeed_tpu_torch.serving.cluster.handoff import KVHandoff, import_sequence


class PreemptionError(RuntimeError):
    """The sequence is not in a preemptible state (mid-prefill, no pending
    token, or scheduler/KV cursors out of step)."""


def preemptible(engine, uid: int) -> bool:
    """True when ``uid`` is a steady-state decode row on ``engine`` (a
    pending sampled token exists and the history/cursor shapes line up).
    Caller holds the engine core's step lock."""
    seq = engine.state_manager.get_sequence(uid)
    if seq is None or seq.finished:
        return False
    pending = engine.scheduler.peek_next_token(uid)
    if pending is None:
        return False
    return (
        len(seq.tokens) >= 2
        and int(seq.tokens[-1]) == int(pending)
        and int(seq.seen_tokens) == len(seq.tokens) - 1
    )


def _spill_checkpoint(engine, tokens, payload) -> int:
    """Best-effort demotion of the checkpoint's full blocks into the
    engine's host tier (the spill path: one ``chain_hashes`` key per
    block, payload column per entry). Returns blocks spilled."""
    tier = getattr(engine, "host_tier", None)
    cache = getattr(engine.state_manager, "prefix_cache", None)
    if tier is None or cache is None or payload is None:
        return 0
    from deepspeed_tpu_torch.inference.v2.host_tier import chain_hashes

    bs = int(cache.block_size)
    n_full = min(len(tokens) // bs, cache._matchable_blocks(len(tokens)))
    if n_full <= 0:
        return 0
    keys = chain_hashes(list(tokens), bs, n_full)
    n = 0
    for i, key in enumerate(keys):
        entry = {name: np.asarray(plane[:, i])  # payload planes are already host numpy (export_kv_blocks gathered once)
                 for name, plane in payload.items()}
        if tier.put(key, entry):
            n += 1
    return n


def preempt_sequence(engine, uid: int) -> KVHandoff:
    """Checkpoint a decode-state sequence OFF ``engine``: stripped token
    history, KV cursor, pending token, and the pool payload for its block
    table. The caller releases the source sequence (freeing its blocks)
    right after — same contract as ``export_sequence``. Caller holds the
    source core's step lock."""
    seq = engine.state_manager.get_sequence(uid)
    if seq is None or seq.finished:
        raise PreemptionError(f"preempt({uid}): no live sequence")
    pending = engine.scheduler.peek_next_token(uid)
    if pending is None:
        raise PreemptionError(
            f"preempt({uid}): no pending decode token (mid-prefill rows are "
            "not preemptible)"
        )
    tokens = list(seq.tokens)
    if not tokens or int(tokens[-1]) != int(pending):
        raise PreemptionError(
            f"preempt({uid}): pending token {pending} is not the history tail"
        )
    tokens = tokens[:-1]  # adopt() re-appends it through feedback on resume
    seen = int(seq.seen_tokens)
    if seen != len(tokens):
        raise PreemptionError(
            f"preempt({uid}): KV cursor {seen} != {len(tokens)} written tokens"
        )
    blocks = [int(b) for b in seq.block_table]
    export = getattr(engine, "export_kv_blocks", None)
    payload = export(blocks) if export is not None else None
    _spill_checkpoint(engine, tokens, payload)
    return KVHandoff(
        uid=uid,
        tokens=tokens,
        seen_tokens=seen,
        pending_token=int(pending),
        n_blocks=len(blocks),
        payload=payload,
    )


def resume_sequence(engine, checkpoint: KVHandoff) -> int:
    """Re-materialize a preemption checkpoint ON ``engine`` as a RUNNING
    decode row. Delegates to the handoff importer — trie/host-tier seed,
    double-buffered chunked scatter for the uncovered tail, loud
    ``adopt()`` — because a checkpoint IS a handoff whose source happens to
    be the past. Returns payload blocks actually copied. Caller holds the
    target core's step lock."""
    return import_sequence(engine, checkpoint)
