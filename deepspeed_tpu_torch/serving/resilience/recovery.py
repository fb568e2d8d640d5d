"""Rebuilding in-flight decodes off a failed replica.

Copy of ``deepspeed_tpu/serving/resilience/recovery.py``.

Two recovery routes, picked per request by :func:`plan_recovery`:

**Checkpoint** — when the failed replica's pool is still readable (the
worker thread crashed *between* steps, or the router detached the
replica administratively) and the row is in steady decode state, reuse
the preemption export verbatim: strip the pending token, export
the written-KV blocks, and let the normal resume path re-materialize the
row on a survivor. Nothing is recomputed; the stream continues from its
exact KV.

**Replay** — when the pool state is unknowable (the step itself raised,
or the step wedged and its thread still owns the lock), re-derive the
stream from its token history instead. The request is re-queued with
``prompt' = prompt + generated`` as its *engine* prompt: prefill over
prompt' rides whatever trie/host-tier prefix coverage survived (often
most of it — the dead replica's spills and the peer directory are both
consulted by ``seed_from_cache``), and the first token sampled at
position ``len(prompt')`` is exactly the next token of the original
stream, because ``sampling.row_keys`` folds (seed, uid, absolute
position) — never batch shape, chunking, or cache hits. Delivered
tokens are delivered once: the stream object keeps its history and
recovery only appends.

Both routes preserve bit-identity (greedy and seeded, bf16 and int8 KV);
the checkpoint route just skips recompute. Block accounting needs no
special case under replay: ``len(prompt') + remaining_new == len(prompt)
+ max_new``, the same ceiling the original admission reserved.
"""

import logging
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["replay_prompt", "plan_recovery"]


def replay_prompt(req) -> np.ndarray:
    """The engine-side prompt for replay recovery: original prompt plus
    every token already delivered on the stream."""
    prompt = np.asarray(req.prompt_tokens, dtype=np.int32)
    if not req.generated:
        return prompt
    return np.concatenate(
        [prompt, np.asarray(list(req.generated), dtype=np.int32)]
    )


def plan_recovery(core, req, pool_readable: bool) -> Tuple[str, Optional[object]]:
    """Decide how to rebuild ``req`` off failed replica ``core``.

    Returns one of ``("checkpoint", KVHandoff)``, ``("replay", prompt)``,
    ``("fail", reason)``. Caller holds ``core.step_lock`` when
    ``pool_readable`` is True (checkpoint export reads the pool); a
    hung replica's lock is unobtainable, so its caller passes False and
    never touches the pool.
    """
    # function-scope import: handoff.py (which preemption imports) itself
    # imports the fault seam from this package — a module-scope import
    # here would close that cycle during package init
    from deepspeed_tpu_torch.serving.elastic.preemption import (
        preempt_sequence, preemptible)

    if req.is_terminal:
        return ("fail", "terminal")
    if pool_readable:
        try:
            if preemptible(core.engine, req.uid):
                ho = preempt_sequence(core.engine, req.uid)
                return ("checkpoint", ho)
        except Exception as e:
            logger.warning(
                "recovery: checkpoint export of uid=%d off %s failed (%s); "
                "falling back to replay", req.uid, core.name, e,
            )
    toks = replay_prompt(req)
    remaining = req.params.max_new_tokens - len(req.generated)
    if remaining <= 0:
        # everything was already delivered; the stream just needs finishing
        return ("fail", "complete")
    check = getattr(core.engine.state_manager, "check_admissible", None)
    if check is not None:
        try:
            # pure config arithmetic (no pool state), so safe to consult
            # even for a hung replica whose step lock is unobtainable;
            # len(toks) + remaining == len(prompt) + max_new, the same
            # ceiling original admission already passed — this guards the
            # invariant, it should never fire
            check(len(toks) + remaining)
        except ValueError as e:
            return ("fail", f"replay over max_context: {e}")
    return ("replay", toks)
