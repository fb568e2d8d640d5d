"""Continuous-batching scheduler (Dynamic SplitFuse analogue).

Reference: the FastGen scheduling policy (inference/v2 blogs + MII): each
engine step packs a token budget (``max_ragged_batch_size``) with
  1. one next-token per running (decode) sequence, then
  2. chunks of pending prompts (prefill), splitting long prompts across
     steps — the "split" — and fusing prompt chunks with decode tokens in
     one batch — the "fuse".

TPU adaptation: the packed batch is padded to static shapes
(max_ragged_sequence_count rows × per-row token buckets) so every engine
step hits a small set of compiled programs.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class RaggedBatch:
    """One engine step's work: for each row, a (uid, tokens, start_pos) unit."""

    uids: List[int]
    tokens: List[np.ndarray]  # per-row new tokens
    start_positions: List[int]  # first position of those tokens in the sequence
    is_prompt_chunk: List[bool]  # True if more of this prompt remains after the step
    is_decode: List[bool] = field(default_factory=list)  # row came from _running

    @property
    def total_tokens(self):
        return sum(len(t) for t in self.tokens)

    def __len__(self):
        return len(self.uids)


class RaggedScheduler:
    """Tracks pending prompt queues + running sequences and emits RaggedBatches.

    ``prompt_chunk``/``max_prompt_chunks`` bound the prompt side of a batch
    to a fixed grid (≤ max_prompt_chunks rows of ≤ prompt_chunk tokens) so
    the engine's split-phase program compiles to a handful of shapes —
    the static-shape re-think of Dynamic SplitFuse's arbitrary packing."""

    def __init__(self, config, manager, prompt_chunk: int = 0, max_prompt_chunks: int = 0):
        self._config = config
        self._mgr = manager
        budget = config.max_ragged_batch_size
        self.prompt_chunk = int(prompt_chunk) or min(512, budget)
        self.max_prompt_chunks = int(max_prompt_chunks) or max(1, budget // self.prompt_chunk)
        self._pending: List[Tuple[int, np.ndarray]] = []  # (uid, remaining prompt)
        self._running: List[int] = []  # uids with a sampled next token to feed
        self._next_token: Dict[int, int] = {}
        # uids force-finished because they hit max_context / max_blocks_per_seq
        # (the decode analogue of a max-length stop); cleared on re-submit
        self.capped: set = set()

    def submit(self, uid: int, prompt_tokens) -> None:
        toks = np.asarray(prompt_tokens, np.int32).reshape(-1)
        # Liveness guard: reject sequences that could never be scheduled —
        # otherwise next_batch() returns None forever while has_work() stays
        # True and callers busy-loop (enforces StateManagerConfig.max_context
        # at submit, per reference max-length admission). Totals include any
        # tokens the uid already holds (continuation submits).
        if len(toks) == 0:
            raise ValueError("empty prompt: nothing to schedule")
        existing = self._mgr.get_sequence(uid)
        if existing is not None and existing.finished:
            # Resubmit of a finish()ed uid whose state somehow survived the
            # flush: extending it would replay the stale seen_tokens into
            # start positions and feedback() would drop tokens forever
            # (finished=True). Start fresh instead.
            self.finish(uid)
            existing = None
        prior = len(existing.tokens) if existing is not None else 0
        total = prior + len(toks)
        if total > self._config.max_context:
            raise ValueError(
                f"sequence would reach {total} tokens, exceeding max_context="
                f"{self._config.max_context}"
            )
        self._mgr.check_admissible(total)
        seq = self._mgr.get_or_create_sequence(uid)
        fresh = not seq.tokens and seq.seen_tokens == 0 and not seq.block_table
        seq.tokens.extend(int(t) for t in toks)
        # Continuation while a decode token is outstanding: fold the pending
        # sampled token (already in seq.tokens via feedback()) into this
        # prompt chunk — otherwise next_batch() would emit a decode row AND a
        # prompt row at the same start position, double-writing the KV cache.
        if uid in self._running:
            self._running.remove(uid)
            pending = self._next_token.pop(uid, None)
            if pending is not None:
                toks = np.concatenate([np.asarray([pending], np.int32), toks])
        self.capped.discard(uid)  # a fresh submit supersedes old capped state
        seed = getattr(self._mgr, "seed_from_cache", None)
        if fresh and seed is not None:
            # Prefix-cache consult (no-op when the cache is off): a hit
            # seeds the block table with shared, already-populated blocks
            # and prefill starts at the first uncached block boundary.
            # With a host tier, the seed also covers host-resident blocks
            # (re-imported, not recomputed), so the chunk budget below is
            # charged only for the truly-cold tail of the prompt.
            n_cached = seed(seq, toks)
            if n_cached:
                toks = toks[n_cached:]
        self._pending.append((uid, toks))

    def feedback(self, uid: int, sampled_token: int) -> None:
        """Engine reports the sampled next token for a running sequence."""
        seq = self._mgr.get_sequence(uid)
        if seq is None or seq.finished:
            return
        seq.tokens.append(int(sampled_token))
        self._next_token[uid] = int(sampled_token)
        if uid not in self._running:
            self._running.append(uid)

    def adopt(self, uid: int, pending_token: int) -> None:
        """Resume an imported (cross-engine KV-handoff) sequence as
        RUNNING: the importer already materialized its state here — block
        table populated, pool KV written, ``seen_tokens`` at the handoff
        cursor — and the prefill engine's sampled first token rides the
        normal feedback path so the next step decodes it like any locally
        prefilled row. Loud failure (unlike ``feedback``'s silent drop):
        an adopt without materialized state is an importer bug."""
        seq = self._mgr.get_sequence(uid)
        if seq is None or seq.finished:
            raise ValueError(f"adopt({uid}): no live sequence to resume")
        if seq.seen_tokens != len(seq.tokens):
            raise ValueError(
                f"adopt({uid}): history/KV cursor mismatch "
                f"({len(seq.tokens)} tokens vs seen_tokens={seq.seen_tokens})"
            )
        self.feedback(uid, pending_token)

    def finish(self, uid: int) -> None:
        seq = self._mgr.get_sequence(uid)
        if seq is not None:
            seq.finished = True
        self._next_token.pop(uid, None)
        if uid in self._running:
            self._running.remove(uid)
        # Drop unscheduled prompt chunks too (cancel mid-prefill): a stale
        # pending entry would crash next_batch (its sequence is flushed) or,
        # after a resubmit of the uid, prepend the OLD prompt's remainder to
        # the new sequence.
        self._pending = [(u, r) for u, r in self._pending if u != uid]
        self._mgr.flush_sequence(uid)

    def drain_capped(self) -> set:
        """Return and clear the capped-uid set (bounds its growth in
        long-lived engines; callers accumulate if they need history)."""
        out = self.capped
        self.capped = set()
        return out

    def has_work(self) -> bool:
        return bool(self._pending or self._running)

    # -- engine-facing accessors (the decode round's bookkeeping runs through
    # these instead of reaching into privates — round-4 advisor finding) ----
    def has_pending(self) -> bool:
        return bool(self._pending)

    def running_uids(self) -> List[int]:
        return list(self._running)

    def peek_next_token(self, uid: int) -> Optional[int]:
        return self._next_token.get(uid)

    def apply_decode_round(self, uid: int, gen_tokens) -> None:
        """Record ``gen_tokens`` greedy tokens produced for a RUNNING uid by
        a fused decode round: history, seen-token count, and the pending
        next-token all advance together."""
        seq = self._mgr.get_sequence(uid)
        if seq is None or seq.finished:
            return
        seq.tokens.extend(int(t) for t in gen_tokens)
        seq.seen_tokens += len(gen_tokens)
        self._next_token[uid] = int(gen_tokens[-1])

    def apply_spec_round(self, uid: int, gen_tokens, pre_blocks: int) -> None:
        """Record a speculative verify round's ACCEPTED tokens for a RUNNING
        uid and roll its KV write cursor back past the rejected draft:
        history/seen/pending advance by the emitted tokens exactly as in a
        fused decode round, then table blocks the round allocated beyond the
        new cursor are truncated and returned to the pool. ``pre_blocks`` is
        the row's table length BEFORE the round's extend — the truncation
        floor that keeps prefix-cache-shared (and any other pre-round)
        blocks out of the drop set."""
        seq = self._mgr.get_sequence(uid)
        if seq is None or seq.finished:
            return
        self.apply_decode_round(uid, gen_tokens)
        self._mgr.truncate_blocks(seq, seq.seen_tokens, min_keep_blocks=pre_blocks)

    def next_batch(self) -> Optional[RaggedBatch]:
        budget = self._config.max_ragged_batch_size
        max_rows = self._config.max_ragged_sequence_count
        uids, tokens, starts, chunked, decode = [], [], [], [], []

        # 1. decode tokens for running sequences (fuse)
        for uid in list(self._running):
            if len(uids) >= max_rows or budget <= 0:
                break
            seq = self._mgr.get_sequence(uid)
            tok = self._next_token.get(uid)
            if seq is None or tok is None:
                continue
            # Permanently unschedulable: context or per-sequence block cap
            # reached. Finish (max-length-style stop) instead of spinning.
            if (
                seq.seen_tokens + 1 > self._config.max_context
                or self._mgr.seq_capped(seq, 1)
            ):
                self.capped.add(uid)
                self.finish(uid)
                continue
            if not self._mgr.extend(seq, 1):
                continue  # no memory: sequence waits this step
            uids.append(uid)
            # builds from a python int, no device transfer
            tokens.append(np.asarray([tok], np.int32))  # dstpu: noqa[host-sync-in-loop]
            starts.append(seq.seen_tokens)
            chunked.append(False)
            decode.append(True)
            self._running.remove(uid)
            self._next_token.pop(uid, None)
            budget -= 1

        # 2. prompt chunks (split): at most max_prompt_chunks rows of at most
        # prompt_chunk tokens — the fixed grid the split-phase program pads to.
        # Packing order: the OLDEST pending request always gets the first
        # chunk slot (so a stream of cache-hit requests with tiny remaining
        # prefills can never starve a cold prompt out of the grid), then
        # shortest-remaining-prefill first — hit requests clear the prompt
        # phase fast, which is the whole TTFT win — with oldest-first as the
        # tie-break. ``_pending`` list order IS arrival order (submit
        # appends; the rebuild below preserves relative positions).
        entries = list(self._pending)
        order = list(range(len(entries)))
        if len(order) > 1:
            order = [0] + sorted(order[1:], key=lambda i: (len(entries[i][1]), i))
        keep: Dict[int, np.ndarray] = {}
        n_chunks = 0
        for i in order:
            uid, remaining = entries[i]
            if n_chunks >= self.max_prompt_chunks or budget <= 0:
                keep[i] = remaining
                continue
            seq = self._mgr.get_sequence(uid)
            if seq is None or seq.finished:
                continue  # finished underneath us: drop the stale chunk
            take = min(budget, self.prompt_chunk, len(remaining))
            if take == 0 or not self._mgr.extend(seq, take):
                keep[i] = remaining
                continue
            chunk, rest = remaining[:take], remaining[take:]
            uids.append(uid)
            tokens.append(chunk)
            starts.append(seq.seen_tokens)
            chunked.append(len(rest) > 0)
            decode.append(False)
            budget -= take
            n_chunks += 1
            # the step consuming this batch writes the chunk's KV, so every
            # full block below seen_tokens+take is cacheable now — any later
            # reader's program runs after this one in device order
            cache_blocks = getattr(self._mgr, "cache_prefill_blocks", None)
            if cache_blocks is not None:
                cache_blocks(seq, seq.seen_tokens + take)
            if len(rest):
                keep[i] = rest
        self._pending = [
            (entries[i][0], keep[i]) for i in range(len(entries)) if i in keep
        ]

        if not uids:
            return None
        return RaggedBatch(
            uids=uids, tokens=tokens, start_positions=starts,
            is_prompt_chunk=chunked, is_decode=decode,
        )
