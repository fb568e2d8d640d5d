"""Engine-agnostic scheduling/admission core.

Copy of ``deepspeed_tpu/serving/cluster/core.py``, over the port's
``InferenceEngineV2``. A port engine is unsharded (``tp_shards`` is 1,
tensor parallel is ROADMAP queue 1, item 6).

This is the single-engine ``ServingDriver`` loop body factored out of its
one-engine assumption: everything that talks to the ENGINE — KV-aware
admissibility, scheduler submission, fused/speculative/plain stepping,
capped-sequence reaping — lives here, keyed by a core instance, while
everything that talks to the REQUEST (token delivery, terminal
transitions, metrics) is delegated to an owner-provided *sink*. One
``ServingDriver`` owns one core; a ``Router`` owns many (prefill workers +
decode replicas) and multiplexes requests across them.

Sink protocol (the owner implements it; ``core`` is passed back so one
owner can serve many cores):

  * ``deliver(core, req, token, feedback=True) -> bool`` — one generated
    token landed; False when the request terminated (stop/error).
  * ``engine_failed(core, error)`` — an engine-level step failure: the
    sink fails the core's in-flight request set (per-request state is
    unknowable after a failed step).
  * ``finish_capped(core, req)`` — the scheduler force-finished the
    sequence at its block/context cap (blocks already freed).

Thread safety: each core carries a ``step_lock`` serializing engine
stepping against KV block import/export and scheduler mutation from other
threads: the port's steps write the pools in place, so an import racing a
step would interleave with its writes.
"""

import threading
import time
from typing import Dict, Optional

import torch

from deepspeed_tpu_torch.observability.tracing import get_tracer
from deepspeed_tpu_torch.serving.request import Request
from deepspeed_tpu_torch.serving.resilience.faults import get_fault_injector
from deepspeed_tpu_torch.serving.resilience.health import ReplicaHealth
from deepspeed_tpu_torch.utils.logging import logger


def engine_device_index(engine) -> Optional[int]:
    """The CUDA device index a thread driving ``engine`` must make current:
    the engine's, or (a device without an index) the one current in the
    calling thread. None for a CPU engine or a fake without a device."""
    device = getattr(engine, "device", None)
    if isinstance(device, torch.device) and device.type == "cuda":
        return device.index if device.index is not None else torch.cuda.current_device()
    return None


def run_in_engine_scope(device_index: Optional[int], fn, *args):
    """Run ``fn(*args)`` as a serving thread's body. Grad mode and the
    current CUDA device are per thread in torch: every thread that steps,
    exports, imports or warms an engine runs without autograd and on the
    engine's card, as the single-engine driver's loop does."""
    with torch.no_grad():
        if device_index is not None:
            torch.cuda.set_device(device_index)
        return fn(*args)


class EngineCore:
    """One engine's slice of the serving loop: admission accounting,
    stepping, and the request set resident on that engine."""

    def __init__(
        self,
        engine,
        name: str = "replica0",
        role: str = "both",  # "prefill" | "decode" | "both" (colocated)
        decode_steps: int = 1,
        kv_headroom: float = 0.0,
        spec_k: Optional[int] = None,
        spec_ngram: int = 3,
        proposer=None,
        metrics=None,
    ):
        self.engine = engine
        self.name = str(name)
        self.role = role
        self.decode_steps = int(decode_steps)
        self.kv_headroom = float(kv_headroom)
        self.metrics = metrics
        self.requests: Dict[int, Request] = {}  # uid -> Request resident here
        # elastic scale-down: a retired core takes no new admissions and its
        # worker thread exits once the resident set drains
        self.retired = False
        # failure detection: per-replica health state machine, the step
        # watchdog stamp (monotonic start of the step in flight, None
        # between steps — the coordinator reads it without the step lock,
        # which is the point: a wedged step never releases that lock), and
        # the step-failed flag the wrapper uses to drive note_success
        self.health = ReplicaHealth(self.name)
        self._step_failed = False
        self.step_started_at: Optional[float] = None
        # serializes engine stepping against KV import/export (both write
        # the pools) and scheduler mutation from other threads (admission,
        # cancel cleanup)
        self.step_lock = threading.RLock()
        self.kv_total = int(self._kv_cfg("num_blocks", 0))
        self.kv_info: Dict = {}
        if hasattr(engine, "kv_pool_info"):
            self.kv_info = dict(engine.kv_pool_info())
        # name the engine after the core so its dispatch/device_wait spans
        # land on this replica's row of the timeline
        if hasattr(engine, "replica_name"):
            engine.replica_name = self.name
        # per-replica tallies for the labeled /metrics gauges
        self.decode_tokens = 0
        self.handoffs_in = 0
        self.handoffs_out = 0
        # speculative decoding: spec_k=None inherits the engine config's
        # spec_k; 0 disables. Only meaningful on cores that decode.
        if spec_k is None:
            spec_k = int(getattr(getattr(engine, "config", None), "spec_k", 0) or 0)
        self.spec_k = int(spec_k)
        self.spec_ctl = None
        self.proposer = proposer
        if self.spec_k > 0 and role != "prefill" and hasattr(engine, "spec_round"):
            from deepspeed_tpu_torch.serving.spec import AdaptiveSpecController, NgramProposer

            if self.proposer is None:
                self.proposer = NgramProposer(max_ngram=max(1, int(spec_ngram)))
            self.spec_ctl = AdaptiveSpecController(self.spec_k)

    # -- engine accessors (guarded so fakes stay minimal) ----------------
    def _kv_cfg(self, name, default):
        kv = getattr(getattr(self.engine, "config", None), "kv_cache", None)
        return getattr(kv, name, default) if kv is not None else default

    def _sm_cfg(self, name, default):
        sm = getattr(getattr(self.engine, "config", None), "state_manager", None)
        return getattr(sm, name, default) if sm is not None else default

    def free_blocks(self) -> int:
        return int(getattr(self.engine.state_manager, "free_blocks", 0))

    def prefix_cache(self):
        return getattr(getattr(self.engine, "state_manager", None), "prefix_cache", None)

    def host_tier(self):
        """The engine's host-memory block tier (None when disabled or the
        engine is a fake without one)."""
        return getattr(self.engine, "host_tier", None)

    def tp_shards(self) -> int:
        """Tensor-parallel width of this engine (1 for the port's unsharded
        engine and minimal fakes). A tp=N replica spreads each sequence's
        KV and attention across N devices, so placement treats its pool
        and compute as N-way aggregated capacity."""
        return int(getattr(self.engine, "_tp", 1) or 1)

    # -- tiered prefix store (PrefixDirectory bridge) ---------------------
    def prefix_hashes(self) -> set:
        """Chain hashes this replica can seed a prefix from — device trie
        ∪ host tier — i.e. its PrefixDirectory advertisement. Caller holds
        ``step_lock`` (the trie mutates under stepping)."""
        out = set()
        cache = self.prefix_cache()
        if cache is not None and hasattr(cache, "prefix_hashes"):
            out |= cache.prefix_hashes()
        tier = self.host_tier()
        if tier is not None:
            out |= set(tier.keys())
        return out

    def prefix_chain(self, tokens) -> list:
        """Chain hashes of the full prompt blocks a seed could cover
        (capped one token short: prefill must still produce next-token
        logits). Empty without a prefix cache."""
        cache = self.prefix_cache()
        if cache is None or not hasattr(cache, "_matchable_blocks"):
            return []
        from deepspeed_tpu_torch.inference.v2.host_tier import chain_hashes

        toks = list(tokens)
        return chain_hashes(toks, cache.block_size,
                            cache._matchable_blocks(len(toks)))

    def prefix_coverage(self, keys) -> int:
        """Contiguous run from the start of ``keys`` this replica holds
        (device or host tier). Pure probe — no refs, no LRU touches —
        used by placement affinity and the router's peer-pull planner."""
        if not keys:
            return 0
        held = self.prefix_hashes()
        n = 0
        for key in keys:
            if key not in held:
                break
            n += 1
        return n

    def _inc(self, name: str, delta: float = 1) -> None:
        if self.metrics is not None:
            self.metrics.inc(name, delta)

    # -- admission accounting --------------------------------------------
    def blocks_needed(self, req: Request, prefill_only: bool = False) -> int:
        """Blocks this request would CHARGE against ``free_blocks``: its
        full token budget (prompt only for a pure prefill worker — the
        handoff frees the worker's blocks right after the first token),
        minus blocks a prefix-cache hit would seed for free."""
        bs = int(self._kv_cfg("block_size", 1))
        cap = int(self._kv_cfg("max_blocks_per_seq", 1 << 30))
        total = len(req.prompt_tokens)
        if not prefill_only:
            total += req.params.max_new_tokens
        need = min((total + bs - 1) // bs, cap)
        cache = self.prefix_cache()
        if cache is not None:
            need = max(0, need - cache.peek(req.prompt_tokens))
        return need

    def committed_blocks(self) -> int:
        """Blocks the resident requests will eventually hold if every one
        runs to its full token budget. Admission must charge THIS, not the
        current holdings: a resident that has only prefilled so far still
        owns its future growth, and seating a second request into that
        headroom can exhaust the pool mid-decode with neither sequence
        terminal — nothing ever frees a block and both streams stall."""
        bs = int(self._kv_cfg("block_size", 1))
        cap = int(self._kv_cfg("max_blocks_per_seq", 1 << 30))
        total = 0
        for r in self.requests.values():
            need = (len(r.prompt_tokens) + r.params.max_new_tokens + bs - 1) // bs
            total += min(need, cap)
        return total

    def admissible(
        self,
        req: Request,
        reserved_blocks: int = 0,
        reserved_seqs: int = 0,
        prefill_only: bool = False,
    ) -> bool:
        """KV-aware admission gate for THIS engine. ``reserved_*`` are
        blocks/sequence-slots a router has promised to in-flight handoffs
        that have not yet materialized here."""
        max_tracked = self._sm_cfg("max_tracked_sequences", None)
        occupied = len(self.requests) + int(reserved_seqs)
        if max_tracked is not None and occupied >= int(max_tracked):
            return False
        free = self.free_blocks() - int(reserved_blocks)
        cache = self.prefix_cache()
        if cache is not None:
            # cached blocks no sequence shares are reclaimable on demand
            # (extend() evicts LRU when the pool runs dry) — a pool full of
            # idle cache must not read as "no room". Blocks this request
            # would HIT are excluded: they'll be shared, not evicted (and
            # blocks_needed already discounts them).
            idle = int(cache.stats()["cached_blocks_idle"])
            free += max(0, idle - cache.peek(req.prompt_tokens))
        if not prefill_only:
            # residents' unrealized growth still claims pool space (a pure
            # prefill worker is exempt: its blocks free at the handoff)
            free = min(free, self.kv_total - self.committed_blocks()
                       - int(reserved_blocks))
        need = self.blocks_needed(req, prefill_only=prefill_only)
        if not occupied:
            # empty engine: headroom gating would starve a request larger
            # than the reserve forever — admit whatever fits outright
            return need <= free
        headroom = int(self.kv_headroom * self.kv_total)
        return need + headroom <= free

    def admit(self, req: Request) -> None:
        """Hand the request to this engine's scheduler (raises on late
        inadmissibility) and make it resident here. Caller holds
        ``step_lock``. Submits ``engine_prompt`` (== ``prompt_tokens``
        except while a replay recovery is in flight)."""
        self.engine.scheduler.submit(req.uid, req.engine_prompt)
        self.requests[req.uid] = req

    def release(self, uid: int, scheduler_done: bool = False) -> None:
        """Detach a request from this engine: drop scheduler state (frees
        KV blocks + pending chunks) and spec history. Caller holds
        ``step_lock``."""
        if not scheduler_done:
            try:
                self.engine.scheduler.finish(uid)
            except Exception as e:  # never let cleanup kill the loop
                logger.warning(f"serving[{self.name}]: finish({uid}) raised: {e}")
        self.requests.pop(uid, None)
        if self.spec_ctl is not None:
            self.spec_ctl.forget(uid)

    def has_work(self) -> bool:
        return self.engine.scheduler.has_work()

    # -- stepping --------------------------------------------------------
    def _reap_capped(self, sink) -> None:
        """Sequences the scheduler force-finished at the block/context cap:
        their blocks are already freed — report a length_cap finish."""
        capped = set()
        sched_drain = getattr(self.engine.scheduler, "drain_capped", None)
        if sched_drain is not None:
            capped |= sched_drain()
        last = getattr(self.engine, "last_capped", None)
        if last:
            capped |= set(last)
            self.engine.last_capped = set()
        for uid in capped:
            req = self.requests.get(uid)
            if req is not None:
                sink.finish_capped(self, req)

    def _build_drafts(self) -> Dict[int, list]:
        """Per-uid draft tokens for the next verify round. Resolves the
        per-request SpecParams against the core's spec_k, asks the
        adaptive controller for this round's draft length (0 during
        fallback cooldown), and caps drafts by the request's remaining
        token budget — a draft past max_new_tokens could only be cut."""
        drafts: Dict[int, list] = {}
        for uid in self.engine.scheduler.running_uids():
            req = self.requests.get(uid)
            k_cap = self.spec_k
            if req is not None and req.params.spec is not None:
                if not req.params.spec.enabled:
                    drafts[uid] = []
                    continue
                k_cap = min(k_cap, req.params.spec.k)
            k = self.spec_ctl.current_k(uid, k_cap)
            if req is not None:
                k = min(k, max(0, req.remaining_tokens - 1))
            if k < 1:
                drafts[uid] = []
                continue
            seq = self.engine.state_manager.get_sequence(uid)
            hist = seq.tokens if seq is not None else []
            drafts[uid] = list(self.proposer.propose(hist, k))
        return drafts

    def _trace_round(self, tr, name: str, t0: float, t1: float,
                     uids, args: Dict) -> None:
        """Record one step round on this core's engine track AND mirror it
        into every participating traced request's tree (parented on the
        request's current lifecycle phase), so a single request timeline
        shows exactly which rounds moved it."""
        tr.complete(name, t0, t1, track=self.name, args=args)
        for uid in uids:
            req = self.requests.get(uid)
            if req is not None and req.trace is not None:
                tr.complete(name, t0, t1, key=uid, parent=req.trace.phase)

    def _spec_step(self, sink, sched) -> bool:
        """One speculative verify round: propose drafts, verify K+1 tokens
        per row in one forward, deliver the accepted burst. Returns True
        when the round ran (progress or not); the caller falls through to
        plain stepping when no row drafted anything."""
        tr = get_tracer()
        if tr.enabled:
            t0 = tr.now()
            drafts = self._build_drafts()
            tr.complete("spec.draft", t0, track=self.name, args={
                "rows": len(drafts),
                "draft_tokens": sum(len(d) for d in drafts.values()),
            })
        else:
            drafts = self._build_drafts()
        if not any(drafts.values()):
            return False  # nothing to verify: fused decode round is cheaper
        t0 = tr.now() if tr.enabled else 0.0
        round_res = self.engine.spec_round(self.spec_k, drafts=drafts)
        if not round_res:
            # every row was skipped (context/block caps, pool exhaustion):
            # the per-step path knows how to cap/stall them
            return False
        self._inc("engine_steps_total")
        per_uid = dict(self.engine.last_spec.get("per_uid", {}))
        if tr.enabled:
            last = getattr(self.engine, "last_spec", None) or {}
            self._trace_round(tr, "round.verify", t0, tr.now(), round_res, {
                "rows": len(round_res),
                "drafted": int(last.get("drafted", 0)),
                "accepted": int(last.get("accepted", 0)),
            })
        if self.metrics is not None:
            self.metrics.observe_spec_round(per_uid)
        for uid, (drafted, accepted) in per_uid.items():
            self.spec_ctl.update(uid, drafted, accepted)
        for uid, toks in round_res.items():
            req = self.requests.get(uid)
            if req is None:
                sched.finish(uid)
                continue
            for tok in toks:
                # apply_spec_round already advanced the scheduler: deliver
                # without feedback, exactly like fused decode rounds
                if not sink.deliver(self, req, int(tok), feedback=False):
                    break
        self._reap_capped(sink)
        return True

    def step_once(self, sink) -> bool:
        """One engine step (or fused decode / speculative verify round).
        Returns True if any token landed / request advanced (progress).
        Caller holds ``step_lock``.

        Wraps the step in the watchdog window — ``step_started_at`` is
        the monotonic stamp the coordinator's hung-step scan reads
        WITHOUT the step lock (a wedged step never releases it) — and
        feeds the health state machine: a clean step resets the error
        streak; the failure handler advances it before telling the
        sink."""
        self._step_failed = False
        self.step_started_at = time.monotonic()
        try:
            return self._step_locked(sink)
        finally:
            self.step_started_at = None
            if not self._step_failed:
                self.health.note_success()

    def _step_locked(self, sink) -> bool:
        sched = self.engine.scheduler
        use_spec = (
            self.spec_ctl is not None
            and not sched.has_pending()
            and bool(sched.running_uids())
        )
        use_round = (
            self.decode_steps > 1
            and hasattr(self.engine, "decode_round")
            and not sched.has_pending()
            and bool(sched.running_uids())
        )
        progress = False
        tr = get_tracer()
        try:
            faults = get_fault_injector()
            if faults.enabled:
                # chaos seam: a hang spec sleeps here INSIDE the watchdog
                # window (step_started_at is set); an error spec raises
                # into the engine-failure handler below, exactly like a
                # real step fault
                faults.check("step.hang", replica=self.name)
                faults.check("engine.step", replica=self.name)
            if use_spec and self._spec_step(sink, sched):
                return True
            if use_round:
                t0 = tr.now() if tr.enabled else 0.0
                round_res = self.engine.decode_round(self.decode_steps)
                if round_res:
                    self._inc("engine_steps_total")
                    if tr.enabled:
                        self._trace_round(tr, "round.fused", t0, tr.now(),
                                          round_res, {
                            "rows": len(round_res),
                            "steps": self.decode_steps,
                            "tokens": sum(len(t) for t in round_res.values()),
                        })
                    for uid, toks in round_res.items():
                        req = self.requests.get(uid)
                        if req is None:
                            sched.finish(uid)
                            continue
                        for tok in toks:
                            progress = True
                            if not sink.deliver(self, req, int(tok), feedback=False):
                                break
                    self._reap_capped(sink)
                    return progress
            t0 = tr.now() if tr.enabled else 0.0
            results = self.engine.step_tokens()
            self._inc("engine_steps_total")
            if tr.enabled:
                self._trace_round(tr, "step.split", t0, tr.now(), results, {
                    "rows": len(results),
                    "tokens": int(getattr(self.engine,
                                          "last_scheduled_tokens", 0) or 0),
                })
        except Exception as e:
            # engine-level failure: per-request state is unknowable, so the
            # in-flight set fails (or, under a resilience-enabled router,
            # is recovered by replay) — but the owner survives
            err = f"{type(e).__name__}: {e}"
            logger.warning(f"serving[{self.name}]: engine step failed: {err}")
            self._step_failed = True
            # advance health BEFORE the sink runs so engine_failed sees the
            # post-transition state (quarantine side-effects fire once)
            self.health.note_error(err)
            sink.engine_failed(self, err)
            cache = self.prefix_cache()
            if cache is not None:
                # the failed step may have left cached blocks' device KV
                # unwritten/garbage — a later hit would serve corrupt
                # context. Drop the whole trie (all actives just finished,
                # so every cached block frees outright).
                try:
                    cache.clear()
                except Exception as ce:
                    logger.warning(
                        f"serving[{self.name}]: prefix-cache clear failed: {ce}"
                    )
            return True
        for uid, tok in results.items():
            req = self.requests.get(uid)
            if req is None:
                # finished between steps (cancel/timeout): drop the token,
                # make sure scheduler state is gone
                sched.finish(uid)
                continue
            progress = True
            sink.deliver(self, req, int(tok))
        self._reap_capped(sink)
        return progress

    # -- probation probes -------------------------------------------------
    def probe(self, lock_timeout_s: float = 0.5) -> None:
        """Synthetic probation probe; raises on failure. A probe cannot
        lie about a wedged replica: it fails outright if a step is still
        in flight or the step lock can't be acquired quickly (a hung step
        owns it forever). Otherwise it runs one empty engine step through
        the fault seam — so a scheduled ``engine.step`` fault at probe
        time deterministically fails the probe, and a real engine that
        can't even step an empty batch stays quarantined."""
        if self.step_started_at is not None:
            raise RuntimeError(f"probe({self.name}): a step is still in flight")
        if not self.step_lock.acquire(timeout=lock_timeout_s):
            raise RuntimeError(f"probe({self.name}): step lock unavailable")
        try:
            faults = get_fault_injector()
            if faults.enabled:
                faults.check("engine.step", replica=self.name)
            self.engine.step_tokens()
        finally:
            self.step_lock.release()

    def kv_endpoint_address(self):
        """``(host, port)`` of this engine's remote-KV listener, or None
        when no ``KVEndpoint`` is attached (non-remote transports). Health
        and placement metadata carry this so a cross-process importer can
        discover where to FETCH a staged handoff from."""
        ep = getattr(self.engine, "_kv_endpoint", None)
        return ep.address if ep is not None else None

    def kv_endpoint_stats(self) -> Dict:
        """Stage/transfer counters of the attached ``KVEndpoint`` ({} when
        none). Health metadata goes through this instead of reaching into
        ``engine._kv_endpoint`` so remote handles (no local engine) can
        answer with their agent-reported snapshot."""
        ep = getattr(self.engine, "_kv_endpoint", None)
        return dict(ep.stats()) if ep is not None else {}

    # -- observability ---------------------------------------------------
    def replica_stats(self) -> Dict[str, float]:
        """Per-replica gauge snapshot for the labeled /metrics samples."""
        free = self.free_blocks()
        stats = {
            "kv_free_blocks": free,
            "kv_total_blocks": self.kv_total,
            "kv_blocks_in_use": max(0, self.kv_total - free),
            "active_requests": len(self.requests),
            # tensor-parallel width of the engine (1 = unsharded):
            # placement scoring divides KV/compute pressure by this, and
            # the /metrics label row proves WHICH replicas are tp>1
            "tp_shards": self.tp_shards(),
            "decode_tokens_total": self.decode_tokens,
            "handoffs_in_total": self.handoffs_in,
            "handoffs_out_total": self.handoffs_out,
        }
        alloc_stats = getattr(self.engine.state_manager, "alloc_stats", None)
        if alloc_stats is not None:
            stats["kv_blocks_shared"] = alloc_stats()["shared"]
        tier = self.host_tier()
        if tier is not None:
            t = tier.stats()
            stats["kv_host_tier_bytes"] = t["bytes"]
            stats["kv_host_tier_blocks"] = t["blocks"]
        return stats
