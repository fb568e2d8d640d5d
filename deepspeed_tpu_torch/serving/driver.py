"""Continuous-batching serving driver.

The long-lived loop MII/FastGen runs around the engine, over the port's v2
engine (copy of ``deepspeed_tpu/serving/driver.py``): a background thread pumps ``engine.step_tokens()`` /
``engine.decode_round()`` while callers submit ``Request``s from any
thread and stream tokens out.

Responsibilities (and how each maps to the loop):

  * **Admission control** — a bounded queue plus KV-aware gating: a prompt
    is only handed to the scheduler when its full token budget
    (prompt + max_new_tokens) fits in ``BlockedAllocator.free_blocks``
    under a configurable occupancy headroom, and the tracked-sequence cap
    has room. Requests that could NEVER fit (max_context / per-seq block
    cap) are rejected at submit.
  * **Timeouts** — per-request deadlines checked every loop pass (queued
    requests time out in the queue too).
  * **Error isolation** — a failing request (stop_fn raising, bad state)
    is finished and its KV blocks freed without killing the loop; an
    engine-level step failure fails the in-flight set but the driver keeps
    serving new requests.
  * **Graceful drain/shutdown** — ``drain()`` stops admissions and runs the
    accepted set to completion; ``shutdown()`` additionally stops the loop.

The driver needs only a small engine protocol — ``scheduler`` (the
``RaggedScheduler`` API), ``state_manager`` (``free_blocks``), and
``step_tokens()`` returning ``{uid: next-token int}`` — so tests drive it
with a compute-free fake over the REAL scheduler/allocator stack.

The engine-facing half of the loop (admission accounting, stepping, spec
rounds, capped reaping) lives in ``serving.cluster.core.EngineCore``; this
driver is the one-engine (colocated prefill and decode) owner of a single
core. The JAX package's many-engine owner, ``Router``, is ROADMAP queue 1,
item 5.
"""

import threading
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.observability.events import get_event_log
from deepspeed_tpu_torch.observability.tracing import (
    begin_request_trace,
    finish_request_trace,
    get_tracer,
    mark_admitted,
    mark_first_token,
)
from deepspeed_tpu_torch.serving.metrics import ServingMetrics
from deepspeed_tpu_torch.serving.request import Request, RequestState, SamplingParams
from deepspeed_tpu_torch.serving.streaming import TokenStream
from deepspeed_tpu_torch.utils.logging import logger


class RequestRejected(Exception):
    """Submit refused (queue full, draining, shed, or the prompt can never
    fit). ``retry_after_s`` — set for backpressure rejections — is the
    server's ``Retry-After`` header, derived from the current queue drain
    rate (how long until the queue has likely made room)."""

    def __init__(self, reason: str, message: str = "",
                 retry_after_s: Optional[float] = None):
        super().__init__(message or reason)
        self.reason = reason
        self.retry_after_s = retry_after_s


class ServingDriver:
    def __init__(
        self,
        engine,
        eos_token_id: Optional[int] = None,
        max_queue: int = 128,
        kv_headroom: float = 0.0,
        default_timeout_s: Optional[float] = None,
        decode_steps: int = 1,
        poll_interval_s: float = 0.02,
        monitor=None,
        spec_k: Optional[int] = None,
        spec_ngram: int = 3,
        proposer=None,
    ):
        self.engine = engine
        self.eos_token_id = eos_token_id
        self.max_queue = int(max_queue)
        self.kv_headroom = float(kv_headroom)
        self.default_timeout_s = default_timeout_s
        self.decode_steps = int(decode_steps)
        self.poll_interval_s = float(poll_interval_s)
        self.monitor = monitor
        self.metrics = ServingMetrics()
        # the engine-facing half of the loop (admission accounting,
        # stepping, spec rounds, capped reaping) — spec_k=None inherits
        # the engine config's spec_k; 0 disables; the proposer is
        # injectable (a small-model drafter satisfies the same protocol)
        from deepspeed_tpu_torch.serving.cluster.core import EngineCore

        self.core = EngineCore(
            engine,
            name="replica0",
            role="both",
            decode_steps=self.decode_steps,
            kv_headroom=self.kv_headroom,
            spec_k=spec_k,
            spec_ngram=spec_ngram,
            proposer=proposer,
            metrics=self.metrics,
        )
        self.spec_k = self.core.spec_k
        self._spec_ctl = self.core.spec_ctl
        self.proposer = self.core.proposer

        self._cond = threading.Condition()
        self._queue: deque = deque()  # Requests awaiting admission
        self._active = self.core.requests  # uid -> Request in the scheduler
        self._cancel_uids: set = set()
        self._next_uid = 0
        self._draining = False
        self._stopping = False
        self._idle = threading.Event()
        self._idle.set()
        self._thread: Optional[threading.Thread] = None
        self._kv_total = self.core.kv_total
        self.metrics.update_kv(self._free_blocks(), self._kv_total)
        # static pool byte accounting (int8 capacity multiplier etc.) —
        # getattr-guarded so minimal fake engines in tests stay minimal
        self._kv_info = self.core.kv_info
        if self._kv_info:
            self.metrics.update_kv_pool_info(self._kv_info)
        if hasattr(self.engine, "comm_wire_info"):
            self.metrics.update_comm_quant(self.engine.comm_wire_info())
        self.metrics.update_replica(
            self.core.name, self.core.replica_stats(), role=self.core.role
        )

    # -- engine accessors (guarded so fakes stay minimal) ----------------
    def _kv_cfg(self, name, default):
        return self.core._kv_cfg(name, default)

    def _sm_cfg(self, name, default):
        return self.core._sm_cfg(name, default)

    def _free_blocks(self) -> int:
        return self.core.free_blocks()

    def _prefix_cache(self):
        return self.core.prefix_cache()

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ServingDriver":
        if self._thread is not None:
            raise RuntimeError("driver already started")
        # the card the loop binds: the engine's, or (a device without an
        # index) the one current in the thread that starts the driver
        device = getattr(self.engine, "device", None)
        self._cuda_device = None
        if isinstance(device, torch.device) and device.type == "cuda":
            self._cuda_device = (device.index if device.index is not None
                                 else torch.cuda.current_device())
        self._thread = threading.Thread(target=self._loop, name="serving-driver", daemon=True)
        self._thread.start()
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(drain=exc_type is None)

    # -- public API ------------------------------------------------------
    def submit(
        self,
        prompt_tokens,
        params: Optional[SamplingParams] = None,
        timeout_s: Optional[float] = None,
        stop_fn=None,
    ) -> Request:
        """Accept a request into the admission queue and return it (its
        ``.stream`` is live immediately). Raises ``RequestRejected`` when the
        driver is draining/stopped, the queue is full, or the prompt can
        never be scheduled (max_context / per-sequence block cap)."""
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        params = params or SamplingParams()
        if len(prompt) == 0:
            self._reject("empty_prompt")
        total = len(prompt) + params.max_new_tokens
        max_ctx = self._sm_cfg("max_context", None)
        if max_ctx is not None and len(prompt) >= max_ctx:
            self._reject("max_context", f"prompt of {len(prompt)} tokens >= max_context={max_ctx}")
        check = getattr(self.engine.state_manager, "check_admissible", None)
        if check is not None:
            try:
                # the PROMPT must fit; generation may be cut short by the
                # block cap (reported as a length_cap finish)
                check(len(prompt))
            except ValueError as e:
                self._reject("inadmissible", str(e))
        timeout = timeout_s if timeout_s is not None else self.default_timeout_s
        with self._cond:
            if self._draining or self._stopping:
                self._reject("draining")
            if len(self._queue) >= self.max_queue:
                self._reject("queue_full", f"admission queue full ({self.max_queue})")
            req = Request(
                uid=self._next_uid,
                prompt_tokens=prompt,
                params=params,
                deadline=(time.monotonic() + timeout) if timeout else None,
                stop_fn=stop_fn,
            )
            self._next_uid += 1
            req.stream = TokenStream(req.uid)
            tracer = get_tracer()
            if tracer.enabled:
                begin_request_trace(tracer, req)
            self._queue.append(req)
            self._idle.clear()
            self.metrics.inc("requests_submitted_total")
            self.metrics.set_gauge("queue_depth", len(self._queue))
            self._cond.notify_all()
        return req

    def cancel(self, uid: int) -> bool:
        """Request cancellation; True if the uid was live. Queued requests
        cancel immediately; active ones are finished by the loop."""
        with self._cond:
            for req in list(self._queue):
                if req.uid == uid:
                    self._queue.remove(req)
                    self._terminate(req, RequestState.CANCELLED, "cancelled")
                    self.metrics.set_gauge("queue_depth", len(self._queue))
                    return True
            if uid in self._active:
                self._cancel_uids.add(uid)
                self._cond.notify_all()
                return True
        return False

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting new requests and run the accepted set (queued +
        active) to completion. Returns True once idle."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        return self._idle.wait(timeout)  # dstpu: noqa[guarded-read-unlocked] — Event is internally synchronized; _cond only coordinates the set/clear with the loop's idle accounting

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop the loop. ``drain=True`` completes accepted requests first;
        ``drain=False`` cancels everything in flight."""
        if drain:
            self.drain(timeout)
        with self._cond:
            self._stopping = True
            if not drain:
                for req in list(self._queue):
                    self._terminate(req, RequestState.CANCELLED, "shutdown")
                self._queue.clear()
                self._cancel_uids.update(self._active.keys())
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self._flush_monitor()

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    @property
    def num_active(self) -> int:
        with self._cond:
            return len(self._active)

    def health(self) -> Dict:
        with self._cond:
            snap = self.metrics.snapshot()
            replica = self.core.replica_stats()
            replica["role"] = self.core.role
            replica["health"] = self.core.health.snapshot()
            return {
                "status": "draining" if self._draining else "ok",
                "queue_depth": len(self._queue),
                "active_requests": len(self._active),
                "kv_free_blocks": self._free_blocks(),
                "kv_total_blocks": self._kv_total,
                "replicas": {self.core.name: replica},
                "kv_cache_dtype": self._kv_info.get("kv_cache_dtype", "bf16"),
                "kv_pool_bytes": self._kv_info.get("kv_pool_bytes", 0),
                "kv_capacity_multiplier": self._kv_info.get(
                    "kv_capacity_multiplier", 1.0
                ),
                "kv_host_tier": self._host_tier_health(),
                "spec": {
                    "enabled": self._spec_ctl is not None,
                    "k": self.spec_k,
                    "rounds": int(snap["spec_rounds_total"]),
                    "draft_tokens": int(snap["spec_draft_tokens_total"]),
                    "accepted_tokens": int(snap["spec_accepted_tokens_total"]),
                    "acceptance_rate": snap["spec_acceptance_rate"],
                },
                "events": get_event_log().stats(),
            }

    def _host_tier_health(self) -> Dict:
        tier = self.core.host_tier()
        if tier is None:
            return {"enabled": False}
        return {"enabled": True, **tier.stats()}

    # -- internals -------------------------------------------------------
    def _reject(self, reason: str, message: str = ""):
        self.metrics.inc("requests_rejected_total")
        raise RequestRejected(reason, message)

    def _terminate(self, req: Request, state: str, reason: str, error: Optional[str] = None):
        """Move a request to a terminal state (caller already detached it
        from queue/active and released scheduler state if needed)."""
        req.state = state
        req.finish_reason = reason
        req.error = error
        req.t_finish = time.monotonic()
        if req.stream is not None:
            req.stream.close(reason, error=error)
        req._done.set()
        if req.trace is not None:
            # traced path: histograms fold from the SPAN endpoints (same
            # numbers — the spans carry the request's own stamps), then
            # the tree is closed and retention policy runs
            self.metrics.observe_trace(req)
            finish_request_trace(req, reason=reason)
        else:
            self.metrics.observe_request(req)
        key = {
            RequestState.FINISHED: "requests_finished_total",
            RequestState.CANCELLED: "requests_cancelled_total",
            RequestState.TIMED_OUT: "requests_timed_out_total",
            RequestState.FAILED: "requests_failed_total",
        }.get(state)
        if key:
            self.metrics.inc(key)

    def _finish_active(self, req: Request, state: str, reason: str,
                       error: Optional[str] = None, scheduler_done: bool = False):
        """Terminal transition for an ACTIVE request: release its scheduler
        state (frees KV blocks + pending prompt chunks) and close out."""
        self.core.release(req.uid, scheduler_done=scheduler_done)
        with self._cond:  # cancel() adds uids under _cond from client threads
            self._cancel_uids.discard(req.uid)
        self._terminate(req, state, reason, error)

    # admission ---------------------------------------------------------
    def _blocks_needed(self, req: Request) -> int:
        return self.core.blocks_needed(req)

    def _admissible(self, req: Request) -> bool:
        return self.core.admissible(req)

    def _admit_locked(self) -> bool:
        admitted = False
        while self._queue:
            req = self._queue[0]
            if not self._admissible(req):
                self.metrics.inc("admission_blocked_total")
                break
            self._queue.popleft()
            try:
                self.core.admit(req)
            except Exception as e:
                # late inadmissibility (e.g. raced config change): isolate
                self._terminate(req, RequestState.REJECTED, "inadmissible", str(e))
                self.metrics.inc("requests_rejected_total")
                continue
            req.state = RequestState.PREFILL
            req.t_admitted = time.monotonic()
            if req.trace is not None:
                mark_admitted(req, core=self.core.name)
            self.metrics.inc("prefill_tokens_total", len(req.prompt_tokens))
            admitted = True
        self.metrics.set_gauge("queue_depth", len(self._queue))
        self.metrics.set_gauge("active_requests", len(self._active))
        return admitted

    # timeouts / cancels ------------------------------------------------
    def _next_deadline_locked(self) -> Optional[float]:
        deadlines = [r.deadline for r in self._queue if r.deadline is not None]
        deadlines += [r.deadline for r in self._active.values() if r.deadline is not None]
        return min(deadlines) if deadlines else None

    def _expire_locked(self):
        now = time.monotonic()
        for req in [r for r in self._queue if r.deadline is not None and now >= r.deadline]:
            self._queue.remove(req)
            self._terminate(req, RequestState.TIMED_OUT, "timeout")
        for req in [r for r in list(self._active.values())
                    if r.deadline is not None and now >= r.deadline]:
            self._finish_active(req, RequestState.TIMED_OUT, "timeout")
        for uid in list(self._cancel_uids):
            req = self._active.get(uid)
            if req is not None:
                self._finish_active(req, RequestState.CANCELLED, "cancelled")
            self._cancel_uids.discard(uid)

    # token delivery ----------------------------------------------------
    def _deliver(self, req: Request, token: int, feedback: bool = True) -> None:
        """One generated token for an active request: record, stream, stop.
        ``feedback=False`` for fused-round tokens — ``apply_decode_round``
        already advanced the scheduler, a second feedback would double-append.
        ``stop_fn`` exceptions propagate (caller isolates the request)."""
        now = time.monotonic()
        if req.t_first_token is None:
            req.t_first_token = now
            req.state = RequestState.DECODE
            if req.trace is not None:
                mark_first_token(req)
        req.generated.append(int(token))
        self.metrics.inc("decode_tokens_total")
        self.core.decode_tokens += 1
        req.stream.put(int(token))
        reason = req.should_stop(int(token), self.eos_token_id)
        if reason is not None:
            self._finish_active(req, RequestState.FINISHED, reason)
        elif feedback:
            self.engine.scheduler.feedback(req.uid, int(token))

    def _deliver_or_fail(self, req: Request, token: int, feedback: bool = True) -> bool:
        """Error isolation: a per-request failure finishes ONLY that request
        (blocks freed via scheduler.finish) and the loop keeps serving.
        Returns False when the request terminated."""
        try:
            self._deliver(req, token, feedback=feedback)
        except Exception as e:
            logger.warning(f"serving: request {req.uid} failed: {type(e).__name__}: {e}")
            self._finish_active(req, RequestState.FAILED, "error", error=f"{type(e).__name__}: {e}")
            return False
        return not req.is_terminal

    # engine stepping ---------------------------------------------------
    # The step body lives in EngineCore.step_once; the driver implements
    # the core's sink protocol (token delivery / engine failure / length
    # cap) over its single-engine request bookkeeping.
    def deliver(self, core, req: Request, token: int, feedback: bool = True) -> bool:
        return self._deliver_or_fail(req, token, feedback=feedback)

    def engine_failed(self, core, error: str):
        # engine-level failure: per-request state is unknowable, so the
        # in-flight set fails — but the driver survives for new requests
        for req in list(self._active.values()):
            self._finish_active(req, RequestState.FAILED, "engine_error", error=error)

    def finish_capped(self, core, req: Request):
        self._finish_active(req, RequestState.FINISHED, "length_cap",
                            scheduler_done=True)

    def _step_once(self) -> bool:
        """One engine step (or fused decode / speculative verify round).
        Returns True if any token landed / request advanced (progress)."""
        with self.core.step_lock:
            return self.core.step_once(self)

    def _flush_monitor(self):
        if self.monitor is not None:
            try:
                self.monitor.write_events(self.metrics.to_events())
            except Exception as e:
                logger.warning(f"serving: monitor write failed: {e}")

    # the loop ----------------------------------------------------------
    def _loop(self):
        """The step loop's thread. Grad mode and the current CUDA device
        are per thread in torch: the loop runs without autograd (no output
        carries a ``grad_fn``) and on the engine's device."""
        with torch.no_grad():
            if self._cuda_device is not None:
                torch.cuda.set_device(self._cuda_device)
            self._run_loop()

    def _run_loop(self):
        stall_wait = False
        while True:
            with self._cond:
                while True:
                    if self._stopping and not self._active and not self._queue:
                        self._idle.set()
                        return
                    work = (
                        bool(self._cancel_uids)
                        or self.engine.scheduler.has_work()
                        or (self._queue and self._admissible(self._queue[0]))
                    )
                    now = time.monotonic()
                    deadline = self._next_deadline_locked()
                    if deadline is not None and now >= deadline:
                        break  # timeouts due
                    if work and not stall_wait:
                        break
                    if not self._active and not self._queue:
                        self._idle.set()
                        self._flush_monitor()
                    # sleep until: new submit/cancel (notify), the next
                    # deadline, or — when the scheduler is stalled on KV
                    # blocks — a short poll. NEVER a busy spin.
                    timeout = None
                    if deadline is not None:
                        timeout = max(0.0, deadline - now)
                    if stall_wait:
                        timeout = min(self.poll_interval_s, timeout) if timeout else self.poll_interval_s
                    self._cond.wait(timeout)
                    stall_wait = False
                self._idle.clear()
                self._expire_locked()
                self._admit_locked()
            stepped = False
            if self.engine.scheduler.has_work():
                stepped = self._step_once()
                with self._cond:
                    self._admit_locked()  # finished requests freed blocks
                    self.metrics.update_kv(self._free_blocks(), self._kv_total)
                    cache = self._prefix_cache()
                    if cache is not None:
                        self.metrics.update_prefix_cache(cache.stats())
                    tier = self.core.host_tier()
                    if tier is not None:
                        self.metrics.update_host_tier(tier.stats())
                    if hasattr(self.engine, "comm_wire_info"):
                        # an engine with collective wires (tensor parallel)
                        # counts them as it steps: refresh every step
                        self.metrics.update_comm_quant(self.engine.comm_wire_info())
                    self.metrics.update_replica(
                        self.core.name, self.core.replica_stats(),
                        role=self.core.role,
                    )
                    self.metrics.set_gauge("active_requests", len(self._active))
                    if not self._active and not self._queue:
                        self._idle.set()
                        self._flush_monitor()
            # a zero-progress pass with work outstanding means the scheduler
            # is waiting on KV blocks (or the queue head is inadmissible):
            # back off onto the condition instead of spinning
            stall_wait = not stepped
