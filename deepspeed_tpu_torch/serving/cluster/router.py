"""Front-end router for disaggregated prefill/decode serving.

Copy of ``deepspeed_tpu/serving/cluster/router.py`` over the port's
engines. Decode replicas may live in other processes: agents
(``serving/cluster/agent.py``) join over ``serve_control`` as
``RemoteEngineHandle``s, and their handoffs ride the ``remote`` KV wire
(``serving/net/``). Each thread the router starts (the coordinator, one
worker per core, remote ones included) runs without autograd and on the
engines' card (``run_in_engine_scope``).

One change of flow against the JAX package: a handoff is imported by its
TARGET's worker, between the target's steps under its own step lock, not
by the prefill worker. The port's steps run on the host for their whole
length (a 64-step fused round holds its core's lock for seconds), so a
prefill worker that imported itself would queue behind every decode
round. Export and import both run on the threads' current stream (the
device's default stream), which orders an export's gathers before the
import that reads them and frees a payload only behind that read. A
remote replica's worker sends the ADOPT, which the port's agent answers
at once and imports between its own steps; an import that fails there
comes back as an ``adopt_failed`` EVENT, and the request recovers as one
resident on a lost agent does (``_remote_event``).

One ``Router`` owns N engines wrapped in :class:`EngineCore`: the first
``P`` are **prefill workers** (chunked prefill only — their split-step
produces the request's first token, then the sequence's KV blocks hand
off), the rest are **decode replicas** (fused decode rounds, spec decode).
With ``P == 0`` the decode replicas are colocated engines — each request
runs prefill AND decode on the replica the placement policy picked, with
no handoff — which is the pure scale-out mode (and what the single-engine
``ServingDriver`` is one instance of).

Threads:
  * one **coordinator** — queue timeouts, SLO-aware admission (placement
    picks the decode target by per-replica free-block headroom / queue
    depth / deadline slack; the decode budget is reserved at admission so
    concurrent prefills can't oversubscribe a replica), idle tracking.
  * one **worker per engine** — steps its core under the core's
    ``step_lock``, delivers tokens through the shared sink callbacks,
    (prefill workers) exports finished prefills to their reserved decode
    replicas and (decode replicas) imports the handoffs addressed to them
    before each step.

Lock order is ``core.step_lock -> router._cond``, never the reverse: any
thread touching an engine's scheduler/pools holds that core's step lock,
and request bookkeeping happens under the router condition inside it.

Output parity: uids are assigned in submit order starting at 0 and every
engine is built from the same config seed, so content-addressed sampling
keys make the streams bit-identical to the single-engine driver no matter
which replica decodes a request.
"""

import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.observability.events import get_event_log, log_event
from deepspeed_tpu_torch.observability.tracing import (
    begin_request_trace,
    finish_request_trace,
    get_tracer,
    mark_admitted,
    mark_first_token,
    mark_preempted,
    mark_resumed,
)
from deepspeed_tpu_torch.serving.cluster.core import (
    EngineCore,
    engine_device_index,
    run_in_engine_scope,
)
from deepspeed_tpu_torch.serving.cluster.handoff import (
    export_sequence,
    get_transport,
    import_sequence,
)
from deepspeed_tpu_torch.serving.cluster.placement import get_placement
from deepspeed_tpu_torch.serving.cluster.prefix_directory import PrefixDirectory
from deepspeed_tpu_torch.serving.driver import RequestRejected
from deepspeed_tpu_torch.serving.metrics import ServingMetrics
from deepspeed_tpu_torch.serving.request import Request, RequestState, SamplingParams
from deepspeed_tpu_torch.serving.resilience.faults import get_fault_injector
from deepspeed_tpu_torch.serving.resilience.health import (
    PROBATION,
    QUARANTINED,
    ResilienceConfig,
)
from deepspeed_tpu_torch.serving.resilience.recovery import plan_recovery, replay_prompt
from deepspeed_tpu_torch.serving.resilience.retry import with_retries
from deepspeed_tpu_torch.serving.streaming import TokenStream
from deepspeed_tpu_torch.utils.logging import logger


class Router:
    def __init__(
        self,
        engines: Optional[List] = None,
        *,
        prefill_engines: Optional[List] = None,
        decode_engines: Optional[List] = None,
        num_prefill_workers: int = 0,
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
        placement: str = "slo",
        kv_transport: str = "host",
        elastic=None,
        spare_pool=None,
        resilience: Optional[ResilienceConfig] = None,
    ):
        """Engines either pre-split (``prefill_engines``/``decode_engines``)
        or one flat ``engines`` list whose first ``num_prefill_workers``
        become prefill workers.

        ``elastic`` (an :class:`ElasticServingConfig`) turns the router
        into a fleet manager: the autoscaling control loop scales the
        decode side between the configured bounds (drawing warm engines
        from ``spare_pool``), the QoS ladder degrades/sheds admissions by
        queue occupancy, and higher tiers preempt lower-tier decodes when
        placement can't seat them.

        ``resilience`` (a :class:`ResilienceConfig`) arms fault tolerance:
        replica failures (step errors, worker crashes, hung steps) recover
        their in-flight streams onto surviving replicas instead of
        failing them, quarantined replicas are excluded from placement
        until a probation probe passes, and handoff/peer-pull edges retry
        with backoff. ``None`` (the default) keeps the legacy fail-fast
        behavior exactly — health is still TRACKED, never acted on."""
        if engines is not None:
            p = int(num_prefill_workers)
            prefill_engines = list(engines[:p])
            decode_engines = list(engines[p:])
        prefill_engines = prefill_engines or []
        decode_engines = decode_engines or []
        if not decode_engines:
            raise ValueError("Router needs at least one decode engine")
        self.eos_token_id = eos_token_id
        self.max_queue = int(max_queue)
        self.default_timeout_s = default_timeout_s
        self.poll_interval_s = float(poll_interval_s)
        self.monitor = monitor
        self.metrics = ServingMetrics()
        self._placement = get_placement(placement)
        # KV handoff wire (handoff.get_transport): host = portable numpy,
        # in_process = one device gather, device = pipelined zero-copy
        # windows, remote = cross-process socket wire. Resolved here so a
        # typo fails at construction.
        self._kv_transport = get_transport(kv_transport)

        colocated = not prefill_engines
        self.prefill = [
            EngineCore(e, name=f"p{i}", role="prefill", decode_steps=1,
                       kv_headroom=kv_headroom, spec_k=0, metrics=self.metrics)
            for i, e in enumerate(prefill_engines)
        ]
        self.decode = [
            EngineCore(e, name=f"d{i}", role="both" if colocated else "decode",
                       decode_steps=decode_steps, kv_headroom=kv_headroom,
                       spec_k=spec_k, spec_ngram=spec_ngram, proposer=proposer,
                       metrics=self.metrics)
            for i, e in enumerate(decode_engines)
        ]
        self.cores = self.prefill + self.decode
        self.spec_k = self.decode[0].spec_k
        # fault tolerance: None = legacy fail-fast (health tracked only)
        self._resilience = resilience
        self._retry_policy = (resilience.retry_policy()
                              if resilience is not None else None)
        if resilience is not None:
            for core in self.cores:
                core.health.configure(resilience)
        # cluster-wide prefix store: replicas advertise the chain hashes
        # they hold (device trie ∪ host tier) after each step; admission
        # pulls a hot prefix's uncovered tail from the best peer into the
        # target's host tier instead of re-prefilling it
        self.directory = PrefixDirectory()

        self._cond = threading.Condition()
        self._queue: deque = deque()  # Requests awaiting admission
        self._by_uid: Dict[int, Request] = {}  # every live request
        self._owner: Dict[int, EngineCore] = {}  # admitted -> resident core
        self._target: Dict[int, EngineCore] = {}  # planned decode replica
        self._resv: Dict[int, tuple] = {}  # uid -> (core, reserved blocks)
        self._reserved: Dict[str, list] = {c.name: [0, 0] for c in self.cores}
        self._handoff_out: Dict[str, list] = {}  # core name -> [(req, tok)]
        # target core name -> [(req, handoff, source core)] to import
        self._handoff_in: Dict[str, list] = {}
        self._tally: Dict[str, Dict[str, float]] = {
            c.name: {"finished": 0, "ttft_sum": 0.0, "ttft_n": 0,
                     "tpot_sum": 0.0, "tpot_n": 0}
            for c in self.cores
        }
        self._cancel_uids: set = set()
        self._next_uid = 0
        self._draining = False
        self._stopping = False
        self._idle = threading.Event()
        self._idle.set()
        self._threads: List[threading.Thread] = []

        # elastic control plane: config, degradation ladder, warm-spare
        # pool, and the autoscaling controller (started with the router)
        self._elastic = elastic
        self._spares = spare_pool
        self._shed = None
        self._controller = None
        if elastic is not None:
            from deepspeed_tpu_torch.serving.elastic import (
                DegradationLadder, ElasticController,
            )
            elastic.validate_fleet(
                len(self.decode),
                spare_pool.available if spare_pool is not None else 0,
            )
            self._shed = DegradationLadder(elastic)
            self._controller = ElasticController(self, elastic)
        # the ladder is stateless per call; the router remembers the last
        # rung so level CHANGES land in the control-plane event log
        self._last_shed_level = 0
        self._decode_seq = len(self.decode)  # next dN replica name
        self._finish_times: deque = deque(maxlen=64)  # Retry-After drain rate

        # remote transport: every exporting engine gets a KVEndpoint up
        # front (registration) so its address is in placement/health
        # metadata before the first handoff; fakes (no exportable pool)
        # hand off bookkeeping-only and need no listener
        self._kv_endpoints = []
        if self._kv_transport.name == "remote":
            from deepspeed_tpu_torch.serving.net.transport import ensure_endpoint
            for core in self.prefill:
                if hasattr(core.engine, "export_kv_blocks"):
                    self._kv_endpoints.append(ensure_endpoint(core.engine))
        # multi-host control plane: a ControlEndpoint (serve_control) that
        # remote decode agents dial into; their RemoteEngineHandles join
        # self.decode and take placements like any local replica
        self._control = None
        # the card the router's threads bind (None on the CPU)
        self._cuda_device = engine_device_index(self.decode[0].engine)

        self.metrics.counters.setdefault("kv_handoffs_total", 0)
        if self.decode[0].kv_info:
            self.metrics.update_kv_pool_info(self.decode[0].kv_info)
        if hasattr(self.decode[0].engine, "comm_wire_info"):
            self.metrics.update_comm_quant(self.decode[0].engine.comm_wire_info())
        with self._cond:
            self.metrics.update_kv(
                sum(c.free_blocks() for c in self.cores),
                sum(c.kv_total for c in self.cores),
            )
            for core in self.cores:
                self.metrics.update_replica(
                    core.name, core.replica_stats(), role=core.role
                )
            self.metrics.set_gauge("decode_replicas", len(self.decode))
            if self._spares is not None:
                self.metrics.set_gauge("warm_spares", self._spares.available)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "Router":
        # under _cond: _threads doubles as the "started" latch that
        # add_decode_replica checks before spawning a worker for a new core
        with self._cond:
            if self._threads:
                raise RuntimeError("router already started")
            self._threads.append(threading.Thread(
                target=self.run_in_engine_scope, args=(self._coordinate,),
                name="serving-router", daemon=True))
            for core in self.cores:
                self._threads.append(threading.Thread(
                    target=self.run_in_engine_scope, args=(self._worker, core),
                    name=f"serving-{core.name}", daemon=True))
            for t in self._threads:
                t.start()
        if self._controller is not None:
            self._controller.start()
        return self

    def run_in_engine_scope(self, fn, *args):
        """Body of every thread that touches this router's engines (its
        coordinator and workers, the elastic controller): ``fn(*args)``
        without autograd, on the engines' card."""
        return run_in_engine_scope(self._cuda_device, fn, *args)

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(drain=exc_type is None)

    # -- public API (mirrors ServingDriver) ------------------------------
    def submit(
        self,
        prompt_tokens,
        params: Optional[SamplingParams] = None,
        timeout_s: Optional[float] = None,
        stop_fn=None,
    ) -> Request:
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)  # prompt token ids from the client, host-born; not a KV payload
        params = params or SamplingParams()
        if len(prompt) == 0:
            self._reject("empty_prompt")
        max_ctx = self.decode[0]._sm_cfg("max_context", None)  # snapshot read of a config template; scale-in never empties decode and admission re-checks live capacity under _cond
        if max_ctx is not None and len(prompt) >= max_ctx:
            self._reject(
                "max_context",
                f"prompt of {len(prompt)} tokens >= max_context={max_ctx}",
            )
        # never-fits guard, PER replica group: the prompt must be
        # schedulable on at least one prefill-capable engine and one decode
        # replica (admission itself re-checks live per-replica free blocks
        # through the placement policy)
        groups = ([self.prefill] if self.prefill else []) + [self.decode]  # never-fits pre-check over a replica-list snapshot; the authoritative admission pass re-reads under _cond
        for cores in groups:
            err = None
            for core in cores:
                check = getattr(core.engine.state_manager, "check_admissible", None)
                if check is None:
                    err = None
                    break
                try:
                    check(len(prompt))
                    err = None
                    break
                except ValueError as e:
                    err = str(e)
            if err is not None:
                self._reject("inadmissible", err)
        timeout = timeout_s if timeout_s is not None else self.default_timeout_s
        with self._cond:
            if self._draining or self._stopping:
                self._reject("draining")
            if self._shed is not None:
                decision = self._shed.apply(params, len(self._queue),
                                            self.max_queue)
                self.metrics.set_gauge("shed_level", decision.level)
                if decision.level != self._last_shed_level:
                    log_event("shed_level",
                              level=decision.level,
                              prev=self._last_shed_level,
                              queue_depth=len(self._queue),
                              max_queue=self.max_queue)
                    self._last_shed_level = decision.level
                if decision.reject:
                    self.metrics.inc("requests_shed_total")
                    self.metrics.observe_tier(params.tenant, params.qos,
                                              "shed_total")
                    self._reject(
                        "shed",
                        f"overloaded: {params.qos!r} tier is shedding "
                        f"(queue {len(self._queue)}/{self.max_queue})",
                        retry_after_s=self._retry_after_locked(),
                    )
                params = decision.params
            if len(self._queue) >= self.max_queue:
                self._reject(
                    "queue_full",
                    f"admission queue full ({self.max_queue})",
                    retry_after_s=self._retry_after_locked(),
                )
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
                extra = None
                if self._shed is not None and self._last_shed_level:
                    extra = {"shed_level": self._last_shed_level}
                begin_request_trace(tracer, req, extra=extra)
            self._queue.append(req)
            self._by_uid[req.uid] = req
            self._idle.clear()
            self.metrics.inc("requests_submitted_total")
            self.metrics.set_gauge("queue_depth", len(self._queue))
            self._update_tier_queue_locked()
            self._cond.notify_all()
        return req

    def cancel(self, uid: int) -> bool:
        with self._cond:
            for req in list(self._queue):
                if req.uid == uid:
                    self._queue.remove(req)
                    self._by_uid.pop(uid, None)
                    self._release_resv_locked(uid)
                    self._terminate_locked(req, RequestState.CANCELLED, "cancelled")
                    self.metrics.set_gauge("queue_depth", len(self._queue))
                    return True
            if uid in self._by_uid:
                self._cancel_uids.add(uid)
                self._cond.notify_all()
                return True
        return False

    def drain(self, timeout: Optional[float] = None) -> bool:
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        return self._idle.wait(timeout)  # Event is internally synchronized; _cond only coordinates the set/clear with the coordinator's idle accounting

    def shutdown(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        if self._controller is not None:
            self._controller.stop()
        if drain:
            self.drain(timeout)
        with self._cond:
            self._stopping = True
            if not drain:
                for req in list(self._queue):
                    self._by_uid.pop(req.uid, None)
                    self._release_resv_locked(req.uid)
                    self._terminate_locked(req, RequestState.CANCELLED, "shutdown")
                self._queue.clear()
                self._cancel_uids.update(self._by_uid.keys())
            self._cond.notify_all()
            # swap out the thread list under the lock; _stopping above
            # keeps add_decode_replica from appending after the swap
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=30)
        # remote agents first (GOODBYE lets them exit their serve loops),
        # then the listener, then the KV endpoints they may still dial
        for core in list(self.decode):  # shutdown path: coordinator threads are joined and _stopping bars new replicas, so the list is frozen
            if getattr(core, "is_remote", False):
                core.close("router shutdown")
        if self._control is not None:
            self._control.close()
            self._control = None
        for ep in self._kv_endpoints:
            ep.close()
        self._kv_endpoints = []
        self._flush_monitor()

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    @property
    def num_active(self) -> int:
        with self._cond:
            return len(self._owner)

    def reserved_for_locked(self, core: EngineCore):
        """(blocks, sequences) the router has promised to in-flight
        handoffs targeting ``core``. The ``_locked`` suffix is the
        contract: placement calls this inside the coordinator's admission
        pass, which holds ``_cond``."""
        r = self._reserved[core.name]
        return int(r[0]), int(r[1])

    def health(self) -> Dict:
        with self._cond:
            snap = self.metrics.snapshot()
            replicas = {}
            for core in self.cores:
                st = core.replica_stats()
                st["role"] = core.role
                st["reserved_blocks"] = self._reserved[core.name][0]
                t = self._tally[core.name]
                st["requests_finished_total"] = t["finished"]
                if t["ttft_n"]:
                    st["ttft_mean_s"] = round(t["ttft_sum"] / t["ttft_n"], 6)
                if t["tpot_n"]:
                    st["tpot_mean_s"] = round(t["tpot_sum"] / t["tpot_n"], 6)
                st["health"] = core.health.snapshot()
                # remote-KV discovery: where a cross-process importer
                # FETCHes this replica's staged handoffs from
                addr = core.kv_endpoint_address()
                if addr is not None:
                    st["kv_endpoint"] = list(addr)
                if getattr(core, "is_remote", False):
                    st["remote"] = True
                    st["connected"] = core.connected
                replicas[core.name] = st
            kv_info = self.decode[0].kv_info
            spec = next((c.spec_ctl for c in self.decode), None)
            return {
                "status": "draining" if self._draining else "ok",
                "queue_depth": len(self._queue),
                "active_requests": len(self._owner),
                "kv_free_blocks": sum(c.free_blocks() for c in self.cores),
                "kv_total_blocks": sum(c.kv_total for c in self.cores),
                "kv_cache_dtype": kv_info.get("kv_cache_dtype", "bf16"),
                "kv_pool_bytes": kv_info.get("kv_pool_bytes", 0),
                "kv_capacity_multiplier": kv_info.get("kv_capacity_multiplier", 1.0),
                "num_prefill_workers": len(self.prefill),
                "num_decode_replicas": len(self.decode),
                "placement": self._placement.name,
                "kv_handoffs": int(snap.get("kv_handoffs_total", 0)),
                "kv_transport": {
                    "transport": self._kv_transport.name,
                    "inflight_windows": int(
                        snap.get("kv_handoff_inflight_windows", 0)),
                    "aborts": int(snap.get("kv_handoff_aborts_total", 0)),
                    "per_transport": self.metrics.handoff_snapshot(),
                    "latency_mean_s": round(
                        self.metrics.handoff_seconds.mean, 6),
                    "latency_p95_s": round(
                        self.metrics.handoff_seconds.quantile(0.95), 6),
                    "endpoints": {
                        c.name: {"address": list(c.kv_endpoint_address()),
                                 **c.kv_endpoint_stats()}
                        for c in self.cores
                        if c.kv_endpoint_address() is not None
                    },
                },
                "control_plane": {
                    "enabled": self._control is not None,
                    "address": (list(self._control.address)
                                if self._control is not None else None),
                    "remote_replicas": {
                        c.name: {
                            "connected": c.connected,
                            "kv_endpoint": (
                                list(c.kv_endpoint_address())
                                if c.kv_endpoint_address() is not None
                                else None),
                        }
                        for c in self.decode
                        if getattr(c, "is_remote", False)
                    },
                },
                "kv_host_tier": self._host_tier_health_locked(),
                "prefix_peer_pulls": int(snap.get("prefix_peer_pulls_total", 0)),
                "prefix_directory": self.directory.stats(),
                "replicas": replicas,
                "elastic": {
                    "enabled": self._elastic is not None,
                    "decode_replicas": len(self.decode),
                    "min_decode_replicas": (
                        self._elastic.min_decode_replicas
                        if self._elastic is not None else len(self.decode)),
                    "max_decode_replicas": (
                        self._elastic.max_decode_replicas
                        if self._elastic is not None else len(self.decode)),
                    "warm_spares": (self._spares.available
                                    if self._spares is not None else 0),
                    "shed_level": int(snap.get("shed_level", 0)),
                    "preempted": int(snap.get("requests_preempted_total", 0)),
                    "resumed": int(snap.get("requests_resumed_total", 0)),
                    "shed": int(snap.get("requests_shed_total", 0)),
                    "scale_up": int(snap.get("scale_up_total", 0)),
                    "scale_down": int(snap.get("scale_down_total", 0)),
                },
                "qos": {
                    f"{tenant}/{tier}": cell
                    for (tenant, tier), cell
                    in self.metrics.tier_snapshot().items()
                },
                "spec": {
                    "enabled": spec is not None,
                    "k": self.spec_k,
                    "rounds": int(snap["spec_rounds_total"]),
                    "draft_tokens": int(snap["spec_draft_tokens_total"]),
                    "accepted_tokens": int(snap["spec_accepted_tokens_total"]),
                    "acceptance_rate": snap["spec_acceptance_rate"],
                },
                "resilience": {
                    "enabled": self._resilience is not None,
                    "placeable_replicas": sum(
                        1 for c in self.decode if c.health.placeable),
                    "replica_failures": int(
                        snap.get("replica_failures_total", 0)),
                    "quarantines": int(
                        snap.get("replica_quarantines_total", 0)),
                    "probes": int(snap.get("replica_probes_total", 0)),
                    "probe_failures": int(
                        snap.get("replica_probe_failures_total", 0)),
                    "recoveries": int(
                        snap.get("requests_recovered_total", 0)),
                    "recovery_checkpoints": int(
                        snap.get("recovery_checkpoints_total", 0)),
                    "recovery_replays": int(
                        snap.get("recovery_replays_total", 0)),
                    "handoff_retries": int(
                        snap.get("handoff_retries_total", 0)),
                    "peer_pull_retries": int(
                        snap.get("peer_pull_retries_total", 0)),
                },
                "events": get_event_log().stats(),
            }

    def _host_tier_health_locked(self) -> Dict:
        """Aggregated host-tier snapshot across cores for health()."""
        tiers = [t for t in (c.host_tier() for c in self.cores) if t is not None]
        if not tiers:
            return {"enabled": False}
        agg: Dict[str, float] = {"enabled": True}
        for t in tiers:
            for k, v in t.stats().items():
                agg[k] = agg.get(k, 0) + v
        return agg

    # -- multi-host control plane ----------------------------------------
    def serve_control(self, host: str = "127.0.0.1", port: int = 0):
        """Start (idempotently) the control listener that remote decode
        agents (``dstpu serve-agent --join host:port``) dial into, and
        return its bound ``(host, port)``. Each agent contributes one
        :class:`RemoteEngineHandle` to ``self.decode``; tokens flow back
        over its events channel, KV handoffs ride the remote KV wire."""
        if self._control is None:
            from deepspeed_tpu_torch.serving.net.control import ControlEndpoint
            self._control = ControlEndpoint(
                host, port, name="router-ctl",
                on_channel=self._on_control_channel,
                metrics=self.metrics,
            ).start()
        return self._control.address

    def _on_control_channel(self, meta: Dict, channel) -> Dict:
        """ControlEndpoint bootstrap hook (accept thread, no router locks
        held). Agents dial twice: the ``rpc`` channel registers/re-joins
        the replica, the ``events`` channel carries its token pump."""
        kind = str(meta.get("channel", "rpc"))
        if kind == "rpc":
            return self._agent_hello(meta, channel)
        if kind == "events":
            name = str(meta.get("name", ""))
            with self._cond:
                handle = next(
                    (c for c in self.decode
                     if c.name == name and getattr(c, "is_remote", False)),
                    None)
            if handle is None:
                raise ValueError(
                    f"events channel for unknown remote replica {name!r}")
            handle.attach_events(channel)
            log_event("agent_joined", replica=name,
                      kv_blocks=handle.kv_total,
                      tp_shards=handle.tp_shards(),
                      kv_endpoint=(list(handle.kv_endpoint_address())
                                   if handle.kv_endpoint_address() else None))
            with self._cond:
                self._cond.notify_all()  # placement may seat queued work now
            return {"name": name}
        raise ValueError(f"unknown control channel kind {kind!r}")

    def _agent_hello(self, meta: Dict, channel) -> Dict:
        """Register a remote decode replica from its bootstrap META (or
        re-attach a known one after an agent restart — same name, fresh
        channels and pool state; its probation probe re-admits it)."""
        from deepspeed_tpu_torch.serving.cluster.remote_core import RemoteEngineHandle
        requested = str(meta.get("name") or "")
        with self._cond:
            existing = (next((c for c in self.decode if c.name == requested),
                             None) if requested else None)
            if existing is not None and not getattr(existing, "is_remote", False):
                raise ValueError(
                    f"replica name {requested!r} is taken by a local engine")
            if existing is None:
                name = requested or f"d{self._decode_seq}"
                if not requested:
                    self._decode_seq += 1
        if existing is not None:
            existing.update_meta(meta)
            existing.attach_rpc(channel)
            log_event("agent_rejoined", replica=existing.name,
                      health=existing.health.state)
            with self._cond:
                self._cond.notify_all()
            return {"name": existing.name}
        handle = RemoteEngineHandle(name, meta, self, metrics=self.metrics,
                                    resilience=self._resilience)
        handle.attach_rpc(channel)
        self.add_remote_replica(handle)
        return {"name": name}

    def add_remote_replica(self, handle) -> None:
        """Wire a :class:`RemoteEngineHandle` into the decode fleet: the
        same bookkeeping as :meth:`add_decode_replica`, minus the engine
        (it lives in the agent's process)."""
        with self._cond:
            self.decode.append(handle)
            self.cores.append(handle)
            self._reserved[handle.name] = [0, 0]
            self._tally[handle.name] = {"finished": 0, "ttft_sum": 0.0,
                                        "ttft_n": 0, "tpot_sum": 0.0,
                                        "tpot_n": 0}
            if self._threads and not self._stopping:
                t = threading.Thread(target=self.run_in_engine_scope,
                                     args=(self._worker, handle),
                                     name=f"serving-{handle.name}",
                                     daemon=True)
                self._threads.append(t)
                t.start()
            self.metrics.set_gauge("decode_replicas", len(self.decode))
            self.metrics.update_replica(handle.name, handle.replica_stats(),
                                        role=handle.role, remote=True)
            self._cond.notify_all()

    def _remote_token(self, core, obj: Dict) -> None:
        """Events-channel TOKEN frame (pump thread): route into the same
        sink path a local ``step_once`` would have called. ``feedback``
        already happened agent-side. Frames racing a finish/recovery are
        dropped by the residency check — the agent's stream is stale."""
        uid = int(obj.get("uid", -1))
        with self._cond:
            req = self._by_uid.get(uid)
            if req is None or req.is_terminal or core.requests.get(uid) is not req:
                return
            if "tok" in obj:
                self.deliver(core, req, int(obj["tok"]), feedback=False)
            elif obj.get("fin") == "length_cap":
                self.finish_capped(core, req)

    def _remote_stats(self, core, obj: Dict) -> None:
        """Events-channel STATS push: the handle already folded it into
        its admission caches; roll it up into /metrics and the prefix
        directory, then wake the coordinator (freed blocks may seat the
        queue head)."""
        with self._cond:
            st = core.replica_stats()
            r = self._reserved.get(core.name)
            if r is not None:
                st["reserved_blocks"] = r[0]
            t = self._tally.get(core.name)
            if t is not None:
                st["requests_finished_total"] = t["finished"]
            self.metrics.update_replica(core.name, st, role=core.role,
                                        remote=True)
            if self._placeable(core):
                self.directory.advertise(core.name, core.prefix_hashes())
            self._cond.notify_all()

    def _remote_event(self, core, obj: Dict) -> None:
        """Events-channel EVENT frame. ``engine_failed`` mirrors the local
        sink's ``engine_failed`` — except the agent already dropped its
        residents (its sink released them), so recovery detaches only.
        ``adopt_failed`` (the port's agent: an ADOPT it acknowledged could
        not import, its retries spent) recovers that one request the same
        way, and releases its staged transfer at the exporter."""
        event = str(obj.get("event", ""))
        if event == "adopt_failed":
            self._remote_adopt_failed(core, obj)
            return
        if event != "engine_failed":
            log_event(f"agent_{event or 'event'}", replica=core.name,
                      **{k: v for k, v in obj.items() if k != "event"})
            return
        error = str(obj.get("error", ""))
        core.health.note_error(error)
        log_event("engine_failed", replica=core.name, error=error,
                  in_flight=len(core.requests), health=core.health.state)
        with self._cond:
            if self._resilience is None:
                for req in list(core.requests.values()):
                    self._finish_on_locked(core, req, RequestState.FAILED,
                                           "engine_error", error=error,
                                           scheduler_done=True)
            else:
                self.metrics.inc("replica_failures_total")
                self._note_quarantine_locked(core)
                for req in list(core.requests.values()):
                    self._recover_resident_locked(
                        core, req, pool_readable=False,
                        cause=f"agent engine step: {error}",
                        detach_only=True)
            self._cond.notify_all()

    def _remote_adopt_failed(self, core, obj: Dict) -> None:
        uid = int(obj.get("uid", -1))
        error = str(obj.get("error", ""))
        tid = obj.get("transfer_id")
        if tid:
            for ep in list(self._kv_endpoints):
                ep.release(str(tid))
        log_event("handoff_failed", uid=uid, target=core.name, error=error)
        logger.warning(f"serving: handoff import of uid={uid} onto "
                       f"{core.name} failed: {error}")
        self.metrics.handoff_aborted("remote")
        with core.step_lock:
            with self._cond:
                req = self._by_uid.get(uid)
                if (req is None or req.is_terminal
                        or core.requests.get(uid) is not req):
                    return
                if self._resilience is None:
                    self._finish_on_locked(core, req, RequestState.FAILED,
                                           "error",
                                           error=f"handoff import: {error}",
                                           scheduler_done=True)
                else:
                    self._recover_resident_locked(
                        core, req, pool_readable=False,
                        cause=f"handoff import: {error}", detach_only=True)
                self._cond.notify_all()

    def _agent_lost(self, core, err: str) -> None:
        """The control wire to an agent died (pump EOF, RPC failure, or an
        explicit GOODBYE): quarantine the replica and recover its residents
        by replay — the agent's pool is unreachable, but every stream is
        re-derivable from its delivered tokens. ``mark_disconnected`` makes
        this idempotent across the pump/flusher race. A restarted agent
        re-joins under the same name and probation re-admits it."""
        if not core.mark_disconnected():
            return
        # the residents' handoffs the agent may not have fetched yet
        # (it imports between its steps): release them at the exporters
        for tid in core.adopted_transfers():
            for ep in list(self._kv_endpoints):
                ep.release(tid)
        err = str(err)
        state = core.health.note_crash(err)
        logger.warning(f"serving[{core.name}]: agent lost: {err}")
        self.metrics.inc("replica_failures_total")
        with core.step_lock:
            with self._cond:
                self._handoff_out.pop(core.name, None)
                self._note_quarantine_locked(core)
                log_event("agent_lost", replica=core.name, error=err,
                          health=state, in_flight=len(core.requests))
                for req in list(core.requests.values()):
                    if self._resilience is not None:
                        # detach_only: the agent is gone — there is no
                        # scheduler to finish, nothing to CANCEL
                        self._recover_resident_locked(
                            core, req, pool_readable=False,
                            cause=f"agent lost: {err}", detach_only=True)
                    else:
                        self._finish_on_locked(core, req, RequestState.FAILED,
                                               "engine_error", error=err,
                                               scheduler_done=True)
                self._cond.notify_all()

    # -- internals -------------------------------------------------------
    def _reject(self, reason: str, message: str = "",
                retry_after_s: Optional[float] = None):
        self.metrics.inc("requests_rejected_total")
        raise RequestRejected(reason, message, retry_after_s=retry_after_s)

    def _retry_after_locked(self) -> float:
        """Retry-After hint from the observed queue drain rate: how long
        until the backlog ahead of a retry has drained. Caller holds
        ``_cond``."""
        now = time.monotonic()
        recent = [t for t in self._finish_times if now - t <= 30.0]
        depth = max(1, len(self._queue))
        if len(recent) >= 2:
            span = max(1e-3, now - recent[0])
            eta = depth / (len(recent) / span)
        else:
            eta = 5.0  # no drain history yet: a polite default
        return float(min(120.0, max(1.0, eta)))

    def _update_tier_queue_locked(self) -> None:
        depths: Dict[tuple, int] = {}
        for r in self._queue:
            key = (r.params.tenant, r.params.qos)
            depths[key] = depths.get(key, 0) + 1
        self.metrics.set_tier_queue_depth(depths)

    def _terminate_locked(self, req: Request, state: str, reason: str,
                          error: Optional[str] = None):
        req.state = state
        req.finish_reason = reason
        req.error = error
        req.t_finish = time.monotonic()
        if req.stream is not None:
            req.stream.close(reason, error=error)
        req._done.set()
        if req.trace is not None:
            # traced path: histograms fold from the SPAN endpoints (same
            # numbers — the spans carry the request's own stamps)
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

    def _release_resv_locked(self, uid: int):
        ent = self._resv.pop(uid, None)
        if ent is not None:
            core, blocks = ent
            r = self._reserved[core.name]
            r[0] -= blocks
            r[1] -= 1
        self._target.pop(uid, None)

    def _finish_on_locked(self, core: EngineCore, req: Request, state: str,
                          reason: str, error: Optional[str] = None,
                          scheduler_done: bool = False):
        """Terminal transition for a request RESIDENT on ``core``. Caller
        holds ``core.step_lock`` and ``self._cond``."""
        core.release(req.uid, scheduler_done=scheduler_done)
        self._release_resv_locked(req.uid)
        self._owner.pop(req.uid, None)
        self._by_uid.pop(req.uid, None)
        self._cancel_uids.discard(req.uid)
        self._terminate_locked(req, state, reason, error)
        t = self._tally[core.name]
        if state == RequestState.FINISHED:
            t["finished"] += 1
            self._finish_times.append(time.monotonic())
            self.metrics.observe_tier(req.params.tenant, req.params.qos,
                                      "finished_total")
        if req.ttft_s is not None:
            t["ttft_sum"] += req.ttft_s
            t["ttft_n"] += 1
            self.metrics.observe_tier(req.params.tenant, req.params.qos,
                                      "ttft_s", req.ttft_s)
        if req.tpot_s is not None:
            t["tpot_sum"] += req.tpot_s
            t["tpot_n"] += 1

    # -- fault tolerance --------------------------------------------------
    def _placeable(self, core: EngineCore) -> bool:
        """Whether placement/pulls/preemption may touch ``core``. Without a
        resilience config health never gates anything (legacy behavior);
        with one, quarantined/probation replicas receive nothing until
        their probe passes."""
        return self._resilience is None or core.health.placeable

    def _note_quarantine_locked(self, core: EngineCore) -> None:
        """Quarantine side-effects, exactly once per transition (the
        health machine may be advanced by worker AND coordinator for the
        same incident): metrics, event log, and dropping the replica's
        prefix advertisement so no peer plans pulls from it. Caller holds
        ``_cond``."""
        if core.health.state != QUARANTINED:
            return
        if getattr(core, "_quarantine_seq", 0) == core.health.quarantines:
            return
        core._quarantine_seq = core.health.quarantines
        self.metrics.inc("replica_quarantines_total")
        self.directory.forget(core.name)
        log_event("quarantine", replica=core.name,
                  error=core.health.last_error,
                  quarantines=core.health.quarantines)

    def _recover_resident_locked(self, core: EngineCore, req: Request,
                                 pool_readable: bool, cause: str,
                                 detach_only: bool = False) -> None:
        """Rebuild one in-flight request off failed replica ``core``:
        checkpoint route when the pool is readable and the row is steady
        decode state, replay route (prompt + delivered tokens; sampling
        keys are position-addressed so the continuation is bit-identical)
        otherwise. Caller holds ``_cond``, and ``core.step_lock`` unless
        ``detach_only`` — a HUNG replica's lock is owned by its wedged
        step, so that path only detaches bookkeeping (``core.requests`` /
        spec history) and never touches the engine; the stale step's
        ``req is None -> sched.finish(uid)`` cleanup frees its scheduler
        state if it ever returns. ``pool_readable`` additionally gates
        the checkpoint export: a replica whose STEP failed can still free
        scheduler state, but its pool content is unknowable — replay."""
        cfg = self._resilience
        uid = req.uid
        if req.is_terminal:
            return
        if uid in self._cancel_uids:
            self._finish_on_locked(core, req, RequestState.CANCELLED,
                                   "cancelled", scheduler_done=detach_only)
            return
        if req.recoveries >= cfg.max_recoveries:
            self._finish_on_locked(
                core, req, RequestState.FAILED, "error",
                error=f"recovery budget ({cfg.max_recoveries}) exhausted; "
                      f"last failure: {cause}",
                scheduler_done=detach_only)
            return
        route, arg = plan_recovery(core, req, pool_readable)
        if route == "fail":
            if arg == "complete":
                # every budgeted token was already delivered — the stream
                # just never saw its terminal transition
                self._finish_on_locked(core, req, RequestState.FINISHED,
                                       "max_tokens",
                                       scheduler_done=detach_only)
            else:
                self._finish_on_locked(
                    core, req, RequestState.FAILED, "error",
                    error=f"unrecoverable after {cause}: {arg}",
                    scheduler_done=detach_only)
            return
        core.release(uid, scheduler_done=detach_only)
        self._owner.pop(uid, None)
        self._release_resv_locked(uid)
        if route == "checkpoint":
            req._checkpoint = arg
            req._replay_prompt = None
            self.metrics.inc("recovery_checkpoints_total")
        else:
            req._checkpoint = None
            req._replay_prompt = arg
            self.metrics.inc("recovery_replays_total")
        req.recoveries += 1
        req.state = RequestState.QUEUED
        if req.trace is not None:
            mark_preempted(req, reason="recovered")
        self._queue.append(req)
        self.metrics.inc("requests_recovered_total")
        self.metrics.set_gauge("queue_depth", len(self._queue))
        self._update_tier_queue_locked()
        log_event("request_recovered", uid=uid, replica=core.name,
                  route=route, tokens=len(req.generated),
                  recoveries=req.recoveries, cause=cause)

    def _requeue_for_replay_locked(self, req: Request, cause: str) -> bool:
        """Replay-recover a request that is resident NOWHERE (a handoff or
        resume import failed after its source released the sequence).
        Returns False when the recovery budget is spent — the caller then
        fails the request. Caller holds ``_cond``."""
        cfg = self._resilience
        if cfg is None or req.is_terminal or req.uid in self._cancel_uids:
            return False
        if req.recoveries >= cfg.max_recoveries:
            return False
        self._release_resv_locked(req.uid)
        req._checkpoint = None
        req._replay_prompt = replay_prompt(req)
        req.recoveries += 1
        req.state = RequestState.QUEUED
        if req.trace is not None:
            mark_preempted(req, reason="recovered")
        self._queue.append(req)
        self.metrics.inc("recovery_replays_total")
        self.metrics.inc("requests_recovered_total")
        self.metrics.set_gauge("queue_depth", len(self._queue))
        self._update_tier_queue_locked()
        log_event("request_recovered", uid=req.uid, replica=None,
                  route="replay", tokens=len(req.generated),
                  recoveries=req.recoveries, cause=cause)
        return True

    def _scan_hangs_locked(self) -> None:
        """Step watchdog (coordinator): a core whose in-flight step is
        older than the hung-step deadline is quarantined and its residents
        recovered by replay. Reads ``step_started_at`` WITHOUT the step
        lock — the wedged step owns that lock and may never release it.
        Caller holds ``_cond``."""
        cfg = self._resilience
        now = time.monotonic()
        for core in self.cores:
            t0 = core.step_started_at
            if t0 is None or now - t0 < cfg.hung_step_s:
                continue
            if core.health.state in (QUARANTINED, PROBATION):
                continue  # this hang was already handled
            err = (f"hung step: {now - t0:.2f}s in flight "
                   f"(deadline {cfg.hung_step_s}s)")
            core.health.note_hang(err)
            self.metrics.inc("replica_failures_total")
            self._note_quarantine_locked(core)
            self._handoff_out.pop(core.name, None)
            log_event("step_hang", replica=core.name,
                      age_s=round(now - t0, 3),
                      in_flight=len(core.requests))
            for req in list(core.requests.values()):
                self._recover_resident_locked(core, req, pool_readable=False,
                                              cause=err, detach_only=True)
            self._replay_inbound_locked(core, err)

    def _replay_inbound_locked(self, core: EngineCore, err: str,
                               inbound=None) -> None:
        """Handoffs waiting for a failed replica's worker (``inbound``, or
        all queued for ``core``) are resident nowhere: unwind each and
        replay it elsewhere (or fail it without resilience). The worker
        would otherwise import them into the quarantined replica and step
        them there."""
        if inbound is None:
            inbound = self._handoff_in.pop(core.name, [])
        for req, ho, source in inbound:
            self._abort_handoff(ho, source)
            if not self._requeue_for_replay_locked(req, err):
                self._release_resv_locked(req.uid)
                self._by_uid.pop(req.uid, None)
                self._cancel_uids.discard(req.uid)
                self._terminate_locked(req, RequestState.FAILED, "error",
                                       error=f"handoff import: {err}")

    def _probe_plan_locked(self):
        """Pick one quarantined core whose probation backoff elapsed and
        move it to PROBATION (so a second coordinator pass can't double-
        probe). The probe itself runs outside ``_cond`` — it takes the
        core's step lock, and lock order is step_lock -> _cond."""
        for core in self.cores:
            if core.health.probe_due():
                core.health.begin_probe()
                return ("probe", core)
        return None

    def _execute_probe(self, core: EngineCore) -> None:
        """Run the synthetic probation probe and settle the circuit
        breaker: pass -> healthy (placement resumes on the next plan
        pass), fail -> quarantined with the backoff doubled."""
        self.metrics.inc("replica_probes_total")
        try:
            core.probe()
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
            core.health.probe_failed(err)
            self.metrics.inc("replica_probe_failures_total")
            log_event("probe_failed", replica=core.name, error=err,
                      probe_failures=core.health.probe_failures)
            return
        core.health.probe_passed()
        log_event("probe_passed", replica=core.name,
                  probes=core.health.probes)
        with self._cond:
            self._cond.notify_all()  # placeable again: replan admissions

    def _note_retry(self, counter: str, site: str, detail: str,
                    attempt: int, err: BaseException) -> None:
        self.metrics.inc(counter)
        log_event("transfer_retry", site=site, detail=detail,
                  attempt=attempt, error=f"{type(err).__name__}: {err}")

    def _edge_retries(self, fn, counter: str, site: str, detail: str):
        """Run a transfer-edge callable under the bounded retry policy —
        or exactly once when resilience is off (legacy single-try)."""
        if self._retry_policy is None:
            return fn()
        return with_retries(
            fn, self._retry_policy, label=site,
            on_retry=lambda attempt, e: self._note_retry(
                counter, site, detail, attempt, e),
        )

    def _resilience_wait_bound_locked(self, now: float) -> float:
        """Earliest future instant the coordinator must wake for: a step
        crossing the hung deadline, or a quarantine backoff expiring; and
        never later than one deadline from now, because a step that starts
        while the coordinator sleeps notifies no one (the JAX router's wait
        is unbounded then: it sees the hang only if another pass wakes it)."""
        cfg = self._resilience
        waits = [cfg.hung_step_s]
        for core in self.cores:
            t0 = core.step_started_at
            if t0 is not None:
                waits.append(max(0.0, t0 + cfg.hung_step_s - now))
            h = core.health
            if h.state == QUARANTINED and h.next_probe_at is not None:
                waits.append(max(0.0, h.next_probe_at - now))
        return min(waits)

    # -- EngineCore sink protocol ----------------------------------------
    def deliver(self, core: EngineCore, req: Request, token: int,
                feedback: bool = True) -> bool:
        with self._cond:
            try:
                now = time.monotonic()
                if req.t_first_token is None:
                    req.t_first_token = now
                    req.state = RequestState.DECODE
                    if req.trace is not None:
                        mark_first_token(req)
                req.generated.append(int(token))
                self.metrics.inc("decode_tokens_total")
                core.decode_tokens += 1
                req.stream.put(int(token))
                reason = req.should_stop(int(token), self.eos_token_id)
                if reason is not None:
                    self._finish_on_locked(core, req, RequestState.FINISHED, reason)
                elif core.role == "prefill":
                    # first token out of the split-step: queue the KV
                    # handoff; the worker exports right after this step
                    self._handoff_out.setdefault(core.name, []).append(
                        (req, int(token)))
                elif feedback:
                    core.engine.scheduler.feedback(req.uid, int(token))
            except Exception as e:
                logger.warning(
                    f"serving: request {req.uid} failed: {type(e).__name__}: {e}")
                self._finish_on_locked(core, req, RequestState.FAILED, "error",
                                       error=f"{type(e).__name__}: {e}")
                return False
        return not req.is_terminal

    def engine_failed(self, core: EngineCore, error: str):
        """Engine-level step failure (called from inside ``step_once``'s
        handler, under ``core.step_lock``; health already advanced).
        Legacy: the resident set fails. With a resilience config: the
        residents recover by REPLAY — the failed step left per-request
        pool/scheduler state unknowable, so nothing is exported; each
        stream is re-derived from its delivered tokens on a surviving
        replica, bit-identically."""
        log_event("engine_failed", replica=core.name, error=error,
                  in_flight=len(core.requests), health=core.health.state)
        with self._cond:
            self._handoff_out.pop(core.name, None)
            if self._resilience is None:
                for req in list(core.requests.values()):
                    self._finish_on_locked(core, req, RequestState.FAILED,
                                           "engine_error", error=error)
                return
            self.metrics.inc("replica_failures_total")
            self._note_quarantine_locked(core)
            for req in list(core.requests.values()):
                # step_lock IS held here, but the pool is NOT readable:
                # the failed step may have half-written it
                self._recover_resident_locked(core, req, pool_readable=False,
                                              cause=f"engine step: {error}")
            self._cond.notify_all()

    def finish_capped(self, core: EngineCore, req: Request):
        with self._cond:
            self._finish_on_locked(core, req, RequestState.FINISHED,
                                   "length_cap", scheduler_done=True)

    # -- admission (coordinator) -----------------------------------------
    def _expire_queue_locked(self):
        now = time.monotonic()
        for req in [r for r in self._queue
                    if r.deadline is not None and now >= r.deadline]:
            self._queue.remove(req)
            self._by_uid.pop(req.uid, None)
            self._release_resv_locked(req.uid)
            self._terminate_locked(req, RequestState.TIMED_OUT, "timeout")
        self.metrics.set_gauge("queue_depth", len(self._queue))
        self._update_tier_queue_locked()

    def _plan_admission_locked(self):
        """Head admission, best (priority, arrival) pair first — identical
        to FIFO when every request rides the default tier. The placement
        policy picks the decode replica (per-replica free blocks,
        reservations included); in disaggregated mode the least-loaded
        admissible prefill worker runs the prefill and the decode budget is
        reserved on the target until the handoff lands. Returns a tagged
        plan: ``("admit", req, pcore, pull)`` for a fresh request,
        ``("resume", req, dcore)`` for a preemption checkpoint re-entering,
        or ``("preempt", victim, vcore)`` when the head can't place but a
        strictly-lower-tier decode could make room."""
        if not self._queue:
            return None
        req = min(self._queue, key=lambda r: (r.priority, r.t_submit, r.uid))
        tr = get_tracer()
        t_place = tr.now() if (tr.enabled and req.trace is not None) else None
        # quarantined/probation replicas take no placements (the identity
        # filter when resilience is off — legacy placement is untouched)
        candidates = [c for c in self.decode if self._placeable(c)]
        if req._checkpoint is not None:
            # a preemption checkpoint is a local device/host payload; it
            # cannot cross a process boundary onto a remote replica
            candidates = [c for c in candidates
                          if not getattr(c, "is_remote", False)]
        elif self.prefill and self._kv_transport.name != "remote":
            # a disaggregated handoff only reaches a remote replica over
            # the remote KV wire — other transports can't cross processes
            candidates = [c for c in candidates
                          if not getattr(c, "is_remote", False)]
        dcore = self._placement.choose(candidates, req, self)
        if dcore is None:
            plan = self._plan_preemption_locked(req)
            if plan is not None:
                return plan
            self.metrics.inc("admission_blocked_total")
            return None
        if req._checkpoint is not None:
            # a preempted stream re-entering: no prefill leg, no handoff
            # reservation — the checkpoint imports straight onto the target
            self._target[req.uid] = dcore
            self._queue.remove(req)
            if t_place is not None:
                tr.complete("placement", t_place, key=req.uid,
                            parent=req.trace.phase,
                            args={"decode": dcore.name, "resume": True})
            return ("resume", req, dcore)
        if self.prefill:
            candidates = [c for c in self.prefill
                          if self._placeable(c)
                          and c.admissible(req, prefill_only=True)]
            if not candidates:
                self.metrics.inc("admission_blocked_total")
                return None
            pcore = min(candidates, key=lambda c: len(c.requests))
            blocks = dcore.blocks_needed(req)
            self._resv[req.uid] = (dcore, blocks)
            r = self._reserved[dcore.name]
            r[0] += blocks
            r[1] += 1
            # _complete_handoff pops this; colocated admits have no handoff
            # leg, so recording a "planned" replica there would leak the
            # entry for the request's whole lifetime
            self._target[req.uid] = dcore
        else:
            pcore = dcore
        self._queue.remove(req)
        if t_place is not None:
            tr.complete("placement", t_place, key=req.uid,
                        parent=req.trace.phase,
                        args={"prefill": pcore.name, "decode": dcore.name})
        return ("admit", req, pcore, self._plan_prefix_pull_locked(req, pcore))

    def _plan_preemption_locked(self, req: Request):
        """When the head of the queue can't place, look for a victim: a
        DECODE-state request of a STRICTLY lower tier whose eviction would
        (by block arithmetic) let the head fit on that replica. Among
        fitting victims, the lowest tier loses first, youngest stream
        first (it has the least sunk work). Returns ``("preempt", victim,
        vcore)`` or None — equal-tier work is never preempted, so the
        default-tier fleet behaves exactly as before."""
        if self._elastic is None:
            return None
        best = None
        for core in self.decode:
            if core.retired or not self._placeable(core):
                continue
            if getattr(core, "is_remote", False):
                continue  # checkpoints can't be exported across processes
            bs = int(core._kv_cfg("block_size", 1))
            cap = int(core._kv_cfg("max_blocks_per_seq", 1 << 30))
            need = core.blocks_needed(req)
            resv = self._reserved[core.name][0]
            free = core.free_blocks() - resv
            committed = core.committed_blocks()
            # a snapshot: admission adds to a colocated core's set under
            # its step lock alone
            for victim in list(core.requests.values()):
                if victim.state != RequestState.DECODE:
                    continue
                if victim.priority <= req.priority:
                    continue  # only strictly lower tiers are evictable
                held = (len(victim.prompt_tokens) + victim.num_generated
                        + bs - 1) // bs
                budget = min((len(victim.prompt_tokens)
                              + victim.params.max_new_tokens + bs - 1) // bs,
                             cap)
                # eviction returns the victim's current blocks AND its
                # future claim; the head must fit under both ceilings (the
                # same pair admissible() charges, else the planner preempts
                # for a seat placement will still refuse)
                if (need > free + held
                        or need > core.kv_total - (committed - budget) - resv):
                    continue  # evicting this one still wouldn't seat the head
                key = (victim.priority, victim.t_first_token or 0.0)
                if best is None or key > best[0]:
                    best = (key, victim, core)
        if best is None:
            return None
        return ("preempt", best[1], best[2])

    def _plan_prefix_pull_locked(self, req: Request, seed_core: EngineCore):
        """Directory consult for the core that will SEED this request (the
        colocated/prefill core running its prefill): if a peer's last
        advertisement covers a strictly longer contiguous run of the
        request's prefix chain than the seed core's own, plan a pull of
        the uncovered tail. Pure planning — advertisement snapshots only,
        no engine locks (the live trie must not be read under _cond)."""
        if seed_core.host_tier() is None:
            return None
        keys = seed_core.prefix_chain(req.prompt_tokens)
        if not keys:
            return None
        covered = self.directory.coverage(seed_core.name, keys)
        peer = self.directory.best_peer(keys, exclude=seed_core.name,
                                        min_extra=covered + 1)
        if peer is None:
            return None
        src = next((c for c in self.cores if c.name == peer[0]), None)
        if src is None or not self._placeable(src):
            return None
        return (src, seed_core, keys[covered:peer[1]])

    def _execute_prefix_pull(self, src: EngineCore, dst: EngineCore, keys) -> int:
        """Copy the planned prefix blocks from ``src`` into ``dst``'s host
        tier. Host-tier entries move host-to-host (no device work); blocks
        only the source's device trie holds are gathered in ONE batched
        export. Source and target locks are taken sequentially, never
        nested — no ordering constraint against stepping. A stale
        advertisement just shortens (or empties) the pulled run; the
        request then re-prefills the remainder — correctness never depends
        on the pull."""
        faults = get_fault_injector()
        if faults.enabled:
            faults.check("peer_pull", replica=src.name)
        pulled = []
        with src.step_lock:
            tier = src.host_tier()
            cache = src.prefix_cache()
            by_hash = (cache.blocks_by_hash()
                       if cache is not None and hasattr(cache, "blocks_by_hash")
                       else {})
            dev_keys = [k for k in keys
                        if (tier is None or k not in tier) and k in by_hash]
            dev_payload = None
            if dev_keys and hasattr(src.engine, "export_kv_blocks"):
                dev_payload = src.engine.export_kv_blocks(
                    [by_hash[k] for k in dev_keys])
            dev_pos = {k: i for i, k in enumerate(dev_keys)}
            for key in keys:
                entry = tier.peek(key) if tier is not None else None
                if entry is None and dev_payload is not None and key in dev_pos:
                    i = dev_pos[key]
                    entry = {name: np.asarray(plane[:, i])  # per-block split of ONE batched device gather above; planes are already host numpy (peer pulls feed the HOST tier by contract), no device sync here
                             for name, plane in dev_payload.items()}
                if entry is None:
                    break  # advert went stale: keep the contiguous head only
                pulled.append((key, entry))
        if not pulled:
            return 0
        n = 0
        with dst.step_lock:
            dtier = dst.host_tier()
            if dtier is not None:
                for key, entry in pulled:
                    if dtier.put(key, entry, peer_pull=True):
                        n += 1
        return n

    def _coordinate(self):
        while True:
            plan = None
            with self._cond:
                while True:
                    if self._stopping and not self._queue and not self._by_uid:
                        self._idle.set()
                        self._cond.notify_all()
                        return
                    self._expire_queue_locked()
                    if self._resilience is not None:
                        # watchdog first: a hang recovery requeues streams
                        # the admission pass below can immediately place
                        self._scan_hangs_locked()
                    plan = self._plan_admission_locked()
                    if plan is not None:
                        break
                    if self._resilience is not None:
                        plan = self._probe_plan_locked()
                        if plan is not None:
                            break
                    if not self._queue and not self._by_uid:
                        self._idle.set()
                        self._flush_monitor()
                    now = time.monotonic()
                    deadlines = [r.deadline for r in self._queue
                                 if r.deadline is not None]
                    timeout = None
                    if deadlines:
                        timeout = max(0.0, min(deadlines) - now)
                    if self._queue:
                        # head may become admissible as other engines free
                        # blocks — workers notify after every step, the
                        # poll is only a backstop against missed wakeups
                        poll = self.poll_interval_s * 5
                        timeout = min(poll, timeout) if timeout is not None else poll
                    if self._resilience is not None:
                        bound = self._resilience_wait_bound_locked(now)
                        timeout = min(timeout, bound) if timeout is not None else bound
                    self._cond.wait(timeout)
            if plan[0] == "probe":
                self._execute_probe(plan[1])
                continue
            if plan[0] == "preempt":
                _, victim, vcore = plan
                if not self._execute_preemption(victim, vcore):
                    # victim raced to a non-preemptible state: back off one
                    # poll so the planner doesn't spin on it
                    time.sleep(self.poll_interval_s)
                continue
            if plan[0] == "resume":
                _, req, dcore = plan
                self._execute_resume(req, dcore)
                continue
            _, req, pcore, pull = plan
            if pull is not None:
                # seed the target's host tier from the peer BEFORE admission:
                # submit()'s seed_from_cache then re-imports the pulled
                # blocks instead of re-prefilling them
                src, dst, keys = pull
                try:
                    n_pulled = self._edge_retries(
                        lambda: self._execute_prefix_pull(src, dst, keys),
                        "peer_pull_retries_total", "peer_pull",
                        f"{src.name}->{dst.name}")
                except Exception as e:
                    # a pull is an optimization, never a correctness
                    # dependency: the request re-prefills what it covers
                    n_pulled = 0
                    log_event("peer_pull_failed", source=src.name,
                              target=dst.name,
                              error=f"{type(e).__name__}: {e}")
                    logger.warning(
                        f"serving: prefix pull {src.name}->{dst.name} failed: "
                        f"{type(e).__name__}: {e}")
                if n_pulled:
                    with self._cond:
                        self.metrics.inc("prefix_peer_pulls_total")
                        self.metrics.inc("prefix_peer_pull_blocks_total", n_pulled)
            err = None
            # the bookkeeping lands before the step lock is released: once
            # it is, the worker may step the request to its first token,
            # hand it off and finish it, and a later PREFILL / owner write
            # would undo that (the JAX router writes them after)
            with pcore.step_lock:
                try:
                    pcore.admit(req)
                except Exception as e:
                    # late inadmissibility (e.g. raced config change): isolate
                    err = str(e)
                with self._cond:
                    if err is None:
                        req.state = RequestState.PREFILL
                        req.t_admitted = time.monotonic()
                        if req.trace is not None:
                            mark_admitted(req, core=pcore.name)
                        self._owner[req.uid] = pcore
                        self.metrics.inc("prefill_tokens_total",
                                         len(req.engine_prompt))
                    else:
                        self._release_resv_locked(req.uid)
                        self._by_uid.pop(req.uid, None)
                        self._terminate_locked(req, RequestState.REJECTED,
                                               "inadmissible", err)
                        self.metrics.inc("requests_rejected_total")
                    self.metrics.set_gauge("queue_depth", len(self._queue))
                    self.metrics.set_gauge("active_requests", len(self._owner))
                    self._cond.notify_all()

    # -- QoS preemption / resume (elastic) -------------------------------
    def _execute_preemption(self, victim: Request, vcore: EngineCore) -> bool:
        """Checkpoint ``victim`` off ``vcore`` and put it back in the
        admission queue (original ``t_submit``, so it re-enters at the
        front of its own tier). Returns True when the preemption landed.
        Lock order: vcore.step_lock -> self._cond."""
        from deepspeed_tpu_torch.serving.elastic.preemption import (
            preempt_sequence, preemptible,
        )
        if getattr(vcore, "is_remote", False):
            return False  # no checkpoint export across a process boundary
        with vcore.step_lock:
            with self._cond:
                if victim.is_terminal or self._owner.get(victim.uid) is not vcore:
                    return False
            if not preemptible(vcore.engine, victim.uid):
                return False  # mid-prefill or no pending token yet: not now
            tr = get_tracer()
            t0 = tr.now() if (tr.enabled and victim.trace is not None) else None
            try:
                ho = preempt_sequence(vcore.engine, victim.uid)
            except Exception as e:
                logger.warning(
                    f"serving: preempting uid={victim.uid} on {vcore.name} "
                    f"failed: {type(e).__name__}: {e}")
                return False
            vcore.release(victim.uid)
            if t0 is not None:
                tr.complete("preempt", t0, key=victim.uid,
                            parent=victim.trace.phase,
                            args={"replica": vcore.name,
                                  "blocks": getattr(ho, "n_blocks", 0)})
            log_event("preempt", uid=victim.uid, replica=vcore.name,
                      qos=victim.params.qos,
                      tokens=len(victim.generated))
            with self._cond:
                victim._checkpoint = ho
                victim.preemptions += 1
                victim.state = RequestState.QUEUED
                if victim.trace is not None:
                    mark_preempted(victim)
                self._owner.pop(victim.uid, None)
                self._queue.append(victim)
                self.metrics.inc("requests_preempted_total")
                self.metrics.observe_tier(victim.params.tenant,
                                          victim.params.qos, "preempted_total")
                self.metrics.set_gauge("queue_depth", len(self._queue))
                self._update_tier_queue_locked()
                self._cond.notify_all()
        return True

    def preempt(self, uid: int) -> bool:
        """Forcibly checkpoint a running request back into the admission
        queue (the test/operator entry point; the planner path preempts
        on tier pressure automatically)."""
        with self._cond:
            req = self._by_uid.get(uid)
            core = self._owner.get(uid)
        if req is None or core is None:
            return False
        return self._execute_preemption(req, core)

    def _execute_resume(self, req: Request, dcore: EngineCore) -> None:
        """Import a preemption checkpoint onto its planned replica and make
        the stream RUNNING again — the mirror of ``_complete_handoff``."""
        from deepspeed_tpu_torch.serving.elastic.preemption import resume_sequence
        ho = req._checkpoint
        with dcore.step_lock:
            if req.is_terminal:
                with self._cond:
                    self._target.pop(req.uid, None)
                return
            tr = get_tracer()
            t0 = tr.now() if (tr.enabled and req.trace is not None) else None
            try:
                self._edge_retries(
                    lambda: resume_sequence(dcore.engine, ho),
                    "handoff_retries_total", "handoff.import",
                    f"resume:{dcore.name}")
            except Exception as e:
                logger.warning(
                    f"serving: resume of uid={req.uid} onto {dcore.name} "
                    f"failed: {type(e).__name__}: {e}")
                with self._cond:
                    # resilience: the checkpoint import died but the stream
                    # is still fully re-derivable — replay it
                    if self._requeue_for_replay_locked(
                            req, f"resume import: {type(e).__name__}: {e}"):
                        self._cond.notify_all()
                        return
                    self._release_resv_locked(req.uid)
                    self._by_uid.pop(req.uid, None)
                    self._cancel_uids.discard(req.uid)
                    self._terminate_locked(
                        req, RequestState.FAILED, "error",
                        error=f"resume import: {type(e).__name__}: {e}")
                return
            if t0 is not None:
                tr.complete("resume", t0, key=req.uid,
                            parent=req.trace.phase,
                            args={"replica": dcore.name,
                                  "blocks": getattr(ho, "n_blocks", 0)})
            log_event("resume", uid=req.uid, replica=dcore.name,
                      qos=req.params.qos)
            with self._cond:
                dcore.requests[req.uid] = req
                self._owner[req.uid] = dcore
                self._target.pop(req.uid, None)
                req._checkpoint = None
                req.state = RequestState.DECODE
                if req.trace is not None:
                    mark_resumed(req, core=dcore.name)
                self.metrics.inc("requests_resumed_total")
                self.metrics.set_gauge("queue_depth", len(self._queue))
                self.metrics.set_gauge("active_requests", len(self._owner))
                self._update_tier_queue_locked()
                self._cond.notify_all()

    # -- handoff ---------------------------------------------------------
    def _abort_handoff(self, ho, source) -> None:
        """Unwind a handoff that will never import: zero the inflight-
        window gauge (the aborted import released its claim on every
        window — a mid-chunk fault must not leak window
        credits) and release transport-side state (a remote export's
        staged payload at the source endpoint)."""
        self.metrics.handoff_aborted(ho.transport)
        if source is None:
            return
        try:
            get_transport(ho.transport).abort(source.engine, ho)
        except Exception as e:  # release is best-effort; never mask the abort
            logger.warning(
                f"serving: transport abort of uid={ho.uid} on "
                f"{source.name} failed: {type(e).__name__}: {e}")

    def _complete_handoff(self, req: Request, ho, source=None):
        with self._cond:
            target = self._target.get(req.uid)
        if target is None:  # terminated mid-flight
            self._abort_handoff(ho, source)
            return
        with target.step_lock:
            if req.is_terminal:
                self._abort_handoff(ho, source)
                return
            tr = get_tracer()
            t0 = tr.now() if (tr.enabled and req.trace is not None) else None
            ho_t0 = time.monotonic()
            try:
                if getattr(target, "is_remote", False):
                    # remote adopt: only the META descriptor crosses the
                    # control wire — the agent FETCHes the staged payload
                    # from the source's KVEndpoint over the remote KV wire
                    copied = self._edge_retries(
                        lambda: target.adopt(req, ho),
                        "handoff_retries_total", "handoff.import",
                        f"{target.name}")
                else:
                    # safe to retry: a failed import_sequence unwinds its
                    # own allocations (sched.finish in its except), so
                    # every attempt starts from a clean target
                    copied = self._edge_retries(
                        lambda: import_sequence(target.engine, ho),
                        "handoff_retries_total", "handoff.import",
                        f"{target.name}")
            except Exception as e:
                log_event("handoff_failed", uid=req.uid, target=target.name,
                          error=f"{type(e).__name__}: {e}")
                logger.warning(
                    f"serving: handoff import of uid={req.uid} onto "
                    f"{target.name} failed: {type(e).__name__}: {e}")
                # exhausted retries: whatever windows this handoff claimed
                # are no longer in flight — unwind the gauge and any staged
                # remote transfer BEFORE replay re-enters admission
                self._abort_handoff(ho, source)
                with self._cond:
                    # resilience: the first token was already delivered and
                    # the prompt is intact — replay seats it elsewhere
                    if self._requeue_for_replay_locked(
                            req, f"handoff import: {type(e).__name__}: {e}"):
                        self._cond.notify_all()
                        return
                    self._release_resv_locked(req.uid)
                    self._by_uid.pop(req.uid, None)
                    self._cancel_uids.discard(req.uid)
                    self._terminate_locked(
                        req, RequestState.FAILED, "error",
                        error=f"handoff import: {type(e).__name__}: {e}")
                return
            if t0 is not None:
                tr.complete("handoff.import", t0, key=req.uid,
                            parent=req.trace.phase,
                            args={"target": target.name,
                                  "blocks": ho.n_blocks, "copied": copied,
                                  "transport": ho.transport,
                                  "chunks": ho.inflight_windows})
            with self._cond:
                target.requests[req.uid] = req
                self._owner[req.uid] = target
                self._release_resv_locked(req.uid)
                target.handoffs_in += 1
                self.metrics.inc("kv_handoffs_total")
                self.metrics.inc("kv_handoff_blocks_total", ho.n_blocks)
                self.metrics.inc("kv_handoff_blocks_copied_total", copied)
                # latency from export dispatch (stamped in _worker_pass)
                # through the import landing — the wire the transport owns
                self.metrics.observe_handoff(
                    ho.transport, nbytes=ho.nbytes,
                    seconds=time.monotonic() - getattr(ho, "_t0", ho_t0),
                    inflight_windows=ho.inflight_windows)
                self._cond.notify_all()

    # -- elastic fleet (autoscaling) -------------------------------------
    def scaling_signals(self):
        """One control-loop sample of admission pressure (see
        :class:`ScalingSignals`)."""
        from deepspeed_tpu_torch.serving.elastic.controller import ScalingSignals
        with self._cond:
            now = time.monotonic()
            slacks = [r.deadline - now for r in self._queue
                      if r.deadline is not None]
            # quarantined replicas are dead capacity: the controller sees
            # only the PLACEABLE fleet, so a failure mid-burst reads as
            # pressure (scale up) instead of idle surplus (scale down)
            placeable = sum(1 for c in self.decode if self._placeable(c))
            return ScalingSignals(
                queue_depth=len(self._queue),
                active_requests=len(self._owner),
                n_decode=placeable,
                spares_available=(self._spares.available
                                  if self._spares is not None else 0),
                min_queue_slack_s=min(slacks) if slacks else None,
                n_quarantined=len(self.decode) - placeable,
            )

    def add_decode_replica(self, engine=None) -> Optional[EngineCore]:
        """Grow the decode fleet by one replica. Without an explicit
        ``engine`` a warm spare is drawn from the pool (its post-warm
        signature — the kernel libraries loaded — rides along as
        ``core._warm_baseline``, ``assert_warm_replicas``' anchor). Returns the new core, or None when no engine
        is available. Safe before or after ``start()``."""
        baseline = None
        if engine is None and self._spares is not None:
            engine, baseline = self._spares.acquire()
        if engine is None:
            return None
        with self._cond:
            tmpl = self.decode[0]
            name = f"d{self._decode_seq}"
            self._decode_seq += 1
        core = EngineCore(
            engine, name=name, role=tmpl.role,
            decode_steps=tmpl.decode_steps, kv_headroom=tmpl.kv_headroom,
            spec_k=tmpl.spec_k, metrics=self.metrics,
        )
        core._warm_baseline = baseline
        if self._resilience is not None:
            core.health.configure(self._resilience)
        with self._cond:
            self.decode.append(core)
            self.cores.append(core)
            self._reserved[core.name] = [0, 0]
            self._tally[core.name] = {"finished": 0, "ttft_sum": 0.0,
                                      "ttft_n": 0, "tpot_sum": 0.0,
                                      "tpot_n": 0}
            if self._threads and not self._stopping:
                t = threading.Thread(target=self.run_in_engine_scope,
                                     args=(self._worker, core),
                                     name=f"serving-{core.name}", daemon=True)
                self._threads.append(t)
                t.start()
            self.metrics.inc("scale_up_total")
            self.metrics.set_gauge("decode_replicas", len(self.decode))
            if self._spares is not None:
                self.metrics.set_gauge("warm_spares", self._spares.available)
            log_event("scale_up", replica=core.name,
                      decode_replicas=len(self.decode),
                      warm=baseline is not None)
            self._cond.notify_all()
        return core

    def remove_decode_replica(self) -> Optional[str]:
        """Retire one IDLE decode replica (no resident requests, no
        reservations, no planned targets, above the configured minimum) and
        return its engine to the warm-spare pool (re-warmed — scale-down
        must leave the spare as admission-ready as spawn did). Returns the
        retired core's name or None when nothing is retirable."""
        floor = (self._elastic.min_decode_replicas
                 if self._elastic is not None else 1)
        with self._cond:
            if len(self.decode) <= floor:
                return None
            victim = None
            for core in reversed(self.decode):
                if core.retired or core.requests:
                    continue
                if getattr(core, "is_remote", False):
                    continue  # a facade has no engine to pool as a spare
                if any(self._reserved[core.name]):
                    continue
                if any(t is core for t in self._target.values()):
                    continue
                victim = core
                break
            if victim is None:
                return None
            victim.retired = True
            self.decode.remove(victim)
            self.cores.remove(victim)
            self.metrics.inc("scale_down_total")
            self.metrics.set_gauge("decode_replicas", len(self.decode))
            log_event("scale_down", replica=victim.name,
                      decode_replicas=len(self.decode))
            self._cond.notify_all()
        if self._spares is not None:
            # re-warm under the victim's step lock: its worker may still be
            # draining its final advert pass
            with victim.step_lock:
                self._spares.add(victim.engine)
            with self._cond:
                self.metrics.set_gauge("warm_spares", self._spares.available)
        return victim.name

    def assert_warm_replicas(self) -> int:
        """Assert no kernel library was built or loaded since each
        scaled-up replica's warm-up (admission is wiring, never building).
        Returns the number of replicas checked."""
        from deepspeed_tpu_torch.serving.elastic.spares import assert_no_new_traces
        with self._cond:
            cores = [c for c in self.decode
                     if getattr(c, "_warm_baseline", None) is not None]
        for core in cores:
            assert_no_new_traces(core.engine, core._warm_baseline,
                                 label=f"replica {core.name}")
        return len(cores)

    # -- workers ---------------------------------------------------------
    def _core_flags_locked(self, core: EngineCore) -> bool:
        # snapshots (list() copies in one step): admission adds to the set
        # under the core's step lock alone
        return any(uid in self._cancel_uids for uid in list(core.requests))

    def _core_deadline_locked(self, core: EngineCore) -> Optional[float]:
        deadlines = [r.deadline for r in list(core.requests.values())
                     if r.deadline is not None]
        return min(deadlines) if deadlines else None

    def _expire_core_locked(self, core: EngineCore):
        now = time.monotonic()
        for req in list(core.requests.values()):
            if req.uid in self._cancel_uids:
                self._finish_on_locked(core, req, RequestState.CANCELLED, "cancelled")
            elif req.deadline is not None and now >= req.deadline:
                self._finish_on_locked(core, req, RequestState.TIMED_OUT, "timeout")

    def _refresh_metrics_locked(self, core: EngineCore):
        self.metrics.update_kv(
            sum(c.free_blocks() for c in self.cores),
            sum(c.kv_total for c in self.cores),
        )
        # prefix-cache rollup: counters are per-replica monotone, so the
        # sums are too; the rate is recomputed from the summed counters
        agg = None
        for c in self.cores:
            cache = c.prefix_cache()
            if cache is None:
                continue
            st = cache.stats()
            if agg is None:
                agg = dict(st)
            else:
                for k, v in st.items():
                    agg[k] = agg.get(k, 0) + v
        if agg is not None:
            agg["hit_rate"] = (
                agg["hits"] / agg["queries"] if agg.get("queries") else 0.0
            )
            self.metrics.update_prefix_cache(agg)
        # host-tier rollup (bytes/blocks are gauges, the rest monotone
        # per-replica counters, so summing preserves both semantics)
        tiers = [t for t in (c.host_tier() for c in self.cores) if t is not None]
        if tiers:
            agg_t: Dict[str, float] = {}
            for t in tiers:
                for k, v in t.stats().items():
                    agg_t[k] = agg_t.get(k, 0) + v
            self.metrics.update_host_tier(agg_t)
        st = core.replica_stats()
        st["reserved_blocks"] = self._reserved[core.name][0]
        st["requests_finished_total"] = self._tally[core.name]["finished"]
        self.metrics.update_replica(core.name, st, role=core.role,
                                    remote=getattr(core, "is_remote", False))
        self.metrics.set_gauge("active_requests", len(self._owner))

    def _maybe_idle_locked(self):
        if not self._queue and not self._by_uid:
            self._idle.set()
            self._flush_monitor()

    def _flush_monitor(self):
        if self.monitor is not None:
            try:
                self.monitor.write_events(self.metrics.to_events())
            except Exception as e:
                logger.warning(f"serving: monitor write failed: {e}")

    def _worker(self, core: EngineCore):
        stall_wait = False
        while True:
            try:
                status = self._worker_pass(core, stall_wait)
            except Exception as e:
                # a dying worker thread must NEVER look like a live
                # replica: mark it failed, recover (or fail) its
                # residents, and keep the thread alive — after a passed
                # probation probe the replica serves again
                self._worker_failed(core, e)
                stall_wait = False
                time.sleep(self.poll_interval_s)
                continue
            if status is None:
                return  # stopping, or retired and drained
            stall_wait = status

    def _worker_failed(self, core: EngineCore, e: BaseException) -> None:
        """A worker-thread pass died OUTSIDE the step path (the step has
        its own handler). The thread held no locks when the exception
        surfaced, so the replica's pool is still readable: residents
        recover via checkpoint export where possible. Unconditionally
        (resilience on or off) the replica is marked failed and
        ``last_error`` surfaces in ``health()`` — a silently dead thread
        previously left a live-looking corpse taking placements."""
        err = f"{type(e).__name__}: {e}"
        logger.warning(f"serving[{core.name}]: worker thread failed: {err}")
        state = core.health.note_crash(err)
        log_event("worker_crash", replica=core.name, error=err, health=state)
        self.metrics.inc("replica_failures_total")
        with core.step_lock:
            with self._cond:
                self._handoff_out.pop(core.name, None)
                self._note_quarantine_locked(core)
                for req in list(core.requests.values()):
                    if self._resilience is not None:
                        self._recover_resident_locked(
                            core, req, pool_readable=True,
                            cause=f"worker crash: {err}")
                    else:
                        self._finish_on_locked(core, req, RequestState.FAILED,
                                               "engine_error", error=err)
                self._replay_inbound_locked(core, f"worker crash: {err}")
                self._cond.notify_all()

    def _worker_pass(self, core: EngineCore, stall_wait: bool) -> Optional[bool]:
        """One wait-step-export-advertise pass of ``core``'s worker.
        Returns None to exit the thread, else the next ``stall_wait``."""
        with self._cond:
            while True:
                if self._stopping and not self._queue and not self._by_uid:
                    self._cond.notify_all()
                    return None
                if core.retired and not core.requests:
                    return None  # scaled down: the core's engine is pooled
                work = (self._core_flags_locked(core) or core.has_work()
                        or bool(self._handoff_in.get(core.name)))
                now = time.monotonic()
                deadline = self._core_deadline_locked(core)
                if deadline is not None and now >= deadline:
                    break
                if work and not stall_wait:
                    break
                timeout = None
                if deadline is not None:
                    timeout = max(0.0, deadline - now)
                if stall_wait:
                    timeout = (min(self.poll_interval_s, timeout)
                               if timeout is not None else self.poll_interval_s)
                self._cond.wait(timeout)
                stall_wait = False
        # the handoffs addressed to this core land first, under its own
        # step lock (the import takes it again: an RLock); those its
        # prefill worker queued after the core failed replay elsewhere
        with self._cond:
            inbound = self._handoff_in.pop(core.name, [])
            if inbound and not self._placeable(core):
                self._replay_inbound_locked(
                    core, f"{core.name} is {core.health.state}", inbound)
                inbound = []
        if inbound:
            with core.step_lock:
                for req, ho, source in inbound:
                    self._complete_handoff(req, ho, source=source)
        # chaos seam: fires when the worker has work to do, OUTSIDE the
        # step lock — the crash surfaces between steps, so the pool is
        # readable and recovery takes the checkpoint route
        faults = get_fault_injector()
        if faults.enabled:
            faults.check("worker.crash", replica=core.name)
        stepped = False
        handoffs = []
        advert = None
        with core.step_lock:
            with self._cond:
                self._expire_core_locked(core)
            if core.has_work():
                stepped = core.step_once(self)
            # directory advertisement: snapshot the held prefix hashes
            # (device trie ∪ host tier) under the step lock — the trie
            # only mutates under stepping, so this is race-free
            if core.prefix_cache() is not None or core.host_tier() is not None:
                advert = core.prefix_hashes()
            # export finished prefills while still under the SOURCE
            # lock (the payload gather must not race the next step's pool
            # writes), then release the source seq
            with self._cond:
                pending = self._handoff_out.pop(core.name, [])
            tr = get_tracer()
            for req, tok in pending:
                if req.is_terminal:
                    continue
                t0 = (tr.now()
                      if (tr.enabled and req.trace is not None) else None)
                t_exp = time.monotonic()
                try:
                    # export is a read-only gather, so attempts are
                    # free to repeat; uid/tok bind per iteration
                    ho = self._edge_retries(
                        lambda uid=req.uid, t=tok: export_sequence(
                            core.engine, uid, t,
                            transport=self._kv_transport),
                        "handoff_retries_total", "handoff.export",
                        f"{core.name}")
                except Exception as e:
                    log_event("handoff_failed", uid=req.uid,
                              source=core.name,
                              error=f"{type(e).__name__}: {e}")
                    with self._cond:
                        # the sequence is still resident and intact:
                        # under resilience, recover it (checkpoint or
                        # replay) instead of failing the stream
                        if self._resilience is not None:
                            self._recover_resident_locked(
                                core, req, pool_readable=True,
                                cause=("handoff export: "
                                       f"{type(e).__name__}: {e}"))
                        else:
                            self._finish_on_locked(
                                core, req, RequestState.FAILED, "error",
                                error=("handoff export: "
                                       f"{type(e).__name__}: {e}"))
                    continue
                ho._t0 = t_exp  # handoff-latency clock: export → import
                if t0 is not None:
                    tr.complete("handoff.export", t0, key=req.uid,
                                parent=req.trace.phase,
                                args={"source": core.name,
                                      "blocks": ho.n_blocks,
                                      "transport": ho.transport,
                                      "chunks": ho.inflight_windows})
                core.release(req.uid)
                with self._cond:
                    self._owner.pop(req.uid, None)
                    core.handoffs_out += 1
                handoffs.append((req, ho))
        # each handoff goes to its TARGET's worker, which imports it under
        # its own lock between its steps: the prefill worker never waits
        # on a decode replica's step
        with self._cond:
            for req, ho in handoffs:
                target = self._target.get(req.uid)
                key = target.name if target is not None else None
                self._handoff_in.setdefault(key, []).append((req, ho, core))
            for req, ho, source in self._handoff_in.pop(None, []):
                self._abort_handoff(ho, source)  # terminated mid-flight
            if advert is not None and self._placeable(core):
                self.directory.advertise(core.name, advert)
            self._refresh_metrics_locked(core)
            self._maybe_idle_locked()
            self._cond.notify_all()
        return not stepped
