"""Replica agent: one decode EngineCore serving a remote Router.

Copy of ``deepspeed_tpu/serving/cluster/agent.py`` over the port's
``EngineCore``, with one change of flow:

  * **ADOPT between steps.** The JAX agent imports a handoff on its RPC
    thread under ``core.step_lock``. A port step holds that lock for its
    whole host-side length (a 64-step round at Mistral-7B width runs for
    seconds), so the RPC, and the router's worker waiting on it, would
    queue behind a whole round. The port's RPC thread decodes the ADOPT's
    META, queues it and replies at once (the reply carries the JAX
    agent's keys, ``ok`` and ``n_blocks``); the step loop imports the
    queue between its steps, under the step lock, retrying a failed
    import (``IMPORT_RETRY``: the transfer stays staged at the exporter
    until an import's DONE). An import whose retries are spent is pushed
    as an ``adopt_failed`` EVENT naming the uid and the transfer id, and
    the router recovers that request (``Router._remote_event``). A CANCEL
    of a queued uid still imports it, so the exporter's stage is fetched
    and released, and releases the sequence at once.

The prefix chain hashes the agent advertises (bootstrap META, STATS) go
as hex strings: they are bytes, which JSON cannot carry (the JAX agent
sends them as they are, and its first STATS push after a prefix-cache hit
fails). The step loop, the RPC thread and all they call run without
autograd on the engine's card (``run_in_engine_scope``): grad mode and the
current device are per thread in torch.

``dstpu serve-agent --join HOST:PORT`` builds exactly the stack a local
decode replica would get — one engine, one :class:`EngineCore`, one
:class:`~..net.endpoint.KVEndpoint` — then JOINS a router's control
plane instead of a local worker thread:

  1. dial the router's :class:`~..net.control.ControlEndpoint` (bounded
     retry) and bootstrap the ``rpc`` channel with a META frame carrying
     the replica's admission geometry (KV pool, scheduler caps, tp
     shards) and its ADVERTISED KV endpoint address;
  2. dial again for the ``events`` channel under the name the router
     assigned (or confirmed);
  3. serve SUBMIT/ADOPT/CANCEL/HEALTH/STATS RPCs from the rpc channel
     while the step loop drives the local core and pushes TOKEN/STATS/
     EVENT frames up the events channel.

ADOPT is the disaggregated path: the frame carries only the handoff's
META descriptor — the agent ``import_sequence``s it, which FETCHes the
staged KV payload straight from the exporting prefill worker's
KVEndpoint over the remote KV wire. Token bytes flow agent -> router;
KV bytes flow worker -> agent; the router never relays either.

Failure semantics: a dead control wire invalidates every resident (the
router has quarantined this replica and is replaying them elsewhere —
or back here, after a re-join and a probation probe), so the agent
drops its resident set, re-dials under the same name, and waits to be
probed. An agent-side engine-step failure releases residents locally
and pushes an ``engine_failed`` EVENT so the router replays them.
"""

import os
import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.serving.cluster.core import (
    EngineCore,
    engine_device_index,
    run_in_engine_scope,
)
from deepspeed_tpu_torch.serving.cluster.handoff import import_sequence
from deepspeed_tpu_torch.serving.net import wire
from deepspeed_tpu_torch.serving.net.control import (
    ControlChannel,
    dial_control,
)
from deepspeed_tpu_torch.serving.net.transport import ensure_endpoint
from deepspeed_tpu_torch.serving.request import Request, SamplingParams
from deepspeed_tpu_torch.serving.resilience.faults import InjectedFault
from deepspeed_tpu_torch.serving.resilience.retry import RetryPolicy, with_retries
from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["ReplicaAgent", "request_from_descriptor"]

DEFAULT_STATS_INTERVAL_S = 0.5
DEFAULT_POLL_INTERVAL_S = 0.005
# an ADOPT's import, retried on the step loop: the transfer stays staged
# at its exporter until an attempt's DONE
IMPORT_RETRY = RetryPolicy()


def request_from_descriptor(obj: Dict) -> Tuple[Request, Optional[int]]:
    """Rebuild the agent-side ``Request`` from a SUBMIT/ADOPT descriptor.

    ``generated`` is pre-seeded with the tokens the router already
    delivered so both sides count ``max_new_tokens`` from the same
    offset, and the router's default EOS rides along so the stop
    decision lands on the same token in both processes."""
    params = SamplingParams(
        max_new_tokens=int(obj.get("max_new_tokens", 64)),
        eos_token_id=(int(obj["eos_token_id"])
                      if obj.get("eos_token_id") is not None else None),
        ignore_eos=bool(obj.get("ignore_eos", False)),
        stop_token_ids=tuple(int(t) for t in obj.get("stop_token_ids", ())),
    )
    req = Request(
        uid=int(obj["uid"]),
        prompt_tokens=np.asarray(obj.get("prompt", ()), dtype=np.int32),  # SUBMIT prompt token ids off the wire, host-born; not a KV payload
        params=params,
        generated=[int(t) for t in obj.get("generated", ())],
    )
    default_eos = obj.get("default_eos")
    return req, (int(default_eos) if default_eos is not None else None)


class _AgentSink:
    """The agent-local sink behind ``EngineCore.step_once``: feed the
    local scheduler, decide termination with the SAME inputs the router
    uses, and forward every new token as a TOKEN frame."""

    def __init__(self, agent: "ReplicaAgent"):
        self.agent = agent

    def deliver(self, core, req, token, feedback=True) -> bool:
        req.generated.append(int(token))
        core.decode_tokens += 1
        if feedback:
            core.engine.scheduler.feedback(req.uid, int(token))
        self.agent._push(wire.F_TOKEN, {"uid": int(req.uid),
                                        "tok": int(token)})
        reason = req.should_stop(int(token),
                                 self.agent._default_eos.get(req.uid))
        if reason is None:
            return True
        # terminal: free scheduler/KV state here; the router reaches the
        # same verdict from the same token and finishes the stream there
        core.release(req.uid)
        self.agent._default_eos.pop(req.uid, None)
        return False

    def engine_failed(self, core, error) -> None:
        uids = sorted(core.requests)
        for uid in uids:
            core.release(uid)
            self.agent._default_eos.pop(uid, None)
        self.agent._push(wire.F_EVENT, {
            "event": "engine_failed", "error": str(error), "uids": uids})

    def finish_capped(self, core, req) -> None:
        core.release(req.uid, scheduler_done=True)
        self.agent._default_eos.pop(req.uid, None)
        self.agent._push(wire.F_TOKEN, {"uid": int(req.uid),
                                        "fin": "length_cap"})


class ReplicaAgent:
    """Drives one local decode :class:`EngineCore` for a remote Router."""

    def __init__(self, core: EngineCore, join: Tuple[str, int], *,
                 name: Optional[str] = None,
                 metrics=None,
                 dial_retry: Optional[RetryPolicy] = None,
                 stats_interval_s: float = DEFAULT_STATS_INTERVAL_S,
                 poll_interval_s: float = DEFAULT_POLL_INTERVAL_S):
        if core.role != "decode":
            raise ValueError(
                f"serve-agent cores are decode replicas (got {core.role!r})")
        self.core = core
        self.join = (str(join[0]), int(join[1]))
        self.name = name  # router-assigned after the first bootstrap
        self.metrics = metrics
        self._dial_retry = dial_retry or RetryPolicy(
            attempts=5, backoff_s=0.2, max_backoff_s=2.0)
        # ADOPTs acknowledged on the rpc thread, imported by the step loop
        # between steps: (req, default_eos, handoff); uids cancelled while
        # queued are released right after their import
        self._adopts: deque = deque()
        self._adopt_lock = threading.Lock()
        self._cancelled_adopts: set = set()
        self.import_retries = 0
        self._device = engine_device_index(core.engine)
        self._stats_interval_s = float(stats_interval_s)
        self._poll_interval_s = float(poll_interval_s)
        self._sink = _AgentSink(self)
        # per-uid default EOS from the descriptor (the ROUTER's default,
        # not this process's — both sides must stop on the same token)
        self._default_eos: Dict[int, Optional[int]] = {}
        self._endpoint = ensure_endpoint(core.engine)
        self._rpc: Optional[ControlChannel] = None
        self._events: Optional[ControlChannel] = None
        self._wire_lost = threading.Event()
        self._stop = threading.Event()
        self._rpc_thread: Optional[threading.Thread] = None
        self._last_stats = 0.0

    # -- bootstrap --------------------------------------------------------
    def _bootstrap_meta(self) -> Dict:
        core = self.core
        with core.step_lock:
            prefix = sorted(h.hex() for h in core.prefix_hashes())
            free = core.free_blocks()
            stats = core.replica_stats()
        return {
            "channel": "rpc",
            "name": self.name,
            "pid": os.getpid(),
            "tp_shards": core.tp_shards(),
            "decode_steps": core.decode_steps,
            "kv_headroom": core.kv_headroom,
            "kv": {
                "num_blocks": core.kv_total,
                "block_size": core._kv_cfg("block_size", 1),
                "max_blocks_per_seq": core._kv_cfg("max_blocks_per_seq",
                                                   1 << 30),
            },
            "sm": {
                "max_tracked_sequences": core._sm_cfg(
                    "max_tracked_sequences", None),
                "max_context": core._sm_cfg("max_context", None),
            },
            "kv_info": core.kv_info,
            "free_blocks": free,
            "prefix": prefix,
            "stats": stats,
            "kv_endpoint": list(self._endpoint.address),
            "kv_endpoint_stats": self._endpoint.stats(),
        }

    def connect(self) -> "ReplicaAgent":
        """Dial both channels (bounded retry) and start the rpc serve
        thread. Safe to call again after a wire loss — residents were
        already dropped, the router re-admits us via a probation probe."""
        rpc, ack = dial_control(
            self.join, self._bootstrap_meta(),
            retry_policy=self._dial_retry,
            name="rpc", replica=self.name or "agent", metrics=self.metrics)
        self.name = str(ack.get("name", self.name or "agent"))
        try:
            events, _ = dial_control(
                self.join, {"channel": "events", "name": self.name},
                retry_policy=self._dial_retry,
                name="events", replica=self.name, metrics=self.metrics)
        except BaseException:
            rpc.close()
            raise
        self._rpc, self._events = rpc, events
        self._wire_lost.clear()
        self._rpc_thread = threading.Thread(
            target=run_in_engine_scope, args=(self._device, self._serve_rpc, rpc),
            name=f"agent-{self.name}-rpc", daemon=True)
        self._rpc_thread.start()
        logger.info(f"serve-agent[{self.name}]: joined router at "
                    f"{self.join[0]}:{self.join[1]} "
                    f"(kv_endpoint={self._endpoint.address})")
        return self

    def _on_wire_lost(self, where: str, err) -> None:
        if self._stop.is_set() or self._wire_lost.is_set():
            return
        logger.warning(f"serve-agent[{self.name}]: {where} channel lost: "
                       f"{type(err).__name__}: {err}")
        # every resident is invalid now: the router quarantined this
        # replica on its side of the same break and is replaying them
        with self.core.step_lock:
            for uid in list(self.core.requests):
                self.core.release(uid)
        # queued ADOPTs too: the router replays them, and releases their
        # staged transfers at the exporter (Router._agent_lost)
        with self._adopt_lock:
            self._adopts.clear()
            self._cancelled_adopts.clear()
        self._default_eos.clear()
        self._wire_lost.set()

    # -- rpc serve loop ---------------------------------------------------
    def _serve_rpc(self, channel: ControlChannel) -> None:
        try:
            while not self._stop.is_set():
                ftype, obj = channel.recv()
                if ftype == wire.F_GOODBYE:
                    logger.info(f"serve-agent[{self.name}]: router said "
                                f"goodbye: {obj.get('reason', '')}")
                    self._stop.set()
                    return
                try:
                    reply = self._dispatch(ftype, obj)
                except InjectedFault:
                    raise
                except Exception as e:
                    channel.send(wire.F_ERROR,
                                 {"error": f"{type(e).__name__}: {e}"})
                    continue
                channel.send(ftype, reply)
        except (wire.WireError, OSError, InjectedFault) as e:
            self._on_wire_lost("rpc", e)

    def _dispatch(self, ftype: int, obj: Dict) -> Dict:
        core = self.core
        if ftype == wire.F_SUBMIT:
            req, default_eos = request_from_descriptor(obj)
            with core.step_lock:
                core.admit(req)
            self._default_eos[req.uid] = default_eos
            return {"ok": True}
        if ftype == wire.F_ADOPT:
            req, default_eos = request_from_descriptor(obj["req"])
            ho = wire.decode_handoff_meta(bytes.fromhex(obj["meta"]))
            # the step loop imports it between steps (import_adopts): the
            # import FETCHes the staged payload straight from the exporting
            # worker's KVEndpoint (handoff.endpoint) — the KV bytes never
            # transit the router's control wire
            with self._adopt_lock:
                self._adopts.append((req, default_eos, ho))
            return {"ok": True, "n_blocks": int(ho.n_blocks)}
        if ftype == wire.F_CANCEL:
            uid = int(obj["uid"])
            # the router flushes CANCEL for every router-side finish; the
            # agent may already have dropped the uid on its own terminal
            # token — unknown uids are a no-op, not an error
            with self._adopt_lock:
                if any(r.uid == uid for r, _, _ in self._adopts):
                    self._cancelled_adopts.add(uid)
            with core.step_lock:
                if uid in core.requests:
                    core.release(uid)
            self._default_eos.pop(uid, None)
            return {"ok": True}
        if ftype == wire.F_HEALTH:
            try:
                core.probe()
            except Exception as e:
                return {"ok": False, "error": f"{type(e).__name__}: {e}"}
            return {"ok": True}
        if ftype == wire.F_STATS:
            return self._stats_snapshot()
        raise wire.WireError(
            f"unexpected rpc frame: {wire.FRAME_NAMES.get(ftype, ftype)}")

    # -- events push ------------------------------------------------------
    def _push(self, ftype: int, obj: Dict) -> None:
        events = self._events
        if events is None or self._wire_lost.is_set():
            return  # disconnected: the router replays these streams anyway
        try:
            events.send(ftype, obj)
        except (wire.WireError, OSError, InjectedFault) as e:
            self._on_wire_lost("events", e)

    def _stats_snapshot(self) -> Dict:
        core = self.core
        with core.step_lock:
            prefix = sorted(h.hex() for h in core.prefix_hashes())
            free = core.free_blocks()
            stats = core.replica_stats()
        return {
            "free_blocks": free,
            "prefix": prefix,
            "stats": stats,
            "kv_endpoint_stats": self._endpoint.stats(),
        }

    def _push_stats(self, now: float) -> None:
        if now - self._last_stats < self._stats_interval_s:
            return
        self._last_stats = now
        self._push(wire.F_STATS, self._stats_snapshot())

    # -- adopts -----------------------------------------------------------
    def import_adopts(self) -> int:
        """Import every queued ADOPT, in arrival order, under the step lock
        (between steps). Returns the number that became resident."""
        core = self.core
        done = 0

        def note_retry(_attempt, _err):
            self.import_retries += 1

        while True:
            with self._adopt_lock:
                if not self._adopts:
                    return done
                req, default_eos, ho = self._adopts.popleft()
                cancelled = req.uid in self._cancelled_adopts
                self._cancelled_adopts.discard(req.uid)
            try:
                with core.step_lock:
                    with_retries(lambda: import_sequence(core.engine, ho),
                                 IMPORT_RETRY,
                                 label=f"agent.adopt:{self.name}",
                                 on_retry=note_retry)
                    if cancelled:  # fetched (the stage is released): drop it
                        core.engine.scheduler.finish(req.uid)
                    else:
                        core.requests[req.uid] = req
                        core.handoffs_in += 1
                        self._default_eos[req.uid] = default_eos
                        done += 1
            except Exception as e:  # noqa: BLE001 - reported to the router
                logger.warning(f"serve-agent[{self.name}]: import of uid="
                               f"{req.uid} failed: {type(e).__name__}: {e}")
                self._push(wire.F_EVENT, {
                    "event": "adopt_failed", "uid": int(req.uid),
                    "transfer_id": ho.transfer_id,
                    "error": f"{type(e).__name__}: {e}"})

    # -- step loop --------------------------------------------------------
    def step_tick(self) -> bool:
        """One agent-loop iteration: import the queued ADOPTs, step the
        core when it has work, push freshness. Returns True when a step
        ran (tests drive this directly; ``run`` loops it)."""
        core = self.core
        stepped = False
        imported = self.import_adopts()
        with core.step_lock:
            if core.has_work():
                core.step_once(self._sink)
                stepped = True
        now = time.monotonic()
        if stepped or imported:
            self._last_stats = 0.0  # pool state moved: push fresh stats now
        self._push_stats(now)
        return stepped

    def run(self) -> int:
        """Blocking main loop (the CLI entry): connect, step, reconnect on
        wire loss, exit on GOODBYE/stop. The loop runs without autograd on
        the engine's card, whichever thread calls it."""
        return run_in_engine_scope(self._device, self._run)

    def _run(self) -> int:
        self.connect()
        try:
            while not self._stop.is_set():
                if self._wire_lost.is_set():
                    try:
                        self.connect()
                    except (wire.WireError, OSError, InjectedFault) as e:
                        logger.warning(
                            f"serve-agent[{self.name}]: re-join failed, "
                            f"exiting: {e}")
                        return 1
                if not self.step_tick():
                    # idle: wait a poll tick (stop_evt wakes us instantly)
                    self._stop.wait(timeout=self._poll_interval_s)
        finally:
            self.close()
        return 0

    def close(self) -> None:
        self._stop.set()
        for chan in (self._rpc, self._events):
            if chan is not None:
                chan.goodbye("agent shutdown")
                chan.close()
        self._rpc = self._events = None
        if (self._rpc_thread is not None
                and self._rpc_thread is not threading.current_thread()):
            self._rpc_thread.join(timeout=2.0)
        ep = getattr(self.core.engine, "_kv_endpoint", None)
        if ep is not None:
            ep.close()
            self.core.engine._kv_endpoint = None
