"""RemoteEngineHandle: a decode replica living in another process.

Copy of ``deepspeed_tpu/serving/cluster/remote_core.py``. The port's agent
answers an ADOPT as soon as it has queued the import (``agent.py``), so
``adopt`` returns without waiting behind the agent's step; an import that
fails later arrives as an ``adopt_failed`` EVENT (``Router._remote_event``).

The Router consumes an ``EngineCore``-shaped surface — admission
accounting (``admissible``/``blocks_needed``/``committed_blocks``),
prefix-directory advertisement (``prefix_hashes``/``prefix_coverage``),
health probing (``probe``), per-replica stats, and the step loop. This
class implements that surface against a replica AGENT on the other end
of two control channels (:mod:`..net.control`), so SLO placement, the
health state machine, preemption/recovery replay, and the /metrics
labels all work unchanged against a replica the router cannot call into:

  * **admission** is computed locally from the agent's bootstrap META
    (pool geometry, tp shards) plus the freshest STATS push — the agent
    re-checks at SUBMIT/ADOPT time, so a stale cache can only cause a
    late rejection (recovered by replay), never pool corruption.
  * **tokens** arrive as TOKEN frames on the events channel; the pump
    thread feeds them into ``Router.deliver(feedback=False)`` — feedback
    already happened agent-side, exactly like fused/spec rounds.
  * **KV handoffs** ride the existing remote transport: ``adopt`` ships
    only the META descriptor; the agent fetches the staged payload
    straight from the prefill worker's ``KVEndpoint`` (data never
    transits the router).
  * **probes** are HEALTH RPCs with a deadline; a dead agent fails them
    until it re-dials and re-attaches, which is what probation re-admit
    means across a process boundary.

Thread/lock model: the handle's ``step_lock`` guards only its local
bookkeeping (the Router's lock order ``step_lock -> _cond`` is
unchanged); all socket I/O happens on handle-owned threads (token pump,
cancel flusher) or on router threads that hold no router locks (probe,
adopt under this handle's own step_lock) — never under ``_cond``.
"""

import threading
from collections import deque
from typing import Dict, Optional, Tuple

from deepspeed_tpu_torch.serving.net import wire
from deepspeed_tpu_torch.serving.net.control import (
    DEFAULT_CONTROL_TIMEOUT_S,
    ControlChannel,
)
from deepspeed_tpu_torch.serving.request import Request
from deepspeed_tpu_torch.serving.resilience.faults import InjectedFault
from deepspeed_tpu_torch.serving.resilience.health import ReplicaHealth

__all__ = ["RemoteEngineHandle"]


def _prefix_keys(hashes) -> set:
    """Advertised prefix chain hashes as the router's keys: the port's
    agent sends each as a hex string, and the router's chains are bytes."""
    out = set()
    for h in hashes or ():
        if isinstance(h, str):
            try:
                h = bytes.fromhex(h)
            except ValueError:
                pass
        out.add(h)
    return out


class _RemoteStateManager:
    """Just enough state-manager surface for the router's never-fits
    pre-check (``submit`` probes ``check_admissible`` through the engine
    facade before any placement work)."""

    def __init__(self, handle: "RemoteEngineHandle"):
        self._handle = handle

    def check_admissible(self, prompt_len: int) -> None:
        max_ctx = self._handle._sm_cfg("max_context", None)
        if max_ctx is not None and int(prompt_len) >= int(max_ctx):
            raise ValueError(
                f"prompt of {prompt_len} tokens >= max_context={max_ctx} "
                f"on remote replica {self._handle.name}")

    @property
    def free_blocks(self) -> int:
        return self._handle.free_blocks()


class _RemoteEngineFacade:
    """Attribute shim standing where ``core.engine`` would: the router
    only touches ``state_manager`` on decode cores it never steps."""

    def __init__(self, handle: "RemoteEngineHandle"):
        self.state_manager = _RemoteStateManager(handle)
        self.replica_name = handle.name


class RemoteEngineHandle:
    """One remote decode replica, as the Router sees it."""

    is_remote = True

    def __init__(self, name: str, meta: Dict, owner, *,
                 metrics=None, resilience=None,
                 probe_timeout_s: float = 5.0):
        self.name = str(name)
        self.role = "decode"
        self.owner = owner
        self.metrics = metrics
        self.requests: Dict[int, Request] = {}
        self.retired = False
        self.health = ReplicaHealth(self.name)
        if resilience is not None:
            self.health.configure(resilience)
        # the watchdog stamp stays None: remote step liveness is observed
        # through the events channel (frames stop -> pump EOF -> agent
        # lost), not through a step clock the router cannot read
        self.step_started_at: Optional[float] = None
        self._step_failed = False
        self.step_lock = threading.RLock()
        self._probe_timeout_s = float(probe_timeout_s)

        self._meta = dict(meta)
        self.decode_steps = int(meta.get("decode_steps", 1) or 1)
        self.kv_headroom = float(meta.get("kv_headroom", 0.0) or 0.0)
        self.kv_total = int(self._kv_cfg("num_blocks", 0))
        self.kv_info = dict(meta.get("kv_info") or {})
        self.decode_tokens = 0
        self.handoffs_in = 0
        self.handoffs_out = 0
        # spec decode runs agent-side; the router never drafts for it
        self.spec_k = 0
        self.spec_ctl = None
        self.proposer = None
        self.engine = _RemoteEngineFacade(self)

        # agent-reported state (STATS pushes); _cache_lock is a leaf lock
        self._cache_lock = threading.Lock()
        self._free_blocks = int(meta.get("free_blocks", self.kv_total))
        self._prefix: set = _prefix_keys(meta.get("prefix"))
        self._stats: Dict = dict(meta.get("stats") or {})
        self._endpoint_stats: Dict = dict(meta.get("kv_endpoint_stats") or {})
        ep = meta.get("kv_endpoint")
        self._kv_endpoint: Optional[Tuple[str, int]] = (
            (str(ep[0]), int(ep[1])) if ep else None)

        # control channels: generation-stamped so threads of a dead
        # attachment exit quietly after a re-join swaps the channels
        self._conn_gen = 0
        self._rpc: Optional[ControlChannel] = None
        self._events: Optional[ControlChannel] = None
        self._closed = False
        self._outbox: deque = deque()
        self._outbox_evt = threading.Event()
        # uid -> transfer id of each adopted handoff while its request is
        # resident: the agent imports it later (between its steps), so a
        # lost agent may leave it staged at the exporter
        self._adopt_tids: Dict[int, str] = {}

    # -- configuration accessors (bootstrap META instead of engine config) --
    def _kv_cfg(self, name: str, default):
        return dict(self._meta.get("kv") or {}).get(name, default)  # _meta is replaced wholesale (atomic ref swap) under _cache_lock; the local dict() copy is a consistent snapshot

    def _sm_cfg(self, name: str, default):
        return dict(self._meta.get("sm") or {}).get(name, default)  # _meta is replaced wholesale (atomic ref swap) under _cache_lock; the local dict() copy is a consistent snapshot

    def tp_shards(self) -> int:
        return int(self._meta.get("tp_shards", 1) or 1)  # _meta is replaced wholesale (atomic ref swap) under _cache_lock; single-key read off one snapshot

    # -- channel attachment ----------------------------------------------
    @property
    def connected(self) -> bool:
        return (not self._closed and self._rpc is not None  # liveness snapshot for health/placement; channels are attached/cleared atomically under _cache_lock and a stale answer is re-checked by the RPC itself (WireError path)
                and not self._rpc.closed and self._events is not None  # same snapshot
                and not self._events.closed)  # same snapshot

    def attach_rpc(self, channel: ControlChannel) -> None:
        """Attach (or re-attach after an agent re-join) the RPC channel and
        start its cancel flusher."""
        with self._cache_lock:
            self._conn_gen += 1
            gen = self._conn_gen
            old, self._rpc = self._rpc, channel
        if old is not None:
            old.close()
        threading.Thread(target=self._flush_loop, args=(gen, channel),
                         name=f"{self.name}-ctl-flush", daemon=True).start()

    def attach_events(self, channel: ControlChannel) -> None:
        """Attach the events channel and start the token pump."""
        with self._cache_lock:
            gen = self._conn_gen
            old, self._events = self._events, channel
        if old is not None:
            old.close()
        threading.Thread(target=self._pump_loop, args=(gen, channel),
                         name=f"{self.name}-ctl-pump", daemon=True).start()

    def update_meta(self, meta: Dict) -> None:
        """Refresh bootstrap metadata on an agent re-join (the restarted
        process advertises fresh pool state and a new KV endpoint port)."""
        with self._cache_lock:
            self._meta.update(meta)
            self.kv_total = int(self._kv_cfg("num_blocks", self.kv_total))
            self._free_blocks = int(meta.get("free_blocks", self.kv_total))
            ep = meta.get("kv_endpoint")
            if ep:
                self._kv_endpoint = (str(ep[0]), int(ep[1]))
            if meta.get("kv_info"):
                self.kv_info = dict(meta["kv_info"])

    def _stale(self, gen: int) -> bool:
        with self._cache_lock:
            return self._closed or gen != self._conn_gen

    def mark_disconnected(self) -> bool:
        """Tear down the channels WITHOUT retiring the handle (the agent
        may re-dial and re-attach later). Returns ``False`` when there was
        nothing attached — loss handlers from both threads race here and
        only the first should run the recovery path."""
        with self._cache_lock:
            if self._closed:
                return False
            rpc, self._rpc = self._rpc, None
            events, self._events = self._events, None
            if rpc is None and events is None:
                return False
            self._conn_gen += 1
        self._outbox.clear()
        self._outbox_evt.set()
        for chan in (rpc, events):
            if chan is not None:
                chan.close()
        return True

    def close(self, reason: str = "shutdown") -> None:
        with self._cache_lock:
            if self._closed:
                return
            self._closed = True
            self._conn_gen += 1
            rpc, self._rpc = self._rpc, None
            events, self._events = self._events, None
        self._outbox_evt.set()
        for chan in (rpc, events):
            if chan is not None:
                chan.goodbye(reason)
                chan.close()

    # -- pump / flusher threads ------------------------------------------
    def _pump_loop(self, gen: int, channel: ControlChannel) -> None:
        """Drain agent-pushed frames: TOKEN into ``Router.deliver`` (via
        the owner hook, which holds the router locks), STATS into the
        admission caches, EVENT into the event log. A dead wire here IS
        the agent-loss detector."""
        try:
            while not self._stale(gen):
                ftype, obj = channel.recv()
                if ftype == wire.F_TOKEN:
                    self.owner._remote_token(self, obj)
                elif ftype == wire.F_STATS:
                    self._apply_stats(obj)
                    self.owner._remote_stats(self, obj)
                elif ftype == wire.F_EVENT:
                    self.owner._remote_event(self, obj)
                elif ftype == wire.F_GOODBYE:
                    if not self._stale(gen):
                        self.owner._agent_lost(
                            self, f"agent said goodbye: "
                                  f"{obj.get('reason', 'unspecified')}")
                    return
                else:
                    raise wire.WireError(
                        "unexpected frame on events channel: "
                        f"{wire.FRAME_NAMES.get(ftype, ftype)}")
        except (wire.WireError, OSError, InjectedFault, ValueError) as e:
            if self._stale(gen):
                return  # re-join or shutdown already swapped this channel
            self.owner._agent_lost(self, f"events channel: "
                                         f"{type(e).__name__}: {e}")

    def _flush_loop(self, gen: int, channel: ControlChannel) -> None:
        """Forward queued release notices (router-side cancels/finishes)
        as CANCEL RPCs — ``release`` itself runs under router locks and
        must never touch the wire."""
        while not self._stale(gen):
            self._outbox_evt.wait(timeout=0.5)
            self._outbox_evt.clear()
            while True:
                try:
                    uid = self._outbox.popleft()
                except IndexError:
                    break
                if self._stale(gen):
                    return
                try:
                    channel.call(wire.F_CANCEL, {"uid": int(uid)},
                                 timeout_s=DEFAULT_CONTROL_TIMEOUT_S)
                except (wire.WireError, OSError, InjectedFault) as e:
                    if not self._stale(gen):
                        self.owner._agent_lost(
                            self, f"rpc channel: {type(e).__name__}: {e}")
                    return

    def _apply_stats(self, obj: Dict) -> None:
        with self._cache_lock:
            if "free_blocks" in obj:
                self._free_blocks = int(obj["free_blocks"])
            if "stats" in obj and isinstance(obj["stats"], dict):
                self._stats.update(obj["stats"])
            if "prefix" in obj:
                self._prefix = _prefix_keys(obj["prefix"])
            if "kv_endpoint_stats" in obj and isinstance(
                    obj["kv_endpoint_stats"], dict):
                self._endpoint_stats = dict(obj["kv_endpoint_stats"])

    def _rpc_channel(self) -> ControlChannel:
        with self._cache_lock:
            rpc = self._rpc
        if rpc is None or rpc.closed:
            raise RuntimeError(f"{self.name}: agent not connected")
        return rpc

    # -- tiered prefix store (advertised, never locally held) -------------
    def prefix_cache(self):
        return None

    def host_tier(self):
        return None

    def prefix_hashes(self) -> set:
        with self._cache_lock:
            return set(self._prefix)

    def prefix_chain(self, tokens) -> list:
        return []  # the handle holds no trie to seed a pull into

    def prefix_coverage(self, keys) -> int:
        if not keys:
            return 0
        held = self.prefix_hashes()
        n = 0
        for key in keys:
            if key not in held:
                break
            n += 1
        return n

    # -- admission accounting (local math over cached pool state) ---------
    def free_blocks(self) -> int:
        with self._cache_lock:
            return int(self._free_blocks)

    def blocks_needed(self, req: Request, prefill_only: bool = False) -> int:
        bs = int(self._kv_cfg("block_size", 1))
        cap = int(self._kv_cfg("max_blocks_per_seq", 1 << 30))
        total = len(req.prompt_tokens)
        if not prefill_only:
            total += req.params.max_new_tokens
        return min((total + bs - 1) // bs, cap)

    def committed_blocks(self) -> int:
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
        """Same gate as ``EngineCore.admissible`` minus the prefix-cache
        reclaim credit (the handle holds no trie), computed over the
        freshest STATS push. The agent re-checks on SUBMIT/ADOPT — a
        stale cache risks a late rejection, never an overrun pool."""
        if not self.connected or self.retired:
            return False
        max_tracked = self._sm_cfg("max_tracked_sequences", None)
        occupied = len(self.requests) + int(reserved_seqs)
        if max_tracked is not None and occupied >= int(max_tracked):
            return False
        free = self.free_blocks() - int(reserved_blocks)
        if not prefill_only:
            free = min(free, self.kv_total - self.committed_blocks()  # kv_total is an int rewritten atomically on re-join META; admission is advisory and the agent re-checks capacity on SUBMIT
                       - int(reserved_blocks))
        need = self.blocks_needed(req, prefill_only=prefill_only)
        if not occupied:
            return need <= free
        headroom = int(self.kv_headroom * self.kv_total)  # same advisory admission read
        return need + headroom <= free

    # -- request plane (RPCs) ---------------------------------------------
    def _req_descriptor(self, req: Request) -> Dict:
        """What the agent needs to run (and terminate) the stream: the
        ENGINE prompt (replay prompt included — bit-identical recovery is
        the agent re-prefilling prompt+delivered), the stop conditions,
        and tokens already delivered (max_new_tokens accounting). The
        router's default EOS rides along so both sides reach the same
        stop decision on the same token."""
        p = req.params
        default_eos = getattr(self.owner, "eos_token_id", None)
        return {
            "uid": int(req.uid),
            "prompt": [int(t) for t in req.engine_prompt],
            "generated": [int(t) for t in req.generated],
            "max_new_tokens": int(p.max_new_tokens),
            "eos_token_id": (int(p.eos_token_id)
                             if p.eos_token_id is not None else None),
            "ignore_eos": bool(p.ignore_eos),
            "stop_token_ids": [int(t) for t in p.stop_token_ids],
            "default_eos": (int(default_eos)
                            if default_eos is not None else None),
        }

    def admit(self, req: Request) -> None:
        """SUBMIT the request to the agent's scheduler (colocated-mode
        placement and contract tests; disaggregated requests arrive via
        ``adopt``). Registered locally FIRST so the token pump can route
        frames that race the RPC reply."""
        self.requests[req.uid] = req
        try:
            self._rpc_channel().call(
                wire.F_SUBMIT, self._req_descriptor(req))
        except Exception:
            self.requests.pop(req.uid, None)
            raise

    def adopt(self, req: Request, handoff) -> int:
        """Ship a finished prefill to the agent: the KV handoff crosses as
        its META descriptor only — the agent FETCHes the staged payload
        directly from the exporter's KVEndpoint over the remote KV wire.
        Returns the number of KV blocks the agent imported."""
        meta_hex = wire.encode_handoff_meta(handoff).hex()
        self.requests[req.uid] = req
        try:
            reply = self._rpc_channel().call(wire.F_ADOPT, {
                "req": self._req_descriptor(req),
                "meta": meta_hex,
            })
        except Exception:
            self.requests.pop(req.uid, None)
            raise
        with self._cache_lock:
            self._adopt_tids[int(req.uid)] = str(handoff.transfer_id)
        return int(reply.get("n_blocks", 0))

    def adopted_transfers(self) -> list:
        """The transfer ids of the residents' adopted handoffs, forgotten
        here: what a lost agent may have left staged at the exporters."""
        with self._cache_lock:
            tids = list(self._adopt_tids.values())
            self._adopt_tids.clear()
        return tids

    def release(self, uid: int, scheduler_done: bool = False) -> None:
        """Detach a request. Runs under router locks, so the agent-side
        release rides the outbox -> CANCEL flusher instead of the wire.
        ``scheduler_done`` means the agent already dropped its state
        (fin frames, adoption failures, agent loss) — nothing to send."""
        self.requests.pop(uid, None)
        with self._cache_lock:
            self._adopt_tids.pop(int(uid), None)
        if not scheduler_done and not self._closed:  # best-effort gate; a CANCEL enqueued during a racing close() is drained harmlessly (flusher exits, agent treats unknown uids as no-ops)
            self._outbox.append(int(uid))
            self._outbox_evt.set()

    def has_work(self) -> bool:
        return bool(self.requests)

    def step_once(self, sink) -> bool:
        """Remote replicas step in their own process; tokens arrive via
        the pump. The worker pass around this still expires deadlines,
        refreshes advertisements, and rolls metrics up — so this is a
        deliberate no-op, not a stub."""
        return False

    def probe(self, lock_timeout_s: float = 0.5) -> None:
        """Probation probe as a HEALTH RPC with a deadline: the agent runs
        its own ``EngineCore.probe`` (empty step through the fault seam)
        and replies. A dead/wedged/unreachable agent fails the deadline —
        a probe cannot lie about a replica it cannot reach."""
        reply = self._rpc_channel().call(
            wire.F_HEALTH, {"probe": True},
            timeout_s=max(self._probe_timeout_s, float(lock_timeout_s)))
        if not reply.get("ok", False):
            raise RuntimeError(
                f"probe({self.name}): agent reported "
                f"{reply.get('error', 'unhealthy')}")

    # -- observability ---------------------------------------------------
    def kv_endpoint_address(self) -> Optional[Tuple[str, int]]:
        with self._cache_lock:
            return self._kv_endpoint

    def kv_endpoint_stats(self) -> Dict:
        with self._cache_lock:
            return dict(self._endpoint_stats)

    def replica_stats(self) -> Dict[str, float]:
        with self._cache_lock:
            stats = {k: v for k, v in self._stats.items()
                     if isinstance(v, (int, float))}
            free = int(self._free_blocks)
        stats.update({
            "kv_free_blocks": free,
            "kv_total_blocks": self.kv_total,  # stats snapshot; kv_total is an int rewritten atomically on re-join META
            "kv_blocks_in_use": max(0, self.kv_total - free),  # same stats snapshot
            "active_requests": len(self.requests),
            "tp_shards": self.tp_shards(),
            "decode_tokens_total": self.decode_tokens,
            "handoffs_in_total": self.handoffs_in,
            "handoffs_out_total": self.handoffs_out,
        })
        return stats
