"""Cross-engine KV-block handoff behind a pluggable transport seam.

Copy of ``deepspeed_tpu/serving/cluster/handoff.py`` over the port's
``InferenceEngineV2``: a device payload is a dict of torch tensors on the
exporter's card, a host payload numpy (a bf16 pool's planes as their
uint16 bits; the ``remote`` wire tags them ``bfloat16``, as the JAX
package's does). Every transfer in this module is issued on the calling thread's current
stream, so an export's gathers are ordered before the import that reads
them, and a payload is freed only behind the work that read it.

The transfer unit is the paged ``BlockedAllocator`` block: a prefill
worker that just produced a request's first token exports the sequence's
token history plus the block-gathered slice of each KV pool
(``[n_layers, n_blocks, block_size, kv_heads, head_dim]`` per pool, and
the fp32 scale planes ``[n_layers, n_blocks, block_size, kv_heads]`` when
``kv_cache_dtype=int8`` — quantized blocks transfer bit-exactly), and the
decode replica scatters the payload into freshly allocated blocks of its
own pool. Engines without device pools (compute-free fakes) hand off with
``payload=None`` — the table/history bookkeeping is identical.

HOW the payload moves is the ``KVTransport`` seam, chosen at handoff time
instead of hard-coded host numpy:

- ``host`` — the portable wire: ``export_kv_blocks`` host numpy, imported
  through the double-buffered fixed-window scatter. The representation a
  cross-host transport would serialize.
- ``in_process`` — one device-resident gather of the whole table; the
  import is a single plain scatter. No host copy, simplest wire; its
  shapes track the block count.
- ``device`` — the zero-copy production wire: chunked pipelined export
  (fixed ``chunk_blocks``-wide device windows, tail padded into the trash
  row, all gathers issued up front) into the fixed-window scatter. No
  host copy, and the decode replica's first decode round queues behind
  the windows' scatters on the same stream.
- ``remote`` — the cross-process wire (``serving/net/``): the exporter
  stages the ``host`` representation at its ``KVEndpoint`` and the
  handoff carries only ``(endpoint, transfer_id)``; the importer pulls
  credit-flow-controlled chunk windows over a socket and scatters each
  through the fixed-window import, so decode starts before the tail
  lands. The only transport whose handoffs can cross a process boundary
  (``serving.net.wire.encode_handoff_meta``).

Prefix replication rides every transport the same way: the importer first
seeds from the TARGET replica's token-block trie (a hit skips the payload
copy for the covered blocks entirely), then registers the imported prefix
into that trie — so a hot system prompt lands in every replica's cache
after its first handoff there and subsequent requests hit locally. With a
host tier live, the seed ALSO covers blocks resident in the target's host
store (including blocks the router's PrefixDirectory pulled from a peer).

Bit-identity: the payload copy is bitwise, and sampling is
content-addressed by (seed, uid, position) with sharding-invariant
random bits — so a sequence prefilled on worker A and decoded on replica
B (at tp=1 or tp>1) streams exactly the tokens the single-engine driver
would have produced.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.serving.resilience.faults import get_fault_injector


class HandoffError(RuntimeError):
    """KV-block import/export failed (pool exhausted, dead sequence, ...)."""


@dataclass
class KVHandoff:
    """A sequence snapshot in flight between engines."""

    uid: int
    tokens: List[int]  # full token history whose KV the payload holds
    seen_tokens: int  # KV cursor (== len(tokens) at handoff time)
    pending_token: int  # first generated token; target feeds it back
    n_blocks: int
    payload: Optional[Dict]  # k/v (+ *_scale), numpy or tensors; None for fakes
    # -- transport metadata (set by export_sequence) -----------------------
    transport: str = "host"  # which KVTransport moved this payload
    windows: Optional[List[Dict]] = field(default=None, repr=False)
    chunk_blocks: int = 0  # window width of a pipelined (device) export
    nbytes: int = 0  # bytes the wire carries (payload or window planes)
    inflight_windows: int = 0  # windows dispatched ahead of the import
    # -- remote-transport metadata (serving/net/) --------------------------
    endpoint: Optional[Tuple[str, int]] = None  # exporter's KVEndpoint addr
    transfer_id: Optional[str] = None  # staged-transfer id at that endpoint


def _payload_nbytes(planes) -> int:
    """Wire bytes of a plane dict (numpy arrays or torch tensors) —
    shape×itemsize, never a device sync."""
    n = 0
    for p in planes.values():
        if isinstance(p, np.ndarray):
            n += int(p.nbytes)
        else:
            n += int(p.numel()) * int(p.element_size())
    return n


class KVTransport:
    """One payload representation for the prefill→decode handoff. The
    exporter picks the transport; the importer replays whatever
    representation the ``KVHandoff`` carries (``handoff.transport``), so
    the two sides cannot disagree. Implementations fill the payload /
    window fields of the handoff and scatter them into the target pool;
    engines without pools (fakes) no-op through every transport."""

    name = "?"

    def export(self, engine, blocks: List[int], handoff: KVHandoff) -> None:
        raise NotImplementedError

    def import_payload(self, engine, handoff: KVHandoff, seq,
                       n_cached: int, fresh: List[int]) -> None:
        """Guarded entry: a handoff replayed through a DIFFERENT transport
        than it was exported with fails here with a clear HandoffError
        naming both — never downstream as a scatter shape error (a remote
        export carries no payload at all, only an endpoint pointer)."""
        if handoff.transport != self.name:
            raise HandoffError(
                f"import({handoff.uid}): handoff was exported via "
                f"{handoff.transport!r} but is being replayed via "
                f"{self.name!r} — the importer must use "
                "get_transport(handoff.transport) (the exporter picks the "
                "representation; the two sides cannot disagree)"
            )
        self._import_payload(engine, handoff, seq, n_cached, fresh)

    def _import_payload(self, engine, handoff: KVHandoff, seq,
                        n_cached: int, fresh: List[int]) -> None:
        raise NotImplementedError

    def abort(self, engine, handoff: KVHandoff) -> None:
        """Release transport-side resources of a handoff that will never
        (re)import — e.g. a staged remote transfer. Default: nothing to
        release (host/device payloads are plain arrays the GC owns)."""
        return None


class HostTransport(KVTransport):
    """The original wire: a host-numpy payload imported through the
    double-buffered FIXED-window scatter (pinned staging, side-stream
    copies). Forcing the fixed windows even below one chunk keeps every
    handoff/resume on the one import path ``warm_trace`` drives. The host
    bounce is the point: this is the representation a cross-host
    transport serializes."""

    name = "host"

    def export(self, engine, blocks, handoff):
        export = getattr(engine, "export_kv_blocks", None)
        if export is None:
            return
        handoff.payload = export(blocks)
        handoff.nbytes = _payload_nbytes(handoff.payload)

    def _import_payload(self, engine, handoff, seq, n_cached, fresh):
        if handoff.payload is None or not fresh:
            return
        # payload columns are the SOURCE table in order; the first
        # n_cached columns are covered by this replica's cache hit
        # (device trie AND host-tier readmits — seed_from_cache counts both)
        sliced = {k: v[:, n_cached:] for k, v in handoff.payload.items()}
        chunked = getattr(engine, "import_kv_blocks_chunked", None)
        plain = getattr(engine, "import_kv_blocks", None)
        if chunked is not None:
            kv = getattr(getattr(engine, "config", None), "kv_cache", None)
            chunk = int(getattr(kv, "host_tier_chunk_blocks", 8) or 8)
            chunked(fresh, sliced, chunk_blocks=chunk)
        elif plain is not None:
            plain(fresh, sliced)


class InProcessTransport(KVTransport):
    """Device-resident, single gather: the whole block table exports as
    one device payload (tensors that own their storage) and imports
    through the plain scatter. No host round-trip; ``device`` is the
    steady-state wire."""

    name = "in_process"

    def export(self, engine, blocks, handoff):
        export = getattr(engine, "export_kv_blocks_device", None)
        if export is None:
            return
        handoff.payload = export(blocks)
        handoff.nbytes = _payload_nbytes(handoff.payload)

    def _import_payload(self, engine, handoff, seq, n_cached, fresh):
        if handoff.payload is None or not fresh:
            return
        plain = getattr(engine, "import_kv_blocks", None)
        if plain is None:
            return
        # device-side column slice — a view of the exported gather, never
        # a host copy
        sliced = {k: v[:, n_cached:] for k, v in handoff.payload.items()}
        plain(fresh, sliced)


class DeviceTransport(KVTransport):
    """The zero-copy pipelined wire: fixed-width device windows exported
    asynchronously up front, scattered window-by-window into the pool.
    The importer redirects trie-covered and padded-tail columns to the
    trash row instead of slicing, so every window keeps one shape.
    Because nothing here blocks on the device, the target's first decode
    round is queued behind the tail windows' scatters — decode starts
    before the full sequence lands on the card."""

    name = "device"

    def export(self, engine, blocks, handoff):
        export = getattr(engine, "export_kv_blocks_windows", None)
        if export is None:
            return
        windows, chunk = export(blocks)
        handoff.windows = windows
        handoff.chunk_blocks = int(chunk)
        handoff.inflight_windows = len(windows)
        handoff.nbytes = int(sum(_payload_nbytes(w) for w in windows))

    def _import_payload(self, engine, handoff, seq, n_cached, fresh):
        if not handoff.windows or not fresh:
            return
        imp = getattr(engine, "import_kv_blocks_device", None)
        if imp is None:
            raise HandoffError(
                f"import({handoff.uid}): target engine has no "
                "import_kv_blocks_device — device-transport handoffs "
                "need an engine_v2 pool on both sides"
            )
        dest = [int(b) for b in seq.block_table]
        if len(dest) != handoff.n_blocks:
            raise HandoffError(
                f"import({handoff.uid}): target table has {len(dest)} "
                f"blocks for a {handoff.n_blocks}-block windowed export"
            )
        imp(dest, handoff.windows, handoff.chunk_blocks,
            skip_blocks=n_cached)


_TRANSPORTS: Dict[str, KVTransport] = {
    t.name: t for t in (HostTransport(), InProcessTransport(),
                        DeviceTransport())
}

# "remote" registers lazily on first use (get_transport) so importing the
# handoff seam never drags in the socket subsystem
KV_TRANSPORTS = ("device", "host", "in_process", "remote")


def get_transport(name) -> KVTransport:
    """Resolve a transport by name (or pass an instance through). A typo
    raises here, at configuration time — never a silent host fallback."""
    if isinstance(name, KVTransport):
        return name
    key = str(name)
    if key == "remote" and key not in _TRANSPORTS:
        from deepspeed_tpu_torch.serving.net.transport import RemoteTransport
        _TRANSPORTS[key] = RemoteTransport()
    try:
        return _TRANSPORTS[key]
    except KeyError:
        raise ValueError(
            f"kv_transport={name!r}: expected one of {sorted(KV_TRANSPORTS)} "
            "(host = portable numpy wire, in_process = one device gather, "
            "device = pipelined zero-copy windows, remote = cross-process "
            "socket wire)"
        ) from None


def export_sequence(engine, uid: int, pending_token: int,
                    transport="host") -> KVHandoff:
    """Snapshot a finished-prefill sequence OFF ``engine``: token history,
    KV cursor, and the pool payload for its block table in the chosen
    transport's representation. Device-resident payloads are fresh gather
    outputs (they own their storage), so — like the host copy — the
    caller releases the source sequence (freeing its blocks) immediately
    after. Caller holds the source core's step lock."""
    tr = get_transport(transport)
    faults = get_fault_injector()
    if faults.enabled:
        faults.check("handoff.export", replica=getattr(engine, "replica_name", None))
    seq = engine.state_manager.get_sequence(uid)
    if seq is None or seq.finished:
        raise HandoffError(f"export({uid}): no live sequence")
    blocks = [int(b) for b in seq.block_table]
    handoff = KVHandoff(
        uid=uid,
        tokens=list(seq.tokens),
        seen_tokens=int(seq.seen_tokens),
        pending_token=int(pending_token),
        n_blocks=len(blocks),
        payload=None,
        transport=tr.name,
    )
    tr.export(engine, blocks, handoff)
    return handoff


def import_sequence(engine, handoff: KVHandoff) -> int:
    """Materialize a handed-off sequence ON ``engine`` and resume it as a
    RUNNING decode row: seed shared blocks from this replica's prefix
    cache (replicated hot prefixes skip the copy), allocate private blocks
    for the remainder, scatter the payload through the transport it was
    exported with, register the prefix into this replica's trie, and feed
    the pending first token back through the scheduler. Returns the number
    of payload blocks actually copied. Caller holds the target core's
    step lock."""
    mgr = engine.state_manager
    sched = engine.scheduler
    if mgr.get_sequence(handoff.uid) is not None:
        raise HandoffError(f"import({handoff.uid}): uid already live on target")
    seq = mgr.get_or_create_sequence(handoff.uid)  # raises at max_tracked
    try:
        n_cached_tokens = mgr.seed_from_cache(seq, handoff.tokens)
        n_cached = len(seq.block_table)
        if not mgr.extend(seq, handoff.seen_tokens - n_cached_tokens):
            raise HandoffError(
                f"import({handoff.uid}): target pool exhausted "
                f"({mgr.free_blocks} free, {handoff.n_blocks - n_cached} needed)"
            )
        seq.tokens = list(handoff.tokens)
        seq.seen_tokens = int(handoff.seen_tokens)
        fresh = [int(b) for b in seq.block_table[n_cached:]]
        # chaos seam: firing AFTER seed+extend means an injected import
        # fault exercises the full unwind — every seeded and freshly
        # allocated destination block must free through the except below
        # (the pool-conservation regression in test_resilience.py)
        faults = get_fault_injector()
        if faults.enabled:
            faults.check("handoff.import",
                         replica=getattr(engine, "replica_name", None))
        get_transport(handoff.transport).import_payload(
            engine, handoff, seq, n_cached, fresh)
        # replicate the hot prefix into THIS replica's trie: the next
        # request sharing the prompt hits locally (full blocks only, so
        # decode writes never land in shared blocks — same discipline as
        # single-engine prefill)
        mgr.cache_prefill_blocks(seq, seq.seen_tokens)
        sched.adopt(handoff.uid, handoff.pending_token)
        return len(fresh)
    except Exception:
        # unwind whatever was seeded/allocated; refcounts stay conserved
        sched.finish(handoff.uid)
        raise
