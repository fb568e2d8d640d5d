"""KVEndpoint: the per-engine listener serving staged KV payloads.

Copy of ``deepspeed_tpu/serving/net/endpoint.py``. A stage also names its
bfloat16 planes (``stage(..., bf16=...)``), which the chunk frames tag
``bfloat16`` (``wire.py``). A stage is released on the importer's DONE
after its transfer is counted ``served`` (the JAX endpoint releases it in
the credit pump, so a drained endpoint can read ``served`` one short).

Each prefill engine that exports over the ``remote`` transport owns one
:class:`KVEndpoint` — a stdlib-socket listener thread plus one handler
thread per connection. The exporter stages a handoff's host-representation
payload (immutable numpy planes) under a transfer id; the importer dials
the endpoint, handshakes versions (HELLO), and FETCHes block-granular
chunk windows. The wire is credit-flow-controlled (:mod:`.flow`): the
FETCH carries an initial grant of ``credit_windows * chunk_blocks``
blocks and CREDIT frames replenish it as the importer's donated scatters
are dispatched, so a slow decoder backpressures the exporter instead of
the socket buffering a whole KV cache.

Staged payloads are immutable and survive a failed transfer: the
importer's bounded retry (``resilience/retry.py``) can re-FETCH the same
transfer id after a mid-window fault, and only an explicit DONE (or the
router calling :meth:`KVEndpoint.release` after the import lands /
finally aborts) drops the stage. That makes the wire edge idempotent,
which is what lets the chaos harness kill it at ``net.connect`` /
``net.send`` / ``net.recv`` without losing a request.
"""

import socket
import threading
import uuid
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.serving.resilience.faults import (
    InjectedFault,
    get_fault_injector,
)
from deepspeed_tpu_torch.serving.net import wire
from deepspeed_tpu_torch.serving.net.flow import CreditError, CreditWindow

__all__ = ["KVEndpoint", "fetch_chunks", "DEFAULT_IO_TIMEOUT_S"]

DEFAULT_IO_TIMEOUT_S = 30.0


class _Stage:
    """One staged transfer: immutable planes + bookkeeping."""

    __slots__ = ("tid", "uid", "planes", "n_blocks", "chunk_blocks", "nbytes",
                 "bf16")

    def __init__(self, tid, uid, planes, chunk_blocks, bf16=()):
        self.tid = tid
        self.uid = uid
        self.planes = planes
        self.bf16 = frozenset(bf16)
        # every plane is [n_layers, n_blocks, ...]; axis 1 is the block axis
        self.n_blocks = int(next(iter(planes.values())).shape[1])
        self.chunk_blocks = int(chunk_blocks)
        self.nbytes = int(sum(a.nbytes for a in planes.values()))


class KVEndpoint:
    """Listener thread serving staged KV payloads as chunk windows.

    >>> ep = KVEndpoint(name="p0"); ep.start()
    >>> tid = ep.stage(uid, payload, chunk_blocks=8)
    >>> ep.address      # ("127.0.0.1", <port>) — goes into the handoff
    >>> ep.release(tid) # after the import lands (DONE also releases)
    >>> ep.close()
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 name: Optional[str] = None, max_staged: int = 64,
                 io_timeout_s: float = DEFAULT_IO_TIMEOUT_S,
                 advertise_host: Optional[str] = None):
        self.name = name or "kv-endpoint"
        self._io_timeout_s = float(io_timeout_s)
        self._max_staged = int(max_staged)
        self._lock = threading.Lock()
        self._staged: Dict[str, _Stage] = {}
        self._closed = False
        self._threads = []
        self._stats = {
            "staged": 0, "released": 0, "served": 0, "frames_sent": 0,
            "wire_bytes_sent": 0, "credit_stalls": 0, "errors": 0,
            "max_inflight_windows": 0,
        }
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(16)
        self._bind_address = self._listener.getsockname()[:2]
        # multi-host discovery: the address handed to IMPORTERS (health
        # metadata, handoff descriptors) may differ from the bind address —
        # a pod-facing endpoint binds 0.0.0.0/127.0.0.1 but must advertise
        # a host other machines can dial
        self._advertise_host = advertise_host or self._bind_address[0]
        self._accept_thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        """The ADVERTISED ``(host, port)`` — what goes into handoff
        descriptors and /health metadata for remote importers to dial."""
        return (self._advertise_host, int(self._bind_address[1]))

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    @property
    def bind_address(self) -> Tuple[str, int]:
        """The local ``(host, port)`` the listener socket is bound to."""
        return (self._bind_address[0], int(self._bind_address[1]))

    def start(self) -> "KVEndpoint":
        if self._accept_thread is None:
            self._accept_thread = threading.Thread(
                target=self._accept_loop, name=f"{self.name}-accept",
                daemon=True)
            self._accept_thread.start()
        return self

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._staged.clear()
        # Closing the listener fd does NOT wake a thread blocked in accept()
        # on Linux — dial it once so the accept loop observes _closed and
        # exits instead of eating the full join timeout below. Dial the
        # BIND address: the advertised host may only resolve off-box.
        try:
            with socket.create_connection(self.bind_address, timeout=0.5):
                pass
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        # snapshot under the lock (handler threads deregister themselves);
        # the joins themselves must run unlocked or they would deadlock
        # with a handler blocked on _lock
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=2.0)

    # -- staging -------------------------------------------------------------
    def stage(self, uid: int, payload: Dict[str, np.ndarray],
              chunk_blocks: int, bf16=()) -> str:
        """Stage an exported payload; returns the transfer id the importer
        FETCHes by. The planes are kept as-is (already host numpy — the
        export made the copy) and served read-only; the planes named in
        ``bf16`` are bfloat16 bits (uint16) and go out tagged so."""
        if not payload:
            raise ValueError(f"stage({uid}): empty payload")
        unknown = set(bf16) - set(payload)
        if unknown:
            raise ValueError(f"stage({uid}): bf16 names no plane {sorted(unknown)}")
        tid = uuid.uuid4().hex
        stage = _Stage(tid, int(uid), dict(payload), chunk_blocks, bf16)
        with self._lock:
            if self._closed:
                raise RuntimeError(f"{self.name}: endpoint closed")
            if len(self._staged) >= self._max_staged:
                raise RuntimeError(
                    f"{self.name}: {len(self._staged)} transfers staged "
                    f">= max_staged {self._max_staged} — importer side is "
                    "not releasing (leak or overload)")
            self._staged[tid] = stage
            self._stats["staged"] += 1
        return tid

    def release(self, tid: str) -> bool:
        """Drop a staged transfer (import landed or finally aborted).
        Idempotent; returns whether the stage was present."""
        with self._lock:
            present = self._staged.pop(tid, None) is not None
            if present:
                self._stats["released"] += 1
            return present

    def staged_count(self) -> int:
        with self._lock:
            return len(self._staged)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats, staged_now=len(self._staged))

    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._stats[key] += n

    # -- server side ---------------------------------------------------------
    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed
            t = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name=f"{self.name}-conn", daemon=True)
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
            t.start()

    def _send(self, conn: socket.socket, frame: bytes) -> None:
        conn.sendall(frame)
        self._bump("frames_sent")
        self._bump("wire_bytes_sent", len(frame))

    def _serve_conn(self, conn: socket.socket) -> None:
        faults = get_fault_injector()
        try:
            conn.settimeout(self._io_timeout_s)
            read = lambda n: wire.recv_exact(conn, n)
            # handshake: both sides announce their version SPAN before any
            # data; skew inside the supported range downgrades, no overlap
            # (or foreign magic) raises out of the negotiation
            ftype, payload = wire.read_frame(read)
            if ftype != wire.F_HELLO:
                raise wire.WireError(
                    f"expected HELLO, got {wire.FRAME_NAMES.get(ftype, ftype)}")
            wire.negotiate_version(wire.decode_hello(payload))
            self._send(conn, wire.encode_hello())
            ftype, payload = wire.read_frame(read)
            if ftype != wire.F_FETCH:
                raise wire.WireError(
                    f"expected FETCH, got {wire.FRAME_NAMES.get(ftype, ftype)}")
            req = wire.decode_json(payload, wire.F_FETCH)
            tid = str(req.get("tid", ""))
            start_block = int(req.get("start_block", 0))
            credit_blocks = int(req.get("credit_blocks", 0))
            with self._lock:
                stage = self._staged.get(tid)
            if stage is None:
                self._bump("errors")
                self._send(conn, wire.encode_json(wire.F_ERROR, {
                    "error": f"unknown transfer id {tid!r} on {self.name} "
                             "(released, expired, or never staged)"}))
                return
            self._stream_chunks(conn, read, stage, start_block,
                                credit_blocks, faults)
        except (wire.WireError, OSError, ValueError, CreditError,
                InjectedFault):
            # importer crashed / protocol break / chaos kill: drop the
            # connection (an InjectedFault at net.send IS the simulated
            # exporter crash — the importer sees a dead wire). The stage
            # stays — the importer's bounded retry re-FETCHes it.
            self._bump("errors")
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _stream_chunks(self, conn, read, stage: _Stage, start_block: int,
                       credit_blocks: int, faults) -> None:
        if not (0 <= start_block <= stage.n_blocks):
            raise wire.WireError(
                f"FETCH start_block {start_block} outside [0, {stage.n_blocks}]")
        window = CreditWindow(credit_blocks)
        chunk = max(1, stage.chunk_blocks)
        done = threading.Event()
        got_done = threading.Event()

        def credit_pump():
            # drains CREDIT frames (and the final DONE) off the socket so
            # the send loop can block on the window, not on recv. A CREDIT
            # both ACKS the oldest in-flight window (settle) and re-opens
            # the send window (grant) — so `window.outstanding` is the true
            # number of chunk windows on the wire at any instant.
            try:
                while not done.is_set():
                    ftype, payload = wire.read_frame(read)
                    if ftype == wire.F_CREDIT:
                        blocks = int(wire.decode_json(
                            payload, wire.F_CREDIT)["blocks"])
                        window.settle(blocks)
                        window.grant(blocks)
                    elif ftype == wire.F_DONE:
                        # tail windows are acknowledged wholesale by DONE
                        window.reset()
                        got_done.set()
                        return
                    else:
                        raise wire.WireError(
                            "expected CREDIT/DONE, got "
                            f"{wire.FRAME_NAMES.get(ftype, ftype)}")
            except (wire.WireError, OSError, ValueError, KeyError,
                    CreditError) as e:
                window.fail(f"{self.name}: credit pump died: {e}")

        pump = threading.Thread(target=credit_pump,
                                name=f"{self.name}-credit", daemon=True)
        pump.start()
        try:
            pos = start_block
            while pos < stage.n_blocks:
                width = min(chunk, stage.n_blocks - pos)
                try:
                    window.take(width, timeout=self._io_timeout_s)
                except Exception:
                    self._bump("credit_stalls")
                    raise
                # chaos seam: one arrival per chunk window, so a
                # FaultSpec("net.send", nth=k) kills exactly window k
                faults.check("net.send", replica=self.name)
                planes = {name: arr[:, pos:pos + width]
                          for name, arr in stage.planes.items()}
                self._send(conn, wire.encode_chunk(pos, pos + width, planes,
                                                   bf16=stage.bf16))
                pos += width
            self._bump("served")
            # wait for the importer's DONE so the stage releases (here,
            # after the count: a released stage has been counted served);
            # a peer that dies here just leaves the stage for release()/retry
            pump.join(timeout=self._io_timeout_s)
            if got_done.is_set():
                self.release(stage.tid)
        except BaseException:
            # unblock BOTH sides before unwinding: the importer wakes with
            # a dead-wire WireError, the pump's recv fails and exits
            done.set()
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            raise
        finally:
            done.set()
            with self._lock:
                self._stats["max_inflight_windows"] = max(
                    self._stats["max_inflight_windows"],
                    window.max_inflight_windows)


# -- importer-side client ----------------------------------------------------
def fetch_chunks(
    address: Tuple[str, int],
    transfer_id: str,
    *,
    start_block: int,
    n_blocks: int,
    chunk_blocks: int,
    on_chunk: Callable[[int, int, Dict[str, np.ndarray]], None],
    credit_windows: int = 2,
    io_timeout_s: float = DEFAULT_IO_TIMEOUT_S,
    replica: Optional[str] = None,
) -> Dict[str, int]:
    """Dial ``address`` and pull blocks ``[start_block, n_blocks)`` of
    ``transfer_id`` as chunk windows, invoking ``on_chunk(lo, hi, planes)``
    for each (the remote transport's callback dispatches the donated
    scatter — async, so the next window's recv overlaps it). The initial
    credit grant is ``credit_windows`` windows (double-buffered by
    default); each consumed window is re-granted after its scatter
    dispatches, which is the backpressure: a slow scatter starves the
    exporter of credit.

    Raises :class:`~.wire.WireError` on any protocol violation, checksum
    mismatch, version skew, truncation, or exporter-reported error, and
    ``OSError`` on plain socket failures; both are retryable — the staged
    payload survives on the exporter until DONE/release.
    """
    chunk = max(1, int(chunk_blocks))
    want = int(n_blocks) - int(start_block)
    if want <= 0:
        return {"windows": 0, "max_inflight_windows": 0, "wire_bytes": 0}
    faults = get_fault_injector()
    # chaos seam: dialing the exporter
    faults.check("net.connect", replica=replica)
    window = CreditWindow(0)
    initial_credit = max(1, int(credit_windows)) * chunk
    stats = {"windows": 0, "wire_bytes": 0}
    with socket.create_connection(
            (address[0], int(address[1])), timeout=io_timeout_s) as conn:
        conn.settimeout(io_timeout_s)
        read = lambda n: wire.recv_exact(conn, n)
        conn.sendall(wire.encode_hello())
        ftype, payload = wire.read_frame(read)
        if ftype != wire.F_HELLO:
            raise wire.WireError(
                f"expected HELLO, got {wire.FRAME_NAMES.get(ftype, ftype)}")
        wire.negotiate_version(wire.decode_hello(payload))
        conn.sendall(wire.encode_json(wire.F_FETCH, {
            "tid": str(transfer_id),
            "start_block": int(start_block),
            "credit_blocks": initial_credit,
        }))
        window.grant(initial_credit)
        got = 0
        expect_lo = int(start_block)
        while got < want:
            # chaos seam: one arrival per frame read off the wire
            faults.check("net.recv", replica=replica)
            ftype, payload = wire.read_frame(read)
            stats["wire_bytes"] += wire.HEADER_BYTES + len(payload)
            if ftype == wire.F_ERROR:
                msg = wire.decode_json(payload, wire.F_ERROR).get(
                    "error", "unspecified")
                raise wire.WireError(f"exporter error: {msg}")
            if ftype != wire.F_CHUNK:
                raise wire.WireError(
                    f"expected CHUNK, got {wire.FRAME_NAMES.get(ftype, ftype)}")
            lo, hi, planes = wire.decode_chunk(payload)
            if lo != expect_lo or hi > n_blocks:
                raise wire.WireError(
                    f"out-of-order CHUNK [{lo}, {hi}): expected window "
                    f"starting at {expect_lo} within {n_blocks} blocks")
            width = hi - lo
            # police the exporter's credit compliance: a window we never
            # granted credit for is a protocol violation, not data
            if not window.try_take(width):
                raise wire.WireError(
                    f"exporter overran its credit window: CHUNK [{lo}, {hi}) "
                    f"with only {window.available} blocks granted")
            on_chunk(lo, hi, planes)
            window.settle(width)
            got += width
            expect_lo = hi
            stats["windows"] += 1
            if got < want:
                # replenish the exporter — and mirror the grant locally so
                # the policing window stays in sync with what the peer sees
                conn.sendall(wire.encode_json(
                    wire.F_CREDIT, {"blocks": width}))
                window.grant(width)
        conn.sendall(wire.encode_frame(wire.F_DONE))
    leaked = window.reset()
    return {
        "windows": stats["windows"],
        # pipeline depth the credit grant permitted: the exporter may run
        # this many windows ahead of the scatters (exporter-side peak is
        # in KVEndpoint.stats()["max_inflight_windows"])
        "max_inflight_windows": min(max(1, int(credit_windows)),
                                    stats["windows"]),
        "wire_bytes": stats["wire_bytes"],
        "leaked_credits": leaked,
    }
