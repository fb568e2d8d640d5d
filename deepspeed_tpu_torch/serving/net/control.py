"""Control-plane wire: the router <-> replica-agent frame channel.

Copy of ``deepspeed_tpu/serving/net/control.py``: the same frames and
handshake, byte for byte.

The multi-host control plane rides the SAME versioned checksummed frame
protocol as the KV data wire (:mod:`.wire`) — UCCL-EP's portable-wire
stance: one strict frame layout under both control and data traffic, so
an RDMA-class transport later slots under either without a second
protocol. Control frames are the v2 vocabulary (SUBMIT/TOKEN/CANCEL/
HEALTH/ADOPT/STATS/EVENT/GOODBYE); a channel whose HELLO negotiation
lands below v2 cannot carry them and is refused at the handshake.

Topology: the ROUTER owns one :class:`ControlEndpoint` listener; each
replica agent DIALS it (:func:`dial_control`, bounded-retry via
``resilience/retry.py``) twice — an ``rpc`` channel the router sends
request frames down (the agent replies in order), and an ``events``
channel the agent pushes TOKEN/STATS/EVENT frames up. Both directions
originate at the agent, so a pod's workers need no inbound reachability
to the replicas (NAT/firewall friendly), and both channels traverse the
same chaos seams as the KV wire: ``net.connect`` at the dial,
``net.send``/``net.recv`` per frame.

Failure semantics: any wire fault (socket error, strict-decode
rejection, injected chaos) surfaces as :class:`~.wire.WireError`/
``OSError`` out of :meth:`ControlChannel.recv`/:meth:`~ControlChannel.call`;
the owner maps it onto the PR-15 resilience machinery (agent lost ->
quarantine -> replay recovery) — the channel itself never retries
mid-stream, only the initial dial is retried.
"""

import socket
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from deepspeed_tpu_torch.serving.net import wire
from deepspeed_tpu_torch.serving.resilience.faults import get_fault_injector
from deepspeed_tpu_torch.serving.resilience.retry import RetryPolicy, with_retries
from deepspeed_tpu_torch.utils.logging import logger

__all__ = [
    "CONTROL_MIN_VERSION",
    "ControlChannel",
    "ControlEndpoint",
    "dial_control",
    "DEFAULT_CONTROL_TIMEOUT_S",
]

# the control vocabulary (SUBMIT..GOODBYE) exists from protocol v2 on; a
# peer whose span negotiates below this cannot serve as a replica agent
CONTROL_MIN_VERSION = 2

DEFAULT_CONTROL_TIMEOUT_S = 30.0


class ControlRefused(wire.WireError):
    """The router answered the bootstrap META with an F_ERROR — a
    protocol-level rejection (name collision, version floor), not a wire
    fault. Dial retries must NOT repeat it: the router gave a verdict,
    and hammering the same bootstrap just re-asks the same question."""


class ControlChannel:
    """One connected control channel speaking JSON frames.

    Thread model: ``send`` is safe from any thread (one writer lock
    serializes frame bytes onto the socket); ``recv`` is single-reader —
    exactly one pump/serve thread drains inbound frames. ``call`` is the
    router-side RPC helper (send request, read reply, one in flight at a
    time) and must own the read side of its channel.
    """

    def __init__(self, conn: socket.socket, *, name: str = "ctl",
                 version: int = wire.PROTOCOL_VERSION,
                 io_timeout_s: Optional[float] = None,
                 metrics=None):
        self.name = str(name)
        self.version = int(version)
        self.metrics = metrics
        self._conn = conn
        # None = blocking: persistent channels legitimately idle for long
        # stretches (an rpc channel between probes, an events channel
        # between tokens) — deadlines are per-call (``call(timeout_s=)``),
        # and a dead peer still surfaces as EOF/RST out of recv
        self._io_timeout_s = (None if io_timeout_s is None
                              else float(io_timeout_s))
        self._send_lock = threading.Lock()
        self._rpc_lock = threading.Lock()
        self._closed = False
        conn.settimeout(self._io_timeout_s)

    # -- framing -------------------------------------------------------------
    def _count(self) -> None:
        if self.metrics is not None:
            self.metrics.inc("control_frames_total")

    def send(self, ftype: int, obj: Dict) -> None:
        """Frame ``obj`` as ``ftype`` and write it. Raises ``OSError`` on a
        dead wire and ``InjectedFault`` at the ``net.send`` chaos seam."""
        faults = get_fault_injector()
        if faults.enabled:
            faults.check("net.send", replica=self.name)
        frame = wire.encode_json(ftype, obj)
        with self._send_lock:
            self._conn.sendall(frame)
        self._count()

    def recv(self, timeout_s: Optional[float] = None) -> Tuple[int, Dict]:
        """Read one frame; strict decode. Single-reader by contract."""
        faults = get_fault_injector()
        if faults.enabled:
            faults.check("net.recv", replica=self.name)
        if timeout_s is not None:
            self._conn.settimeout(float(timeout_s))
        try:
            ftype, payload = wire.read_frame(
                lambda n: wire.recv_exact(self._conn, n))
        finally:
            if timeout_s is not None:
                self._conn.settimeout(self._io_timeout_s)
        self._count()
        return ftype, wire.decode_json(payload, ftype) if payload else {}

    def call(self, ftype: int, obj: Dict,
             timeout_s: Optional[float] = None) -> Dict:
        """One request/reply round trip (router -> agent). The reply must
        echo the request's frame type; an ERROR frame raises with the
        agent's message. Serialized — one RPC in flight per channel."""
        t0 = time.monotonic()
        with self._rpc_lock:
            self.send(ftype, obj)
            rtype, reply = self.recv(timeout_s=timeout_s)  # the recv IS the rpc: _rpc_lock exists to serialize request/reply pairs on this channel, nothing else contends on it, and agent loss unblocks it via socket close (WireError)
        if self.metrics is not None:
            self.metrics.inc("control_rpcs_total")
            self.metrics.inc("control_rpc_seconds", time.monotonic() - t0)
        if rtype == wire.F_ERROR:
            raise wire.WireError(
                f"{wire.FRAME_NAMES.get(ftype, ftype)} rpc failed on "
                f"{self.name}: {reply.get('error', 'unspecified')}")
        if rtype != ftype:
            raise wire.WireError(
                f"rpc reply type mismatch on {self.name}: sent "
                f"{wire.FRAME_NAMES.get(ftype, ftype)}, got "
                f"{wire.FRAME_NAMES.get(rtype, rtype)}")
        return reply

    # -- lifecycle -----------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    def goodbye(self, reason: str = "shutdown") -> None:
        """Best-effort clean teardown notice; never raises."""
        try:
            self.send(wire.F_GOODBYE, {"reason": str(reason)})
        except Exception:
            pass

    def close(self) -> None:
        self._closed = True
        try:
            self._conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._conn.close()
        except OSError:
            pass


def _handshake_accept(conn: socket.socket, io_timeout_s: float) -> Tuple[int, Dict]:
    """Server side of the channel bootstrap: HELLO span exchange (strict
    negotiation), then one META frame describing the channel (role, agent
    metadata). Returns ``(negotiated_version, bootstrap_meta)``."""
    conn.settimeout(io_timeout_s)
    read = lambda n: wire.recv_exact(conn, n)
    ftype, payload = wire.read_frame(read)
    if ftype != wire.F_HELLO:
        raise wire.WireError(
            f"expected HELLO, got {wire.FRAME_NAMES.get(ftype, ftype)}")
    version = wire.negotiate_version(wire.decode_hello(payload))
    if version < CONTROL_MIN_VERSION:
        raise wire.WireError(
            f"peer negotiated v{version} < v{CONTROL_MIN_VERSION} — no "
            "control-frame vocabulary before v2")
    conn.sendall(wire.encode_hello())
    ftype, payload = wire.read_frame(read)
    if ftype != wire.F_META:
        raise wire.WireError(
            f"expected META bootstrap, got {wire.FRAME_NAMES.get(ftype, ftype)}")
    return version, wire.decode_json(payload, wire.F_META)


class ControlEndpoint:
    """The router's control listener: accepts agent channels, handshakes
    them (HELLO negotiation + META bootstrap), and hands each
    :class:`ControlChannel` to ``on_channel(meta, channel)`` — whose dict
    return value is sent back as the META acknowledgment (e.g. the
    replica name the router assigned). Raising inside ``on_channel``
    refuses the channel with an ERROR frame."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 name: str = "control",
                 on_channel: Callable[[Dict, ControlChannel], Optional[Dict]],
                 io_timeout_s: float = DEFAULT_CONTROL_TIMEOUT_S,
                 metrics=None):
        self.name = str(name)
        self.metrics = metrics
        self._on_channel = on_channel
        self._io_timeout_s = float(io_timeout_s)
        self._lock = threading.Lock()
        self._closed = False
        self._threads = []
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(16)
        self._address = self._listener.getsockname()[:2]
        self._accept_thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return (self._address[0], int(self._address[1]))

    def start(self) -> "ControlEndpoint":
        if self._accept_thread is None:
            self._accept_thread = threading.Thread(
                target=self._accept_loop, name=f"{self.name}-accept",
                daemon=True)
            self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed
            t = threading.Thread(target=self._bootstrap_conn, args=(conn,),
                                 name=f"{self.name}-hello", daemon=True)
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
            t.start()

    def _bootstrap_conn(self, conn: socket.socket) -> None:
        """Handshake one inbound channel and hand it to the owner. The
        thread exits after the META ack — pump/serve loops belong to the
        owner, not the endpoint."""
        channel = None
        try:
            version, meta = _handshake_accept(conn, self._io_timeout_s)
            channel = ControlChannel(
                conn, name=str(meta.get("channel", "ctl")), version=version,
                metrics=self.metrics)
            try:
                ack = self._on_channel(meta, channel) or {}
            except Exception as e:
                channel.send(wire.F_ERROR, {"error": f"{type(e).__name__}: {e}"})
                channel.close()
                return
            channel.send(wire.F_META, dict(ack, version=version))
        except (wire.WireError, OSError, ValueError) as e:
            logger.warning(f"control[{self.name}]: bootstrap failed: {e}")
            if channel is not None:
                channel.close()
            else:
                try:
                    conn.close()
                except OSError:
                    pass

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        # wake a blocked accept() (closing the fd does not, on Linux)
        try:
            with socket.create_connection(self.address, timeout=0.5):
                pass
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=2.0)


def dial_control(
    address: Tuple[str, int],
    meta: Dict,
    *,
    retry_policy: Optional[RetryPolicy] = None,
    io_timeout_s: float = DEFAULT_CONTROL_TIMEOUT_S,
    name: str = "ctl",
    replica: Optional[str] = None,
    metrics=None,
) -> Tuple[ControlChannel, Dict]:
    """Agent side: dial the router's control endpoint, negotiate versions,
    send the META bootstrap, and return ``(channel, ack)`` where ``ack``
    is the router's META reply (assigned replica name, agreed version).

    ``retry_policy`` bounds the dial (``resilience/retry.py``): an agent
    started before its router retries with backoff instead of dying. Only
    the DIAL retries — a channel that fails mid-stream is the owner's
    failure plane, not the wire's.
    """

    def attempt() -> Tuple[ControlChannel, Dict]:
        faults = get_fault_injector()
        if faults.enabled:
            faults.check("net.connect", replica=replica or name)
        conn = socket.create_connection(
            (address[0], int(address[1])), timeout=io_timeout_s)
        try:
            conn.settimeout(io_timeout_s)
            read = lambda n: wire.recv_exact(conn, n)
            conn.sendall(wire.encode_hello())
            ftype, payload = wire.read_frame(read)
            if ftype != wire.F_HELLO:
                raise wire.WireError(
                    f"expected HELLO, got {wire.FRAME_NAMES.get(ftype, ftype)}")
            version = wire.negotiate_version(wire.decode_hello(payload))
            if version < CONTROL_MIN_VERSION:
                raise wire.WireError(
                    f"router negotiated v{version} < v{CONTROL_MIN_VERSION} — "
                    "no control-frame vocabulary before v2")
            conn.sendall(wire.encode_json(wire.F_META, meta))
            ftype, payload = wire.read_frame(read)
            if ftype == wire.F_ERROR:
                err = wire.decode_json(payload, wire.F_ERROR)
                raise ControlRefused(
                    f"router refused channel: {err.get('error', 'unspecified')}")
            if ftype != wire.F_META:
                raise wire.WireError(
                    f"expected META ack, got {wire.FRAME_NAMES.get(ftype, ftype)}")
            ack = wire.decode_json(payload, wire.F_META)
            # the handshake ran under a dial deadline; the long-lived
            # channel goes blocking (see ControlChannel.__init__)
            conn.settimeout(None)
            return (ControlChannel(conn, name=name, version=version,
                                   metrics=metrics), ack)
        except BaseException:
            try:
                conn.close()
            except OSError:
                pass
            raise

    if retry_policy is None:
        return attempt()

    def _refusals_are_final(_attempt: int, err: BaseException) -> None:
        if isinstance(err, ControlRefused):
            raise err

    return with_retries(attempt, retry_policy, label=f"control.dial:{name}",
                        on_retry=_refusals_are_final)
