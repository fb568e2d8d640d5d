"""The port's control-plane wire (``serving/net/control.py``) against the
JAX package's.

Mirrors ``tests/unit/test_control_plane.py``: the v2 frame vocabulary
(SUBMIT/TOKEN/CANCEL/HEALTH/ADOPT/STATS/EVENT/GOODBYE) round trips and
strict-decode rejections for every type, the HELLO version-skew matrix (a
v1-only peer downgrades on the KV wire and is refused a control channel),
``ControlChannel`` over a socket pair (RPC, error mapping, a dead wire),
and the ``ControlEndpoint`` / ``dial_control`` bootstrap (acks, refusals,
dials retried through the ``net.connect`` chaos seam, refusals final). Each
case runs in both packages; the bytes of every control frame are equal,
and each package's agent side bootstraps against the other's router side.
Every socket wait has a deadline.
"""

import importlib
import socket
import threading
import time

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


IO_S = 5.0  # every read, call and join below is bounded by this


class _Pkg:
    def __init__(self, root):
        m = lambda name: importlib.import_module(f"{root}.serving.{name}")  # noqa: E731
        self.wire, self.control = m("net.wire"), m("net.control")
        self.res, self.retry = m("resilience"), m("resilience.retry")
        self.ServingMetrics = m("metrics").ServingMetrics


PKGS = {"jax": _Pkg("deepspeed_tpu"), "port": _Pkg("deepspeed_tpu_torch")}
J, P = PKGS["jax"], PKGS["port"]
both = pytest.mark.parametrize("pkg", ["jax", "port"])


def _frames(w):
    return (w.F_SUBMIT, w.F_TOKEN, w.F_CANCEL, w.F_HEALTH, w.F_ADOPT, w.F_STATS, w.F_EVENT,
            w.F_GOODBYE)


class TestControlFrames:
    def test_vocabulary_is_v2_and_names_equal(self):
        for pk in (J, P):
            w = pk.wire
            assert w.PROTOCOL_VERSION >= 2 and pk.control.CONTROL_MIN_VERSION == 2
            v1 = {w.F_HELLO, w.F_FETCH, w.F_CHUNK, w.F_CREDIT, w.F_DONE, w.F_ERROR, w.F_META}
            frames = _frames(w)
            assert len(set(frames)) == len(frames) and not set(frames) & v1
        assert P.wire.FRAME_NAMES == J.wire.FRAME_NAMES
        assert (P.wire.PROTOCOL_VERSION, P.wire.MIN_PROTOCOL_VERSION) == (
            J.wire.PROTOCOL_VERSION, J.wire.MIN_PROTOCOL_VERSION)

    @pytest.mark.parametrize("i", range(8), ids=["SUBMIT", "TOKEN", "CANCEL", "HEALTH", "ADOPT",
                                                  "STATS", "EVENT", "GOODBYE"])
    def test_roundtrip_bytes_and_rejections(self, i):
        """Each control frame type: equal bytes in both packages, each
        decodes the other's, and a flipped payload bit, a truncation, an
        unknown type or a version outside the span is refused."""
        obj = {"uid": 7, "tok": 123, "nested": {"prefix": [1, 2, 3]}, "name": "d2",
               "event": "engine_failed"}
        ftype = _frames(P.wire)[i]
        buf = P.wire.encode_json(ftype, obj)
        assert buf == J.wire.encode_json(ftype, obj)
        for pk in (J, P):
            w = pk.wire
            got_type, payload, used = w.decode_frame(buf)
            assert (got_type, used, w.decode_json(payload, ftype)) == (ftype, len(buf), obj)
            bad = bytearray(buf)
            bad[-1] ^= 0xFF
            with pytest.raises(w.WireError, match="checksum"):
                w.decode_frame(bytes(bad))
            with pytest.raises(w.WireError):
                w.decode_frame(buf[: len(buf) - 3])
            bad = bytearray(buf)
            bad[6] = 99
            with pytest.raises(w.WireError, match="unknown frame type"):
                w.decode_frame(bytes(bad))
            for version in (w.PROTOCOL_VERSION + 1, 0):
                bad = bytearray(buf)
                bad[4] = version
                with pytest.raises(w.WireError, match="version skew"):
                    w.decode_frame(bytes(bad))

    @both
    def test_non_json_payload_rejected(self, pkg):
        w = PKGS[pkg].wire
        _, payload, _ = w.decode_frame(w.encode_frame(w.F_STATS, b"\x00\x01not-json"))
        with pytest.raises(w.WireError, match="malformed JSON"):
            w.decode_json(payload, w.F_STATS)


class TestHelloNegotiation:
    @both
    def test_hello_span_and_legacy(self, pkg):
        w = PKGS[pkg].wire
        ftype, payload, _ = w.decode_frame(w.encode_hello({"channel": "rpc"}))
        hello = w.decode_hello(payload)
        assert ftype == w.F_HELLO and hello["channel"] == "rpc"
        assert (hello["min_version"], hello["max_version"]) == (w.MIN_PROTOCOL_VERSION,
                                                                w.PROTOCOL_VERSION)
        assert w.decode_hello(b"") == {"min_version": 1, "max_version": 1}

    @both
    def test_skew_matrix_and_strictness(self, pkg):
        w = PKGS[pkg].wire
        v = w.PROTOCOL_VERSION
        for (lo, hi), want in (((1, 1), 1), ((1, v), v), ((2, 5), v), ((v, v), v)):
            assert w.negotiate_version({"min_version": lo, "max_version": hi}) == want
        with pytest.raises(w.WireError, match="no common protocol"):
            w.negotiate_version({"min_version": v + 1, "max_version": v + 3})
        with pytest.raises(w.WireError, match="malformed HELLO"):
            w.negotiate_version({"min_version": 3, "max_version": 1})
        with pytest.raises(w.WireError, match="malformed HELLO"):
            w.negotiate_version({"min_version": "x"})


def _channel_pair(pk, metrics=None):
    a, b = socket.socketpair()
    return (pk.control.ControlChannel(a, name="left", metrics=metrics),
            pk.control.ControlChannel(b, name="right"))


def _serve_once(fn):
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    return t


class TestControlChannel:
    @both
    def test_send_recv_and_call(self, pkg):
        pk = PKGS[pkg]
        w = pk.wire
        metrics = pk.ServingMetrics()
        left, right = _channel_pair(pk, metrics)
        try:
            left.send(w.F_TOKEN, {"uid": 4, "tok": 99})
            assert right.recv(timeout_s=IO_S) == (w.F_TOKEN, {"uid": 4, "tok": 99})
            t = _serve_once(lambda: right.send(*right.recv(timeout_s=IO_S)))
            assert left.call(w.F_HEALTH, {"probe": True}, timeout_s=IO_S) == {"probe": True}
            t.join(IO_S)
            assert not t.is_alive()
            snap = metrics.snapshot()
            assert snap["control_rpcs_total"] == 1 and snap["control_frames_total"] >= 3
            assert snap["control_rpc_seconds"] >= 0.0
        finally:
            left.close()
            right.close()

    @both
    def test_error_reply_and_type_mismatch(self, pkg):
        pk = PKGS[pkg]
        w = pk.wire
        for reply, match in (((w.F_ERROR, {"error": "KeyError: 13"}), "KeyError: 13"),
                             ((w.F_STATS, {"free_blocks": 1}), "mismatch")):
            left, right = _channel_pair(pk)

            def server(reply=reply):
                right.recv(timeout_s=IO_S)
                right.send(*reply)

            t = _serve_once(server)
            try:
                with pytest.raises(w.WireError, match=match):
                    left.call(w.F_CANCEL, {"uid": 13}, timeout_s=IO_S)
            finally:
                t.join(IO_S)
                left.close()
                right.close()
            assert not t.is_alive()

    @both
    def test_dead_wire_surfaces_and_goodbye_never_raises(self, pkg):
        pk = PKGS[pkg]
        left, right = _channel_pair(pk)
        right.close()
        with pytest.raises((pk.wire.WireError, OSError)):
            left.recv(timeout_s=IO_S)
        left.goodbye("late")
        left.close()
        assert left.closed

    def test_channels_speak_across_packages(self):
        """A port channel and a JAX channel on one socket pair: frames and
        RPCs cross in both directions."""
        a, b = socket.socketpair()
        pc = P.control.ControlChannel(a, name="port")
        jc = J.control.ControlChannel(b, name="jax")
        try:
            pc.send(P.wire.F_STATS, {"free_blocks": 5})
            assert jc.recv(timeout_s=IO_S) == (J.wire.F_STATS, {"free_blocks": 5})
            t = _serve_once(lambda: jc.send(*jc.recv(timeout_s=IO_S)))
            assert pc.call(P.wire.F_ADOPT, {"meta": "00"}, timeout_s=IO_S) == {"meta": "00"}
            t.join(IO_S)
            assert not t.is_alive()
        finally:
            pc.close()
            jc.close()


class TestControlBootstrap:
    @pytest.mark.parametrize("router,agent", [("port", "port"), ("jax", "port"),
                                              ("port", "jax")])
    def test_dial_and_ack(self, router, agent):
        got = {}

        def on_channel(meta, channel):
            got["meta"] = meta
            return {"name": "d7"}

        ep = PKGS[router].control.ControlEndpoint(on_channel=on_channel, name="test-ctl",
                                                  io_timeout_s=IO_S).start()
        try:
            chan, ack = PKGS[agent].control.dial_control(
                ep.address, {"channel": "rpc", "name": "agent"}, io_timeout_s=IO_S)
            try:
                v = P.wire.PROTOCOL_VERSION
                assert ack["name"] == "d7" and ack["version"] == v and chan.version == v
                assert got["meta"] == {"channel": "rpc", "name": "agent"}
            finally:
                chan.close()
        finally:
            ep.close()

    @both
    def test_refusal_is_an_error_frame_and_final(self, pkg):
        """``on_channel`` raising refuses with an ERROR frame; under a retry
        policy the refusal surfaces on the first attempt (no backoff)."""
        pk = PKGS[pkg]
        calls = []

        def on_channel(meta, channel):
            calls.append(meta)
            raise ValueError("name 'd0' is taken by a local engine")

        ep = pk.control.ControlEndpoint(on_channel=on_channel, io_timeout_s=IO_S).start()
        try:
            with pytest.raises(pk.wire.WireError, match="refused channel.*d0.*taken"):
                pk.control.dial_control(ep.address, {"channel": "rpc", "name": "d0"},
                                        io_timeout_s=IO_S)
            t0 = time.monotonic()
            with pytest.raises(pk.control.ControlRefused, match="taken by a local"):
                pk.control.dial_control(
                    ep.address, {"channel": "rpc", "name": "d0"}, io_timeout_s=IO_S,
                    retry_policy=pk.retry.RetryPolicy(attempts=5, backoff_s=10.0,
                                                      max_backoff_s=10.0))
            assert time.monotonic() - t0 < IO_S and len(calls) == 2
        finally:
            ep.close()

    @both
    def test_v1_only_peer_refused_a_control_channel(self, pkg):
        pk = PKGS[pkg]
        w = pk.wire
        ep = pk.control.ControlEndpoint(on_channel=lambda m, c: {}, io_timeout_s=IO_S).start()
        try:
            with socket.create_connection(ep.address, timeout=IO_S) as conn:
                conn.settimeout(IO_S)
                conn.sendall(w.encode_frame(w.F_HELLO, b""))
                with pytest.raises((w.WireError, OSError)):
                    ftype, _ = w.read_frame(lambda n: w.recv_exact(conn, n))
                    if ftype == w.F_HELLO:
                        raise AssertionError("v1 peer was acked")
        finally:
            ep.close()

    @both
    def test_dial_retries_through_connect_chaos(self, pkg):
        pk = PKGS[pkg]
        ep = pk.control.ControlEndpoint(on_channel=lambda m, c: {"name": "d1"},
                                        io_timeout_s=IO_S).start()
        try:
            with pk.res.inject(pk.res.FaultSpec("net.connect", nth=1)) as inj:
                chan, ack = pk.control.dial_control(
                    ep.address, {"channel": "rpc"}, io_timeout_s=IO_S, replica="agent",
                    retry_policy=pk.retry.RetryPolicy(attempts=3, backoff_s=0.001))
                chan.close()
            assert ack["name"] == "d1" and len(inj.fired()) == 1
        finally:
            ep.close()

    @both
    def test_endpoint_close_is_idempotent_and_wakes_accept(self, pkg):
        pk = PKGS[pkg]
        ep = pk.control.ControlEndpoint(on_channel=lambda m, c: {}).start()
        ep.close()
        ep.close()
        with pytest.raises(OSError):
            socket.create_connection(ep.address, timeout=0.5).close()
