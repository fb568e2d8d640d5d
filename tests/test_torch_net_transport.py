"""The port's remote KV wire (``serving/net/``) against the JAX package's.

Mirrors ``tests/unit/test_net_transport.py`` layer by layer: strict frame
decode (truncation, checksum, version skew, foreign magic, bad chunks),
the credit window's accounting and leak audit, the loopback endpoint
(round trip, unknown transfer ids, an exporter crash mid-window with the
stage surviving for the retry, the importer's chaos sites), the transport
seam (lazy registry, the mismatch guard, fake engines, a direct engine
pair) and the Router over ``kv_transport="remote"``: the port's greedy
streams equal the JAX Router's on the same converted weights (fp32 and
bf16 pools), with chaos at every ``net.*`` site retried to the same
streams and nothing leaked.

Byte compatibility is held directly: for the same planes (a bf16 plane as
its uint16 bits in the port, as an ml_dtypes ``bfloat16`` array in the
JAX package; int8 codes; fp32 scales) every frame the port writes equals
the JAX package's byte for byte, each package decodes the other's, and
over loopback each package's ``fetch_chunks`` pulls the other's
``KVEndpoint`` bit for bit; a handoff exported by one package's engine
imports into the other's. Every socket wait has a deadline.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tests.test_torch_router import JAX, PORT, _cluster, _real_prompts, _tiny_engines, run_all


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


IO_S = 10.0  # every socket read and join below is bounded by this


def _net(root):
    import importlib

    m = lambda name: importlib.import_module(f"{root}.serving.{name}")  # noqa: E731
    return m("net.wire"), m("net.endpoint"), m("net.flow"), m("resilience"), m("cluster.handoff")


J = dict(zip(("wire", "endpoint", "flow", "res", "handoff"), _net("deepspeed_tpu")))
P = dict(zip(("wire", "endpoint", "flow", "res", "handoff"), _net("deepspeed_tpu_torch")))


def _planes(n_blocks=10, dtype=np.float32, with_scales=False):
    """A payload-shaped plane dict ([n_layers, n_blocks, bs, heads])."""
    rng = np.random.RandomState(3)
    shape = (2, n_blocks, 4, 3)
    planes = {"k": rng.rand(*shape).astype(dtype), "v": rng.rand(*shape).astype(dtype)}
    if with_scales:
        planes["k_scale"] = rng.rand(2, n_blocks, 4).astype(np.float32)
        planes["v_scale"] = rng.rand(2, n_blocks, 4).astype(np.float32)
    return planes


def _mixed_planes(n_blocks=6):
    """The same planes in each package's form: a bf16 K plane (JAX:
    ml_dtypes bfloat16; the port: its uint16 bits), int8 V codes, fp32
    scales. Returns (jax planes, port planes, bf16 names)."""
    import ml_dtypes

    rng = np.random.default_rng(11)
    k = rng.normal(size=(2, n_blocks, 4, 3)).astype(ml_dtypes.bfloat16)
    codes = rng.integers(-127, 128, size=(2, n_blocks, 4, 3)).astype(np.int8)
    scales = rng.random((2, n_blocks, 4)).astype(np.float32)
    jp = {"k": k, "v": codes, "k_scale": scales, "v_scale": scales * 2}
    pp = dict(jp, k=k.view(np.uint16))
    return jp, pp, ("k",)


def _fast_cfg(ns_res, **kw):
    base = dict(hung_step_s=5.0, probe_backoff_s=0.05, retry_backoff_s=0.001)
    base.update(kw)
    base.setdefault("probe_backoff_max_s", max(30.0, base["probe_backoff_s"]))
    return ns_res.ResilienceConfig(**base)


# ---------------------------------------------------------------------------
# wire.py: strict frames, and the port's bytes against the JAX package's
# ---------------------------------------------------------------------------
class TestWireFormat:
    @pytest.mark.parametrize("pkg", ["jax", "port"])
    def test_chunk_roundtrip_preserves_every_byte(self, pkg):
        w = (J if pkg == "jax" else P)["wire"]
        jp, pp, bf16 = _mixed_planes()
        planes, kw = (jp, {}) if pkg == "jax" else (pp, {"bf16": bf16})
        frame = w.encode_chunk(2, 6, planes, **kw)
        ftype, payload, end = w.decode_frame(frame)
        assert ftype == w.F_CHUNK and end == len(frame)
        lo, hi, out = w.decode_chunk(payload)
        assert (lo, hi) == (2, 6) and set(out) == set(planes)
        for name, arr in planes.items():
            assert out[name].dtype == arr.dtype and out[name].shape == arr.shape, name
            assert out[name].tobytes() == arr.tobytes(), name

    def test_chunk_and_planes_bytes_equal_jax(self):
        """The port's CHUNK frame (written plane by plane into one buffer)
        and its plane records equal the JAX package's byte for byte, a
        strided column slice included."""
        jp, pp, bf16 = _mixed_planes(n_blocks=9)
        for lo, hi in ((0, 9), (3, 7)):
            js = {k: v[:, lo:hi] for k, v in jp.items()}
            ps = {k: v[:, lo:hi] for k, v in pp.items()}
            assert P["wire"].encode_chunk(lo, hi, ps, bf16=bf16) == J["wire"].encode_chunk(lo, hi, js)
            assert P["wire"].encode_planes(ps, bf16=bf16) == J["wire"].encode_planes(js)
        f32 = _planes(with_scales=True)
        assert P["wire"].encode_chunk(0, 10, f32) == J["wire"].encode_chunk(0, 10, f32)

    def test_each_package_decodes_the_other(self):
        """JAX reads the port's bf16 plane as ``bfloat16`` with the same
        bits; the port reads JAX's as its uint16 bits, without ml_dtypes."""
        import ml_dtypes

        jp, pp, bf16 = _mixed_planes()
        _, payload, _ = J["wire"].decode_frame(P["wire"].encode_chunk(0, 6, pp, bf16=bf16))
        _, _, got = J["wire"].decode_chunk(payload)
        assert got["k"].dtype == ml_dtypes.bfloat16
        for name in jp:
            assert got[name].dtype == jp[name].dtype and got[name].tobytes() == jp[name].tobytes()
        _, payload, _ = P["wire"].decode_frame(J["wire"].encode_chunk(0, 6, jp))
        _, _, got = P["wire"].decode_chunk(payload)
        assert got["k"].dtype == np.uint16
        for name in pp:
            assert got[name].dtype == pp[name].dtype and got[name].tobytes() == pp[name].tobytes()
        # a genuine uint16 plane stays uint16 unless the caller names it bf16
        u16 = {"x": np.arange(12, dtype=np.uint16).reshape(2, 6)}
        assert P["wire"].encode_planes(u16) == J["wire"].encode_planes(u16)
        with pytest.raises(ValueError, match="16-bit integer"):
            P["wire"].encode_planes({"x": np.zeros(3, np.float32)}, bf16=("x",))

    def test_control_hello_and_meta_bytes_equal_jax(self):
        """HELLO, every JSON frame type and the META handoff descriptor:
        equal bytes in both packages."""
        for ftype, name in J["wire"].FRAME_NAMES.items():
            assert P["wire"].FRAME_NAMES[ftype] == name
            obj = {"uid": 7, "tok": 123, "nested": {"prefix": [1, 2]}, "name": "d2"}
            assert P["wire"].encode_json(ftype, obj) == J["wire"].encode_json(ftype, obj)
            assert P["wire"].encode_frame(ftype, b"xyz") == J["wire"].encode_frame(ftype, b"xyz")
        assert P["wire"].encode_hello({"channel": "rpc"}) == J["wire"].encode_hello(
            {"channel": "rpc"})
        kw = dict(uid=41, tokens=list(range(1, 25)), seen_tokens=24, pending_token=9,
                  n_blocks=2, payload=None, transport="remote", chunk_blocks=8, nbytes=4096,
                  endpoint=("127.0.0.1", 45555), transfer_id="abc123")
        jho, pho = J["handoff"].KVHandoff(**kw), P["handoff"].KVHandoff(**kw)
        frame = P["wire"].encode_handoff_meta(pho)
        assert frame == J["wire"].encode_handoff_meta(jho)
        back = P["wire"].decode_handoff_meta(J["wire"].encode_handoff_meta(jho))
        assert isinstance(back, P["handoff"].KVHandoff)
        for k, v in kw.items():
            assert getattr(back, k) == v, k

    @pytest.mark.parametrize("pkg", ["jax", "port"])
    def test_strict_rejections(self, pkg):
        """Truncation, checksum, version skew, foreign magic, an unknown
        type and bad chunk records raise the same errors in both."""
        w = (J if pkg == "jax" else P)["wire"]
        frame = w.encode_chunk(0, 10, _planes())
        with pytest.raises(w.WireError, match="truncated"):
            w.decode_frame(frame[: w.HEADER_BYTES - 1])
        with pytest.raises(w.WireError, match="truncated"):
            w.decode_frame(frame[:-1])
        bad = bytearray(frame)
        bad[-1] ^= 0xFF
        with pytest.raises(w.WireError, match="checksum mismatch"):
            w.decode_frame(bytes(bad))
        hello = bytearray(w.encode_frame(w.F_HELLO))
        hello[4] = w.PROTOCOL_VERSION + 1
        with pytest.raises(w.WireError, match="version skew"):
            w.decode_frame(bytes(hello))
        with pytest.raises(w.WireError, match="foreign frame"):
            w.decode_frame(b"HTTP" + w.encode_frame(w.F_HELLO)[4:])
        hello = bytearray(w.encode_frame(w.F_HELLO))
        hello[6] = 0x7F
        with pytest.raises(w.WireError, match="unknown frame type"):
            w.decode_frame(bytes(hello))
        payload = w.decode_frame(w.encode_chunk(3, 4, {"k": _planes()["k"][:, 3:4]}))[1]
        bad = bytearray(payload)
        bad[4:8] = bad[0:4]
        with pytest.raises(w.WireError, match="empty or inverted"):
            w.decode_chunk(bytes(bad))
        with pytest.raises(w.WireError, match="trailing bytes"):
            w.decode_chunk(payload + b"xx")
        with pytest.raises(w.WireError, match="truncated plane record"):
            w.decode_chunk(payload[:-4])
        bad = bytearray(payload)
        dim0 = 8 + 2 + 2 + 1 + 2 + 7 + 1
        bad[dim0:dim0 + 4] = (99).to_bytes(4, "little")
        with pytest.raises(w.WireError, match="payload bytes"):
            w.decode_chunk(bytes(bad))
        ho = (J if pkg == "jax" else P)["handoff"].KVHandoff(
            uid=1, tokens=[1, 2], seen_tokens=2, pending_token=3, n_blocks=1, payload=None)
        with pytest.raises(w.WireError, match="no endpoint"):
            w.encode_handoff_meta(ho)


# ---------------------------------------------------------------------------
# flow.py: the credit window
# ---------------------------------------------------------------------------
class TestCreditWindow:
    @pytest.mark.parametrize("pkg", ["jax", "port"])
    def test_accounting_stalls_and_leak_audit(self, pkg):
        f = (J if pkg == "jax" else P)["flow"]
        w = f.CreditWindow(4)
        w.take(4)
        assert w.available == 0 and w.outstanding == 4 and not w.try_take(1)
        w.grant(2)
        assert w.try_take(2)
        w.settle(4)
        w.settle(2)
        assert (w.outstanding, w.granted, w.reset()) == (0, 6, 0)
        with pytest.raises(f.CreditError, match="credit stall"):
            f.CreditWindow(1).take(2, timeout=0.02)
        w = f.CreditWindow(8)
        w.take(3)
        w.take(2)
        w.settle(3)
        assert w.reset() == 2 and w.outstanding == 0
        w = f.CreditWindow(4)
        w.take(2)
        with pytest.raises(f.CreditError, match="double settle"):
            w.settle(3)
        w = f.CreditWindow(10)
        for _ in range(3):
            w.take(2)
        w.settle(2)
        w.take(2)
        assert w.max_inflight_windows == 3
        assert f.CreditWindow(3).snapshot() == {"available": 3, "outstanding": 0,
                                                "granted": 3, "settled": 0,
                                                "max_inflight_windows": 0}

    def test_fail_wakes_blocked_takers(self):
        w = P["flow"].CreditWindow(0)
        errs = []

        def taker():
            try:
                w.take(1, timeout=IO_S)
            except P["flow"].CreditError as e:
                errs.append(str(e))

        t = threading.Thread(target=taker)
        t.start()
        time.sleep(0.02)
        w.fail("peer died")
        t.join(timeout=IO_S)
        assert not t.is_alive() and errs and "peer died" in errs[0]


# ---------------------------------------------------------------------------
# endpoint.py: loopback, and each package against the other's
# ---------------------------------------------------------------------------
def _fetch_all(mod, address, tid, n_blocks, chunk, start=0):
    got = {}

    def on_chunk(lo, hi, planes):
        for name, arr in planes.items():
            got.setdefault(name, []).append((lo, np.array(arr)))

    stats = mod.fetch_chunks(address, tid, start_block=start, n_blocks=n_blocks,
                             chunk_blocks=chunk, on_chunk=on_chunk, io_timeout_s=IO_S)
    joined = {name: np.concatenate([a for _, a in sorted(parts, key=lambda t: t[0])], axis=1)
              for name, parts in got.items()}
    return joined, stats


def _drained(ep):
    deadline = time.monotonic() + IO_S
    while ep.staged_count() and time.monotonic() < deadline:
        time.sleep(0.005)  # DONE releases the stage asynchronously
    return ep.staged_count() == 0


class TestEndpoint:
    def test_loopback_roundtrip_and_release(self):
        planes = _planes(n_blocks=10, with_scales=True)
        ep = P["endpoint"].KVEndpoint(name="p0", io_timeout_s=IO_S).start()
        try:
            tid = ep.stage(7, planes, chunk_blocks=3)
            joined, stats = _fetch_all(P["endpoint"], ep.address, tid, 10, 3, start=2)
            for name, arr in planes.items():
                assert joined[name].tobytes() == arr[:, 2:].tobytes(), name
            assert (stats["windows"], stats["leaked_credits"],
                    stats["max_inflight_windows"]) == (3, 0, 2)
            assert _drained(ep) and ep.stats()["served"] == 1
        finally:
            ep.close()

    def test_a_released_stage_was_counted_served(self, monkeypatch):
        """The stage is released only after its transfer is counted
        ``served``: with the count held back until the importer's DONE has
        arrived, a drained endpoint still reads ``served`` 1 (the JAX
        endpoint releases in its credit pump first, and reads 0 here)."""
        ep = P["endpoint"].KVEndpoint(name="p0", io_timeout_s=IO_S).start()
        bump = ep._bump
        fetched = threading.Event()

        def slow_served(key, n=1):
            if key == "served":
                assert fetched.wait(IO_S)
                time.sleep(0.2)  # the DONE is on the wire by now
            bump(key, n)

        monkeypatch.setattr(ep, "_bump", slow_served)
        try:
            tid = ep.stage(3, _planes(n_blocks=4), chunk_blocks=2)
            _fetch_all(P["endpoint"], ep.address, tid, 4, 2)
            fetched.set()
            assert _drained(ep) and ep.stats()["served"] == 1
        finally:
            ep.close()

    @pytest.mark.parametrize("direction", ["jax_pulls_port", "port_pulls_jax"])
    def test_cross_package_fetch_bit_for_bit(self, direction):
        """One package's ``fetch_chunks`` pulls the other's ``KVEndpoint``
        over loopback: every plane equal bit for bit (bf16 as ml_dtypes in
        JAX, uint16 bits in the port), the stage released by the DONE."""
        jp, pp, bf16 = _mixed_planes(n_blocks=7)
        if direction == "jax_pulls_port":
            ep = P["endpoint"].KVEndpoint(name="p0", io_timeout_s=IO_S).start()
            tid, client, want = ep.stage(3, pp, chunk_blocks=2, bf16=bf16), J["endpoint"], jp
        else:
            ep = J["endpoint"].KVEndpoint(name="p0", io_timeout_s=IO_S).start()
            tid, client, want = ep.stage(3, jp, chunk_blocks=2), P["endpoint"], pp
        try:
            joined, stats = _fetch_all(client, ep.address, tid, 7, 2, start=1)
            for name, arr in want.items():
                assert joined[name].dtype == arr.dtype, name
                assert joined[name].tobytes() == arr[:, 1:].tobytes(), name
            assert stats["windows"] == 3 and stats["leaked_credits"] == 0
            assert _drained(ep)
        finally:
            ep.close()

    def test_unknown_transfer_id_is_a_clear_error(self):
        ep = P["endpoint"].KVEndpoint(name="p0", io_timeout_s=IO_S).start()
        try:
            with pytest.raises(P["wire"].WireError, match="unknown transfer id"):
                P["endpoint"].fetch_chunks(ep.address, "bogus", start_block=0, n_blocks=4,
                                           chunk_blocks=2, on_chunk=lambda *a: None,
                                           io_timeout_s=IO_S)
        finally:
            ep.close()

    def test_exporter_crash_mid_window_stage_survives_retry(self):
        """``net.send`` nth=2 kills window 2 of the export: the importer sees
        a dead wire, the stage survives, and the same transfer id fetches
        again bit for bit."""
        planes = _planes(n_blocks=10)
        ep = P["endpoint"].KVEndpoint(name="p0", io_timeout_s=IO_S).start()
        try:
            tid = ep.stage(7, planes, chunk_blocks=3)
            with P["res"].inject(P["res"].FaultSpec("net.send", nth=2)) as inj:
                with pytest.raises((P["wire"].WireError, OSError)):
                    _fetch_all(P["endpoint"], ep.address, tid, 10, 3)
                assert [f["site"] for f in inj.fired()] == ["net.send"]
            assert ep.staged_count() == 1
            joined, stats = _fetch_all(P["endpoint"], ep.address, tid, 10, 3)
            for name, arr in planes.items():
                assert joined[name].tobytes() == arr.tobytes(), name
            assert stats["leaked_credits"] == 0 and ep.stats()["errors"] >= 1
        finally:
            ep.close()

    def test_importer_chaos_sites_fire(self):
        planes = _planes(n_blocks=6)
        ep = P["endpoint"].KVEndpoint(name="p0", io_timeout_s=IO_S).start()
        try:
            tid = ep.stage(9, planes, chunk_blocks=3)
            for site, nth in (("net.connect", 1), ("net.recv", 2)):
                with P["res"].inject(P["res"].FaultSpec(site, nth=nth)):
                    with pytest.raises(P["res"].InjectedFault):
                        _fetch_all(P["endpoint"], ep.address, tid, 6, 3)
            assert ep.staged_count() == 1
            joined, _ = _fetch_all(P["endpoint"], ep.address, tid, 6, 3)
            assert joined["k"].tobytes() == planes["k"].tobytes()
        finally:
            ep.close()

    def test_release_idempotent_bounded_and_closed(self):
        planes = _planes(n_blocks=2)
        ep = P["endpoint"].KVEndpoint(name="p0", max_staged=2).start()
        try:
            t1 = ep.stage(1, planes, chunk_blocks=2)
            ep.stage(2, planes, chunk_blocks=2)
            with pytest.raises(RuntimeError, match="max_staged"):
                ep.stage(3, planes, chunk_blocks=2)
            assert ep.release(t1) is True and ep.release(t1) is False
            ep.stage(3, planes, chunk_blocks=2)
            with pytest.raises(ValueError, match="bf16 names no plane"):
                ep.stage(4, planes, chunk_blocks=2, bf16=("q",))
        finally:
            ep.close()
        ep.close()
        with pytest.raises(RuntimeError, match="closed"):
            ep.stage(1, planes, chunk_blocks=2)


# ---------------------------------------------------------------------------
# the transport seam
# ---------------------------------------------------------------------------
def _prefill_one(engine, uid, prompt):
    engine.scheduler.submit(uid, prompt)
    for _ in range(8):
        out = engine.step_tokens()
        if uid in out:
            return int(out[uid])
    raise AssertionError("prefill produced no token")


def _pool_bits(engine, uid):
    """Every plane of ``uid``'s blocks as raw bytes, in table order."""
    seq = engine.state_manager.get_sequence(uid)
    return {k: v.tobytes() for k, v in engine.export_kv_blocks(list(seq.block_table)).items()}


def _close_endpoint(engine):
    ep = getattr(engine, "_kv_endpoint", None)
    if ep is not None:
        ep.close()
        engine._kv_endpoint = None


class TestRemoteSeam:
    def test_remote_registered_lazily(self):
        for h in (J["handoff"], P["handoff"]):
            assert "remote" in h.KV_TRANSPORTS
            tr = h.get_transport("remote")
            assert tr.name == "remote" and h.get_transport("remote") is tr
            with pytest.raises(ValueError, match="remote"):
                h.get_transport("warp")

    def test_transport_mismatch_is_a_clear_handoff_error(self):
        _, (src, tgt) = _tiny_engines(2)
        h = P["handoff"]
        tok = _prefill_one(src, 31, np.arange(1, 25, dtype=np.int32))
        ho = h.export_sequence(src, 31, tok, transport="remote")
        try:
            src.scheduler.finish(31)
            assert ho.transport == "remote" and ho.payload is None
            assert ho.endpoint is not None and ho.transfer_id
            for wrong in ("host", "in_process", "device"):
                with pytest.raises(h.HandoffError) as ei:
                    h.get_transport(wrong).import_payload(tgt, ho, None, 0, [0, 1])
                assert "remote" in str(ei.value) and wrong in str(ei.value)
            assert h.import_sequence(tgt, ho) == ho.n_blocks
            tgt.scheduler.finish(31)
            assert tgt.state_manager.free_blocks == 64
        finally:
            _close_endpoint(src)

    def test_fake_engines_ride_remote(self):
        from tests.test_torch_serving import FakeEngine

        h = P["handoff"]
        src, tgt = FakeEngine(PORT), FakeEngine(PORT)
        src.scheduler.submit(3, np.arange(1, 9, dtype=np.int32))
        tok = src.step_tokens()[3]
        ho = h.export_sequence(src, 3, int(tok), transport="remote")
        src.scheduler.finish(3)
        assert ho.endpoint is None and ho.transfer_id is None
        assert getattr(src, "_kv_endpoint", None) is None
        assert h.import_sequence(tgt, ho) >= 0
        assert tgt.scheduler.peek_next_token(3) == ho.pending_token
        tgt.scheduler.finish(3)

    @pytest.mark.parametrize("kv", ["int8", "bfloat16"])
    def test_direct_engine_pair_over_loopback(self, kv):
        """export_sequence / import_sequence over the real wire with no
        Router: the target's blocks equal the source's bit for bit (int8
        codes and fp32 scales; a bf16 pool's bits), pools conserve, the
        stage drains after the DONE."""
        from tests.test_torch_serving import INT8

        src, tgt = (_port_engine("float32", **INT8) if kv == "int8" else _port_engine(kv)
                    for _ in range(2))
        h = P["handoff"]
        tok = _prefill_one(src, 33, np.arange(1, 25, dtype=np.int32))
        want = _pool_bits(src, 33)
        ho = h.export_sequence(src, 33, tok, transport="remote")
        try:
            src.scheduler.finish(33)
            assert src.state_manager.free_blocks == 64 and ho.nbytes > 0
            assert h.import_sequence(tgt, ho) == ho.n_blocks
            assert _pool_bits(tgt, 33) == want
            assert tgt.scheduler.peek_next_token(33) == ho.pending_token
            tgt.scheduler.finish(33)
            assert tgt.state_manager.free_blocks == 64
            ep = src._kv_endpoint
            assert _drained(ep)
            assert ep.stats()["wire_bytes_sent"] > ho.nbytes
        finally:
            _close_endpoint(src)

    @pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
    def test_cross_package_handoff(self, direction):
        """A bf16 pool's handoff exported by one package's engine over the
        remote wire imports into the other's: the imported blocks equal the
        exported ones bit for bit and the first token is adopted."""
        from tests.test_torch_serving import engines

        (je_src, pe_src), (je_tgt, pe_tgt) = engines("bfloat16"), engines("bfloat16")
        if direction == "port_to_jax":
            src, tgt, hs, ht = pe_src, je_tgt, P["handoff"], J["handoff"]
        else:
            src, tgt, hs, ht = je_src, pe_tgt, J["handoff"], P["handoff"]
        tok = _prefill_one(src, 5, np.arange(1, 30, dtype=np.int32))
        seq = src.state_manager.get_sequence(5)
        want = {k: np.asarray(v).tobytes()
                for k, v in src.export_kv_blocks(list(seq.block_table)).items()}
        ho = hs.export_sequence(src, 5, tok, transport="remote")
        try:
            src.scheduler.finish(5)
            back = (J if direction == "port_to_jax" else P)["wire"].decode_handoff_meta(
                (P if direction == "port_to_jax" else J)["wire"].encode_handoff_meta(ho))
            assert ht.import_sequence(tgt, back) == ho.n_blocks
            tseq = tgt.state_manager.get_sequence(5)
            got = {k: np.asarray(v).tobytes()
                   for k, v in tgt.export_kv_blocks(list(tseq.block_table)).items()}
            assert got == want
            assert tgt.scheduler.peek_next_token(5) == tok
            tgt.scheduler.finish(5)
        finally:
            _close_endpoint(src)


def _port_engine(dtype, **over):
    """The tiny model's port engine (``tests/test_torch_spec_decode.py``)
    with ``dtype`` weights and compute, so its KV pool is ``dtype`` too."""
    import jax

    from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import transformer as PT
    from deepspeed_tpu_torch.models.convert import params_from_numpy
    from tests import test_torch_spec_decode as sd

    _, jp = sd._jax_params(0)
    return InferenceEngineV2(PT.TransformerConfig(**dict(sd.MODEL, dtype=dtype)),
                             params_from_numpy(jax.tree.map(np.asarray, jp)),
                             RaggedInferenceEngineConfig.from_dict(
                                 sd.engine_config(dtype=dtype, **over)), device="cpu")


# ---------------------------------------------------------------------------
# the Router over the remote wire
# ---------------------------------------------------------------------------
def _engine_sets(dtype, n):
    """(JAX engines, port engines) on the same converted weights."""
    if dtype == "float32":
        return _tiny_engines(n)
    from tests.test_torch_serving import engines

    pairs = [engines(dtype) for _ in range(n)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _router_streams(ns, engs, transport, prompts, n_new=6, sampling=None, **kw):
    if sampling is not None:
        for e in engs:
            e.set_sampling(**sampling)
    router = _cluster(ns).Router(engines=engs, num_prefill_workers=1,
                                 kv_transport=transport, **kw).start()
    try:
        got = [list(r.generated) for r in run_all(ns, router, prompts, n_new)]
        h = router.health()
        snap = router.metrics.snapshot()
    finally:
        router.shutdown()
    return got, h, snap


class TestRemoteStreamParity:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_streams_match_jax_router_and_driver(self, dtype):
        """Greedy: the port's Router over the remote wire streams the JAX
        Router's tokens (remote wire, same weights) and the port's driver's;
        every handoff crosses the socket in pipelined windows, the
        endpoint's stages drain, every pool is free after. Seeded: the
        port's driver's tokens."""
        ps = _real_prompts()
        jengs, pengs = _engine_sets(dtype, 4)
        jgot, jh, _ = _router_streams(JAX, jengs[1:], "remote", ps)
        drv = PORT.ServingDriver(pengs[0]).start()
        single = [list(r.generated) for r in run_all(PORT, drv, ps, 6)]
        drv.shutdown()
        got, h, _ = _router_streams(PORT, pengs[1:], "remote", ps)
        assert got == jgot == single
        kt = h["kv_transport"]
        assert kt["transport"] == jh["kv_transport"]["transport"] == "remote"
        per = kt["per_transport"]["remote"]
        assert per["handoffs"] == len(ps) and per["bytes"] > 0
        assert h["replicas"]["p0"]["kv_endpoint"][0] == "127.0.0.1"
        ep = kt["endpoints"]["p0"]
        assert ep["served"] == len(ps) and ep["staged_now"] == 0
        assert ep["wire_bytes_sent"] > per["bytes"]
        assert ep["wire_bytes_sent"] == jh["kv_transport"]["endpoints"]["p0"]["wire_bytes_sent"]
        for e in pengs:
            assert e.state_manager.free_blocks == e.config.kv_cache.num_blocks
        if dtype == "float32":
            seeded = {"greedy": False, "temperature": 0.8, "seed": 123}
            pengs[0].set_sampling(**seeded)
            drv = PORT.ServingDriver(pengs[0]).start()
            want = [list(r.generated) for r in run_all(PORT, drv, ps, 6)]
            drv.shutdown()
            got, _, _ = _router_streams(PORT, pengs[1:], "remote", ps, sampling=seeded)
            assert got == want

    def test_a_second_router_exports_over_the_same_engines(self):
        """A Router's shutdown closes its engines' KVEndpoints. A second
        Router over the same engines hands off over a fresh endpoint and
        streams the first Router's tokens: ``ensure_endpoint`` replaces a
        closed endpoint (the JAX package's keeps it, and every export of
        the second Router then fails "endpoint closed")."""
        ps = _real_prompts()[:3]
        _, pengs = _engine_sets("float32", 3)
        first, h1, _ = _router_streams(PORT, pengs, "remote", ps)
        closed = pengs[0]._kv_endpoint
        assert closed.closed
        assert h1["kv_transport"]["per_transport"]["remote"]["handoffs"] == len(ps)
        second, h2, _ = _router_streams(PORT, pengs, "remote", ps)
        assert second == first
        assert h2["kv_transport"]["per_transport"]["remote"]["handoffs"] == len(ps)
        assert pengs[0]._kv_endpoint is not closed
        assert h2["kv_transport"]["endpoints"]["p0"]["served"] == len(ps)
        for e in pengs:
            assert e.state_manager.free_blocks == e.config.kv_cache.num_blocks

    @pytest.mark.slow
    def test_int8_streams_match_the_driver(self):
        """int8 codes and fp32 scale planes cross the socket bit for bit."""
        from tests import test_torch_spec_decode as sd
        from tests.test_torch_serving import INT8

        ps = _real_prompts()
        drv = PORT.ServingDriver(sd.port_engine(**INT8)).start()
        single = [list(r.generated) for r in run_all(PORT, drv, ps, 6)]
        drv.shutdown()
        got, h, _ = _router_streams(PORT, [sd.port_engine(**INT8) for _ in range(3)], "remote",
                                    ps)
        assert got == single and h["kv_transport"]["endpoints"]["p0"]["staged_now"] == 0


class TestRemoteChaos:
    def _single(self, ps, sampling):
        from tests import test_torch_spec_decode as sd

        eng = sd.port_engine()
        eng.set_sampling(**sampling)
        drv = PORT.ServingDriver(eng).start()
        try:
            return [list(r.generated) for r in run_all(PORT, drv, ps, 6)]
        finally:
            drv.shutdown()

    def test_wire_faults_retry_to_bit_identical_streams(self):
        """A killed dial, a killed chunk send and a killed frame recv each
        abort one import attempt; bounded retries land the same staged
        transfer and every stream equals the fault-free driver's. No pool
        block, window credit or staged transfer leaks."""
        from tests import test_torch_spec_decode as sd

        sampling = {"greedy": False, "temperature": 0.8, "seed": 123}
        ps = _real_prompts()
        want = self._single(ps, sampling)
        res = P["res"]
        specs = [res.FaultSpec("net.connect", nth=1), res.FaultSpec("net.send", nth=3),
                 res.FaultSpec("net.recv", nth=5)]
        engs = [sd.port_engine() for _ in range(3)]
        with res.inject(*specs) as inj:
            got, h, _ = _router_streams(PORT, engs, "remote", ps, sampling=sampling,
                                        resilience=_fast_cfg(res))
        assert got == want, "remote streams diverged under wire chaos"
        assert {f["site"] for f in inj.fired()} == {"net.connect", "net.send", "net.recv"}
        assert h["resilience"]["handoff_retries"] >= 3
        kt = h["kv_transport"]
        assert kt["aborts"] == 0 and kt["endpoints"]["p0"]["staged_now"] == 0
        for e in engs:
            assert e.state_manager.free_blocks == 64

    def test_exhausted_retries_abort_unwinds_gauge_and_stage(self):
        """Every attempt of d0's first import killed: the request replays to
        the same stream, the abort is counted, the inflight-window gauge
        unwinds and the aborted handoff's stage is released."""
        from tests import test_torch_spec_decode as sd

        ps = _real_prompts()
        want = self._single(ps, {"greedy": True})
        res = P["res"]
        engs = [sd.port_engine() for _ in range(3)]
        # one replica's dials: the port's decode replicas import on their
        # own workers, side by side, so the three must name one of them
        specs = [res.FaultSpec("net.connect", nth=n, replica="d0") for n in (1, 2, 3)]
        with res.inject(*specs) as inj:
            got, h, snap = _router_streams(PORT, engs, "remote", ps, resilience=_fast_cfg(res))
        assert got == want, "replayed stream diverged after aborted handoff"
        assert len(inj.fired()) == 3
        kt = h["kv_transport"]
        assert kt["aborts"] == 1 and snap["kv_handoff_aborts_total"] == 1
        assert h["resilience"]["recoveries"] >= 1
        assert kt["endpoints"]["p0"]["staged_now"] == 0 and kt["endpoints"]["p0"]["released"] >= 1
        for e in engs:
            assert e.state_manager.free_blocks == 64


class TestRemoteCLI:
    def test_kv_transport_remote_flag(self):
        from types import SimpleNamespace

        from deepspeed_tpu_torch.inference import cli as pcli
        from deepspeed_tpu_torch.serving import Router
        from tests import test_torch_spec_decode as sd
        from tests.test_torch_router import SERVE_ARGV

        base = sd.port_engine()
        args = pcli.serve_parse_args(SERVE_ARGV + [
            "--num-prefill-workers", "1", "--num-decode-replicas", "1",
            "--kv-transport", "remote"])
        front, _ = pcli.build_serving_stack(args, cfg=base._mc, params=base.params,
                                            tok=SimpleNamespace(eos_token_id=None))
        try:
            assert isinstance(front, Router) and front._kv_transport.name == "remote"
            health = front.health()
            assert health["kv_transport"]["transport"] == "remote"
            # registration happened at construction: p0 listens before the
            # first request arrives
            assert health["replicas"]["p0"]["kv_endpoint"][1] > 0
        finally:
            front.shutdown(drain=False)
