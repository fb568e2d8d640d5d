"""The port's serving stack against the JAX package's, on the CPU.

Every test runs the same scenario through both packages and holds the
port to the JAX package's observable results: token streams, finish
reasons, terminal states, KV blocks freed, metric counters, exposition
text. Wall-clock quantities (latencies, step counts) are not compared.

The driver tests run on ``FakeEngine`` (each package's real scheduler and
allocator, compute-free steps: the next token is the last one + 1), as the
JAX package's ``tests/unit/test_serving.py`` does. ``TestServingRealEngine``
serves the tiny model of ``tests/test_torch_spec_decode.py`` (2 layers,
h 128, fp32 and bf16) through both packages' ``InferenceEngineV2`` on
identical weights: greedy streams are compared token for token (exact:
integer ids), through the split step, the fused rounds (``decode_steps``
4), n-gram speculative rounds and int8 pools, with a cancel and a timeout.
"""

import importlib
import threading
import time
from types import SimpleNamespace

import numpy as np
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


WAIT_S = 60  # every wait on a request, a stream or a thread is bounded


def _ns(root: str) -> SimpleNamespace:
    """One package's serving surface, by the same names in both."""
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    cfg, driver, metrics = m("inference.config"), m("serving.driver"), m("serving.metrics")
    request, streaming = m("serving.request"), m("serving.streaming")
    return SimpleNamespace(
        root=root,
        KVCacheConfig=cfg.KVCacheConfig, StateManagerConfig=cfg.StateManagerConfig,
        DSStateManager=m("inference.v2.ragged_manager").DSStateManager,
        RaggedScheduler=m("inference.v2.scheduler").RaggedScheduler,
        ServingDriver=driver.ServingDriver, RequestRejected=driver.RequestRejected,
        Histogram=metrics.Histogram, ServingMetrics=metrics.ServingMetrics,
        Request=request.Request, RequestState=request.RequestState,
        SamplingParams=request.SamplingParams,
        TokenStream=streaming.TokenStream, StreamClosed=streaming.StreamClosed,
        IncrementalDetokenizer=streaming.IncrementalDetokenizer,
        monitor=m("monitor.monitor"), DeepSpeedConfig=m("runtime.config").DeepSpeedConfig,
        observability=m("observability"),
    )


JAX = _ns("deepspeed_tpu")
PORT = _ns("deepspeed_tpu_torch")


def on_both(scenario):
    """Run ``scenario(ns)`` on each package; assert the results are equal;
    return the port's."""
    want, got = scenario(JAX), scenario(PORT)
    assert got == want
    return got


class FakeEngine:
    """The driver's engine protocol over one package's real scheduler and
    allocator (``tests/unit/test_serving.py``'s): each completed row emits
    last-token + 1, so a prompt ending in ``p`` streams ``p+1, p+2, ...``."""

    def __init__(self, ns, block_size=4, num_blocks=256, max_blocks_per_seq=16,
                 max_tracked=32, batch_budget=64, max_rows=16, max_context=4096,
                 step_delay=0.0, vocab=1 << 30):
        kv = ns.KVCacheConfig(block_size=block_size, num_blocks=num_blocks,
                              max_blocks_per_seq=max_blocks_per_seq)
        sm = ns.StateManagerConfig(max_tracked_sequences=max_tracked,
                                   max_ragged_batch_size=batch_budget,
                                   max_ragged_sequence_count=max_rows, max_context=max_context)
        self.config = SimpleNamespace(kv_cache=kv, state_manager=sm)
        self.state_manager = ns.DSStateManager(sm, kv)
        self.scheduler = ns.RaggedScheduler(sm, self.state_manager)
        self.last_capped = set()
        self.steps = 0
        self.step_delay = step_delay
        self.vocab = vocab
        self.fail_next = 0  # > 0: that many step_tokens() calls raise

    def step_tokens(self):
        self.steps += 1
        if self.fail_next > 0:
            self.fail_next -= 1
            raise RuntimeError("injected engine failure")
        if self.step_delay:
            time.sleep(self.step_delay)
        batch = self.scheduler.next_batch()
        self.last_capped |= self.scheduler.drain_capped()
        if batch is None:
            return {}
        out = {}
        for uid, toks, chunked in zip(batch.uids, batch.tokens, batch.is_prompt_chunk):
            seq = self.state_manager.get_sequence(uid)
            seq.seen_tokens += len(toks)
            if not chunked:
                out[uid] = (int(toks[-1]) + 1) % self.vocab
        return out


def expected_tokens(prompt, n):
    last = int(prompt[-1])
    return [last + 1 + i for i in range(n)]


def params(ns, n, **kw):
    return ns.SamplingParams(max_new_tokens=n, ignore_eos=True, **kw)


def wait_until(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.001)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------
class TestServingDriver:
    def test_acceptance_concurrent_requests(self):
        """8 concurrent streams finish while an injected timeout and an
        injected failure stay isolated (blocks freed, others unaffected);
        a drain completes the running set and refuses new submits."""

        def scenario(ns):
            eng = FakeEngine(ns, step_delay=0.002)
            driver = ns.ServingDriver(eng, max_queue=64)
            driver.start()
            try:
                streamed, threads = {}, []
                prompts = [np.arange(1 + 100 * i, 6 + 100 * i, dtype=np.int32)
                           for i in range(8)]
                reqs = []
                for p in prompts:
                    r = driver.submit(p, params=params(ns, 12))
                    t = threading.Thread(target=lambda r=r: streamed.__setitem__(
                        r.uid, list(r.stream)))
                    t.start()
                    reqs.append(r)
                    threads.append(t)
                r_timeout = driver.submit(np.asarray([7, 8, 9], np.int32),
                                          params=params(ns, 10000), timeout_s=0.15)

                def boom(req, tok):
                    if len(req.generated) >= 3:
                        raise RuntimeError("boom")
                    return False

                r_fail = driver.submit(np.asarray([50, 51], np.int32),
                                       params=params(ns, 10000), stop_fn=boom)
                for r in reqs + [r_timeout, r_fail]:
                    assert r.wait(WAIT_S), f"request {r.uid} did not finish"
                for t in threads:
                    t.join(WAIT_S)
                for r, p in zip(reqs, prompts):
                    assert r.generated == expected_tokens(p, 12)
                    assert streamed[r.uid] == r.generated
                    assert r.ttft_s is not None and r.e2e_s is not None
                d1 = driver.submit(np.asarray([500], np.int32), params=params(ns, 40))
                d2 = driver.submit(np.asarray([600], np.int32), params=params(ns, 40))
                drained = threading.Event()
                threading.Thread(target=lambda: (driver.drain(WAIT_S), drained.set())).start()
                wait_until(lambda: driver.health()["status"] == "draining", "draining")
                with pytest.raises(ns.RequestRejected) as ei:
                    driver.submit(np.asarray([1], np.int32))
                assert drained.wait(WAIT_S)
            finally:
                driver.shutdown(drain=False, timeout=WAIT_S)
            snap = driver.metrics.snapshot()
            return {
                "states": [(r.state, r.finish_reason) for r in reqs + [d1, d2]],
                "d_lens": [len(d1.generated), len(d2.generated)],
                "timeout": (r_timeout.state, r_timeout.stream.finish_reason),
                "fail": (r_fail.state, "boom" in r_fail.error, len(r_fail.generated)),
                "rejected": ei.value.reason,
                "free": eng.state_manager.free_blocks, "work": eng.scheduler.has_work(),
                "counters": {k: snap[k] for k in (
                    "requests_finished_total", "requests_timed_out_total",
                    "requests_failed_total", "requests_rejected_total",
                    "requests_submitted_total")},
            }

        got = on_both(scenario)
        assert got["states"] == [("finished", "max_tokens")] * 10
        assert got["timeout"] == ("timed_out", "timeout")
        assert got["fail"] == ("failed", True, 3)
        assert got["free"] == 256 and not got["work"]
        assert got["counters"]["requests_finished_total"] == 10

    def test_admission_waits_without_busy_loop(self):
        """An exhausted pool makes the next request wait (no engine spin)
        until the first one's blocks come back."""

        def scenario(ns):
            eng = FakeEngine(ns, block_size=4, num_blocks=8, max_blocks_per_seq=8,
                             max_context=64, step_delay=0.005)
            driver = ns.ServingDriver(eng, poll_interval_s=0.02)
            driver.start()
            try:
                time.sleep(0.1)
                idle_steps = eng.steps
                a = driver.submit(np.arange(1, 9, dtype=np.int32), params=params(ns, 24))
                wait_until(lambda: driver.num_active > 0, "admission")
                b = driver.submit(np.arange(1, 9, dtype=np.int32), params=params(ns, 24))
                b_queued = b.state
                assert a.wait(WAIT_S) and b.wait(WAIT_S)
            finally:
                driver.shutdown(timeout=WAIT_S)
            assert eng.steps < 120  # a busy loop would be thousands
            return {"idle_steps": idle_steps, "b_queued": b_queued,
                    "done": [(r.state, len(r.generated)) for r in (a, b)],
                    "blocked": driver.metrics.snapshot()["admission_blocked_total"] >= 1,
                    "free": eng.state_manager.free_blocks}

        got = on_both(scenario)
        assert got["idle_steps"] == 0 and got["b_queued"] == "queued" and got["free"] == 8

    def test_length_cap_reports_length_cap_finish(self):
        def scenario(ns):
            eng = FakeEngine(ns, block_size=4, num_blocks=64, max_blocks_per_seq=2,
                             max_context=256)
            with ns.ServingDriver(eng) as driver:
                r = driver.submit(np.arange(1, 5, dtype=np.int32), params=params(ns, 50))
                assert r.wait(WAIT_S)
            return (r.state, r.finish_reason, r.generated, eng.state_manager.free_blocks)

        state, reason, gen, free = on_both(scenario)
        assert (state, reason, free) == ("finished", "length_cap", 64)
        assert 0 < len(gen) <= 5

    def test_cancel_active_frees_blocks(self):
        def scenario(ns):
            eng = FakeEngine(ns, step_delay=0.005)
            with ns.ServingDriver(eng) as driver:
                r = driver.submit(np.asarray([1, 2, 3], np.int32), params=params(ns, 10000))
                first = r.stream.get(timeout=WAIT_S)
                cancelled = driver.cancel(r.uid)
                assert r.wait(WAIT_S)
                unknown = driver.cancel(12345)
            return (first, cancelled, r.state, unknown, eng.state_manager.free_blocks)

        assert on_both(scenario) == (4, True, "cancelled", False, 256)

    def test_engine_error_isolated_loop_survives(self):
        def scenario(ns):
            eng = FakeEngine(ns)
            with ns.ServingDriver(eng) as driver:
                eng.fail_next = 1
                r1 = driver.submit(np.asarray([1, 2], np.int32), params=params(ns, 4))
                assert r1.wait(WAIT_S)
                free = eng.state_manager.free_blocks
                r2 = driver.submit(np.asarray([1, 2], np.int32), params=params(ns, 4))
                assert r2.wait(WAIT_S)
            return (r1.state, r1.error, free, r2.state, r2.generated)

        assert on_both(scenario) == ("failed", "RuntimeError: injected engine failure", 256,
                                     "finished", [3, 4, 5, 6])

    def test_submit_rejections(self):
        def scenario(ns):
            eng = FakeEngine(ns, block_size=4, num_blocks=8, max_blocks_per_seq=4,
                             max_context=16)
            driver = ns.ServingDriver(eng, max_queue=1)  # never started
            reasons = []
            for prompt in ([], np.arange(20), [1], [1]):
                try:
                    driver.submit(np.asarray(prompt, np.int32))
                    reasons.append(None)
                except ns.RequestRejected as e:
                    reasons.append(e.reason)
            with pytest.raises(ValueError):
                ns.SamplingParams(max_new_tokens=0)
            return reasons

        assert on_both(scenario) == ["empty_prompt", "max_context", None, "queue_full"]

    def test_eos_and_stop_tokens(self):
        def scenario(ns):
            with ns.ServingDriver(FakeEngine(ns), eos_token_id=13) as driver:
                r = driver.submit(np.asarray([10], np.int32),
                                  params=ns.SamplingParams(max_new_tokens=50))
                r2 = driver.submit(np.asarray([10], np.int32),
                                   params=params(ns, 50, stop_token_ids=(15,)))
                assert r.wait(WAIT_S) and r2.wait(WAIT_S)
            return [(x.finish_reason, x.generated) for x in (r, r2)]

        assert on_both(scenario) == [("eos", [11, 12, 13]),
                                     ("stop_token", [11, 12, 13, 14, 15])]

    def test_health_document(self):
        """``health()`` of an idle driver: the same keys and values."""

        def scenario(ns):
            eng = FakeEngine(ns)
            with ns.ServingDriver(eng) as driver:
                r = driver.submit(np.asarray([3, 4], np.int32), params=params(ns, 3))
                assert r.wait(WAIT_S)
                wait_until(lambda: driver.num_active == 0, "idle")
                h = driver.health()
            # the event log is process-global in each package: other tests
            # may have written to the JAX package's
            events = h.pop("events")
            assert set(events) == {"total", "retained", "dropped"}
            return h

        h = on_both(scenario)
        assert h["kv_free_blocks"] == h["kv_total_blocks"] == 256


    def test_replica_health_streak(self):
        """The step-error streak ``/health`` reports: errors walk healthy →
        degraded → quarantined, a clean step resets a degraded replica and
        not a quarantined one; the same snapshots on a fake clock."""

        def scenario(ns):
            mod = importlib.import_module(f"{ns.root}.serving.resilience.health")
            h = mod.ReplicaHealth("r0", clock=lambda: 10.0)
            seen = [h.snapshot()]
            for event in ("error", "success", "error", "error", "error", "success", "error"):
                if event == "error":
                    h.note_error(f"boom {len(seen)}")
                else:
                    h.note_success()
                seen.append(h.snapshot())
            return seen

        seen = on_both(scenario)
        assert [s["state"] for s in seen] == ["healthy", "degraded", "healthy", "degraded",
                                              "degraded", "quarantined", "quarantined",
                                              "quarantined"]
        assert seen[-1]["quarantines"] == 1 and seen[-1]["next_probe_in_s"] == 0.25


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------
class ByteTok:
    """Token id == one UTF-8 byte."""

    def decode(self, ids):
        return bytes(ids).decode("utf-8", errors="replace")


class TestStreaming:
    def test_token_stream_iterate_and_close(self):
        def scenario(ns):
            s = ns.TokenStream(uid=1)
            s.put(1), s.put(2)
            s.close("done")
            s.put(99)  # dropped after close
            out = (list(s), s.finish_reason)
            with pytest.raises(ns.StreamClosed):
                s.get()
            with pytest.raises(TimeoutError):
                ns.TokenStream(uid=2).get(timeout=0.01)
            return out

        assert on_both(scenario) == ([1, 2], "done")

    def test_token_stream_concurrent_producer(self):
        def scenario(ns):
            s = ns.TokenStream(uid=1)

            def produce():
                for i in range(100):
                    s.put(i)
                s.close("max_tokens")

            t = threading.Thread(target=produce)
            t.start()
            out = list(s)
            t.join(WAIT_S)
            return out

        assert on_both(scenario) == list(range(100))

    def test_incremental_detok_holds_partial_utf8(self):
        def scenario(ns):
            d = ns.IncrementalDetokenizer(ByteTok())
            out = [d.push(t) for t in (ord("a"), 0xC3, 0xA9, ord("b"))] + [d.flush()]
            e = ns.IncrementalDetokenizer(ByteTok())
            return out + [e.push(0xC3), e.flush()]

        assert on_both(scenario) == ["a", "", "é", "b", "", "", "�"]


# ---------------------------------------------------------------------------
# metrics and the Monitor writers
# ---------------------------------------------------------------------------
def _observed_metrics(ns):
    m = ns.ServingMetrics()
    m.inc("requests_submitted_total", 3)
    m.inc("requests_finished_total", 2)
    m.update_kv(free_blocks=96, total_blocks=128)
    req = ns.Request(uid=0, prompt_tokens=np.asarray([1], np.int32))
    req.t_submit = 50.0
    req.t_first_token = 50.02
    req.t_finish = 50.1
    req.generated = [1, 2, 3]
    m.observe_request(req)
    m.observe_spec_round({0: (4, 2), 1: (4, 4)})
    m.update_replica("replica0", {"kv_free_blocks": 96, "active_requests": 1}, role="both")
    return m


class TestServingMetrics:
    def test_histogram_counts_and_quantile(self):
        def scenario(ns):
            h = ns.Histogram(buckets=(0.1, 1.0, 10.0))
            for v in (0.05, 0.5, 0.5, 5.0):
                h.observe(v)
            return (h.count, h.mean, h.quantile(0.5), h.quantile(1.0), h.prom_samples("x"))

        count, mean, q50, q100, samples = on_both(scenario)
        assert (count, q50, q100) == (4, 1.0, 10.0) and mean == pytest.approx(1.5125)
        by_le = {s[1]["le"]: s[2] for s in samples if s[0] == "x_bucket"}
        assert by_le["0.1"] == 1 and by_le["1.0"] == 3 and by_le["+Inf"] == 4

    def test_prometheus_text_exposition(self):
        """The same samples render the same exposition text (exact)."""
        text = on_both(lambda ns: _observed_metrics(ns).prometheus_text())
        assert "# TYPE dstpu_serving_requests_submitted_total counter" in text
        assert "dstpu_serving_kv_occupancy 0.25" in text
        assert 'dstpu_serving_ttft_seconds_bucket{le="+Inf"} 1' in text

    def test_render_prometheus_text_same_samples(self):
        samples = [
            ("a_total", None, 3, "counter"),
            ("lat_bucket", {"le": "0.1"}, 1, "histogram"),
            ("lat_bucket", {"le": "+Inf"}, 2, "histogram"),
            ("g", {"replica": 'd"0\n', "role": "decode"}, float("inf"), "gauge"),
            ("plain", None, 0.5, None),
        ]
        text = on_both(lambda ns: ns.monitor.render_prometheus_text(samples))
        assert text.count("# TYPE") == 3 and 'replica="d\\"0\\n"' in text

    def test_to_events_bridges_to_monitor(self):
        events = on_both(lambda ns: _observed_metrics(ns).to_events())
        assert dict((n, v) for n, v, _ in events)["Serving/requests_finished_total"] == 2
        assert {s for _, _, s in events} == {2}


class TestPrometheusMonitor:
    def test_expose_and_textfile(self, tmp_path):
        def scenario(ns):
            out = tmp_path / ns.root
            mon = ns.monitor.PrometheusMonitor(SimpleNamespace(
                enabled=True, output_path=str(out), job_name="unittest"))
            mon.write_events([("Train/Samples/loss", 2.5, 10), ("bad name!", 1.0, 1),
                              ("text", "n/a", 3)])
            text = mon.expose()
            assert (out / "unittest.prom").read_text() == text
            return text

        text = on_both(scenario)
        assert "Train_Samples_loss 2.5" in text and "bad_name_ 1.0" in text

    def test_monitor_master_wiring(self, tmp_path):
        def scenario(ns):
            out = tmp_path / ns.root
            ds = ns.DeepSpeedConfig.from_dict({
                "train_batch_size": 8,
                "prometheus": {"enabled": True, "output_path": str(out), "job_name": "wired"},
                "csv_monitor": {"enabled": True, "output_path": str(out), "job_name": "csv"},
            })
            master = ns.monitor.MonitorMaster(ds)
            master.write_events([("Serving/queue_depth", 4, 7)])
            return (master.enabled, master.prometheus_monitor.expose(),
                    (out / "wired.prom").exists(),
                    (out / "csv" / "Serving_queue_depth.csv").read_text())

        enabled, text, prom_file, csv_text = on_both(scenario)
        assert enabled and prom_file and "Serving_queue_depth 4" in text
        assert csv_text.splitlines() == ["step,Serving/queue_depth", "7,4"]


# ---------------------------------------------------------------------------
# the real engines
# ---------------------------------------------------------------------------
def _engines():
    from tests import test_torch_spec_decode as sd

    return sd


def real_prompts():
    rng = np.random.default_rng(5)
    motif = rng.integers(1, 256, size=5).astype(np.int32)
    return [np.tile(motif, 4),  # repetitive: the n-gram proposer drafts here
            rng.integers(1, 256, size=13).astype(np.int32),
            rng.integers(1, 256, size=37).astype(np.int32),  # two prompt chunks
            np.concatenate([rng.integers(1, 256, size=6), motif, motif]).astype(np.int32)]


def serve(ns, eng, prompts, n_new, **driver_kw):
    """Every prompt submitted at once to a driver over ``eng``; returns the
    finished requests (the driver is shut down in every case)."""
    driver = ns.ServingDriver(eng, **driver_kw)
    driver.start()
    try:
        reqs = [driver.submit(p, params=params(ns, n_new)) for p in prompts]
        streams = {}
        threads = [threading.Thread(target=lambda r=r: streams.__setitem__(r.uid, list(r.stream)))
                   for r in reqs]
        for t in threads:
            t.start()
        for r in reqs:
            assert r.wait(WAIT_S), f"request {r.uid} did not finish"
        for t in threads:
            t.join(WAIT_S)
        for r in reqs:
            assert streams[r.uid] == r.generated
    finally:
        driver.shutdown(drain=False, timeout=WAIT_S)
    return reqs, driver


INT8 = {"kv_cache": {"block_size": 8, "num_blocks": 64, "max_blocks_per_seq": 12,
                    "kv_cache_dtype": "int8"}}
# (model dtype, engine config overrides, driver keywords)
CASES = {
    "fp32_split": ("float32", {}, {}),
    "fp32_fused4": ("float32", {"decode_steps": 4}, {"decode_steps": 4}),
    "fp32_spec": ("float32", {"spec_k": 4}, {}),
    "bf16_split": ("bfloat16", {}, {}),
    "bf16_fused4": ("bfloat16", {"decode_steps": 4}, {"decode_steps": 4}),
    "int8_split": ("float32", INT8, {}),
    "int8_fused4": ("float32", {"decode_steps": 4, **INT8}, {"decode_steps": 4}),
    "int8_spec": ("float32", {"spec_k": 4, **INT8}, {}),
}


def engines(dtype="float32", **over):
    """(JAX engine, port engine) on the same seeded weights (the tiny
    model of ``tests/test_torch_spec_decode.py``, in ``dtype``)."""
    import dataclasses

    import jax

    from deepspeed_tpu.inference.config import RaggedInferenceEngineConfig as JaxEngineConfig
    from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
    from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import transformer as PT
    from deepspeed_tpu_torch.models.convert import params_from_numpy

    sd = _engines()
    jcfg, jp = sd._jax_params(0)
    rc = sd.engine_config(dtype=dtype, **over)
    je = JaxEngine(dataclasses.replace(jcfg, dtype=dtype), jp, JaxEngineConfig.from_dict(rc))
    pe = InferenceEngineV2(PT.TransformerConfig(**dict(sd.MODEL, dtype=dtype)),
                           params_from_numpy(jax.tree.map(np.asarray, jp)),
                           RaggedInferenceEngineConfig.from_dict(rc), device="cpu")
    return je, pe


class TestServingRealEngine:
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_greedy_streams_match_jax_driver(self, case):
        """The port's driver over the port's engine streams the JAX
        driver's tokens over the JAX engine, and the port engine's own
        ``generate()``, token for token (exact)."""
        dtype, over, dkw = CASES[case]
        ps = real_prompts()
        je, eng = engines(dtype, **over)
        jreqs, _ = serve(JAX, je, ps, 8, **dkw)
        preqs, driver = serve(PORT, eng, ps, 8, **dkw)
        want = engines(dtype, **over)[1].generate(ps, max_new_tokens=8)
        for j, p, w, prompt in zip(jreqs, preqs, want, ps):
            assert p.state == j.state == "finished"
            assert p.generated == j.generated
            assert p.generated == [int(t) for t in w[len(prompt):]]
        assert eng.state_manager.free_blocks == eng.config.kv_cache.num_blocks
        snap = driver.metrics.snapshot()
        if "spec" in case:
            assert snap["spec_rounds_total"] > 0 and snap["spec_accepted_tokens_total"] > 0

    def test_no_output_carries_grad_fn(self):
        """The loop runs without autograd even when the engine's weights
        require gradients: no tensor a step hands back has a grad_fn."""
        sd = _engines()
        eng = sd.port_engine(decode_steps=4)
        for w in list(eng.params["layers"].values()) + [eng.params["embed"]]:
            w.requires_grad_(True)
        seen = []
        step_device, decode_round = eng._step_device, eng.decode_round

        def spy_step():
            res = step_device()
            seen.extend(t for logits, _, toks in res.values() for t in (logits, toks))
            seen.append(torch.is_grad_enabled())
            return res

        def spy_round(n):
            seen.append(torch.is_grad_enabled())
            return decode_round(n)

        eng._step_device, eng.decode_round = spy_step, spy_round
        reqs, _ = serve(PORT, eng, real_prompts()[:2], 6, decode_steps=4)
        assert all(len(r.generated) == 6 for r in reqs)
        assert seen and not any(x is True for x in seen)
        assert all(t.grad_fn is None for t in seen if isinstance(t, torch.Tensor))
        assert torch.is_grad_enabled()  # the caller's thread is untouched

    def test_cancel_and_timeout(self):
        """A cancelled stream is a prefix of the uncancelled one; a request
        past its deadline times out; both free their blocks, in both
        packages, and the third request streams on unchanged."""
        sd = _engines()
        ps = real_prompts()

        def scenario(ns, eng):
            with ns.ServingDriver(eng) as driver:
                keep = driver.submit(ps[1], params=params(ns, 8))
                victim = driver.submit(ps[0], params=params(ns, 200))
                first = victim.stream.get(timeout=WAIT_S)
                assert driver.cancel(victim.uid)
                late = driver.submit(ps[2], params=params(ns, 200), timeout_s=0.05)
                for r in (keep, victim, late):
                    assert r.wait(WAIT_S)
            assert eng.state_manager.free_blocks == eng.config.kv_cache.num_blocks
            return keep, victim, late, first

        jk, jv, jl, jf = scenario(JAX, sd.jax_engine())
        pk, pv, pl, pf = scenario(PORT, sd.port_engine())
        assert pk.generated == jk.generated and pf == jf
        assert (pv.state, jv.state) == ("cancelled", "cancelled")
        assert (pl.state, jl.state) == ("timed_out", "timed_out")
        ref = sd.port_engine().generate([ps[0], ps[2]], max_new_tokens=200)
        assert pv.generated == [int(t) for t in ref[0][len(ps[0]):][: len(pv.generated)]]
        assert pl.generated == [int(t) for t in ref[1][len(ps[2]):][: len(pl.generated)]]
