"""The port's tracing, event log, Chrome export and the metrics bridges
against the JAX package's, on the CPU.

Each test runs one scenario through both packages
(``tests/test_torch_serving.py``'s ``on_both``) and holds the port to the
JAX package's results: span names, parents and args, trees, exported
documents, exposition text, event values. Times are compared only where
the scenario sets them itself. The serving tests trace real drivers over
both packages' ``InferenceEngineV2`` (the tiny model of
``tests/test_torch_spec_decode.py``): the engine track's spans
(``engine.dispatch``, ``engine.device_wait``, the round spans) and every
request's tree must be equal in names and structure (not in times), and
so must the host tier's ``host_tier.spill`` / ``host_tier.readmit`` spans
over the eviction cycle of ``tests/test_torch_host_tier.py``.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_torch_serving import JAX, PORT, WAIT_S, FakeEngine, engines, on_both, params


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _isolated_tracer():
    """Tracing off and empty event logs before and after every test, in
    both packages (each has its own process-global tracer and log)."""
    for ns in (JAX, PORT):
        ns.observability.set_tracer(ns.observability.NULL_TRACER)
        ns.observability.get_event_log().clear()
    yield
    for ns in (JAX, PORT):
        ns.observability.set_tracer(ns.observability.NULL_TRACER)
        ns.observability.get_event_log().clear()


def _shape(spans):
    """A span list without its times: (name, parent's name, track, args)."""
    by_id = {sp.span_id: sp for sp in spans}
    out = []
    for sp in spans:
        parent = by_id.get(sp.parent_id)
        out.append((sp.name, parent.name if parent is not None else None, sp.track,
                    sp.args))
    return out


def _assert_single_rooted(spans):
    ids = {sp.span_id: sp for sp in spans}
    roots = [sp for sp in spans if sp.parent_id is None]
    assert len(roots) == 1, [r.name for r in roots]
    for sp in spans:
        cur, seen = sp, set()
        while cur.parent_id is not None:
            assert cur.span_id not in seen and cur.parent_id in ids
            seen.add(cur.span_id)
            cur = ids[cur.parent_id]
        assert cur is roots[0]
    return roots[0]


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------
class TestSpanTracer:
    def test_tree_lifecycle_and_parent_default(self):
        def scenario(ns):
            tr = ns.observability.SpanTracer()
            root = tr.begin_trace(7, "request", t0=1.0, args={"uid": 7})
            child = tr.start(7, "queued", t0=1.0)
            assert child.parent_id == root.span_id
            grand = tr.start(7, "placement", parent=child, t0=1.5)
            tr.end(grand, t1=1.6, args={"core": "d0"})
            assert tr.end_trace(7, meta={"finish_reason": "stop"})
            rec = tr.trace(7)
            _assert_single_rooted(rec["spans"])
            return (rec["complete"], rec["meta"], _shape(rec["spans"]),
                    [(s.t0, s.t1) for s in rec["spans"]])

        complete, meta, shape, _ = on_both(scenario)
        assert complete and meta["finish_reason"] == "stop"
        assert [s[0] for s in shape] == ["request", "queued", "placement"]

    def test_unknown_key_spans_dropped(self):
        def scenario(ns):
            tr = ns.observability.SpanTracer()
            sp = tr.start(999, "late", t0=0.0)
            return sp.name, tr.trace(999), tr.dropped_spans

        assert on_both(scenario) == ("late", None, 1)

    def test_ring_instant_ctx_manager_and_bound(self):
        def scenario(ns):
            tr = ns.observability.SpanTracer()
            with tr.span("round.fused", track="d0", args={"rows": 3}) as sp:
                pass
            mark = tr.instant("host_tier.spill", track="d0", args={"block": 5})
            small = ns.observability.SpanTracer(max_events=10)
            for i in range(300):
                small.instant(f"e{i}")
            return (sp.t1 is not None, mark.t0 == mark.t1, _shape(tr.ring_spans()),
                    small.max_events, len(small.ring_spans()))

        ended, instant, ring, cap, n = on_both(scenario)
        assert ended and instant and (cap, n) == (256, 256)
        assert [s[0] for s in ring] == ["round.fused", "host_tier.spill"]

    def test_completed_trace_budget_eviction(self):
        def scenario(ns):
            tr = ns.observability.SpanTracer(max_events=256)
            for uid in range(4):
                tr.begin_trace(uid, "request", t0=0.0)
                for j in range(99):
                    tr.end(tr.start(uid, f"s{j}", t0=0.0), t1=0.0)
                tr.end(tr.trace(uid)["spans"][0], t1=1.0)
                tr.end_trace(uid)
            tr.begin_trace(9, "request", t0=0.0)
            tr.start(9, "queued", t0=0.0)
            tr.begin_trace(9, "request", t0=5.0)  # uid reuse: the stale tree goes
            st = tr.stats()
            return ([rec["key"] for rec in tr.traces()], st["completed_spans"],
                    tr.dropped_traces, len(tr.trace(9)["spans"]), st["active_traces"])

        keys, spans, dropped, n9, active = on_both(scenario)
        assert 3 in keys and 0 not in keys and spans <= 256 and dropped >= 1
        assert (n9, active) == (1, 1)


class TestCapturePolicy:
    @staticmethod
    def _finished(tr, uid, e2e, slow_hint=False):
        tr.end(tr.begin_trace(uid, "request", t0=0.0), t1=e2e)
        return tr.end_trace(uid, slow_hint=slow_hint)

    def test_warmup_then_slow_only(self):
        def scenario(ns):
            tr = ns.observability.SpanTracer(capture="slow")
            warm = [self._finished(tr, uid, 0.001) for uid in range(tr.WARMUP)]
            tr2 = ns.observability.SpanTracer(capture="slow")
            tr2._e2e_samples.extend([1.0] * tr2.RESERVOIR)
            kept = [self._finished(tr2, 1, 0.001), self._finished(tr2, 2, 2.0),
                    self._finished(tr2, 3, 0.001, slow_hint=True)]
            tr2.begin_trace(4, "request", t0=0.0)
            kept.append(tr2.end_trace(4))
            every = ns.observability.SpanTracer(capture="all")
            every._e2e_samples.extend([1.0] * every.RESERVOIR)
            kept.append(self._finished(every, 1, 0.001))
            with pytest.raises(ValueError, match="capture"):
                ns.observability.SpanTracer(capture="sometimes")
            return all(warm), kept

        assert on_both(scenario) == (True, [False, True, True, True, True])


class TestNullTracer:
    def test_noop_identity_no_per_call_allocation(self):
        def scenario(ns):
            tr = ns.observability.NULL_TRACER
            handles = {id(tr.span("a")), id(tr.span("b")), id(tr.start(None, "c")),
                       id(tr.begin_trace(1, "d")), id(tr.complete("e", 0.0)),
                       id(tr.instant("f"))}
            with tr.span("g") as sp:
                assert sp is tr.span("h")
            tr.end(sp)
            return tr.enabled, len(handles), tr.end_trace(1), tr.stats()

        assert on_both(scenario) == (False, 1, False, {"enabled": False})

    def test_configure_tracing_switches_global(self):
        def scenario(ns):
            o = ns.observability
            live = o.configure_tracing(enabled=True, max_events=512, capture="slow")
            out = (o.get_tracer() is live, live.enabled, live.max_events, live.capture)
            o.configure_tracing(enabled=False)
            return out + (o.get_tracer() is o.NULL_TRACER,)

        assert on_both(scenario) == (True, True, 512, "slow", True)


class TestEventLog:
    def test_bounded_newest_first_and_global(self):
        def scenario(ns):
            log = ns.observability.EventLog(maxlen=4)
            for i in range(6):
                log.emit("shed_level", level=i)
            ns.observability.log_event("scale_up", replica="d1")
            recent = [{k: v for k, v in e.items() if k != "t"} for e in log.recent(2)]
            return (len(log), log.total, log.stats(), recent,
                    [e.fields["level"] for e in log.events()],
                    ns.observability.get_event_log().recent(1)[0]["kind"])

        n, total, stats, recent, oldest, kind = on_both(scenario)
        assert (n, total, oldest, kind) == (4, 6, [2, 3, 4, 5], "scale_up")
        assert [e["level"] for e in recent] == [5, 4] and stats["dropped"] == 2


class TestChromeExport:
    @staticmethod
    def _small(ns):
        tr = ns.observability.SpanTracer()
        root = tr.begin_trace(3, "request", t0=1.0, args={"uid": 3})
        tr.end(tr.start(3, "queued", t0=1.0), t1=1.1)
        tr.end(root, t1=2.0)
        tr.end_trace(3)
        tr.complete("round.fused", 1.2, 1.3, track="d0", args={"rows": 2})
        return tr

    def test_export_layout_and_validation(self):
        def scenario(ns):
            o = ns.observability
            log = o.EventLog()
            ev = log.emit("preempt", uid=3)
            ev.t = 1.5  # a fixed clock for the comparison
            doc = o.to_chrome_trace(tracer=self._small(ns), event_log=log)
            assert o.validate_chrome_trace(doc) == []
            json.dumps(doc)
            return doc

        doc = on_both(scenario)
        xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        assert {e["pid"] for e in xs} == {1, 2}
        root = next(e for e in xs if e["name"] == "request")
        assert root["ts"] == 1.0e6 and root["dur"] == 1.0e6

    def test_open_spans_and_validator(self, tmp_path):
        def scenario(ns):
            o = ns.observability
            tr = o.SpanTracer()
            tr.begin_trace(1, "request", t0=1.0)
            doc = o.trace_to_chrome(tr.trace(1), now=4.0)
            bad = {"traceEvents": [
                {"ph": "Q", "name": "x", "pid": 1},
                {"ph": "X", "pid": 1, "ts": 0.0, "dur": 1.0},
                {"ph": "X", "name": "y", "pid": 1, "ts": float("nan"), "dur": 1.0},
                {"ph": "X", "name": "z", "pid": 1, "ts": 0.0, "dur": -1.0},
            ]}
            path = tmp_path / f"{ns.root}.trace.json"
            o.write_trace(str(path), o.to_chrome_trace(tracer=self._small(ns)))
            with pytest.raises(ValueError, match="invalid"):
                o.write_trace(str(tmp_path / "bad.json"), {"traceEvents": [{}]})
            return (doc, o.validate_chrome_trace([]), o.validate_chrome_trace(bad),
                    o.validate_chrome_trace(json.loads(path.read_text())))

        doc, empty, bad, written = on_both(scenario)
        ev = next(e for e in doc["traceEvents"] if e["ph"] == "X")
        assert ev["args"]["open"] is True and ev["dur"] == 3.0e6
        assert empty != [] and len(bad) == 4 and written == []


# ---------------------------------------------------------------------------
# the driver's trees and the engine's spans
# ---------------------------------------------------------------------------
def _traced_serve(ns, eng, prompts, n_new, **driver_kw):
    """Submit every prompt before the loop starts (one admission pass, so
    the rounds are deterministic), serve with tracing on, and return
    (requests, driver, tracer)."""
    tracer = ns.observability.set_tracer(ns.observability.SpanTracer())
    driver = ns.ServingDriver(eng, **driver_kw)
    try:
        reqs = [driver.submit(p, params=params(ns, n_new)) for p in prompts]
        driver.start()
        for r in reqs:
            assert r.wait(WAIT_S), f"request {r.uid} did not finish"
    finally:
        driver.shutdown(drain=False, timeout=WAIT_S)
        ns.observability.set_tracer(ns.observability.NULL_TRACER)
    return reqs, driver, tracer


def _trees(tracer, reqs):
    return {r.uid: _shape(tracer.trace(r.uid)["spans"]) for r in reqs}


class TestDriverTracing:
    def test_rooted_tree_and_histogram_bridge(self):
        def scenario(ns):
            prompt = np.asarray([5, 6, 7], np.int32)
            (req,), driver, tracer = _traced_serve(ns, FakeEngine(ns), [prompt], 4, max_queue=8)
            assert req.trace is None and req.generated == [8, 9, 10, 11]
            rec = tracer.trace(req.uid)
            root = _assert_single_rooted(rec["spans"])
            assert driver.metrics.e2e.total == pytest.approx(root.t1 - root.t0)
            assert ns.observability.validate_chrome_trace(
                ns.observability.trace_to_chrome(rec)) == []
            return (rec["complete"], rec["meta"], _shape(rec["spans"]),
                    driver.metrics.e2e.count, driver.metrics.ttft.count)

        complete, meta, shape, e2e, ttft = on_both(scenario)
        names = [s[0] for s in shape]
        assert complete and meta["tenant"] == "default" and (e2e, ttft) == (1, 1)
        for phase in ("queued", "prefill", "decode"):
            assert (phase, "request") in [(s[0], s[1]) for s in shape], names

    def test_tracing_off_leaves_requests_clean(self):
        def scenario(ns):
            with ns.ServingDriver(FakeEngine(ns), max_queue=8) as driver:
                req = driver.submit(np.asarray([3], np.int32), params=params(ns, 2))
                assert req.wait(WAIT_S)
            o = ns.observability
            return (req.trace, o.get_tracer() is o.NULL_TRACER, driver.metrics.e2e.count,
                    o.NULL_TRACER.ring_spans(), o.NULL_TRACER.recent())

        assert on_both(scenario) == (None, True, 1, [], [])

    @pytest.mark.parametrize("case", ["split", "fused4", "spec"])
    def test_engine_spans_and_request_trees_match_jax(self, case):
        """Real engines: the engine track (dispatch / device_wait brackets
        inside each step.split, round.fused or round.verify) and every
        request's tree are equal in names, parents and args."""
        from tests.test_torch_serving import real_prompts

        over, dkw = {"split": ({}, {}), "fused4": ({"decode_steps": 4}, {"decode_steps": 4}),
                     "spec": ({"spec_k": 4}, {})}[case]
        je, pe = engines(**over)
        ps = real_prompts()
        jr, _, jt = _traced_serve(JAX, je, ps, 6, **dkw)
        pr, _, pt = _traced_serve(PORT, pe, ps, 6, **dkw)
        assert [r.generated for r in pr] == [r.generated for r in jr]
        ring_j, ring_p = _shape(jt.ring_spans()), _shape(pt.ring_spans())
        assert ring_p == ring_j
        names = {s[0] for s in ring_p}
        assert {"engine.dispatch", "engine.device_wait", "step.split"} <= names
        want = {"split": "step.split", "fused4": "round.fused", "spec": "round.verify"}[case]
        assert want in names
        assert _trees(pt, pr) == _trees(jt, jr)
        for r in pr:
            _assert_single_rooted(pt.trace(r.uid)["spans"])
        doc = PORT.observability.to_chrome_trace(tracer=pt)
        assert PORT.observability.validate_chrome_trace(doc) == []

    def test_host_tier_spans_match_jax(self):
        """The eviction cycle of tests/test_torch_host_tier.py with tracing
        on: the same host_tier.spill instants and host_tier.readmit spans
        (names, tracks, args) in the same order."""
        from tests import test_torch_host_tier as ht

        rings = {}
        for ns, build in ((JAX, ht.jax_engine), (PORT, ht.port_engine)):
            tracer = ns.observability.set_tracer(ns.observability.SpanTracer())
            try:
                ht.evict_cycle(build(1 << 20))
            finally:
                ns.observability.set_tracer(ns.observability.NULL_TRACER)
            rings[ns.root] = [s for s in _shape(tracer.ring_spans())
                              if s[0].startswith("host_tier.")]
        assert rings["deepspeed_tpu_torch"] == rings["deepspeed_tpu"]
        names = [s[0] for s in rings["deepspeed_tpu_torch"]]
        assert "host_tier.spill" in names and "host_tier.readmit" in names

    def test_tracing_off_adds_nothing_to_the_step(self, monkeypatch):
        """With tracing off the engine's step never reaches the device wait
        (nor the span helpers); with it on, once per step."""
        from deepspeed_tpu_torch.inference.v2 import engine_v2

        calls = []
        monkeypatch.setattr(engine_v2, "_device_wait", lambda device: calls.append(device))
        _, pe = engines(decode_steps=4)
        from tests.test_torch_serving import real_prompts, serve

        serve(PORT, pe, real_prompts()[:2], 6, decode_steps=4)
        assert calls == []
        _, pe = engines(decode_steps=4)
        _traced_serve(PORT, pe, real_prompts()[:2], 6, decode_steps=4)
        assert calls and all(d == torch.device("cpu") for d in calls)


class TestHistogramBridgeEquality:
    def test_span_bridge_matches_request_stamps_exactly(self):
        def scenario(ns):
            o = ns.observability
            tracer = o.SpanTracer()
            req = ns.Request(uid=11, prompt_tokens=np.asarray([1, 2], np.int32),
                             params=params(ns, 8))
            req.t_submit = 100.0
            req.generated = [3, 4, 5, 6]
            o.begin_request_trace(tracer, req)
            req.t_admitted = 100.5
            o.mark_admitted(req, core="d0")
            req.t_first_token = 101.0
            o.mark_first_token(req)
            req.t_finish = 103.0
            req.finish_reason = "max_tokens"
            traced, plain = ns.ServingMetrics(), ns.ServingMetrics()
            traced.observe_trace(req)
            o.finish_request_trace(req)
            plain.observe_request(req)
            out = {}
            for attr in ("ttft", "tpot", "e2e"):
                a, b = getattr(traced, attr), getattr(plain, attr)
                assert (a.count, a.total, a.counts) == (b.count, b.total, b.counts)
                out[attr] = (a.count, a.total, list(a.counts))
            fallback = ns.ServingMetrics()
            late = ns.Request(uid=12, prompt_tokens=np.asarray([1], np.int32),
                              params=params(ns, 2))
            late.t_submit, late.t_finish = 10.0, 11.0
            fallback.observe_trace(late)
            return out, (fallback.e2e.count, fallback.e2e.total), _shape(
                tracer.trace(11)["spans"])

        out, fallback, shape = on_both(scenario)
        assert out["ttft"][1] == pytest.approx(1.0) and out["e2e"][1] == pytest.approx(3.0)
        assert fallback == (1, pytest.approx(1.0))


class TestLabelSafety:
    def test_escape_and_render(self):
        evil = 'x"} 1\nevil_metric{t="'

        def scenario(ns):
            esc = ns.monitor.escape_label_value('a"b\\c\nd')
            text = ns.monitor.render_prometheus_text([("m", {"tenant": evil}, 1.0, "gauge")])
            return esc, text

        esc, text = on_both(scenario)
        assert esc == 'a\\"b\\\\c\\nd' and "\nevil_metric" not in text
        assert len([line for line in text.splitlines() if line]) == 2

    @pytest.mark.parametrize("tenant", ["", "a\nb", "a\x00b", "x" * 65, "\x7f"])
    def test_bad_tenant_rejected_at_admission(self, tenant):
        def scenario(ns):
            with pytest.raises(ValueError, match="tenant") as ei:
                ns.SamplingParams(tenant=tenant)
            return str(ei.value)

        on_both(scenario)

    def test_trace_id_and_hostile_tier_labels(self):
        def scenario(ns):
            with pytest.raises(ValueError, match="trace_id"):
                ns.SamplingParams(trace_id="a\nb")
            m = ns.ServingMetrics()
            m.observe_tier('ten"ant', "batch", "finished_total")
            return ns.SamplingParams(trace_id="req-01").trace_id, m.prometheus_text()

        tid, text = on_both(scenario)
        assert tid == "req-01"
        assert any('tenant="ten\\"ant"' in line for line in text.splitlines()
                   if "tier_finished_total{" in line)


class TestMonitorBridge:
    @staticmethod
    def _labeled(ns):
        m = ns.ServingMetrics()
        m.inc("requests_finished_total", 3)
        m.observe_request(SimpleNamespace(ttft_s=0.5, tpot_s=0.01, e2e_s=1.0))
        m.update_replica("d0", {"free_blocks": 7, "resident": 2.0, "role_str": "decode"},
                         role="decode")
        m.observe_tier("acme", "interactive", "finished_total")
        m.observe_tier("acme", "interactive", "ttft_s", 0.25)
        return m

    def test_to_events_csv_and_prometheus(self, tmp_path):
        def scenario(ns):
            events = self._labeled(ns).to_events()
            out = tmp_path / ns.root
            csv = ns.monitor.csvMonitor(SimpleNamespace(enabled=True, output_path=str(out),
                                                        job_name="serve"))
            csv.write_events(events)
            prom = ns.monitor.PrometheusMonitor(SimpleNamespace(enabled=True, output_path=""))
            prom.write_events(events)
            files = sorted(p.name for p in (out / "serve").iterdir())
            tier = (out / "serve" / "Serving_tier_acme_interactive_finished_total.csv")
            return events, files, tier.read_text(), prom.expose()

        events, files, tier, text = on_both(scenario)
        ev = {name: value for name, value, _ in events}
        assert ev["Serving/replica_d0_free_blocks"] == 7
        assert "Serving/replica_d0_role_str" not in ev
        assert tier.splitlines()[1] == "3,1.0"
        assert "Serving_replica_d0_free_blocks 7.0" in text

    def test_missing_writer_packages_warn_and_disable(self, monkeypatch):
        """TensorBoard, W&B and Comet without their packages (hidden from
        the import system here): the writers disable themselves with a
        warning and writes are no-ops, as the JAX package's are."""
        import sys

        for pkg in ("tensorboard", "torch.utils.tensorboard", "wandb", "comet_ml"):
            monkeypatch.setitem(sys.modules, pkg, None)  # import raises ImportError

        def scenario(ns):
            tb = ns.monitor.TensorBoardMonitor(SimpleNamespace(
                enabled=True, output_path="", job_name="j"))
            wb = ns.monitor.WandbMonitor(SimpleNamespace(
                enabled=True, project="p", group=None, team=None))
            cm = ns.monitor.CometMonitor(SimpleNamespace(enabled=True, project="p"))
            for w in (tb, wb, cm):
                w.write_events([("x", 1.0, 1)])
            return tb.enabled, wb.enabled, cm.enabled

        assert on_both(scenario) == (False, False, False)
