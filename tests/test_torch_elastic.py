"""The port's elastic serving control plane against the JAX package's, on
the CPU.

Mirrors ``tests/unit/test_elastic.py``. The pure pieces answer alike over
tables of inputs: ``ElasticServingConfig`` validation, the degradation
ladder, ``plan_scaling``. The Router cases run one scenario through both
packages on ``FakeEngine`` (each package's real scheduler and allocator,
compute-free steps; ``tests/test_torch_serving.py``): QoS preemption and
resume, admission order, shedding with Retry-After, scale-up from a warm
spare and back. The real-engine case preempts and resumes a stream and
draws a warm spare into the fleet on the tiny model: the streams equal the
single-engine driver's, and the spare's admission builds or loads no
kernel library (``assert_warm_replicas``; on the CPU no kernel loads, so
the signature stays empty).
"""

import importlib
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_torch_serving import JAX, PORT, WAIT_S, FakeEngine, expected_tokens, on_both


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _el(ns) -> SimpleNamespace:
    """One package's elastic surface, by the same names in both."""
    m = importlib.import_module(f"{ns.root}.serving.elastic")
    out = SimpleNamespace(**{k: getattr(m, k) for k in m.__all__})
    out.Router = importlib.import_module(f"{ns.root}.serving.cluster.router").Router
    return out


def sp(ns, n_new, qos="standard", tenant="default"):
    return ns.SamplingParams(max_new_tokens=n_new, ignore_eos=True, qos=qos, tenant=tenant)


def preempt_soon(router, req, timeout=WAIT_S):
    """Preempt ``req`` once it is a steady decode row (retrying the race
    where the worker holds its pending token mid-step)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not req.is_terminal:
        if router.preempt(req.uid):
            return True
        time.sleep(0.002)
    return False


# ---------------------------------------------------------------------------
# configuration, the ladder and the scaling plan (pure, over tables)
# ---------------------------------------------------------------------------
CONFIG_CASES = [
    {}, {"min_decode_replicas": 0}, {"min_decode_replicas": 3, "max_decode_replicas": 2},
    {"control_interval_s": 0.0}, {"scale_up_after": 0}, {"scale_up_queue_per_replica": 0.0},
    {"shed_degrade_at": 0.0}, {"shed_reject_at": 1.5},
    {"shed_degrade_at": 0.9, "shed_spec_off_at": 0.5}, {"shed_max_new_tokens": 0},
    {"min_decode_replicas": 2, "max_decode_replicas": 4, "scale_down_after": 7},
]


@pytest.mark.parametrize("kw", CONFIG_CASES, ids=[str(k) for k in CONFIG_CASES])
def test_elastic_config_validation_table(kw):
    """Valid configurations hold the same fields; invalid ones raise
    ValueError in both packages."""

    def scenario(ns):
        try:
            cfg = _el(ns).ElasticServingConfig(**kw)
        except ValueError:
            return "ValueError"
        return vars(cfg)

    on_both(scenario)


def test_elastic_config_dict_bridge_and_fleet():
    def scenario(ns):
        e = _el(ns)
        out = [e.ElasticServingConfig.from_dict({"max_decode_replicas": 3}).max_decode_replicas]
        with pytest.raises(ValueError, match="unknown elastic serving keys"):
            e.ElasticServingConfig.from_dict({"max_gpus": 3})
        bridged = e.ElasticServingConfig.from_elasticity(
            SimpleNamespace(min_gpus=2, max_gpus=6), scale_up_after=5)
        out.append((bridged.min_decode_replicas, bridged.max_decode_replicas,
                    bridged.scale_up_after))
        cfg = e.ElasticServingConfig(min_decode_replicas=2, max_decode_replicas=4)
        cfg.validate_fleet(2, 2)
        for fleet, match in (((1, 8), "min_decode_replicas"), ((2, 1), "warm spares")):
            with pytest.raises(ValueError, match=match):
                cfg.validate_fleet(*fleet)
        return out

    assert on_both(scenario) == [3, (2, 6, 5)]


# (queue depth, max queue, max_new_tokens, qos)
LADDER_CASES = [(d, 100, n, q) for d in (0, 49, 50, 74, 75, 89, 90, 100)
                for n, q in ((500, "standard"), (8, "batch"), (500, "interactive"),
                             (20, "standard"))]


def test_degradation_ladder_table():
    """Level, rejection, degradation and the admitted budget and spec of
    every (occupancy, request) cell; the caller's params never change."""

    def scenario(ns):
        e = _el(ns)
        lad = e.DegradationLadder(e.ElasticServingConfig(
            shed_degrade_at=0.5, shed_spec_off_at=0.75, shed_reject_at=0.9,
            shed_max_new_tokens=32))
        out = []
        for depth, cap, n_new, qos in LADDER_CASES:
            p = sp(ns, n_new, qos=qos)
            d = lad.apply(p, depth, cap)
            spec = d.params.spec
            out.append((lad.level(depth, cap), d.level, d.reject, d.degraded,
                        d.params.max_new_tokens, None if spec is None else spec.enabled,
                        d.params is p, p.max_new_tokens, p.spec))
        return out

    out = on_both(scenario)
    assert [row[0] for row in out[::4]] == [0, 0, 1, 1, 2, 2, 3, 3]


# (queue depth, active, replicas, spares, slack) sample sequences
SCALING_SEQUENCES = {
    "sustained_pressure": [(4, 0, 1, 1, None)] * 3,
    "blip": [(4, 0, 1, 1, None), (0, 2, 2, 1, None), (4, 0, 1, 1, None)],
    "urgent_slack": [(1, 0, 1, 1, 0.2), (1, 0, 1, 1, 0.2)],
    "idle_streak": [(0, 0, 2, 1, None)] * 4,
    "at_max": [(50, 0, 4, 1, None)] * 3,
    "at_min": [(0, 0, 1, 1, None)] * 5,
}


@pytest.mark.parametrize("name", sorted(SCALING_SEQUENCES))
def test_plan_scaling_table(name):
    def scenario(ns):
        e = _el(ns)
        cfg = e.ElasticServingConfig(min_decode_replicas=1, max_decode_replicas=4,
                                     scale_up_queue_per_replica=2.0, scale_up_after=2,
                                     scale_down_after=3)
        up = down = 0
        out = []
        for q, active, n, spares, slack in SCALING_SEQUENCES[name]:
            sig = e.ScalingSignals(queue_depth=q, active_requests=active, n_decode=n,
                                   spares_available=spares, min_queue_slack_s=slack)
            d, up, down = e.plan_scaling(sig, cfg, up, down)
            out.append((d, up, down))
        return out

    on_both(scenario)


# ---------------------------------------------------------------------------
# QoS preemption, shedding and scaling on the fake engine
# ---------------------------------------------------------------------------
class TestQoSPreemption:
    def test_preempt_resume_stream_identity(self):
        def scenario(ns):
            e = _el(ns)
            eng = FakeEngine(ns, step_delay=0.003)
            router = e.Router(engines=[eng], num_prefill_workers=0,
                              elastic=e.ElasticServingConfig(max_decode_replicas=1)).start()
            try:
                prompt = np.arange(1, 9, dtype=np.int32)
                r = router.submit(prompt, params=sp(ns, 24, qos="batch"))
                assert r.stream.get(timeout=WAIT_S) is not None
                assert preempt_soon(router, r)
                assert r.wait(WAIT_S)
                snap = router.metrics.snapshot()
            finally:
                router.shutdown(drain=False)
            return (r.state, r.generated, r.preemptions, snap["requests_preempted_total"],
                    snap["requests_resumed_total"], eng.state_manager.free_blocks,
                    eng.scheduler.has_work())

        assert on_both(scenario) == ("finished", expected_tokens(np.arange(1, 9), 24), 1, 1, 1,
                                     256, False)

    def test_interactive_preempts_batch_under_pressure(self):
        def scenario(ns):
            e = _el(ns)
            eng = FakeEngine(ns, block_size=4, num_blocks=8, max_blocks_per_seq=8,
                             max_context=64, step_delay=0.004)
            router = e.Router(engines=[eng], num_prefill_workers=0,
                              elastic=e.ElasticServingConfig(max_decode_replicas=1)).start()
            try:
                prompt = np.arange(1, 9, dtype=np.int32)
                low = router.submit(prompt, params=sp(ns, 24, qos="batch"))
                assert low.stream.get(timeout=WAIT_S) is not None
                high = router.submit(prompt, params=sp(ns, 24, qos="interactive"))
                assert high.wait(WAIT_S) and low.wait(WAIT_S)
            finally:
                router.shutdown(drain=False)
            return (high.generated, low.generated, low.preemptions >= 1,
                    high.t_finish < low.t_finish, eng.state_manager.free_blocks)

        want = expected_tokens(np.arange(1, 9), 24)
        assert on_both(scenario) == (want, want, True, True, 8)

    def test_equal_tier_never_preempts(self):
        def scenario(ns):
            e = _el(ns)
            eng = FakeEngine(ns, block_size=4, num_blocks=8, max_blocks_per_seq=8,
                             max_context=64, step_delay=0.002)
            router = e.Router(engines=[eng], num_prefill_workers=0,
                              elastic=e.ElasticServingConfig(max_decode_replicas=1)).start()
            try:
                prompt = np.arange(1, 9, dtype=np.int32)
                a = router.submit(prompt, params=sp(ns, 24))
                assert a.stream.get(timeout=WAIT_S) is not None
                b = router.submit(prompt, params=sp(ns, 8))
                assert a.wait(WAIT_S) and b.wait(WAIT_S)
            finally:
                router.shutdown(drain=False)
            return a.preemptions, a.generated, b.generated

        assert on_both(scenario) == (0, expected_tokens(np.arange(1, 9), 24),
                                     expected_tokens(np.arange(1, 9), 8))

    def test_admission_order_is_priority_then_arrival(self):
        def scenario(ns):
            e = _el(ns)
            eng = FakeEngine(ns, block_size=4, num_blocks=8, max_blocks_per_seq=8,
                             max_context=64, step_delay=0.004)
            router = e.Router(engines=[eng], num_prefill_workers=0,
                              elastic=e.ElasticServingConfig()).start()
            try:
                prompt = np.arange(1, 9, dtype=np.int32)
                running = router.submit(prompt, params=sp(ns, 16, qos="interactive"))
                assert running.stream.get(timeout=WAIT_S) is not None
                low = router.submit(prompt, params=sp(ns, 4, qos="batch"))
                high = router.submit(prompt, params=sp(ns, 4, qos="interactive"))
                for r in (running, low, high):
                    assert r.wait(WAIT_S)
            finally:
                router.shutdown(drain=False)
            return [r.state for r in (running, low, high)], high.t_first_token < low.t_first_token

        assert on_both(scenario) == (["finished"] * 3, True)

    def test_preemptible_gates_and_checkpoint_shape(self):
        def scenario(ns):
            e = _el(ns)
            eng = FakeEngine(ns)
            gates = [e.preemptible(eng, 7)]
            eng.scheduler.submit(7, np.arange(1, 9, dtype=np.int32))
            gates.append(e.preemptible(eng, 7))
            tok = eng.step_tokens()[7]
            eng.scheduler.feedback(7, tok)
            gates.append(e.preemptible(eng, 7))
            ck = e.preempt_sequence(eng, 7)
            eng.scheduler.finish(7)
            free = eng.state_manager.free_blocks
            e.resume_sequence(eng, ck)
            seq = eng.state_manager.get_sequence(7)
            out = (gates, ck.tokens, ck.pending_token, ck.seen_tokens, ck.n_blocks, free,
                   list(seq.tokens), eng.scheduler.peek_next_token(7))
            eng.scheduler.finish(7)
            with pytest.raises(e.PreemptionError, match="no live sequence"):
                e.preempt_sequence(eng, 7)
            return out

        gates, tokens, tok, seen, *_ = on_both(scenario)
        assert gates == [False, False, True] and seen == len(tokens) == 8


class TestShedding:
    def test_lowest_tier_sheds_with_retry_after(self):
        def scenario(ns):
            e = _el(ns)
            cfg = e.ElasticServingConfig(shed_degrade_at=0.01, shed_spec_off_at=0.01,
                                         shed_reject_at=0.01)
            router = e.Router(engines=[FakeEngine(ns)], num_prefill_workers=0, elastic=cfg,
                              max_queue=4)
            try:
                prompt = np.asarray([1, 2], np.int32)
                keep = [router.submit(prompt, params=sp(ns, 8)) for _ in range(2)]
                with pytest.raises(ns.RequestRejected) as ei:
                    router.submit(prompt, params=sp(ns, 4, qos="batch", tenant="acme"))
                ok = router.submit(prompt, params=sp(ns, 4, qos="interactive"))
                snap = router.metrics.snapshot()
                router.start()
                for r in keep + [ok]:
                    assert r.wait(WAIT_S)
            finally:
                router.shutdown(drain=False)
            return (ei.value.reason, ei.value.retry_after_s >= 1.0, snap["requests_shed_total"],
                    snap["tier_acme_batch_shed_total"], [r.generated for r in keep + [ok]])

        assert on_both(scenario)[:4] == ("shed", True, 1, 1)

    def test_degraded_admission_caps_tokens(self):
        def scenario(ns):
            e = _el(ns)
            cfg = e.ElasticServingConfig(shed_degrade_at=0.01, shed_spec_off_at=0.02,
                                         shed_reject_at=0.9, shed_max_new_tokens=3)
            router = e.Router(engines=[FakeEngine(ns)], num_prefill_workers=0, elastic=cfg,
                              max_queue=100)
            try:
                prompt = np.asarray([1, 2], np.int32)
                first = router.submit(prompt, params=sp(ns, 30))
                degraded = router.submit(prompt, params=sp(ns, 30))
                router.start()
                assert first.wait(WAIT_S) and degraded.wait(WAIT_S)
            finally:
                router.shutdown(drain=False)
            return len(first.generated), len(degraded.generated), degraded.finish_reason

        assert on_both(scenario) == (30, 3, "max_tokens")

    def test_queue_full_has_retry_after(self):
        def scenario(ns):
            router = _el(ns).Router(engines=[FakeEngine(ns)], num_prefill_workers=0,
                                    max_queue=1)
            try:
                router.submit(np.asarray([1], np.int32), params=sp(ns, 4))
                with pytest.raises(ns.RequestRejected) as ei:
                    router.submit(np.asarray([1], np.int32), params=sp(ns, 4))
            finally:
                router.shutdown(drain=False)
            return ei.value.reason, 1.0 <= ei.value.retry_after_s <= 120.0

        assert on_both(scenario) == ("queue_full", True)


class TestScaling:
    @staticmethod
    def _router(ns, n_spares=1):
        e = _el(ns)

        def mk():  # one resident request a replica: a burst builds a queue
            return FakeEngine(ns, block_size=4, num_blocks=8, max_blocks_per_seq=8,
                              max_context=64, step_delay=0.004)

        cfg = e.ElasticServingConfig(min_decode_replicas=1, max_decode_replicas=1 + n_spares,
                                     control_interval_s=30.0, scale_up_after=1,
                                     scale_down_after=2)
        pool = e.WarmSparePool(factory=mk, count=n_spares)
        return e.Router(engines=[mk()], num_prefill_workers=0, elastic=cfg,
                        spare_pool=pool).start(), pool

    def test_burst_scales_up_from_warm_spare_then_down(self):
        """Queue pressure draws the warm spare into the fleet, every request
        streams exactly, both replicas take work; an idle streak retires
        the extra replica back into the pool."""

        def scenario(ns):
            router, pool = self._router(ns)
            ctl = router._controller
            try:
                prompt = np.arange(1, 9, dtype=np.int32)
                reqs = [router.submit(prompt, params=sp(ns, 24)) for _ in range(6)]
                up = ctl.step()
                mid = (pool.available, pool.spawned, len(router.decode),
                       router.health()["elastic"]["decode_replicas"],
                       router.assert_warm_replicas())
                for r in reqs:
                    assert r.wait(WAIT_S)
                both = all(c.engine.steps > 0 for c in router.decode)
                deadline = time.monotonic() + WAIT_S
                while len(router.decode) > 1:
                    ctl.step()
                    assert time.monotonic() < deadline, "never scaled down"
                    time.sleep(0.01)
                snap = router.metrics.snapshot()
            finally:
                router.shutdown(drain=False)
            return (up, mid, [r.generated for r in reqs], both, pool.available,
                    snap["scale_up_total"], snap["scale_down_total"], snap["decode_replicas"])

        got = on_both(scenario)
        assert got[0] == 1 and got[1] == (0, 1, 2, 2, 1)
        assert got[2] == [expected_tokens(np.arange(1, 9), 24)] * 6
        assert got[3:] == (True, 1, 1, 1, 1)

    def test_scale_bounds_and_fleet_validation(self):
        def scenario(ns):
            e = _el(ns)
            router, _ = self._router(ns)
            try:
                got = [router.add_decode_replica() is not None,
                       router.add_decode_replica() is None, len(router.decode)]
            finally:
                router.shutdown(drain=False)
            router, _ = self._router(ns)
            try:
                got.append(router.remove_decode_replica())  # never below the minimum
            finally:
                router.shutdown(drain=False)
            with pytest.raises(ValueError, match="min_decode_replicas"):
                e.Router(engines=[FakeEngine(ns)], num_prefill_workers=0,
                         elastic=e.ElasticServingConfig(min_decode_replicas=2,
                                                        max_decode_replicas=2))
            return got

        assert on_both(scenario) == [True, True, 2, None]

    def test_warm_spare_pool_counters_and_assert(self):
        def scenario(ns):
            e = _el(ns)
            pool = e.WarmSparePool(factory=lambda: FakeEngine(ns), count=2)
            out = [pool.available, pool.spawned, pool.warmed]
            eng, baseline = pool.acquire()
            e.assert_no_new_traces(eng, baseline)
            out += [baseline, pool.available]
            pool.add(eng)
            out.append(pool.available)
            with pytest.raises(ValueError, match="needs a factory"):
                e.WarmSparePool(count=1)
            return out

        assert on_both(scenario) == [2, 2, 0, {}, 1, 2]

    def test_assert_no_new_traces_names_what_grew(self):
        """A signature that grew after warm-up fails, naming each entry."""
        for ns in (JAX, PORT):
            e = _el(ns)
            eng = SimpleNamespace(trace_signature=lambda: {"kernel[paged_decode]": 1, "x": 2})
            e.assert_no_new_traces(eng, {"kernel[paged_decode]": 1, "x": 2})
            with pytest.raises(RuntimeError, match="kernel\\[paged_decode\\]: 0 -> 1"):
                e.assert_no_new_traces(eng, {"x": 2}, label="replica d2")


class TestTierHealth:
    def test_router_health_elastic_and_qos_blocks(self):
        def scenario(ns):
            e = _el(ns)
            router = e.Router(engines=[FakeEngine(ns)], num_prefill_workers=0,
                              elastic=e.ElasticServingConfig(max_decode_replicas=1)).start()
            try:
                r = router.submit(np.asarray([1, 2], np.int32),
                                  params=sp(ns, 4, qos="interactive", tenant="acme"))
                assert r.wait(WAIT_S)
                h = router.health()
            finally:
                router.shutdown(drain=False)
            plain = e.Router(engines=[FakeEngine(ns)], num_prefill_workers=0).health()
            q = h["qos"]["acme/interactive"]
            return (h["elastic"]["enabled"], h["elastic"]["decode_replicas"],
                    h["elastic"]["max_decode_replicas"], q["finished_total"], q["ttft_count"],
                    plain["elastic"]["enabled"])

        assert on_both(scenario) == (True, 1, 1, 1, 1, False)


# ---------------------------------------------------------------------------
# real engines: preempt and resume, a warm scale-up and a scale-down
# ---------------------------------------------------------------------------
class TestElasticRealEngine:
    @pytest.mark.parametrize("sampling", [{"greedy": True},
                                          {"greedy": False, "temperature": 0.8, "seed": 123}],
                             ids=["greedy", "seeded"])
    def test_preempt_resume_and_warm_scale_up_and_down(self, sampling):
        """On the tiny model: a stream preempted mid-decode and resumed, and
        a request on a replica drawn from a warm spare, equal the
        single-engine driver's streams; the spare's admission built or
        loaded no kernel library; a scale-down parks the replica back in
        the pool, warmed again."""
        from tests import test_torch_spec_decode as sd

        def mk():
            eng = sd.port_engine()
            eng.set_sampling(**sampling)
            return eng

        e = _el(PORT)
        prompts = [np.arange(1 + 3 * i, 25 + 3 * i, dtype=np.int32) for i in range(2)]
        drv = PORT.ServingDriver(mk()).start()
        want = []
        for p in prompts:
            r = drv.submit(p, params=sp(PORT, 10))
            assert r.wait(WAIT_S)
            want.append(r.generated)
        drv.shutdown()
        pool = e.WarmSparePool(factory=mk, count=1, warm_kw={"decode_steps": 1, "spec_k": 0})
        assert pool.warmed == 1
        cfg = e.ElasticServingConfig(min_decode_replicas=1, max_decode_replicas=2,
                                     control_interval_s=30.0)
        router = e.Router(engines=[mk()], num_prefill_workers=0, elastic=cfg,
                          spare_pool=pool).start()
        try:
            r0 = router.submit(prompts[0], params=sp(PORT, 10))
            assert r0.stream.get(timeout=WAIT_S) is not None
            assert preempt_soon(router, r0)
            core = router.add_decode_replica()
            assert core is not None and core.name == "d1" and pool.available == 0
            r1 = router.submit(prompts[1], params=sp(PORT, 10))
            assert r0.wait(WAIT_S) and r1.wait(WAIT_S)
            assert [r0.generated, r1.generated] == want
            assert r0.preemptions == 1
            assert router.assert_warm_replicas() == 1
            assert core._warm_baseline == {}  # no kernel library on the CPU
            deadline = time.monotonic() + WAIT_S
            while router.remove_decode_replica() is None:
                assert time.monotonic() < deadline, "never scaled down"
                time.sleep(0.01)
            assert pool.available == 1 and pool.warmed == 2
            assert len(router.decode) == 1
        finally:
            router.shutdown(drain=False)
