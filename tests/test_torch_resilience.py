"""The port's serving resilience against the JAX package's, on the CPU.

Mirrors ``tests/unit/test_resilience.py`` (a remote agent's loss, replay
and re-admission are held in ``tests/test_torch_multihost.py``). The building blocks are driven directly in both
packages over tables of inputs and must answer alike: the replica health
state machine after the same event sequences (fake clock), bounded
retries (fake sleep), the recovery planner. The Router cases run one chaos
scenario through both packages on ``FakeEngine`` (each package's real
scheduler and allocator, compute-free steps; ``tests/test_torch_serving.py``)
and compare streams, terminal states and the ``/health`` resilience block.
The real-engine case kills a decode replica's worker mid-stream on the
tiny model and holds every stream to the fault-free pass's.
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


def _res(ns) -> SimpleNamespace:
    """One package's resilience surface, by the same names in both."""
    m = importlib.import_module(f"{ns.root}.serving.resilience")
    out = SimpleNamespace(**{k: getattr(m, k) for k in m.__all__})
    out.Router = importlib.import_module(f"{ns.root}.serving.cluster.router").Router
    return out


def sp(ns, n):
    return ns.SamplingParams(max_new_tokens=n, ignore_eos=True)


def run_all(ns, front, prompts, n_new, timeout=WAIT_S):
    reqs = [front.submit(p, params=sp(ns, n_new)) for p in prompts]
    for r in reqs:
        assert r.wait(timeout), f"uid={r.uid} never finished ({r.state})"
    return reqs


def fast_cfg(ns, **kw):
    base = dict(hung_step_s=5.0, probe_backoff_s=0.05, retry_backoff_s=0.001)
    base.update(kw)
    base.setdefault("probe_backoff_max_s", max(30.0, base["probe_backoff_s"]))
    return _res(ns).ResilienceConfig(**base)


# ---------------------------------------------------------------------------
# replica health state machine (fake clock)
# ---------------------------------------------------------------------------
# event sequences: (method, argument or None, clock advance after)
HEALTH_SEQUENCES = {
    "error_streak": [("note_error", "e1", 0), ("note_error", "e2", 0), ("note_error", "e3", 0)],
    "success_resets": [("note_error", "e1", 0), ("note_success", None, 0),
                       ("note_error", "e2", 0)],
    "quarantine_sticky": [("note_error", f"e{i}", 0) for i in range(3)]
    + [("note_success", None, 0)],
    "crash": [("note_crash", "boom", 0.5)],
    "hang": [("note_hang", "wedged", 0)],
    "probe_backoff": [("note_crash", "dead", 1.0), ("begin_probe", None, 0),
                      ("probe_failed", "still", 2.0), ("begin_probe", None, 0),
                      ("probe_failed", "still", 4.0), ("begin_probe", None, 0),
                      ("probe_failed", "still", 4.0), ("begin_probe", None, 0),
                      ("probe_passed", None, 0)],
    "error_in_probation": [("note_crash", "dead", 1.0), ("begin_probe", None, 0),
                           ("note_error", "raced", 0.5)],
    "degraded_then_crash": [("note_error", "e1", 0.1), ("note_crash", "c", 0.1),
                            ("note_success", None, 0)],
}


@pytest.mark.parametrize("name", sorted(HEALTH_SEQUENCES))
def test_replica_health_snapshots_after_the_same_events(name):
    """After every event of the sequence: the state, the returned value,
    ``placeable``, ``probe_due()``, the counters and ``snapshot()`` are the
    JAX machine's."""

    def scenario(ns):
        r = _res(ns)
        clock = {"t": 100.0}
        cfg = r.ResilienceConfig(degrade_after=1, quarantine_after=3, probe_backoff_s=1.0,
                                 probe_backoff_max_s=4.0)
        h = r.ReplicaHealth("d0", cfg, clock=lambda: clock["t"])
        out = []
        for method, arg, advance in HEALTH_SEQUENCES[name]:
            got = getattr(h, method)(*([] if arg is None else [arg]))
            clock["t"] += advance
            out.append((got, h.state, h.placeable, h.probe_due(), h.next_probe_at,
                        h.probes, h.probe_failures, h.quarantines, h.snapshot()))
        return out

    on_both(scenario)


def test_health_guards_and_config_validation():
    for ns in (JAX, PORT):
        r = _res(ns)
        with pytest.raises(RuntimeError, match="begin_probe"):
            r.ReplicaHealth("d0").begin_probe()
        for kw, match in (({"degrade_after": 3, "quarantine_after": 2}, "quarantine_after"),
                          ({"hung_step_s": 0}, "hung_step_s"),
                          ({"probe_backoff_mult": 0.5}, "probe_backoff_mult"),
                          ({"retry_attempts": 0}, "retry_attempts"),
                          ({"max_recoveries": -1}, "max_recoveries")):
            with pytest.raises(ValueError, match=match):
                r.ResilienceConfig(**kw)
        with pytest.raises(ValueError, match="unknown resilience"):
            r.ResilienceConfig.from_dict({"hung_stp_s": 1})
        assert r.ResilienceConfig.from_dict({"hung_step_s": 2.5}).hung_step_s == 2.5
        pol = r.ResilienceConfig(retry_attempts=4, retry_backoff_s=0.5).retry_policy()
        assert (pol.attempts, pol.backoff_s) == (4, 0.5)
    assert _res(PORT).PROBATION == _res(JAX).PROBATION == "probation"


def test_configure_resets_the_backoff_outside_quarantine():
    def scenario(ns):
        r = _res(ns)
        clock = {"t": 0.0}
        h = r.ReplicaHealth("d0", clock=lambda: clock["t"])
        h.configure(r.ResilienceConfig(probe_backoff_s=2.0, probe_backoff_max_s=8.0))
        h.note_crash("x")
        first = h.next_probe_at
        h.configure(r.ResilienceConfig(probe_backoff_s=0.5))
        clock["t"] = first
        h.begin_probe()
        h.probe_failed("y")
        return first, h.next_probe_at, h.snapshot()

    first, after, _ = on_both(scenario)
    # a quarantined replica keeps its backoff through configure(): doubled to 4.0
    assert first == 2.0 and after == 2.0 + 4.0


# ---------------------------------------------------------------------------
# bounded retries (fake sleep)
# ---------------------------------------------------------------------------
# (failures before success, attempts, backoff_s, mult, max_backoff_s)
RETRY_CASES = [(0, 3, 0.1, 2.0, 30.0), (2, 3, 0.1, 2.0, 30.0), (3, 3, 0.1, 2.0, 30.0),
               (5, 6, 0.1, 10.0, 0.5), (1, 1, 0.0, 1.0, 30.0), (4, 5, 0.25, 1.5, 1.0)]


@pytest.mark.parametrize("case", RETRY_CASES, ids=[str(c) for c in RETRY_CASES])
def test_with_retries_table(case):
    """The result or the re-raised last error, the calls, the sleeps and
    the on_retry attempts are the JAX policy's."""
    fails, attempts, backoff, mult, cap = case

    def scenario(ns):
        r = _res(ns)
        calls, slept, seen = {"n": 0}, [], []

        def flaky():
            calls["n"] += 1
            if calls["n"] <= fails:
                raise RuntimeError(f"transient {calls['n']}")
            return "ok"

        pol = r.RetryPolicy(attempts=attempts, backoff_s=backoff, backoff_mult=mult,
                            max_backoff_s=cap)
        try:
            got = r.with_retries(flaky, pol, on_retry=lambda a, e: seen.append((a, str(e))),
                                 sleep=slept.append)
        except RuntimeError as e:
            got = f"raised {e}"
        return got, calls["n"], slept, seen, [pol.delay(i) for i in range(1, 5)]

    on_both(scenario)


def test_retry_policy_validation():
    for ns in (JAX, PORT):
        r = _res(ns)
        for kw in ({"attempts": 0}, {"backoff_mult": 0.5}, {"backoff_s": -1.0}):
            with pytest.raises(ValueError):
                r.RetryPolicy(**kw)


# ---------------------------------------------------------------------------
# recovery planning
# ---------------------------------------------------------------------------
# (prompt, generated, max_new, max_blocks_per_seq, pool readable, decode-ready)
RECOVERY_CASES = {
    "complete": ([1, 2], [3, 4], 2, 16, False, False),
    "replay": ([1, 2], [3], 4, 16, False, False),
    "over_ceiling": ([1, 2, 3, 4], [5], 8, 2, False, False),
    "fresh": ([7, 8, 9], [], 5, 16, False, False),
    "checkpoint": ([1, 2, 3, 4, 5], [6], 6, 16, True, True),
    "readable_unseated": ([1, 2, 3], [4], 6, 16, True, False),
}


@pytest.mark.parametrize("name", sorted(RECOVERY_CASES))
def test_plan_recovery_table(name):
    """``plan_recovery``'s route and argument (the replay prompt, the
    failure reason, or the checkpoint's history and cursor) for each case;
    ``replay_prompt`` is the prompt plus the delivered tokens."""
    prompt, generated, max_new, mbps, readable, seated = RECOVERY_CASES[name]

    def scenario(ns):
        r = _res(ns)
        eng = FakeEngine(ns, max_blocks_per_seq=mbps)
        core = SimpleNamespace(engine=eng, name="d0")
        req = SimpleNamespace(uid=5, is_terminal=False,
                              prompt_tokens=np.asarray(prompt, np.int32),
                              generated=list(generated), params=sp(ns, max_new))
        if seated:  # a steady decode row: prefilled, its first token fed back
            eng.scheduler.submit(5, req.prompt_tokens)
            tok = eng.step_tokens()[5]
            eng.scheduler.feedback(5, tok)
        route, arg = r.plan_recovery(core, req, pool_readable=readable)
        if route == "checkpoint":
            arg = (arg.tokens, arg.seen_tokens, arg.pending_token, arg.n_blocks)
        elif route == "replay":
            arg = (arg.dtype.name, arg.tolist())
        elif route == "fail":
            arg = arg.split(":")[0]
        return route, arg, r.replay_prompt(req).tolist()

    route, _, replay = on_both(scenario)
    assert replay == prompt + generated
    assert route == {"complete": "fail", "over_ceiling": "fail",
                     "checkpoint": "checkpoint"}.get(name, "replay")


# ---------------------------------------------------------------------------
# router chaos on the fake engine
# ---------------------------------------------------------------------------
def _resilience_block(h):
    keep = ("enabled", "placeable_replicas", "quarantines", "recoveries")
    return {k: h["resilience"][k] for k in keep}


class TestRouterRecovery:
    def test_engine_step_failure_replays_bit_identically(self):
        """A failed step leaves the pool unknowable: residents recover by
        replay, and the continuation is the fault-free stream."""

        def scenario(ns):
            engines = [FakeEngine(ns, step_delay=0.002) for _ in range(2)]
            router = _res(ns).Router(engines=engines, num_prefill_workers=0,
                                     resilience=fast_cfg(ns)).start()
            try:
                prompts = [np.arange(1 + 10 * i, 5 + 10 * i, dtype=np.int32) for i in range(4)]
                reqs = [router.submit(p, params=sp(ns, 24)) for p in prompts]
                for r in reqs:
                    r.stream.get(timeout=WAIT_S)
                engines[0].fail_next = 1
                for r in reqs:
                    assert r.wait(WAIT_S)
                res = router.health()["resilience"]
            finally:
                router.shutdown()
            return ([r.generated for r in reqs], res["replica_failures"] >= 1,
                    res["recovery_replays"] >= 1, max(r.recoveries for r in reqs) <= 1,
                    [e.state_manager.free_blocks for e in engines])

        got = on_both(scenario)
        assert got[0] == [expected_tokens(np.arange(1 + 10 * i, 5 + 10 * i), 24)
                          for i in range(4)]
        assert got[1:] == (True, True, True, [256, 256])

    def test_worker_crash_recovers_by_checkpoint_and_surfaces_error(self):
        def scenario(ns):
            r = _res(ns)
            engines = [FakeEngine(ns, step_delay=0.002) for _ in range(2)]
            with r.inject(r.FaultSpec("worker.crash", nth=8, replica="d0")):
                router = r.Router(engines=engines, num_prefill_workers=0,
                                  resilience=fast_cfg(ns, probe_backoff_s=60)).start()
                try:
                    prompts = [np.arange(1 + 10 * i, 5 + 10 * i, dtype=np.int32)
                               for i in range(4)]
                    reqs = run_all(ns, router, prompts, 30)
                    h = router.health()
                finally:
                    router.shutdown()
            d0 = h["replicas"]["d0"]["health"]
            return ([q.generated for q in reqs], h["resilience"]["quarantines"],
                    h["resilience"]["recovery_checkpoints"] >= 1, d0["state"],
                    "worker crash" in d0["last_error"], "InjectedFault" in d0["last_error"])

        got = on_both(scenario)
        assert got[1:] == (1, True, "quarantined", True, True)

    def test_quarantined_replica_takes_no_placements_until_probe(self):
        """While d0 is quarantined every new request lands on d1, even under
        round-robin; only a passed probe restores its placements."""

        def scenario(ns):
            r = _res(ns)
            engines = [FakeEngine(ns, step_delay=0.001) for _ in range(2)]
            with r.inject(r.FaultSpec("worker.crash", nth=4, replica="d0")):
                router = r.Router(engines=engines, num_prefill_workers=0,
                                  placement="round_robin",
                                  resilience=fast_cfg(ns, probe_backoff_s=0.2)).start()
                try:
                    first = run_all(ns, router, [np.asarray([5], np.int32)], 12)[0]
                    deadline = time.monotonic() + WAIT_S
                    while router.health()["replicas"]["d0"]["health"]["state"] != "quarantined":
                        assert time.monotonic() < deadline, "d0 never quarantined"
                        time.sleep(0.005)
                    before = router.health()["replicas"]
                    reqs = run_all(ns, router, [np.asarray([100 + i], np.int32)
                                                for i in range(4)], 4)
                    after = router.health()["replicas"]
                    deadline = time.monotonic() + WAIT_S
                    while router.health()["resilience"]["placeable_replicas"] < 2:
                        assert time.monotonic() < deadline, "probe never passed"
                        time.sleep(0.01)
                    run_all(ns, router, [np.asarray([200 + i], np.int32) for i in range(4)], 4)
                    final = router.health()
                finally:
                    router.shutdown()
            fin = lambda snap, n: snap[n]["requests_finished_total"]  # noqa: E731
            return (first.generated, [q.generated for q in reqs],
                    fin(after, "d0") - fin(before, "d0"), fin(after, "d1") - fin(before, "d1"),
                    fin(final["replicas"], "d0") - fin(after, "d0") >= 1,
                    final["resilience"]["probes"] >= 1)

        got = on_both(scenario)
        assert got[0] == expected_tokens([5], 12) and got[2:] == (0, 4, True, True)

    def test_step_hang_watchdog_quarantines_and_replays(self):
        def scenario(ns):
            r = _res(ns)
            engines = [FakeEngine(ns, step_delay=0.002) for _ in range(2)]
            cfg = fast_cfg(ns, hung_step_s=0.15, probe_backoff_s=60)
            # the hang outlasts the deadline by far: the watchdog runs on the
            # coordinator, which a loaded machine may schedule late
            with r.inject(r.FaultSpec("step.hang", nth=6, replica="d1", hang_s=2.0)) as inj:
                router = r.Router(engines=engines, num_prefill_workers=0, resilience=cfg).start()
                try:
                    prompts = [np.arange(1 + 10 * i, 5 + 10 * i, dtype=np.int32)
                               for i in range(4)]
                    reqs = run_all(ns, router, prompts, 30)
                    res = router.health()["resilience"]
                finally:
                    router.shutdown()
            return ([q.generated for q in reqs],
                    any(f["site"] == "step.hang" for f in inj.fired()),
                    res["quarantines"] >= 1, res["recovery_replays"] >= 1)

        assert on_both(scenario)[1:] == (True, True, True)

    def test_watchdog_sees_a_hang_while_the_coordinator_sleeps(self):
        """One request, its replica's third step wedged and no other
        replica stepping: the coordinator wakes within one deadline (its
        wait is bounded by it), quarantines the replica and replays the
        stream on the other before the wedged step returns."""
        r = _res(PORT)
        engines = [FakeEngine(PORT, step_delay=0.002) for _ in range(2)]
        with r.inject(r.FaultSpec("step.hang", nth=3, hang_s=1.5)):
            router = r.Router(engines=engines, num_prefill_workers=0,
                              resilience=fast_cfg(PORT, hung_step_s=0.2,
                                                  probe_backoff_s=60)).start()
            try:
                t0 = time.monotonic()
                (q,) = run_all(PORT, router, [np.asarray([5], np.int32)], 12)
                took = time.monotonic() - t0
                res = router.health()["resilience"]
            finally:
                router.shutdown()
        assert q.generated == expected_tokens([5], 12) and q.recoveries == 1
        assert res["quarantines"] == 1 and res["recovery_replays"] == 1
        assert took < 1.5  # replayed before the wedged step returned

    def test_handoff_import_fault_retries_transparently(self):
        def scenario(ns):
            r = _res(ns)
            engines = [FakeEngine(ns, step_delay=0.001) for _ in range(3)]
            with r.inject(r.FaultSpec("handoff.import", nth=2)):
                router = r.Router(engines=engines, num_prefill_workers=1,
                                  resilience=fast_cfg(ns)).start()
                try:
                    prompts = [np.arange(1 + 10 * i, 7 + 10 * i, dtype=np.int32)
                               for i in range(5)]
                    reqs = run_all(ns, router, prompts, 12)
                    res = router.health()["resilience"]
                finally:
                    router.shutdown()
            return ([q.generated for q in reqs], res["handoff_retries"] >= 1,
                    res["replica_failures"], [e.state_manager.free_blocks for e in engines])

        got = on_both(scenario)
        assert got[0] == [expected_tokens(np.arange(1 + 10 * i, 7 + 10 * i), 12)
                          for i in range(5)]
        assert got[1:] == (True, 0, [256] * 3)

    def test_handoff_export_fault_recovers_resident(self):
        def scenario(ns):
            r = _res(ns)
            engines = [FakeEngine(ns, step_delay=0.001) for _ in range(2)]
            specs = [r.FaultSpec("handoff.export", nth=n) for n in (1, 2, 3)]
            with r.inject(*specs):
                router = r.Router(engines=engines, num_prefill_workers=1,
                                  resilience=fast_cfg(ns)).start()
                try:
                    (q,) = run_all(ns, router, [np.arange(1, 7, dtype=np.int32)], 12)
                    res = router.health()["resilience"]
                finally:
                    router.shutdown()
            return (q.generated, q.recoveries, res["recoveries"] >= 1,
                    res["handoff_retries"] >= 2, [e.state_manager.free_blocks for e in engines])

        got = on_both(scenario)
        assert got == (expected_tokens(np.arange(1, 7), 12), 1, True, True, [256, 256])

    def test_recovery_budget_exhausted_fails_request(self):
        def scenario(ns):
            engines = [FakeEngine(ns, step_delay=0.002) for _ in range(2)]
            router = _res(ns).Router(engines=engines, num_prefill_workers=0,
                                     resilience=fast_cfg(ns, max_recoveries=0)).start()
            try:
                q = router.submit(np.asarray([5], np.int32), params=sp(ns, 24))
                q.stream.get(timeout=WAIT_S)
                next(e for e in engines if e.state_manager.n_tracked_sequences).fail_next = 1
                assert q.wait(WAIT_S)
            finally:
                router.shutdown()
            return q.state, "recovery budget" in q.error

        assert on_both(scenario) == ("failed", True)

    def test_legacy_mode_unchanged_but_health_tracked(self):
        def scenario(ns):
            engines = [FakeEngine(ns, step_delay=0.002) for _ in range(2)]
            router = _res(ns).Router(engines=engines, num_prefill_workers=0).start()
            try:
                q = router.submit(np.asarray([5], np.int32), params=sp(ns, 24))
                q.stream.get(timeout=WAIT_S)
                next(e for e in engines if e.state_manager.n_tracked_sequences).fail_next = 1
                assert q.wait(WAIT_S)
                h = router.health()
            finally:
                router.shutdown()
            failed = [st["health"]["last_error"] for st in h["replicas"].values()
                      if st["health"]["last_error"]]
            return q.state, _resilience_block(h), failed

        state, block, failed = on_both(scenario)
        assert state == "failed" and block["enabled"] is False and block["recoveries"] == 0
        assert block["placeable_replicas"] == 2 and "injected engine failure" in failed[0]

    def test_seeded_schedule_acceptance_scenario(self):
        """A replica kill mid-stream with a seeded faulted handoff import:
        every request completes byte-identical, pools conserved."""

        def scenario(ns):
            r = _res(ns)
            schedule = [r.FaultSpec("worker.crash", nth=10, replica="d0")]
            schedule += list(r.seeded_schedule(7, {"handoff.import": 1}))
            engines = [FakeEngine(ns, step_delay=0.001) for _ in range(2)]
            with r.inject(*schedule) as inj:
                router = r.Router(engines=engines, num_prefill_workers=0,
                                  resilience=fast_cfg(ns)).start()
                try:
                    prompts = [np.arange(1 + 10 * i, 6 + 10 * i, dtype=np.int32)
                               for i in range(6)]
                    reqs = run_all(ns, router, prompts, 20)
                    res = router.health()["resilience"]
                finally:
                    router.shutdown()
            return ([q.generated for q in reqs], res["recoveries"] >= 1, res["quarantines"] >= 1,
                    "worker.crash" in {f["site"] for f in inj.fired()},
                    [(s.site, s.nth, s.replica) for s in schedule],
                    [e.state_manager.free_blocks for e in engines])

        got = on_both(scenario)
        assert got[0] == [expected_tokens(np.arange(1 + 10 * i, 6 + 10 * i), 20)
                          for i in range(6)]
        assert got[1:4] == (True, True, True) and got[5] == [256, 256]

    def test_scaling_signals_exclude_quarantined(self):
        def scenario(ns):
            r = _res(ns)
            engines = [FakeEngine(ns, step_delay=0.001) for _ in range(2)]
            with r.inject(r.FaultSpec("worker.crash", nth=4, replica="d0")):
                router = r.Router(engines=engines, num_prefill_workers=0,
                                  resilience=fast_cfg(ns, probe_backoff_s=60)).start()
                try:
                    run_all(ns, router, [np.asarray([5], np.int32)], 12)
                    deadline = time.monotonic() + WAIT_S
                    while router.health()["replicas"]["d0"]["health"]["state"] != "quarantined":
                        assert time.monotonic() < deadline
                        time.sleep(0.005)
                    sig = router.scaling_signals()
                finally:
                    router.shutdown()
            return sig.n_decode, sig.n_quarantined

        assert on_both(scenario) == (1, 1)


# ---------------------------------------------------------------------------
# real engines: a crashed decode replica's streams equal the fault-free pass's
# ---------------------------------------------------------------------------
class TestRecoveryRealEngine:
    @pytest.mark.parametrize("transport", ["host", "device"])
    def test_worker_crash_streams_equal_the_fault_free_pass(self, transport):
        """One prefill worker and two decode replicas on the tiny model: d1's
        worker dies outside the step after its first handoff lands; its
        residents recover by checkpoint onto d0 (exact KV), every stream
        equals the fault-free pass's token for token, /health counts the
        recovery, and every pool is free afterwards."""
        from tests import test_torch_spec_decode as sd
        from tests.test_torch_serving import real_prompts

        r = _res(PORT)
        ps = real_prompts()

        def serve(faults):
            engines = [sd.port_engine() for _ in range(3)]
            with r.inject(*faults):
                router = r.Router(engines=engines, num_prefill_workers=1,
                                  kv_transport=transport,
                                  resilience=fast_cfg(PORT, probe_backoff_s=60)).start()
                try:
                    reqs = run_all(PORT, router, ps, 8)
                    h = router.health()
                finally:
                    router.shutdown()
            assert all(e.state_manager.free_blocks == e.config.kv_cache.num_blocks
                       for e in engines)
            return [q.generated for q in reqs], [q.state for q in reqs], h

        want, _, _ = serve([])
        got, states, h = serve([r.FaultSpec("worker.crash", nth=1, replica="d1")])
        assert states == ["finished"] * len(ps) and got == want
        res = h["resilience"]
        assert res["replica_failures"] == 1 and res["recoveries"] >= 1
        assert res["recovery_checkpoints"] >= 1
        assert "worker crash" in h["replicas"]["d1"]["health"]["last_error"]


# ---------------------------------------------------------------------------
# dstpu serve --resilience
# ---------------------------------------------------------------------------
def test_resilience_flag_builds_fault_tolerant_router():
    """``--resilience --hung-step-s 2.5 --max-recoveries 1`` build the
    Router with a ResilienceConfig carrying both (also for one decode
    replica), as the JAX command does."""
    from deepspeed_tpu_torch.inference import cli as pcli
    from deepspeed_tpu_torch.serving import Router
    from tests import test_torch_spec_decode as sd
    from tests.test_torch_router import SERVE_ARGV

    base = sd.port_engine()
    args = pcli.serve_parse_args(SERVE_ARGV + ["--resilience", "--hung-step-s", "2.5",
                                               "--max-recoveries", "1"])
    front, _ = pcli.build_serving_stack(args, cfg=base._mc, params=base.params,
                                        tok=SimpleNamespace(eos_token_id=None))
    assert isinstance(front, Router)
    cfg = front._resilience
    assert (cfg.hung_step_s, cfg.max_recoveries) == (2.5, 1)
    h = front.health()
    assert h["resilience"]["enabled"] is True and set(h["replicas"]) == {"d0"}
    assert all(c.health.cfg is cfg for c in front.cores)
