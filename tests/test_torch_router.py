"""The port's multi-engine Router against the JAX package's, on the CPU.

Mirrors ``tests/unit/test_disagg.py`` and ``tests/unit/test_kv_transport.py``
(their tensor-parallel classes are ROADMAP queue 1, item 6; the remote wire
is held in ``tests/test_torch_net_transport.py`` and
``tests/test_torch_multihost.py``). The fake-engine tests run one scenario through both packages, each over
its own real scheduler, allocator and state manager under ``FakeEngine``
(``tests/test_torch_serving.py``: compute-free, the next token is the last
one + 1), and hold the port to the JAX package's observable results: token
streams, placements, handoff and refcount tallies, freed blocks. The
real-engine tests serve the tiny model of ``tests/test_torch_spec_decode.py``
(2 layers, h 128, fp32) on identical weights: one prefill worker and two
decode replicas over the ``host``, ``in_process`` and ``device`` wires
stream the JAX Router's greedy tokens and the single-engine driver's, token
for token. Seeded streams are held to the port's own driver: the port draws
from a counter hash of (seed, uid, position), not JAX's PRNG, so seeded
parity with JAX holds for greedy only (ROADMAP §1, item 4).
"""

import importlib
import threading
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


def _cluster(ns) -> SimpleNamespace:
    """One package's cluster surface, by the same names in both."""
    m = lambda name: importlib.import_module(f"{ns.root}.{name}")  # noqa: E731
    handoff = m("serving.cluster.handoff")
    return SimpleNamespace(
        Router=m("serving.cluster.router").Router, EngineCore=m("serving.cluster.core").EngineCore,
        handoff=handoff, placement=m("serving.cluster.placement"),
        PrefixDirectory=m("serving.cluster.prefix_directory").PrefixDirectory,
        KVCacheConfig=ns.KVCacheConfig,
    )


def sp(ns, n, **kw):
    return ns.SamplingParams(max_new_tokens=n, ignore_eos=True, **kw)


def run_all(ns, front, prompts, n_new, timeout=WAIT_S, **submit_kw):
    reqs = [front.submit(p, params=sp(ns, n_new), **submit_kw) for p in prompts]
    for r in reqs:
        assert r.wait(timeout), f"request {r.uid} did not finish ({r.state})"
    return reqs


def wait_idle(router, timeout=WAIT_S):
    """In-flight work cleared WITHOUT drain() (drain is terminal)."""
    deadline = time.monotonic() + timeout
    while router.num_active or router.queue_depth:
        assert time.monotonic() < deadline, "router did not go idle"
        time.sleep(0.002)


def cached_fake(ns, prefix_blocks=64, **kw):
    """FakeEngine with the prefix cache on (the trie rides the real state
    manager, so handoff prefix replication runs for real)."""
    eng = FakeEngine(ns, **kw)
    kv = ns.KVCacheConfig(block_size=eng.config.kv_cache.block_size,
                          num_blocks=eng.config.kv_cache.num_blocks,
                          max_blocks_per_seq=eng.config.kv_cache.max_blocks_per_seq,
                          prefix_cache=True, prefix_cache_blocks=prefix_blocks)
    sm = eng.config.state_manager
    eng.config = SimpleNamespace(kv_cache=kv, state_manager=sm)
    eng.state_manager = ns.DSStateManager(sm, kv)
    eng.scheduler = ns.RaggedScheduler(sm, eng.state_manager)
    return eng


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
class TestPlacement:
    def test_one_full_one_empty_admits_to_empty(self):
        """One replica's pool exhausted, the other empty: admission consults
        per-replica free blocks through the placement policy and lands on
        the empty replica at once."""

        def scenario(ns):
            c = _cluster(ns)
            engines = [FakeEngine(ns, block_size=4, num_blocks=8, max_blocks_per_seq=8,
                                  max_context=64, step_delay=0.004) for _ in range(2)]
            router = c.Router(engines=engines, num_prefill_workers=0).start()
            try:
                a = router.submit(np.arange(1, 9, dtype=np.int32), params=sp(ns, 24))
                a.stream.get(timeout=WAIT_S)
                full = next(e for e in engines if e.state_manager.n_tracked_sequences)
                empty = engines[1 - engines.index(full)]
                b = router.submit(np.arange(1, 9, dtype=np.int32), params=sp(ns, 24))
                b.stream.get(timeout=WAIT_S)
                assert not a.is_terminal, "B should admit while A still runs"
                assert empty.state_manager.n_tracked_sequences == 1
                assert a.wait(WAIT_S) and b.wait(WAIT_S)
                finished = sorted(r["requests_finished_total"]
                                  for r in router.health()["replicas"].values())
            finally:
                router.shutdown()
            return a.generated, b.generated, finished, [e.state_manager.free_blocks
                                                        for e in engines]

        a, b, finished, free = on_both(scenario)
        assert a == b == expected_tokens(np.arange(1, 9), 24)
        assert finished == [1, 1] and free == [8, 8]

    def test_unknown_placement_rejected(self):
        for ns in (JAX, PORT):
            with pytest.raises(ValueError, match="unknown placement"):
                _cluster(ns).Router(engines=[FakeEngine(ns)], placement="nope")

    def test_round_robin_spreads_load(self):
        def scenario(ns):
            engines = [FakeEngine(ns) for _ in range(3)]
            router = _cluster(ns).Router(engines=engines, placement="round_robin").start()
            try:
                reqs = run_all(ns, router, [np.asarray([10 * (i + 1)], np.int32)
                                            for i in range(6)], 4)
                assert router.drain(WAIT_S)
            finally:
                router.shutdown()
            return [r.generated for r in reqs], [e.steps > 0 for e in engines]

        _, stepped = on_both(scenario)
        assert stepped == [True] * 3

    @pytest.mark.parametrize("policy", ["slo", "round_robin", "least_loaded"])
    def test_policy_choices_table(self, policy):
        """Each policy's pick over replicas of different load and free
        blocks, request by request (with deadlines and reservations), is
        the JAX policy's."""

        def scenario(ns):
            c = _cluster(ns)
            cores = []
            for i, (n_live, resident) in enumerate([(5, 1), (0, 0), (2, 3)]):
                eng = FakeEngine(ns, block_size=4, num_blocks=32, max_blocks_per_seq=8,
                                 max_context=32, max_tracked=8)
                core = c.EngineCore(eng, name=f"d{i}", role="decode")
                for u in range(n_live):  # live sequences holding blocks
                    seq = eng.state_manager.get_or_create_sequence(100 + u)
                    eng.state_manager.extend(seq, 4 * (1 + u % 2))
                core.requests.update({200 + k: ns.Request(
                    uid=200 + k, prompt_tokens=np.arange(1, 6, dtype=np.int32),
                    params=sp(ns, 3)) for k in range(resident)})
                cores.append(core)
            reserved = {"d0": [0, 0], "d1": [6, 1], "d2": [0, 2]}
            router = SimpleNamespace(
                directory=None,
                reserved_for_locked=lambda core: tuple(reserved[core.name]))
            pol = c.placement.get_placement(policy)
            picks = []
            for i, (plen, n_new, slack) in enumerate([(4, 8, None), (12, 12, 0.01),
                                                      (3, 1, 5.0), (20, 4, None),
                                                      (8, 24, None), (2, 2, 0.0)]):
                req = ns.Request(uid=i, prompt_tokens=np.arange(1, plen + 1, dtype=np.int32),
                                 params=sp(ns, n_new))
                req.deadline = None if slack is None else time.monotonic() + slack
                got = pol.choose(cores, req, router)
                picks.append(None if got is None else got.name)
            return picks

        picks = on_both(scenario)
        assert any(p is not None for p in picks)


# ---------------------------------------------------------------------------
# disaggregated prefill/decode on the fake engine
# ---------------------------------------------------------------------------
class TestDisaggFake:
    def test_handoff_parity_and_drain(self):
        """1 prefill worker + 2 decode replicas stream exactly what the
        single-engine driver streams, every request's KV hands off, and a
        drain leaves every pool free."""
        prompts = [np.arange(1 + 10 * i, 7 + 10 * i, dtype=np.int32) for i in range(6)]

        def scenario(ns):
            single = ns.ServingDriver(FakeEngine(ns)).start()
            want = [list(r.generated) for r in run_all(ns, single, prompts, 12)]
            single.shutdown()
            engines = [FakeEngine(ns, step_delay=0.001) for _ in range(3)]
            router = _cluster(ns).Router(engines=engines, num_prefill_workers=1).start()
            try:
                streamed, threads, reqs = {}, [], []
                for p in prompts:
                    r = router.submit(p, params=sp(ns, 12))
                    t = threading.Thread(target=lambda r=r: streamed.__setitem__(
                        r.uid, list(r.stream)))
                    t.start()
                    reqs.append(r)
                    threads.append(t)
                for r in reqs:
                    assert r.wait(WAIT_S)
                for t in threads:
                    t.join(WAIT_S)
                got = [list(r.generated) for r in reqs]
                assert got == want and [streamed[r.uid] for r in reqs] == want
                h = router.health()
                tallies = (h["num_prefill_workers"], h["num_decode_replicas"], h["kv_handoffs"],
                           h["replicas"]["p0"]["handoffs_out_total"],
                           sum(h["replicas"][d]["handoffs_in_total"] for d in ("d0", "d1")),
                           h["replicas"]["p0"]["requests_finished_total"])
                assert router.drain(WAIT_S)
            finally:
                router.shutdown()
            free = [e.state_manager.free_blocks == e.config.kv_cache.num_blocks
                    and not e.scheduler.has_work() for e in engines]
            return got, tallies, free

        got, tallies, free = on_both(scenario)
        assert got == [expected_tokens(p, 12) for p in prompts]
        assert tallies == (1, 2, 6, 6, 6, 0) and free == [True] * 3

    def test_first_token_stop_never_hands_off(self):
        def scenario(ns):
            engines = [FakeEngine(ns) for _ in range(2)]
            router = _cluster(ns).Router(engines=engines, num_prefill_workers=1,
                                         eos_token_id=11).start()
            try:
                r = router.submit(np.asarray([10], np.int32),
                                  params=ns.SamplingParams(max_new_tokens=50))
                assert r.wait(WAIT_S)
                handoffs = router.health()["kv_handoffs"]
            finally:
                router.shutdown()
            return r.finish_reason, r.generated, handoffs, engines[1].steps

        assert on_both(scenario) == ("eos", [11], 0, 0)

    def test_cancel_and_timeout_on_router(self):
        def scenario(ns):
            engines = [FakeEngine(ns, step_delay=0.004) for _ in range(3)]
            router = _cluster(ns).Router(engines=engines, num_prefill_workers=1).start()
            try:
                r = router.submit(np.asarray([1, 2, 3], np.int32), params=sp(ns, 10000))
                first = r.stream.get(timeout=WAIT_S)
                cancelled = router.cancel(r.uid)
                assert r.wait(WAIT_S)
                unknown = router.cancel(424242)
                t = router.submit(np.asarray([5], np.int32), params=sp(ns, 10000),
                                  timeout_s=0.1)
                assert t.wait(WAIT_S)
            finally:
                router.shutdown()
            return (first, cancelled, r.state, unknown, t.state,
                    [e.state_manager.free_blocks == e.config.kv_cache.num_blocks
                     for e in engines])

        assert on_both(scenario) == (4, True, "cancelled", False, "timed_out", [True] * 3)

    def test_decode_engine_failure_isolated(self):
        def scenario(ns):
            engines = [FakeEngine(ns) for _ in range(2)]
            router = _cluster(ns).Router(engines=engines, num_prefill_workers=0).start()
            try:
                engines[0].fail_next = engines[1].fail_next = 1
                r1 = router.submit(np.asarray([1, 2], np.int32), params=sp(ns, 4))
                assert r1.wait(WAIT_S)
                r2 = router.submit(np.asarray([1, 2], np.int32), params=sp(ns, 4))
                assert r2.wait(WAIT_S)
            finally:
                router.shutdown()
            return r1.state, r2.state, r2.generated, [e.state_manager.free_blocks
                                                      for e in engines]

        assert on_both(scenario) == ("failed", "finished", [3, 4, 5, 6], [256, 256])

    def test_submit_rejections(self):
        def scenario(ns):
            engines = [FakeEngine(ns, block_size=4, num_blocks=8, max_blocks_per_seq=2,
                                  max_context=16) for _ in range(2)]
            router = _cluster(ns).Router(engines=engines, num_prefill_workers=1, max_queue=1)
            reasons = []
            for prompt in (np.asarray([], np.int32), np.arange(20, dtype=np.int32),
                           np.arange(15, dtype=np.int32)):
                with pytest.raises(ns.RequestRejected) as ei:
                    router.submit(prompt)
                reasons.append(ei.value.reason)
            router.submit(np.asarray([1], np.int32))
            with pytest.raises(ns.RequestRejected) as ei:
                router.submit(np.asarray([1], np.int32))
            return reasons + [ei.value.reason]

        assert on_both(scenario) == ["empty_prompt", "max_context", "inadmissible",
                                     "queue_full"]


    def test_handoff_queue_under_thread_stress(self):
        """The port's decode replicas import their own handoffs (the prefill
        workers queue them): with more worker threads than cores and a
        shortened switch interval, 60 requests over 2 prefill workers and 9
        decode replicas each stream exactly, every handoff lands once and
        every pool is free after."""
        import sys

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            engines = [FakeEngine(PORT, block_size=4, num_blocks=64) for _ in range(11)]
            router = _cluster(PORT).Router(engines=engines, num_prefill_workers=2).start()
            try:
                prompts = [np.arange(1 + 7 * i, 6 + 7 * i + i % 5, dtype=np.int32)
                           for i in range(60)]
                reqs = run_all(PORT, router, prompts, 6)
                h = router.health()
                threads = list(router._threads)
            finally:
                router.shutdown()
        finally:
            sys.setswitchinterval(old)
        assert [r.generated for r in reqs] == [expected_tokens(p, 6) for p in prompts]
        assert h["kv_handoffs"] == 60 and not router._handoff_in
        assert sum(h["replicas"][f"d{i}"]["handoffs_in_total"] for i in range(9)) == 60
        assert all(e.state_manager.free_blocks == 64 for e in engines)
        assert len(threads) == 12 and not any(t.is_alive() for t in threads)


# ---------------------------------------------------------------------------
# handoff bookkeeping: prefix replication, refcounts, unwinding, the seam
# ---------------------------------------------------------------------------
class TestHandoffInvariants:
    def test_prefix_replication_and_refcounts(self):
        """A cached-prefix request's imported blocks register in the target
        replica's trie; a second request with the same prompt skips the
        covered copy; free + live + cached-only blocks stay conserved on
        both engines; clearing the tries returns every block."""
        prompt = np.arange(1, 18, dtype=np.int32)  # 17 tokens, bs 4 -> 4 full blocks

        def scenario(ns):
            engines = [cached_fake(ns, block_size=4, num_blocks=64, max_blocks_per_seq=16,
                                   step_delay=0.001) for _ in range(2)]
            router = _cluster(ns).Router(engines=engines, num_prefill_workers=1).start()
            out = []
            try:
                for _ in range(2):
                    r = run_all(ns, router, [prompt], 8)[0]
                    wait_idle(router)
                    snap = router.metrics.snapshot()
                    acct = [e.state_manager.kv_block_accounting() for e in engines]
                    assert all(a["free"] + a["live"] + a["cached_only"] == a["total"]
                               for a in acct)
                    out.append((r.generated, snap["kv_handoffs_total"],
                                snap["kv_handoff_blocks_total"],
                                snap["kv_handoff_blocks_copied_total"],
                                engines[1].state_manager.prefix_cache.stats()["cached_blocks"],
                                [a["live"] for a in acct]))
            finally:
                router.shutdown()
            for e in engines:
                e.state_manager.prefix_cache.clear()
            return out, [e.state_manager.free_blocks for e in engines]

        (first, second), free = on_both(scenario)
        assert first[0] == second[0] == expected_tokens(prompt, 8)
        assert first[1:3] == (1, first[2]) and first[2] >= 4 and first[4] >= 4
        assert second[1] == 2
        # the second import seeds the matchable (17 - 1) // 4 = 4 blocks
        assert second[3] - first[3] <= (second[2] - first[2]) - 4
        assert free == [64, 64]

    def test_import_failure_unwinds_target(self):
        def scenario(ns):
            h = _cluster(ns).handoff
            tgt = FakeEngine(ns, block_size=4, num_blocks=4, max_blocks_per_seq=16)
            ho = h.KVHandoff(uid=0, tokens=list(range(40)), seen_tokens=40, pending_token=99,
                             n_blocks=10, payload=None)
            with pytest.raises(h.HandoffError, match="pool exhausted"):
                h.import_sequence(tgt, ho)
            return tgt.state_manager.free_blocks, tgt.state_manager.get_sequence(0)

        assert on_both(scenario) == (4, None)

    def test_adopt_requires_materialized_state(self):
        for ns in (JAX, PORT):
            eng = FakeEngine(ns)
            with pytest.raises(ValueError, match="no live sequence"):
                eng.scheduler.adopt(7, 1)
            seq = eng.state_manager.get_or_create_sequence(7)
            seq.tokens, seq.seen_tokens = [1, 2, 3], 1
            with pytest.raises(ValueError, match="mismatch"):
                eng.scheduler.adopt(7, 1)

    def test_transport_registry_and_remote_refused(self):
        """The same names resolve in both packages, the cross-process wire
        too (registered on first use); a typo fails at configuration time;
        a Router asked for the remote wire builds on it in both."""
        jh, ph = _cluster(JAX).handoff, _cluster(PORT).handoff
        assert ph.KV_TRANSPORTS == jh.KV_TRANSPORTS
        for name in ("host", "in_process", "device", "remote"):
            tr = ph.get_transport(name)
            assert tr.name == name == jh.get_transport(name).name
            assert ph.get_transport(tr) is tr and ph.get_transport(name) is tr
            assert type(tr).__name__ == type(jh.get_transport(name)).__name__
        for h in (jh, ph):
            with pytest.raises(ValueError, match="kv_transport='warp'"):
                h.get_transport("warp")

        def scenario(ns):
            router = _cluster(ns).Router(engines=[FakeEngine(ns)], kv_transport="remote")
            try:
                return router._kv_transport.name, router.health()["kv_transport"]["endpoints"]
            finally:
                router.shutdown()

        assert on_both(scenario) == ("remote", {})

    @pytest.mark.parametrize("transport", ["host", "in_process", "device"])
    def test_fake_engines_ride_every_transport(self, transport):
        """Engines without device pools hand off with payload None over any
        transport: the table and history bookkeeping is identical."""

        def scenario(ns):
            h = _cluster(ns).handoff
            src, tgt = FakeEngine(ns), FakeEngine(ns)
            src.scheduler.submit(3, np.arange(1, 9, dtype=np.int32))
            tok = src.step_tokens()[3]
            ho = h.export_sequence(src, 3, int(tok), transport=transport)
            src.scheduler.finish(3)
            copied = h.import_sequence(tgt, ho)
            got = (ho.transport, ho.payload, ho.nbytes, ho.tokens, ho.seen_tokens, copied,
                   tgt.scheduler.peek_next_token(3))
            tgt.scheduler.finish(3)
            return got

        assert on_both(scenario) == (transport, None, 0, list(range(1, 9)), 8, 2, 9)

    def test_control_plane_names_item_5(self):
        """The multi-host control plane is served: ``serve_control`` binds
        once (idempotent) and /health reports it; before an agent joins
        there is no remote replica and no KV endpoint, in both packages."""

        def scenario(ns):
            router = _cluster(ns).Router(engines=[FakeEngine(ns)])
            before = router.health()["control_plane"]
            try:
                addr = router.serve_control("127.0.0.1", 0)
                h = router.health()
                return (before, router.serve_control() == addr, addr[1] > 0,
                        h["control_plane"]["enabled"], h["control_plane"]["address"] == list(addr),
                        h["control_plane"]["remote_replicas"], h["kv_transport"]["endpoints"])
            finally:
                router.shutdown()

        assert on_both(scenario) == ({"enabled": False, "address": None, "remote_replicas": {}},
                                     True, True, True, True, {}, {})


# ---------------------------------------------------------------------------
# the prefix directory
# ---------------------------------------------------------------------------
class TestPrefixDirectory:
    def test_directory_table(self):
        """Advertisements, coverage, the best peer and the stats over a
        table of replicas and chains: the JAX directory's answers."""

        def scenario(ns):
            d = _cluster(ns).PrefixDirectory()
            keys = [bytes([i]) * 4 for i in range(6)]
            d.advertise("d0", set(keys[:2]))
            d.advertise("d1", set(keys[:5]))
            d.advertise("d2", {keys[0], keys[2], keys[3]})
            out = [d.coverage(n, keys) for n in ("d0", "d1", "d2", "d9")]
            for exclude, min_extra in (("d0", 3), ("d1", 1), ("d0", 6), (None, 1)):
                out.append(d.best_peer(keys, exclude=exclude, min_extra=min_extra))
            d.advertise("d1", set())
            out.append(d.best_peer(keys, exclude="d0", min_extra=3))
            d.forget("d2")
            out.append(d.stats())
            return out

        out = on_both(scenario)
        assert out[:4] == [2, 5, 1, 0] and out[4] == ("d1", 5)

    def test_router_pulls_a_peers_prefix(self):
        """A hot prefix prefilled on d0 (prefix cache and host tier on)
        seeds d1's host tier through a peer pull when placement puts the
        next request there: the pull is counted, the stream is the same,
        and d1's prefill charges only the uncovered tail."""
        from tests.test_torch_serving import engines as both_engines

        prompt = np.arange(1, 42, dtype=np.int32)  # 41 tokens, 8-token blocks: 5 full

        def scenario(ns, engs):
            router = _cluster(ns).Router(engines=engs, placement="round_robin").start()
            try:
                r1 = run_all(ns, router, [prompt], 4)[0]
                wait_idle(router)
                r2 = run_all(ns, router, [prompt], 4)[0]
                wait_idle(router)
                h = router.health()
            finally:
                router.shutdown()
            return r1.generated, r2.generated, h["prefix_peer_pulls"] >= 1

        over = {"kv_cache": {"block_size": 8, "num_blocks": 64, "max_blocks_per_seq": 12,
                             "prefix_cache": True, "host_tier_bytes": 1 << 22}}
        pairs = [both_engines("float32", **over) for _ in range(2)]
        want = scenario(JAX, [p[0] for p in pairs])
        got = scenario(PORT, [p[1] for p in pairs])
        assert got == want
        assert got[0] == got[1] and got[2] is True


# ---------------------------------------------------------------------------
# real engines: one prefill worker and two decode replicas over every wire
# ---------------------------------------------------------------------------
def _tiny_engines(n):
    """``n`` JAX engines and ``n`` port engines on the same seeded weights
    (``tests/test_torch_spec_decode.py``'s tiny model, fp32)."""
    import dataclasses

    import jax

    from deepspeed_tpu.inference.config import RaggedInferenceEngineConfig as JaxEngineConfig
    from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
    from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import transformer as PT
    from deepspeed_tpu_torch.models.convert import params_from_numpy
    from tests import test_torch_spec_decode as sd

    jcfg, jp = sd._jax_params(0)
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    pcfg = PT.TransformerConfig(**dict(sd.MODEL, dtype="float32"))
    rc = sd.engine_config()
    return ([JaxEngine(jcfg, jp, JaxEngineConfig.from_dict(rc)) for _ in range(n)],
            [InferenceEngineV2(pcfg, pp, RaggedInferenceEngineConfig.from_dict(rc), device="cpu")
             for _ in range(n)])


def _real_prompts():
    from tests.test_torch_serving import real_prompts

    return real_prompts()


SEEDED = {"greedy": False, "temperature": 0.8, "seed": 123}


@pytest.fixture(scope="module")
def jax_streams():
    """The JAX package's streams on the tiny model: the single-engine
    driver's and the Router's (one prefill worker, two decode replicas,
    the host wire), greedy."""
    jengs, _ = _tiny_engines(4)
    ps = _real_prompts()
    drv = JAX.ServingDriver(jengs[0]).start()
    single = [r.generated for r in run_all(JAX, drv, ps, 6)]
    drv.shutdown()
    router = _cluster(JAX).Router(engines=jengs[1:], num_prefill_workers=1).start()
    try:
        routed = [r.generated for r in run_all(JAX, router, ps, 6)]
    finally:
        router.shutdown()
    return single, routed


class TestRouterRealEngine:
    @pytest.mark.parametrize("transport", ["host", "in_process", "device"])
    def test_streams_match_jax_router_and_driver(self, transport, jax_streams):
        """Greedy: the port's Router streams the JAX Router's tokens and the
        single-engine driver's (both packages'), every request handed off,
        every pool free after; seeded: the port's Router streams its own
        driver's tokens."""
        jsingle, jrouted = jax_streams
        assert jrouted == jsingle
        ps = _real_prompts()
        _, pengs = _tiny_engines(4)
        for sampling in ({"greedy": True}, SEEDED):
            for e in pengs:
                e.set_sampling(**sampling)
            drv = PORT.ServingDriver(pengs[0]).start()
            single = [r.generated for r in run_all(PORT, drv, ps, 6)]
            drv.shutdown()
            router = _cluster(PORT).Router(engines=pengs[1:], num_prefill_workers=1,
                                           kv_transport=transport).start()
            try:
                got = [r.generated for r in run_all(PORT, router, ps, 6)]
                h = router.health()
            finally:
                router.shutdown()
            assert got == single, f"router streams left the driver's ({transport}, {sampling})"
            if sampling.get("greedy"):
                assert got == jsingle
            assert h["kv_handoffs"] == len(ps)
            wire = h["kv_transport"]["per_transport"][transport]
            assert wire["handoffs"] == len(ps) and wire["bytes"] > 0
        for e in pengs:
            assert e.state_manager.free_blocks == e.config.kv_cache.num_blocks

    def test_device_wire_keeps_payloads_on_the_engine_device(self):
        """A device-wire handoff carries no numpy plane: every window plane
        is a tensor on the engine's device, one window width, and the byte
        count is shape × itemsize."""
        _, (src, tgt) = _tiny_engines(2)
        h = _cluster(PORT).handoff
        prompt = np.arange(1, 30, dtype=np.int32)
        src.scheduler.submit(0, prompt)
        tok = None
        for _ in range(8):
            out = src.step_tokens()
            if 0 in out:
                tok = int(out[0])
                break
        ho = h.export_sequence(src, 0, tok, transport="device")
        assert ho.payload is None and ho.windows and ho.chunk_blocks > 0
        for w in ho.windows:
            for t in w.values():
                assert isinstance(t, torch.Tensor) and t.device == src.device
                assert t.shape[1] == ho.chunk_blocks
        assert ho.nbytes == sum(t.numel() * t.element_size() for w in ho.windows
                                for t in w.values())
        src.scheduler.finish(0)
        assert h.import_sequence(tgt, ho) == ho.n_blocks
        assert tgt.scheduler.peek_next_token(0) == tok
        tgt.scheduler.finish(0)

    @pytest.mark.slow
    def test_int8_streams_match_the_driver(self):
        """int8 pools: codes and scale planes cross the handoff bit for bit,
        so the routed streams equal the single-engine driver's on every
        wire (slow, as the JAX package's int8 parity test is)."""
        from tests import test_torch_spec_decode as sd
        from tests.test_torch_serving import INT8

        ps = _real_prompts()
        drv = PORT.ServingDriver(sd.port_engine(**INT8)).start()
        single = [r.generated for r in run_all(PORT, drv, ps, 6)]
        drv.shutdown()
        for transport in ("host", "in_process", "device"):
            router = _cluster(PORT).Router(engines=[sd.port_engine(**INT8) for _ in range(3)],
                                           num_prefill_workers=1, kv_transport=transport).start()
            try:
                got = [r.generated for r in run_all(PORT, router, ps, 6)]
            finally:
                router.shutdown()
            assert got == single, transport


# ---------------------------------------------------------------------------
# dstpu serve's router mode
# ---------------------------------------------------------------------------
SERVE_ARGV = ["--model", "", "--port", "0", "--dtype", "float32", "--device", "cpu",
              "--num-blocks", "64", "--block-size", "8", "--max-blocks-per-seq", "12",
              "--max-context", "96", "--max-concurrent", "8"]


class TestServeCLI:
    def test_build_serving_stack_router_mode(self):
        """--num-prefill-workers 1 --num-decode-replicas 2 build the Router
        (p0, d0, d1; separate KV pools over one copy of the weights, each
        engine warmed), the placement and the wire echoed; the flag
        defaults keep the single-engine driver."""
        from deepspeed_tpu_torch.inference import cli as pcli
        from deepspeed_tpu_torch.serving import Router, ServingDriver
        from tests import test_torch_spec_decode as sd

        base = sd.port_engine()
        cfg, params = base._mc, base.params
        tok = SimpleNamespace(eos_token_id=None)
        args = pcli.serve_parse_args(SERVE_ARGV + [
            "--num-prefill-workers", "1", "--num-decode-replicas", "2",
            "--placement", "least_loaded", "--kv-transport", "device"])
        front, _ = pcli.build_serving_stack(args, cfg=cfg, params=params, tok=tok)
        assert isinstance(front, Router)
        h = front.health()
        assert set(h["replicas"]) == {"p0", "d0", "d1"}
        assert h["placement"] == "least_loaded"
        assert h["kv_transport"]["transport"] == "device"
        embeds = {c.engine.params["embed"].data_ptr() for c in front.cores}
        assert embeds == {params["embed"].data_ptr()}
        with front:
            (r,) = run_all(PORT, front, [np.arange(1, 20, dtype=np.int32)], 4)
        assert len(r.generated) == 4 and front.health()["kv_handoffs"] == 1
        front, _ = pcli.build_serving_stack(pcli.serve_parse_args(SERVE_ARGV), cfg=cfg,
                                            params=params, tok=tok)
        assert isinstance(front, ServingDriver)

    @pytest.mark.parametrize("flags,item", [
        (["--control-port", "0"], "item 5"), (["--control-host", "0.0.0.0"], "item 5"),
        (["--kv-transport", "remote"], "item 5"), (["--tp", "2"], "item 6"),
    ], ids=["control-port", "control-host", "remote", "tp"])
    def test_refused_flags_name_their_item(self, flags, item):
        """The cross-process flags (ROADMAP queue 1, item 5, ported) parse
        as the JAX package's do and build the router: the control plane's
        own flags are read by ``serve_main``, the remote wire registers p0's
        KV endpoint at construction. ``--tp`` above 1 stays refused, naming
        item 6, before anything is built."""
        from deepspeed_tpu.inference import cli as jcli
        from deepspeed_tpu_torch.inference import cli as pcli
        from deepspeed_tpu_torch.serving import Router
        from tests import test_torch_spec_decode as sd

        argv = SERVE_ARGV + ["--num-prefill-workers", "1"] + flags
        args = pcli.serve_parse_args(argv)
        if item == "item 6":
            with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, {item}"):
                pcli.build_serving_stack(args)
            return
        jargs = jcli.serve_parse_args([a for a in argv if a not in ("--device", "cpu")])
        for key in ("control_port", "control_host", "kv_transport"):
            assert getattr(args, key) == getattr(jargs, key), key
        base = sd.port_engine()
        front, _ = pcli.build_serving_stack(args, cfg=base._mc, params=base.params,
                                            tok=SimpleNamespace(eos_token_id=None))
        try:
            assert isinstance(front, Router)
            h = front.health()
            assert h["kv_transport"]["transport"] == args.kv_transport
            assert ("p0" in h["kv_transport"]["endpoints"]) == (args.kv_transport == "remote")
        finally:
            front.shutdown(drain=False)


class TestRouterMetrics:
    def test_replica_labels_in_prometheus_text(self):
        def scenario(ns):
            engines = [FakeEngine(ns) for _ in range(3)]
            router = _cluster(ns).Router(engines=engines, num_prefill_workers=1).start()
            try:
                run_all(ns, router, [np.asarray([5, 6], np.int32)], 4)
                assert router.drain(WAIT_S)
                text = router.metrics.prometheus_text()
            finally:
                router.shutdown()
            # the samples' names and labels (their values are gauges a worker
            # refreshes after its own pass: timing, not behaviour)
            lines = sorted(ln.rsplit(" ", 1)[0] for ln in text.splitlines()
                           if ln.startswith("dstpu_serving_replica_"))
            return lines, router.metrics.snapshot()["kv_total_blocks"]

        lines, total = on_both(scenario)
        text = "\n".join(lines)
        for name in ("p0", "d0", "d1"):
            assert f'replica="{name}"' in text
        assert 'role="prefill"' in text and 'role="decode"' in text
        assert "dstpu_serving_replica_handoffs_out_total" in text
        assert total == 3 * 256
