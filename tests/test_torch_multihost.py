"""The port's multi-host control plane (``serving/cluster/agent.py``,
``remote_core.py`` behind the Router) against the JAX package's.

Mirrors ``tests/unit/test_multihost.py``, cheapest first:

  1. ``RemoteEngineHandle``'s admission math and cache bookkeeping with no
     sockets, on the same inputs in both packages;
  2. the in-process contract: a real ``ReplicaAgent`` over ``FakeEngine``
     (each package's real scheduler and allocator, compute-free steps;
     ``tests/test_torch_serving.py``) dials a real ``Router.serve_control()``
     listener in the same process: join, decode, cancel, loss, re-join,
     the advertised KV endpoint host and a refused name, each scenario run
     through both packages with the same observable results;
  3. stream parity: on the tiny model of ``tests/test_torch_spec_decode.py``
     (converted weights), the port's ``Router(kv_transport="remote")`` with
     an in-process agent thread streams the JAX Router's greedy tokens (fp32
     and bf16 pools); an int8 pool streams the port's single driver's;
  4. across processes: a real agent subprocess (``python -S -m
     tests.test_torch_multihost agent ...``: no site customization, it
     imports no JAX and loads its weights from an npz the parent wrote with
     the port's own checkpoint writer) decodes its share of the streams,
     equal to the single driver's, and exits 0 on the router's GOODBYE.
     Tier-1 carries the greedy leg; the seeded, int8 and SIGKILL legs are
     ``slow``, as the JAX package marks them.

This module imports nothing of JAX at its top: the agent child runs it.
Every wait on a thread, a process or a socket has a deadline and asserts.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 60  # requests, joins, threads
CHILD_JOIN_S = 120  # an agent child: interpreter, torch, engine, dial
CHILD_EXIT_S = 60


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mh(ns):
    """One package's control-plane surface, by the same names in both."""
    import importlib
    from types import SimpleNamespace

    m = lambda name: importlib.import_module(f"{ns.root}.{name}")  # noqa: E731
    return SimpleNamespace(
        ns=ns, Router=m("serving.cluster.router").Router,
        EngineCore=m("serving.cluster.core").EngineCore,
        ReplicaAgent=m("serving.cluster.agent").ReplicaAgent,
        RemoteEngineHandle=m("serving.cluster.remote_core").RemoteEngineHandle,
        ControlChannel=m("serving.net.control").ControlChannel,
        WireError=m("serving.net.wire").WireError,
        ServingMetrics=m("serving.metrics").ServingMetrics,
        ResilienceConfig=m("serving.resilience").ResilienceConfig,
        events=m("observability.events"),
    )


def _both():
    from tests.test_torch_serving import JAX, PORT

    return _mh(JAX), _mh(PORT)


def on_both(scenario):
    """``scenario(mh)`` in each package; the results must be equal; returns
    the port's."""
    jmh, pmh = _both()
    want, got = scenario(jmh), scenario(pmh)
    assert got == want
    return got


def agent_rcs(rcs, runner, mh):
    """Keep ``runner``'s exit code by package: the scenarios compare the
    port's with 0 and not the JAX agent's, whose run can raise out of its
    first dial under load (ROADMAP §3, a known JAX flake)."""
    rcs[mh.ns.root] = runner.join()


def wait_for(pred, timeout=WAIT_S, msg="condition", interval=0.005):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {msg}"
        time.sleep(interval)


def _fast_cfg(mh, **kw):
    base = dict(hung_step_s=30.0, probe_backoff_s=0.05, retry_backoff_s=0.001)
    base.update(kw)
    base.setdefault("probe_backoff_max_s", max(30.0, base["probe_backoff_s"]))
    return mh.ResilienceConfig(**base)


def _req(mh, uid=1, n_prompt=8, max_new=8):
    ns = mh.ns
    return ns.Request(uid=uid, prompt_tokens=np.arange(1, n_prompt + 1, dtype=np.int32),
                      params=ns.SamplingParams(max_new_tokens=max_new, ignore_eos=True))


def run_all(mh, front, prompts, n_new, timeout=WAIT_S):
    ns = mh.ns
    reqs = [front.submit(p, params=ns.SamplingParams(max_new_tokens=n_new, ignore_eos=True))
            for p in prompts]
    for r in reqs:
        assert r.wait(timeout), f"request {r.uid} did not finish ({r.state})"
    return reqs


# ---------------------------------------------------------------------------
# 1. RemoteEngineHandle: admission math over cached META/STATS, no sockets
# ---------------------------------------------------------------------------
class _RecordingOwner:
    eos_token_id = None

    def __init__(self):
        self.tokens, self.stats, self.events, self.lost = [], [], [], []

    def _remote_token(self, core, obj):
        self.tokens.append(obj)

    def _remote_stats(self, core, obj):
        self.stats.append(obj)

    def _remote_event(self, core, obj):
        self.events.append(obj)

    def _agent_lost(self, core, err):
        self.lost.append(str(err))


def _meta(**over):
    meta = {"tp_shards": 1, "decode_steps": 1, "kv_headroom": 0.0,
            "kv": {"num_blocks": 16, "block_size": 4, "max_blocks_per_seq": 8},
            "sm": {"max_tracked_sequences": 4, "max_context": 128},
            "kv_info": {}, "free_blocks": 16, "prefix": [], "stats": {},
            "kv_endpoint": ["127.0.0.1", 4242], "kv_endpoint_stats": {}}
    meta.update(over)
    return meta


class TestRemoteHandleMath:
    def test_disconnected_handle_takes_no_placements(self):
        def scenario(mh):
            h = mh.RemoteEngineHandle("r0", _meta(), _RecordingOwner())
            out = [h.is_remote, h.role, h.connected, h.admissible(_req(mh)),
                   h.blocks_needed(_req(mh, n_prompt=8, max_new=8)), h.free_blocks(),
                   h.kv_total, h.committed_blocks()]
            with pytest.raises(ValueError, match="max_context=128"):
                h.engine.state_manager.check_admissible(128)
            h.engine.state_manager.check_admissible(127)
            return out

        assert on_both(scenario) == [True, "decode", False, False, 4, 16, 16, 0]

    def test_admission_tracks_stats_pushes(self):
        import socket

        def scenario(mh):
            owner = _RecordingOwner()
            h = mh.RemoteEngineHandle("r0", _meta(), owner)
            a, b = socket.socketpair()
            c, d = socket.socketpair()
            out = []
            try:
                h.attach_rpc(mh.ControlChannel(a, name="rpc"))
                h.attach_events(mh.ControlChannel(c, name="events"))
                out += [h.connected, h.admissible(_req(mh, n_prompt=8, max_new=8))]
                h._apply_stats({"free_blocks": 3, "prefix": ["p1", "p2", "p3"]})
                out += [h.free_blocks(), h.admissible(_req(mh, n_prompt=8, max_new=8)),
                        h.prefix_coverage(["p1", "p2", "zz", "p3"]), h.prefix_coverage(["zz"]),
                        h.prefix_coverage([])]
                h._apply_stats({"free_blocks": 16})
                for uid in range(4):
                    h.requests[uid] = _req(mh, uid=uid, max_new=4)
                out.append(h.admissible(_req(mh, uid=9)))
            finally:
                h.close()
                for s in (b, d):
                    s.close()
            return out

        assert on_both(scenario) == [True, True, 3, False, 2, 0, 0, False]

    def test_release_rides_outbox_and_disconnect_is_idempotent(self):
        import socket

        def scenario(mh):
            h = mh.RemoteEngineHandle("r0", _meta(), _RecordingOwner())
            h.requests[5] = _req(mh, uid=5)
            h.requests[6] = _req(mh, uid=6)
            h.release(5)
            h.release(6, scheduler_done=True)
            out = [5 in h.requests, 6 in h.requests, list(h._outbox)]
            a, b = socket.socketpair()
            try:
                h.attach_rpc(mh.ControlChannel(a, name="rpc"))
                out += [h.mark_disconnected(), h.mark_disconnected(), h.connected,
                        list(h._outbox)]
            finally:
                h.close()
                b.close()
            return out

        assert on_both(scenario) == [False, False, [5], True, False, False, []]

    def test_update_meta_refreshes_geometry_on_rejoin(self):
        def scenario(mh):
            h = mh.RemoteEngineHandle("r0", _meta(), _RecordingOwner())
            before = h.kv_endpoint_address()
            h.update_meta({"kv": {"num_blocks": 32, "block_size": 4, "max_blocks_per_seq": 8},
                           "free_blocks": 32, "kv_endpoint": ["10.0.0.2", 999]})
            st = h.replica_stats()
            return [before, h.kv_total, h.free_blocks(), h.kv_endpoint_address(),
                    st["kv_free_blocks"], st["kv_total_blocks"]]

        assert on_both(scenario) == [("127.0.0.1", 4242), 32, 32, ("10.0.0.2", 999), 32, 32]


# ---------------------------------------------------------------------------
# 2. the in-process contract: a real agent over FakeEngine dials a Router
# ---------------------------------------------------------------------------
class _AgentRunner:
    """``agent.run()`` on a thread, its exit code kept."""

    def __init__(self, agent):
        self.agent = agent
        self.rc = None
        self.thread = threading.Thread(target=self._main, name="agent-run", daemon=True)
        self.thread.start()

    def _main(self):
        self.rc = self.agent.run()

    def join(self, timeout=WAIT_S):
        self.thread.join(timeout)
        assert not self.thread.is_alive(), "agent run loop did not exit"
        return self.rc


def _fake(mh, **kw):
    from tests.test_torch_serving import FakeEngine

    return FakeEngine(mh.ns, **kw)


def _fake_agent(mh, addr, name="ra0", engine=None):
    core = mh.EngineCore(engine if engine is not None else _fake(mh), name=name, role="decode",
                         metrics=mh.ServingMetrics())
    return mh.ReplicaAgent(core, addr, name=name, stats_interval_s=0.05,
                           poll_interval_s=0.002)


def _remote_handle(router):
    return next(c for c in router.decode if getattr(c, "is_remote", False))


def _wait_joined(router, name, timeout=WAIT_S):
    wait_for(lambda: router.health()["control_plane"]["remote_replicas"]
             .get(name, {}).get("connected", False), timeout=timeout, msg=f"agent {name} join")


def _expected(prompt, n):
    last = int(prompt[-1])
    return [last + 1 + i for i in range(n)]


class TestInProcessContract:
    def test_join_decode_observability_goodbye(self):
        """An agent joins, round-robin placement seats streams on it, tokens
        pump back through ``Router.deliver``, /health and /metrics carry
        the remote labels, and the router's GOODBYE ends the agent loop
        with rc 0; both pools are conserved."""

        def scenario(mh):
            local = _fake(mh)
            router = mh.Router(engines=[local], num_prefill_workers=0,
                               placement="round_robin").start()
            addr = router.serve_control()
            assert router.serve_control() == addr
            agent = _fake_agent(mh, addr)
            runner = _AgentRunner(agent)
            try:
                _wait_joined(router, "ra0")
                prompts = [np.asarray([10 * (i + 1)], np.int32) for i in range(6)]
                reqs = run_all(mh, router, prompts, 4)
                health = router.health()
                cp, rep = health["control_plane"], health["replicas"]["ra0"]
                snap = router.metrics.snapshot()
                out = [[r.generated == _expected(p, 4) for p, r in zip(prompts, reqs)],
                       cp["enabled"], cp["address"] == list(addr),
                       cp["remote_replicas"]["ra0"]["connected"], rep["remote"],
                       rep["connected"], rep["requests_finished_total"],
                       health["replicas"]["d0"]["requests_finished_total"],
                       'remote="1"' in router.metrics.prometheus_text(),
                       snap.get("control_rpcs_total", 0) >= 3,
                       snap.get("control_frames_total", 0) > 0,
                       "agent_joined" in {e["kind"] for e in mh.events.get_event_log().recent(100)}]
            finally:
                router.shutdown()
            agent_rcs(rcs, runner, mh)
            return out + [local.state_manager.free_blocks,
                          agent.core.engine.state_manager.free_blocks]

        rcs = {}
        assert on_both(scenario) == [[True] * 6, True, True, True, True, True, 3, 3, True, True,
                                     True, True, 256, 256]
        assert rcs["deepspeed_tpu_torch"] == 0

    def test_router_cancel_flushes_to_agent(self):
        """A router-side cancel frees the agent's scheduler and KV state
        through the CANCEL flusher."""

        def scenario(mh):
            local = _fake(mh, block_size=4, num_blocks=2, max_blocks_per_seq=8)
            router = mh.Router(engines=[local], num_prefill_workers=0).start()
            addr = router.serve_control()
            agent = _fake_agent(mh, addr, engine=_fake(mh, step_delay=0.002))
            runner = _AgentRunner(agent)
            try:
                _wait_joined(router, "ra0")
                req = router.submit(np.arange(1, 9, dtype=np.int32),
                                    params=mh.ns.SamplingParams(max_new_tokens=512,
                                                                ignore_eos=True))
                req.stream.get(timeout=WAIT_S)
                out = [req.uid in _remote_handle(router).requests, req.uid in agent.core.requests,
                       router.cancel(req.uid)]
                wait_for(lambda: req.uid not in agent.core.requests, msg="CANCEL at the agent")
                wait_for(lambda: agent.core.engine.state_manager.free_blocks == 256,
                         msg="agent KV blocks to free")
            finally:
                router.shutdown()
            agent_rcs(rcs, runner, mh)
            return out

        rcs = {}
        assert on_both(scenario) == [True, True, True]
        assert rcs["deepspeed_tpu_torch"] == 0

    def test_agent_loss_quarantines_replays_and_rejoins(self):
        """Severing the control wire (an agent crash) quarantines the
        replica, replays its residents on the local replica to the same
        streams, and the agent re-joins under its name: the probation
        probe re-admits it and it takes traffic again."""
        import socket

        def scenario(mh):
            local = _fake(mh, step_delay=0.003)
            router = mh.Router(engines=[local], num_prefill_workers=0, placement="round_robin",
                               resilience=_fast_cfg(mh)).start()
            addr = router.serve_control()
            agent = _fake_agent(mh, addr, engine=_fake(mh, step_delay=0.003))
            runner = _AgentRunner(agent)
            try:
                _wait_joined(router, "ra0")
                handle = _remote_handle(router)
                prompts = [np.asarray([100 * (i + 1)], np.int32) for i in range(2)]
                reqs = [router.submit(p, params=mh.ns.SamplingParams(max_new_tokens=60,
                                                                     ignore_eos=True))
                        for p in prompts]
                wait_for(lambda: any(r.uid in handle.requests and len(r.generated) >= 2
                                     for r in reqs), msg="remote stream mid-decode")
                for chan in (agent._rpc, agent._events):
                    try:
                        chan._conn.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                for r in reqs:
                    assert r.wait(WAIT_S), "stream did not recover from agent loss"
                out = [[r.generated == _expected(p, 60) for p, r in zip(prompts, reqs)]]
                snap = router.metrics.snapshot()
                out += [snap.get("replica_failures_total", 0) >= 1,
                        snap.get("recovery_replays_total", 0) >= 1]
                _wait_joined(router, "ra0")
                wait_for(lambda: router.health()["replicas"]["ra0"]["health"]["state"]
                         == "healthy", msg="probation re-admit")
                kinds = {e["kind"] for e in mh.events.get_event_log().recent(200)}
                out += [{"agent_lost", "agent_rejoined", "probe_passed"} <= kinds]
                more = run_all(mh, router, [np.asarray([7], np.int32)] * 4, 4)
                out += [[r.generated for r in more], len(handle.requests)]
            finally:
                router.shutdown()
            agent_rcs(rcs, runner, mh)
            return out + [local.state_manager.free_blocks,
                          agent.core.engine.state_manager.free_blocks]

        rcs = {}
        assert on_both(scenario) == [[True, True], True, True, True, [[8, 9, 10, 11]] * 4, 0,
                                     256, 256]
        assert rcs["deepspeed_tpu_torch"] == 0

    def test_advertised_kv_endpoint_host(self, monkeypatch):
        """``DSTPU_KV_ENDPOINT_HOST`` separates discovery from binding: the
        listener stays on its bind interface, the bootstrap META and
        /health advertise the configured address."""
        monkeypatch.setenv("DSTPU_KV_ENDPOINT_HOST", "198.51.100.7")

        def scenario(mh):
            router = mh.Router(engines=[_fake(mh)], num_prefill_workers=0).start()
            addr = router.serve_control()
            agent = _fake_agent(mh, addr, name="adv0")
            runner = _AgentRunner(agent)
            try:
                ep = agent._endpoint
                out = [ep.bind_address[0], ep.address == ("198.51.100.7", ep.bind_address[1]),
                       agent._bootstrap_meta()["kv_endpoint"][0]]
                _wait_joined(router, "adv0")
                health = router.health()
                out += [health["control_plane"]["remote_replicas"]["adv0"]["kv_endpoint"][0],
                        health["replicas"]["adv0"]["kv_endpoint"][0]]
            finally:
                router.shutdown()
            agent_rcs(rcs, runner, mh)
            return out

        rcs = {}
        assert on_both(scenario) == ["127.0.0.1", True] + ["198.51.100.7"] * 3
        assert rcs["deepspeed_tpu_torch"] == 0

    def test_local_name_collision_refused(self):
        def scenario(mh):
            router = mh.Router(engines=[_fake(mh)], num_prefill_workers=0).start()
            addr = router.serve_control()
            agent = _fake_agent(mh, addr, name="d0")
            try:
                with pytest.raises(mh.WireError, match="taken by a local engine"):
                    agent.connect()
                return len(router.decode)
            finally:
                agent.close()
                router.shutdown()

        assert on_both(scenario) == 1


# ---------------------------------------------------------------------------
# 3. stream parity with an in-process agent over the remote wire
# ---------------------------------------------------------------------------
def _agent_router_streams(mh, router_engines, agent_engine, prompts, n_new=6, name="ra0"):
    """1 prefill worker + 1 local decode replica + 1 agent (a thread over
    ``agent_engine``) behind ``kv_transport="remote"``, round robin: the
    streams, /health, and the agent's exit code."""
    router = mh.Router(engines=router_engines, num_prefill_workers=1, kv_transport="remote",
                       placement="round_robin").start()
    runner = None
    try:
        addr = router.serve_control()
        core = mh.EngineCore(agent_engine, name=name, role="decode", metrics=mh.ServingMetrics())
        runner = _AgentRunner(mh.ReplicaAgent(core, addr, name=name, stats_interval_s=0.05,
                                              poll_interval_s=0.002))
        _wait_joined(router, name)
        got = [list(r.generated) for r in run_all(mh, router, prompts, n_new)]
        wait_for(lambda: router.num_active == 0, msg="router idle")
        health = router.health()
    finally:
        router.shutdown()
    return got, health, runner.join() if runner is not None else None


class TestRemoteAgentStreams:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_streams_match_jax_router(self, dtype):
        """Greedy streams through the port's remote Router with an agent
        equal the JAX Router's (its own agent, same weights) and the port's
        single driver's; the agent decoded its share; every pool is free."""
        from tests.test_torch_net_transport import _engine_sets
        from tests.test_torch_router import _real_prompts

        jmh, pmh = _both()
        ps = _real_prompts()
        jengs, pengs = _engine_sets(dtype, 4)
        jgot, jh, jrc = _agent_router_streams(jmh, jengs[:2], jengs[2], ps)
        drv = pmh.ns.ServingDriver(pengs[3]).start()
        single = [list(r.generated) for r in run_all(pmh, drv, ps, 6)]
        drv.shutdown()
        got, h, rc = _agent_router_streams(pmh, pengs[:2], pengs[2], ps)
        assert got == jgot == single
        assert rc == jrc == 0
        rep = h["replicas"]["ra0"]
        assert rep["remote"] and rep["requests_finished_total"] >= 1
        assert (rep["requests_finished_total"] + h["replicas"]["d0"]["requests_finished_total"]
                == len(ps))
        assert h["kv_transport"]["endpoints"]["p0"]["staged_now"] == 0
        for e in pengs:
            assert e.state_manager.free_blocks == e.config.kv_cache.num_blocks

    def test_int8_streams_match_the_driver(self):
        from tests import test_torch_spec_decode as sd
        from tests.test_torch_router import _real_prompts
        from tests.test_torch_serving import INT8

        _, pmh = _both()
        ps = _real_prompts()
        drv = pmh.ns.ServingDriver(sd.port_engine(**INT8)).start()
        single = [list(r.generated) for r in run_all(pmh, drv, ps, 6)]
        drv.shutdown()
        engs = [sd.port_engine(**INT8) for _ in range(3)]
        got, h, rc = _agent_router_streams(pmh, engs[:2], engs[2], ps)
        assert got == single and rc == 0
        assert h["replicas"]["ra0"]["requests_finished_total"] >= 1
        for e in engs:
            assert e.state_manager.free_blocks == 64

    def test_prefix_cache_agent_advertises_and_streams(self):
        """With the prefix cache on (``serve``'s default) the agent's STATS
        carry its prefix chain hashes as hex strings (bytes are no JSON);
        the router reads them back as its own keys, and a repeated prompt's
        streams still equal the single driver's."""
        from tests import test_torch_spec_decode as sd

        _, pmh = _both()
        kv = {"kv_cache": {"block_size": 8, "num_blocks": 64, "max_blocks_per_seq": 12,
                           "prefix_cache": True}}
        ps = [np.arange(1, 40, dtype=np.int32), np.arange(1, 60, dtype=np.int32)] * 2
        drv = pmh.ns.ServingDriver(sd.port_engine(**kv)).start()
        single = [list(r.generated) for r in run_all(pmh, drv, ps, 16)]
        drv.shutdown()
        engs = [sd.port_engine(**kv) for _ in range(3)]
        router = pmh.Router(engines=engs[:2], num_prefill_workers=1, kv_transport="remote",
                            placement="round_robin").start()
        runner = None
        try:
            addr = router.serve_control()
            core = pmh.EngineCore(engs[2], name="ra0", role="decode",
                                  metrics=pmh.ServingMetrics())
            runner = _AgentRunner(pmh.ReplicaAgent(core, addr, name="ra0",
                                                   stats_interval_s=0.05, poll_interval_s=0.002))
            _wait_joined(router, "ra0")
            got = [list(r.generated) for r in run_all(pmh, router, ps, 16)]
            handle = _remote_handle(router)
            wait_for(lambda: len(handle.prefix_hashes()) > 0, msg="the agent's advertisement")
            held = handle.prefix_hashes()
            assert held and all(isinstance(h, bytes) for h in held)
            assert held <= core.prefix_hashes()
        finally:
            router.shutdown()
        assert runner.join() == 0
        assert got == single

    def test_failed_adopt_recovers_the_request(self):
        """An ADOPT the agent acknowledged but could not import (every
        retry of its fetch killed at ``net.recv``) comes back as an
        ``adopt_failed`` EVENT: the request replays to the same stream and
        its staged transfer is released."""
        from tests import test_torch_spec_decode as sd
        from tests.test_torch_router import _real_prompts

        from deepspeed_tpu_torch.serving import resilience as res

        _, pmh = _both()
        ps = _real_prompts()
        drv = pmh.ns.ServingDriver(sd.port_engine()).start()
        single = [list(r.generated) for r in run_all(pmh, drv, ps, 6)]
        drv.shutdown()
        engs = [sd.port_engine() for _ in range(3)]
        router = pmh.Router(engines=engs[:2], num_prefill_workers=1, kv_transport="remote",
                            placement="round_robin", resilience=_fast_cfg(pmh)).start()
        runner = None
        specs = [res.FaultSpec("net.recv", nth=n, replica="ra0") for n in (1, 2, 3)]
        try:
            with res.inject(*specs) as inj:
                addr = router.serve_control()
                core = pmh.EngineCore(engs[2], name="ra0", role="decode",
                                      metrics=pmh.ServingMetrics())
                agent = pmh.ReplicaAgent(core, addr, name="ra0", stats_interval_s=0.05,
                                         poll_interval_s=0.002)
                runner = _AgentRunner(agent)
                _wait_joined(router, "ra0")
                got = [list(r.generated) for r in run_all(pmh, router, ps, 6)]
                wait_for(lambda: router.num_active == 0, msg="router idle")
                h = router.health()
            assert len(inj.fired()) == 3 and agent.import_retries == 2
        finally:
            router.shutdown()
        assert runner.join() == 0
        assert got == single
        assert h["resilience"]["recoveries"] >= 1
        assert h["kv_transport"]["endpoints"]["p0"]["staged_now"] == 0
        for e in engs:
            assert e.state_manager.free_blocks == 64


# ---------------------------------------------------------------------------
# 4. across processes: a real agent subprocess
# ---------------------------------------------------------------------------
def _port_engine_spec(kv_dtype):
    """(model config dict, engine config dict) of the tiny model's port
    engine (``tests/test_torch_spec_decode.py``): what the child builds."""
    from tests import test_torch_spec_decode as sd
    from tests.test_torch_serving import INT8

    over = INT8 if kv_dtype == "int8" else {}
    return dict(sd.MODEL), sd.engine_config(**over)


def _write_weights(tmp_path):
    """The tiny model's converted weights, written by the port's own
    checkpoint writer (the child reads them back with its reader)."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
        TorchCheckpointEngine,
    )
    from tests import test_torch_spec_decode as sd

    path = str(tmp_path / "weights.npz")
    TorchCheckpointEngine().save({"params": sd.port_engine().params}, path)
    return path


def _spawn_agent_child(addr, name, kv_dtype, sampling, weights):
    model, rc = _port_engine_spec(kv_dtype)
    spec = json.dumps({"model": model, "engine": rc, "sampling": sampling, "weights": weights})
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT)] + sys.path),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-S", "-m", "tests.test_torch_multihost", "agent",
                             addr[0], str(addr[1]), name, spec],
                            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _child_tail(proc, limit=3000):
    try:
        out, _ = proc.communicate(timeout=5)
    except Exception:  # noqa: BLE001 - diagnostics only
        out = ""
    return (out or "")[-limit:]


def _wait_child_joined(router, name, proc, timeout=CHILD_JOIN_S):
    deadline = time.monotonic() + timeout
    while True:
        if router.health()["control_plane"]["remote_replicas"].get(name, {}).get("connected"):
            return
        if proc.poll() is not None:
            raise AssertionError(f"agent child died rc={proc.returncode} before joining:\n"
                                 f"{_child_tail(proc)}")
        assert time.monotonic() < deadline, f"agent child never joined:\n{_child_tail(proc)}"
        time.sleep(0.05)


def _reap_clean(proc, timeout=CHILD_EXIT_S):
    """The router's shutdown GOODBYE must end the agent with rc 0."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate(timeout=10)
        raise AssertionError("agent child did not exit on router shutdown")
    assert proc.returncode == 0, f"agent child rc={proc.returncode}:\n{(out or '')[-3000:]}"
    return out


def _single_streams(pmh, kv_dtype, sampling, prompts, n_new):
    from tests import test_torch_spec_decode as sd
    from tests.test_torch_serving import INT8

    eng = sd.port_engine(**(INT8 if kv_dtype == "int8" else {}))
    eng.set_sampling(**sampling)
    drv = pmh.ns.ServingDriver(eng).start()
    try:
        return [list(r.generated) for r in run_all(pmh, drv, prompts, n_new)]
    finally:
        drv.shutdown()


class TestCrossProcess:
    def _parity(self, tmp_path, kv_dtype, sampling):
        """1 prefill worker + 1 local decode replica + 1 agent subprocess
        behind ``kv_transport="remote"``: streams equal the single driver's,
        the agent decoded its round-robin share (KV fetched from the
        worker's endpoint, tokens over the events channel), it joined with
        the same weights and exited 0 on the GOODBYE."""
        from tests import test_torch_spec_decode as sd
        from tests.test_torch_router import _real_prompts
        from tests.test_torch_serving import INT8

        _, pmh = _both()
        ps = _real_prompts()
        want = _single_streams(pmh, kv_dtype, sampling, ps, 6)
        weights = _write_weights(tmp_path)
        engs = [sd.port_engine(**(INT8 if kv_dtype == "int8" else {})) for _ in range(2)]
        for e in engs:
            e.set_sampling(**sampling)
        router = pmh.Router(engines=engs, num_prefill_workers=1, kv_transport="remote",
                            placement="round_robin").start()
        proc = None
        try:
            addr = router.serve_control()
            proc = _spawn_agent_child(addr, "ragent", kv_dtype, sampling, weights)
            _wait_child_joined(router, "ragent", proc)
            got = [list(r.generated) for r in run_all(pmh, router, ps, 6)]
            health = router.health()
        finally:
            try:
                router.shutdown()
            finally:
                out = _reap_clean(proc) if proc is not None else ""
        assert got == want, f"streams diverged ({kv_dtype}, {sampling})"
        rep = health["replicas"]["ragent"]
        assert rep["remote"] is True and rep["connected"] is True
        assert rep["requests_finished_total"] >= 1
        assert rep["requests_finished_total"] + health["replicas"]["d0"][
            "requests_finished_total"] == len(ps)
        assert health["control_plane"]["remote_replicas"]["ragent"]["kv_endpoint"] is not None
        assert health["kv_transport"]["endpoints"]["p0"]["staged_now"] == 0
        for e in engs:
            assert e.state_manager.free_blocks == 64, "parent pool leaked"
        child = json.loads(out.strip().splitlines()[-1])
        assert child["jax_loaded"] is False and child["free_blocks"] == 64
        assert child["handoffs_in"] >= 1

    @pytest.mark.parametrize(
        "sampling", [{"greedy": True},
                     pytest.param({"greedy": False, "temperature": 0.8, "seed": 123},
                                  marks=pytest.mark.slow)],
        ids=["greedy", "seeded"])
    def test_cross_process_parity_fp32(self, tmp_path, sampling):
        self._parity(tmp_path, "fp32", sampling)

    @pytest.mark.slow
    def test_cross_process_parity_int8(self, tmp_path):
        self._parity(tmp_path, "int8", {"greedy": True})

    @pytest.mark.slow
    def test_cross_process_sigkill_recovery_and_readmit(self, tmp_path):
        """SIGKILL the agent mid-decode: the pump's EOF quarantines it, its
        residents replay on the local replica to the driver's streams,
        pools are conserved, and a restarted agent under the same name
        passes its probation probe and decodes again."""
        from tests import test_torch_spec_decode as sd
        from tests.test_torch_router import _real_prompts

        _, pmh = _both()
        sampling, n_long = {"greedy": True}, 40
        ps = _real_prompts()
        prompts = ps[:2]
        want = _single_streams(pmh, "fp32", sampling, prompts, n_long)
        weights = _write_weights(tmp_path)
        engs = [sd.port_engine() for _ in range(2)]
        router = pmh.Router(engines=engs, num_prefill_workers=1, kv_transport="remote",
                            placement="round_robin", resilience=_fast_cfg(pmh)).start()
        proc = proc2 = None
        try:
            addr = router.serve_control()
            proc = _spawn_agent_child(addr, "ragent", "fp32", sampling, weights)
            _wait_child_joined(router, "ragent", proc)
            handle = _remote_handle(router)
            reqs = [router.submit(p, params=pmh.ns.SamplingParams(max_new_tokens=n_long,
                                                                  ignore_eos=True))
                    for p in prompts]
            wait_for(lambda: any(r.uid in handle.requests and len(r.generated) >= 2
                                 for r in reqs), timeout=CHILD_JOIN_S, msg="remote decode")
            os.kill(proc.pid, signal.SIGKILL)
            proc.communicate(timeout=CHILD_EXIT_S)
            for r, w in zip(reqs, want):
                assert r.wait(WAIT_S), "stream did not recover from SIGKILL"
                assert list(r.generated) == w, "replayed stream diverged"
            snap = router.metrics.snapshot()
            assert snap.get("replica_failures_total", 0) >= 1
            assert snap.get("recovery_replays_total", 0) >= 1
            assert router.health()["replicas"]["ragent"]["health"]["quarantines"] >= 1
            proc2 = _spawn_agent_child(addr, "ragent", "fp32", sampling, weights)
            _wait_child_joined(router, "ragent", proc2)
            wait_for(lambda: router.health()["replicas"]["ragent"]["health"]["state"]
                     == "healthy", msg="probation re-admit")
            got = [list(r.generated) for r in run_all(pmh, router, ps, 6)]
            assert got == _single_streams(pmh, "fp32", sampling, ps, 6)
            wait_for(lambda: router.health()["replicas"]["ragent"]["kv_free_blocks"] == 64,
                     msg="agent KV pool to drain back")
            assert router.health()["kv_transport"]["endpoints"]["p0"]["staged_now"] == 0
        finally:
            try:
                router.shutdown()
            finally:
                if proc2 is not None:
                    _reap_clean(proc2)
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.communicate(timeout=10)
        for e in engs:
            assert e.state_manager.free_blocks == 64, "parent pool leaked"


# ---------------------------------------------------------------------------
# the agent child (``python -S -m tests.test_torch_multihost agent ...``):
# the EngineCore + ReplicaAgent stack ``serve-agent --join`` runs, over the
# tiny model's weights read from the parent's npz; it imports no JAX
# ---------------------------------------------------------------------------
def _fill(template, leaves):
    """``template``'s tree with its leaves replaced, in flatten order."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import tree_leaves

    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return torch.as_tensor(np.asarray(next(it))).to(t.dtype)

    out = walk(template)
    assert next(it, None) is None and len(tree_leaves(template)) == len(leaves)
    return out


def _agent_child_main(argv):
    host, port, name, spec = argv[:4]
    spec = json.loads(spec)
    from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
        TorchCheckpointEngine,
    )
    from deepspeed_tpu_torch.serving.cluster import EngineCore, ReplicaAgent
    from deepspeed_tpu_torch.serving.metrics import ServingMetrics

    torch.set_num_threads(1)
    cfg = T.TransformerConfig(**spec["model"])
    template = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = _fill(template, TorchCheckpointEngine().load(spec["weights"])["params"])
    engine = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig.from_dict(spec["engine"]),
                               device="cpu")
    engine.set_sampling(**spec["sampling"])
    core = EngineCore(engine, name=name, role="decode", metrics=ServingMetrics())
    agent = ReplicaAgent(core, (host, int(port)), name=name, stats_interval_s=0.05,
                         poll_interval_s=0.001)
    try:
        rc = agent.run()
    except KeyboardInterrupt:
        agent.close()
        rc = 0
    print(json.dumps({"rc": rc, "jax_loaded": "jax" in sys.modules,
                      "free_blocks": engine.state_manager.free_blocks,
                      "handoffs_in": core.handoffs_in}), flush=True)
    return rc


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "agent":
        sys.exit(_agent_child_main(sys.argv[2:]))
    sys.exit("usage: python -S -m tests.test_torch_multihost agent HOST PORT NAME SPEC_JSON")
