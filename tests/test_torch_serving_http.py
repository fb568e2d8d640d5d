"""The port's HTTP front end and ``serve`` command against the JAX
package's, on the CPU.

Each test starts one server per package on an ephemeral loopback port and
compares what a client reads: ``/generate`` bodies (plain and streamed
chunk by chunk), ``/health``, ``/metrics`` (parsed as Prometheus text),
the ``/debug/trace`` family and the error responses. ``FakeEngine`` (from
``tests/test_torch_serving.py``) gives deterministic tokens; the real
engines are the tiny model of ``tests/test_torch_spec_decode.py`` on
identical weights, compared token for token (exact). The ``serve``
command's stack is built from parsed arguments on that model in memory;
the multi-engine and cross-process flags build the router, ``--tp`` above
1 is refused naming ROADMAP queue 1, item 6. Every server and driver is shut down in a ``finally``
and every socket read has a timeout.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import chip_smoke
from deepspeed_tpu.inference import cli as jcli
from deepspeed_tpu.serving import server as jserver
from deepspeed_tpu_torch.inference import cli as pcli
from deepspeed_tpu_torch.serving import server as pserver
from tests.test_torch_serving import JAX, PORT, WAIT_S, FakeEngine, engines, on_both, real_prompts


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SERVER = {"deepspeed_tpu": jserver, "deepspeed_tpu_torch": pserver}


class WordTok:
    eos_token_id = 0

    def encode(self, text):
        return np.asarray([len(w) for w in text.split()], np.int32)

    def decode(self, ids):
        return " ".join("x" * int(i) for i in ids)


def _get(url):
    with urllib.request.urlopen(url, timeout=WAIT_S) as r:
        return r.read()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return dict(r.headers), r.read()


def _error(fn):
    with pytest.raises(urllib.error.HTTPError) as ei:
        fn()
    return ei.value.code, json.loads(ei.value.read())


class Served:
    """A started driver behind a started server; both shut down on exit."""

    def __init__(self, ns, driver, tokenizer=None, start=True):
        self.driver = driver
        if start:
            driver.start()
        self.server = None
        try:
            self.server = SERVER[ns.root].start_server(driver, host="127.0.0.1", port=0,
                                                       tokenizer=tokenizer)
        except BaseException:
            driver.shutdown(drain=False, timeout=WAIT_S)
            raise
        host, port = self.server.server_address[:2]
        self.base = f"http://{host}:{port}"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            self.server.shutdown()
            self.server.server_close()
        finally:
            self.driver.shutdown(drain=False, timeout=WAIT_S)


# ---------------------------------------------------------------------------
# request parsing
# ---------------------------------------------------------------------------
class TestParseGenerate:
    def test_tokens_and_prompt_paths(self):
        def scenario(ns):
            prompt, params, stream, timeout = SERVER[ns.root].parse_generate(
                {"tokens": [1, 2, 3], "max_new_tokens": 7, "stream": True, "timeout_s": 2.5,
                 "stop_token_ids": [9], "ignore_eos": True, "qos": "interactive",
                 "tenant": "acme", "trace_id": "ext-7f3a", "spec": {"k": 2}})
            with pytest.raises(ValueError, match="tokens"):
                SERVER[ns.root].parse_generate({"prompt": "hi"}, tokenizer=None)
            text_prompt = SERVER[ns.root].parse_generate({"prompt": "aa bbb"},
                                                         tokenizer=WordTok())[0]
            return (prompt.dtype.str, prompt.tolist(), params.max_new_tokens,
                    params.stop_token_ids, params.ignore_eos, params.qos, params.tenant,
                    params.trace_id, (params.spec.enabled, params.spec.k), stream, timeout,
                    text_prompt.tolist())

        got = on_both(scenario)
        assert got[1] == [1, 2, 3] and got[-1] == [2, 3] and got[-2] == 2.5

    @pytest.mark.parametrize("body", [
        [1, 2], {}, {"tokens": []}, {"tokens": [1], "timeout_s": -1},
        {"tokens": [1], "qos": "platinum"}, {"tokens": [1], "trace_id": "a\nb"},
        {"tokens": [1], "tenant": 'x"}\ninjected 1'}, {"tokens": [1], "spec": 3},
        {"tokens": [1], "spec": {"depth": 2}},
    ], ids=["list", "empty", "no_tokens", "timeout", "qos", "trace_id", "tenant", "spec",
            "spec_key"])
    def test_invalid_bodies(self, body):
        def scenario(ns):
            with pytest.raises(ValueError) as ei:
                SERVER[ns.root].parse_generate(body)
            return str(ei.value)

        on_both(scenario)


# ---------------------------------------------------------------------------
# the endpoints over a real socket
# ---------------------------------------------------------------------------
class TestServingHTTP:
    def test_real_socket_round_trip(self):
        """/health, plain and streamed /generate, /metrics, 400 and 404."""

        def scenario(ns):
            eng = FakeEngine(ns)
            with Served(ns, ns.ServingDriver(eng, max_queue=16)) as s:
                health = json.loads(_get(f"{s.base}/health"))
                _, plain = _post(f"{s.base}/generate",
                                 {"tokens": [5, 6], "max_new_tokens": 4, "ignore_eos": True})
                headers, streamed = _post(f"{s.base}/generate",
                                          {"tokens": [20], "max_new_tokens": 3,
                                           "ignore_eos": True, "stream": True})
                metrics = chip_smoke.parse_prometheus(_get(f"{s.base}/metrics").decode())
                bad = _error(lambda: _post(f"{s.base}/generate", {}))
                missing = _error(lambda: _get(f"{s.base}/nope"))
            assert set(health.pop("events")) == {"total", "retained", "dropped"}
            counters = {k: v for k, v in metrics.items() if k.endswith("_total")}
            return (health, json.loads(plain), headers["Transfer-Encoding"],
                    headers["Content-Type"], streamed, counters, bad, missing)

        health, plain, te, ctype, streamed, counters, bad, missing = on_both(scenario)
        assert health["status"] == "ok" and health["kv_total_blocks"] == 256
        assert plain["finish_reason"] == "max_tokens" and plain["tokens"] == [7, 8, 9, 10]
        assert te == "chunked" and ctype == "application/jsonl"
        assert [json.loads(line)["token"] for line in streamed.splitlines()] == [21, 22, 23]
        assert counters["dstpu_serving_requests_finished_total"] == 2
        assert bad[0] == 400 and missing[0] == 404

    def test_text_prompts_stream_detokenized_pieces(self):
        def scenario(ns):
            with Served(ns, ns.ServingDriver(FakeEngine(ns), max_queue=4),
                        tokenizer=WordTok()) as s:
                _, plain = _post(f"{s.base}/generate",
                                 {"prompt": "aa bbb", "max_new_tokens": 2, "ignore_eos": True})
                headers, streamed = _post(f"{s.base}/generate",
                                          {"prompt": "a", "max_new_tokens": 3,
                                           "ignore_eos": True, "stream": True})
            return json.loads(plain), headers["Content-Type"], streamed

        plain, ctype, streamed = on_both(scenario)
        assert plain["tokens"] == [4, 5] and plain["text"] == "xxxx xxxxx"
        assert ctype.startswith("text/plain") and streamed

class TestOverloadResponses:
    def test_queue_full_503(self):
        """A driver whose queue is full (never started, so its occupancy is
        fixed) answers 503 with the rejection's reason."""

        def scenario(ns):
            driver = ns.ServingDriver(FakeEngine(ns), max_queue=1)
            driver.submit(np.asarray([1], np.int32))
            with Served(ns, driver, start=False) as s:
                return _error(lambda: _post(f"{s.base}/generate",
                                            {"tokens": [5], "max_new_tokens": 2}))

        code, body = on_both(scenario)
        assert code == 503 and body["reason"] == "queue_full"

class TestDebugTraceEndpoints:
    def test_debug_trace_index_dump_and_events(self):
        def scenario(ns):
            o = ns.observability
            o.set_tracer(o.SpanTracer())
            try:
                with Served(ns, ns.ServingDriver(FakeEngine(ns), max_queue=16)) as s:
                    _, out = _post(f"{s.base}/generate",
                                   {"tokens": [9], "max_new_tokens": 3, "ignore_eos": True,
                                    "trace_id": "ext-42"})
                    out = json.loads(out)
                    index = json.loads(_get(f"{s.base}/debug/trace"))
                    doc = json.loads(_get(f"{s.base}/debug/trace?uid={out['uid']}"))
                    full = json.loads(_get(f"{s.base}/debug/trace?format=chrome"))
                    e404 = _error(lambda: _get(f"{s.base}/debug/trace?uid=999999"))
                    e400 = _error(lambda: _get(f"{s.base}/debug/trace?uid=nope"))
                    o.log_event("shed_level", level=1, prev=0)
                    events = json.loads(_get(f"{s.base}/debug/events"))
            finally:
                o.set_tracer(o.NULL_TRACER)
                o.get_event_log().clear()
            assert o.validate_chrome_trace(doc) == [] and o.validate_chrome_trace(full) == []
            names = sorted((e["name"], e["ph"]) for e in doc["traceEvents"])
            root = next(e for e in doc["traceEvents"] if e["name"] == "request")
            return (out["tokens"], index["enabled"], index["stats"]["completed_traces"],
                    [c["key"] for c in index["completed"]], names, root["args"]["trace_id"],
                    e404[0], e400[0], events["events"][0]["kind"],
                    len(full["traceEvents"]) >= len(doc["traceEvents"]))

        got = on_both(scenario)
        assert got[0] == [10, 11, 12] and got[1] is True and got[5] == "ext-42"
        names = {n for n, ph in got[4] if ph == "X"}
        assert {"request", "server.parse", "queued", "prefill", "decode"} <= names
        assert got[6:9] == (404, 400, "shed_level")

    def test_debug_trace_reports_disabled_when_off(self):
        def scenario(ns):
            ns.observability.set_tracer(ns.observability.NULL_TRACER)
            with Served(ns, ns.ServingDriver(FakeEngine(ns), max_queue=4), start=False) as s:
                return json.loads(_get(f"{s.base}/debug/trace"))

        index = on_both(scenario)
        assert index["enabled"] is False and index["completed"] == []


class TestServingRealEngineHTTP:
    @pytest.mark.parametrize("case", ["fused4", "int8_spec"])
    def test_generate_bodies_and_chunks_match_jax(self, case):
        """Concurrent clients, half streamed: every /generate body and every
        streamed chunk from the port's server equals the JAX server's, and
        the stream equals the port engine's ``generate()``."""
        import threading

        over, dkw = {
            "fused4": ({"decode_steps": 4}, {"decode_steps": 4}),
            "int8_spec": ({"spec_k": 4, "kv_cache": {"block_size": 8, "num_blocks": 64,
                                                     "max_blocks_per_seq": 12,
                                                     "kv_cache_dtype": "int8"}}, {}),
        }[case]
        je, pe = engines(**over)
        ps = real_prompts()

        def scenario(ns, eng):
            bodies = [None] * len(ps)
            errors = []
            with Served(ns, ns.ServingDriver(eng, **dkw)) as s:
                def client(i):
                    try:
                        bodies[i] = _post(f"{s.base}/generate", {
                            "tokens": ps[i].tolist(), "max_new_tokens": 8,
                            "ignore_eos": True, "stream": i % 2 == 1})[1]
                    except Exception as e:  # surfaced below
                        errors.append(e)

                threads = [threading.Thread(target=client, args=(i,)) for i in range(len(ps))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(WAIT_S)
                assert not errors, errors
                health = json.loads(_get(f"{s.base}/health"))
            return [b.decode() for b in bodies], health["kv_free_blocks"]

        jb, jfree = scenario(JAX, je)
        pb, pfree = scenario(PORT, pe)
        strip = lambda b: {k: v for k, v in json.loads(b).items() if k != "uid"}  # noqa: E731
        for i, (j, p) in enumerate(zip(jb, pb)):
            if i % 2:
                assert p == j  # the chunks' payloads, line for line
            else:
                assert strip(p) == strip(j)
        assert pfree == jfree == 64
        want = engines(**over)[1].generate(ps, max_new_tokens=8)
        for i, (p, w) in enumerate(zip(pb, want)):
            toks = ([json.loads(line)["token"] for line in p.splitlines()] if i % 2
                    else json.loads(p)["tokens"])
            assert toks == [int(t) for t in w[len(ps[i]):]]


# ---------------------------------------------------------------------------
# the serve command
# ---------------------------------------------------------------------------
SERVE_ARGV = ["--model", "", "--port", "0", "--dtype", "float32", "--num-blocks", "64",
              "--block-size", "8", "--max-blocks-per-seq", "12", "--max-context", "96",
              "--decode-steps", "4", "--kv-headroom", "0.0"]


class TestServeCommand:
    def test_build_serving_stack_serves_like_jax(self):
        """``build_serving_stack`` from parsed serve arguments on the tiny
        model in memory (prefix cache on, as the command defaults):
        /generate answers the JAX stack's tokens, after ``warm_trace``."""
        import dataclasses

        import jax

        from deepspeed_tpu_torch.models import transformer as PT
        from deepspeed_tpu_torch.models.convert import params_from_numpy
        from tests import test_torch_spec_decode as sd

        jcfg, jp = sd._jax_params(0)
        stacks = {
            "deepspeed_tpu": jcli.build_serving_stack(
                jcli.serve_parse_args(SERVE_ARGV), cfg=dataclasses.replace(jcfg), params=jp,
                tok=None),
            "deepspeed_tpu_torch": pcli.build_serving_stack(
                pcli.serve_parse_args(SERVE_ARGV + ["--device", "cpu"]),
                cfg=PT.TransformerConfig(**sd.MODEL),
                params=params_from_numpy(jax.tree.map(np.asarray, jp)), tok=None),
        }
        ps = real_prompts()

        def scenario(ns):
            driver, _ = stacks[ns.root]
            outs = []
            with Served(ns, driver) as s:
                for p in ps + ps[:1]:  # the repeat hits the prefix cache
                    outs.append(json.loads(_post(f"{s.base}/generate", {
                        "tokens": p.tolist(), "max_new_tokens": 6, "ignore_eos": True})[1]))
                prefix = json.loads(_get(f"{s.base}/health"))["kv_free_blocks"]
            return [(o["tokens"], o["finish_reason"]) for o in outs], prefix

        outs, _ = on_both(scenario)
        assert outs[0] == outs[-1] and all(len(t) == 6 for t, _ in outs)
        eng = stacks["deepspeed_tpu_torch"][0].engine
        assert eng.device == torch.device("cpu") and eng.trace_signature() == {}

    @pytest.mark.parametrize("flags", [
        ["--num-decode-replicas", "2"], ["--num-prefill-workers", "1"],
        ["--max-decode-replicas", "3"], ["--resilience"], ["--control-port", "0"],
    ], ids=["replicas", "prefill", "elastic", "resilience", "control"])
    def test_multi_engine_flags_name_item_5(self, flags):
        """Each multi-engine form builds the router with the cross-process
        pieces (ROADMAP queue 1, item 5, now ported): ``--control-port``
        parses as the JAX package's does and the router serves the control
        plane (``serve_main`` binds it); ``--kv-transport remote`` registers
        every prefill worker's KV endpoint at construction."""
        from deepspeed_tpu_torch.serving import Router
        from tests import test_torch_spec_decode as sd

        base = sd.port_engine()
        for extra in (["--control-port", "0"], ["--kv-transport", "remote"]):
            args = pcli.serve_parse_args(SERVE_ARGV + ["--device", "cpu"] + flags + extra)
            jargs = jcli.serve_parse_args(SERVE_ARGV + flags + extra)
            assert (args.control_port, args.control_host, args.kv_transport) == (
                jargs.control_port, jargs.control_host, jargs.kv_transport)
            front, _ = pcli.build_serving_stack(args, cfg=base._mc, params=base.params, tok=None)
            try:
                # --control-port alone is one engine: the driver, which has no
                # control plane (serve_main refuses it, as the JAX command does)
                assert isinstance(front, Router) == (flags != ["--control-port", "0"])
                if not isinstance(front, Router):
                    assert not hasattr(front, "serve_control")
                    continue
                addr = front.serve_control("127.0.0.1", 0)
                h = front.health()
                assert h["control_plane"]["enabled"] and h["control_plane"]["address"] == list(addr)
                assert h["kv_transport"]["transport"] == args.kv_transport
                workers = [c.name for c in front.prefill]
                assert sorted(h["kv_transport"]["endpoints"]) == (
                    workers if args.kv_transport == "remote" else [])
            finally:
                front.shutdown(drain=False)

    @pytest.mark.parametrize("flags", [
        ["--placement", "least_loaded"], ["--kv-transport", "remote"],
        ["--shed-reject-at", "0.5"], ["--hung-step-s", "1"], ["--control-host", "0.0.0.0"],
    ], ids=["placement", "transport", "shed", "hung", "control-host"])
    def test_router_tuning_flags_are_not_parsed(self, flags, capsys):
        """The flags that only tune the router parse now, as the JAX
        package's do, and keep their value; an unknown choice is an
        argparse error, never a silent default."""
        jargs = jcli.serve_parse_args(SERVE_ARGV + flags)
        args = pcli.serve_parse_args(SERVE_ARGV + flags)
        dest = flags[0].lstrip("-").replace("-", "_")
        assert getattr(args, dest) == getattr(jargs, dest)
        if dest in ("placement", "kv_transport"):
            with pytest.raises(SystemExit):
                pcli.serve_parse_args(SERVE_ARGV + [flags[0], "bogus"])
            assert "invalid choice" in capsys.readouterr().err

    def test_refusals(self):
        """``serve-agent`` wants ``--join HOST:PORT`` (2 otherwise); ``--tp``
        above 1 stays refused for serve and serve-agent, naming item 6; the
        agent and the remote core are ``serving.cluster``'s names, not
        ``serving``'s, as in the JAX package."""
        assert pcli.main(["serve-agent", "--model", "x", "--join", "nohost"]) == 2
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 6"):
            pcli.build_serving_stack(pcli.serve_parse_args(SERVE_ARGV + ["--tp", "2"]))
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 6"):
            pcli.build_agent_core(pcli.serve_agent_parse_args(
                SERVE_ARGV + ["--tp", "2", "--join", "127.0.0.1:1"]))
        with pytest.raises(ValueError, match="num_prefill_workers"):
            pcli.build_serving_stack(pcli.serve_parse_args(
                SERVE_ARGV + ["--num-prefill-workers", "-1"]))
        import deepspeed_tpu.serving as jserving
        import deepspeed_tpu_torch.serving as serving
        import deepspeed_tpu_torch.serving.cluster as cluster
        from deepspeed_tpu_torch.serving.cluster.agent import ReplicaAgent
        from deepspeed_tpu_torch.serving.cluster.remote_core import RemoteEngineHandle

        assert (cluster.ReplicaAgent, cluster.RemoteEngineHandle) == (ReplicaAgent,
                                                                      RemoteEngineHandle)
        for name in ("ReplicaAgent", "RemoteEngineHandle"):
            assert hasattr(serving, name) == hasattr(jserving, name) is False
        with pytest.raises(AttributeError):
            serving.NoSuchName  # noqa: B018
