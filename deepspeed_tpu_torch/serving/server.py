"""Stdlib-only HTTP front end for the serving driver.

Endpoints (the MII/FastGen RESTful surface, minus the gRPC layer):

  * ``POST /generate`` — body ``{"prompt": str | "tokens": [int], ...}``.
    With ``"stream": true`` the response is chunked (one piece per decode
    round: text when a tokenizer is loaded, else one token id per line);
    otherwise the full completion returns as one JSON object.
  * ``GET /health``  — driver liveness + queue/KV occupancy JSON.
  * ``GET /metrics`` — Prometheus text exposition (ServingMetrics).
  * ``GET /debug/trace`` — tracing index (enabled, active uids, retained
    trace summaries).  ``?uid=N`` returns one request's span tree as a
    Chrome-trace JSON document; ``?format=chrome`` dumps every retained
    trace plus the engine ring and control events (what ``dstpu trace
    dump`` fetches and Perfetto opens).
  * ``GET /debug/events`` — recent control-plane events, newest first.

No framework, no sockets beyond ``http.server``: the handler is a thin
adapter over ``ServingDriver.submit`` + ``TokenStream``, so everything
interesting is testable without binding a port (see ``parse_generate``)
and the server itself is one ``ThreadingHTTPServer`` away.

Copy of ``deepspeed_tpu/serving/server.py``.
"""

import json
import socket
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.observability import (
    get_event_log,
    get_tracer,
    to_chrome_trace,
    trace_to_chrome,
)
from deepspeed_tpu_torch.serving.driver import RequestRejected, ServingDriver
from deepspeed_tpu_torch.serving.request import SamplingParams
from deepspeed_tpu_torch.serving.streaming import IncrementalDetokenizer
from deepspeed_tpu_torch.utils.logging import logger


def parse_generate(body: dict, tokenizer=None) -> Tuple[np.ndarray, SamplingParams, bool, Optional[float]]:
    """Validate a /generate JSON body → (prompt_tokens, params, stream,
    timeout_s). Raises ValueError with a client-facing message."""
    if not isinstance(body, dict):
        raise ValueError("request body must be a JSON object")
    if "tokens" in body:
        prompt = np.asarray(body["tokens"], np.int32).reshape(-1)
    elif "prompt" in body:
        if tokenizer is None:
            raise ValueError("server has no tokenizer: send \"tokens\" instead of \"prompt\"")
        prompt = tokenizer.encode(str(body["prompt"]))
    else:
        raise ValueError("body needs \"prompt\" (text) or \"tokens\" (ids)")
    if len(prompt) == 0:
        raise ValueError("empty prompt")
    spec = body.get("spec")
    if spec is not None and not isinstance(spec, dict):
        raise ValueError('"spec" must be an object, e.g. {"enabled": true, "k": 4}')
    try:
        params = SamplingParams(
            max_new_tokens=int(body.get("max_new_tokens", 64)),
            eos_token_id=body.get("eos_token_id"),
            ignore_eos=bool(body.get("ignore_eos", False)),
            stop_token_ids=tuple(body.get("stop_token_ids", ())),
            spec=spec,
            qos=str(body.get("qos", "standard")),
            tenant=str(body.get("tenant", "default")),
            trace_id=(str(body["trace_id"]) if body.get("trace_id") is not None else None),
        )
    except TypeError as e:  # unknown spec key → client error, not a 500
        raise ValueError(f"bad spec params: {e}")
    stream = bool(body.get("stream", False))
    timeout_s = body.get("timeout_s")
    if timeout_s is not None:
        timeout_s = float(timeout_s)
        if timeout_s <= 0:
            raise ValueError("timeout_s must be positive")
    return prompt, params, stream, timeout_s


def make_handler(driver: ServingDriver, tokenizer=None):
    """Build the request-handler class bound to one driver instance."""

    class ServingHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through our logger
            logger.debug("serving-http: " + fmt % args)

        # -- helpers ----------------------------------------------------
        def _json(self, code: int, obj: dict, headers: Optional[dict] = None):
            payload = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            for name, value in (headers or {}).items():
                self.send_header(name, str(value))
            self.end_headers()
            self.wfile.write(payload)

        def _chunk(self, data: bytes):
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

        def _end_chunks(self):
            self.wfile.write(b"0\r\n\r\n")

        # -- endpoints ---------------------------------------------------
        def do_GET(self):
            url = urllib.parse.urlsplit(self.path)
            if url.path == "/health":
                self._json(200, driver.health())
            elif url.path == "/metrics":
                text = driver.metrics.prometheus_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(text)))
                self.end_headers()
                self.wfile.write(text)
            elif url.path == "/debug/trace":
                self._debug_trace(urllib.parse.parse_qs(url.query))
            elif url.path == "/debug/events":
                log = get_event_log()
                self._json(200, {**log.stats(), "events": log.recent()})
            else:
                self._json(404, {"error": f"no such path {self.path}"})

        def _debug_trace(self, query: dict):
            tracer = get_tracer()
            uid_q = query.get("uid", [None])[0]
            if uid_q is not None:
                try:
                    uid = int(uid_q)
                except ValueError:
                    self._json(400, {"error": f"bad uid {uid_q!r}"})
                    return
                trace = tracer.trace(uid)
                if trace is None:
                    self._json(404, {"error": f"no trace for uid {uid}"})
                    return
                self._json(200, trace_to_chrome(trace))
            elif query.get("format", [None])[0] == "chrome":
                self._json(200, to_chrome_trace(tracer=tracer, event_log=get_event_log()))
            else:
                active = tracer.active_keys() if tracer.enabled else []
                self._json(200, {
                    "enabled": tracer.enabled,
                    "stats": tracer.stats(),
                    "active": active,
                    "completed": tracer.recent(),
                })

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": f"no such path {self.path}"})
                return
            tracer = get_tracer()
            t_parse0 = tracer.now() if tracer.enabled else 0.0
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                prompt, params, stream, timeout_s = parse_generate(body, tokenizer)
            except (ValueError, json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
                return
            t_parse1 = tracer.now() if tracer.enabled else 0.0
            try:
                req = driver.submit(prompt, params=params, timeout_s=timeout_s)
            except RequestRejected as e:
                code = 503 if e.reason in ("queue_full", "draining", "shed") else 400
                out = {"error": str(e), "reason": e.reason}
                headers = {}
                if code == 503 and e.retry_after_s is not None:
                    # RFC 7231 delay-seconds (integral, at least 1)
                    retry = max(1, int(round(e.retry_after_s)))
                    out["retry_after_s"] = retry
                    headers["Retry-After"] = retry
                self._json(code, out, headers=headers)
                return
            if req.trace is not None:
                # parse happened just before submit rooted the tree, so
                # this slice sits a hair left of the root in the timeline
                tracer.complete("server.parse", t_parse0, t_parse1,
                                key=req.uid, parent=req.trace.root,
                                args={"bytes": length})
            if stream:
                self._stream_response(req)
            else:
                req.wait()
                out = {
                    "uid": req.uid,
                    "finish_reason": req.finish_reason,
                    "tokens": [int(t) for t in req.generated],
                }
                if tokenizer is not None:
                    out["text"] = tokenizer.decode(req.generated)
                if req.error:
                    out["error"] = req.error
                self._json(200, out)

        def _stream_response(self, req):
            self.send_response(200)
            ctype = "text/plain; charset=utf-8" if tokenizer is not None else "application/jsonl"
            self.send_header("Content-Type", ctype)
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("X-Request-Uid", str(req.uid))
            self.end_headers()
            detok = IncrementalDetokenizer(tokenizer) if tokenizer is not None else None
            try:
                for tok in req.stream:
                    if detok is not None:
                        piece = detok.push(tok)
                        if piece:
                            self._chunk(piece.encode())
                    else:
                        self._chunk(json.dumps({"token": int(tok)}).encode() + b"\n")
                if detok is not None:
                    tail = detok.flush()
                    if tail:
                        self._chunk(tail.encode())
                self._end_chunks()
            except (BrokenPipeError, ConnectionResetError):
                driver.cancel(req.uid)  # client went away: free the KV blocks

    return ServingHandler


class ServingHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


def start_server(
    driver: ServingDriver, host: str = "127.0.0.1", port: int = 8000, tokenizer=None
) -> ServingHTTPServer:
    """Bind and serve in a daemon thread; returns the server (its bound port
    is ``server.server_address[1]`` — pass port 0 for an ephemeral one)."""
    server = ServingHTTPServer((host, port), make_handler(driver, tokenizer))
    t = threading.Thread(target=server.serve_forever, name="serving-http", daemon=True)
    t.start()
    return server


def get_free_port(host: str = "127.0.0.1") -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]
