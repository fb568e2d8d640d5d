"""Pull a timeline from a serving endpoint (the JAX package's ``dstpu trace``).

    python -m deepspeed_tpu_torch.observability.cli dump --url http://127.0.0.1:8000 \\
        --out dstpu.trace.json
    python -m deepspeed_tpu_torch.observability.cli dump --uid 3 --out req3.trace.json

The output validates against the Chrome-trace schema and opens in
https://ui.perfetto.dev or ``chrome://tracing``.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.request

from deepspeed_tpu_torch.observability.export import validate_chrome_trace

__all__ = ["trace_main"]


def _fetch_json(url: str, timeout: float):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def trace_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.observability.cli",
        description="dump request/engine timelines from a serving endpoint")
    sub = ap.add_subparsers(dest="cmd")
    dump = sub.add_parser("dump", help="fetch a Chrome-trace JSON timeline")
    dump.add_argument("--url", default="http://127.0.0.1:8000",
                      help="serving endpoint base URL")
    dump.add_argument("--uid", type=int, default=None,
                      help="dump one request's span tree (default: everything)")
    dump.add_argument("--out", default="dstpu.trace.json",
                      help="output path (open in Perfetto)")
    dump.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)
    if args.cmd is None:
        ap.print_help()
        return 2

    base = args.url.rstrip("/")
    if args.uid is not None:
        url = f"{base}/debug/trace?uid={args.uid}"
    else:
        url = f"{base}/debug/trace?format=chrome"
    try:
        doc = _fetch_json(url, args.timeout)
    except urllib.error.HTTPError as e:
        print(f"trace dump: {url} -> HTTP {e.code} {e.reason}", file=sys.stderr)
        return 1
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"trace dump: {url} -> {e}", file=sys.stderr)
        return 1

    errs = validate_chrome_trace(doc)
    if errs:
        print("trace dump: endpoint returned an invalid Chrome-trace "
              "document:", file=sys.stderr)
        for e in errs[:10]:
            print(f"  - {e}", file=sys.stderr)
        return 1

    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(doc, f, separators=(",", ":"))
    n = len(doc.get("traceEvents", []))
    print(f"wrote {args.out}: {n} events (open in https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(trace_main(sys.argv[1:]))
