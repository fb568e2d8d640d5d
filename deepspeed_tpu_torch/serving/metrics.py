"""Serving telemetry: latency histograms, throughput counters, KV gauges.

The metric set is the FastGen/MII serving dashboard: TTFT (time to first
token — prefill + queueing), TPOT (time per output token — decode cadence),
e2e latency, queue depth, KV-block occupancy, and prefill-vs-decode token
throughput. Two sinks share one source: ``prometheus_text()`` renders the
text exposition for the HTTP ``/metrics`` endpoint, and ``to_events()``
bridges the same numbers into the ``monitor.Monitor`` writer interface
(TensorBoard/W&B/CSV/Comet/Prometheus-textfile) so serving telemetry lands
next to training telemetry.

Copy of ``deepspeed_tpu/serving/metrics.py``.
"""

import threading
from typing import Dict, List, Optional, Tuple

from deepspeed_tpu_torch.monitor.monitor import (
    prometheus_metric_name,
    render_prometheus_text,
)

# Latency buckets in seconds (log-ish spacing from 1 ms to 2 min): one set
# serves TTFT, TPOT, and e2e — cross-metric comparability beats per-metric
# tightness for dashboards.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

# Accepted-draft-tokens-per-verify-round buckets: small integers (a round
# accepts 0..K drafts; K is single digits in practice).
SPEC_ACCEPT_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0)


def _safe_rate(value: float) -> float:
    """Clamp a ratio gauge to a finite number: 0.0 in place of NaN/inf.
    A hit rate before any query (0/0) must render as 0.0 in ``/metrics``
    and ``health()``, not poison the JSON/exposition with NaN."""
    v = float(value)
    if v != v or v == float("inf") or v == float("-inf"):
        return 0.0
    return v


class Histogram:
    """Prometheus-style cumulative histogram (counts per le-bucket + sum)."""

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf bucket
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper bound of the bucket holding the
        q-th observation) — good enough for bench reporting."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for i, b in enumerate(self.buckets):
            seen += self.counts[i]
            if seen >= target:
                return b
        # target lands in the +Inf bucket: clamp to the largest finite
        # edge (mirrors _safe_rate) so bench JSON and /metrics-derived
        # reports stay finite
        return self.buckets[-1] if self.buckets else 0.0

    def prom_samples(self, name: str) -> List[Tuple]:
        out = []
        cum = 0
        for i, b in enumerate(self.buckets):
            cum += self.counts[i]
            # bucket bounds are python floats, no device sync
            out.append((f"{name}_bucket", {"le": repr(float(b))}, cum, "histogram"))  # dstpu: noqa[host-sync-in-loop]
        out.append((f"{name}_bucket", {"le": "+Inf"}, self.count, "histogram"))
        out.append((f"{name}_sum", None, self.total, None))
        out.append((f"{name}_count", None, self.count, None))
        return out


class ServingMetrics:
    """Thread-safe registry the driver and server write into."""

    PREFIX = "dstpu_serving"

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self._lock = threading.Lock()
        self.ttft = Histogram(buckets)
        self.tpot = Histogram(buckets)
        self.e2e = Histogram(buckets)
        # accepted draft tokens per sequence per verify round (spec decode)
        self.spec_accepted = Histogram(SPEC_ACCEPT_BUCKETS)
        # per-handoff wall time (export dispatch -> import landed), all
        # transports folded into one histogram; the per-transport split
        # lives in the labeled _handoffs family
        self.handoff_seconds = Histogram(buckets)
        self.counters: Dict[str, float] = {
            "requests_submitted_total": 0,
            "requests_rejected_total": 0,
            "requests_finished_total": 0,
            "requests_cancelled_total": 0,
            "requests_timed_out_total": 0,
            "requests_failed_total": 0,
            "prefill_tokens_total": 0,
            "decode_tokens_total": 0,
            "engine_steps_total": 0,
            "admission_blocked_total": 0,
            # prefix cache (mirrors of PrefixCache's monotone counters)
            "prefix_queries_total": 0,
            "prefix_hits_total": 0,
            "prefix_hit_tokens_total": 0,
            "prefix_inserted_blocks_total": 0,
            "prefix_evictions_total": 0,
            # tiered KV host store (HostBlockStore.stats() rollup) + the
            # router's cross-replica prefix pulls
            "kv_host_tier_hits_total": 0,
            "kv_host_tier_misses_total": 0,
            "kv_host_tier_spills_total": 0,
            "kv_host_tier_readmits_total": 0,
            "kv_host_tier_evictions_total": 0,
            "prefix_peer_pulls_total": 0,
            "prefix_peer_pull_blocks_total": 0,
            # speculative decoding
            "spec_rounds_total": 0,
            "spec_draft_tokens_total": 0,
            "spec_accepted_tokens_total": 0,
            # elastic control plane: QoS preemption + shedding + scaling
            "requests_preempted_total": 0,
            "requests_resumed_total": 0,
            "requests_shed_total": 0,
            "scale_up_total": 0,
            "scale_down_total": 0,
            # fault tolerance: replica health transitions and request
            # recovery (checkpoint = KV export reused, replay = prompt +
            # generated resubmitted), plus bounded transfer retries
            "replica_failures_total": 0,
            "replica_quarantines_total": 0,
            "replica_probes_total": 0,
            "replica_probe_failures_total": 0,
            "requests_recovered_total": 0,
            "recovery_checkpoints_total": 0,
            "recovery_replays_total": 0,
            "handoff_retries_total": 0,
            "peer_pull_retries_total": 0,
            # handoffs abandoned after export (retries exhausted or the
            # request terminated mid-flight) — pairs with the inflight-
            # window gauge unwind in handoff_aborted()
            "kv_handoff_aborts_total": 0,
        }
        self.gauges: Dict[str, float] = {
            "queue_depth": 0,
            "active_requests": 0,
            "kv_free_blocks": 0,
            "kv_total_blocks": 0,
            "kv_blocks_in_use": 0,
            "kv_occupancy": 0.0,
            # KV-pool byte accounting (engine.kv_pool_info): payload dtype
            # as a 0/1 int8 flag, allocated HBM bytes, and the effective
            # block-capacity multiplier vs a bf16 pool at the same budget
            "kv_cache_int8": 0,
            "kv_pool_bytes": 0,
            "kv_capacity_multiplier": 1.0,
            # quantized-collectives flag (engine.comm_wire_info); per-wire
            # byte counters render as labeled comm_wire_* samples
            "comm_quant_int8": 0,
            "prefix_cached_blocks": 0,
            "prefix_cached_blocks_idle": 0,
            "prefix_hit_rate": 0.0,
            # host tier occupancy (bytes/blocks resident right now)
            "kv_host_tier_bytes": 0,
            "kv_host_tier_blocks": 0,
            "kv_host_tier_budget_bytes": 0,
            "kv_host_tier_hit_rate": 0.0,
            "spec_acceptance_rate": 0.0,
            "spec_mean_accepted_per_round": 0.0,
            # elastic control plane: live decode fleet size, parked warm
            # spares, and the degradation ladder's current rung (0..3)
            "decode_replicas": 0,
            "warm_spares": 0,
            "shed_level": 0,
            # KV handoff transport: in-flight export windows of the most
            # recent pipelined (device-transport) handoff — 0 for host /
            # in_process handoffs, which ship one monolithic payload
            "kv_handoff_inflight_windows": 0,
        }
        # per-wire collective byte accounting (comm.quantized.wire_stats
        # via engine.comm_wire_info): tag -> {sites, wire_bytes_int8,
        # wire_bytes_fp, reduction}; trace-time counts per compiled site
        self._comm_wires: Dict[str, Dict[str, float]] = {}
        # per-replica gauge snapshots (disaggregated serving): name ->
        # (role, {stat: value}); rendered as replica=/role=-labeled
        # dstpu_serving_replica_* samples. The unlabeled kv_*/queue/latency
        # gauges stay the router-level rollup.
        self._replicas: Dict[str, Tuple[str, Dict[str, float]]] = {}
        # per-(tenant, qos-tier) accounting: finished/preempted/shed
        # counters, live queue depth, and a TTFT sum/count pair; rendered
        # as tenant=/tier=-labeled dstpu_serving_tier_* samples so a burst
        # trace can prove WHO was shed and WHOSE latency was protected.
        self._tiers: Dict[Tuple[str, str], Dict[str, float]] = {}
        # per-transport KV handoff accounting (disagg prefill->decode
        # moves): transport -> {handoffs, bytes, chunks}; rendered as
        # transport=-labeled dstpu_serving_kv_handoff_* samples so an A/B
        # (host vs device wire) shows up as two label rows, not a reset
        self._handoffs: Dict[str, Dict[str, float]] = {}

    # -- writers ---------------------------------------------------------
    def inc(self, name: str, delta: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + delta

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def observe_request(self, req) -> None:
        """Fold a TERMINAL request's latencies in (whatever stamps exist)."""
        with self._lock:
            if req.ttft_s is not None:
                self.ttft.observe(req.ttft_s)
            if req.tpot_s is not None:
                self.tpot.observe(req.tpot_s)
            if req.e2e_s is not None:
                self.e2e.observe(req.e2e_s)

    def observe_trace(self, req) -> None:
        """Histogram bridge from SPAN endpoints, for traced requests.

        The trace helpers stamp phase boundaries with the request's own
        monotonic stamps, so this folds numbers numerically identical to
        ``observe_request`` (a unit test asserts it) — but when tracing
        is on the span tree is the source of truth, so the timeline view
        and the histogram view cannot drift apart.  Falls back to
        ``observe_request`` when the request carries no trace.
        """
        ctx = getattr(req, "trace", None)
        if ctx is None:
            self.observe_request(req)
            return
        t_submit = ctx.root.t0
        t_first = ctx.t_first
        t_finish = ctx.root.t1 if ctx.root.t1 is not None else req.t_finish
        with self._lock:
            if t_first is not None:
                self.ttft.observe(t_first - t_submit)
            if t_first is not None and t_finish is not None:
                n = len(req.generated) - 1
                if n >= 1:
                    self.tpot.observe((t_finish - t_first) / n)
            if t_finish is not None:
                self.e2e.observe(t_finish - t_submit)

    def update_kv(self, free_blocks: int, total_blocks: int) -> None:
        with self._lock:
            self.gauges["kv_free_blocks"] = free_blocks
            self.gauges["kv_total_blocks"] = total_blocks
            self.gauges["kv_blocks_in_use"] = max(0, total_blocks - free_blocks)
            if total_blocks:
                self.gauges["kv_occupancy"] = 1.0 - free_blocks / total_blocks

    def update_kv_pool_info(self, info: Dict[str, float]) -> None:
        """Mirror an ``engine.kv_pool_info()`` snapshot (static per engine,
        set once at driver start)."""
        with self._lock:
            self.gauges["kv_cache_int8"] = int(
                info.get("kv_cache_dtype") == "int8"
            )
            self.gauges["kv_pool_bytes"] = info.get("kv_pool_bytes", 0)
            self.gauges["kv_capacity_multiplier"] = info.get(
                "kv_capacity_multiplier", 1.0
            )

    def update_comm_quant(self, info: Dict) -> None:
        """Mirror an ``engine.comm_wire_info()`` snapshot: the comm_quant /
        comm_overlap modes as 0/1 gauges plus the per-wire trace-time
        counters (quantized vs replaced full-width bytes, the derived
        reduction ratio the A/B gate checks, and the tile-granular overlap
        factor each wire decomposed into)."""
        with self._lock:
            self.gauges["comm_quant_int8"] = int(info.get("comm_quant") == "int8")
            self.gauges["comm_overlap_tiled"] = int(
                info.get("comm_overlap") == "tiled"
            )
            self._comm_wires = {
                tag: dict(v) for tag, v in (info.get("wires") or {}).items()
            }

    def update_replica(
        self, name: str, stats: Dict[str, float], role: str = "both",
        remote: bool = False,
    ) -> None:
        """Per-replica gauge snapshot (disaggregated serving): KV blocks,
        resident requests, handoff/decode tallies for ONE engine, labeled
        ``replica=name`` / ``role=...`` / ``remote=...`` in the exposition
        (``remote="1"`` marks a replica served by a cross-process agent).
        Non-numeric entries are dropped (labels carry the strings)."""
        clean = {}
        for k, v in stats.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            clean[k] = v * 1.0
        with self._lock:
            self._replicas[name] = (str(role), bool(remote), clean)

    def replica_snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {name: dict(st)
                    for name, (_role, _remote, st) in self._replicas.items()}

    def _tier_cell(self, tenant: str, tier: str) -> Dict[str, float]:
        """Caller holds the lock."""
        key = (str(tenant), str(tier))
        cell = self._tiers.get(key)
        if cell is None:
            cell = self._tiers[key] = {
                "finished_total": 0.0,
                "preempted_total": 0.0,
                "shed_total": 0.0,
                "queue_depth": 0.0,
                "ttft_sum_s": 0.0,
                "ttft_count": 0.0,
            }
        return cell

    def observe_tier(self, tenant: str, tier: str, stat: str,
                     delta: float = 1.0) -> None:
        """Bump one per-(tenant, tier) counter (``finished_total``,
        ``preempted_total``, ``shed_total``) or fold a TTFT sample in
        (``stat="ttft_s"``, delta = the latency)."""
        with self._lock:
            cell = self._tier_cell(tenant, tier)
            if stat == "ttft_s":
                cell["ttft_sum_s"] += float(delta)  # dstpu: noqa[host-sync-in-loop] host wall-clock float, not a device scalar
                cell["ttft_count"] += 1.0
            else:
                cell[stat] = cell.get(stat, 0.0) + float(delta)  # dstpu: noqa[host-sync-in-loop] host counter delta, not a device scalar

    def set_tier_queue_depth(self, depths: Dict[Tuple[str, str], int]) -> None:
        """Replace the per-(tenant, tier) queue-depth gauges with a fresh
        census (cells absent from ``depths`` drop to 0 — a drained tier
        must not keep reporting its burst-time depth)."""
        with self._lock:
            for cell in self._tiers.values():
                cell["queue_depth"] = 0.0
            for (tenant, tier), depth in depths.items():
                self._tier_cell(tenant, tier)["queue_depth"] = float(depth)  # dstpu: noqa[host-sync-in-loop] host int census, not a device scalar

    def tier_snapshot(self) -> Dict[Tuple[str, str], Dict[str, float]]:
        with self._lock:
            return {key: dict(cell) for key, cell in self._tiers.items()}

    def update_prefix_cache(self, stats: Dict[str, float]) -> None:
        """Mirror a ``PrefixCache.stats()`` snapshot. The source counters
        are monotone, so assigning (not incrementing) keeps Prometheus
        counter semantics."""
        with self._lock:
            self.counters["prefix_queries_total"] = stats["queries"]
            self.counters["prefix_hits_total"] = stats["hits"]
            self.counters["prefix_hit_tokens_total"] = stats["hit_tokens"]
            self.counters["prefix_inserted_blocks_total"] = stats["inserted_blocks"]
            self.counters["prefix_evictions_total"] = stats["evictions"]
            self.gauges["prefix_cached_blocks"] = stats["cached_blocks"]
            self.gauges["prefix_cached_blocks_idle"] = stats["cached_blocks_idle"]
            # the source computes hits/queries; guard the 0/0 (and any
            # NaN that leaks through a zero-query snapshot) to 0.0
            self.gauges["prefix_hit_rate"] = _safe_rate(stats["hit_rate"])

    def update_host_tier(self, stats: Dict[str, float]) -> None:
        """Mirror a ``HostBlockStore.stats()`` snapshot (or a cross-replica
        sum of them, from the router rollup). Counters are monotone at the
        source, so assignment keeps Prometheus counter semantics."""
        with self._lock:
            self.gauges["kv_host_tier_bytes"] = stats.get("bytes", 0)
            self.gauges["kv_host_tier_blocks"] = stats.get("blocks", 0)
            self.gauges["kv_host_tier_budget_bytes"] = stats.get("budget_bytes", 0)
            hits = stats.get("hits", 0)
            misses = stats.get("misses", 0)
            self.counters["kv_host_tier_hits_total"] = hits
            self.counters["kv_host_tier_misses_total"] = misses
            self.counters["kv_host_tier_spills_total"] = stats.get("spills", 0)
            self.counters["kv_host_tier_readmits_total"] = stats.get("readmits", 0)
            self.counters["kv_host_tier_evictions_total"] = stats.get("evictions", 0)
            probes = hits + misses
            self.gauges["kv_host_tier_hit_rate"] = (
                _safe_rate(hits / probes) if probes else 0.0
            )

    def observe_spec_round(self, per_uid: Dict[int, Tuple[int, int]]) -> None:
        """Fold one verify round's (drafted, accepted) per sequence into the
        spec counters/histogram and refresh the derived gauges."""
        with self._lock:
            for drafted, accepted in per_uid.values():
                self.counters["spec_draft_tokens_total"] += drafted
                self.counters["spec_accepted_tokens_total"] += accepted
                self.spec_accepted.observe(float(accepted))  # dstpu: noqa[host-sync-in-loop] host int, not a device scalar
            self.counters["spec_rounds_total"] += 1
            drafted_total = self.counters["spec_draft_tokens_total"]
            if drafted_total:
                self.gauges["spec_acceptance_rate"] = (
                    self.counters["spec_accepted_tokens_total"] / drafted_total
                )
            self.gauges["spec_mean_accepted_per_round"] = self.spec_accepted.mean

    def observe_handoff(self, transport: str, nbytes: int = 0,
                        seconds: Optional[float] = None,
                        inflight_windows: int = 0) -> None:
        """Fold one completed KV handoff in: bytes moved over the chosen
        transport, end-to-end wall time (export dispatch -> import
        landed), and — for the pipelined device wire — how many chunked
        export windows were in flight."""
        with self._lock:
            cell = self._handoffs.setdefault(
                str(transport), {"handoffs": 0.0, "bytes": 0.0, "chunks": 0.0}
            )
            cell["handoffs"] += 1.0
            cell["bytes"] += float(nbytes)
            cell["chunks"] += float(inflight_windows)
            if seconds is not None:
                self.handoff_seconds.observe(float(seconds))
            self.gauges["kv_handoff_inflight_windows"] = float(inflight_windows)

    def handoff_aborted(self, transport: str) -> None:
        """Unwind one handoff that will never land (import retries
        exhausted, or the request died mid-flight). The inflight-window
        gauge MUST return to zero here: an aborted import unwound its
        pool blocks, so windows it claimed are no longer in flight — a
        nonzero residue after an abort is the credit leak the resilience
        suite asserts against."""
        with self._lock:
            self.counters["kv_handoff_aborts_total"] += 1
            cell = self._handoffs.setdefault(
                str(transport), {"handoffs": 0.0, "bytes": 0.0, "chunks": 0.0}
            )
            cell["aborts"] = cell.get("aborts", 0.0) + 1.0
            self.gauges["kv_handoff_inflight_windows"] = 0.0

    def handoff_snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {t: dict(cell) for t, cell in self._handoffs.items()}

    # -- readers ---------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self.counters)
            out.update(self.gauges)
            out["ttft_mean_s"] = self.ttft.mean
            out["tpot_mean_s"] = self.tpot.mean
            out["e2e_mean_s"] = self.e2e.mean
            for tag, w in self._comm_wires.items():
                out[f"comm_wire_{tag}_reduction"] = w.get("reduction", 0.0)
                out[f"comm_wire_{tag}_tiles"] = w.get("tiles", 1)
            for transport, cell in self._handoffs.items():
                for key, value in cell.items():
                    out[f"kv_handoff_{transport}_{key}"] = value
            out["kv_handoff_seconds_mean"] = self.handoff_seconds.mean
            for name, (_role, _remote, st) in self._replicas.items():
                for key, value in st.items():
                    out[f"replica_{name}_{key}"] = value
            for (tenant, tier), cell in self._tiers.items():
                for key, value in cell.items():
                    out[f"tier_{tenant}_{tier}_{key}"] = value
            return out

    def prometheus_text(self) -> str:
        p = self.PREFIX
        with self._lock:
            samples = []
            for name in sorted(self.counters):
                samples.append((f"{p}_{name}", None, self.counters[name], "counter"))
            for name in sorted(self.gauges):
                samples.append((f"{p}_{name}", None, self.gauges[name], "gauge"))
            for tag in sorted(self._comm_wires):
                w = self._comm_wires[tag]
                lbl = {"wire": tag}
                samples.append((f"{p}_comm_wire_sites", lbl, w.get("sites", 0), "gauge"))
                samples.append((f"{p}_comm_wire_bytes_quant", lbl, w.get("wire_bytes_int8", 0), "gauge"))
                samples.append((f"{p}_comm_wire_bytes_fp", lbl, w.get("wire_bytes_fp", 0), "gauge"))
                samples.append((f"{p}_comm_wire_reduction", lbl, w.get("reduction", 0.0), "gauge"))
                samples.append((f"{p}_comm_wire_tiles", lbl, w.get("tiles", 1), "gauge"))
            for transport in sorted(self._handoffs):
                cell = self._handoffs[transport]
                lbl = {"transport": transport}
                samples.append((f"{p}_kv_handoff_total", lbl, cell["handoffs"], "counter"))
                samples.append((f"{p}_kv_handoff_bytes", lbl, cell["bytes"], "counter"))
                samples.append((f"{p}_kv_handoff_chunks_total", lbl, cell["chunks"], "counter"))
                samples.append((f"{p}_kv_handoff_aborts_total", lbl, cell.get("aborts", 0.0), "counter"))
            for name in sorted(self._replicas):
                role, remote, st = self._replicas[name]
                lbl = {"replica": name, "role": role,
                       "remote": "1" if remote else "0"}
                for key in sorted(st):
                    samples.append((f"{p}_replica_{key}", lbl, st[key], "gauge"))
            for tenant, tier in sorted(self._tiers):
                cell = self._tiers[(tenant, tier)]
                lbl = {"tenant": tenant, "tier": tier}
                for key in sorted(cell):
                    kind = "counter" if key.endswith("_total") else "gauge"
                    samples.append((f"{p}_tier_{key}", lbl, cell[key], kind))
            for hname, hist in (
                ("ttft_seconds", self.ttft),
                ("tpot_seconds", self.tpot),
                ("e2e_latency_seconds", self.e2e),
                ("spec_accepted_per_round", self.spec_accepted),
                ("kv_handoff_seconds", self.handoff_seconds),
            ):
                samples.extend(hist.prom_samples(f"{p}_{hname}"))
        return render_prometheus_text(samples)

    def to_events(self, step: Optional[int] = None) -> List[Tuple]:
        """The Monitor-writer bridge: (name, value, step) triples. ``step``
        defaults to the finished-request count (a monotone serving clock)."""
        with self._lock:
            if step is None:
                step = int(self.counters["requests_finished_total"])
            events = []
            for name, value in {**self.counters, **self.gauges}.items():
                events.append((f"Serving/{name}", value, step))
            for hname, hist in (
                ("ttft_s", self.ttft),
                ("tpot_s", self.tpot),
                ("e2e_s", self.e2e),
                ("spec_accepted_per_round", self.spec_accepted),
                ("kv_handoff_s", self.handoff_seconds),
            ):
                if hist.count:
                    events.append((f"Serving/{hname}_mean", hist.mean, step))
                    events.append((f"Serving/{hname}_p95", hist.quantile(0.95), step))
            for transport, cell in self._handoffs.items():
                for key, value in cell.items():
                    events.append(
                        (f"Serving/kv_handoff_{transport}_{key}", value, step))
            # labeled families, flattened the same way snapshot() does, so
            # replica and tenant/tier telemetry reaches the file-backed
            # writers (CSV/TensorBoard/...) and not just /metrics
            for name, (_role, _remote, st) in self._replicas.items():
                for key, value in st.items():
                    events.append((f"Serving/replica_{name}_{key}", value, step))
            for (tenant, tier), cell in self._tiers.items():
                for key, value in cell.items():
                    events.append(
                        (f"Serving/tier_{tenant}_{tier}_{key}", value, step))
            return events


# re-export for callers that want consistent naming with the monitor sink
__all__ = [
    "DEFAULT_BUCKETS",
    "SPEC_ACCEPT_BUCKETS",
    "Histogram",
    "ServingMetrics",
    "prometheus_metric_name",
    "_safe_rate",
]
