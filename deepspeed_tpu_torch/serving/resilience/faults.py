"""Deterministic fault injection for the serving cluster.

Copy of ``deepspeed_tpu/serving/resilience/faults.py`` (stdlib only). The
port's engine, core, handoff, router and wire (``serving/net/``) check
every site.

The chaos harness is a *seam*, not a framework: the serving hot paths
call ``get_fault_injector().check(site, replica=...)`` at a small set of
named sites, and the default injector is a no-op whose ``check`` is one
attribute test — production pays an ``if faults.enabled`` per site and
nothing else. Tests (and the bench/smoke chaos gates) install a
:class:`FaultInjector` carrying an explicit schedule: *the Nth arrival at
site S (optionally on replica R) raises* (or, for hang specs, sleeps
through the step watchdog's deadline). Arrival counting is the only
state, so a given (schedule, workload) pair replays the exact same
failures every run — chaos tests run on CPU with zero real faults and
bit-exact expectations.

Sites (the full set — a spec naming anything else is a typo, loudly):

  * ``handoff.export``   — prefill worker exporting a finished prefill
  * ``handoff.import``   — target replica importing a handoff OR a
    preemption/recovery checkpoint (resume is the same import path)
  * ``engine.step``      — inside ``EngineCore.step_once`` before the
    engine runs (also consumed by probation probes, so a scheduled
    probe-time fault deterministically fails the probe)
  * ``host_tier.readmit``— engine host-tier re-import during seeding
  * ``peer_pull``        — router prefix-directory peer pull
  * ``worker.crash``     — top of a router worker-thread iteration
  * ``step.hang``        — sleeps ``hang_s`` inside the step window so
    the watchdog sees a wedged step (the spec's kind is forced to
    ``"hang"``)
  * ``net.connect``      — remote KV importer dialing the exporter's
    endpoint (before the socket opens)
  * ``net.send``         — remote KV exporter about to send a chunk
    window (one arrival per window, so nth selects which window dies)
  * ``net.recv``         — remote KV importer about to read the next
    frame off the wire (one arrival per frame)
"""

import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

__all__ = [
    "SITES",
    "InjectedFault",
    "FaultSpec",
    "NullFaultInjector",
    "FaultInjector",
    "seeded_schedule",
    "get_fault_injector",
    "set_fault_injector",
    "inject",
]

SITES = (
    "handoff.export",
    "handoff.import",
    "engine.step",
    "host_tier.readmit",
    "peer_pull",
    "worker.crash",
    "step.hang",
    "net.connect",
    "net.send",
    "net.recv",
)


class InjectedFault(RuntimeError):
    """A scheduled chaos fault fired. Carries its site/replica so tests
    can assert exactly which injection produced which recovery."""

    def __init__(self, site: str, replica: Optional[str], nth: int):
        super().__init__(
            f"injected fault at {site}"
            + (f" on {replica}" if replica else "")
            + f" (arrival #{nth})"
        )
        self.site = site
        self.replica = replica
        self.nth = nth


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire on the ``nth`` arrival at ``site``
    (counted per replica when ``replica`` is set, globally otherwise)."""

    site: str
    nth: int = 1
    replica: Optional[str] = None
    kind: str = "error"  # "error" | "hang"
    hang_s: float = 0.2

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r} (one of {sorted(SITES)})"
            )
        if self.nth < 1:
            raise ValueError(f"nth must be >= 1, got {self.nth}")
        if self.site == "step.hang":
            object.__setattr__(self, "kind", "hang")
        if self.kind not in ("error", "hang"):
            raise ValueError(f"kind must be 'error' or 'hang', got {self.kind!r}")
        if self.hang_s < 0:
            raise ValueError(f"hang_s must be >= 0, got {self.hang_s}")


class NullFaultInjector:
    """The production injector: every check is a no-op."""

    enabled = False

    def check(self, site: str, replica: Optional[str] = None) -> None:
        return None

    def fired(self) -> List[dict]:
        return []

    def arrivals(self, site: str) -> int:
        return 0


class FaultInjector:
    """Schedule-driven injector. Thread-safe: sites are hit concurrently
    from worker/coordinator threads, and the arrival counters are the
    determinism anchor — they mutate under one lock."""

    enabled = True

    def __init__(self, schedule=()):
        self.schedule: Tuple[FaultSpec, ...] = tuple(
            s if isinstance(s, FaultSpec) else FaultSpec(**s) for s in schedule
        )
        self._lock = threading.Lock()
        self._site_count: Dict[str, int] = {}
        self._pair_count: Dict[Tuple[str, str], int] = {}
        self._fired: List[dict] = []

    def check(self, site: str, replica: Optional[str] = None) -> None:
        """Count one arrival at ``site`` and fire any matching spec:
        hang specs sleep (inside the caller's step window), error specs
        raise :class:`InjectedFault`."""
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}")
        hang_s = 0.0
        fire: Optional[Tuple[FaultSpec, int]] = None
        with self._lock:
            n_site = self._site_count[site] = self._site_count.get(site, 0) + 1
            n_pair = n_site
            if replica is not None:
                key = (site, replica)
                n_pair = self._pair_count[key] = self._pair_count.get(key, 0) + 1
            for spec in self.schedule:
                if spec.site != site:
                    continue
                if spec.replica is None:
                    if spec.nth != n_site:
                        continue
                elif spec.replica != replica or spec.nth != n_pair:
                    continue
                self._fired.append({
                    "site": site, "replica": replica, "nth": spec.nth,
                    "kind": spec.kind, "t": time.monotonic(),
                })
                if spec.kind == "hang":
                    hang_s = max(hang_s, spec.hang_s)
                else:
                    fire = (spec, spec.nth)
        if hang_s > 0:
            time.sleep(hang_s)
        if fire is not None:
            raise InjectedFault(site, replica, fire[1])

    def fired(self) -> List[dict]:
        with self._lock:
            return list(self._fired)

    def arrivals(self, site: str) -> int:
        with self._lock:
            return self._site_count.get(site, 0)


def seeded_schedule(
    seed: int,
    sites: Dict[str, int],
    max_nth: int = 8,
    replicas: Optional[List[str]] = None,
) -> List[FaultSpec]:
    """Derive a deterministic schedule from a seed: for each site, draw
    ``count`` distinct arrival indices in [1, max_nth] (and, when
    ``replicas`` is given, a replica per fault). Same seed → same
    schedule → same failures, run after run."""
    rng = random.Random(int(seed))
    out: List[FaultSpec] = []
    for site, count in sorted(sites.items()):
        nths = rng.sample(range(1, max_nth + 1), min(count, max_nth))
        for nth in sorted(nths):
            rep = rng.choice(replicas) if replicas else None
            out.append(FaultSpec(site=site, nth=nth, replica=rep))
    return out


_NULL = NullFaultInjector()
_INJECTOR = _NULL


def get_fault_injector():  # dstpu: returns[FaultInjector]
    # the contract comment tells the static lock model which locks a
    # `.check()` through this handle may take; the production
    # NullFaultInjector is lock-free, so FaultInjector is the upper bound
    return _INJECTOR


def set_fault_injector(injector=None):
    """Install ``injector`` as the process-global seam (None restores the
    no-op). Returns the installed injector."""
    global _INJECTOR
    _INJECTOR = injector if injector is not None else _NULL
    return _INJECTOR


class inject:
    """Context manager for tests: install a schedule, restore on exit.

    >>> with inject(FaultSpec("engine.step", nth=3, replica="d0")) as inj:
    ...     run_workload()
    >>> assert inj.fired()
    """

    def __init__(self, *specs):
        self.injector = FaultInjector(specs)
        self._prev = None

    def __enter__(self) -> FaultInjector:
        self._prev = get_fault_injector()
        set_fault_injector(self.injector)
        return self.injector

    def __exit__(self, exc_type, exc, tb):
        set_fault_injector(self._prev if self._prev is not _NULL else None)
        return False
