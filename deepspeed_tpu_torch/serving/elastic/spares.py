"""Warm spare engines: pay kernel builds at spawn, not at scale-up.

Copy of ``deepspeed_tpu/serving/elastic/spares.py`` over the port's
engine, whose ``trace_signature`` counts the kernel libraries the process
has built or loaded (eager PyTorch compiles nothing per step shape).

A cold engine admitted into the fleet would build or load its kernels on
the first real request — seconds of latency exactly when the control loop
scaled up because latency was already bad. A warm spare runs
``engine.warm_trace()`` at spawn (a throwaway prompt driven through every
step kind the serving loop will use, then scrubbed from the caches),
records the signature, and parks. Scale-up then just wires the engine
into the router — and ``assert_no_new_traces`` pins that admission built
or loaded NO new kernel library.
"""

import threading
from typing import Callable, Dict, List, Optional


def trace_signature(engine) -> Dict[str, int]:
    """Snapshot of the engine's ``trace_signature``: in the port, one entry
    per kernel library built or loaded. Engines without one (compute-free
    fakes) yield an empty signature."""
    fn = getattr(engine, "trace_signature", None)
    if fn is not None:
        return dict(fn())
    return {}


def assert_no_new_traces(engine, baseline: Dict[str, int],
                         label: str = "engine") -> None:
    """Raise if the signature grew since ``baseline`` was taken — the
    warm-spare admission contract (scale-up is wiring, never building)."""
    now = trace_signature(engine)
    grew = sorted(
        f"{k}: {baseline.get(k, 0)} -> {v}"
        for k, v in now.items()
        if v > baseline.get(k, 0)
    )
    if grew:
        raise RuntimeError(
            f"{label}: {len(grew)} step program(s) or kernel(s) built after warm-up: "
            + "; ".join(grew)
        )


class WarmSparePool:
    """Standby engines for scale-up. ``factory`` builds a fresh engine;
    every engine entering the pool (spawned or released back by a
    scale-down) is warmed before it becomes acquirable.

    ``warm_kw`` forwards the serving loop's step knobs (``decode_steps``,
    ``spec_k``) to ``warm_trace`` so the spare launches EXACTLY the
    kernels the router's cores will run."""

    def __init__(
        self,
        factory: Optional[Callable[[], object]] = None,
        count: int = 0,
        warm_kw: Optional[dict] = None,
    ):
        self._factory = factory
        self._warm_kw = dict(warm_kw or {})
        self._lock = threading.Lock()
        self._spares: List[object] = []
        self.spawned = 0
        self.warmed = 0
        for _ in range(int(count)):
            self.add(self._spawn())

    def _spawn(self):
        if self._factory is None:
            raise ValueError("WarmSparePool: count > 0 needs a factory")
        eng = self._factory()
        self.spawned += 1
        return eng

    def warm(self, engine) -> Dict[str, int]:
        """Drive the engine's step kinds once; returns the post-warm
        signature (the baseline scale-up asserts against)."""
        warm = getattr(engine, "warm_trace", None)
        if warm is not None:
            warm(**self._warm_kw)
            self.warmed += 1
        return trace_signature(engine)

    def add(self, engine) -> None:
        """Warm an engine and park it (spawn-time and scale-down both land
        here). The signature rides on the engine so acquire() hands back a
        matched (engine, baseline) pair."""
        engine._warm_signature = self.warm(engine)
        with self._lock:
            self._spares.append(engine)

    def acquire(self):
        """Pop a warm spare → (engine, baseline signature); (None, None)
        when the pool is empty (the caller may cold-spawn or skip)."""
        with self._lock:
            if not self._spares:
                return None, None
            eng = self._spares.pop()
        return eng, dict(getattr(eng, "_warm_signature", {}) or {})

    @property
    def available(self) -> int:
        with self._lock:
            return len(self._spares)
