"""Rank topology of the port: the named-axis grid over torch.distributed.

Counterpart of ``deepspeed_tpu/parallel/topology.py``. The JAX package lays
its devices out as a ``jax.sharding.Mesh`` with named axes; here the same
axes, in the same order (``MESH_AXES``, outermost first), lay out the
torch.distributed ranks: ``arange(world).reshape(shape)``, as the JAX file
reshapes its device array. Each axis (and the data x context pair the
engine reduces gradients over) gets one process group, made at
construction by every rank in the same order.

Two forms, and two counts kept apart:

  * the process form (the default): one rank per process.
    ``world_size`` (the grid's rank count) equals the process count of the
    initialized process group; collectives run through ``comm``;
  * the loopback form (``loopback=True``): one process holds every rank of
    the grid, as the JAX package's tests hold N virtual devices in one
    process. ``world_size`` is the grid's size, ``process_count`` is 1, no
    collective runs, and the ring attention drives its N context ranks in
    lock-step inside the process. Reached only by passing such a Topology
    (``set_topology`` or ``initialize(mpu=...)``), never from a config.

The engine reduces across processes only (``process_count``). Data and
context may be above 1; every other axis above 1 raises (ROADMAP queue 1,
item 6).
"""

from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

# Canonical axis names, outermost first (the JAX package's order)
PIPE_AXIS = "pipe"
DATA_AXIS = "data"
ZERO_AXIS = "zero"
EXPERT_AXIS = "expert"
CONTEXT_AXIS = "context"
SEQUENCE_AXIS = "sequence"
MODEL_AXIS = "model"
MESH_AXES = (
    PIPE_AXIS, DATA_AXIS, ZERO_AXIS, EXPERT_AXIS, CONTEXT_AXIS, SEQUENCE_AXIS,
    MODEL_AXIS,
)
# Axis set that jointly shards the batch dimension (DP world).
BATCH_AXES = (DATA_AXIS, ZERO_AXIS, EXPERT_AXIS)
# Axes that ZeRO partitions parameters/optimizer state over (full dp).
ZERO_AXES = (DATA_AXIS, ZERO_AXIS)
# The axes this port runs above 1; the engine sums gradients over both.
PORTED_AXES = (DATA_AXIS, CONTEXT_AXIS)

Axes = Union[str, Sequence[str]]


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


class Topology:
    """A named-axis rank grid with DeepSpeed-style size queries."""

    def __init__(
        self,
        data: int = 0,
        model: int = 1,
        pipe: int = 1,
        sequence: int = 1,
        expert: int = 1,
        zero: int = 1,
        context: int = 1,
        loopback: bool = False,
        timeout: Optional[timedelta] = None,
    ):
        sizes = {PIPE_AXIS: pipe, DATA_AXIS: data, ZERO_AXIS: zero, EXPERT_AXIS: expert,
                 CONTEXT_AXIS: context, SEQUENCE_AXIS: sequence, MODEL_AXIS: model}
        big = {a: s for a, s in sizes.items() if a not in PORTED_AXES and s and int(s) > 1}
        if big:
            raise NotImplementedError(
                f"Topology: axes {big} above 1 are not ported yet (only data and context "
                "are; ROADMAP queue 1, item 6: multi-GPU)")
        dist = _dist()
        self.loopback = bool(loopback)
        procs = 1 if self.loopback or dist is None else dist.get_world_size()
        fixed = int(np.prod([int(s) for a, s in sizes.items() if a != DATA_AXIS]))
        if data in (0, None) and self.loopback:
            data = 1
        elif data in (0, None):
            if procs % fixed:
                raise ValueError(f"process count {procs} not divisible by "
                                 f"model*pipe*context*sequence*expert*zero={fixed}")
            data = procs // fixed
        sizes[DATA_AXIS] = int(data)
        self.sizes: Dict[str, int] = {a: int(sizes[a]) for a in MESH_AXES}
        world = int(np.prod(list(self.sizes.values())))
        if not self.loopback and world != procs:
            raise ValueError(
                f"mesh sizes {self._live() or 'single-rank'} do not multiply to the process "
                f"count {procs} (one rank per process; for N ranks in one process pass "
                "loopback=True)")
        self.process_count = procs
        self.rank = 0 if self.loopback or dist is None else dist.get_rank()
        self.ranks = np.arange(world).reshape(tuple(self.sizes[a] for a in MESH_AXES))
        # axes key -> (process group, its global ranks in group order)
        self._groups: Dict[Tuple[str, ...], tuple] = {}
        if self.process_count > 1:
            live = [a for a in PORTED_AXES if self.sizes[a] > 1]
            keys = [(a,) for a in live] + ([tuple(live)] if len(live) > 1 else [])
            for key in keys:
                for row in self._rows(key):
                    pg = dist.new_group(row, timeout=timeout)
                    if self.rank in row:
                        self._groups[key] = (pg, row)

    def _live(self):
        return {a: s for a, s in self.sizes.items() if s > 1}

    def _rows(self, key):
        """Global rank lists of every group over the axes ``key``, each in
        the order of the axes' coordinates (outer axis first)."""
        idx = [MESH_AXES.index(a) for a in key]
        other = [i for i in range(len(MESH_AXES)) if i not in idx]
        n = int(np.prod([self.sizes[a] for a in key]))
        return [list(map(int, r)) for r in
                np.transpose(self.ranks, other + idx).reshape(-1, n)]

    def _key(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in MESH_AXES]
        if unknown:
            raise ValueError(f"Topology: unknown axes {unknown}; axes are {MESH_AXES}")
        return tuple(a for a in MESH_AXES if a in axes and self.sizes[a] > 1)

    # ---- the JAX package's size queries ----
    @property
    def world_size(self) -> int:
        """Ranks of the grid (virtual ones too, in the loopback form)."""
        return int(self.ranks.size)

    def axis_size(self, axis: Axes) -> int:
        return int(np.prod([self.sizes[a] for a in self._key(axis)]))

    @property
    def dp_world_size(self) -> int:
        """Data-parallel world (batch shards): data x zero x expert axes."""
        return self.sizes[DATA_AXIS] * self.sizes[ZERO_AXIS] * self.sizes[EXPERT_AXIS]

    @property
    def data_parallel_size(self) -> int:
        return self.sizes[DATA_AXIS] * self.sizes[ZERO_AXIS]

    @property
    def zero_shard_size(self) -> int:
        return self.sizes[ZERO_AXIS]

    @property
    def model_parallel_size(self) -> int:
        return self.sizes[MODEL_AXIS]

    tensor_parallel_size = model_parallel_size

    @property
    def pipe_parallel_size(self) -> int:
        return self.sizes[PIPE_AXIS]

    @property
    def sequence_parallel_size(self) -> int:
        return self.sizes[SEQUENCE_AXIS]

    @property
    def context_parallel_size(self) -> int:
        """Ring (context-parallel) degree: shards the sequence dim itself."""
        return self.sizes[CONTEXT_AXIS]

    @property
    def expert_parallel_size(self) -> int:
        return self.sizes[EXPERT_AXIS]

    # ---- the process form ----
    @property
    def distributed(self) -> bool:
        """True when the grid spans more than one process."""
        return self.process_count > 1

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Coordinate of ``rank`` (default: this process) on every axis."""
        r = self.rank if rank is None else rank
        pos = np.argwhere(self.ranks == r)[0]
        return {a: int(i) for a, i in zip(MESH_AXES, pos)}

    def axis_index(self, axes: Axes) -> int:
        """This process's index along ``axes`` (0 in the loopback form,
        whose one process holds every index)."""
        c = self.coords()
        idx = 0
        for a in self._key(axes):
            idx = idx * self.sizes[a] + c[a]
        return idx if self.distributed else 0

    def group(self, axes: Axes):
        """(process group, global ranks in axis order) over ``axes`` for
        this process, or None where the group is this process alone."""
        key = self._key(axes)
        if not key or not self.distributed:
            return None
        if key not in self._groups:
            raise NotImplementedError(
                f"Topology: no process group over {key} (the port groups {PORTED_AXES}; "
                "ROADMAP queue 1, item 6)")
        return self._groups[key]

    def __repr__(self):
        form = "loopback" if self.loopback else f"processes={self.process_count}"
        return f"Topology(world={self.world_size}, {self._live() or 'single-rank'}, {form})"


_TOPOLOGY: Optional[Topology] = None


def set_topology(topo: Topology):
    global _TOPOLOGY
    _TOPOLOGY = topo


def get_topology() -> Topology:
    global _TOPOLOGY
    if _TOPOLOGY is None:
        _TOPOLOGY = Topology()
    return _TOPOLOGY


def reset_topology():
    global _TOPOLOGY
    _TOPOLOGY = None
