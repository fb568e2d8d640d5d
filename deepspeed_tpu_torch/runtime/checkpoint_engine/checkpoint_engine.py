"""Pluggable checkpoint writers, in the port.

Counterpart of ``deepspeed_tpu/runtime/checkpoint_engine/checkpoint_engine.py``:
the ``CheckpointEngine`` interface with the synchronous ("sync"/"torch"),
async ("async"/"fast") and decoupled writers and the registry. The archive
layout is the JAX package's, so each package loads the other's files: one
``.npz`` of uncompressed ``section::000042.npy`` entries, leaves in the JAX
package's tree-flatten order (dicts by sorted key, named tuples by field),
and a ``.meta.json`` beside it. The async writers snapshot tensors to host
numpy first (the copy is the only part that must happen before the next
step updates them in place) and write in a background thread; ``commit()``
joins outstanding writes, and only then may the ``latest`` marker be
written (two-phase save/commit). Beside the archive each writer also puts
``.names.json``: every section's leaves as dotted paths, in archive order
(``tree_paths``), which ``checkpoint/zero_to_fp32.py`` reads; the JAX
package neither writes nor needs it.
"""

import io
import json
import mmap
import os
import queue
import struct
import threading
import zipfile
import zlib
from abc import ABC, abstractmethod
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


# queue marker: the producer aborted mid-save; the writer must discard the
# partial archive instead of finalizing it (AsyncCheckpointEngine.save)
_ABORT = object()


class CheckpointEngine(ABC):
    """The writers' interface: create/save/load/commit."""

    def __init__(self, config_params=None):
        self.config_params = config_params

    def create(self, tag: str):
        """Hook called at the start of a save under ``tag``."""

    @abstractmethod
    def save(self, state_dict: Dict[str, Any], path: str):
        ...

    @abstractmethod
    def load(self, path: str, map_location=None) -> Dict[str, Any]:
        ...

    @abstractmethod
    def commit(self, tag: str) -> bool:
        """Publish ``tag`` (write the latest marker) once durable."""

    def makedirs(self, path, exist_ok=True):
        os.makedirs(path, exist_ok=exist_ok)


# bf16 has no numpy dtype: the JAX package's arrays reach an archive as
# 2-byte void entries ('<V2'), so the port writes the same bytes under the
# same descr and reads them back through their raw bits
_BF16_NPY = np.dtype("V2")


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor (one copy: a device tensor's transfer is
    it); bf16 as 2-byte void elements."""
    src = t.detach()
    host = src.cpu().contiguous()
    if host.numel() and host.data_ptr() == src.data_ptr():
        host = host.clone()
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(_BF16_NPY)
    return host.numpy()


def numpy_to_tensor(a: np.ndarray) -> torch.Tensor:
    """The inverse: 2-byte void (or ml_dtypes bfloat16) arrays become bf16
    tensors through their bits. A writable contiguous array is shared, not
    copied (the archive reader hands out private mappings of the file)."""
    a = np.asarray(a)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a)
    if a.dtype == _BF16_NPY or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _snapshot_leaf(x):
    """Device -> host copy of ONE leaf (the only part of a save that must
    happen before the training step may overwrite the buffer in place)."""
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x)
    return np.asarray(x)


def tree_leaves(tree) -> list:
    """Leaves in the JAX package's flatten order: dict values by sorted key,
    tuples (named or not) and lists in order, None skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_paths(tree, prefix="") -> list:
    """Dotted paths of ``tree_leaves(tree)``, in the same order: dict keys,
    and sequence indices as the JAX package's ``zero_to_fp32._flatten``
    writes them."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_paths(tree[k], f"{prefix}.{k}" if prefix else str(k))]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree)
                for p in tree_paths(v, f"{prefix}.{i}" if prefix else str(i))]
    return [prefix]


def _iter_named_leaves(state_dict: Dict[str, Any]) -> Iterator[Tuple[str, Any]]:
    """Leaves in tree-flatten order under INDEX keys (``section::000042``):
    restore zips them back into the live template's leaves."""
    for k, v in state_dict.items():
        if k == "__meta__":
            continue
        for i, leaf in enumerate(tree_leaves(v)):
            yield f"{k}::{i:06d}", leaf


class _NpzStreamWriter:
    """Incremental npz writer: one uncompressed zip entry per leaf, written
    as it arrives. The archive matches ``np.savez`` layout (``np.load``
    reads it back), but peak host memory is ONE leaf, not the tree."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._zf = zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True)

    def write(self, name: str, arr: np.ndarray):
        with self._zf.open(f"{name}.npy", "w", force_zip64=True) as f:
            np.lib.format.write_array(f, np.asarray(arr), allow_pickle=False)

    def close(self):
        self._zf.close()


def _write_meta(base: str, meta, names=None):
    if meta is not None:
        with open(base + ".meta.json", "w") as f:  # read side strips .npz too
            json.dump(meta, f, default=_json_safe)
    if names is not None:
        with open(base + ".names.json", "w") as f:
            json.dump(names, f)


def _section_paths(state_dict: Dict[str, Any]) -> Dict[str, list]:
    return {k: tree_paths(v) for k, v in state_dict.items() if k != "__meta__"}


def _json_safe(obj):
    """Meta must round-trip: numpy scalars/arrays convert, anything else
    non-JSON fails AT SAVE TIME (default=str would silently stringify)."""
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray) or hasattr(obj, "tolist"):
        return np.asarray(obj).tolist()
    raise TypeError(f"client_state value of type {type(obj).__name__} is not JSON-serializable")


def _write_npz_streaming(state_dict: Dict[str, Any], path: str):
    """Synchronous bounded-memory save: snapshot → write → release, leaf at
    a time."""
    base = path[: -len(".npz")] if path.endswith(".npz") else path
    w = _NpzStreamWriter(base + ".npz")
    try:
        for name, leaf in _iter_named_leaves(state_dict):
            w.write(name, _snapshot_leaf(leaf))
    finally:
        w.close()
    _write_meta(base, state_dict.get("__meta__"), _section_paths(state_dict))


def _stored_array(mm, info: zipfile.ZipInfo) -> Optional[np.ndarray]:
    """A stored (uncompressed) ``.npy`` entry of a mapped archive as an
    array over the mapping itself, its CRC checked: no copy. None for a
    compressed entry."""
    if info.compress_type != zipfile.ZIP_STORED:
        return None
    off = info.header_offset
    name_len, extra_len = struct.unpack("<HH", mm[off + 26:off + 30])
    start = off + 30 + name_len + extra_len
    if zlib.crc32(memoryview(mm)[start:start + info.file_size]) != info.CRC:
        raise zipfile.BadZipFile(f"bad CRC in {info.filename}: the archive is damaged")
    head = io.BytesIO(mm[start:start + min(info.file_size, 1 << 17)])
    version = np.lib.format.read_magic(head)
    read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                   else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read_header(head)
    if dtype.hasobject:
        raise ValueError(f"{info.filename}: object arrays are not loaded")
    count = int(np.prod(shape, dtype=np.int64))
    arr = np.frombuffer(mm, dtype=dtype, count=count, offset=start + head.tell())
    return arr.reshape(shape, order="F" if fortran else "C")


def _read_npz(path: str) -> Dict[str, Any]:
    """Returns {section: [leaves in flatten order], '__meta__': dict,
    '__names__': {section: [dotted paths]}} (the last two when written).
    Stored entries (as both packages write them) are arrays over a private
    mapping of the file: pages are read when touched, once."""
    base = path[: -len(".npz")] if path.endswith(".npz") else path
    path = base + ".npz"
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    sections: Dict[str, list] = {}
    with zipfile.ZipFile(path) as zf:
        for info in zf.infolist():
            arr = _stored_array(mm, info)
            if arr is None:
                with zf.open(info) as member:
                    arr = np.lib.format.read_array(member, allow_pickle=False)
            key = info.filename[:-len(".npy")] if info.filename.endswith(".npy") else info.filename
            section, idx = key.split("::", 1)
            sections.setdefault(section, []).append((int(idx), arr))
    out: Dict[str, Any] = {
        k: [a for _, a in sorted(v)] for k, v in sections.items()
    }
    meta_path = base + ".meta.json"  # written next to base, not base.npz
    if os.path.isfile(meta_path):
        out["__meta__"] = json.load(open(meta_path))
    if os.path.isfile(base + ".names.json"):
        with open(base + ".names.json") as f:
            out["__names__"] = json.load(f)
    return out


class TorchCheckpointEngine(CheckpointEngine):
    """Synchronous engine: save blocks until the file is written; commit
    has nothing to join. Peak host memory: one leaf (streamed)."""

    def save(self, state_dict, path):
        _write_npz_streaming(state_dict, path)

    def load(self, path, map_location=None):
        return _read_npz(path)

    def commit(self, tag):
        return True


class AsyncCheckpointEngine(CheckpointEngine):
    """Pipelined background writer: ``save`` streams leaves through a
    BOUNDED queue, so the snapshot of leaf i+1 overlaps the serialization of
    leaf i and host memory is capped at ``QUEUE_DEPTH`` leaves instead of
    the whole tree. ``save`` returns once every leaf is SNAPSHOTTED (the
    next step may then update the device buffers in place); the final
    writes drain off-thread and ``commit`` joins them."""

    QUEUE_DEPTH = 4

    def __init__(self, config_params=None):
        super().__init__(config_params)
        self._pending: List[threading.Thread] = []
        self._errors: List[BaseException] = []
        self.max_buffered = 0  # observability: peak queued leaves (tests)

    def save(self, state_dict, path):
        base = path[: -len(".npz")] if path.endswith(".npz") else path
        meta = state_dict.get("__meta__")
        names = _section_paths(state_dict)
        q: "queue.Queue" = queue.Queue(maxsize=self.QUEUE_DEPTH)

        def write():
            sentinel_seen = False
            aborted = False
            try:
                w = _NpzStreamWriter(base + ".npz")
                try:
                    while True:
                        item = q.get()
                        if item is None:
                            sentinel_seen = True
                            break
                        if item is _ABORT:
                            sentinel_seen = True
                            aborted = True
                            break
                        w.write(*item)
                finally:
                    w.close()
                if aborted:
                    # producer died mid-tree: a truncated archive with a
                    # complete-looking meta sidecar would masquerade as a
                    # valid checkpoint — remove it and record the abort
                    os.unlink(base + ".npz")
                    raise RuntimeError("save aborted: snapshot failed mid-tree")
                _write_meta(base, meta, names)
            except BaseException as e:  # surfaced at commit
                self._errors.append(e)
                # unblock the producer — but ONLY until the sentinel; if the
                # failure came after it (meta/close), the queue is already
                # empty and a blocking drain would deadlock commit()
                while not sentinel_seen:
                    if q.get() in (None, _ABORT):
                        sentinel_seen = True

        t = threading.Thread(target=write, daemon=True)
        t.start()
        self._pending.append(t)
        ok = False
        try:
            for name, leaf in _iter_named_leaves(state_dict):
                # put() blocks at queue_depth: bounded host buffering even
                # when the filesystem is slower than the snapshots
                q.put((name, _snapshot_leaf(leaf)))
                self.max_buffered = max(self.max_buffered, q.qsize())
            ok = True
        finally:
            # ALWAYS release the writer (a snapshot error mid-loop would
            # otherwise leave it blocked on q.get() and hang commit());
            # the abort marker makes it discard the partial archive
            q.put(None if ok else _ABORT)

    def load(self, path, map_location=None):
        return _read_npz(path)

    def commit(self, tag) -> bool:
        for t in self._pending:
            t.join()
        self._pending.clear()
        if self._errors:
            err, self._errors = self._errors[:], []
            raise RuntimeError(f"async checkpoint writes failed: {err}")
        return True

    @property
    def in_flight(self) -> int:
        return sum(1 for t in self._pending if t.is_alive())


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class DecoupledCheckpointEngine(AsyncCheckpointEngine):
    """Every process writes its OWN rank-suffixed file, no rank-0 gather;
    commit publishes when the local writes land. A checkpoint resumes with
    the process count and mapping it was saved with."""

    def save(self, state_dict, path):
        super().save(state_dict, f"{path}.rank{_rank()}")

    def load(self, path, map_location=None):
        ranked = f"{path}.rank{_rank()}"
        if not os.path.isfile(ranked + ".npz"):
            raise FileNotFoundError(
                f"{ranked}.npz missing: decoupled checkpoints resume with the SAME "
                "process count/mapping they were saved with"
            )
        return _read_npz(ranked)


ENGINES = {
    "torch": TorchCheckpointEngine,
    "sync": TorchCheckpointEngine,
    "async": AsyncCheckpointEngine,
    "fast": AsyncCheckpointEngine,
    "decoupled": DecoupledCheckpointEngine,
}


def register_checkpoint_engine(name: str, cls, overwrite: bool = False):
    """Register a writer from outside the package. ``cls`` must subclass
    :class:`CheckpointEngine` (create/save/load/commit and the two-phase
    publish contract: ``commit(tag)`` is the ONLY point after which a
    ``latest`` marker may be written; ``save()`` may return before the
    file is durable). After registration ``{"checkpoint": {"writer":
    name}}`` selects it for every ``engine.save_checkpoint``."""
    key = name.lower()
    if not (isinstance(cls, type) and issubclass(cls, CheckpointEngine)):
        raise TypeError(
            f"checkpoint engine {name!r} must subclass CheckpointEngine "
            "(the save/commit two-phase contract is load-bearing for the "
            "decoupled publish path)"
        )
    if key in ENGINES and not overwrite:
        raise ValueError(
            f"checkpoint engine {name!r} already registered "
            f"({ENGINES[key].__name__}); pass overwrite=True to replace it"
        )
    ENGINES[key] = cls
    return cls


def create_checkpoint_engine(name: Optional[str] = None, config_params=None) -> CheckpointEngine:
    """The writer registered under ``name`` (default: sync)."""
    cls = ENGINES.get((name or "sync").lower())
    if cls is None:
        raise ValueError(f"unknown checkpoint engine {name!r}; options: {sorted(ENGINES)}")
    return cls(config_params)
