"""The safetensors format, read and written without the ``safetensors`` package.

Counterpart of the JAX package's ``_load_state_dict``
(``deepspeed_tpu/models/hf.py``), which reads a HuggingFace checkpoint
directory through ``safetensors.safe_open``. A safetensors file is an
8-byte little-endian header length, a JSON header mapping each tensor's
name to its ``dtype``, ``shape`` and ``data_offsets`` (begin and end, in
bytes after the header), then the raw little-endian bytes of every tensor,
back to back. The reader maps the file (``mmap``, private copy-on-write
pages) and hands out ``torch.frombuffer`` views of it, so a tensor costs
no host memory until it is touched and keeps its dtype: bf16 stays bf16,
with no fp32 copy of the checkpoint.

``load_state_dict(path)`` reads a directory as the JAX package does:
``model.safetensors.index.json`` and its shards, else ``model.safetensors``,
else ``pytorch_model.bin`` through ``torch.load(weights_only=True)``.
``save_file`` and ``save_sharded`` write the same format (the latter with
an index), for tests and for checkpoints made on the card.
"""

import json
import mmap
import os
import struct
from typing import Dict, List, Optional

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
INDEX = "model.safetensors.index.json"
SINGLE = "model.safetensors"
TORCH_BIN = "pytorch_model.bin"


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as CPU views of a private
    mapping of it (in file order)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        # ACCESS_COPY: writable private pages, which torch.frombuffer wants;
        # nothing is written back to the file
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else b""
    start = 8 + n
    out = {}
    entries = sorted(((k, v) for k, v in header.items() if k != "__metadata__"),
                     key=lambda kv: kv[1]["data_offsets"][0])
    for name, e in entries:
        dtype = DTYPES.get(e["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {e['dtype']!r}; "
                             f"supported: {sorted(DTYPES)}")
        shape = tuple(int(s) for s in e["shape"])
        b, end = (int(x) for x in e["data_offsets"])
        count = end - b
        item = torch.empty((), dtype=dtype).element_size()
        numel = 1
        for s in shape:
            numel *= s
        if count != numel * item or start + end > size:
            raise ValueError(f"{path}: tensor {name!r} spans {count} bytes for shape "
                             f"{list(shape)} of {e['dtype']}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        elif (start + b) % item:
            # an unaligned tensor (writers that pack mixed dtypes): copy it out
            raw = bytearray(buf[start + b:start + end])
            out[name] = torch.frombuffer(raw, dtype=dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=numel,
                                         offset=start + b).reshape(shape)
    return out


def checkpoint_files(path: str) -> List[str]:
    """The weight files of a checkpoint directory, in the order the JAX
    package reads them: the index's shards (sorted), the single file, or
    the torch ``.bin``."""
    index = os.path.join(path, INDEX)
    if os.path.isfile(index):
        with open(index) as f:
            shards = json.load(f)["weight_map"].values()
        return sorted({os.path.join(path, s) for s in shards})
    for name in (SINGLE, TORCH_BIN):
        if os.path.isfile(os.path.join(path, name)):
            return [os.path.join(path, name)]
    raise FileNotFoundError(f"no safetensors/bin checkpoint under {path}")


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """All weights of a HF checkpoint directory as CPU tensors in their
    stored dtypes (safetensors preferred, sharded or single-file; the torch
    ``.bin`` as the fallback)."""
    state: Dict[str, torch.Tensor] = {}
    for f in checkpoint_files(path):
        if f.endswith(".bin"):
            state.update(torch.load(f, map_location="cpu", weights_only=True))
        else:
            state.update(load_file(f))
    return state


def _tensor_bytes(t: torch.Tensor) -> memoryview:
    t = t.detach().to("cpu").contiguous()
    if t.numel() == 0:
        return memoryview(b"")
    return memoryview(t.view(torch.uint8).reshape(-1).numpy())


def _order(tensors: Dict[str, torch.Tensor]) -> List[str]:
    # widest dtype first, then by name (as the safetensors package orders
    # them): every tensor then starts at a multiple of its element size
    return sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (any device; contiguous copies are taken on the
    host one at a time) as one safetensors file. Returns its data bytes."""
    header: Dict[str, dict] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    names = _order(tensors)
    for k in names:
        t = tensors[k]
        if t.dtype not in _NAMES:
            raise ValueError(f"save_file: tensor {k!r} has unsupported dtype {t.dtype}")
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for k in names:
            f.write(_tensor_bytes(tensors[k]))
    return offset


def save_sharded(tensors: Dict[str, torch.Tensor], path: str, shards: int = 2,
                 metadata: Optional[Dict[str, str]] = None) -> List[str]:
    """Write ``tensors`` into directory ``path`` as ``shards`` files of
    about equal bytes (``model-0000i-of-0000n.safetensors``) and the index
    ``model.safetensors.index.json``. Returns the shard paths."""
    os.makedirs(path, exist_ok=True)
    names = list(tensors)
    total = sum(tensors[k].numel() * tensors[k].element_size() for k in names)
    groups: List[List[str]] = [[] for _ in range(max(1, shards))]
    done = 0
    for k in names:
        i = min(len(groups) - 1, done * len(groups) // max(total, 1))
        groups[i].append(k)
        done += tensors[k].numel() * tensors[k].element_size()
    groups = [g for g in groups if g]
    files, weight_map = [], {}
    for i, g in enumerate(groups):
        fname = f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors"
        save_file({k: tensors[k] for k in g}, os.path.join(path, fname), metadata)
        files.append(os.path.join(path, fname))
        weight_map.update({k: fname for k in g})
    with open(os.path.join(path, INDEX), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=1)
    return files


__all__ = ["DTYPES", "checkpoint_files", "load_file", "load_state_dict", "save_file",
           "save_sharded"]
