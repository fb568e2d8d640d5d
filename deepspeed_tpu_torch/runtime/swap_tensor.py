"""NVMe tensor swapping: the ZeRO-Infinity optimizer-state tier.

Counterpart of ``deepspeed_tpu/runtime/swap_tensor.py`` (reference
``runtime/swap_tensor/partitioned_optimizer_swapper.py``,
``pipelined_optimizer_swapper.py``, ``async_swapper.py``): fp32 masters and
Adam moments live in files, one per (leaf, key), and are swapped in around
each step through page-locked buffers by the AIO engine
(``ops/aio``). The engine's step ends at gradients on the device; the
update runs here, one leaf at a time (the leaf plays the reference's
sub-group role):

    read leaf i+1's state (async)      -+ overlapped
    CPU-Adam on leaf i (native C++)    -+
    write leaf i's state back (async)

so host memory holds two read sets and two write sets of the largest leaf,
not the model. Writes never truncate (the AIO engine's offset-write rule):
a leaf's files keep their size from one step to the next.
"""

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
from deepspeed_tpu_torch.ops.aio import AioHandle
from deepspeed_tpu_torch.utils.logging import logger

STATE_KEYS = ("master", "exp_avg", "exp_avg_sq")


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


def host_fp32(t) -> torch.Tensor:
    """A contiguous flat fp32 CPU tensor of ``t`` (a tensor on any device,
    or an array); no copy when it is one already."""
    t = torch.as_tensor(t)
    return t.detach().to(device="cpu", dtype=torch.float32).contiguous().reshape(-1)


class AsyncTensorSwapper:
    """Flat tensor <-> file store over the AIO engine (reference
    ``async_swapper.py:AsyncTensorSwapper``): one file per name, async
    writes fire and forget, reads land in the caller's buffers."""

    def __init__(self, swap_dir: str, block_size: int = 1 << 20,
                 intra_op_parallelism: int = 4):
        self.swap_dir = swap_dir
        os.makedirs(swap_dir, exist_ok=True)
        # one engine for reads and one for writes: a prefetch is awaited
        # without waiting behind write-backs, and the other way round
        self.read_handle = AioHandle(block_size=block_size,
                                     intra_op_parallelism=intra_op_parallelism)
        self.write_handle = AioHandle(block_size=block_size,
                                      intra_op_parallelism=intra_op_parallelism)

    def path(self, name: str) -> str:
        return os.path.join(self.swap_dir, f"{name}.swp")

    def swap_out(self, name: str, buf: torch.Tensor, asynchronous: bool = True):
        """Write ``buf``; an async write needs it alive until
        ``drain_writes()``."""
        if asynchronous:
            self.write_handle.async_pwrite(buf, self.path(name))
        else:
            self.write_handle.sync_pwrite(buf, self.path(name))
        return buf

    def swap_in(self, name: str, out: torch.Tensor, asynchronous: bool = False):
        if asynchronous:
            self.read_handle.async_pread(out, self.path(name))
        else:
            self.read_handle.sync_pread(out, self.path(name))
        return out

    def drain_reads(self):
        self.read_handle.wait()

    def drain_writes(self):
        self.write_handle.wait()

    def drain(self):
        """Wait for every async op, write-backs and prefetches."""
        self.read_handle.wait()
        self.write_handle.wait()


class NVMeOptimizerSwapper:
    """Adam/AdamW whose whole state lives in files (reference
    ``partitioned_optimizer_swapper.py:31`` + ``cpu_adam``).

    ``init_from_params`` writes fp32 masters of the (half) params and zero
    moments; ``step`` runs the pipelined per-leaf update and returns the
    new params, each in its own dtype, as CPU tensors."""

    def __init__(self, nvme_path: str, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 adamw_mode: bool = True, buffer_count: int = 4,
                 aio_block_size: int = 1 << 20, aio_parallelism: int = 4,
                 pipeline_read: bool = True, pipeline_write: bool = True):
        self.swapper = AsyncTensorSwapper(
            os.path.join(nvme_path, "zero_stage_opt"),
            block_size=aio_block_size, intra_op_parallelism=aio_parallelism,
        )
        self.cpu_adam = DeepSpeedCPUAdam(lr=lr, betas=betas, eps=eps,
                                         weight_decay=weight_decay, adamw_mode=adamw_mode)
        # kept for the reference's config; the pipeline is fixed at two read
        # sets and two write sets (a wait-all write drain uses no more)
        self.buffer_count = max(2, buffer_count)
        self.pipeline_read = pipeline_read
        self.pipeline_write = pipeline_write
        self.steps = 0
        self.leaves: Dict[str, Any] = {}  # name -> (shape, param dtype)
        self._bufcache = None
        self.bytes_read = 0
        self.bytes_written = 0

    def init_from_params(self, named_leaves):
        """``named_leaves``: (name, tensor) pairs. Writes fp32 masters and
        zero moments to the files (reference _initialize_from_swapped_fp16_params)."""
        for name, leaf in named_leaves:
            leaf = torch.as_tensor(leaf)
            self.leaves[name] = (tuple(leaf.shape), leaf.dtype)
            master = host_fp32(leaf).clone()
            zeros = torch.zeros(master.numel(), dtype=torch.float32)
            self.swapper.swap_out(f"{name}.master", master, asynchronous=False)
            self.swapper.swap_out(f"{name}.exp_avg", zeros, asynchronous=False)
            self.swapper.swap_out(f"{name}.exp_avg_sq", zeros, asynchronous=False)
        nbytes = sum(3 * 4 * _numel(s) for s, _ in self.leaves.values())
        logger.info(f"NVMe optimizer tier: {len(self.leaves)} leaves, {nbytes / 1e9:.2f} GB of "
                    f"fp32 state swapped out to {self.swapper.swap_dir}")

    def _buffers(self, max_elems):
        """Two read sets and two write sets of the largest leaf, page-locked,
        made once and reused by every step."""
        if self._bufcache is None or self._bufcache[0] < max_elems:
            h = self.swapper.read_handle

            def bufset():
                return {k: h.new_cpu_locked_tensor(max_elems) for k in STATE_KEYS}

            self._bufcache = (max_elems, [bufset(), bufset()], [bufset(), bufset()])
        return self._bufcache[1], self._bufcache[2]

    def _read_state(self, name, n, bufs, asynchronous):
        for key in STATE_KEYS:
            self.swapper.swap_in(f"{name}.{key}", bufs[key][:n], asynchronous=asynchronous)
        self.bytes_read += 3 * 4 * n

    def step(self, named_grads, lr: Optional[float] = None):
        """``named_grads``: ordered (name, fp32 grad) pairs, CPU tensors.
        Returns {name: new param (CPU, the param's dtype and shape)}. The
        next leaf's reads overlap this leaf's CPU-Adam call, and this
        leaf's write-back overlaps the next leaf's (reference pipelined
        swapper's swap_in/out_optimizer_state around _optimizer_step)."""
        self.steps += 1
        out: Dict[str, torch.Tensor] = {}
        if not named_grads:
            return out
        max_elems = max(_numel(self.leaves[n][0]) for n, _ in named_grads)
        readsets, writesets = self._buffers(max_elems)
        names = [n for n, _ in named_grads]
        self._read_state(names[0], _numel(self.leaves[names[0]][0]), readsets[0],
                         asynchronous=False)
        prefetched = False
        for i, (name, grad) in enumerate(named_grads):
            shape, out_dtype = self.leaves[name]
            n = _numel(shape)
            if i > 0:
                if prefetched:
                    self.swapper.drain_reads()  # the prefetch has landed
                else:
                    self._read_state(name, n, readsets[i % 2], asynchronous=False)
            cur = readsets[i % 2]
            prefetched = self.pipeline_read and i + 1 < len(names)
            if prefetched:
                nxt = names[i + 1]
                self._read_state(nxt, _numel(self.leaves[nxt][0]), readsets[(i + 1) % 2],
                                 asynchronous=True)
            g = host_fp32(grad)
            if g.numel() != n:
                raise ValueError(f"grad size {g.numel()} != leaf {name} size {n}")
            master, m, v = (cur[k][:n] for k in STATE_KEYS)
            self.cpu_adam.step(master, g, m, v, lr=lr, step=self.steps)
            # write back from a set of its own, waited on only before the
            # set is reused: the writes overlap the next leaf's read + Adam
            ws = writesets[i % 2]
            if i >= 2 and self.pipeline_write:
                self.swapper.drain_writes()
            for key, src in (("master", master), ("exp_avg", m), ("exp_avg_sq", v)):
                ws[key][:n].copy_(src)
                self.swapper.swap_out(f"{name}.{key}", ws[key][:n],
                                      asynchronous=self.pipeline_write)
            self.bytes_written += 3 * 4 * n
            out[name] = master.reshape(shape).to(out_dtype, copy=True)
        self.swapper.drain()
        return out

    # -- checkpoints --
    def as_state_tree(self) -> Dict[str, Any]:
        """The whole swapped state, read back (12 bytes a parameter in host
        memory at once: a checkpoint writer takes a whole tree)."""
        tree: Dict[str, Any] = {"steps": self.steps}
        for name, (shape, _) in self.leaves.items():
            for key in STATE_KEYS:
                buf = torch.empty(_numel(shape), dtype=torch.float32)
                self.swapper.swap_in(f"{name}.{key}", buf, asynchronous=False)
                tree[f"{name}.{key}"] = buf.reshape(shape)
        return tree

    def state_tree_template(self) -> Dict[str, Any]:
        """``as_state_tree``'s shapes and dtypes, without reading the files."""
        tree: Dict[str, Any] = {"steps": self.steps}
        for name, (shape, _) in self.leaves.items():
            for key in STATE_KEYS:
                tree[f"{name}.{key}"] = torch.empty(shape, dtype=torch.float32)
        return tree

    def load_state_tree(self, tree: Dict[str, Any]):
        """Write a checkpointed state tree back out to the files."""
        self.steps = int(tree.get("steps", 0))
        self.cpu_adam.steps = self.steps
        for name in self.leaves:
            for key in STATE_KEYS:
                self.swapper.swap_out(f"{name}.{key}", host_fp32(tree[f"{name}.{key}"]),
                                      asynchronous=False)
