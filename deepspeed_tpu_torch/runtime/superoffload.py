"""SuperOffload: the whole optimizer on the host.

Counterpart of ``deepspeed_tpu/runtime/superoffload.py`` (reference
``runtime/superoffload/superoffload_stage3.py``, ``superoffload_utils.py``):
on hosts whose link to the card is fast, the whole Adam update runs on the
CPU every step. The engine's step ends at gradients on the card; here the
fp32 masters and moments stay resident in page-locked host memory, and
each leaf's gradient comes down ``non_blocking`` on a copy stream into a
page-locked buffer of its own, with an event, while the previous leaf's
native CPU-Adam runs (the reference's async CPU-Adam overlap; the JAX
package pulls on a thread pool). The Adam loops use every core through
OpenMP. No file traffic, no swap pipeline.

The engine decides an overflow skip before ``step()``, so no state is ever
poisoned and nothing rolls back.
"""

from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
from deepspeed_tpu_torch.runtime.swap_tensor import host_fp32
from deepspeed_tpu_torch.utils.logging import logger

STATE_KEYS = ("master", "exp_avg", "exp_avg_sq")


def pinned_empty(n, dtype=torch.float32) -> torch.Tensor:
    """A flat CPU tensor, page-locked when the process has a card."""
    return torch.empty(int(n), dtype=dtype, pin_memory=torch.cuda.is_available())


class GradPuller:
    """Brings device gradients to the host one leaf ahead: ``start(i)``
    enqueues leaf i's D2H copy on a copy stream (after the compute stream's
    work so far) into a page-locked fp32 buffer and records an event;
    ``take(i)`` waits for that event and hands the buffer over. Two buffers
    of the largest leaf, made once. CPU gradients are taken as they are."""

    def __init__(self):
        self._bufs = None
        self._stream = None
        self._events = {}

    def _slot(self, i, n):
        if self._bufs is None or self._bufs[0].numel() < n:
            self._bufs = [pinned_empty(n), pinned_empty(n)]
        return self._bufs[i % 2][:n]

    def start(self, i, g):
        if g.device.type == "cpu":
            self._events[i] = (host_fp32(g), None)
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(g.device)
        buf = self._slot(i, g.numel())
        self._stream.wait_stream(torch.cuda.current_stream(g.device))
        with torch.cuda.stream(self._stream):
            src = g.detach().reshape(-1)
            buf.copy_(src if src.dtype == torch.float32 else src.float(), non_blocking=True)
            src.record_stream(self._stream)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        self._events[i] = (buf, ev)

    def take(self, i):
        buf, ev = self._events.pop(i)
        if ev is not None:
            ev.synchronize()
        return buf


class SuperOffloadHostOptimizer:
    """Host-memory Adam/AdamW over named leaves; the same interface as
    ``NVMeOptimizerSwapper``, so the engine drives both through one path."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 adamw_mode=True, cpuadam_cores_perc: float = 0.8):
        self.cpu_adam = DeepSpeedCPUAdam(lr=lr, betas=betas, eps=eps,
                                         weight_decay=weight_decay, adamw_mode=adamw_mode)
        self.cpuadam_cores_perc = cpuadam_cores_perc  # kept for the config: OpenMP owns cores
        self.steps = 0
        self.leaves: Dict[str, Any] = {}  # name -> (shape, param dtype)
        self._state: Dict[str, torch.Tensor] = {}  # "name.master" etc., flat fp32
        self._puller = GradPuller()

    def init_from_params(self, named_leaves):
        total = 0
        for name, leaf in named_leaves:
            leaf = torch.as_tensor(leaf)
            self.leaves[name] = (tuple(leaf.shape), leaf.dtype)
            n = leaf.numel()
            for key in STATE_KEYS:
                t = pinned_empty(n)
                if key == "master":
                    t.copy_(leaf.detach().reshape(-1))
                else:
                    t.zero_()
                self._state[f"{name}.{key}"] = t
            total += 3 * 4 * n
        logger.info(f"SuperOffload: {len(self.leaves)} leaves, {total / 1e9:.2f} GB of fp32 "
                    f"optimizer state resident in host memory")

    def step(self, named_grads, lr: Optional[float] = None):
        """``named_grads``: ordered (name, grad) pairs, on the card or the
        host. Returns {name: new param (CPU, the param's dtype and shape)}."""
        self.steps += 1
        out: Dict[str, torch.Tensor] = {}
        if not named_grads:
            return out
        pull = self._puller
        pull.start(0, named_grads[0][1])
        for i, (name, _) in enumerate(named_grads):
            g = pull.take(i)
            if i + 1 < len(named_grads):
                pull.start(i + 1, named_grads[i + 1][1])
            shape, out_dtype = self.leaves[name]
            master = self._state[f"{name}.master"]
            if g.numel() != master.numel():
                raise ValueError(f"grad size mismatch on {name}: {g.numel()} != "
                                 f"{master.numel()}")
            self.cpu_adam.step(master, g, self._state[f"{name}.exp_avg"],
                               self._state[f"{name}.exp_avg_sq"], lr=lr, step=self.steps)
            out[name] = master.reshape(shape).to(out_dtype, copy=True)
        return out

    # -- checkpoints (the same interface as NVMeOptimizerSwapper) --
    def as_state_tree(self) -> Dict[str, Any]:
        tree: Dict[str, Any] = {"steps": self.steps}
        for name, (shape, _) in self.leaves.items():
            for key in STATE_KEYS:
                # a copy: an async writer serializes while the next step
                # updates these buffers in place
                tree[f"{name}.{key}"] = self._state[f"{name}.{key}"].reshape(shape).clone()
        return tree

    def state_tree_template(self) -> Dict[str, Any]:
        tree: Dict[str, Any] = {"steps": self.steps}
        for name, (shape, _) in self.leaves.items():
            for key in STATE_KEYS:
                tree[f"{name}.{key}"] = torch.empty(shape, dtype=torch.float32)
        return tree

    def load_state_tree(self, tree: Dict[str, Any]):
        self.steps = int(tree.get("steps", 0))
        self.cpu_adam.steps = self.steps
        for name in self.leaves:
            for key in STATE_KEYS:
                self._state[f"{name}.{key}"].copy_(host_fp32(tree[f"{name}.{key}"]))
