"""Weight streaming: layers' weights staged from host memory, one ahead.

Counterpart of the JAX model's staging (``deepspeed_tpu/models/
transformer.py`` ``_stage_to_device``, ``_maybe_stage``, ``_stage_tree``;
reference ``partition_parameters.py`` remote_device and the prefetch
coordinator). With ``TransformerConfig.weight_stream`` and the training
engine's ``offload_param``, the streamed leaves (the JAX rule:
``streamed_leaf``) rest in page-locked host memory; the engine opens a
``stream_scope`` around its loss, and the model takes each leaf through
this module:

  * a stacked layer leaf ([L, ...]) is staged one layer at a time into one
    of two slots of device buffers (``WeightStreamer``): layer i+1's
    slices go H2D on a copy stream while layer i computes (layer i-1 in
    the backward's recompute), and the compute stream waits on the copy's
    event. The staging ``autograd.Function`` (``_StageSlice``) sends the
    gradient of its slice D2H on the copy stream into a page-locked
    gradient buffer of the whole leaf (the JAX ``_stage_bwd``); it returns
    no gradient to autograd, and the engine reads the buffer;
  * a 2-D leaf (embeddings, the LM head) is staged whole (``_StageWhole``)
    and its gradient comes back to the host through autograd.

The device copy is taken inside the layer's function, so under remat the
backward's recompute takes it again rather than autograd keeping it; the
copies themselves run outside the remat region (``ahead``: from the
forward loop, and in the backward from a hook on the layer's output, which
fires before the recompute), since the selective remat policies replay a
region's ops exactly. A slot is taken again only after the layer that held
it is done (its forward under remat, or the last of its slices' gradients
in the backward). When a slot is not free a layer gets buffers of its own,
and ``peak_bytes`` counts every streamed byte on the device at once.
Without remat autograd keeps each layer's staged weights for the backward
(as XLA keeps them in the JAX model), so every layer gets its own buffers.

On the CPU host and device are one, and the same code copies host to host.
"""

import contextlib
import contextvars
from typing import Dict, Optional

import numpy as np
import torch

STREAM_MIN_2D_BYTES = 8 << 20
_STREAMER = contextvars.ContextVar("weight_streamer", default=None)


def streamed_leaf(shape, dtype) -> bool:
    """The JAX engine's rule (``_destream_small``): stacked >= 3-D leaves
    and 2-D leaves of at least 8 MiB stream; smaller leaves stay on the
    device."""
    nbytes = int(np.prod(tuple(shape) or (1,), dtype=np.int64)) * torch.empty(
        (), dtype=dtype).element_size()
    return len(shape) >= 3 or (len(shape) == 2 and nbytes >= STREAM_MIN_2D_BYTES)


@contextlib.contextmanager
def stream_scope(streamer: Optional["WeightStreamer"]):
    """Make ``streamer`` the one the model stages through (None: none)."""
    token = _STREAMER.set(streamer)
    try:
        yield streamer
    finally:
        _STREAMER.reset(token)


def active_streamer() -> Optional["WeightStreamer"]:
    return _STREAMER.get()


class _StageWhole(torch.autograd.Function):
    """host leaf -> its device copy; the gradient goes back to the host."""

    @staticmethod
    def forward(ctx, w, streamer):
        ctx.host, ctx.streamer = w.device, streamer
        streamer.h2d_bytes += w.numel() * w.element_size()
        return w.to(streamer.device, non_blocking=True, copy=True)

    @staticmethod
    def backward(ctx, g):
        ctx.streamer.d2h_bytes += g.numel() * g.element_size()
        return g.to(ctx.host), None


class _StageSlice(torch.autograd.Function):
    """Slice ``li`` of a stacked host leaf, already staged in ``buf``; its
    gradient is written into the streamer's host buffer (no autograd
    gradient)."""

    @staticmethod
    def forward(ctx, w, buf, streamer, key, li):
        ctx.streamer, ctx.key, ctx.li = streamer, key, li
        return buf.detach()

    @staticmethod
    def backward(ctx, g):
        ctx.streamer._grad_out(ctx.key, ctx.li, g)
        return None, None, None, None, None


class WeightStreamer:
    """The streamed leaves of one engine and the device buffers they are
    staged through.

    ``layers``: {key: host [L, ...] tensor} (the stacked streamed leaves);
    ``whole``: the host 2-D streamed leaves; ``remat``: whether the layers
    run under remat (slots are reused only then)."""

    def __init__(self, layers: Dict[str, torch.Tensor], whole, device, remat: bool):
        self.layers = dict(layers)
        self.whole_ids = {id(t) for t in whole}
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.remat = remat
        self.n_layers = next(iter(self.layers.values())).shape[0] if self.layers else 0
        self.layer_bytes = sum(t[0].numel() * t.element_size() for t in self.layers.values())
        pin = self.cuda
        self.grads = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                      for k, t in self.layers.items()}
        self.copy = torch.cuda.Stream(self.device) if self.cuda else None
        self._slots = None  # two {key: device buffer of one layer's slice}
        self.timing = False  # time each copy with CUDA events (copy_ms)
        self.reset_counts()
        self.begin_step()

    # -- counters --
    def reset_counts(self):
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.stages = 0
        self.extra_stages = 0  # layers that found no free slot
        self.peak_bytes = 0
        self.copy_events = []  # (start, end) events of each copy on the copy stream

    def begin_step(self):
        """Before a step's forward: no layer staged, both slots free."""
        self._owner = [None, None]
        self._free_ev = [None, None]
        self._staged = {}  # layer -> (buffers, ready event, slot or None)
        self._extra_bytes = 0
        self._pending = {}
        self.backward = False

    def begin_backward(self):
        self.backward = True
        self._pending = {li: set(self.layers) for li in range(self.n_layers)}

    def finish(self):
        """After the backward: the compute stream waits for the gradients'
        copies, and the host for the copy stream."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(self.copy)
            self.copy.synchronize()

    # -- staging --
    def _track(self):
        slots = 0 if self._slots is None else 2 * self.layer_bytes
        self.peak_bytes = max(self.peak_bytes, slots + self._extra_bytes)

    def _timed(self):
        """The copy stream's context, and the timing events of one copy
        (None unless ``timing``)."""
        if not self.cuda:
            return contextlib.nullcontext(), None
        if not self.timing:
            return torch.cuda.stream(self.copy), None
        evs = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        self.copy_events.append(evs)
        return torch.cuda.stream(self.copy), evs

    def _stage(self, li):
        """Copy layer ``li``'s slices into its slot (or buffers of its own
        when the slot is taken), on the copy stream."""
        s = li % 2
        reuse = self.remat or not torch.is_grad_enabled()
        if reuse and self._owner[s] is None:
            if self._slots is None:
                self._slots = [{k: torch.empty(t.shape[1:], dtype=t.dtype, device=self.device)
                                for k, t in self.layers.items()} for _ in range(2)]
            bufs, slot = self._slots[s], s
            self._owner[s] = li
        else:
            bufs = {k: torch.empty(t.shape[1:], dtype=t.dtype, device=self.device)
                    for k, t in self.layers.items()}
            slot = None
            self.extra_stages += 1
            self._extra_bytes += self.layer_bytes
        self._track()
        ctx, evs = self._timed()
        ev = None
        with ctx:
            if self.cuda:
                self.copy.wait_stream(torch.cuda.current_stream(self.device))
                if slot is not None and self._free_ev[s] is not None:
                    self.copy.wait_event(self._free_ev[s])
                if evs:
                    evs[0].record(self.copy)
            for k, t in self.layers.items():
                bufs[k].copy_(t[li], non_blocking=True)
            if self.cuda:
                if evs:
                    evs[1].record(self.copy)
                ev = torch.cuda.Event()
                ev.record(self.copy)
        self.stages += 1
        self.h2d_bytes += self.layer_bytes
        self._staged[li] = (bufs, ev, slot)

    def _free(self, li):
        entry = self._staged.pop(li, None)
        if entry is None:
            return
        _, _, slot = entry
        ev = None
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        if slot is None:
            self._extra_bytes -= self.layer_bytes
        else:
            self._owner[slot] = None
            self._free_ev[slot] = ev

    def ahead(self, li):
        """Before layer ``li`` runs (outside its remat region, whose ops the
        selective policies replay): stage it unless staged, and start the
        next layer's copies (layer li + 1 in the forward, li - 1 in the
        backward) when that layer's slot is free."""
        if li not in self._staged:
            self._stage(li)
        nxt = li - 1 if self.backward else li + 1
        if (0 <= nxt < self.n_layers and nxt not in self._staged
                and self._owner[nxt % 2] is None and (self.remat or not torch.is_grad_enabled())):
            self._stage(nxt)

    def backward_hook(self, li):
        """A hook for layer ``li``'s output: its gradient arrives before the
        backward recomputes the layer, so the layer (and the one below it)
        is staged there."""
        def hook(grad):
            self.ahead(li)

        return hook

    def layer(self, li, host_layer):
        """Layer ``li``'s params with its streamed slices on the device (the
        compute stream waits for their copies)."""
        if li not in self._staged:
            self._stage(li)
        bufs, ev, _ = self._staged[li]
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)
        out = dict(host_layer)
        for k in self.layers:
            out[k] = _StageSlice.apply(host_layer[k], bufs[k], self, k, li)
        return out

    def layer_done(self, li):
        """After layer ``li``'s forward: its slot is free again unless
        autograd keeps the staged weights (no remat) or the backward runs
        (freed by the gradients)."""
        if not self.backward and (self.remat or not torch.is_grad_enabled()):
            self._free(li)

    def _grad_out(self, key, li, g):
        """A slice's gradient: D2H into the host buffer, on the copy
        stream after the compute stream's work so far."""
        dst = self.grads[key][li]
        ctx, evs = self._timed()
        with ctx:
            if self.cuda:
                self.copy.wait_stream(torch.cuda.current_stream(self.device))
                if evs:
                    evs[0].record(self.copy)
                dst.copy_(g, non_blocking=True)
                g.record_stream(self.copy)
                if evs:
                    evs[1].record(self.copy)
            else:
                dst.copy_(g)
        self.d2h_bytes += g.numel() * g.element_size()
        pending = self._pending.get(li)
        if pending is not None:
            pending.discard(key)
            if not pending:
                del self._pending[li]
                self._free(li)

    def whole(self, w):
        """A 2-D streamed host leaf's device copy (other tensors as they are)."""
        if isinstance(w, torch.Tensor) and id(w) in self.whole_ids:
            return _StageWhole.apply(w, self)
        return w

    def owns_layers(self, layers) -> bool:
        return bool(self.layers) and all(layers.get(k) is t for k, t in self.layers.items())

    def copy_ms(self) -> float:
        """Device ms of every timed copy since ``reset_counts`` (card only)."""
        if not self.cuda:
            return 0.0
        torch.cuda.synchronize(self.device)
        return float(sum(a.elapsed_time(b) for a, b in self.copy_events))


__all__ = ["WeightStreamer", "active_streamer", "stream_scope", "streamed_leaf"]
