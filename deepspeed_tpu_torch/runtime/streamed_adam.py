"""Chunk-streamed AdamW over host-resident optimizer state (weight streaming).

Counterpart of ``deepspeed_tpu/runtime/streamed_adam.py`` (reference
analogue: the ZeRO-Infinity pipelined optimizer swap). The fp32 masters
and moments of the weight-streaming tier live in page-locked host memory;
each leaf's update streams through the device in windows of its leading
axis, so device memory is bounded by the window, not the model:

  * window i+1's gradient, master and moments go H2D on a copy stream
    while window i's AdamW runs on the compute stream (``double_buffer``,
    two slots of device buffers; the compute stream waits on the copy's
    event);
  * the new master, moments and param go D2H into the host state on the
    copy stream after the compute stream's event;
  * the tail window is clamped to end at the leaf's end (as the JAX
    module's is); the rows it shares with the window before it were
    written already, so only its new rows are written back.

A leaf whose state is on the device (a small leaf the engine keeps there,
or every leaf of an all-on-device run) takes the whole-leaf path: one
update in place. A host leaf no larger than a window is staged whole. The
math is plain torch, as the JAX module's is plain ``jnp``; windows cut the
leading axis and the int8 moment blocks (``stream_quant_bits: 8``) lie on
the minor axis, so a windowed update equals the whole-leaf one element for
element. The 8- and 32-row window rounding of the JAX module is libtpu's
sublane rule for host slices and has no counterpart here.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.optimizers import OptState
from deepspeed_tpu_torch.utils.tree import tree_map

# 2^25 fp32 elements = 128 MB a staged buffer
DEFAULT_CHUNK_ELEMS = 1 << 25
QUANT_BLOCK = 256  # elements per int8 block (an fp32 scale each)


def _quant_eligible(shape) -> bool:
    """int8 moments for >= 2-D leaves whose last dim is a multiple of 256
    (blocks tile the minor axis, so windows slice data and scales alike)."""
    return len(shape) >= 2 and shape[-1] % QUANT_BLOCK == 0


def _q8(x):
    """Blockwise int8: x [..., row] fp32, row % 256 == 0 -> (q int8 of x's
    shape, s fp32 [..., row / 256])."""
    shape = x.shape
    blocks = x.reshape(shape[:-1] + (shape[-1] // QUANT_BLOCK, QUANT_BLOCK))
    s = blocks.abs().amax(dim=-1) / 127.0
    q = torch.round(blocks / s[..., None].clamp_min(1e-30))
    return q.clamp(-127, 127).to(torch.int8).reshape(shape), s.float()


def _dq8(q, s):
    shape = q.shape
    blocks = q.reshape(shape[:-1] + (shape[-1] // QUANT_BLOCK, QUANT_BLOCK))
    return (blocks.float() * s[..., None]).reshape(shape)


def _q8_nu(nu):
    """Second moment: linear int8 on sqrt(nu) (nu spans many orders of
    magnitude within a block)."""
    return _q8(nu.sqrt())


def _dq8_nu(q, s):
    r = _dq8(q, s)
    return r * r


def _q8_mu(mu):
    """First moment: linear int8 on the signed sqrt."""
    return _q8(mu.sign() * mu.abs().sqrt())


def _dq8_mu(q, s):
    r = _dq8(q, s)
    return r.sign() * (r * r)


def _adamw_math(g, m, mu, nu, lr, b1, b2, eps, wd, c1, c2):
    """One window of AdamW (bias-corrected, decoupled decay), fp32:
    returns (m', mu', nu')."""
    g = g.float()
    mu = b1 * mu + (1.0 - b1) * g
    nu = b2 * nu + (1.0 - b2) * g.square()
    update = (mu / c1) / ((nu / c2).sqrt() + eps)
    if wd:
        update = update + wd * m
    return m - lr * update, mu, nu


def _on_host(t, device) -> bool:
    return device is not None and t.device.type == "cpu"


class _Windows:
    """The window schedule of one host leaf ([dim0, ...], leading axis
    cut) and the streams it runs on."""

    def __init__(self, shape, chunk, device, stream):
        n = int(np.prod(shape, dtype=np.int64))
        self.dim0 = shape[0]
        row_elems = n // self.dim0
        self.rows = self.dim0 if n <= chunk else max(1, min(self.dim0, chunk // max(row_elems, 1)))
        self.count = -(-self.dim0 // self.rows)
        self.device = device
        self.cuda = device.type == "cuda"
        self.copy = (stream or torch.cuda.Stream(device)) if self.cuda else None
        self.compute = torch.cuda.current_stream(device) if self.cuda else None

    def start(self, i):
        # clamped: the tail window ends at the leaf's end
        return min(i * self.rows, self.dim0 - self.rows)

    def stage(self, host_tensors, i, slots=None):
        """H2D copies of window i of each host tensor (on the copy stream,
        after the compute stream's work so far, into ``slots`` when
        given); returns the device windows and the copy's event."""
        s = self.start(i)
        if not self.cuda:
            return [t[s:s + self.rows].to(self.device, copy=True) for t in host_tensors], None
        self.copy.wait_stream(self.compute)
        with torch.cuda.stream(self.copy):
            out = []
            for j, t in enumerate(host_tensors):
                src = t[s:s + self.rows]
                if slots is None:
                    out.append(src.to(self.device, non_blocking=True))
                else:
                    out.append(slots[j].copy_(src, non_blocking=True))
            ev = torch.cuda.Event()
            ev.record(self.copy)
        return out, ev

    def writeback(self, i, pairs):
        """Window i's results into their destinations: D2H on the copy
        stream after the compute stream's event for host tensors, on the
        compute stream for device ones. Only the rows no earlier window
        wrote (the clamped tail shares some)."""
        s = self.start(i)
        lo = i * self.rows - s
        hi = s + self.rows
        if self.cuda:
            self.copy.wait_stream(self.compute)
        for dst, src in pairs:
            if dst.device.type == "cpu" and self.cuda:
                with torch.cuda.stream(self.copy):
                    dst[s + lo:hi].copy_(src[lo:], non_blocking=True)
                    src.record_stream(self.copy)
            else:
                dst[s + lo:hi].copy_(src[lo:])

    def wait(self, ev):
        if ev is not None:
            self.compute.wait_event(ev)

    def finish(self):
        """The compute stream waits for the last write-back (a later
        reader of the host state synchronizes with it)."""
        if self.cuda:
            self.compute.wait_stream(self.copy)


def _lead(t):
    """A view with a leading axis (0-d leaves get one of size 1)."""
    return t.reshape(1) if t.dim() == 0 else t


def _stream_leaf(host, outputs, update, chunk, double_buffer, device, stream):
    """Run ``update(*device windows) -> results`` over the windows of the
    host tensors ``host``, writing result j into ``outputs[j]`` (host or
    device tensors of the leaf's shape)."""
    host = [_lead(t) for t in host]
    outputs = [_lead(t) for t in outputs]
    win = _Windows(tuple(host[1].shape), chunk, device, stream)
    slots = None
    if double_buffer and win.cuda and win.count > 1:
        slots = [[torch.empty((win.rows,) + tuple(t.shape[1:]), dtype=t.dtype, device=device)
                  for t in host] for _ in range(2)]

    def stage(i):
        return win.stage(host, i, slots[i % 2] if slots else None)

    staged = stage(0)
    for i in range(win.count):
        # window i+1's copies are enqueued before window i's math
        nxt = stage(i + 1) if double_buffer and i + 1 < win.count else None
        windows, ev = staged
        win.wait(ev)
        results = update(*windows)
        win.writeback(i, list(zip(outputs, results)))
        if i + 1 < win.count:
            staged = nxt if nxt is not None else stage(i + 1)
    win.finish()


def streamed_adamw_leaf(g, m, mu, nu, p, lr, *, b1, b2, eps, wd, c1, c2,
                        chunk=DEFAULT_CHUNK_ELEMS, double_buffer=True, device=None,
                        stream=None):
    """Update one leaf in place: master ``m``, moments ``mu`` / ``nu`` and
    the param ``p`` (rewritten from the master in its own dtype). When
    ``m`` is on the host and ``device`` is given, the leaf streams through
    ``device`` in windows of its leading axis (one window when it fits);
    otherwise it updates where it is. Returns (m, mu, nu, p)."""
    if not _on_host(m, device):
        m2, mu2, nu2 = _adamw_math(g.to(m.device), m, mu, nu, lr, b1, b2, eps, wd, c1, c2)
        for dst, src in ((m, m2), (mu, mu2), (nu, nu2), (p, m2)):
            dst.copy_(src)
        return m, mu, nu, p

    def update(gw, mw, muw, nuw):
        m2, mu2, nu2 = _adamw_math(gw, mw, muw, nuw, lr, b1, b2, eps, wd, c1, c2)
        return m2, mu2, nu2, m2.to(p.dtype)

    _stream_leaf([g, m, mu, nu], [m, mu, nu, p], update, chunk, double_buffer, device, stream)
    return m, mu, nu, p


def streamed_adamw_leaf_q8(g, m, mu, nu, p, lr, *, b1, b2, eps, wd, c1, c2,
                           chunk=DEFAULT_CHUNK_ELEMS, double_buffer=True, device=None,
                           stream=None):
    """The int8-moment form: ``mu`` / ``nu`` are {"q": int8 of the leaf's
    shape, "s": fp32 [..., last / 256]}; dequantize, AdamW, requantize a
    window at a time on the device, so quantization error does not build
    up within a step."""
    def update(gw, mw, muq, mus, nuq, nus):
        m2, mu2, nu2 = _adamw_math(gw, mw, _dq8_mu(muq, mus), _dq8_nu(nuq, nus), lr, b1, b2,
                                   eps, wd, c1, c2)
        return (m2, *_q8_mu(mu2), *_q8_nu(nu2), m2.to(p.dtype))

    state = [m, mu["q"], mu["s"], nu["q"], nu["s"], p]
    if not _on_host(m, device):
        gw = g.to(m.device)
        for dst, src in zip(state, update(gw, m, mu["q"], mu["s"], nu["q"], nu["s"])):
            dst.copy_(src)
        return m, mu, nu, p
    _stream_leaf([g, m, mu["q"], mu["s"], nu["q"], nu["s"]], state, update, chunk,
                 double_buffer, device, stream)
    return m, mu, nu, p


class StreamedAdamW:
    """The weight-streaming tier's optimizer (the JAX package's
    ``StreamedAdamW``): ``step(grads, OptState(master, {"count", "mu",
    "nu"}), params, lr)`` updates every leaf in place through
    ``streamed_adamw_leaf`` (``_q8`` when its moments are int8), streaming
    host leaves through ``device``."""

    tx = None

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 chunk_elems=DEFAULT_CHUNK_ELEMS, quant_bits=0, overlap=True, device=None):
        self.name = "streamed_adamw"
        self.defaults = {"lr": lr, "betas": betas, "eps": eps, "weight_decay": weight_decay}
        self._lr = lr
        self.chunk_elems = chunk_elems
        self.overlap = bool(overlap)
        self.quant_bits = int(quant_bits or 0)
        if self.quant_bits not in (0, 8):
            raise ValueError(f"stream_quant_bits must be 0 or 8, got {quant_bits}")
        self.device = device
        self._stream = None

    def set_lr(self, lr):
        self._lr = lr

    def get_lr(self):
        return self._lr

    @property
    def param_groups(self):
        return [{"lr": self._lr, **self.defaults}]

    def _moment_like(self, m):
        if self.quant_bits == 8 and _quant_eligible(tuple(m.shape)):
            return {"q": torch.zeros(m.shape, dtype=torch.int8, device=m.device),
                    "s": torch.zeros(tuple(m.shape[:-1]) + (m.shape[-1] // QUANT_BLOCK,),
                                     dtype=torch.float32, device=m.device)}
        return torch.zeros_like(m)

    def init(self, params) -> OptState:
        master = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
        return OptState(master=master, inner={"count": 0,
                                              "mu": tree_map(self._moment_like, master),
                                              "nu": tree_map(self._moment_like, master)})

    @torch.no_grad()
    def step(self, grads, state: OptState, params, lr) -> OptState:
        b1, b2 = (float(b) for b in self.defaults["betas"])
        count = state.inner["count"] + 1
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        lr = float(np.float32(lr))
        if self.device is not None and self.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        kw = dict(b1=b1, b2=b2, eps=float(self.defaults["eps"]),
                  wd=float(self.defaults["weight_decay"]), c1=c1, c2=c2,
                  chunk=self.chunk_elems, double_buffer=self.overlap, device=self.device,
                  stream=self._stream)
        for m, g, mu, nu, p in _walk_moments(state.master, grads, state.inner["mu"],
                                             state.inner["nu"], params):
            leaf = streamed_adamw_leaf_q8 if isinstance(mu, dict) else streamed_adamw_leaf
            leaf(g, m, mu, nu, p, lr, **kw)
        return OptState(master=state.master, inner=dict(state.inner, count=count))


def _walk_moments(master, *rest):
    """(master leaf, and the same path in each of ``rest``) with a moment
    leaf that is an int8 {"q", "s"} pair taken whole."""
    for k, v in master.items():
        if isinstance(v, dict):
            yield from _walk_moments(v, *(r[k] for r in rest))
        else:
            yield (v, *(r[k] for r in rest))


__all__ = ["DEFAULT_CHUNK_ELEMS", "QUANT_BLOCK", "StreamedAdamW", "streamed_adamw_leaf",
           "streamed_adamw_leaf_q8"]
