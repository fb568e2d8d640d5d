"""InferenceEngineV2: paged-KV continuous-batching engine (PyTorch).

Counterpart of ``deepspeed_tpu/inference/v2/engine_v2.py`` (reference
``InferenceEngineV2.put()``, inference/v2/engine_v2.py:107). The scheduler,
state manager and block allocator are the JAX package's, copied; the step
bodies are eager PyTorch:

  * the paged KV pools are two contiguous tensors [L, num_blocks + 1,
    block_size, n_kv, d] (block ``num_blocks`` is the trash block padded
    tokens write to); attention reads flat multi-layer views
    [L * NBp, bs, nkv, d] through layer-offset tables and trash ids;
  * ``kv_cache.kv_cache_dtype="int8"``: the pools hold int8 codes beside
    fp32 scale planes [L, num_blocks + 1, block_size, n_kv], one scale per
    head vector. Every write quantizes K and V together
    (``quantize_kv_pair``: one launch of the CUDA block-quant kernel on a
    card); every read dequantizes (the int8 form of
    the paged-decode kernel, or the plain gathers). A step's or round's own
    K/V, attended as extra columns, stay in the compute dtype;
  * the split-phase step runs R decode slots and Rc prompt chunks of tq
    tokens in one pass: decode rows through ``paged_attention`` (the CUDA
    paged-decode kernel on a card) with their own K/V as one extra column,
    chunk rows through ``paged_chunk_attention`` (plain torch);
  * ``decode_round`` runs n_steps decode iterations with the sampled token
    fed back on the device; the round's own K/V ride in side buffers
    [L, R, n, nkv, d] as the kernel's extra columns;
  * every norm goes through ``rms_norm`` (the CUDA RMSNorm kernel on a card);
  * ``_step_per_row`` runs each scheduled sequence on its own (the JAX
    package's round-1 execution model, kept as the baseline): its chunk,
    padded to a bucket of ``_CHUNK_BUCKETS``, through every layer, the
    padded tail's K/V written to the trash block, attention over the
    sequence's gathered context of max_blocks_per_seq × block_size keys.
    With ``attention_impl="splash"`` and a sliding window that attention is
    ``splash_prefill_attention`` (the splash forward kernel on a card, which
    visits only the blocks in the band); otherwise the dense masked
    ``mha_reference``, as in the JAX package. An int8 pool attends before
    the chunk's write instead, through ``paged_attention`` over the pool
    below the chunk plus the chunk's own K/V as extra columns, and never
    takes the splash prefill. The batched step and the fused rounds are the
    same for every ``attention_impl``.

Where the JAX package scatters new K/V into a donated buffer and reads the
pool at its step- or round-start state, the port writes the pools in
place, after each layer's attention. That is the same computation: a
layer's attention reads only its own layer's region, and the pool limit
(the step's decode positions, the chunk starts, the round's start
positions) masks every position the step or round has written.

``quant.enabled`` (weight-only quantized serving, ``inference/
quantization``): the matmul weights are quantized after the dtype cast and
held int8 / packed int4 with fp32 block scales; every step body widens its
layer's weights at its top (``_lp``) and the head's in ``_apply_lm_head``,
in plain torch, so the wide copy is one layer's. The KV pools, the
transports and the host tier move K/V, not weights, and work as they do
for a wide model.

Speculative decoding (``spec_round``) verifies each row's pending token
and up to k drafts in one forward of R x (k + 1) query rows: the verify
form of ``paged_attention`` (``paged.verify_kwargs``: each query row
carries its row's table and write cursor, and the row's k + 1 fresh K/V as
extra columns with the in-chunk causal mask), then the layer's write, the
same write-after-read order as the split step. The targets are drawn with
the keys plain decode would use, so spec-on streams equal spec-off ones.

The host block tier (``kv_cache.host_tier_bytes``) spills blocks the
prefix trie evicts to a byte-budgeted host store and readmits them through
``import_kv_blocks_chunked`` (fixed windows: the payload staged once in
pinned memory, each window's copy on a side stream while the previous
window's scatter runs).

The port compiles no programs: eager PyTorch builds nothing per step
shape, so ``trace_signature`` is the set of kernel libraries this process
has built or loaded, the one cost a first use pays at admission (ROADMAP
queue 1, item 4).

With tracing on (``observability.configure_tracing``), every step, fused
round and verify round writes an ``engine.dispatch`` span (host staging
and the kernel launches) and an ``engine.device_wait`` span (a
synchronization of the current stream until the step's outputs are
ready) on the engine's track, and the host tier writes ``host_tier.spill``
(instant) and ``host_tier.readmit`` (span), as the JAX engine does. With
tracing off nothing is added to a step.

The engine runs on ``device`` ("cuda" unless the caller passes "cpu"), and
raises when asked for a card that is not there. Features of the JAX engine
that later slices port raise ``NotImplementedError`` naming their ROADMAP
item.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.inference.config import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.sampling import row_keys, sample_tokens
from deepspeed_tpu_torch.inference.v2.host_tier import HostBlockStore, chain_hashes
from deepspeed_tpu_torch.inference.v2.kv_pool import _check_dtype, check_kv_payload, describe
from deepspeed_tpu_torch.inference.v2.ragged_manager import DSStateManager
from deepspeed_tpu_torch.inference.v2.scheduler import RaggedScheduler
from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.observability.tracing import get_tracer
from deepspeed_tpu_torch.ops.attention.core import NEG_INF, mha_reference, window_too_far
from deepspeed_tpu_torch.ops.attention.paged import (
    paged_attention,
    paged_chunk_attention,
    resolve_impl,
    verify_extras,
    verify_rows,
)
from deepspeed_tpu_torch.ops.kernels import KERNELS
from deepspeed_tpu_torch.ops.quantizer.block_quant import quantize_kv_pair
from deepspeed_tpu_torch.ops.sparse_attention.splash import splash_prefill_attention
from deepspeed_tpu_torch.serving.resilience.faults import InjectedFault, get_fault_injector
from deepspeed_tpu_torch.utils.logging import log_dist

_CHUNK_BUCKETS = (1, 8, 32, 64, 128, 256, 512)


def _bucket(n):
    """The per-row step's chunk length for n tokens (the JAX package's)."""
    for b in _CHUNK_BUCKETS:
        if n <= b:
            return b
    return ((n + 255) // 256) * 256


def _later(what: str, item: str):
    return NotImplementedError(f"InferenceEngineV2: {what} is not ported yet ({item})")


def serving_benchmark(eng, n_seq=32, max_new=64, repeats=2, prompt_min=64,
                      prompt_max=512, seed=0):
    """The canonical serving-throughput workload of the JAX package: n_seq
    concurrent sequences of mixed prompt lengths, max_new generated tokens
    each. Returns the best generated tok/s over ``repeats`` passes after
    one warm pass (the wall clock ends on the host copy of the tokens)."""
    import time as _time

    rng = np.random.default_rng(seed)
    vocab = eng._mc.vocab_size

    def batch():
        return [
            rng.integers(0, vocab, size=(int(n),)).astype(np.int32)
            for n in rng.integers(prompt_min, prompt_max, size=n_seq)
        ]

    eng.generate(batch(), max_new_tokens=max_new)  # warm
    best = 0.0
    for _ in range(repeats):
        prompts = batch()
        t0 = _time.perf_counter()
        outs = eng.generate(prompts, max_new_tokens=max_new)
        dt = _time.perf_counter() - t0
        gen = sum(len(o) - len(p) for o, p in zip(outs, prompts))
        best = max(best, gen / dt)
    return best


def _materialize_rows(res: dict, want_tokens: bool = False) -> dict:
    """{uid: (logits tensor, row, token tensor)} -> {uid: host logits row,
    or host token with ``want_tokens``}, copying each distinct tensor to the
    host once (rows of one step share their tensors)."""
    hosts = {}
    out = {}
    for uid, (logits, idx, toks) in res.items():
        arr = toks if want_tokens else logits
        if id(arr) not in hosts:
            hosts[id(arr)] = arr.detach().cpu().numpy()
        out[uid] = hosts[id(arr)][idx]
    return out


def _device_wait(device: torch.device) -> None:
    """Block until the work queued so far on ``device``'s current stream
    has run (the outputs of the step just dispatched): the boundary of the
    ``engine.device_wait`` span. Nothing to wait for on the CPU."""
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        ev.synchronize()


def _trace_dispatch(tr, track: str, t0: float, device: torch.device, args: dict) -> None:
    """Close the ``engine.dispatch`` span opened at ``t0``, wait for the
    device, and write the ``engine.device_wait`` span (the JAX engine's
    pair, on the engine's track)."""
    tr.complete("engine.dispatch", t0, track=track, args=args)
    t1 = tr.now()
    _device_wait(device)
    tr.complete("engine.device_wait", t1, track=track)


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """A pool's numpy dtype in a KV payload (bf16 as its uint16 bits)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=dtype).numpy().dtype


def _upload(device, *arrays):
    """Host int32 arrays -> device tensors through ONE copy: the step's
    small metadata arrays are packed, copied, then split into views."""
    flat = torch.from_numpy(np.concatenate([np.asarray(a, np.int32).reshape(-1) for a in arrays]))
    dev = flat.to(device)
    out, off = [], 0
    for a in arrays:
        n = int(np.prod(np.shape(a), dtype=np.int64))
        out.append(dev[off : off + n].view(np.shape(a)))
        off += n
    return out


class InferenceEngineV2:
    def __init__(self, model_config: T.TransformerConfig, params,
                 config: Optional[RaggedInferenceEngineConfig] = None, device="cuda"):
        self.config = config or RaggedInferenceEngineConfig()
        self._mc = c = model_config
        self.device = torch.device(device)
        # the serving replica that owns this engine (``EngineCore`` names
        # it): its trace track and its fault-injection key; None alone
        self.replica_name: Optional[str] = None
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "InferenceEngineV2: no CUDA device is available; pass device='cpu' "
                "to run on the CPU"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"InferenceEngineV2: device {device!r} (expected cuda or cpu)")
        if c.position == "alibi":
            raise NotImplementedError(
                "v2 paged engine: alibi (bloom) is not supported — the paged "
                "attention kernel takes no bias"
            )
        if not c.attn_causal:
            raise ValueError(
                "v2 paged engine: encoder models (attn_causal=False) do not "
                "autoregressively generate — run models.transformer.forward()"
            )
        cfg = self.config
        kv = cfg.kv_cache
        if int(getattr(cfg, "tp_size", 1) or 1) > 1:
            raise _later("tp_size > 1", "ROADMAP queue 1, item 6: multi-GPU")
        if c.attn_sparsity is not None:
            # the steps serve the causal (windowed) mask: a sparsity layout
            # would be served as another mask than the one it trained with,
            # as the JAX engine serves it; no kernel lifts this refusal
            raise NotImplementedError(
                "InferenceEngineV2: serving an attn_sparsity layout is refused: the JAX "
                "engine serves such a model with the dense causal mask, not its own "
                "(ROADMAP section 3)")
        self._kv_dtype = _check_dtype(str(getattr(kv, "kv_cache_dtype", "bf16") or "bf16"))
        self._kv_int8 = self._kv_dtype == "int8"
        for knob, allowed in (("comm_quant", ("none", "int8")),
                              ("comm_overlap", ("none", "tiled"))):
            val = str(getattr(cfg, knob, "none") or "none")
            if val not in allowed:
                raise ValueError(f"{knob}={val!r}: expected one of {allowed}")
            # both are validated no-ops at tp_size=1, as in the JAX engine

        impl = str(getattr(cfg, "paged_attention_impl", "auto") or "auto")
        if impl not in ("auto", "kernel", "dense"):
            raise ValueError(
                f"paged_attention_impl={impl!r}: expected 'auto', 'kernel' or 'dense' "
                "(a typo must not silently fall back to the gather path)"
            )
        self._attn_impl = resolve_impl(impl, self.device.type, c.head_dim)

        self._dtype = T.DTYPES.get(cfg.dtype, torch.bfloat16)
        self.params = self._place(params)
        if getattr(cfg, "quant", None) is not None and cfg.quant.enabled:
            # after the dtype cast: the codes come from the served values
            from deepspeed_tpu_torch.inference.quantization import quantize_inference_params

            self.params = quantize_inference_params(self.params, bits=cfg.quant.bits,
                                                    group_size=cfg.quant.group_size)
        # one layer's slices (a quantized weight's too); each step body
        # widens them through _lp as it runs the layer, decided here once
        self._quantized = any(isinstance(w, T.QuantizedWeight)
                              for w in self.params["layers"].values())
        self._layer_params = [
            {k: w[li] for k, w in self.params["layers"].items()} for li in range(c.n_layers)
        ]
        self.state_manager = DSStateManager(cfg.state_manager, kv)
        self.scheduler = RaggedScheduler(
            cfg.state_manager,
            self.state_manager,
            prompt_chunk=int(getattr(cfg, "prompt_chunk", 0) or 0),
            max_prompt_chunks=int(getattr(cfg, "max_prompt_chunks", 0) or 0),
        )
        # +1 trash block: padded tail tokens of bucketed chunks scatter there
        # instead of corrupting block 0 (which belongs to a live sequence)
        shape = (c.n_layers, kv.num_blocks + 1, kv.block_size, c.kv_heads, c.head_dim)
        pool_dtype = torch.int8 if self._kv_int8 else self._dtype
        self._k_cache = torch.zeros(shape, dtype=pool_dtype, device=self.device)
        self._v_cache = torch.zeros(shape, dtype=pool_dtype, device=self.device)
        # int8: fp32 scale planes, one scalar per head vector (zero in the
        # trash block until a padded token writes there)
        self._ks_cache = self._vs_cache = None
        if self._kv_int8:
            self._ks_cache = torch.zeros(shape[:-1], dtype=torch.float32, device=self.device)
            self._vs_cache = torch.zeros(shape[:-1], dtype=torch.float32, device=self.device)
        # layer offsets of the flat pool views, for the per-step tables
        self._layer_off = torch.arange(c.n_layers, device=self.device, dtype=torch.int32) * (
            kv.num_blocks + 1
        )
        # the host block tier: LRU-evicted prefix-trie blocks demote their
        # K/V to a byte-budgeted host store; a trie miss the store covers
        # re-imports instead of re-prefilling (streams equal tier on or off)
        self._host_tier = None
        htb = int(getattr(kv, "host_tier_bytes", 0) or 0)
        if htb > 0:
            if self.state_manager.prefix_cache is None:
                raise ValueError(
                    "kv_cache.host_tier_bytes requires kv_cache.prefix_cache: "
                    "the host tier spills and readmits through the prefix trie"
                )
            self._host_tier = HostBlockStore(htb, validate=self._check_tier_entry)
            self.state_manager.prefix_cache.spill_fn = self._spill_block
            self.state_manager.host_readmit = self._host_readmit
        self._seed = int(getattr(cfg, "seed", 0) or 0)
        self._copy_stream = None  # import_kv_blocks_chunked's side stream, made on first use
        self._spec_rr = 0  # rotation cursor for budget-capped spec rounds
        self.last_spec = {"drafted": 0, "accepted": 0, "per_uid": {}}
        self.last_logprobs: Dict[int, np.ndarray] = {}
        self.last_scheduled_tokens = 0
        self.last_capped = set()
        log_dist(
            f"InferenceEngineV2: {kv.num_blocks} KV blocks × {kv.block_size} tokens, "
            f"budget {cfg.state_manager.max_ragged_batch_size} tok/step, "
            f"kv={self._kv_dtype}, attn={self._attn_impl}, device={self.device}"
            + (", prefix_cache=on" if self.state_manager.prefix_cache is not None else "")
            + (f", host_tier={htb}B" if self._host_tier is not None else ""),
            ranks=[0],
        )

    def _place(self, tree):
        """Floating parameters at the engine dtype on the engine device."""
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = self._place(v)
            else:
                v = torch.as_tensor(v)
                dt = self._dtype if v.is_floating_point() else v.dtype
                out[k] = v.to(device=self.device, dtype=dt).contiguous()
        return out

    @property
    def trace_track(self) -> str:
        """The timeline track of this engine's spans: its replica's name,
        or "engine"."""
        return self.replica_name or "engine"

    @property
    def paged_attention_impl(self) -> str:
        """The RESOLVED decode-attention impl ("kernel" or "dense")."""
        return self._attn_impl

    @property
    def kv_cache_dtype(self) -> str:
        """Pool payload dtype knob value: "bf16" (compute dtype) or "int8"."""
        return self._kv_dtype

    def kv_pool_info(self) -> Dict:
        """Byte-accounting snapshot (kv_pool.describe) plus the resolved
        attention impl: the JAX engine's dict."""
        c, kv = self._mc, self.config.kv_cache
        info = describe(kv.num_blocks, kv.block_size, c.kv_heads, c.head_dim, c.n_layers,
                        self._kv_dtype)
        info["paged_attention_impl"] = self._attn_impl
        return info

    # -- host KV export/import (the prefill -> decode handoff unit) ---------
    def _kv_pool_planes(self) -> Dict[str, torch.Tensor]:
        planes = {"k": self._k_cache, "v": self._v_cache}
        if self._kv_int8:
            planes["k_scale"] = self._ks_cache
            planes["v_scale"] = self._vs_cache
        return planes

    def _kv_payload_spec(self):
        """plane name -> ((n_layers, *per_block_tail), numpy dtype): the
        contract ``check_kv_payload`` validates against. numpy has no
        bfloat16, so a bf16 pool's planes travel as their bits (uint16)."""
        return {name: ((pool.shape[0],) + tuple(pool.shape[2:]), _np_dtype(pool.dtype))
                for name, pool in self._kv_pool_planes().items()}

    def _check_kv_payload(self, n: int, payload: Dict[str, np.ndarray],
                          context: str = "import_kv_blocks") -> None:
        check_kv_payload(self._kv_payload_spec(), n, payload, context=context)

    def export_kv_blocks(self, block_ids) -> Dict[str, np.ndarray]:
        """The pool planes of ``block_ids`` on the host, keyed by plane name:
        an int8 pool's codes and fp32 scale planes verbatim, so a re-import
        is bitwise (no requantization)."""
        idx = torch.as_tensor(np.asarray(list(block_ids), np.int64), device=self.device)
        out = {}
        for name, pool in self._kv_pool_planes().items():
            host = pool[:, idx].cpu()
            if host.dtype == torch.bfloat16:
                host = host.view(torch.int16)
            out[name] = host.numpy().view(_np_dtype(pool.dtype))
        return out

    def import_kv_blocks(self, block_ids, payload: Dict[str, np.ndarray]) -> None:
        """Write an exported payload into THIS pool at ``block_ids`` (the
        importer's freshly allocated table slots; ids need not match the
        exporter's), after ``check_kv_payload`` validates every plane. A
        JAX engine's int8 or fp32 payload imports as it is; a bf16 one's
        planes go as their bits (``plane.view(np.uint16)``). A device
        payload (``export_kv_blocks_device``'s tensors, or column slices of
        them) scatters without a host copy, held to the device window's
        contract."""
        n = len(block_ids)
        if n == 0:
            return
        idx = torch.as_tensor(np.asarray(list(block_ids), np.int64), device=self.device)
        if any(isinstance(p, torch.Tensor) for p in payload.values()):
            self._check_device_window(n, payload)
            for name, pool in self._kv_pool_planes().items():
                pool.index_copy_(1, idx, payload[name])
            return
        self._check_kv_payload(n, payload)
        for name, pool in self._kv_pool_planes().items():
            vals = torch.from_numpy(np.ascontiguousarray(payload[name]))
            if pool.dtype == torch.bfloat16:
                vals = vals.view(torch.int16).view(torch.bfloat16)
            pool[:, idx] = vals.to(self.device)

    # -- chunked and device-resident transports ----------------------------
    def _window_index(self, block_ids, chunk: int, skip: int = 0) -> np.ndarray:
        """Destination block ids padded to whole windows of ``chunk`` with
        the trash block (``num_blocks``); the first ``skip`` also trash."""
        trash = self.config.kv_cache.num_blocks
        n = len(block_ids)
        idx = np.full(-(-n // chunk) * chunk, trash, np.int64)
        idx[:n] = np.asarray(list(block_ids), np.int64)
        idx[: max(0, int(skip))] = trash
        return idx

    def _chunk_blocks(self, chunk_blocks: int) -> int:
        kv = self.config.kv_cache
        return int(chunk_blocks) or int(getattr(kv, "host_tier_chunk_blocks", 8) or 8)

    def _stage_windows(self, payload: Dict[str, np.ndarray], n: int,
                       chunk: int) -> Dict[str, torch.Tensor]:
        """The payload's planes copied once into host tensors laid out
        window by window ([n_win, L, chunk, *tail], so each window is one
        contiguous run), the tail window zero-filled; in pinned memory when
        the pool is on a card, so each window's copy to it is asynchronous."""
        n_win = -(-n // chunk)
        pin = self.device.type == "cuda"
        host = {}
        for name, pool in self._kv_pool_planes().items():
            src = torch.from_numpy(np.ascontiguousarray(payload[name]))
            if pool.dtype == torch.bfloat16:
                src = src.view(torch.int16).view(torch.bfloat16)
            t = torch.empty((n_win, pool.shape[0], chunk) + tuple(pool.shape[2:]),
                            dtype=pool.dtype, pin_memory=pin)
            for w in range(n_win):
                lo, hi = w * chunk, min((w + 1) * chunk, n)
                t[w, :, : hi - lo].copy_(src[:, lo:hi])
                t[w, :, hi - lo :].zero_()
            host[name] = t
        return host

    def import_kv_blocks_chunked(self, block_ids, payload: Dict[str, np.ndarray],
                                 chunk_blocks: int = 0) -> None:
        """``import_kv_blocks`` in fixed windows of ``chunk_blocks`` blocks
        (default ``kv_cache.host_tier_chunk_blocks``): the tail window's ids
        are padded with the trash block and its values zero-filled, so every
        window has one shape. Each window is one ``index_copy_`` per plane
        along the block axis. On a card the payload is staged once in
        pinned memory (``_stage_windows``) and the windows' copies run on a
        side stream into two device buffers, so window w + 1's copy runs
        while window w's scatter does (the double buffer); each scatter
        waits on its window's copy, each copy on the scatter that last read
        its buffer. Every plane moves, an int8 pool's scale planes too. With
        ``chunk_blocks`` 0, a payload of one window or less goes through
        ``import_kv_blocks``. The payload is validated first."""
        n = len(block_ids)
        if n == 0:
            return
        self._check_kv_payload(n, payload)
        chunk = self._chunk_blocks(chunk_blocks)
        if n <= chunk and chunk_blocks == 0:
            return self.import_kv_blocks(block_ids, payload)
        idx_dev = torch.from_numpy(self._window_index(block_ids, chunk)).to(self.device)
        planes = self._kv_pool_planes()
        host = self._stage_windows(payload, n, chunk)
        n_win = -(-n // chunk)
        if self.device.type != "cuda":
            for w in range(n_win):
                idx = idx_dev[w * chunk : (w + 1) * chunk]
                for name, pool in planes.items():
                    pool.index_copy_(1, idx, host[name][w])
            return
        main = torch.cuda.current_stream(self.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        side = self._copy_stream
        # the buffers come from the main stream's pool: the side stream
        # starts after the main stream's earlier work, and the main stream
        # waits on every copy, so later reuse of the buffers is ordered
        bufs = [{name: torch.empty_like(host[name][0], device=self.device) for name in planes}
                for _ in range(2)]
        read = [None, None]  # the event after the last scatter that read a buffer
        side.wait_stream(main)

        def issue(w):
            slot = bufs[w % 2]
            with torch.cuda.stream(side):
                if read[w % 2] is not None:
                    side.wait_event(read[w % 2])
                for name in planes:
                    slot[name].copy_(host[name][w], non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(side)
            return copied

        copied = issue(0)
        for w in range(n_win):
            nxt = issue(w + 1) if w + 1 < n_win else None
            main.wait_event(copied)
            idx = idx_dev[w * chunk : (w + 1) * chunk]
            for name, pool in planes.items():
                pool.index_copy_(1, idx, bufs[w % 2][name])
            read[w % 2] = torch.cuda.Event()
            read[w % 2].record(main)
            copied = nxt

    def export_kv_blocks_device(self, block_ids) -> Dict[str, torch.Tensor]:
        """``export_kv_blocks`` without the host copy: the pool planes of
        ``block_ids`` as tensors on the engine's device, which own their
        storage (the source's blocks may be freed and rewritten while the
        payload is in flight)."""
        idx = torch.as_tensor(np.asarray(list(block_ids), np.int64), device=self.device)
        return {name: pool.index_select(1, idx) for name, pool in self._kv_pool_planes().items()}

    def export_kv_blocks_windows(self, block_ids, chunk_blocks: int = 0):
        """The windowed device export, the dual of
        ``import_kv_blocks_chunked``: returns (windows, chunk), each window
        {plane: tensor of exactly ``chunk`` block columns}, the tail's ids
        padded with the trash block. Every gather is issued up front."""
        chunk = self._chunk_blocks(chunk_blocks)
        n = len(block_ids)
        if n == 0:
            return [], chunk
        idx_dev = torch.from_numpy(self._window_index(block_ids, chunk)).to(self.device)
        planes = self._kv_pool_planes()
        return [{name: pool.index_select(1, idx_dev[w : w + chunk])
                 for name, pool in planes.items()}
                for w in range(0, len(idx_dev), chunk)], chunk

    def _check_device_window(self, n: int, win: Dict[str, torch.Tensor]) -> None:
        """``check_kv_payload``'s contract for a device window: the pool's
        planes, each [L, n, *tail] in the pool's dtype on its device."""
        planes = self._kv_pool_planes()
        if set(win) != set(planes):
            raise ValueError(
                f"import_kv_blocks_device: payload planes {sorted(win)} do not match the "
                f"pool's {sorted(planes)}")
        for name, pool in planes.items():
            t = win[name]
            want = (pool.shape[0], n) + tuple(pool.shape[2:])
            if tuple(t.shape) != want or t.dtype != pool.dtype or t.device != pool.device:
                raise ValueError(
                    f"import_kv_blocks_device: payload[{name!r}] {tuple(t.shape)} {t.dtype} "
                    f"on {t.device}, expected {want} {pool.dtype} on {pool.device}")

    def import_kv_blocks_device(self, block_ids, windows, chunk_blocks: int,
                                skip_blocks: int = 0) -> int:
        """Scatter a windowed device export into THIS pool at ``block_ids``
        (the whole destination table, in the exporter's column order) with
        no host copy. The first ``skip_blocks`` destinations (a prefix this
        engine already holds) and the padded tail go to the trash block;
        windows wholly below ``skip_blocks`` are not touched. Returns the
        number of block columns written."""
        n = len(block_ids)
        chunk = int(chunk_blocks)
        if n == 0 or not windows:
            return 0
        if chunk <= 0:
            raise ValueError(f"import_kv_blocks_device: chunk_blocks={chunk_blocks} must be "
                             "positive (the exporter's window size)")
        n_win = -(-n // chunk)
        if len(windows) != n_win:
            raise ValueError(f"import_kv_blocks_device: {len(windows)} windows != {n_win} "
                             f"expected for {n} blocks at chunk {chunk}")
        for win in windows:
            self._check_device_window(chunk, win)
        trash = self.config.kv_cache.num_blocks
        idx_host = self._window_index(block_ids, chunk, skip_blocks)
        idx_dev = torch.from_numpy(idx_host).to(self.device)
        planes = self._kv_pool_planes()
        copied = 0
        for w in range(max(0, int(skip_blocks)) // chunk, n_win):
            idx = idx_dev[w * chunk : (w + 1) * chunk]
            for name, pool in planes.items():
                pool.index_copy_(1, idx, windows[w][name])
            copied += int(np.sum(idx_host[w * chunk : (w + 1) * chunk] != trash))
        return copied

    # -- host block tier ---------------------------------------------------
    @property
    def prefix_cache(self):
        """The pool's automatic prefix cache (None when kv_cache.prefix_cache
        is off). A cache-seeded sequence enters prefill with shared blocks
        and a nonzero start; the split step's chunk rows read them below the
        chunk start like any other context."""
        return self.state_manager.prefix_cache

    @property
    def host_tier(self):
        """The host block tier (None when kv_cache.host_tier_bytes is 0)."""
        return self._host_tier

    def _check_tier_entry(self, payload: Dict[str, np.ndarray]) -> None:
        """A host-tier entry is one block's column of the export payload
        ([L, block_size, kv_heads(, head_dim)] per plane): the block axis
        restored, it is held to the same contract as an import."""
        self._check_kv_payload(1, {name: p[:, None] for name, p in payload.items()},
                               context="host_tier.put")

    def _spill_block(self, hkey: bytes, block: int) -> None:
        """The prefix trie's eviction hook: one idle cached block's K/V to
        the host tier before its pool block returns to the free list."""
        store = self._host_tier
        if store is None:
            return
        tr = get_tracer()
        if tr.enabled:
            tr.instant("host_tier.spill", track=self.trace_track,
                       args={"block": int(block)})
        payload = self.export_kv_blocks([block])
        store.put(hkey, {name: plane[:, 0] for name, plane in payload.items()})

    def _host_readmit(self, seq, prompt_tokens, n_cached: int) -> int:
        """``seed_from_cache``'s continuation: after the trie covered
        ``n_cached`` prompt tokens, cover the next run of full blocks from
        the host tier (fresh pool blocks, the stored payloads through
        ``import_kv_blocks_chunked``, the prefix registered in the trie
        again). Returns the new cached-token count; prefill then charges
        only the tail. A ``host_tier.readmit`` fault, or a pool too tight,
        degrades to re-prefilling, with the same stream."""
        store = self._host_tier
        cache = self.state_manager.prefix_cache
        if store is None or cache is None or len(store) == 0:
            return n_cached
        faults = get_fault_injector()
        if faults.enabled:
            try:
                faults.check("host_tier.readmit", replica=self.replica_name)
            except InjectedFault:
                return n_cached  # before extend(): the pool is untouched
        toks = np.asarray(prompt_tokens).reshape(-1)
        bs = cache.block_size
        matchable = cache._matchable_blocks(len(toks))
        start = n_cached // bs
        if start >= matchable:
            return n_cached
        keys = chain_hashes(toks, bs, matchable)
        run = store.match(keys, start)
        if run == 0:
            return n_cached
        # payloads before allocating: extend() may evict, spill and drop
        # matched store entries
        payloads = []
        for key in keys[start : start + run]:
            entry = store.get(key)
            if entry is None:
                break
            payloads.append(entry)
        run = len(payloads)
        if run == 0:
            return n_cached
        if not self.state_manager.extend(seq, run * bs):
            return n_cached
        stacked = {name: np.stack([p[name] for p in payloads], axis=1) for name in payloads[0]}
        tr = get_tracer()
        with tr.span("host_tier.readmit", track=self.trace_track,
                     args={"blocks": run} if tr.enabled else None):
            self.import_kv_blocks_chunked(seq.block_table[start:], stacked)
        seq.seen_tokens = n_cached + run * bs
        store.note_readmits(run)
        cache.insert(toks[: seq.seen_tokens], seq.block_table)
        return seq.seen_tokens

    # -- warm spares ---------------------------------------------------------
    def trace_signature(self) -> Dict[str, int]:
        """What stands for a compile in the port: every kernel library this
        process has built or loaded (``kernel[name]``: 1). Eager PyTorch
        builds nothing per step shape, so shapes are not counted. Two
        snapshots that differ mean a kernel's first build or load at
        admission; on the CPU, where no kernel loads, it stays empty."""
        return {f"kernel[{name}]": 1 for name, k in KERNELS.items() if k.loaded}

    def warm_trace(self, decode_steps: int = 1, spec_k: int = 0,
                   uid: int = (1 << 30) + 7) -> Dict[str, int]:
        """Drive every step kind the serving loop will use before serving,
        so every kernel it launches is built or loaded, as the JAX engine's
        warm_trace compiles its programs: the split step at both chunk buckets
        (128 and ``prompt_chunk``), the fused round at ``decode_steps``, the
        verify step at ``spec_k``, the chunked import at a window and a
        padded tail, and the windowed device export and import. The throwaway
        sequences are finished and the prefix trie cleared afterwards (its
        spill hook is off meanwhile); sampling keys are content-addressed,
        so later streams are those of a cold engine. Returns the
        ``trace_signature``. Call after the final ``set_sampling``."""
        sched = self.scheduler
        vocab = int(getattr(self._mc, "vocab_size", 0) or 2)
        cache = self.state_manager.prefix_cache
        spill = getattr(cache, "spill_fn", None) if cache is not None else None
        if cache is not None:
            cache.spill_fn = None
        lens = [8]
        pc = int(sched.prompt_chunk)
        if pc > 128 and int(self.config.state_manager.max_context) > pc + 8:
            lens.append(pc)
        try:
            for i, length in enumerate(lens):
                wuid = uid + i
                toks = (np.arange(length, dtype=np.int32) % max(1, vocab - 1)) + 1
                sched.submit(wuid, toks)
                try:
                    tok = None
                    for _ in range(8 + length // max(1, pc)):
                        out = self.step_tokens()
                        if wuid in out:
                            tok = out[wuid]
                            break
                    if tok is None:
                        raise RuntimeError(
                            f"warm_trace: prefill of {length} tokens never produced a first "
                            "token")
                    sched.feedback(wuid, tok)
                    if i == 0:
                        if decode_steps > 1:
                            self.decode_round(int(decode_steps))
                        if spec_k > 0:
                            self.spec_round(int(spec_k), drafts={wuid: [1] * int(spec_k)})
                finally:
                    sched.finish(wuid)
            kv = self.config.kv_cache
            chunk = self._chunk_blocks(0)
            n = min(chunk + 1, int(kv.num_blocks))
            if n > chunk:
                blocks = list(range(n))
                self.import_kv_blocks_chunked(blocks, self.export_kv_blocks(blocks),
                                              chunk_blocks=chunk)
                wins, ch = self.export_kv_blocks_windows(blocks, chunk_blocks=chunk)
                self.import_kv_blocks_device(blocks, wins, ch)
        finally:
            if cache is not None:
                try:
                    cache.clear()  # warm prefixes must never serve a hit
                finally:
                    cache.spill_fn = spill
        return self.trace_signature()

    # -- sampling ------------------------------------------------------------
    def set_sampling(self, greedy=None, temperature=None, top_k=None, top_p=None, seed=None):
        """Update the sampling knobs; ``seed`` restarts the counter-hash
        keys. Nothing is rebuilt: the knobs are arguments of the draw, not of
        a compiled program as in the JAX engine."""
        cfg = self.config
        if greedy is not None:
            cfg.greedy = bool(greedy)
        if temperature is not None:
            cfg.temperature = float(temperature)
        if top_k is not None:
            cfg.top_k = int(top_k)
        if top_p is not None:
            cfg.top_p = float(top_p)
        if seed is not None:
            self._seed = int(seed)

    def _sampling_kw(self):
        cfg = self.config
        return dict(
            greedy=bool(getattr(cfg, "greedy", True)),
            top_k=int(getattr(cfg, "top_k", 0) or 0),
            top_p=float(getattr(cfg, "top_p", 0.0) or 0.0),
        )

    # ------------------------------------------------------------------
    def _sample(self, logits, uids, positions, return_logprobs=False):
        """Next tokens for [R, vocab] logits, keyed on (seed, uid, position
        of the logits source) like the JAX package's row_keys."""
        kw = self._sampling_kw()
        keys = None if kw["greedy"] else row_keys(self._seed, uids, positions)
        return sample_tokens(
            logits.float(), keys,
            temperature=float(getattr(self.config, "temperature", 1.0) or 1.0),
            return_logprobs=return_logprobs, **kw,
        )

    # ------------------------------------------------------------------
    def _pool_views(self):
        """Flat multi-layer block-pool views [L*NBp, bs, nkv, d] (views of
        the contiguous pools: no copy)."""
        c, kv = self._mc, self.config.kv_cache
        shape = (c.n_layers * (kv.num_blocks + 1), kv.block_size, c.kv_heads, c.head_dim)
        return self._k_cache.view(shape), self._v_cache.view(shape)

    def _scale_views(self):
        """Flat views [L*NBp, bs, nkv] of the int8 pools' scale planes (the
        layer-offset indexing of ``_pool_views``), or (None, None)."""
        if not self._kv_int8:
            return None, None
        c, kv = self._mc, self.config.kv_cache
        shape = (c.n_layers * (kv.num_blocks + 1), kv.block_size, c.kv_heads)
        return self._ks_cache.view(shape), self._vs_cache.view(shape)

    def _trash(self, li: int) -> int:
        kv = self.config.kv_cache
        return li * (kv.num_blocks + 1) + kv.num_blocks

    def _scatter_kv(self, li, blk, row, k, v):
        """Write the new tokens' K/V into the pools IN PLACE through one
        index_put on a flat slot view [L*NBp*bs, nkv, d] (the JAX package
        scatters into a donated buffer instead). blk/row: [t] int32. An
        int8 pool quantizes on write (``quantize_kv_pair``, per head vector,
        K and V in one launch) and its scales go through the same slot
        ids."""
        c, kv = self._mc, self.config.kv_cache
        L, NBp, bs = c.n_layers, kv.num_blocks + 1, kv.block_size
        slot = ((li * NBp + blk.long()) * bs + row.long())
        flat = (L * NBp * bs, c.kv_heads, c.head_dim)
        if self._kv_int8:
            (k, sk), (v, sv) = quantize_kv_pair(k, v)
            self._ks_cache.view(flat[:2])[slot] = sk
            self._vs_cache.view(flat[:2])[slot] = sv
        self._k_cache.view(flat)[slot] = k.to(self._k_cache.dtype)
        self._v_cache.view(flat)[slot] = v.to(self._v_cache.dtype)

    def _window(self, li: int) -> int:
        c = self._mc
        if c.attn_layer_pattern is None:
            return int(c.sliding_window or 0)
        return int(c.sliding_window or 0) if c.attn_layer_pattern[li] else 0

    def _lp(self, li: int):
        """Layer ``li``'s params at the engine dtype: a quantized model's
        weights dequantized for this step (one layer wide at a time)."""
        if self._quantized:
            return T._dequant_tree(self._layer_params[li], self._dtype)
        return self._layer_params[li]

    def _layer_qkv(self, lp, x, positions, live: int):
        """Shared per-layer prologue: pre-norm → QKV projections (+ biases)
        → qk-norm → rope. x: [t, h]; returns [t, nh|nkv, d] heads."""
        c = self._mc
        nh, nkv, d = c.n_heads, c.kv_heads, c.head_dim
        t = x.shape[0]
        a = T._norm(x, lp["attn_norm"], lp.get("attn_norm_b"), c.norm, c.norm_eps)
        q, k, v = a @ lp["wq"], a @ lp["wk"], a @ lp["wv"]
        if c.attn_qkv_bias:
            q, k, v = q + lp["wq_b"], k + lp["wk_b"], v + lp["wv_b"]
        q = q.reshape(t, nh, d)
        k = k.reshape(t, nkv, d)
        v = v.reshape(t, nkv, d)
        if c.qk_norm:
            q = T.qk_norm_apply(c, q, lp["q_norm"], head_axis=1, b=lp.get("q_norm_b"))
            k = T.qk_norm_apply(c, k, lp["k_norm"], head_axis=1, b=lp.get("k_norm_b"))
        if c.position == "rope":
            q = T._rope(q.transpose(0, 1)[None], positions[None], c, live)[0].transpose(0, 1)
            k = T._rope(k.transpose(0, 1)[None], positions[None], c, live)[0].transpose(0, 1)
        return q.contiguous(), k.contiguous(), v

    def _layer_tail(self, lp, x, out):
        """Shared per-layer epilogue: wo projection (+ bias), then the
        parallel-block or sequential residual + MLP."""
        c = self._mc
        t = x.shape[0]
        attn_out = out.reshape(t, c.n_heads * c.head_dim) @ lp["wo"]
        if c.attn_out_bias:
            attn_out = attn_out + lp["wo_b"]
        if c.parallel_block:
            m = T._norm(x, lp["mlp_norm"], lp.get("mlp_norm_b"), c.norm, c.norm_eps)
            return x + attn_out + T._mlp_block(c, lp, m)[0]
        x = x + attn_out
        m = T._norm(x, lp["mlp_norm"], lp.get("mlp_norm_b"), c.norm, c.norm_eps)
        return x + T._mlp_block(c, lp, m)[0]

    def _final(self, x):
        c = self._mc
        return T._norm(x, self.params["final_norm"], self.params.get("final_norm_b"),
                       c.norm, c.norm_eps)

    # ------------------------------------------------------------------
    def _split_layer(self, li, x, meta):
        """One layer of the split-phase step: the packed token axis is
        [R decode slots | Rc chunks x tq tokens]. Projections, norms and the
        MLP run on the whole batch; attention splits into the decode rows
        (paged_attention, their own K/V as one extra column, pool limited
        to positions below theirs) and the chunk rows (paged_chunk_attention
        over the chunk's fresh K/V plus the pool below the chunk start).
        The pools are written after attention."""
        c = self._mc
        lp = self._lp(li)
        nh, nkv, d = c.n_heads, c.kv_heads, c.head_dim
        R, Rc, tq = meta["R"], meta["Rc"], meta["tq"]
        w = self._window(li)
        q, k, v = self._layer_qkv(lp, x, meta["positions"], meta["live"])
        k_pool, v_pool = self._pool_views()
        ks_pool, vs_pool = self._scale_views()
        dec_pos = meta["dec_pos"]
        out_d = paged_attention(
            q[:R], k_pool, v_pool, meta["dec_tables"][li], dec_pos, self._trash(li),
            impl=self._attn_impl, window=w, scale=c.attn_scale, k_scale=ks_pool,
            v_scale=vs_pool, extra_kv=(k[:R, None], v[:R, None], dec_pos[:, None]),
            pool_limit=dec_pos,
        )
        out_c = paged_chunk_attention(
            q[R:].reshape(Rc, tq, nh, d), k_pool, v_pool, meta["chk_tables"][li],
            meta["chk_pos"], self._trash(li), window=w, scale=c.attn_scale,
            new_kv=(k[R:].reshape(Rc, tq, nkv, d), v[R:].reshape(Rc, tq, nkv, d)),
            pool_limit=meta["chk_start"], k_scale=ks_pool, v_scale=vs_pool,
        )
        self._scatter_kv(li, meta["blk"], meta["row"], k, v)
        out = torch.cat([out_d, out_c.reshape(Rc * tq, nh, d)], dim=0)
        return self._layer_tail(lp, x, out)

    def _round_layer(self, li, x, meta, side_k, side_v):
        """One layer of one step of a fused decode round: queries are the
        round's step-``s`` tokens (one per row); context = the pool below
        each row's round start + the round's tokens so far from the side
        buffers [L, R, n, nkv, d] (written in place before attention: the
        query sees itself)."""
        c = self._mc
        lp = self._lp(li)
        q, k, v = self._layer_qkv(lp, x, meta["pos"], meta["live"])
        s = meta["s"]
        side_k[li, :, s] = k
        side_v[li, :, s] = v
        k_pool, v_pool = self._pool_views()
        ks_pool, vs_pool = self._scale_views()
        out = paged_attention(
            q, k_pool, v_pool, meta["tables"][li], meta["pos"], self._trash(li),
            impl=self._attn_impl, window=self._window(li), scale=c.attn_scale,
            k_scale=ks_pool, v_scale=vs_pool,
            extra_kv=(side_k[li], side_v[li], meta["epos"]), pool_limit=meta["pos0"],
        )
        self._scatter_kv(li, meta["blk"], meta["row"], k, v)
        return self._layer_tail(lp, x, out)

    # ------------------------------------------------------------------
    def decode_round(self, n_steps: Optional[int] = None) -> Dict[int, np.ndarray]:
        """One fused decode round: ``n_steps`` tokens for every eligible
        RUNNING sequence, the sampled token fed back on the device. Only
        legal when no prompt chunks are pending. Returns {uid: [n_steps]
        generated tokens}; sequences that cannot take a full round (near
        max_context or the block cap, or waiting on blocks) are left to the
        per-step path, as in the JAX engine."""
        n = int(n_steps or self.config.decode_steps)
        sched = self.scheduler
        if sched.has_pending():
            raise RuntimeError(
                "decode_round: prompt chunks are still pending — drive step() "
                "until prefill completes before fused decode"
            )
        c = self._mc
        max_context = self.config.state_manager.max_context
        R = self.config.state_manager.max_ragged_sequence_count
        uids = []
        for uid in sched.running_uids():
            if len(uids) >= R:
                break
            seq = self.state_manager.get_sequence(uid)
            if seq.seen_tokens + n > max_context:
                continue
            if self.state_manager.seq_capped(seq, n):
                continue
            if not self.state_manager.extend(seq, n):
                continue
            uids.append(uid)
        if not uids:
            return {}
        tr = get_tracer()
        t0 = tr.now() if tr.enabled else 0.0
        kv = self.config.kv_cache
        B, bs, trash = kv.max_blocks_per_seq, kv.block_size, kv.num_blocks
        tokens = np.zeros(R, np.int32)
        pos0 = np.zeros(R, np.int32)
        tables = np.full((R, B), trash, np.int32)
        uid_arr = np.zeros(R, np.int32)
        active = np.zeros(R, bool)
        for i, uid in enumerate(uids):
            seq = self.state_manager.get_sequence(uid)
            tokens[i] = sched.peek_next_token(uid)
            pos0[i] = seq.seen_tokens
            tables[i, : len(seq.block_table)] = seq.block_table
            uid_arr[i] = uid
            active[i] = True
        tables = np.where(active[:, None], tables, trash).astype(np.int32)
        j = np.arange(n, dtype=np.int32)
        toks, tables_d, uids_d, pos0_d, act_d = _upload(
            self.device, tokens, tables, uid_arr, np.where(active, pos0, 0), active
        )
        tables_l = tables_d[None] + self._layer_off[:, None, None]  # [L, R, B]
        act_d = act_d.bool()
        side_shape = (c.n_layers, R, n, c.kv_heads, c.head_dim)
        side_k = torch.zeros(side_shape, dtype=self._dtype, device=self.device)
        side_v = torch.zeros(side_shape, dtype=self._dtype, device=self.device)
        toks_out, logps_out = [], []
        for s in range(n):
            # positions advance on the host: no device read inside the round
            pos = (pos0 + s * active).astype(np.int32)
            blk = tables[np.arange(R), np.clip(pos // bs, 0, B - 1)]
            epos = np.where((j[None] <= s) & active[:, None], pos0[:, None] + j[None], -1)
            pos_d, blk_d, row_d, epos_d, key_pos = _upload(
                self.device, pos, blk, pos % bs, epos, np.where(active, pos, -1)
            )
            meta = {
                "tables": tables_l, "pos": pos_d, "pos0": pos0_d, "s": s,
                "epos": epos_d, "blk": blk_d, "row": row_d,
                "live": int(np.max(np.where(active, pos, 0))) + 1,
            }
            x = T.embed_tokens(self.params, toks, pos_d, c)
            for li in range(c.n_layers):
                x = self._round_layer(li, x, meta, side_k, side_v)
            logits = T._apply_lm_head(self.params, self._final(x), c)
            nxt, logp = self._sample(logits, uids_d, key_pos, return_logprobs=True)
            toks = torch.where(act_d, nxt, toks)  # inactive rows freeze
            toks_out.append(toks)
            logps_out.append(logp)
        if tr.enabled:
            _trace_dispatch(tr, self.trace_track, t0, self.device,
                            {"rows": len(uids), "steps": n})
        toks_h = torch.stack(toks_out).cpu().numpy()  # [n, R]
        logps_h = torch.stack(logps_out).cpu().numpy()
        results: Dict[int, np.ndarray] = {}
        self.last_logprobs = {}
        for i, uid in enumerate(uids):
            gen = toks_h[:, i]
            sched.apply_decode_round(uid, gen)
            results[uid] = gen
            self.last_logprobs[uid] = logps_h[:, i]
        return results

    # ------------------------------------------------------------------
    def _verify_layer(self, li, x, meta):
        """One layer of the speculative verify step: R rows of K1 tokens
        each, flattened to R * K1 query rows. Attention is the verify form
        of ``paged_attention`` (``paged.verify_rows`` / ``verify_extras``):
        each query row reads its row's pool below the row's write cursor
        and the row's K1 fresh K/V as extras, whose positions make the
        in-chunk causal mask (a padded slot, at -1, sees nothing). The
        pools are written after attention."""
        c = self._mc
        lp = self._lp(li)
        q, k, v = self._layer_qkv(lp, x, meta["pos"], meta["live"])
        k_pool, v_pool = self._pool_views()
        ks_pool, vs_pool = self._scale_views()
        ke, ve = verify_extras(k, v, meta["K1"])
        out = paged_attention(
            q, k_pool, v_pool, meta["tables"][li], meta["qpos"], self._trash(li),
            impl=self._attn_impl, window=self._window(li), scale=c.attn_scale,
            k_scale=ks_pool, v_scale=vs_pool, extra_kv=(ke, ve, meta["epos"]),
            pool_limit=meta["limit"],
        )
        self._scatter_kv(li, meta["blk"], meta["row"], k, v)
        return self._layer_tail(lp, x, out)

    def _verify_step(self, k: int, tokens, positions0, tables, uids, active, n_input):
        """The speculative verify step (the JAX engine's
        ``_build_verify_step``): every active row scores its pending token
        and up to k drafts (tokens [R, K1], K1 = k + 1, at positions
        p..p+k; padded slots at qpos -1 write to the trash block) in one
        forward, draws the TARGET token at every position with the key
        plain decode would use (``row_keys(seed, uid, position)``), and
        accepts the longest draft prefix equal to the targets. Returns device
        tensors (targets and n_emit as one int32 [R, K1 + 1]: n_emit =
        accepted + 1, 0 for inactive rows, in the last column; logprobs
        [R, K1]), copied to the host by ``spec_round``."""
        c, kv = self._mc, self.config.kv_cache
        R, K1 = tokens.shape
        B, bs, trash = kv.max_blocks_per_seq, kv.block_size, kv.num_blocks
        j = np.arange(K1, dtype=np.int32)
        pos = positions0[:, None] + j[None]  # [R, K1]
        valid = (j[None] < n_input[:, None]) & active[:, None]
        qpos = np.where(valid, pos, -1).astype(np.int32)
        tok_tables = np.where(active[:, None], tables, trash).astype(np.int32)
        blk = np.take_along_axis(tok_tables, np.clip(pos // bs, 0, B - 1), axis=1)
        blk = np.where(valid, blk, trash).astype(np.int32)
        (tokens_d, pos_d, qpos_d, tables_d, lim_d, blk_d, row_d, uids_d, n_in_d,
         act_d) = _upload(self.device, tokens, pos, qpos, tok_tables,
                          np.where(active, positions0, 0), blk, pos % bs, uids, n_input, active)
        rep_tables, qpos_flat, rep_lim, epos = verify_rows(tables_d, qpos_d, lim_d)
        meta = {
            "K1": K1, "pos": pos_d.reshape(R * K1), "qpos": qpos_flat, "limit": rep_lim,
            "epos": epos, "tables": rep_tables[None] + self._layer_off[:, None, None],
            "blk": blk_d.reshape(R * K1), "row": row_d.reshape(R * K1),
            # rope's live length from valid positions only: padded slots
            # would flip a longrope switch early
            "live": int(np.max(np.where(valid, pos, 0))) + 1,
        }
        x = T.embed_tokens(self.params, tokens_d.reshape(R * K1), meta["pos"], c)
        for li in range(c.n_layers):
            x = self._verify_layer(li, x, meta)
        logits = T._apply_lm_head(self.params, self._final(x), c)  # [R * K1, vocab]
        tgt, logp = self._sample(logits, uids_d.repeat_interleave(K1), qpos_flat,
                                 return_logprobs=True)
        tgt = tgt.reshape(R, K1)
        jj = torch.arange(k, device=self.device)
        match = (tokens_d[:, 1:] == tgt[:, :k]) & (jj[None] < (n_in_d - 1)[:, None])
        n_acc = torch.cumprod(match.int(), dim=1).sum(dim=1)
        n_emit = torch.where(act_d.bool(), n_acc + 1, torch.zeros_like(n_acc))
        return torch.cat([tgt, n_emit[:, None].to(torch.int32)], dim=1), logp.reshape(R, K1)

    def spec_round(self, k: Optional[int] = None, drafts=None) -> Dict[int, np.ndarray]:
        """One speculative draft-and-verify round over the eligible RUNNING
        rows (the JAX engine's ``spec_round``). ``drafts``: {uid: proposed
        next tokens (<= k)}; a row without one verifies zero drafts, a
        plain one-token decode in the same step. Returns {uid: emitted
        tokens (1..k+1), those plain decode emits}; ``last_spec`` holds the
        round's drafted and accepted counts. Eligibility is
        ``decode_round``'s (the context limit, the block cap, blocks for
        the row's own draft); rejected drafts' blocks are rolled back by
        ``scheduler.apply_spec_round``. At most budget // (k + 1) rows run,
        from a start that rotates so a capped round starves no uid."""
        k = int(k if k is not None else getattr(self.config, "spec_k", 0) or 0)
        if k < 1:
            raise ValueError(f"spec_round needs k >= 1 draft slots, got {k}")
        drafts = drafts or {}
        sched = self.scheduler
        if sched.has_pending():
            raise RuntimeError(
                "spec_round: prompt chunks are still pending — drive step() "
                "until prefill completes before speculative decode"
            )
        sm = self.config.state_manager
        R, K1 = sm.max_ragged_sequence_count, k + 1
        max_rows = min(R, max(1, sm.max_ragged_batch_size // K1))
        run = sched.running_uids()
        if len(run) > max_rows:
            off = self._spec_rr % len(run)
            run = run[off:] + run[:off]
            self._spec_rr += max_rows
        uids, row_drafts = [], []
        pre_blocks: Dict[int, int] = {}
        for uid in run:
            if len(uids) >= max_rows:
                break
            seq = self.state_manager.get_sequence(uid)
            d = [int(t) for t in drafts.get(uid, ())][:k]
            n = len(d) + 1
            if seq.seen_tokens + n > sm.max_context:
                continue
            if self.state_manager.seq_capped(seq, n):
                continue
            pre = len(seq.block_table)
            if not self.state_manager.extend(seq, n):
                continue
            uids.append(uid)
            row_drafts.append(d)
            pre_blocks[uid] = pre
        if not uids:
            return {}
        kv = self.config.kv_cache
        tokens = np.zeros((R, K1), np.int32)
        positions = np.zeros(R, np.int32)
        tables = np.full((R, kv.max_blocks_per_seq), kv.num_blocks, np.int32)
        uid_arr = np.zeros(R, np.int32)
        active = np.zeros(R, bool)
        n_input = np.ones(R, np.int32)
        for i, (uid, d) in enumerate(zip(uids, row_drafts)):
            seq = self.state_manager.get_sequence(uid)
            tokens[i, 0] = sched.peek_next_token(uid)
            tokens[i, 1 : 1 + len(d)] = d
            positions[i] = seq.seen_tokens
            tables[i, : len(seq.block_table)] = seq.block_table
            uid_arr[i] = uid
            active[i] = True
            n_input[i] = 1 + len(d)
        tr = get_tracer()
        t0 = tr.now() if tr.enabled else 0.0
        out, logp = self._verify_step(k, tokens, positions, tables, uid_arr, active, n_input)
        if tr.enabled:
            _trace_dispatch(tr, self.trace_track, t0, self.device,
                            {"rows": len(uids), "k": k})
        host = out.cpu().numpy()
        tgt, n_emit, logp = host[:, :K1], host[:, K1], logp.cpu().numpy()
        results: Dict[int, np.ndarray] = {}
        self.last_logprobs = {}
        drafted_total = accepted_total = 0
        per_uid: Dict[int, Tuple[int, int]] = {}
        for i, uid in enumerate(uids):
            n = int(n_emit[i])
            gen = tgt[i, :n].astype(np.int32)
            sched.apply_spec_round(uid, gen, pre_blocks[uid])
            results[uid] = gen
            self.last_logprobs[uid] = logp[i, :n]
            d, a = int(n_input[i]) - 1, n - 1
            drafted_total += d
            accepted_total += a
            per_uid[uid] = (d, a)
        self.last_spec = {"drafted": drafted_total, "accepted": accepted_total,
                          "per_uid": per_uid}
        return results

    def put(self, batch_uids, batch_tokens) -> Dict[int, np.ndarray]:
        """Submit new sequences (reference put :107) and run ONE engine step.
        Returns {uid: logits} for sequences whose scheduled tokens completed a
        prompt or decode step this round."""
        for uid, toks in zip(batch_uids, batch_tokens):
            self.scheduler.submit(uid, toks)
        return self.step()

    def step(self) -> Dict[int, np.ndarray]:
        """One engine step; returns host fp32 logits per completed row."""
        return _materialize_rows(self._step_device())

    def step_tokens(self) -> Dict[int, int]:
        """One engine step returning ``{uid: next-token int}`` (the sampled
        token computed with the step, never a host argmax). With tracing on
        the step is split into ``engine.dispatch`` (``_step_device``: host
        staging and the launches) and ``engine.device_wait``; the split
        wraps the caller, so ``_step_device`` itself stays free of waits."""
        tr = get_tracer()
        if not tr.enabled:
            rows = _materialize_rows(self._step_device(), want_tokens=True)
            return {uid: int(tok) for uid, tok in rows.items()}
        t0 = tr.now()
        res = self._step_device()
        _trace_dispatch(tr, self.trace_track, t0, self.device,
                        {"rows": len(res), "tokens": int(self.last_scheduled_tokens or 0)})
        rows = _materialize_rows(res, want_tokens=True)
        return {uid: int(tok) for uid, tok in rows.items()}

    def _step_device(self) -> Dict[int, tuple]:
        """The split-phase step: stage the scheduler's batch onto the fixed
        [R decode slots | Rc chunks x tq] grid, run the layers, return
        {uid: (logits tensor, row, token tensor)} for rows whose prompt (or
        decode token) completed. Nothing here waits for the device."""
        batch = self.scheduler.next_batch()
        self.last_scheduled_tokens = batch.total_tokens if batch is not None else 0
        self.last_capped |= self.scheduler.drain_capped()
        if batch is None:
            return {}
        c = self._mc
        kv = self.config.kv_cache
        R = self.config.state_manager.max_ragged_sequence_count
        Rc = self.scheduler.max_prompt_chunks
        B, bs, trash = kv.max_blocks_per_seq, kv.block_size, kv.num_blocks

        dec_rows = [
            (uid, toks, start)
            for uid, toks, start, dec in zip(
                batch.uids, batch.tokens, batch.start_positions, batch.is_decode
            )
            if dec
        ]
        chk_rows = [
            (uid, toks, start, chunked)
            for uid, toks, start, chunked, dec in zip(
                batch.uids, batch.tokens, batch.start_positions,
                batch.is_prompt_chunk, batch.is_decode,
            )
            if not dec
        ]
        if len(dec_rows) > R or len(chk_rows) > Rc:
            raise RuntimeError(
                f"split-phase batch overflow: {len(dec_rows)} decode rows "
                f"(cap {R}), {len(chk_rows)} prompt chunks (cap {Rc})"
            )
        max_chunk = max((len(t) for _, t, _, _ in chk_rows), default=1)
        # two chunk-length buckets, as in the JAX engine (same padding, so
        # the two engines run the same shapes)
        tq = 128 if max_chunk <= 128 else self.scheduler.prompt_chunk
        tq = min(tq, self.scheduler.prompt_chunk)
        T_ = R + Rc * tq

        tokens = np.zeros(T_, np.int32)
        positions = np.zeros(T_, np.int32)
        blk = np.full(T_, trash, np.int32)
        row = np.zeros(T_, np.int32)
        dec_tables = np.full((R, B), trash, np.int32)
        dec_pos = np.full(R, -1, np.int32)  # -1 = inactive slot (masks all)
        dec_uids = np.zeros(R, np.int32)
        chk_tables = np.full((Rc, B), trash, np.int32)
        chk_pos = np.full((Rc, tq), -1, np.int32)
        chk_start = np.zeros(Rc, np.int32)  # 0 = inactive (empty pool window)
        chk_last = np.zeros(Rc, np.int32)
        chk_uids = np.zeros(Rc, np.int32)

        for i, (uid, toks, start) in enumerate(dec_rows):
            seq = self.state_manager.get_sequence(uid)
            tokens[i] = toks[0]
            positions[i] = start
            nblk = len(seq.block_table)
            dec_tables[i, :nblk] = seq.block_table
            dec_pos[i] = start
            dec_uids[i] = uid
            blk[i] = seq.block_table[min(start // bs, nblk - 1)]
            row[i] = start % bs
        for j, (uid, toks, start, _chunked) in enumerate(chk_rows):
            seq = self.state_manager.get_sequence(uid)
            n = len(toks)
            off = R + j * tq
            tokens[off : off + n] = toks
            pos = start + np.arange(n)
            positions[off : off + n] = pos
            nblk = len(seq.block_table)
            chk_tables[j, :nblk] = seq.block_table
            chk_pos[j, :n] = pos
            chk_start[j] = start
            chk_uids[j] = uid
            blk[off : off + n] = np.asarray(seq.block_table, np.int32)[np.minimum(pos // bs, nblk - 1)]
            row[off : off + n] = pos % bs
            chk_last[j] = off + n - 1
        chk_src = positions[np.clip(chk_last, 0, T_ - 1)]

        (tokens_d, positions_d, blk_d, row_d, dec_tables_d, dec_pos_d, dec_uids_d,
         chk_tables_d, chk_pos_d, chk_start_d, chk_last_d, chk_uids_d, chk_src_d) = _upload(
            self.device, tokens, positions, blk, row, dec_tables, dec_pos, dec_uids,
            chk_tables, chk_pos, chk_start, np.clip(chk_last, 0, T_ - 1), chk_uids, chk_src,
        )
        off = self._layer_off[:, None, None]
        meta = {
            "R": R, "Rc": Rc, "tq": tq, "positions": positions_d,
            "blk": blk_d, "row": row_d,
            # live length (HF max(position_ids)+1) for the rope-scaling
            # switch: padded slots carry position 0, so the plain max works
            "live": int(positions.max()) + 1,
            "dec_tables": dec_tables_d[None] + off, "dec_pos": dec_pos_d,
            "chk_tables": chk_tables_d[None] + off, "chk_pos": chk_pos_d,
            "chk_start": chk_start_d,
        }
        x = T.embed_tokens(self.params, tokens_d, positions_d, c)
        for li in range(c.n_layers):
            x = self._split_layer(li, x, meta)
        x = self._final(x)
        logits_dec = T._apply_lm_head(self.params, x[:R], c).float()
        logits_chk = T._apply_lm_head(self.params, x[chk_last_d.long()], c).float()
        toks_dec = self._sample(logits_dec, dec_uids_d, dec_pos_d)
        toks_chk = self._sample(logits_chk, chk_uids_d, chk_src_d)

        results: Dict[int, tuple] = {}
        for i, (uid, toks, _start) in enumerate(dec_rows):
            seq = self.state_manager.get_sequence(uid)
            seq.seen_tokens += len(toks)
            results[uid] = (logits_dec, i, toks_dec)
        for j, (uid, toks, _start, chunked) in enumerate(chk_rows):
            seq = self.state_manager.get_sequence(uid)
            seq.seen_tokens += len(toks)
            if not chunked:  # prompt complete: last-token logits usable
                results[uid] = (logits_chk, j, toks_chk)
        return results

    # ------------------------------------------------------------------
    def _row_step(self, tokens, start: int, n_valid: int, table):
        """One sequence's bucketed chunk (or decode token) through every
        layer: the port's form of the JAX package's ``_build_row_step``.
        tokens: [t] host int32 (the first ``n_valid`` real, the tail
        padding); start: the first position; table: the sequence's [B]
        block table. Writes the chunk's K/V into the pools (the padded
        tail's into the trash block), then attends over the gathered
        context of S = B × block_size keys. An int8 pool attends first,
        through ``paged_attention`` (the engine's impl: the int8 kernel on a
        card) over the pool below ``start`` with the chunk's own K/V as
        extra columns (the padded tail's at epos -1), then quantizes and
        writes; the JAX engine's per-row step does the same through its
        dense impl. Returns the fp32 logits [vocab] of the last valid
        token."""
        c, kv = self._mc, self.config.kv_cache
        nh, nkv, d = c.n_heads, c.kv_heads, c.head_dim
        bs, B = kv.block_size, kv.max_blocks_per_seq
        S = B * bs
        t = len(tokens)
        glob = start + np.arange(t, dtype=np.int32)  # global positions of the chunk
        blk = np.where(np.arange(t) < n_valid, table[np.clip(glob // bs, 0, B - 1)],
                       kv.num_blocks)
        epos = np.where(np.arange(t) < n_valid, glob, -1)
        tokens_d, pos_d, blk_d, row_d, table_d, epos_d, start_d = _upload(
            self.device, tokens, glob, blk, glob % bs, table, epos, np.full(t, start))
        splash = c.attention_impl == "splash" and c.sliding_window > 0 and not self._kv_int8
        if not splash and not self._kv_int8:
            kpos = torch.arange(S, device=self.device)
            mask = kpos[None, :] <= pos_d[:, None]  # [t, S] causal against global positions
            if c.sliding_window:
                mask &= ~window_too_far(pos_d[:, None], kpos[None, :], c.sliding_window)
            bias = torch.where(mask, 0.0, NEG_INF)[None, None]
        k_pool, v_pool = self._pool_views()
        ks_pool, vs_pool = self._scale_views()
        x = T.embed_tokens(self.params, tokens_d, pos_d, c)
        for li in range(c.n_layers):
            lp = self._lp(li)
            # live length (HF max(position_ids)+1) from the valid tokens only
            q, k, v = self._layer_qkv(lp, x, pos_d, start + n_valid)
            if self._kv_int8:
                tbl = (table_d + li * (kv.num_blocks + 1))[None].expand(t, B)
                out = paged_attention(
                    q, k_pool, v_pool, tbl, pos_d, self._trash(li), impl=self._attn_impl,
                    window=c.sliding_window, scale=c.attn_scale, k_scale=ks_pool,
                    v_scale=vs_pool, pool_limit=start_d,
                    extra_kv=(k[None].expand(t, t, nkv, d), v[None].expand(t, t, nkv, d),
                              epos_d[None].expand(t, t)),
                )
                self._scatter_kv(li, blk_d, row_d, k, v)
                x = self._layer_tail(lp, x, out)
                continue
            self._scatter_kv(li, blk_d, row_d, k, v)
            tbl = (table_d + li * (kv.num_blocks + 1)).long()
            k_ctx = k_pool[tbl].reshape(S, nkv, d).transpose(0, 1)[None]
            v_ctx = v_pool[tbl].reshape(S, nkv, d).transpose(0, 1)[None]
            qh = q.transpose(0, 1)[None]  # [1, nh, t, d]
            if splash:
                out = splash_prefill_attention(qh, k_ctx, v_ctx, start, window=c.sliding_window,
                                               block_kv=bs, scale=c.attn_scale)
            else:
                out = mha_reference(qh, k_ctx, v_ctx, causal=False, bias=bias,
                                    scale=c.attn_scale)
            x = self._layer_tail(lp, x, out[0].transpose(0, 1).reshape(t, nh, d))
        last = self._final(x[min(max(n_valid - 1, 0), t - 1)][None])
        return T._apply_lm_head(self.params, last, c)[0].float()

    def _step_per_row(self) -> Dict[int, np.ndarray]:
        """The per-row execution model (one forward per scheduled sequence),
        kept as the baseline the batched step is measured against. Returns
        host fp32 logits per row whose prompt (or decode token) completed."""
        if self._mc.attn_layer_pattern is not None:
            raise NotImplementedError(
                "_step_per_row: alternating layer patterns run only through "
                "the batched step (its unrolled layer loop)"
            )
        batch = self.scheduler.next_batch()
        self.last_scheduled_tokens = batch.total_tokens if batch is not None else 0
        self.last_capped |= self.scheduler.drain_capped()
        if batch is None:
            return {}
        results: Dict[int, np.ndarray] = {}
        for uid, toks, start, chunked in zip(
            batch.uids, batch.tokens, batch.start_positions, batch.is_prompt_chunk
        ):
            seq = self.state_manager.get_sequence(uid)
            t = len(toks)
            padded = np.zeros(_bucket(t), np.int32)
            padded[:t] = toks
            table = self.state_manager.block_table_array(seq)
            logits = self._row_step(padded, int(start), t, table)
            seq.seen_tokens += t
            if not chunked:  # prompt complete (or decode token): logits usable
                results[uid] = logits.cpu().numpy()
        return results

    # -- convenience generation loop ---------------------------------------
    def generate(self, prompts, max_new_tokens: int = 32, eos_token_id: Optional[int] = None):
        """Drive submit/step/feedback to completion for a list of prompts.
        Returns a list of int32 arrays (prompt + generated).

        Two phases, as in the JAX engine: (1) prefill — split-phase steps
        with no host read between them; the completed rows' next tokens are
        copied to the host once at the end; (2) decode — fused rounds of
        ``decode_steps`` tokens, with the per-step loop underneath for caps
        and memory pressure."""
        uids = list(range(len(prompts)))
        for uid, p in zip(uids, prompts):
            self.scheduler.submit(uid, p)
        remaining = {uid: max_new_tokens for uid in uids}
        outputs = {uid: list(np.asarray(p, np.int32).reshape(-1)) for uid, p in zip(uids, prompts)}
        self.last_capped = set()
        ds = int(getattr(self.config, "decode_steps", 1) or 1)

        def take_token(uid, nxt):
            outputs[uid].append(nxt)
            remaining[uid] -= 1
            if remaining[uid] <= 0 or (eos_token_id is not None and nxt == eos_token_id):
                self.scheduler.finish(uid)
            else:
                self.scheduler.feedback(uid, nxt)

        # ---- phase 1: prefill without per-step host reads ----
        held: Dict[int, tuple] = {}
        while self.scheduler.has_pending():
            res = self._step_device()
            if self.last_scheduled_tokens == 0:
                break  # pool pressure: the interleaved loop below owns waiting
            held.update(res)
        for uid, tok in _materialize_rows(held, want_tokens=True).items():
            take_token(uid, int(tok))

        # ---- phase 2: fused decode rounds + interleaved fallback ----
        while self.scheduler.has_work():
            if ds > 1 and not self.scheduler._pending and self.scheduler._running:
                res = self.decode_round(ds)
                if res:
                    for uid, gen in res.items():
                        take = [int(t) for t in gen]
                        if eos_token_id is not None and eos_token_id in take:
                            take = take[: take.index(eos_token_id) + 1]
                        take = take[: remaining[uid]]
                        outputs[uid].extend(take)
                        remaining[uid] -= len(take)
                        if remaining[uid] <= 0 or (
                            eos_token_id is not None and take and take[-1] == eos_token_id
                        ):
                            self.scheduler.finish(uid)
                    continue
            res = self._step_device()
            if self.last_scheduled_tokens == 0 and self.scheduler.has_work():
                raise RuntimeError(
                    "scheduler deadlock: work pending but nothing schedulable "
                    f"(free KV blocks={self.state_manager.free_blocks}); "
                    "increase kv_cache.num_blocks or reduce concurrency"
                )
            for uid, tok in _materialize_rows(res, want_tokens=True).items():
                take_token(uid, int(tok))
        return [np.asarray(outputs[uid], np.int32) for uid in uids]
