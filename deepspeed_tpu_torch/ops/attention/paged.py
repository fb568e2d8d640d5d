"""Paged (block-table) attention for the ragged inference batch.

Counterpart of ``deepspeed_tpu/ops/attention/paged_pallas.py``. Layout:

  q            [T, nh, d]       packed new-token queries
  k/v pool     [NB, bs, nkv, d] paged block pool (token-major); the engine
                 passes a flat multi-layer view [L*NBp, bs, nkv, d] with
                 layer-offset block tables and trash id
  block_tables [T, B] per token (decode: one token per row)
  q_pos        global position of each query in its sequence

Implementations:
  * ``paged_attention_reference``, ``paged_decode_attention_dense`` and
    ``paged_chunk_attention``: plain torch (block gather + masked softmax),
    as the JAX package's are plain XLA.
  * ``paged_decode``: the hand-written CUDA kernel (``ops/kernels/csrc/
    paged_decode.cu``, replacing the Pallas ``_paged_kernel``). On a CPU
    tensor it takes its plain version, ``paged_decode_attention_dense``,
    which computes the same function (pool limit, extra columns, window,
    scale, trash blocks, zero for fully-masked rows).
  * ``paged_attention(impl=...)``: the dispatch seam, with the JAX
    contract ``auto | kernel | dense | reference``.

int8 pools (``block_quant.quantize_kv`` payloads) come with ``k_scale`` /
``v_scale`` [NB, bs, nkv] fp32 planes, one scale per head vector; every
entry point takes them. The plain versions dequantize in their gather, in
fp32, as the JAX package's do; the kernel's int8 form
(``paged_decode_int8``) reads the int8 rows and their scales. Extra and new
columns stay in q's dtype. An int8 pool without both planes, or planes
beside a pool that is not int8, raises ``ValueError``.
"""

import ctypes
import dataclasses
from typing import Optional

import torch

from deepspeed_tpu_torch.ops.attention.core import window_too_far
from deepspeed_tpu_torch.ops.kernels import KERNELS, stream_ptr

NEG_INF = -1e30
PAGED_ATTENTION_IMPLS = ("auto", "kernel", "dense", "reference")
KERNEL_HEAD_DIMS = (64, 128, 256)
PAGED_KERNEL = KERNELS["paged_decode"]
PAGED_INT8_KERNEL = KERNELS["paged_decode_int8"]


def _check_planes(k_cache, k_scale, v_scale, where):
    """The JAX contract: scale planes iff the pool payload is int8."""
    if k_cache.dtype == torch.int8:
        if k_scale is None or v_scale is None:
            raise ValueError(f"{where}: int8 k/v pools need k_scale and v_scale planes")
    elif k_scale is not None or v_scale is not None:
        raise ValueError(
            f"{where}: k_scale/v_scale given but the pool payload is {k_cache.dtype}, not int8"
        )


def _gather_ctx(cache, tables, scale=None):
    """cache [NB, bs, nkv, d], tables [R, B] -> fp32 context [R, nkv, B*bs, d],
    an int8 pool dequantized by its plane ``scale`` [NB, bs, nkv]."""
    R, B = tables.shape
    _, bs, nkv, d = cache.shape
    g = cache[tables.long()].float()  # [R, B, bs, nkv, d]
    if scale is not None:
        g = g * scale[tables.long()][..., None]
    return g.permute(0, 3, 1, 2, 4).reshape(R, nkv, B * bs, d)


def paged_attention_reference(q, k_cache, v_cache, block_tables, q_pos, trash_block,
                              window: int = 0, scale=None, k_scale=None, v_scale=None):
    """Plain per-token context gather + masked softmax. Shapes as the
    module docstring; returns [T, nh, d]. Tokens go in groups of 32 so peak
    memory is 32 context windows. ``k_scale``/``v_scale``: an int8 pool's
    dequant planes."""
    _check_planes(k_cache, k_scale, v_scale, "paged_attention_reference")
    T, nh, d = q.shape
    _, bs, nkv, _ = k_cache.shape
    B = block_tables.shape[1]
    S = B * bs
    group = nh // nkv
    kpos = torch.arange(S, device=q.device, dtype=torch.int32)
    sc = scale if scale is not None else d ** -0.5
    outs = []
    for t0 in range(0, T, 32):
        bt = block_tables[t0 : t0 + 32]
        pos = q_pos[t0 : t0 + 32]
        n = bt.shape[0]
        k_ctx = _gather_ctx(k_cache, bt, k_scale)  # [n, nkv, S, d]
        v_ctx = _gather_ctx(v_cache, bt, v_scale)
        blk_valid = (bt != trash_block).repeat_interleave(bs, dim=1)  # [n, S]
        mask = (kpos[None] <= pos[:, None]) & blk_valid
        if window:
            mask = mask & ~window_too_far(pos[:, None], kpos[None], window)
        qg = q[t0 : t0 + 32].reshape(n, nkv, group, d).float()
        s = torch.einsum("rngd,rnsd->rngs", qg, k_ctx) * sc
        s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
        w = torch.softmax(s, dim=-1)
        w = torch.where(mask.any(dim=1)[:, None, None, None], w, torch.zeros_like(w))
        outs.append(torch.einsum("rngs,rnsd->rngd", w, v_ctx).reshape(n, nh, d))
    return torch.cat(outs, dim=0).to(q.dtype)


def paged_decode_attention_dense(q, k_cache, v_cache, block_tables, q_pos, trash_block,
                                 window: int = 0, scale: Optional[float] = None,
                                 extra_kv=None, pool_limit=None, k_scale=None,
                                 v_scale=None):
    """Decode attention as plain torch (block gather + masked softmax): the
    plain version of the paged-decode kernel. q [R, nh, d], tables [R, B]
    per row. ``extra_kv`` = (ke [R, E, nkv, d], ve, epos [R, E]): not-yet-
    cached tokens appended as extra score columns, epos = -1 invalid.
    ``pool_limit`` [R]: pool positions >= limit are masked (default
    q_pos + 1, the causal <=). ``k_scale``/``v_scale``: an int8 pool's
    dequant planes (the extras stay in q's dtype)."""
    _check_planes(k_cache, k_scale, v_scale, "paged_decode_attention_dense")
    R, nh, d = q.shape
    _, bs, nkv, _ = k_cache.shape
    B = block_tables.shape[1]
    S = B * bs
    group = nh // nkv
    k_ctx = _gather_ctx(k_cache, block_tables, k_scale)
    v_ctx = _gather_ctx(v_cache, block_tables, v_scale)
    kpos = torch.arange(S, device=q.device, dtype=torch.int32)
    limit = (q_pos + 1) if pool_limit is None else pool_limit
    mask = (kpos[None] < limit[:, None]) & (block_tables != trash_block).repeat_interleave(
        bs, dim=1
    )  # [R, S]
    if pool_limit is not None:
        # a slot at q_pos < 0 is padding and sees nothing, as in the Pallas
        # kernel (the JAX dense gather lets it see the pool below its limit;
        # the engine never passes that combination)
        mask = mask & (q_pos[:, None] >= 0)
    if window:
        mask = mask & ~window_too_far(q_pos[:, None], kpos[None], window)
    qg = q.reshape(R, nkv, group, d).float() * (scale if scale is not None else d ** -0.5)
    s = torch.einsum("rngd,rnsd->rngs", qg, k_ctx)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    if extra_kv is not None:
        ke, ve, epos = extra_kv
        emask = (epos >= 0) & (epos <= q_pos[:, None])  # [R, E]
        if window:
            emask = emask & ~window_too_far(q_pos[:, None], epos, window)
        ke32 = ke.permute(0, 2, 1, 3).float()  # [R, nkv, E, d]
        ve32 = ve.permute(0, 2, 1, 3).float()
        se = torch.einsum("rngd,rned->rnge", qg, ke32)
        se = torch.where(emask[:, None, None], se, torch.full_like(se, NEG_INF))
        s = torch.cat([s, se], dim=-1)
        any_valid = mask.any(dim=1) | emask.any(dim=1)
        w = torch.softmax(s, dim=-1)
        w = torch.where(any_valid[:, None, None, None], w, torch.zeros_like(w))
        out = torch.einsum("rngs,rnsd->rngd", w[..., :S], v_ctx) + torch.einsum(
            "rnge,rned->rngd", w[..., S:], ve32
        )
        return out.reshape(R, nh, d).to(q.dtype)
    w = torch.softmax(s, dim=-1)
    w = torch.where(mask.any(dim=1)[:, None, None, None], w, torch.zeros_like(w))
    out = torch.einsum("rngs,rnsd->rngd", w, v_ctx)
    return out.reshape(R, nh, d).to(q.dtype)


def paged_chunk_attention(q, k_cache, v_cache, row_tables, q_pos, trash_block,
                          window: int = 0, scale: Optional[float] = None, new_kv=None,
                          pool_limit=None, k_scale=None, v_scale=None):
    """Prefill-chunk attention: Rc rows x tq new tokens, each row's tokens
    sharing that row's block table (q [Rc, tq, nh, d], row_tables [Rc, B],
    q_pos [Rc, tq], -1 = padding). One context gather per row, then a dense
    masked softmax; padded tokens emit exactly 0. ``new_kv`` = (ke
    [Rc, tq, nkv, d], ve): this chunk's not-yet-cached K/V, attended
    causally, while the pool covers positions < ``pool_limit`` [Rc].
    ``k_scale``/``v_scale``: an int8 pool's dequant planes (new_kv stays in
    q's dtype)."""
    _check_planes(k_cache, k_scale, v_scale, "paged_chunk_attention")
    Rc, tq, nh, d = q.shape
    _, bs, nkv, _ = k_cache.shape
    B = row_tables.shape[1]
    S = B * bs
    group = nh // nkv
    k_ctx = _gather_ctx(k_cache, row_tables, k_scale)  # [Rc, nkv, S, d]
    v_ctx = _gather_ctx(v_cache, row_tables, v_scale)
    kpos = torch.arange(S, device=q.device, dtype=torch.int32)
    blk_valid = (row_tables != trash_block).repeat_interleave(bs, dim=1)  # [Rc, S]
    if pool_limit is None:
        pool_ok = kpos[None, None] <= q_pos[:, :, None]
    else:
        pool_ok = (kpos[None] < pool_limit[:, None])[:, None].expand(Rc, tq, S)
    mask = pool_ok & (q_pos[:, :, None] >= 0) & blk_valid[:, None]  # [Rc, tq, S]
    if window:
        mask = mask & ~window_too_far(q_pos[:, :, None], kpos[None, None], window)
    qg = q.reshape(Rc, tq, nkv, group, d).float() * (scale if scale is not None else d ** -0.5)
    s = torch.einsum("rtngd,rnsd->rntgs", qg, k_ctx)
    s = torch.where(mask[:, None, :, None], s, torch.full_like(s, NEG_INF))
    if new_kv is not None:
        ke, ve = new_kv
        # in-chunk causal: key j visible to query i iff 0 <= pos_j <= pos_i
        cmask = (
            (q_pos[:, None, :] >= 0)
            & (q_pos[:, :, None] >= 0)
            & (q_pos[:, None, :] <= q_pos[:, :, None])
        )  # [Rc, tq(i), tq(j)]
        if window:
            cmask = cmask & ~window_too_far(q_pos[:, :, None], q_pos[:, None, :], window)
        ke32 = ke.permute(0, 2, 1, 3).float()  # [Rc, nkv, tq, d]
        ve32 = ve.permute(0, 2, 1, 3).float()
        sc = torch.einsum("rtngd,rnjd->rntgj", qg, ke32)
        sc = torch.where(cmask[:, None, :, None], sc, torch.full_like(sc, NEG_INF))
        s = torch.cat([s, sc], dim=-1)
        any_valid = mask.any(dim=2) | cmask.any(dim=2)  # [Rc, tq]
        w = torch.softmax(s, dim=-1)
        w = torch.where(any_valid[:, None, :, None, None], w, torch.zeros_like(w))
        out = torch.einsum("rntgs,rnsd->rtngd", w[..., :S], v_ctx) + torch.einsum(
            "rntgj,rnjd->rtngd", w[..., S:], ve32
        )
        return out.reshape(Rc, tq, nh, d).to(q.dtype)
    w = torch.softmax(s, dim=-1)
    w = torch.where(mask.any(dim=2)[:, None, :, None, None], w, torch.zeros_like(w))
    out = torch.einsum("rntgs,rnsd->rtngd", w, v_ctx)
    return out.reshape(Rc, tq, nh, d).to(q.dtype)


def _i32(t, shape, name):
    t = torch.as_tensor(t)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"paged_decode: {name} shape {tuple(t.shape)}, expected {tuple(shape)}")
    return t.to(torch.int32).contiguous()


def kernel_tile_keys(d: int) -> int:
    """Keys per tile of the paged-decode kernel (``paged_decode.cu``
    ``tile_keys``): 64, and 32 at d 256."""
    return 32 if d == 256 else 64


# the split plan aims at this many CTAs (about two waves of the 3 CTAs each
# of the H100's 132 SMs holds) and cuts a row's keys into at most
# MAX_SPLITS splits. Measured at the round form (R 32, 32/8 heads of 128,
# 640-token tables, E 64; chip_smoke's shapes): 384-768 CTAs beat 1024-2048
# by 7-20%; each CTA pays a fixed cost (its table lookups, queries, warp
# merge and partial) that short splits cannot amortize
SPLIT_TARGET_CTAS = 512
MAX_SPLITS = 32


def decode_span(B: int, bs: int, window: int, has_limit: bool) -> int:
    """Pool keys one row's valid range can span: B * bs, or the window when
    there is no pool limit (the causal bound then keeps hi - lo <= window)."""
    return min(B * bs, window) if window and not has_limit else B * bs


def decode_splits(n_rows: int, nkv: int, group: int, span: int, E: int, d: int):
    """The kernel's split plan: (split_keys, pool_splits, extra_splits).
    split_keys is a multiple of the tile and at least two tiles, sized so
    that n_rows * nkv * ceil(group / 16) CTAs per split times the splits
    come near SPLIT_TARGET_CTAS; a row's pool range is cut into pool_splits
    splits of split_keys keys, its E extras into extra_splits."""
    kt = kernel_tile_keys(d)
    ctas = max(1, n_rows * nkv * -(-group // 16))
    want = max(1, min(MAX_SPLITS, -(-SPLIT_TARGET_CTAS // ctas)))
    sk = max(2 * kt, -(-span // want))
    sk = -(-sk // kt) * kt
    return sk, -(-span // sk), -(-E // sk)


def _rows_view(t, shape, name):
    """An extras operand of ``shape`` [T, ...] as the kernel reads it: the
    tensor itself, with its row stride in elements, when its inner dims are
    contiguous (a stride-0 ``expand`` over the rows included); otherwise a
    contiguous copy."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"paged_decode: {name} {tuple(t.shape)}, expected {tuple(shape)}")
    inner, n = [], 1
    for size in reversed(shape[1:]):
        inner.insert(0, n)
        n *= size
    if n > 1 and list(t.stride()[1:]) != inner:
        t = t.contiguous()
    return t, (int(t.stride(0)) if shape[0] > 1 else 0)


@dataclasses.dataclass
class PagedDecodeArgs:
    """What ``paged_decode`` hands the kernel: its tensors (no copy of a
    view the kernel can read by its row stride) and its integers."""

    q: torch.Tensor
    k_cache: torch.Tensor
    v_cache: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    tables: torch.Tensor
    qpos: torch.Tensor
    limit: Optional[torch.Tensor]
    ke: Optional[torch.Tensor]
    ve: Optional[torch.Tensor]
    epos: Optional[torch.Tensor]
    T: int
    nh: int
    nkv: int
    d: int
    bs: int
    B: int
    E: int
    x_stride: int  # elements between the extras of rows t and t + 1 (0: one row for all)
    e_stride: int  # the same for epos
    trash: int
    window: int
    scale: float
    split_keys: int
    pool_splits: int
    extra_splits: int

    @property
    def int8(self) -> bool:
        return self.k_cache.dtype == torch.int8

    @property
    def splits(self) -> int:
        return self.pool_splits + self.extra_splits

    @property
    def launches_per_call(self) -> int:
        """Kernels one call launches: the split kernel, and the merge
        kernel when there is more than one split."""
        return 1 if self.splits == 1 else 2


def paged_decode_args(q, k_cache, v_cache, block_tables, q_pos, trash_block, window: int = 0,
                      scale: Optional[float] = None, extra_kv=None, pool_limit=None,
                      k_scale=None, v_scale=None) -> PagedDecodeArgs:
    """Check what the kernel takes and build its arguments, on any device
    (a pure function: nothing is launched). Raises on what the kernel does
    not take: q in bf16 or fp32, a pool in q's dtype or int8 with its fp32
    planes, d in ``KERNEL_HEAD_DIMS``, contiguous q and pools, 16-byte
    aligned data. The extras ``ke``/``ve`` [T, E, nkv, d] are passed by
    their row stride when their inner three dims are contiguous (a
    stride-0 ``expand`` view over the rows reaches the kernel as it is);
    any other layout is copied to a contiguous tensor first. ``epos`` [T,
    E] likewise."""
    _check_planes(k_cache, k_scale, v_scale, "paged_decode")
    T, nh, d = q.shape
    NB, bs, nkv, dk = k_cache.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"paged_decode: {q.dtype} queries; the kernel takes bf16 or fp32")
    int8_pool = k_cache.dtype == torch.int8
    pool_dtype = torch.int8 if int8_pool else q.dtype
    if k_cache.dtype != pool_dtype or v_cache.dtype != pool_dtype:
        raise ValueError(
            f"paged_decode: pool dtype {k_cache.dtype}/{v_cache.dtype} with q {q.dtype}; the "
            "kernels take a pool in q's dtype, or an int8 pool for both"
        )
    if d not in KERNEL_HEAD_DIMS or dk != d or tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError(
            f"paged_decode: head_dim {d} (pool {tuple(k_cache.shape)}); the kernel "
            f"takes d in {KERNEL_HEAD_DIMS} and matching K/V pools"
        )
    if nh % nkv:
        raise ValueError(f"paged_decode: nh={nh} is not a multiple of nkv={nkv}")
    dense = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache)]
    if int8_pool:
        dense += [("k_scale", k_scale), ("v_scale", v_scale)]
        for name, t in dense[3:]:
            if tuple(t.shape) != (NB, bs, nkv) or t.dtype != torch.float32:
                raise ValueError(f"paged_decode: {name} {tuple(t.shape)} {t.dtype}, expected "
                                 f"fp32 {(NB, bs, nkv)}")
    for name, t in dense:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_decode: {name} must be contiguous on {q.device}")
    B = block_tables.shape[1]
    tables = _i32(block_tables, (T, B), "block_tables")
    qpos = _i32(q_pos, (T,), "q_pos")
    limit = None if pool_limit is None else _i32(pool_limit, (T,), "pool_limit")
    E = x_stride = e_stride = 0
    ke = ve = epos = None
    if extra_kv is not None:
        ke, ve, epos = extra_kv
        E = int(ke.shape[1])
        ke, xs_k = _rows_view(ke, (T, E, nkv, d), "extra K")
        ve, xs_v = _rows_view(ve, (T, E, nkv, d), "extra V")
        if xs_k != xs_v:  # one stride for both operands
            ke, ve = ke.contiguous(), ve.contiguous()
            xs_k = E * nkv * d if T > 1 else 0
        x_stride = xs_k
        if ke.dtype != q.dtype or ve.dtype != q.dtype:
            raise ValueError("paged_decode: extra K/V must be in q's dtype")
        if ke.device != q.device or ve.device != q.device:
            raise ValueError(f"paged_decode: extra K/V must be on {q.device}")
        epos = torch.as_tensor(epos)
        epos, e_stride = _rows_view(epos.to(torch.int32), (T, E), "epos")
    tensors = [q, k_cache, v_cache] + ([ke, ve] if E else [])
    if any(t.data_ptr() % 16 for t in tensors) or (x_stride * q.element_size()) % 16:
        raise ValueError("paged_decode: tensors must be 16-byte aligned")
    span = decode_span(B, bs, int(window), limit is not None)
    split_keys, pool_splits, extra_splits = decode_splits(T, nkv, nh // nkv, span, E, d)
    return PagedDecodeArgs(
        q=q, k_cache=k_cache, v_cache=v_cache, k_scale=k_scale, v_scale=v_scale,
        tables=tables, qpos=qpos, limit=limit, ke=ke, ve=ve, epos=epos,
        T=T, nh=nh, nkv=nkv, d=d, bs=bs, B=B, E=E, x_stride=x_stride, e_stride=e_stride,
        trash=int(trash_block), window=int(window),
        scale=float(scale if scale is not None else d ** -0.5),
        split_keys=split_keys, pool_splits=pool_splits, extra_splits=extra_splits,
    )


def paged_decode(q, k_cache, v_cache, block_tables, q_pos, trash_block, window: int = 0,
                 scale: Optional[float] = None, extra_kv=None, pool_limit=None, k_scale=None,
                 v_scale=None):
    """The paged-decode kernels' wrapper. A CPU tensor takes the plain
    version (``paged_decode_attention_dense``); a CUDA tensor launches the
    kernel (``paged_decode``, or ``paged_decode_int8`` for an int8 pool with
    its scale planes) or raises. ``trash_block`` is a Python int (or 0-d
    tensor). One call launches the split kernel and, when the plan has
    more than one split, the merge kernel (``PagedDecodeArgs.
    launches_per_call``); the count rises by one per call. Arguments as
    ``paged_decode_args`` builds them (extras by their row stride)."""
    _check_planes(k_cache, k_scale, v_scale, "paged_decode")
    if q.device.type == "cpu":
        return paged_decode_attention_dense(
            q, k_cache, v_cache, block_tables, q_pos, trash_block, window=window,
            scale=scale, extra_kv=extra_kv, pool_limit=pool_limit, k_scale=k_scale,
            v_scale=v_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: q on {q.device}; expected a CPU or CUDA tensor")
    a = paged_decode_args(q, k_cache, v_cache, block_tables, q_pos, trash_block, window=window,
                          scale=scale, extra_kv=extra_kv, pool_limit=pool_limit,
                          k_scale=k_scale, v_scale=v_scale)
    out = torch.empty_like(q)
    if a.T == 0:
        return out
    part_acc = part_ml = None
    if a.splits > 1:  # fp32 partials, merged by the second kernel of the call
        part_acc = torch.empty(a.T, a.nh, a.splits, a.d, device=q.device, dtype=torch.float32)
        part_ml = torch.empty(a.T, a.nh, a.splits, 2, device=q.device, dtype=torch.float32)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    kernel = PAGED_INT8_KERNEL if a.int8 else PAGED_KERNEL
    planes = [ptr(a.k_scale), ptr(a.v_scale)] if a.int8 else []
    rc = kernel.fn()(
        ptr(q), ptr(a.k_cache), ptr(a.v_cache), *planes, ptr(a.tables), ptr(a.qpos),
        ptr(a.limit), ptr(a.ke), ptr(a.ve), ptr(a.epos), ptr(out), ptr(part_acc), ptr(part_ml),
        a.T, a.nh, a.nkv, a.d, a.bs, a.B, a.E, a.x_stride, a.e_stride, a.trash, a.window,
        a.split_keys, a.pool_splits, a.extra_splits, ctypes.c_float(a.scale),
        int(q.dtype == torch.bfloat16), stream_ptr(q),
    )
    kernel.check(rc)
    kernel.launches += 1
    return out


def _split_partial(qg, k, v, valid):
    """One split's fp32 softmax state: qg [R, nkv, G, d] (scaled), k/v [R,
    SK, nkv, d], valid [R, SK] -> (m [R, nkv, G], l, acc [R, nkv, G, d]);
    an empty split gives m = NEG_INF, l = 0, acc = 0."""
    s = torch.einsum("rngd,rknd->rngk", qg, k)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(valid[:, None, None], torch.exp(s - m[..., None]), torch.zeros_like(s))
    return m, p.sum(dim=-1), torch.einsum("rngk,rknd->rngd", p, v)


def merge_partials(parts):
    """Merge split states [(m, l, acc), ...] as the kernel's merge does:
    m = max m_s, weights e^(m_s - m) for the non-empty splits only, out =
    sum w acc / max(sum w l, 1e-30), exactly 0 where no split saw a key."""
    M = torch.stack([p[0] for p in parts]).amax(dim=0)
    L = torch.zeros_like(M)
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(m > 0.5 * NEG_INF, torch.exp(m - M), torch.zeros_like(m))
        L = L + w * l
        A = A + w[..., None] * acc
    out = A / L.clamp(min=1e-30)[..., None]
    return torch.where((M > 0.5 * NEG_INF)[..., None], out, torch.zeros_like(out))


def paged_decode_split_merge(q, k_cache, v_cache, block_tables, q_pos, trash_block,
                             window: int = 0, scale: Optional[float] = None, extra_kv=None,
                             pool_limit=None, k_scale=None, v_scale=None,
                             split_keys: Optional[int] = None, return_partials: bool = False):
    """A plain model of the kernel's split-and-merge (tests only; the main
    path never calls it): a row's pool range [lo, hi) cut into splits of
    ``split_keys`` keys from lo (default: the kernel's plan,
    ``decode_splits``), the extras into splits of the same size, each
    split's fp32 state from its keys alone, then ``merge_partials``.
    Arguments as ``paged_decode_attention_dense``; returns [R, nh, d] in
    q's dtype, and with ``return_partials`` also the splits' states."""
    _check_planes(k_cache, k_scale, v_scale, "paged_decode_split_merge")
    R, nh, d = q.shape
    _, bs, nkv, _ = k_cache.shape
    B = block_tables.shape[1]
    G = nh // nkv
    E = int(extra_kv[0].shape[1]) if extra_kv is not None else 0
    span = decode_span(B, bs, window, pool_limit is not None)
    if split_keys is None:
        split_keys, n_pool, n_extra = decode_splits(R, nkv, G, span, E, d)
    else:
        n_pool, n_extra = max(1, -(-span // split_keys)), -(-E // split_keys)
    dev = q.device
    qg = q.reshape(R, nkv, G, d).float() * (scale if scale is not None else d ** -0.5)
    qp = q_pos.long().to(dev)
    if pool_limit is None:
        hi = qp + 1
    else:
        hi = torch.where(qp >= 0, pool_limit.long().to(dev), torch.zeros_like(qp))
    hi = hi.clamp(max=B * bs)
    lo = (qp - window + 1).clamp(min=0) if window else torch.zeros_like(qp)
    tables = block_tables.long().to(dev)
    ar = torch.arange(split_keys, device=dev)
    k_rows, v_rows = k_cache.reshape(-1, nkv, d), v_cache.reshape(-1, nkv, d)
    parts = []
    for s in range(n_pool):
        k0 = lo + s * split_keys
        kpos = k0[:, None] + ar[None]  # [R, SK]
        kc = kpos.clamp(0, B * bs - 1)
        blk = tables.gather(1, kc // bs)
        valid = (kpos < torch.minimum(hi, k0 + split_keys)[:, None]) & (blk != trash_block)
        rows = blk * bs + kc % bs
        kf, vf = k_rows[rows].float(), v_rows[rows].float()  # [R, SK, nkv, d]
        if k_scale is not None:
            kf = kf * k_scale.reshape(-1, nkv)[rows][..., None]
            vf = vf * v_scale.reshape(-1, nkv)[rows][..., None]
        parts.append(_split_partial(qg, kf, vf, valid))
    if n_extra:
        ke, ve, epos = extra_kv
        epos = epos.long().to(dev)
        for s in range(n_extra):
            e = s * split_keys + ar
            ec = e.clamp(max=E - 1)
            ep = epos[:, ec]
            valid = (e < E)[None] & (ep >= 0) & (ep <= qp[:, None])
            if window:
                valid = valid & ~window_too_far(qp[:, None], ep, window)
            parts.append(_split_partial(qg, ke[:, ec].float(), ve[:, ec].float(), valid))
    out = merge_partials(parts).reshape(R, nh, d).to(q.dtype)
    return (out, parts) if return_partials else out


def verify_rows(tables, qpos, pool_limit):
    """The per-query-row arguments of the verify form (speculative
    decoding's verify step, the JAX engine's flattened kernel call): R rows
    of K1 = k + 1 tokens each become R * K1 query rows. tables [R, B] ->
    [R * K1, B] (each row's table repeated), qpos [R, K1] (-1 = a padded
    slot) -> [R * K1], pool_limit [R] -> [R * K1], and the extras' positions
    [R * K1, K1]: query row (r, i) sees row r's K1 fresh keys at qpos[r],
    so the extras mask (0 <= epos <= q_pos) is the in-chunk causal mask and
    a padded slot sees nothing."""
    R, K1 = qpos.shape
    epos = qpos[:, None, :].expand(R, K1, K1).reshape(R * K1, K1)
    return (tables.repeat_interleave(K1, dim=0), qpos.reshape(R * K1),
            pool_limit.repeat_interleave(K1), epos)


def verify_extras(k, v, K1: int):
    """The verify form's extras: each row's K1 fresh K/V [R * K1, nkv, d]
    handed to each of its K1 query rows, [R * K1, K1, nkv, d]. The kernel
    reads extras by one row stride, which cannot say "the same K1 columns
    for K1 consecutive rows", so this is a contiguous copy (R * K1 * K1 *
    nkv * d elements per operand)."""
    T, nkv, d = k.shape
    R = T // K1

    def rep(t):
        return t.reshape(R, 1, K1, nkv, d).expand(R, K1, K1, nkv, d).reshape(T, K1, nkv, d)

    return rep(k), rep(v)


def verify_kwargs(q, k, v, tables, qpos, pool_limit, trash_block):
    """The whole verify-form call of ``paged_decode`` / ``paged_attention``
    (without the pools): q [R * K1, nh, d] and the rows' fresh k/v [R * K1,
    nkv, d], tables [R, B], qpos [R, K1], pool_limit [R] (each row's write
    cursor: the pool below it)."""
    rep_tables, q_pos, limit, epos = verify_rows(tables, qpos, pool_limit)
    ke, ve = verify_extras(k, v, qpos.shape[1])
    return dict(q=q, block_tables=rep_tables, q_pos=q_pos, trash_block=trash_block,
                extra_kv=(ke, ve, epos), pool_limit=limit)


def resolve_impl(impl: Optional[str], device_type: str, head_dim: int) -> str:
    """What ``impl`` ("auto" or None, "kernel", "dense", "reference") runs
    on a ``device_type`` tensor. "auto" is the CUDA kernel on a card and the
    dense gather on the CPU; on a card with a head_dim the kernel does not
    take it raises, since only an explicit "dense"/"reference" may put the
    plain version on a card."""
    if impl is not None and impl not in PAGED_ATTENTION_IMPLS:
        raise ValueError(
            f"paged_attention: unknown impl {impl!r} (expected one of {PAGED_ATTENTION_IMPLS})"
        )
    if impl not in (None, "auto"):
        return impl
    if device_type == "cpu":
        return "dense"
    if head_dim not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"paged_attention: head_dim {head_dim} on the card; the paged-decode kernel "
            f"takes d in {KERNEL_HEAD_DIMS} (other head dims: ROADMAP queue 2, item 3). "
            "Select paged_attention_impl='dense' to run the plain gather instead"
        )
    return "kernel"


def paged_attention(q, k_cache, v_cache, block_tables, q_pos, trash_block,
                    impl: Optional[str] = None, window: int = 0,
                    scale: Optional[float] = None, k_scale=None, v_scale=None,
                    extra_kv=None, pool_limit=None):
    """Dispatching entry point for paged decode attention.

    ``impl``: "auto" (None) resolves as ``resolve_impl`` says; "kernel",
    "dense", "reference" force a path; anything else raises. "kernel" on a
    CPU tensor runs the kernel's plain version. ``k_scale``/``v_scale``
    [NB, bs, nkv] fp32: an int8 pool's dequant planes, required iff the
    pool payload is int8 (each path checks)."""
    impl = resolve_impl(impl, q.device.type, q.shape[-1])
    if impl == "reference":
        if extra_kv is not None or pool_limit is not None:
            raise ValueError(
                "paged_attention: impl='reference' serves the plain parity form only "
                "(no extra_kv/pool_limit)"
            )
        return paged_attention_reference(
            q, k_cache, v_cache, block_tables, q_pos, trash_block, window=window, scale=scale,
            k_scale=k_scale, v_scale=v_scale,
        )
    fn = paged_decode_attention_dense if impl == "dense" else paged_decode
    return fn(
        q, k_cache, v_cache, block_tables, q_pos, trash_block, window=window, scale=scale,
        extra_kv=extra_kv, pool_limit=pool_limit, k_scale=k_scale, v_scale=v_scale,
    )
