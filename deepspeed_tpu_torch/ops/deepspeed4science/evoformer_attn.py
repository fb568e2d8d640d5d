"""Evoformer attention (DS4Science): hand-written CUDA forward and backward.

Counterpart of ``deepspeed_tpu/ops/deepspeed4science/evoformer_attn.py``.
Evoformer MSA-row and triangle attention is softmax(Q Kᵀ·d^-½ + bias₁ +
bias₂) V, where bias₁ is a per-row padding mask [*, 1, 1, s] and bias₂ the
pair bias [*, h, s, s]; both may need gradients (bias₂'s feeds the pair
stack). No causal mask, no GQA. Four kernels, in
``ops/kernels/csrc/evoformer_fwd.cu`` and ``evoformer_bwd.cu``:

  * ``evoformer_fwd``     replaces ``_fwd_kernel``: out and an fp32 LSE [B, h, s];
  * ``evoformer_bwd_dq``  replaces ``_bwd_dq_kernel``: dq, delta = sum(do·out)
    [B, h, s] for dk/dv, and the bias gradient in the form ``bias_grad_plan``
    chooses (the fp32 dS plane [B, h, s, s], or dS summed over groups of
    batch rows);
  * ``evoformer_bwd_dkv`` replaces ``_bwd_dkv_kernel``: dk and dv (from dq's
    delta), and in the reduced form each key's dS summed over the queries;
  * ``evoformer_bias_grad_merge`` finishes dq's bias gradient: it folds the
    partial sums, in a fixed order, into each bias's gradient.

The kernels read q, k, v in the call's own [B, s, h, d] layout (the leading
dims flattened into B, nothing transposed) and up to two fp32 bias operands
through their strides, so a bias broadcast over the batch is not
materialized. When the flattened batch needs more than one stride for a
bias (e.g. [b, 1, h, s, s] under leading dims [b, n] with b > 1), or a bias
is not unit-stride over keys, that bias is materialized as fp32 [B, h, s,
s], as the JAX package always does; a third and further biases are summed
into the second operand.

A bias's gradient is dS summed over the dims of [B, h, s(query)] it is
broadcast over (the transpose of JAX's ``broadcast_to``), cast to its dtype.
``bias_grad_plan`` picks one of two forms by shape, for the whole call:
reduced, where every bias that needs a gradient is broadcast over the batch
or the queries and its operand carries exactly those broadcasts as stride 0
(AlphaFold's mask [*, 1, 1, s] and pair bias [1, h, s, s] under [1, n]): the
kernels sum dS on the card, dq over its group of batch rows (``rows``),
dk/dv over the queries (``cols``), and the merge folds those partials; no
[B, h, s, s] tensor is formed. Otherwise (a materialized operand, a third
bias folded into the second operand, or a bias broadcast over heads only)
the plane form: dq writes the plane and torch sums it (``Tensor.sum_to_size``).
The CPU path takes the same forms through the plain versions.

Beside the kernels are their plain versions, ``evoformer_fwd_reference``,
``evoformer_bwd_reference`` (which also gives the reduced gradients: the
plane's arithmetic, summed per bias) and
``evoformer_bias_grad_merge_reference``, with the Pallas bodies' arithmetic
(every sum in fp32) and the kernels' rule for a dead logit: one at or below
-1e30, -inf or NaN contributes exactly 0, so a row with no live logit gives
out 0, lse -1e30, and zero dq and dS (the JAX kernel's behaviour; its dense
oracle ``evoformer_reference``, and this module's, give NaN there). A CPU
tensor takes the plain versions (any float dtype, any head dim); a CUDA
tensor launches the kernels or raises for what they do not take: fp16
(ROADMAP queue 2, item 11), a head dim outside 16/32/64/128 (item 13; a head
dim below 16, such as the extra-MSA stack's 8, is zero-padded to 16 with the
scale of the true one, which is exact). Nothing falls back.
"""

import ctypes
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.ops.kernels import KERNELS, stream_ptr

NEG_INF = -1e30
FWD_KERNEL = KERNELS["evoformer_fwd"]
DQ_KERNEL = KERNELS["evoformer_bwd_dq"]
DKV_KERNEL = KERNELS["evoformer_bwd_dkv"]
MERGE_KERNEL = KERNELS["evoformer_bias_grad_merge"]
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# the plain versions work on [rows, h, s, s] fp32 slabs of at most this many
# elements, so that no full [B, h, s, s] intermediate is formed at once
_CHUNK_ELEMS = 1 << 26
# the backward CTAs walk groups of batch rows (rows_per_cta): about this many
# CTAs a call, four waves of three CTAs on each of the 132 SMs of an H100
BWD_CTAS = 12 * 132


# ---------------------------------------------------------------------------
# bias operands
# ---------------------------------------------------------------------------
def _bias_operand(bias, lead, h, s):
    """``bias`` (broadcastable to [*lead, h, s, s]) as an fp32 [B, h, s, s]
    view with unit key stride: stride 0 on its broadcast dims, materialized
    only where one stride cannot span the flattened batch."""
    B = math.prod(lead)
    x = bias.float().expand(*lead, h, s, s)
    try:
        x = x.view(B, h, s, s)
    except RuntimeError:
        x = x.reshape(B, h, s, s)  # copies: the batch needs more than one stride
    return x if x.stride(-1) == 1 else x.contiguous()


def _operands(biases, lead, h, s):
    """The kernels' (at most two) fp32 bias operands for ``biases``."""
    ops = [_bias_operand(b, lead, h, s) for b in biases]
    if len(ops) > 2:
        extra = ops[1]
        for x in ops[2:]:
            extra = extra + x
        ops = [ops[0], extra.contiguous()]
    return ops


def _batch_chunks(B, h, s):
    step = max(1, _CHUNK_ELEMS // max(1, h * s * s))
    return [(b0, min(B, b0 + step)) for b0 in range(0, B, step)]


def _bias_slab(biases, b0, b1):
    """The summed fp32 bias of batch rows b0..b1 ([rows, h, s, s]), or
    None."""
    total = None
    for x in biases:
        total = x[b0:b1] if total is None else total + x[b0:b1]
    return total


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


# ---------------------------------------------------------------------------
# the bias gradients' form
# ---------------------------------------------------------------------------
def _n_tiles(s):
    return -(-s // 64)


def rows_per_cta(B, h, s):
    """Batch rows a CTA of any of the three kernels walks: ~BWD_CTAS CTAs a
    call, and at least 8 (all B when fewer), so dq's row partials stay
    within an eighth of the [B, h, s, s] plane. More rows a CTA make fewer,
    smaller row partials, and let the forward read a bias that is the same
    for every batch row once for more rows; fewer make more CTAs."""
    return min(B, max(8, -(-B * h * _n_tiles(s) // BWD_CTAS)))


def _broadcast_dims(shape, op, lead, h, s):
    """The dims of [B, h, s] (0 the flattened batch, 1 the head, 2 the
    query) a bias of ``shape`` is broadcast over, when its operand ``op``
    carries exactly those broadcasts as stride 0; None when it does not (a
    materialized operand, or a bias that is an expanded view itself)."""
    full = (*lead, h, s, s)
    shape = tuple(shape)[-len(full):]
    shape = (1,) * (len(full) - len(shape)) + shape
    B = math.prod(lead)
    by_shape = tuple(i for i, (n, size) in enumerate(
        ((B, math.prod(shape[:-3])), (h, shape[-3]), (s, shape[-2]))) if n > 1 and size == 1)
    by_stride = tuple(i for i, n in enumerate((B, h, s)) if n > 1 and op.stride(i) == 0)
    return by_shape if by_shape == by_stride else None


class BiasGradPlan(NamedTuple):
    """How a call's bias gradients are formed: ``form`` "none" (no bias
    needs one), "plane" or "reduced"; ``dims`` per bias the dims of [B, h,
    s] its gradient is summed over (reduced form; None for a bias that needs
    none); ``rows`` / ``cols`` whether dq writes the row partials / dk/dv
    the column partials."""
    form: str
    dims: Tuple = ()
    rows: bool = False
    cols: bool = False


def bias_grad_plan(shapes, ops, lead, h, s, wanted) -> BiasGradPlan:
    """The shape rule. ``shapes``: the biases' shapes as the caller gave
    them; ``ops``: their kernel operands (``_operands``); ``wanted``: which
    biases need a gradient. Reduced when there are at most two biases and
    every bias that needs a gradient is broadcast over the batch or the
    queries (``_broadcast_dims``); the plane otherwise."""
    if not any(wanted):
        return BiasGradPlan("none")
    if len(shapes) > 2:  # a third bias is folded into the second operand
        return BiasGradPlan("plane")
    dims = []
    for shape, op, want in zip(shapes, ops, wanted):
        dm = _broadcast_dims(shape, op, lead, h, s) if want else None
        if want and (dm is None or not {0, 2} & set(dm)):
            return BiasGradPlan("plane")
        dims.append(dm)
    rows = any(dm is not None and 0 in dm and 2 not in dm for dm in dims)
    cols = any(dm is not None and 2 in dm for dm in dims)
    return BiasGradPlan("reduced", tuple(dims), rows, cols)


def merge_flags(dims):
    """The merge's axes (bit i: axis i) for a bias summed over ``dims``: of
    the row partials [groups, h, s, s] (the groups, and the heads if
    broadcast over them) or of the column partials [B, h, 1, s] (the batch
    and the heads if broadcast over them)."""
    return (1 if 0 in dims or 2 not in dims else 0) | (2 if 1 in dims else 0)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------
def _logits(q, k, biases, b0, b1, sc):
    """fp32 logits [rows, h, s, s] of batch rows b0..b1 and their live mask;
    dead logits set to -1e30."""
    qf = q[b0:b1].float().transpose(1, 2)
    kf = k[b0:b1].float().transpose(1, 2)
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * sc
    bias = _bias_slab(biases, b0, b1)
    if bias is not None:
        logits = logits + bias
    live = logits > NEG_INF
    return torch.where(live, logits, torch.full_like(logits, NEG_INF)), live


def evoformer_fwd_reference(q, k, v, biases=(), scale=None):
    """Plain forward with the kernels' arithmetic. q, k, v: [B, s, h, d];
    ``biases``: tensors broadcastable to [B, h, s, s]. fp32 logits * scale +
    the biases; a dead logit (<= -1e30, -inf, NaN) gets p = 0; p = exp(logit
    - max), out = (p v) / max(sum p, 1e-30) in fp32, rounded once to q's
    dtype. Returns (out [B, s, h, d], lse [B, h, s] fp32; a row with no live
    logit: 0 and -1e30)."""
    B, s, h, d = q.shape
    sc = _scale(q, scale)
    ops = _operands(biases, (B,), h, s)
    outs, lses = [], []
    for b0, b1 in _batch_chunks(B, h, s):
        logits, live = _logits(q, k, ops, b0, b1, sc)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.where(live, torch.exp(logits - m), torch.zeros_like(logits))
        del logits, live
        ls = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        out = torch.matmul(p, v[b0:b1].float().transpose(1, 2)) / ls
        outs.append(out.transpose(1, 2).to(q.dtype))
        lses.append((m + torch.log(ls))[..., 0])
    return torch.cat(outs).contiguous(), torch.cat(lses)


def evoformer_bwd_reference(q, k, v, out, do, lse, biases=(), scale=None, want_ds=True,
                            sums: Sequence = ()):
    """Plain backward from the recompute formulas, every sum in fp32: p =
    exp(logit - lse) (0 for a dead logit), delta = sum(do * out), dS = p *
    (do vᵀ - delta), dq = dS k * scale, dk = dSᵀ q * scale, dv = pᵀ do.
    Returns (dq, dk, dv) in the inputs' dtypes and layout, dS fp32 [B, h, s,
    s] (None unless ``want_ds``), and for each entry of ``sums`` (the dims of
    [B, h, s] to sum over, or None) dS summed over those dims (keepdim,
    fp32; None): the reduced bias gradients, and the plain version of dq's
    partials and the merge together. No [B, h, s, s] tensor is formed unless
    ``want_ds``."""
    B, s, h, d = q.shape
    sc = _scale(q, scale)
    ops = _operands(biases, (B,), h, s)
    dqs, dks, dvs, dss = [], [], [], []
    parts = [[] for _ in sums]
    for b0, b1 in _batch_chunks(B, h, s):
        logits, live = _logits(q, k, ops, b0, b1, sc)
        p = torch.where(live, torch.exp(logits - lse[b0:b1].float()[..., None]),
                        torch.zeros_like(logits))
        del logits, live
        qf, kf, vf = (t[b0:b1].float().transpose(1, 2) for t in (q, k, v))
        dof = do[b0:b1].float().transpose(1, 2)
        delta = (dof * out[b0:b1].float().transpose(1, 2)).sum(dim=-1, keepdim=True)
        ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
        dqs.append((torch.matmul(ds, kf) * sc).transpose(1, 2).to(q.dtype))
        dks.append((torch.matmul(ds.transpose(-1, -2), qf) * sc).transpose(1, 2).to(k.dtype))
        dvs.append(torch.matmul(p.transpose(-1, -2), dof).transpose(1, 2).to(v.dtype))
        for part, dims in zip(parts, sums):
            if dims is not None:
                part.append(ds.sum(dim=list(dims), keepdim=True) if dims else ds)
        if want_ds:
            dss.append(ds)
    reduced = []
    for part, dims in zip(parts, sums):
        if dims is None:
            reduced.append(None)
        elif 0 in dims:  # the chunks' batch sums, added in order
            total = part[0]
            for x in part[1:]:
                total = total + x
            reduced.append(total)
        else:
            reduced.append(torch.cat(part))
    return (torch.cat(dqs).contiguous(), torch.cat(dks).contiguous(),
            torch.cat(dvs).contiguous(), torch.cat(dss) if want_ds else None, reduced)


def evoformer_bias_grad_merge_reference(src, flags):
    """Plain merge: ``src`` [a0, a1, a2, n] fp32 summed over the axes flagged
    in ``flags`` (bit i: axis i), keepdim."""
    dims = [i for i in range(3) if flags >> i & 1]
    return src.sum(dim=dims, keepdim=True) if dims else src.clone()


def evoformer_reference(Q, K, V, biases=None):
    """Dense oracle, written as the JAX package's: fp32 logits * d^-½ plus
    each bias in fp32, a softmax, the weights rounded to V's dtype before
    the product. A row whose logits are all -inf gives NaN here (the kernels
    give 0)."""
    biases = biases or []
    d = Q.shape[-1]
    q, k, v = (t.transpose(-3, -2) for t in (Q, K, V))  # ...shd -> ...hsd
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d ** -0.5)
    for bb in biases:
        logits = logits + bb.float()
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w.to(v.dtype), v).transpose(-3, -2)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------
def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_args(where, q, k, v, biases, *more):
    """Check what the kernels take; return (contiguous, 16-byte aligned q, k,
    v and ``more`` with the head dim padded to the kernels' (zeros), the
    bias operands, the true head dim)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{where}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "must be one [B, s, h, d] shape")
    if q.dtype == torch.float16:
        raise NotImplementedError(
            f"{where}: fp16; the kernels take bf16 and fp32 (ROADMAP queue 2, item 11)")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(
            f"{where}: q/k/v {q.dtype}/{k.dtype}/{v.dtype}; the kernels take one of "
            f"{KERNEL_DTYPES}")
    B, s, h, d = q.shape
    if d > 16 and d not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"{where}: head_dim {d}; the kernels take {KERNEL_HEAD_DIMS} and pad a smaller "
            "one to 16 (ROADMAP queue 2, item 13)")
    tensors = (q, k, v) + tuple(more) + tuple(biases)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(
            f"{where}: every tensor must be on one CUDA device "
            f"(got {sorted({str(t.device) for t in tensors})})")
    ops = _operands(biases, (B,), h, s)
    pad = max(16, d) - d
    main = [_aligned(torch.nn.functional.pad(t, (0, pad)) if pad else t)
            for t in (q, k, v) + tuple(more)]
    return main, ops, d


def _bias_args(ops):
    """Two pointers (None when absent), six strides, and whether the
    kernels may load the bias tiles as float4 (16-byte aligned pointers,
    strides that are multiples of 4)."""
    ptrs, strides = [], []
    for i in range(2):
        if i < len(ops):
            ptrs.append(ops[i].data_ptr())
            strides += [ops[i].stride(0), ops[i].stride(1), ops[i].stride(2)]
        else:
            ptrs.append(None)
            strides += [0, 0, 0]
    vec = all(p is None or p % 16 == 0 for p in ptrs) and all(x % 4 == 0 for x in strides)
    return ptrs, strides, int(vec)


def _tail(q, d, scale, vec, *more):
    """The entry points' trailing arguments: B, h, s, d, scale, fp32, vec,
    ``more`` (the backward's group), the stream."""
    B, s, h, dk = q.shape
    return (B, h, s, dk, ctypes.c_float(d ** -0.5 if scale is None else float(scale)),
            int(q.dtype == torch.float32), vec, *more, stream_ptr(q))


def evoformer_fwd_cuda(q, k, v, biases=(), scale=None):
    """Launch the forward kernel (a CTA per group of ``rows_per_cta`` batch
    rows, head and 64-query tile). q, k, v: [B, s, h, d] on one card.
    Returns (out in q's dtype and shape, lse fp32 [B, h, s])."""
    (q, k, v), ops, d = _kernel_args("evoformer_fwd_cuda", q, k, v, biases)
    B, s, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, h, s), device=q.device, dtype=torch.float32)
    if q.numel():
        ptrs, strides, vec = _bias_args(ops)
        rc = FWD_KERNEL.fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs, out.data_ptr(),
                             lse.data_ptr(), *strides,
                             *_tail(q, d, scale, vec, rows_per_cta(B, h, s)))
        FWD_KERNEL.check(rc)
        FWD_KERNEL.launches += 1
    return out[..., :d].contiguous() if out.shape[-1] != d else out, lse


def evoformer_bwd_dq_cuda(q, k, v, out, do, lse, biases=(), scale=None, want_ds=False,
                          rows=False):
    """Launch the dq kernel. ``want_ds``: write the fp32 dS plane [B, h, s,
    s]; ``rows``: the row partials [ceil(B / group), h, s, s], dS summed over
    each group of ``rows_per_cta`` batch rows (not both). Returns (dq in q's
    dtype and shape, delta fp32 [B, h, s] for dk/dv, the plane and the row
    partials, each None unless asked)."""
    (q, k, v, out, do), ops, d = _kernel_args("evoformer_bwd_dq_cuda", q, k, v, biases, out,
                                              do.to(q.dtype))
    if want_ds and rows:
        raise ValueError("evoformer_bwd_dq_cuda: the dS plane or its row sums, not both")
    if (want_ds or rows) and not ops:
        raise ValueError("evoformer_bwd_dq_cuda: a bias gradient with no bias")
    lse = _aligned(lse.float())
    B, s, h, _ = q.shape
    group = rows_per_cta(B, h, s)
    f32 = dict(device=q.device, dtype=torch.float32)
    dq = torch.empty_like(q)
    delta = torch.empty((B, h, s), **f32)
    ds = torch.empty((B, h, s, s), **f32) if want_ds else None
    rp = torch.empty((-(-B // group), h, s, s), **f32) if rows else None
    if q.numel():
        ptrs, strides, vec = _bias_args(ops)
        outs = [None if t is None else t.data_ptr() for t in (ds, rp)]
        rc = DQ_KERNEL.fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                            do.data_ptr(), lse.data_ptr(), *ptrs, dq.data_ptr(),
                            delta.data_ptr(), *outs, *strides,
                            *_tail(q, d, scale, vec, group))
        DQ_KERNEL.check(rc)
        DQ_KERNEL.launches += 1
    return (dq[..., :d].contiguous() if dq.shape[-1] != d else dq), delta, ds, rp


def evoformer_bwd_dkv_cuda(q, k, v, do, lse, delta, biases=(), scale=None, cols=False):
    """Launch the dk/dv kernel on dq's ``delta`` (the dq kernel runs first on
    the stream). ``cols``: the column partials [B, h, 1, s], each key's dS
    summed over the queries. Returns (dk, dv) in k's dtype and shape, and
    the column partials or None."""
    (q, k, v, do), ops, d = _kernel_args("evoformer_bwd_dkv_cuda", q, k, v, biases,
                                         do.to(q.dtype))
    lse = _aligned(lse.float())
    delta = _aligned(delta.float())
    B, s, h, _ = q.shape
    if cols and not ops:
        raise ValueError("evoformer_bwd_dkv_cuda: a bias gradient with no bias")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    cp = torch.empty((B, h, 1, s), device=q.device, dtype=torch.float32) if cols else None
    if q.numel():
        ptrs, strides, vec = _bias_args(ops)
        rc = DKV_KERNEL.fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                             lse.data_ptr(), delta.data_ptr(), *ptrs, dk.data_ptr(),
                             dv.data_ptr(), None if cp is None else cp.data_ptr(), *strides,
                             *_tail(q, d, scale, vec, rows_per_cta(B, h, s)))
        DKV_KERNEL.check(rc)
        DKV_KERNEL.launches += 1
    if dk.shape[-1] != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv, cp


def evoformer_bias_grad_merge_cuda(jobs):
    """Launch the merge on one or two (partials, flags) jobs (``merge_flags``):
    each [a0, a1, a2, n] fp32 on one card, summed over the flagged axes in
    index order. Returns the sums (keepdim), in order."""
    if not 1 <= len(jobs) <= 2:
        raise ValueError(f"evoformer_bias_grad_merge_cuda: 1 or 2 jobs, got {len(jobs)}")
    args, outs = [], []
    for src, flags in jobs:
        if src.device.type != "cuda" or src.dtype != torch.float32 or src.dim() != 4:
            raise ValueError("evoformer_bias_grad_merge_cuda: partials must be 4-d fp32 on a "
                             f"CUDA device (got {src.dtype}, {tuple(src.shape)}, {src.device})")
        src = src.contiguous()
        a0, a1, a2, n = src.shape
        dst = torch.empty((1 if flags & 1 else a0, 1 if flags & 2 else a1,
                           1 if flags & 4 else a2, n), device=src.device, dtype=torch.float32)
        args.append((src, dst, a0, a1, a2, n, flags))
        outs.append(dst)
    j0 = args[0]
    j1 = args[1] if len(args) == 2 else (None, None, 0, 0, 0, 0, 0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = MERGE_KERNEL.fn()(ptr(j0[0]), ptr(j0[1]), *j0[2:], ptr(j1[0]), ptr(j1[1]), *j1[2:],
                           len(args), stream_ptr(j0[0]))
    MERGE_KERNEL.check(rc)
    MERGE_KERNEL.launches += 1
    return outs


def evoformer_bwd_cuda(q, k, v, out, do, lse, biases, scale, plan: BiasGradPlan):
    """The backward on the card: dq (with the bias gradient in ``plan``'s
    form), dk/dv, and in the reduced form the merge. Returns (dq, dk, dv, the
    dS plane or None, per bias its reduced gradient or None)."""
    dq, delta, ds, rp = evoformer_bwd_dq_cuda(q, k, v, out, do, lse, biases, scale,
                                              want_ds=plan.form == "plane", rows=plan.rows)
    dk, dv, cp = evoformer_bwd_dkv_cuda(q, k, v, do, lse, delta, biases, scale, cols=plan.cols)
    sums = [None] * len(plan.dims)
    if plan.form == "reduced":
        asked = [i for i, dm in enumerate(plan.dims) if dm is not None]
        merged = evoformer_bias_grad_merge_cuda(
            [(rp if 2 not in plan.dims[i] else cp, merge_flags(plan.dims[i])) for i in asked])
        for i, g in zip(asked, merged):
            sums[i] = g
    return dq, dk, dv, ds, sums


class EvoformerAttention(torch.autograd.Function):
    """The kernels (CUDA tensors) or their plain versions (CPU tensors)
    under one autograd node over q, k, v [B, s, h, d] and the biases as the
    caller gave them (``lead``: the leading dims B flattens); saves q, k, v,
    out, the fp32 LSE and the bias operands. The backward forms the bias
    gradients as ``bias_grad_plan`` says, on either device."""

    @staticmethod
    def forward(ctx, q, k, v, scale, lead, *biases):
        s, h = q.shape[1], q.shape[2]
        ops = _operands(biases, lead, h, s)
        if q.device.type == "cpu":
            out, lse = evoformer_fwd_reference(q, k, v, ops, scale)
        else:
            out, lse = evoformer_fwd_cuda(q, k, v, ops, scale)
        ctx.save_for_backward(q, k, v, out, lse, *ops)
        ctx.scale, ctx.lead = scale, lead
        ctx.bias_meta = [(b.shape, b.dtype) for b in biases]
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, *ops = ctx.saved_tensors
        wanted = ctx.needs_input_grad[5:]
        s, h = q.shape[1], q.shape[2]
        plan = bias_grad_plan([shape for shape, _ in ctx.bias_meta], ops, ctx.lead, h, s, wanted)
        args = (q, k, v, out, do, lse, ops, ctx.scale)
        if q.device.type == "cpu":
            dq, dk, dv, ds, sums = evoformer_bwd_reference(
                *args, want_ds=plan.form == "plane", sums=plan.dims)
        else:
            dq, dk, dv, ds, sums = evoformer_bwd_cuda(*args, plan)
        grads = []
        for i, ((shape, dtype), want) in enumerate(zip(ctx.bias_meta, wanted)):
            if not want:
                grads.append(None)
            elif plan.form == "reduced":
                grads.append(sums[i].reshape(shape).to(dtype))
            else:
                grads.append(ds.view(*ctx.lead, h, s, s).sum_to_size(shape).to(dtype))
        return (dq, dk, dv, None, None, *grads)


def DS4Sci_EvoformerAttention(Q, K, V, biases: Optional[List] = None):
    """Reference-parity entry (``ops/deepspeed4science/evoformer_attn.py``):
    Q/K/V: [*, s, h, d] with any leading dims (none included); ``biases``:
    tensors broadcastable to [*, h, s, s] (the padding mask and the pair
    bias; any number). Returns [*, s, h, d] in Q's dtype; gradients flow to
    Q, K, V and every bias that needs one, each in its own dtype. The JAX
    function's ``interpret`` argument selects Pallas's interpreter and has
    no counterpart here: a CPU tensor runs the plain versions."""
    biases = list(biases or [])
    *lead, s, h, d = Q.shape
    B = math.prod(lead)
    q, k, v = (t.reshape(B, s, h, d) for t in (Q, K, V))
    out = EvoformerAttention.apply(q, k, v, d ** -0.5, tuple(lead), *biases)
    return out.reshape(*lead, s, h, d)
