"""Context-parallel ring attention of the port, over the flash carry kernels.

Counterpart of ``deepspeed_tpu/ops/attention/sharded.py``. The sequence
dimension is cut into N chunks over the topology's ``context`` axis; k/v
chunks (forward, dq) or the q side (dk/dv) travel around a ring while each
rank's raw softmax state or raw gradient sums stay home, threaded from
hop to hop through the carry-mode chunk entries of ``flash.py`` (the
kernels of ``ops/kernels/csrc/flash_chunk.cu`` on a card, their plain
versions on the CPU).

The hop schedule is the JAX package's, written once (``_ring_a``,
``_ring_b``) and driven in two forms:

  * the process form: one rank per process, q/k/v the rank's own [b, h,
    s/N, d] chunk; a rotation is ``comm.ppermute`` over the context group
    (NCCL for CUDA tensors, gloo for CPU tensors);
  * the loopback form (a ``Topology(loopback=True)``): one process holds
    the N context ranks, q/k/v are the global [b, h, s, d] arrays, cut into
    N chunks, and every rank takes each hop in lock-step; a rotation is a
    shift of the list of chunks. It is the counterpart of the JAX package's
    N virtual devices in one process.

Schedule (``sharded.py:266-432`` in the JAX package):

  * ring A (forward, dq): k/v pre-rotate one hop, then rank i at hop t
    holds chunk (i + t + 1) % N: the causal chunks arrive 0, 1, ..., i,
    the diagonal last;
  * ring B (dk/dv): the q side (q, out, do, lse, ids) rotates the same way,
    compute before rotate: the home k/v see q chunks i, i + 1, ..., N - 1,
    the diagonal first;
  * a hop whose chunk the causal mask hides launches nothing; every hop
    still rotates (collectives stay uniform across the ring).

Arrival in ascending global order is the single kernel's streaming order.
The forward runs the single forward's CTA body, whose rows depend on where
their key tiles start (``FWD_TILES[d]["bk"]``: 128 keys at d 64 and 128, 64
at d 256), and the backward the single backward's bodies, dq's rows on where
its key tiles start (``BWD_TILES[d]["bk"]``: 64, 32 at d 256) and dk/dv's on
where its query tiles start (``BWD_TILES[d]["kv_bq"]``: 64), the GQA group's
heads inner in both forms. So with chunks that are whole tiles of all three
(``ring_matches_flash``: chunks of a multiple of 128 rows at every d) the
ring's out, lse, dq, dk and dv (GQA too) are the single flash kernels' bits;
other chunks give the same function rounded differently (an fp32 rescale
or a partial sum falls elsewhere). "auto" promotes to the ring only at
chunks of a multiple of 128 rows (``core._ring_eligible``), the JAX
package's rule, where the bits hold at every d. The chunk
kernels finalize on a row's last hop, through the single kernels'
epilogues. Causal only, no window, no ALiBi, s divisible by N: each other
case raises.
"""

import torch

from deepspeed_tpu_torch.ops.attention.flash import (
    BWD_TILES,
    FWD_TILES,
    flash_attention,
    flash_dkv_chunk,
    flash_dq_chunk,
    flash_fwd_chunk,
)
from deepspeed_tpu_torch.parallel.topology import CONTEXT_AXIS, get_topology


def ring_matches_flash(chunk, d):
    """Whether the ring over chunks of ``chunk`` rows at head dim ``d``
    gives the single flash kernels' bits on a card: no forward key tile,
    no dq key tile and no dk/dv query tile straddles a chunk boundary."""
    tiles = (FWD_TILES[d]["bk"], BWD_TILES[d]["bk"], BWD_TILES[d]["kv_bq"])
    return all(chunk % t == 0 for t in tiles)


def _divisible(topo, b, h, h_kv, s=None):
    """Whether the canonical layout divides over the grid (batch over
    data/expert, heads over model+sequence, optionally seq over context)."""
    batch_div = topo.data_parallel_size * topo.expert_parallel_size
    head_div = topo.model_parallel_size * topo.sequence_parallel_size
    if b % batch_div or h % head_div or h_kv % head_div:
        return False
    if (h // h_kv) > 1 and (h // head_div) % (h // h_kv) != 0:
        return False  # GQA group would straddle a head shard
    if s is not None and s % topo.context_parallel_size:
        return False
    return True


def _no_alibi(where, alibi_slopes):
    if alibi_slopes is not None:
        raise NotImplementedError(
            f"{where}: ALiBi through the chunk kernels and the head-sharded form is not "
            "ported yet (ROADMAP queue 2, item 1)")


def head_sharded_flash(q, k, v, causal=True, segment_ids=None, scale=None, alibi_slopes=None,
                       alibi_positions=None, window=0, window_flag=None):
    """Flash attention over the batch rows this process holds. With model
    and sequence at size 1 (all the port runs) the head axes are whole on
    every rank, so this is the local flash call; head sharding over model
    and sequence comes with tensor parallelism (ROADMAP queue 1, item 6)."""
    _no_alibi("head_sharded_flash", alibi_slopes)
    return flash_attention(q, k, v, causal=causal, segment_ids=segment_ids, scale=scale,
                           window=window, window_flag=window_flag)


# ---------------------------------------------------------------------------
# the hop schedule, once for both forms
# ---------------------------------------------------------------------------
class _Ring:
    """The ranks this process drives along a ring of ``n`` and how a list
    of per-rank payloads (dicts of tensors) moves one hop: every rank
    receives the payload of the next rank."""

    def __init__(self, n, ranks, rotate):
        self.n = n
        self.ranks = ranks
        self.rotate = rotate

    def split(self, x, dim):
        """A tensor of this process into per-rank chunks."""
        if len(self.ranks) == 1:
            return [x.contiguous()]
        return [c.contiguous() for c in x.chunk(self.n, dim=dim)]

    def join(self, xs, dim):
        return xs[0] if len(xs) == 1 else torch.cat(xs, dim=dim)


def loopback_ring(n):
    """All n ranks in this process; a hop shifts the list."""
    return _Ring(n, list(range(n)), lambda pay: pay[1:] + pay[:1])


def process_ring(n, index, axis=CONTEXT_AXIS):
    """This process is rank ``index`` of the ring over ``axis``; a hop is
    one ``ppermute`` per tensor: member r sends to r - 1."""
    from deepspeed_tpu_torch import comm

    perm = [(r, (r - 1) % n) for r in range(n)]

    def rotate(pay):
        return [{key: comm.ppermute(x, perm, axis) for key, x in pay[0].items()}]

    return _Ring(n, [index], rotate)


def _ring_a(ring, payload, visit):
    """Ring A (forward, dq). ``payload``: per-rank k/v-side dicts. Calls
    ``visit(j, chunk_payload, causal, final)`` for every active hop of the
    j-th rank this process drives."""
    n = ring.n
    payload = ring.rotate(payload)
    for t in range(n):
        nxt = ring.rotate(payload) if t < n - 1 else payload
        for j, i in enumerate(ring.ranks):
            src = (i + t + 1) % n  # the chunk this hop delivered
            if t == n - 1:  # the diagonal, last for every rank
                visit(j, payload[j], True, True)
            elif src < i:
                visit(j, payload[j], False, False)
        payload = nxt


def _ring_b(ring, payload, visit):
    """Ring B (dk/dv). ``payload``: per-rank q-side dicts. The diagonal
    is hop 0 and a rank's last active hop brings chunk N - 1."""
    n = ring.n
    for t in range(n):
        nxt = ring.rotate(payload) if t < n - 1 else payload
        for j, i in enumerate(ring.ranks):
            src = (i + t) % n  # the q chunk visiting this hop
            if t == 0 or src > i:
                visit(j, payload[j], t == 0, src == n - 1)
        payload = nxt


def _pair(home, visitor):
    return None if home is None else (home, visitor)


def ring_forward(ring, qs, ks, vs, segs, scale):
    """Per-rank chunks in, per-rank (out, lse) out: ring A over the
    forward chunk entry."""
    carry, res = [None] * len(qs), [None] * len(qs)

    def visit(j, pay, causal, final):
        r = flash_fwd_chunk(qs[j], pay["k"], pay["v"], carry[j], _pair(segs[j], pay.get("seg")),
                            causal=causal, scale=scale, final=final)
        if final:
            res[j] = r
        else:
            carry[j] = r

    payload = [dict(k=k, v=v, **({} if s is None else {"seg": s}))
               for k, v, s in zip(ks, vs, segs)]
    _ring_a(ring, payload, visit)
    return [r[0] for r in res], [r[1] for r in res]


def ring_backward(ring, qs, ks, vs, outs, dos, lses, segs, scale):
    """Per-rank (dq, dk, dv): ring A over the dq chunk entry, then ring B
    over the dk/dv chunk entry."""
    m = len(qs)
    acc, dq = [None] * m, [None] * m

    def visit_dq(j, pay, causal, final):
        r = flash_dq_chunk(qs[j], pay["k"], pay["v"], outs[j], dos[j], lses[j], acc[j],
                           _pair(segs[j], pay.get("seg")), causal=causal, scale=scale,
                           final=final)
        if final:
            dq[j] = r
        else:
            acc[j] = r

    payload = [dict(k=k, v=v, **({} if s is None else {"seg": s}))
               for k, v, s in zip(ks, vs, segs)]
    _ring_a(ring, payload, visit_dq)
    del acc, payload

    carry, dkv = [None] * m, [None] * m

    def visit_dkv(j, pay, causal, final):
        r = flash_dkv_chunk(pay["q"], ks[j], vs[j], pay["o"], pay["do"], pay["lse"], carry[j],
                            _pair(pay.get("seg"), segs[j]), causal=causal, scale=scale,
                            final=final)
        if final:
            dkv[j] = r
        else:
            carry[j] = r

    payload = [dict(q=q, o=o, do=do, lse=lse, **({} if s is None else {"seg": s}))
               for q, o, do, lse, s in zip(qs, outs, dos, lses, segs)]
    _ring_b(ring, payload, visit_dkv)
    return dq, [r[0] for r in dkv], [r[1] for r in dkv]


class RingAttention(torch.autograd.Function):
    """The ring under one autograd node: forward = ring A; backward = ring
    A (dq), then ring B (dk/dv). Saves q, k, v, out and the fp32 lse."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, scale, ring):
        qs, ks, vs = (ring.split(x, 2) for x in (q, k, v))
        segs = ring.split(segment_ids, 1) if segment_ids is not None else [None] * len(qs)
        outs, lses = ring_forward(ring, qs, ks, vs, segs, scale)
        out, lse = ring.join(outs, 2), ring.join(lses, 2)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.ring, ctx.scale = ring, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        ring = ctx.ring
        qs, ks, vs, outs, dos, lses = (ring.split(x, 2) for x in (q, k, v, out, do, lse))
        segs = ring.split(segment_ids, 1) if segment_ids is not None else [None] * len(qs)
        dq, dk, dv = ring_backward(ring, qs, ks, vs, outs, dos, lses, segs, ctx.scale)
        return ring.join(dq, 2), ring.join(dk, 2), ring.join(dv, 2), None, None, None


def ring_attention_local(q, k, v, segment_ids=None, scale=None, alibi_slopes=None,
                         axis_name=CONTEXT_AXIS, axis_size=None):
    """The per-process ring body (the process form): q [b, h, s/N, d], k/v
    [b, h_kv, s/N, d] and segment ids [b, s/N] are this rank's chunk of the
    sequence, rank = this process's index along ``axis_name``. Causal
    only. Differentiable (two gradient rings)."""
    _no_alibi("ring_attention_local", alibi_slopes)
    topo = get_topology()
    n = axis_size if axis_size is not None else topo.axis_size(axis_name)
    if n == 1:
        return flash_attention(q, k, v, causal=True, segment_ids=segment_ids, scale=scale)
    return RingAttention.apply(q, k, v, segment_ids, scale,
                               process_ring(n, topo.axis_index(axis_name), axis_name))


def ring_flash_attention(q, k, v, causal=True, segment_ids=None, scale=None, alibi_slopes=None,
                         window=0):
    """Context-parallel flash attention over the topology's ``context``
    axis: the global [b, h, s, d] arrays in the loopback form, this rank's
    chunk in the process form. Raises on what the ring cannot do (it does
    not fall back): non-causal attention (a uniform rotation only gives
    ascending arrival for the causal triangle), a sliding window (band
    masks are global-position), ALiBi, and a sequence N does not divide.
    With context 1 it is ``head_sharded_flash``."""
    if not causal:
        raise NotImplementedError(
            "ring_flash_attention: causal=False not supported - the ring schedule needs "
            "ascending chunk arrival, which a uniform rotation only yields for the causal "
            "triangle")
    if window:
        raise NotImplementedError(
            "ring_flash_attention: sliding window not supported on the ring path (band masks "
            "are global-position)")
    _no_alibi("ring_flash_attention", alibi_slopes)
    topo = get_topology()
    n = topo.context_parallel_size
    if n == 1:
        return head_sharded_flash(q, k, v, causal=True, segment_ids=segment_ids, scale=scale)
    if topo.distributed:
        return ring_attention_local(q, k, v, segment_ids=segment_ids, scale=scale, axis_size=n)
    b, h, s, d = q.shape
    if not _divisible(topo, b, h, k.shape[1], s=s):
        raise ValueError(f"ring_flash_attention: shapes b={b} h={h} h_kv={k.shape[1]} s={s} "
                         f"do not divide the grid {topo.sizes}")
    return RingAttention.apply(q, k, v, segment_ids, scale, loopback_ring(n))
