"""Paged attention of the PyTorch port against the JAX package.

The same pools, tables and queries, made from a seed with numpy, go through
the port's ``paged_attention(impl="kernel")`` (a CPU tensor: the kernel's
plain version, which the CUDA kernel is held to on the card) and the JAX
package's ``paged_attention(impl="kernel", interpret=True)``, the Pallas
``_paged_kernel`` in interpret mode; and through the plain gathers of both
packages (dense decode, chunk attention, reference).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.attention import paged_pallas as jx
from deepspeed_tpu_torch.ops.attention import paged as pt


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# fp32 everywhere: fp32 scores and online vs one-shot softmax differ only
# in summation order (a few fp32 units in the last place of O(1) outputs)
ATOL = RTOL = 2e-5


def _world(seed, T, nh, nkv, d, bs, NB, B, E=0):
    """A pool of NB blocks + the trash block (id NB), per-token tables of
    distinct blocks, queries and E extra columns."""
    rng = np.random.default_rng(seed)
    w = {
        "q": rng.normal(size=(T, nh, d)).astype(np.float32),
        "k": rng.normal(size=(NB + 1, bs, nkv, d)).astype(np.float32),
        "v": rng.normal(size=(NB + 1, bs, nkv, d)).astype(np.float32),
        "trash": NB,
    }
    tables = np.full((T, B), NB, np.int32)
    pos = rng.integers(0, B * bs, size=T).astype(np.int32)
    for t in range(T):
        n = pos[t] // bs + 1
        tables[t, :n] = rng.permutation(NB)[:n]
    w["tables"], w["pos"] = tables, pos
    if E:
        w["ke"] = rng.normal(size=(T, E, nkv, d)).astype(np.float32)
        w["ve"] = rng.normal(size=(T, E, nkv, d)).astype(np.float32)
    return w, rng


def _both(w, extras=None, limit=None, **kw):
    """(port, jax) outputs of the kernel path for one world."""
    pj = dict(kw)
    pp = dict(kw)
    if extras is not None:
        pj["extra_kv"] = (jnp.asarray(w["ke"]), jnp.asarray(w["ve"]), jnp.asarray(extras))
        pp["extra_kv"] = (torch.from_numpy(w["ke"]), torch.from_numpy(w["ve"]),
                          torch.from_numpy(extras))
    if limit is not None:
        pj["pool_limit"] = jnp.asarray(limit)
        pp["pool_limit"] = torch.from_numpy(limit)
    want = jx.paged_attention(
        jnp.asarray(w["q"]), jnp.asarray(w["k"]), jnp.asarray(w["v"]),
        jnp.asarray(w["tables"]), jnp.asarray(w["pos"]), w["trash"],
        impl="kernel", interpret=True, **pj,
    )
    got = pt.paged_attention(
        torch.from_numpy(w["q"]), torch.from_numpy(w["k"]), torch.from_numpy(w["v"]),
        torch.from_numpy(w["tables"]), torch.from_numpy(w["pos"]), w["trash"],
        impl="kernel", **pp,
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("nh,nkv", [(4, 4), (4, 2), (8, 2)])
def test_causal_gqa_with_trash_rows(nh, nkv):
    w, _ = _world(nh * 10 + nkv, T=5, nh=nh, nkv=nkv, d=16, bs=8, NB=12, B=3)
    w["tables"][2] = w["trash"]  # an all-trash row
    got, want = _both(w)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert not got[2].any(), "an all-trash row must give exactly 0"


@pytest.mark.parametrize("E", [1, 4])
def test_pool_limit_and_extras(E):
    """The engine's write-after-read form: pool below ``limit``, extras at
    their positions (some -1), padded slots at q_pos = -1 see nothing."""
    w, rng = _world(E, T=6, nh=4, nkv=2, d=16, bs=8, NB=16, B=3, E=E)
    limit = (w["pos"] - rng.integers(0, 3, size=6)).clip(0).astype(np.int32)
    epos = (limit[:, None] + np.arange(E)[None]).astype(np.int32)
    epos[:, -1] = -1  # the last extra column is invalid everywhere
    if E > 1:
        epos[1, :] = -1
    w["pos"][4] = -1  # a padded decode slot
    w["pos"] = np.maximum(w["pos"], np.where(epos >= 0, epos, -1).max(axis=1)).astype(np.int32)
    w["pos"][4] = -1
    got, want = _both(w, extras=epos, limit=limit)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert not got[4].any(), "a slot at q_pos = -1 must give exactly 0"


def test_window_and_scale_override():
    w, rng = _world(5, T=6, nh=4, nkv=2, d=16, bs=8, NB=16, B=4, E=2)
    epos = np.stack([w["pos"] - 1, w["pos"]], axis=1).astype(np.int32)
    limit = np.maximum(w["pos"] - 1, 0).astype(np.int32)
    got, want = _both(w, extras=epos, limit=limit, window=8, scale=0.3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    got, want = _both(w, window=8)  # causal form with the window
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_all_masked_by_window_gives_zero():
    """A window that leaves no key: the online softmax must not turn the
    finite -1e30 fill into NaN, and the row must be exactly 0."""
    w, _ = _world(6, T=3, nh=4, nkv=2, d=16, bs=8, NB=8, B=2, E=1)
    epos = np.full((3, 1), -1, np.int32)
    limit = np.zeros(3, np.int32)
    got, want = _both(w, extras=epos, limit=limit)
    assert np.isfinite(got).all() and not got.any()
    np.testing.assert_array_equal(got, np.asarray(want))


def test_padded_slot_with_pool_limit_sees_nothing():
    """A slot at q_pos = -1 with a pool limit above 0: the Pallas kernel
    masks the whole pool, the JAX dense gather does not (it checks only
    kpos < limit). The port's dense path follows the kernel, since it is
    the kernel's plain version; the engine never passes this combination
    (its padded slots carry limit -1)."""
    w, _ = _world(12, T=3, nh=4, nkv=2, d=16, bs=8, NB=8, B=2)
    w["pos"][1] = -1
    limit = np.array([3, 9, 5], np.int32)
    got, want = _both(w, limit=limit)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert not got[1].any()
    jax_dense = np.asarray(jx.paged_decode_attention_dense(
        *(jnp.asarray(w[a]) for a in ("q", "k", "v", "tables", "pos")), w["trash"],
        pool_limit=jnp.asarray(limit),
    ))
    assert jax_dense[1].any(), "the JAX dense gather's difference this test pins"


def test_dense_decode_matches_jax_dense():
    w, rng = _world(8, T=5, nh=8, nkv=4, d=16, bs=8, NB=12, B=3, E=2)
    epos = np.stack([w["pos"], -np.ones(5, np.int32)], axis=1).astype(np.int32)
    want = jx.paged_decode_attention_dense(
        jnp.asarray(w["q"]), jnp.asarray(w["k"]), jnp.asarray(w["v"]),
        jnp.asarray(w["tables"]), jnp.asarray(w["pos"]), w["trash"], window=8,
        extra_kv=(jnp.asarray(w["ke"]), jnp.asarray(w["ve"]), jnp.asarray(epos)),
        pool_limit=jnp.asarray(w["pos"]),
    )
    got = pt.paged_decode_attention_dense(
        torch.from_numpy(w["q"]), torch.from_numpy(w["k"]), torch.from_numpy(w["v"]),
        torch.from_numpy(w["tables"]), torch.from_numpy(w["pos"]), w["trash"], window=8,
        extra_kv=(torch.from_numpy(w["ke"]), torch.from_numpy(w["ve"]), torch.from_numpy(epos)),
        pool_limit=torch.from_numpy(w["pos"]),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_reference_matches_jax_reference():
    w, _ = _world(9, T=4, nh=4, nkv=2, d=16, bs=8, NB=10, B=3)
    args = ("q", "k", "v", "tables", "pos")
    want = jx.paged_attention_reference(*(jnp.asarray(w[a]) for a in args), w["trash"],
                                        window=5, scale=0.2)
    got = pt.paged_attention_reference(*(torch.from_numpy(w[a]) for a in args), w["trash"],
                                       window=5, scale=0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("window", [0, 6])
def test_chunk_attention_matches_jax(window):
    """Prefill chunks: pool below the chunk start + in-chunk causal over the
    chunk's fresh K/V, padded tail tokens (q_pos = -1) give 0."""
    rng = np.random.default_rng(10 + window)
    Rc, tq, nh, nkv, d, bs, NB, B = 2, 8, 4, 2, 16, 8, 12, 3
    q = rng.normal(size=(Rc, tq, nh, d)).astype(np.float32)
    k = rng.normal(size=(NB + 1, bs, nkv, d)).astype(np.float32)
    v = rng.normal(size=(NB + 1, bs, nkv, d)).astype(np.float32)
    ke = rng.normal(size=(Rc, tq, nkv, d)).astype(np.float32)
    ve = rng.normal(size=(Rc, tq, nkv, d)).astype(np.float32)
    tables = np.stack([rng.permutation(NB)[:B] for _ in range(Rc)]).astype(np.int32)
    tables[1, 2] = NB
    start = np.array([5, 9], np.int32)
    pos = start[:, None] + np.arange(tq)[None]
    pos[1, 6:] = -1  # padded tail
    pos = pos.astype(np.int32)
    want = jx.paged_chunk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables), jnp.asarray(pos),
        NB, window=window, new_kv=(jnp.asarray(ke), jnp.asarray(ve)),
        pool_limit=jnp.asarray(start),
    )
    got = pt.paged_chunk_attention(
        *(torch.from_numpy(a) for a in (q, k, v, tables, pos)), NB, window=window,
        new_kv=(torch.from_numpy(ke), torch.from_numpy(ve)), pool_limit=torch.from_numpy(start),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert not got[1, 6:].any()
    # the legacy form: the pool already holds the chunk, causal <=
    want = jx.paged_chunk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables), jnp.asarray(pos),
        NB, window=window,
    )
    got = pt.paged_chunk_attention(
        *(torch.from_numpy(a) for a in (q, k, v, tables, pos)), NB, window=window
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_dispatch_contract():
    w, _ = _world(11, T=2, nh=4, nkv=2, d=16, bs=8, NB=4, B=2)
    args = [torch.from_numpy(w[a]) for a in ("q", "k", "v", "tables", "pos")] + [w["trash"]]
    dense = pt.paged_attention(*args, impl="dense")
    torch.testing.assert_close(pt.paged_attention(*args), dense, atol=0, rtol=0)
    torch.testing.assert_close(pt.paged_attention(*args, impl="kernel"), dense, atol=0, rtol=0)
    with pytest.raises(ValueError, match="unknown impl"):
        pt.paged_attention(*args, impl="pallas")
    with pytest.raises(ValueError, match="reference"):
        pt.paged_attention(*args, impl="reference", pool_limit=args[4])
    with pytest.raises(ValueError, match="not int8"):
        pt.paged_attention(*args, k_scale=torch.ones(5, 8, 2), v_scale=torch.ones(5, 8, 2))
    int8_pool = [args[0], args[1].to(torch.int8), args[2].to(torch.int8)] + args[3:]
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        pt.paged_attention(*int8_pool, k_scale=torch.ones(5, 8, 2))


@pytest.mark.parametrize("impl,device,d,want", [
    ("auto", "cuda", 128, "kernel"),
    (None, "cuda", 64, "kernel"),
    ("auto", "cpu", 96, "dense"),
    ("dense", "cuda", 96, "dense"),  # the plain gather on a card only when asked for
    ("kernel", "cpu", 128, "kernel"),  # runs the kernel's plain version on a CPU tensor
    ("auto", "cuda", 96, NotImplementedError),  # never the plain gather by default
    ("auto", "cuda", 80, NotImplementedError),
])
def test_resolve_impl(impl, device, d, want):
    if want is NotImplementedError:
        with pytest.raises(NotImplementedError, match="ROADMAP queue 2, item 3"):
            pt.resolve_impl(impl, device, d)
    else:
        assert pt.resolve_impl(impl, device, d) == want


@pytest.mark.cuda
def test_auto_refuses_an_unported_head_dim_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q = torch.zeros(2, 4, 96, device="cuda")
    pool = torch.zeros(3, 8, 2, 96, device="cuda")
    tables = torch.zeros(2, 1, dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError, match="head_dim 96"):
        pt.paged_attention(q, pool, pool, tables, tables[:, 0], 2)


# ---------------------------------------------------------------------------
# the kernel's split-and-merge (a plain model of it) and its argument builder
# ---------------------------------------------------------------------------
def _torch_world(w, epos=None, limit=None):
    """The paged functions' keyword arguments for a numpy world."""
    kw = dict(q=torch.from_numpy(w["q"]), k_cache=torch.from_numpy(w["k"]),
              v_cache=torch.from_numpy(w["v"]), block_tables=torch.from_numpy(w["tables"]),
              q_pos=torch.from_numpy(w["pos"]), trash_block=w["trash"])
    if epos is not None:
        kw["extra_kv"] = (torch.from_numpy(w["ke"]), torch.from_numpy(w["ve"]),
                          torch.from_numpy(epos))
    if limit is not None:
        kw["pool_limit"] = torch.from_numpy(limit)
    return kw


def _rel_frobenius(got, want):
    """||got - want|| / ||want|| per (row, head); rows that are exactly 0 in
    ``want`` must be exactly 0 in ``got`` (reported as 0 or inf)."""
    num = (got.float() - want.float()).flatten(2).norm(dim=-1)
    den = want.float().flatten(2).norm(dim=-1)
    return torch.where(den > 0, num / den.clamp(min=1e-30),
                       torch.where(num > 0, torch.full_like(num, float("inf")), num))


# a pool limit, two extras, a window: the round form at a tiny size (the
# pool span is B * bs = 32 keys: 32, 16 and 5 keys per split give 1, 2 and 7
# pool splits; the extras take one split of their own)
@pytest.mark.parametrize("split_keys,n_pool", [(32, 1), (16, 2), (5, 7)])
def test_split_merge_matches_dense(split_keys, n_pool):
    w, rng = _world(20 + n_pool, T=7, nh=8, nkv=2, d=16, bs=8, NB=16, B=4, E=2)
    limit = np.maximum(w["pos"] - rng.integers(0, 4, size=7), 0).astype(np.int32)
    epos = np.stack([limit, w["pos"]], axis=1).astype(np.int32)
    for window in (0, 11):
        kw = _torch_world(w, epos, limit)
        want = pt.paged_decode_attention_dense(**kw, window=window)
        got, parts = pt.paged_decode_split_merge(**kw, window=window, split_keys=split_keys,
                                                 return_partials=True)
        assert len(parts) == n_pool + 1
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    # the kernel's own plan at this size: one pool split, one extras split
    got = pt.paged_decode_split_merge(**kw)
    torch.testing.assert_close(got, pt.paged_decode_attention_dense(**kw), atol=ATOL, rtol=RTOL)


def test_split_merge_masked_splits_and_empty_rows():
    """A split that is wholly masked leaves an empty state (m = -1e30, l = 0)
    that the merge skips; a window that cuts splits in their middle; an
    all-trash row and a padded slot give exactly 0, as the dense version."""
    w, _ = _world(31, T=5, nh=4, nkv=2, d=16, bs=8, NB=16, B=4, E=1)
    w["pos"][:] = [30, 29, 17, 31, -1]
    w["tables"][2] = w["trash"]  # an all-trash row (its extra is invalid too)
    w["tables"][1, 1] = w["trash"]  # a trash block inside row 1's range
    limit = np.array([28, 29, 17, 31, -1], np.int32)
    epos = np.array([[30], [29], [-1], [31], [-1]], np.int32)
    kw = _torch_world(w, epos, limit)
    for window in (0, 13):
        want = pt.paged_decode_attention_dense(**kw, window=window)
        got, parts = pt.paged_decode_split_merge(**kw, window=window, split_keys=6,
                                                 return_partials=True)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
        for r in (2, 4):
            assert not got[r].any() and not want[r].any()
        m = torch.stack([p[0] for p in parts])  # [splits, R, nkv, G]
        ls = torch.stack([p[1] for p in parts])
        empty = m <= 0.5 * pt.NEG_INF
        assert bool((ls[empty] == 0).all())
        # row 1 (lo = 0 without a window): its second split lies on the
        # trash block; with the window the last splits lie past hi
        assert bool(empty[:, 1].all(dim=(1, 2)).any())
        assert bool(empty[:, 2].all()) and bool(empty[:, 4].all())


@pytest.mark.parametrize("fault", ["drop", "double"])
def test_a_dropped_or_doubled_split_fails_the_check(fault):
    """The per-(row, head) relative Frobenius check the kernels are held to
    (1e-2 in bf16) sees one split too few or too many."""
    w, _ = _world(41, T=6, nh=8, nkv=2, d=16, bs=8, NB=16, B=4)
    w["pos"][:] = 31
    kw = _torch_world(w)
    want = pt.paged_decode_attention_dense(**kw)
    _, parts = pt.paged_decode_split_merge(**kw, split_keys=8, return_partials=True)
    assert len(parts) == 4
    torch.testing.assert_close(pt.merge_partials(parts).reshape(want.shape), want,
                               atol=ATOL, rtol=RTOL)
    bad = parts[:1] + parts[2:] if fault == "drop" else parts + parts[1:2]
    err = _rel_frobenius(pt.merge_partials(bad).reshape(want.shape), want)
    assert float(err.max()) > 1e-2


def test_decode_splits_plan():
    # the round form at Mistral-7B width: R 32, 8 kv heads, group 4, a
    # 640-token pool span, 64 extras: 2 pool splits of 320 keys and 1 extra
    # (768 CTAs)
    assert pt.decode_splits(32, 8, 4, 640, 64, 128) == (320, 2, 1)
    # few rows: more splits, each at least two tiles
    assert pt.decode_splits(2, 8, 4, 640, 1, 128) == (128, 5, 1)
    # the per-row form (256 queries of one row) fills the card in one split
    sk, n_pool, n_extra = pt.decode_splits(256, 8, 4, 1024, 256, 128)
    assert (n_pool, n_extra) == (1, 1) and sk >= 1024
    # at least two tiles a split, a multiple of the tile (32 keys at d 256)
    sk, n_pool, _ = pt.decode_splits(1, 1, 1, 40, 0, 256)
    assert sk == 64 and n_pool == 1
    assert pt.decode_span(5, 128, 200, has_limit=False) == 200
    assert pt.decode_span(5, 128, 200, has_limit=True) == 640


def _stride_world():
    """The per-row form at a tiny size: T queries sharing one row's table,
    the chunk's own K/V as extras through a stride-0 expand view."""
    rng = np.random.default_rng(51)
    T, nh, nkv, d, bs, NB, B = 5, 4, 2, 64, 8, 6, 3
    q = torch.from_numpy(rng.normal(size=(T, nh, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(NB + 1, bs, nkv, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(NB + 1, bs, nkv, d)).astype(np.float32))
    chunk_k = torch.from_numpy(rng.normal(size=(T, nkv, d)).astype(np.float32))
    chunk_v = torch.from_numpy(rng.normal(size=(T, nkv, d)).astype(np.float32))
    start = 11
    pos = torch.arange(start, start + T, dtype=torch.int32)
    epos = pos.clone()
    epos[-1] = -1  # a padded tail column
    tables = torch.tensor([[2, 0, 5]], dtype=torch.int32).expand(T, B)
    kw = dict(q=q, k_cache=k, v_cache=v, block_tables=tables, q_pos=pos, trash_block=NB,
              pool_limit=torch.full((T,), start, dtype=torch.int32))
    view = (chunk_k[None].expand(T, T, nkv, d), chunk_v[None].expand(T, T, nkv, d),
            epos[None].expand(T, T))
    return kw, view


def test_stride0_extras_match_their_copy_on_the_cpu():
    kw, view = _stride_world()
    got = pt.paged_decode(**kw, extra_kv=view)
    want = pt.paged_decode(**kw, extra_kv=tuple(t.contiguous() for t in view))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(pt.paged_decode_split_merge(**kw, extra_kv=view), want,
                               atol=ATOL, rtol=RTOL)


def test_args_pass_the_views_stride_without_a_copy():
    kw, view = _stride_world()
    a = pt.paged_decode_args(**kw, extra_kv=view)
    assert (a.x_stride, a.e_stride) == (0, 0)
    assert a.ke.data_ptr() == view[0].data_ptr() and a.ve.data_ptr() == view[1].data_ptr()
    assert a.epos.data_ptr() == view[2].data_ptr()
    assert a.E == 5 and a.splits == a.pool_splits + a.extra_splits
    # a contiguous extras tensor: its row stride
    dense = tuple(t.contiguous() for t in view)
    a = pt.paged_decode_args(**kw, extra_kv=dense)
    assert a.x_stride == 5 * 2 * 64 and a.e_stride == 5
    assert a.ke.data_ptr() == dense[0].data_ptr()


def test_args_copy_a_view_whose_inner_dims_are_not_contiguous():
    kw, (ke, ve, epos) = _stride_world()
    odd = ke.contiguous().transpose(2, 3).contiguous().transpose(2, 3)  # [T, E, nkv, d], d strided
    assert not odd.is_contiguous() and odd.stride(3) != 1
    a = pt.paged_decode_args(**kw, extra_kv=(odd, ve, epos))
    assert a.ke.is_contiguous() and a.ke.data_ptr() != odd.data_ptr()
    assert torch.equal(a.ke, odd) and a.x_stride == 5 * 2 * 64
    assert a.ve.stride(0) == a.x_stride  # one row stride for both operands
    torch.testing.assert_close(pt.paged_decode(**kw, extra_kv=(odd, ve, epos)),
                               pt.paged_decode(**kw, extra_kv=(ke.contiguous(), ve, epos)),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="extra V"):
        pt.paged_decode_args(**kw, extra_kv=(ke[:, :3], ve, epos))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    for d in pt.KERNEL_HEAD_DIMS:
        w, rng = _world(d, T=6, nh=8, nkv=2, d=d, bs=16, NB=12, B=3, E=3)
        w["tables"][1, 0] = w["tables"][3, 0] = w["tables"][0, 0]  # a shared block
        epos = np.stack([w["pos"] - 1, w["pos"], -np.ones(6, np.int32)], 1).astype(np.int32)
        limit = np.maximum(w["pos"] - 1, 0).astype(np.int32)
        cu = {k: torch.as_tensor(v).cuda() for k, v in w.items() if k != "trash"}
        kw = dict(extra_kv=(cu["ke"], cu["ve"], torch.as_tensor(epos).cuda()),
                  pool_limit=torch.as_tensor(limit).cuda(), window=10)
        args = [cu[a] for a in ("q", "k", "v", "tables", "pos")] + [w["trash"]]
        before = pt.PAGED_KERNEL.launches
        got = pt.paged_decode(*args, **kw)
        assert pt.PAGED_KERNEL.launches == before + 1
        torch.testing.assert_close(got, pt.paged_decode_attention_dense(*args, **kw),
                                   atol=ATOL, rtol=RTOL)
    # stride-0 extras (the per-row form), fp32 and bf16
    kw, view = _stride_world()
    for dt, tol in ((torch.float32, ATOL), (torch.bfloat16, 2.0 ** -6)):
        ck = {k: (v.cuda().to(dt) if v.dtype == torch.float32 else v.cuda())
              if torch.is_tensor(v) else v for k, v in kw.items()}
        cv = tuple(t[0].cuda()[None].expand(t.shape) for t in view)  # stride 0 on the card
        cv = (cv[0].to(dt), cv[1].to(dt), cv[2])
        cv = tuple(t[0][None].expand(t.shape) for t in cv)
        assert pt.paged_decode_args(**ck, extra_kv=cv).x_stride == 0
        got = pt.paged_decode(**ck, extra_kv=cv)
        want = pt.paged_decode_attention_dense(**ck, extra_kv=cv)
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
