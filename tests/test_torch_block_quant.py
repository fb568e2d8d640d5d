"""The port's block quantizer against the JAX package's, on the CPU.

The same inputs, made from a seed with numpy, go through the port's
quantizers (one plane, and the engine's pair of K and V) (a CPU tensor: the ``block_quant`` kernel's plain version, which
the CUDA kernel is held to bit for bit on the card) and the JAX package's:
``quantize_kv`` and ``quantize_blockwise`` as its engine and its training
paths run them, under ``jax.jit`` (XLA turns ``absmax / qmax`` into a
product with the fp32 reciprocal there), and ``quantize_blockwise_pallas``
with its Pallas ``_quant_kernel`` in interpret mode. Codes are compared
bit for bit and scales exactly; stochastic rounding, whose bits differ from
the TPU PRNG's, is held to its distribution.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.quantizer import block_quant as jbq
from deepspeed_tpu_torch.ops import kernels as K
from deepspeed_tpu_torch.ops.quantizer import block_quant as pbq


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_jit_kv = jax.jit(jbq.quantize_kv)


def _ties(rng, n, d, qmax=127.0):
    """[n, d] fp32 rows, each holding values whose ``x * inv`` is exactly
    k + 0.5 under the scale chain (absmax * fl(1/qmax), 1 / scale), so
    the round-half-to-even rule decides their codes."""
    c = np.float32(1.0) / np.float32(qmax)
    rows = []
    while len(rows) < n:
        absmax = np.float32(rng.uniform(0.5, 50.0))
        s = np.float32(absmax * c)
        inv = np.float32(np.float32(1.0) / s)
        row = rng.normal(size=d).astype(np.float32) * absmax / 4
        row[0] = absmax
        found = 0
        for k in range(-60, 60, 3):
            x = np.float32((k + 0.5) / np.float64(inv))
            if abs(x) < absmax and np.float32(x * inv) == np.float32(k + 0.5):
                row[1 + found] = x
                found += 1
                if found == d - 1:
                    break
        if found >= 4:
            rows.append(row)
    return np.stack(rows)


def _kv_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * rng.uniform(1e-3, 100, size=shape[:-1] + (1,))).astype(
        np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0  # a zero vector: scale 0, codes 0
    flat[1 : 1 + 8] = _ties(rng, 8, shape[-1])
    return x


def _tie_count(x):
    """How many elements of x sit exactly on k + 0.5 under the scale chain."""
    flat = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    s, inv = pbq._scales_and_inverse(flat.abs().amax(-1, keepdim=True), 127.0)
    y = flat * inv
    return int(((y - torch.floor(y)) == 0.5).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 3, 64), (40, 128), (6, 2, 16)])
def test_quantize_kv_matches_jax_bitwise(shape, dtype):
    x = _kv_inputs(len(shape) * 100 + shape[-1], shape)
    assert _tie_count(x) >= 32, "the inputs must hold exact ties"
    jx = jnp.asarray(x).astype(dtype)
    want_q, want_s = _jit_kv(jx)
    px = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got_q, got_s = pbq.quantize_kv(px)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert tuple(got_q.shape) == shape and tuple(got_s.shape) == shape[:-1]
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    flat_q = got_q.reshape(-1, shape[-1])
    assert not flat_q[0].any() and float(got_s.reshape(-1)[0]) == 0.0
    # dequant: the same product on both sides
    np.testing.assert_array_equal(pbq.dequantize_kv(got_q, got_s).numpy(),
                                  np.asarray(jbq.dequantize_kv(want_q, want_s)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 3, 64), (40, 128), (7, 2, 256)])
def test_quantize_kv_pair_is_quantize_kv_of_each_plane(shape, dtype):
    """The engine's pair form (K and V of one write, one launch on a card)
    equals ``quantize_kv`` of each plane and the JAX package's
    ``quantize_kv`` of each, bit for bit; ``block_quant_pair`` equals
    ``block_quant`` of each plane in the stochastic mode too (the noise is
    indexed within each plane)."""
    k = _kv_inputs(len(shape) * 10 + shape[-1], shape)
    v = _kv_inputs(len(shape) * 10 + shape[-1] + 1, shape)
    jk, jv = (jnp.asarray(x).astype(dtype) for x in (k, v))
    pk, pv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
              for x in (jk, jv))
    (qk, sk), (qv, sv) = pbq.quantize_kv_pair(pk, pv)
    for (q, sc), px, jx in (((qk, sk), pk, jk), ((qv, sv), pv, jv)):
        assert q.dtype == torch.int8 and tuple(q.shape) == shape
        assert tuple(sc.shape) == shape[:-1]
        one_q, one_s = pbq.quantize_kv(px)
        assert torch.equal(q, one_q) and torch.equal(sc.view(torch.int32),
                                                     one_s.view(torch.int32))
        want_q, want_s = _jit_kv(jx)
        np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(want_s))
    rows_k, rows_v = pk.reshape(-1, shape[-1]), pv.reshape(-1, shape[-1])
    for stochastic in (False, True):
        pair = pbq.block_quant_pair(rows_k, rows_v, 127.0, stochastic, seed=5)
        for got, rows in zip(pair, (rows_k, rows_v)):
            want = pbq.block_quant(rows, 127.0, stochastic, seed=5)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_block_quant_pair_wants_one_shape_and_a_device():
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="one shape"):
        pbq.block_quant_pair(x, torch.zeros(4, 128))
    with pytest.raises(ValueError, match="one shape"):
        pbq.block_quant_pair(x, x.double())
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pbq.block_quant_pair(x.to("meta"), x.to("meta"))


def test_ties_round_half_to_even():
    """The tie elements land on the even neighbour (torch.round and
    jnp.round, and rintf in the kernel)."""
    rng = np.random.default_rng(3)
    x = _ties(rng, 4, 64)
    q, s = pbq.quantize_kv(torch.from_numpy(x))
    flat = torch.from_numpy(x)
    _, inv = pbq._scales_and_inverse(flat.abs().amax(-1, keepdim=True), 127.0)
    y = flat * inv
    tie = (y - torch.floor(y)) == 0.5
    assert int(tie.sum()) >= 16
    assert bool((q[tie].long() % 2 == 0).all())


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype,block,n", [("float32", 64, 3000), ("bfloat16", 256, 5000),
                                           ("float32", 2048, 2048 * 8)])
def test_kernel_reference_matches_pallas_interpret(bits, dtype, block, n):
    """The kernel's plain version against ``quantize_blockwise_pallas`` in
    interpret mode: rows padded to a multiple of 8 blocks, values and
    scales equal (int4: the same torch/jnp post-pass pack)."""
    rng = np.random.default_rng(bits * 10 + block)
    x = (rng.normal(size=(n,)) * 3).astype(np.float32)
    x[:block] = 0.0  # a zero block
    jx = jnp.asarray(x).astype(dtype)
    want = jbq.quantize_blockwise_pallas(jx, bits=bits, block_size=block, interpret=True)
    px = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = pbq.quantize_blockwise_kernel_reference(px, bits=bits, block_size=block)
    assert got.shape == want.shape and got.bits == bits and got.block_size == block
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    # the wrapper takes the plain version for a CPU tensor
    same = pbq.quantize_blockwise_kernel(px, bits=bits, block_size=block)
    assert torch.equal(same.values, got.values) and torch.equal(same.scales, got.scales)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,block", [((37, 50), 64), ((4096,), 2048), ((3, 5, 16), 8)])
def test_blockwise_round_trip_matches_jax(bits, shape, block):
    rng = np.random.default_rng(bits + block)
    x = rng.normal(size=shape).astype(np.float32) * 2
    fn = jax.jit(lambda a: jbq.quantize_blockwise(a, bits=bits, block_size=block))
    want = fn(jnp.asarray(x))
    got = pbq.quantize_blockwise(torch.from_numpy(x), bits=bits, block_size=block)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    back = pbq.dequantize_blockwise(got)
    assert tuple(back.shape) == shape
    np.testing.assert_array_equal(back.numpy(), np.asarray(jbq.dequantize_blockwise(want)))
    # the per-row helpers (qgZ's layout) against JAX's
    rows = x.reshape(-1)[: (x.size // block) * block].reshape(-1, block)
    if rows.size:
        jp, js = jax.jit(lambda r: jbq._quantize_rows(r, bits, block))(jnp.asarray(rows))
        pp, ps = pbq._quantize_rows(torch.from_numpy(rows), bits, block)
        np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        np.testing.assert_array_equal(pbq._dequantize_rows(pp, ps, bits, block).numpy(),
                                      np.asarray(jbq._dequantize_rows(jp, js, bits, block)))


def test_stochastic_rounding_distribution():
    """The kernel's stochastic mode (its plain version here): every code is
    the floor or the ceiling of x * inv, other seeds give other codes, and
    the mean of the dequantized values over 256 seeds is within 0.16 of a
    scale of x everywhere (5 standard deviations of a mean of 256 roundings,
    each at most half a scale from its mean), 0.03 in mean absolute value
    (a mean of 256 roundings spreads by ~0.026 on average) and 0.005 in
    signed mean over the 1024 elements (no bias)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.normal(size=(4, 256)) * 2).astype(np.float32))
    _, inv = pbq._scales_and_inverse(x.abs().amax(-1, keepdim=True), 127.0)
    y = x * inv
    acc = torch.zeros_like(x)
    first = None
    for seed in range(256):
        q, s = pbq.block_quant_reference(x, 127.0, stochastic=True, seed=seed)
        qf = q.float()
        assert bool(((qf == torch.floor(y)) | (qf == torch.ceil(y))).all())
        first = q if first is None else first
        acc += qf * s[:, None]
    assert not torch.equal(first, pbq.block_quant_reference(x, 127.0, True, 1)[0])
    scale = s[:, None]
    err = (acc / 256 - x) / scale
    assert float(err.abs().max()) < 0.16 and float(err.abs().mean()) < 0.03
    assert abs(float(err.mean())) < 0.005
    # the deterministic codes are biased by up to half a scale: the check sees bias
    det = pbq.block_quant_reference(x, 127.0)[0].float() * scale
    assert float(((det - x).abs() / scale).max()) > 0.4


def test_stochastic_noise_is_the_counter_hash():
    """The noise words: top 24 bits of fold(fold(mix32(seed), i >> 32), i),
    in [-0.5, 0.5), reproducible, and different across seeds."""
    a = pbq.stochastic_noise(3, 16, 5, "cpu")
    assert a.shape == (3, 16) and bool((a >= -0.5).all()) and bool((a < 0.5).all())
    assert torch.equal(a, pbq.stochastic_noise(3, 16, 5, "cpu"))
    assert not torch.equal(a, pbq.stochastic_noise(3, 16, 6, "cpu"))
    from deepspeed_tpu_torch.utils.counter_hash import fold, mix32

    key = mix32(torch.tensor(5))
    bits = fold(fold(key, torch.tensor(0)), torch.tensor(17))
    assert float(a[1, 1]) == float((bits >> 8).float() / (1 << 24) - 0.5)


def test_stochastic_blockwise_needs_a_generator():
    x = torch.randn(64)
    with pytest.raises(ValueError, match="rng"):
        pbq.quantize_blockwise(x, block_size=16, stochastic=True)
    g = torch.Generator().manual_seed(0)
    qt = pbq.quantize_blockwise(x, block_size=16, stochastic=True, rng=g)
    det = pbq.quantize_blockwise(x, block_size=16)
    assert bool(((qt.values.long() - det.values.long()).abs() <= 1).all())


def test_wrapper_never_falls_back_for_device_tensors():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pbq.block_quant(torch.zeros(4, 16, device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pbq.quantize_kv(torch.zeros(2, 4, 64, device="meta"))


@pytest.mark.cuda
def test_cuda_block_quant_matches_plain_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, block in ((1037, 128), (64, 2048), (19, 8), (300, 256)):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(rows, block, generator=gen, device="cuda").to(dtype)
            x[0] = 0
            for stochastic in (False, True):
                before = pbq.QUANT_KERNEL.launches
                q, s = pbq.block_quant(x, 127.0, stochastic, seed=9)
                assert pbq.QUANT_KERNEL.launches == before + 1
                wq, ws = pbq.block_quant_reference(x, 127.0, stochastic, seed=9)
                assert torch.equal(q, wq)
                assert torch.equal(s.view(torch.int32), ws.view(torch.int32))
    # the pair (K and V of one write in one launch) at the head dims, with a
    # row count that fills no CTA (CTAs of 32 / 16 / 8 rows) and one that
    # fills one wave of a split step's write
    for rows, d in ((1037, 64), (8448, 128), (13, 128), (299, 256)):
        for dtype in (torch.bfloat16, torch.float32):
            a = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
            b = torch.randn(rows, d, generator=gen, device="cuda").to(dtype) * 3
            a[1] = 0
            for stochastic in (False, True):
                before = pbq.QUANT_KERNEL.launches
                pair = pbq.block_quant_pair(a, b, 127.0, stochastic, seed=11)
                assert pbq.QUANT_KERNEL.launches == before + 1
                for (q, s), x in zip(pair, (a, b)):
                    wq, ws = pbq.block_quant_reference(x, 127.0, stochastic, seed=11)
                    assert torch.equal(q, wq)
                    assert torch.equal(s.view(torch.int32), ws.view(torch.int32))
    x = torch.randn(3, 5, 128, generator=gen, device="cuda").to(torch.bfloat16)
    q, s = pbq.quantize_kv(x)
    wq, ws = pbq.block_quant_reference(x.reshape(-1, 128), 127.0)
    assert torch.equal(q.reshape(-1, 128), wq) and torch.equal(s.reshape(-1), ws)
    K.reset_counts()
    (qk, sk), (qv, sv) = pbq.quantize_kv_pair(x, x * 2)
    assert K.counts()["block_quant"] == 1
    assert torch.equal(qk, q) and torch.equal(sk, s)
    wq, ws = pbq.block_quant_reference((x * 2).reshape(-1, 128), 127.0)
    assert torch.equal(qv.reshape(-1, 128), wq) and torch.equal(sv.reshape(-1), ws)
    K.reset_counts()
    pbq.quantize_blockwise_kernel(x, bits=4, block_size=64)
    assert K.counts()["block_quant"] == 1
