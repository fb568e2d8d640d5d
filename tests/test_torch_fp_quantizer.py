"""The FP quantizer in the port against the JAX package, on the CPU.

Mirrors the FP quantizer cases of ``tests/unit/ops/test_misc_ops.py``: the
same numpy-seeded values through ``fp_quantize`` (fp6 e3m2, fp8 e4m3, fp12
e4m7), ``fp_pack`` and ``fp_unpack`` of both packages, eager on both sides:
the format-rounded values, the scales and every packed byte equal JAX's
bit for bit, powers of two, subnormals, zeros and saturating values
included, but where XLA's inexact exp2 moves fp12's lowest band (pinned
below). ``fp8_cast`` equals JAX's on torch's ``float8_e4m3fn``; an
unscaled out-of-range cast is where the two dtypes part (torch saturates,
JAX gives NaN), which ``fp8_cast`` never feeds.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.quantizer import block_quant as jbq
from deepspeed_tpu_torch.ops.quantizer import block_quant as pbq


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(seed, n=4096):
    """Normal values at spread scales, plus the edge cases: zeros, powers
    of two, values next to them, tiny values that flush or go subnormal."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) * np.exp(rng.uniform(-6, 6, size=n))
    edge = np.concatenate([[0.0, -0.0], 2.0 ** np.arange(-20, 9), -(2.0 ** np.arange(-20, 9)),
                           np.nextafter(2.0 ** np.arange(-6, 6), 0),
                           np.nextafter(2.0 ** np.arange(-6, 6), 10), [1e-30, -1e-30, 3e-8]])
    x[: edge.size] = edge
    return x.astype(np.float32)


def _codes12(packed):
    """fp12 codes from packed bytes (two codes in three bytes)."""
    t = np.asarray(packed).astype(np.int64).reshape(-1, 3)
    return np.stack([t[:, 0] | ((t[:, 1] & 0xF) << 8), (t[:, 1] >> 4) | (t[:, 2] << 4)],
                    -1).ravel()


@pytest.mark.parametrize("q_bits,group", [(6, 128), (8, 96), (12, 128), (12, 96)])
def test_codes_scales_and_bytes_equal_jax(q_bits, group):
    """fp6 and fp8: values, scales, packed bytes and unpacked values equal
    JAX's bit for bit. fp12, pinned (ROADMAP section 3): XLA's CPU exp2 is
    inexact at integers outside [-12, 12], and fp12's lowest band (scaled
    values below 2^-5) steps by exp2(-13), which XLA gives as 2^-13 (1 -
    4.8e-7). There a JAX value is its grid index k_j = round(x / step) over
    that step, times the step; the port's index k_p is over 2^-13. k_j
    exceeds k_p by one where x sits within the error of a half step, and
    is k_p elsewhere. JAX's code is k_j, but a value with k_j 128 or 256
    lies just below 2^-6 or 2^-5 and packs one code low (0.8% / 0.4% below
    its value). Every value and code outside the band equals the port's."""
    x = _values(q_bits + group)
    jq, js, jshape = jbq.fp_quantize(jnp.asarray(x), q_bits=q_bits, group_size=group)
    pq, ps, pshape = pbq.fp_quantize(torch.from_numpy(x), q_bits=q_bits, group_size=group)
    assert tuple(jshape) == pshape
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    jq, jp = np.asarray(jq), np.asarray(jbq.fp_pack(jq, q_bits))
    pp = pbq.fp_pack(pq, q_bits)
    assert pp.dtype == torch.uint8
    if q_bits != 12:
        np.testing.assert_array_equal(pq.numpy(), jq)
        np.testing.assert_array_equal(pp.numpy(), jp)
        n = pq.numel()
        np.testing.assert_array_equal(pbq.fp_unpack(pp, n, q_bits).numpy(),
                                      np.asarray(jbq.fp_unpack(jnp.asarray(jp), n, q_bits)))
        np.testing.assert_array_equal(
            pbq.fp_dequantize(pq, ps, pshape).numpy(),
            np.asarray(jbq.fp_dequantize(jnp.asarray(jq), js, jshape)))
        return
    step_j = np.asarray(jnp.exp2(jnp.float32(-13.0)))
    assert step_j != np.float32(2.0 ** -13)  # the pinned case is still there
    scaled = pbq._pad_to(torch.from_numpy(x), group)[0].reshape(-1, group) / ps
    band = (scaled.abs() < 2.0 ** -5).numpy()
    k_p = np.abs(pq.numpy().astype(np.float64)) / 2.0 ** -13
    k_j = np.rint(np.abs(jq.astype(np.float64)) / np.float64(step_j))
    np.testing.assert_array_equal(jq[~band], pq.numpy()[~band])
    np.testing.assert_array_equal(np.abs(jq[band]), (k_j[band] * step_j).astype(np.float32))
    moved = k_j[band] - k_p[band]
    assert set(np.unique(moved)) <= {0.0, 1.0} and moved.sum() <= 8
    low = band & np.isin(k_j, [128, 256])
    assert low.any()  # the seeded values reach the codes JAX packs low
    want = _codes12(pp.numpy()) + np.where(band, k_j - k_p, 0).ravel().astype(np.int64)
    want -= low.ravel()
    np.testing.assert_array_equal(_codes12(jp), want)


@pytest.mark.parametrize("q_bits", [6, 8, 12])
def test_pack_of_any_grid_value_equals_jax(q_bits):
    """Every value of the format's grid (and its negative), packed: each
    code equals JAX's and unpacks to the value."""
    exp_bits, man_bits = pbq._FP_FORMATS[q_bits]
    bias = (1 << (exp_bits - 1)) - 1
    man = np.arange(1 << man_bits)
    sub = man * 2.0 ** (1 - bias - man_bits)
    normal = ((1 + man[None] / 2 ** man_bits) * 2.0 ** np.arange(1 - bias, bias + 1)[:, None])
    grid = np.concatenate([sub, normal.ravel()])
    grid = np.concatenate([grid, -grid[1:]]).astype(np.float32)
    pp = pbq.fp_pack(torch.from_numpy(grid), q_bits)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jbq.fp_pack(jnp.asarray(grid), q_bits)))
    np.testing.assert_array_equal(pbq.fp_unpack(pp, grid.size, q_bits).numpy(), grid)


@pytest.mark.parametrize("q_bits,rtol", [(6, 0.15), (8, 0.08), (12, 0.005)])
def test_quantize_error_bound(q_bits, rtol):
    x = torch.from_numpy(np.random.default_rng(0).normal(size=1024).astype(np.float32))
    q, scale, shape = pbq.fp_quantize(x, q_bits=q_bits, group_size=128)
    err = (pbq.fp_dequantize(q, scale, shape) - x).abs()
    assert float((err / (x.abs() + 1e-3)).median()) < rtol


def test_fp6_memory_footprint():
    """fp6 packs 4 values into 3 bytes, fp12 2 into 3."""
    q, _, _ = pbq.fp_quantize(torch.ones(1024), q_bits=6)
    packed = pbq.fp_pack(q, 6)
    assert packed.dtype == torch.uint8 and packed.numel() == 1024 // 4 * 3
    q, _, _ = pbq.fp_quantize(torch.ones(1024), q_bits=12)
    assert pbq.fp_pack(q, 12).numel() == 1024 // 2 * 3


def test_unknown_format_raises():
    with pytest.raises(ValueError, match="q_bits"):
        pbq.fp_quantize(torch.ones(8), q_bits=4)


def test_fp8_cast_equals_jax():
    x = _values(7).reshape(64, 64)
    pv, ps = pbq.fp8_cast(torch.from_numpy(x))
    jv, js = jbq.fp8_cast(jnp.asarray(x))
    assert pv.dtype == torch.float8_e4m3fn
    assert float(ps) == float(js)
    np.testing.assert_array_equal(pv.view(torch.uint8).numpy(), np.asarray(jv).view(np.uint8))
    np.testing.assert_array_equal(pbq.fp8_uncast(pv, ps).numpy(),
                                  np.asarray(jbq.fp8_uncast(jv, js)))
    zv, zs = pbq.fp8_cast(torch.zeros(4, 4))
    assert float(zs) == 1.0 and not zv.float().any()


def test_unscaled_fp8_casts_part_out_of_range_only():
    """Pinned: inside e4m3's range torch's and JAX's casts agree bit for
    bit; past 448 torch saturates where JAX gives NaN. ``fp8_cast`` scales
    into the range first, so it never feeds such a value."""
    inside = np.random.default_rng(8).uniform(-448, 448, size=100_000).astype(np.float32)
    p = torch.from_numpy(inside).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    j = np.asarray(jnp.asarray(inside).astype(jnp.float8_e4m3fn)).view(np.uint8)
    np.testing.assert_array_equal(p, j)
    out = np.array([500.0, 1000.0, -600.0], np.float32)
    assert torch.from_numpy(out).to(torch.float8_e4m3fn).float().tolist() == [448, 448, -448]
    assert np.isnan(np.asarray(jnp.asarray(out).astype(jnp.float8_e4m3fn), np.float32)).all()


def test_the_registry_hands_out_the_fp_quantizer(monkeypatch):
    monkeypatch.setenv("DS_ACCELERATOR", "cpu")
    from deepspeed_tpu_torch.accelerator import real_accelerator

    monkeypatch.setattr(real_accelerator, "_accelerator", None)
    op = real_accelerator.get_accelerator().create_op_builder("fp_quantizer").load()
    assert op is importlib.import_module("deepspeed_tpu_torch.ops.quantizer.block_quant")
    for name in ("fp8_cast", "fp8_uncast", "fp_quantize", "fp_dequantize", "fp_pack", "fp_unpack"):
        assert callable(getattr(op, name))
    from deepspeed_tpu_torch.ops import quantizer

    assert quantizer.fp_quantize is pbq.fp_quantize
