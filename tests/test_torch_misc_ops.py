"""The port's plain ops (``ops/spatial``, ``ops/random_ltd``) against the JAX package.

Both modules are plain XLA in the JAX package and plain torch in the port.
The same inputs, made from a seed with numpy, go through both: the spatial
ops agree to fp32 rounding (GroupNorm sums in another order) and raise the
same error on a bad group count; ``token_gather``/``token_scatter`` agree
exactly on the same indices. The sampling draws differ by design (the port
takes a ``torch.Generator`` and does not reimplement threefry), so the two
are held to the same properties: shape, dtype, sorted, unique, in range,
``kept`` per row, a mask that marks exactly the indices; and the port to
determinism per seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import random_ltd as jltd
from deepspeed_tpu.ops import spatial as jsp
from deepspeed_tpu_torch.ops import random_ltd as pltd
from deepspeed_tpu_torch.ops import spatial as psp


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FP32_TOL = 2e-6
GN_TOL = 2e-5  # fp32 means and variances summed in another order


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# spatial
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_adds_match_jax(dtype):
    rng = _rng(0)
    act, other = (rng.standard_normal((2, 5, 6, 16)).astype(np.float32) for _ in range(2))
    bias = rng.standard_normal(16).astype(np.float32)
    tdt = getattr(torch, dtype)
    ta, to = torch.tensor(act).to(tdt), torch.tensor(other).to(tdt)
    ja, jo = (jnp.asarray(x).astype(getattr(jnp, dtype)) for x in (act, other))
    got = psp.nhwc_bias_add(ta, torch.tensor(bias))
    want = jsp.nhwc_bias_add(ja, jnp.asarray(bias))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=FP32_TOL,
                               atol=FP32_TOL)
    got = psp.bias_add_add(ta, to, torch.tensor(bias))
    want = jsp.bias_add_add(ja, jo, jnp.asarray(bias))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=FP32_TOL,
                               atol=FP32_TOL)


@pytest.mark.parametrize("shape,groups", [((2, 4, 4, 32), 8), ((1, 3, 5, 12), 3),
                                          ((2, 2, 2, 8), 1)])
def test_nhwc_group_norm_matches_jax(shape, groups):
    rng = _rng(1)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    gamma, beta = (rng.standard_normal(shape[-1]).astype(np.float32) for _ in range(2))
    got = psp.nhwc_group_norm(torch.tensor(x), torch.tensor(gamma), torch.tensor(beta), groups)
    want = jsp.nhwc_group_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GN_TOL, atol=GN_TOL)


def test_nhwc_group_norm_returns_x_dtype_and_refuses_a_bad_group_count():
    rng = _rng(2)
    x = rng.standard_normal((1, 2, 2, 8)).astype(np.float32)
    g, b = np.ones(8, np.float32), np.zeros(8, np.float32)
    got = psp.nhwc_group_norm(torch.tensor(x).bfloat16(), torch.tensor(g), torch.tensor(b), 2)
    want = jsp.nhwc_group_norm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(g),
                               jnp.asarray(b), 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)
    with pytest.raises(ValueError, match="not divisible by num_groups 3") as port:
        psp.nhwc_group_norm(torch.tensor(x), torch.tensor(g), torch.tensor(b), 3)
    with pytest.raises(ValueError) as ref:
        jsp.nhwc_group_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 3)
    assert str(port.value) == str(ref.value)


# ---------------------------------------------------------------------------
# random_ltd
# ---------------------------------------------------------------------------
def _check_sample(idx, mask, seq_len, kept, batch):
    idx, mask = np.asarray(idx), np.asarray(mask)
    assert idx.shape == (batch, kept) and idx.dtype == np.int32
    assert mask.shape == (batch, seq_len) and mask.dtype == np.bool_
    assert (np.diff(idx, axis=1) > 0).all()  # sorted and unique
    assert idx.min() >= 0 and idx.max() < seq_len
    assert (mask.sum(axis=1) == kept).all()
    assert all(mask[r, idx[r]].all() for r in range(batch))


@pytest.mark.parametrize("fn", ["gpt_sample_tokens", "bert_sample_tokens"])
@pytest.mark.parametrize("seq_len,kept,batch", [(16, 5, 3), (32, 32, 2), (9, 1, 4)])
def test_sampling_has_the_jax_properties(fn, seq_len, kept, batch):
    jidx, jmask = getattr(jltd, fn)(jax.random.key(0), seq_len, kept, batch)
    _check_sample(jidx, jmask, seq_len, kept, batch)
    pidx, pmask = getattr(pltd, fn)(torch.Generator().manual_seed(0), seq_len, kept, batch)
    assert pidx.dtype == torch.int32 and pmask.dtype == torch.bool
    _check_sample(pidx.numpy(), pmask.numpy(), seq_len, kept, batch)


def test_sampling_is_deterministic_per_seed():
    a = pltd.gpt_sample_tokens(torch.Generator().manual_seed(7), 64, 20, 4)
    b = pltd.gpt_sample_tokens(torch.Generator().manual_seed(7), 64, 20, 4)
    c = pltd.gpt_sample_tokens(torch.Generator().manual_seed(8), 64, 20, 4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    rows = {tuple(r) for r in a[0].tolist()}
    assert len(rows) > 1  # each row draws its own tokens


@pytest.mark.parametrize("tail", [(), (6,), (2, 3)])
def test_token_gather_and_scatter_equal_jax_exactly(tail):
    rng = _rng(3)
    b, s, k = 3, 12, 5
    x = rng.standard_normal((b, s, *tail)).astype(np.float32)
    idx = np.sort(np.stack([rng.permutation(s)[:k] for _ in range(b)]), axis=1).astype(np.int32)
    got = pltd.token_gather(torch.tensor(x), torch.tensor(idx))
    want = jltd.token_gather(jnp.asarray(x), jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vals = rng.standard_normal((b, k, *tail)).astype(np.float32)
    full = torch.tensor(x)
    got = pltd.token_scatter(full, torch.tensor(vals), torch.tensor(idx))
    want = jltd.token_scatter(jnp.asarray(x), jnp.asarray(vals), jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(full, torch.tensor(x))  # a new tensor, as the JAX function returns
    # scatter of the gathered tokens is the identity
    back = pltd.token_scatter(full, pltd.token_gather(full, torch.tensor(idx)), torch.tensor(idx))
    assert torch.equal(back, full)


def test_ops_come_from_the_registry():
    """``create_op_builder(name).load()`` hands out these modules (plain
    OpBuilders: nothing to build)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.accelerator import real_accelerator
    from deepspeed_tpu_torch.ops.op_builder import CUDAOpBuilder, OpBuilder

    saved = real_accelerator._accelerator
    try:
        real_accelerator._accelerator = None
        accel = deepspeed_tpu_torch.get_accelerator()
        for name, mod in (("spatial_inference", psp), ("random_ltd", pltd)):
            builder = accel.create_op_builder(name)
            assert isinstance(builder, OpBuilder) and not isinstance(builder, CUDAOpBuilder)
            assert builder.is_compatible() and builder.load(verbose=False) is mod
    finally:
        real_accelerator._accelerator = saved
