"""Evoformer attention of the PyTorch port against the JAX package.

The same inputs, made from a seed with numpy, go through the port's
``DS4Sci_EvoformerAttention`` (on CPU tensors: the kernels' plain versions)
and the JAX package's, with its Pallas bodies in interpret mode as
``tests/unit/ops/test_evoformer.py`` runs them: outputs in fp32 within the
contract's 2e-4, the gradients of Q, K, V and both biases within its 5e-4,
bf16 within one bf16 unit at 1.0 (the JAX kernel keeps the softmax weights
in fp32, as the port's plain versions do). The plain forward and backward
are also held against torch autograd through the dense oracle, and the
kernels (``cuda`` marker) against the plain versions on a card. The bias
gradients take the reduced form (dq's partials folded by the merge, no
[B, h, s, s] plane) for broadcast biases and the plane form otherwise
(``bias_grad_plan``); both are held here.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.deepspeed4science import evoformer_attn as jevo
from deepspeed_tpu_torch.ops.deepspeed4science import evoformer_attn as pevo
from deepspeed_tpu_torch.ops.kernels import KERNELS


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FWD_TOL = 2e-4
GRAD_TOL = 5e-4
BF16_TOL = 1e-2
# the plain versions against autograd of the dense oracle, both fp32: the
# same products summed in another order
PLAIN_TOL = 2e-5
EVO_KERNELS = ("evoformer_fwd", "evoformer_bwd_dq", "evoformer_bwd_dkv")
ALL_EVO_KERNELS = EVO_KERNELS + ("evoformer_bias_grad_merge",)

# name: (leading dims, s, h, d, which biases: "1" padding mask, "2" pair bias)
CASES = {
    "no_bias": ((1, 4), 64, 2, 32, ""),
    "two_biases": ((1, 4), 64, 2, 32, "12"),
    "triangle_lead_2x3": ((2, 3), 64, 2, 32, "2"),
    "s40": ((1, 3), 40, 2, 32, "12"),
    "d16": ((1, 3), 64, 2, 16, "12"),
    "no_lead_dims": ((), 64, 2, 32, "2"),
}


def _inputs(lead, s, h, d, which, seed=0, dtype=np.float32):
    """Q, K, V [*lead, s, h, d]; bias1 [*lead, 1, 1, s] (per-row mask) and
    bias2 [lead[0] or 1, 1, h, s, s] (pair bias), as the contract draws them."""
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((*lead, s, h, d)).astype(dtype) for _ in range(3)]
    biases = []
    if "1" in which:
        biases.append((rng.standard_normal((*lead, 1, 1, s)) * 0.5).astype(np.float32))
    if "2" in which:
        pair = (h, s, s) if not lead else (lead[0],) + (1,) * (len(lead) - 1) + (h, s, s)
        biases.append((rng.standard_normal(pair) * 0.5).astype(np.float32))
    return qkv, biases


@functools.lru_cache(maxsize=None)
def _jax_out(name):
    (Q, K, V), biases = _inputs(*CASES[name])
    return np.asarray(jevo.DS4Sci_EvoformerAttention(
        jnp.asarray(Q), jnp.asarray(K), jnp.asarray(V), [jnp.asarray(b) for b in biases],
        interpret=True))


def _port(qkv, biases, grad=False):
    ts = [torch.tensor(x, requires_grad=grad) for x in list(qkv) + list(biases)]
    return pevo.DS4Sci_EvoformerAttention(ts[0], ts[1], ts[2], ts[3:]), ts


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax_fp32(name):
    qkv, biases = _inputs(*CASES[name])
    out, _ = _port(qkv, biases)
    assert out.shape == qkv[0].shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _jax_out(name), rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("name", ["two_biases", "s40"])
def test_grads_of_q_k_v_and_both_biases_match_jax(name):
    lead, s, h, d, which = CASES[name]
    lead = (1, 2) if name == "two_biases" else lead
    qkv, biases = _inputs(lead, s, h, d, which, seed=1)

    def loss(Q, K, V, b1, b2):
        return jnp.sum(jnp.square(jevo.DS4Sci_EvoformerAttention(Q, K, V, [b1, b2],
                                                                 interpret=True)))

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, qkv + biases))
    out, leaves = _port(qkv, biases, grad=True)
    out.square().sum().backward()
    for leaf, g, what in zip(leaves, want, ["dQ", "dK", "dV", "db1", "db2"]):
        assert leaf.grad.shape == leaf.shape
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=what)


def test_bf16_matches_jax_within_one_unit():
    qkv, biases = _inputs((1, 3), 64, 2, 32, "12", seed=2)
    qkv = [x.astype(jnp.bfloat16) for x in qkv]
    want = jevo.DS4Sci_EvoformerAttention(*map(jnp.asarray, qkv),
                                          [jnp.asarray(b) for b in biases], interpret=True)
    ts = [torch.tensor(np.asarray(x, np.float32)).bfloat16() for x in qkv]
    out = pevo.DS4Sci_EvoformerAttention(*ts, [torch.tensor(b) for b in biases])
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_fully_masked_row_gives_zero_as_the_jax_kernel_and_nan_in_the_oracles():
    """A row whose keys all carry a -inf bias: the JAX kernel and the port
    give 0 (and zero gradients in the port); the JAX oracle
    ``evoformer_reference`` and the port's copy of it give NaN (ROADMAP §3).
    With AlphaFold's -1e9 mask the kernel and the oracle agree."""
    qkv, (b1,) = _inputs((1, 3), 64, 2, 32, "1", seed=3)
    dead = b1.copy()
    dead[0, 1] = -np.inf
    jq = list(map(jnp.asarray, qkv))
    kern = np.asarray(jevo.DS4Sci_EvoformerAttention(*jq, [jnp.asarray(dead)], interpret=True))
    oracle = np.asarray(jevo.evoformer_reference(*jq, [jnp.asarray(dead)]))
    out, leaves = _port(qkv, [dead], grad=True)
    assert not kern[0, 1].any() and np.isnan(oracle[0, 1]).all()
    assert not out[0, 1].detach().any()
    np.testing.assert_allclose(out.detach().numpy(), kern, rtol=FWD_TOL, atol=FWD_TOL)
    port_oracle = pevo.evoformer_reference(*map(torch.tensor, qkv), [torch.tensor(dead)])
    assert torch.isnan(port_oracle[0, 1]).all()
    out.square().sum().backward()
    assert not leaves[0].grad[0, 1].any() and torch.isfinite(leaves[0].grad).all()
    assert not leaves[3].grad[0, 1].any()
    # AlphaFold's convention: 1e9 * (mask - 1)
    soft = b1.copy()
    soft[0, 1] = -1e9
    out, _ = _port(qkv, [soft])
    ref = pevo.evoformer_reference(*map(torch.tensor, qkv), [torch.tensor(soft)])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=FWD_TOL, atol=FWD_TOL)


# ---------------------------------------------------------------------------
# the plain versions against torch autograd through the dense oracle
# ---------------------------------------------------------------------------
def _flat(lead, s, h, d, which, seed, dtype=torch.float32):
    (Q, K, V), biases = _inputs(lead, s, h, d, which, seed)
    ts = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in (Q, K, V, *biases)]
    return ts[:3], ts[3:]


@pytest.mark.parametrize("name", ["two_biases", "triangle_lead_2x3", "s40", "no_lead_dims"])
def test_plain_versions_match_autograd_of_the_dense_oracle(name):
    lead, s, h, d, which = CASES[name]
    (Q, K, V), biases = _flat(lead, s, h, d, which, seed=4)
    ref = pevo.evoformer_reference(Q, K, V, biases)
    do = torch.randn(ref.shape, generator=torch.Generator().manual_seed(5), dtype=ref.dtype)
    grads = torch.autograd.grad(ref, [Q, K, V, *biases], do)
    B = int(np.prod(lead))
    q, k, v = (t.detach().reshape(B, s, h, d) for t in (Q, K, V))
    ops = pevo._operands([b.detach() for b in biases], lead, h, s)
    out, lse = pevo.evoformer_fwd_reference(q, k, v, ops)
    torch.testing.assert_close(out.reshape(ref.shape), ref.detach(), rtol=PLAIN_TOL,
                               atol=PLAIN_TOL)
    dq, dk, dv, ds, _ = pevo.evoformer_bwd_reference(q, k, v, out, do.reshape(B, s, h, d), lse,
                                                     ops)
    for got, want in zip((dq, dk, dv), grads[:3]):
        torch.testing.assert_close(got.reshape(want.shape), want, rtol=PLAIN_TOL,
                                   atol=PLAIN_TOL)
    for b, want in zip(biases, grads[3:]):
        torch.testing.assert_close(ds.view(*lead, h, s, s).sum_to_size(b.shape), want,
                                   rtol=PLAIN_TOL, atol=PLAIN_TOL)


def test_bias_operands_keep_broadcasts_as_strides():
    """At the slice's leading dims [1, n] neither bias is materialized (the
    mask has strides (s, 0, 0), the pair bias (0, s², s)); a pair bias
    [b, 1, h, s, s] under [b, n] with b > 1 is, as fp32 [B, h, s, s]; a
    third bias is summed into the second operand."""
    n, h, s = 5, 3, 24
    mask = torch.randn(1, n, 1, 1, s)
    pair = torch.randn(1, 1, h, s, s)
    o1, o2 = pevo._operands([mask, pair], (1, n), h, s)
    assert o1.shape == o2.shape == (n, h, s, s)
    assert o1.stride()[:3] == (s, 0, 0) and o1.data_ptr() == mask.data_ptr()
    assert o2.stride()[:3] == (0, s * s, s) and o2.data_ptr() == pair.data_ptr()
    pair2 = torch.randn(2, 1, h, s, s)
    mask2 = torch.randn(2, n, 1, 1, s)
    o1, o2 = pevo._operands([mask2, pair2], (2, n), h, s)
    assert o1.stride()[:3] == (s, 0, 0)
    assert o2.is_contiguous() and o2.shape == (2 * n, h, s, s)
    torch.testing.assert_close(o2.view(2, n, h, s, s), pair2.expand(2, n, h, s, s))
    bf = pair.bfloat16()
    ops = pevo._operands([mask, pair, bf], (1, n), h, s)
    assert len(ops) == 2 and ops[1].dtype == torch.float32 and ops[1].is_contiguous()
    torch.testing.assert_close(ops[1], (pair + bf.float()).expand(1, n, h, s, s)
                               .reshape(n, h, s, s))


def test_three_biases_and_bias_dtypes_get_their_own_gradients():
    """Any number of biases (JAX's loop takes any): each gets dS summed to
    its shape, in its dtype; a bias that needs no gradient gets none."""
    (Q, K, V), (b1, b2) = _flat((2, 3), 24, 2, 16, "12", seed=6, dtype=torch.float32)
    b3 = torch.randn(1, 1, 24, generator=torch.Generator().manual_seed(7)).bfloat16()
    b3.requires_grad_(True)
    out = pevo.DS4Sci_EvoformerAttention(Q, K, V, [b1, b2, b3])
    ref = pevo.evoformer_reference(Q, K, V, [b1, b2, b3])
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    got = torch.autograd.grad(out.square().sum(), [Q, K, V, b1, b2, b3])
    want = torch.autograd.grad(ref.square().sum(), [Q, K, V, b1, b2, b3])
    assert got[5].dtype == torch.bfloat16 and got[5].shape == b3.shape
    for g, w in zip(got[:5], want[:5]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[5].float(), want[5].float(), rtol=1e-2, atol=1e-2)


def test_no_dS_plane_without_a_bias_that_needs_a_gradient(monkeypatch):
    """No bias needing a gradient: neither the plane nor a reduced sum is
    asked for. The pair bias [1, 1, h, s, s] under [1, 2] that needs one is
    reduced over the batch, with no plane."""
    seen = []
    real = pevo.evoformer_bwd_reference

    def spy(*a, want_ds=True, sums=(), **kw):
        seen.append((want_ds, tuple(sums)))
        return real(*a, want_ds=want_ds, sums=sums, **kw)

    monkeypatch.setattr(pevo, "evoformer_bwd_reference", spy)
    (Q, K, V), (b1, b2) = _flat((1, 2), 16, 2, 16, "12", seed=8, dtype=torch.float32)
    pevo.DS4Sci_EvoformerAttention(Q, K, V, [b1.detach(), b2.detach()]).sum().backward()
    pevo.DS4Sci_EvoformerAttention(Q, K, V, [b1.detach(), b2]).sum().backward()
    assert seen == [(False, ()), (False, (None, (0,)))]
    assert b2.grad is not None and b1.grad is None


# ---------------------------------------------------------------------------
# the bias gradients' forms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lead", [(1, 5), (2, 3)])
def test_reduced_bias_grads_equal_the_plane_summed(lead):
    """The plain backward's reduced gradients (dS summed over each bias's
    broadcast dims, no plane) equal its plane summed with ``sum_to_size``,
    for AlphaFold's mask [*lead, 1, 1, s] and pair bias [1, 1, h, s, s], at
    fp32 tolerances (the same products summed in another order)."""
    s, h, d = 40, 3, 16
    (Q, K, V), (mask,) = _inputs(lead, s, h, d, "1", seed=11)
    pair = np.random.default_rng(12).standard_normal((1, 1, h, s, s)).astype(np.float32)
    B = int(np.prod(lead))
    q, k, v = (torch.tensor(x).reshape(B, s, h, d) for x in (Q, K, V))
    biases = [torch.tensor(mask), torch.tensor(pair)]
    ops = pevo._operands(biases, lead, h, s)
    plan = pevo.bias_grad_plan([b.shape for b in biases], ops, lead, h, s, (True, True))
    assert plan == pevo.BiasGradPlan("reduced", ((1, 2), (0,)), True, True)
    out, lse = pevo.evoformer_fwd_reference(q, k, v, ops)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(13))
    *_, ds, sums = pevo.evoformer_bwd_reference(q, k, v, out, do, lse, ops, sums=plan.dims)
    for b, got in zip(biases, sums):
        torch.testing.assert_close(got.reshape(b.shape),
                                   ds.view(*lead, h, s, s).sum_to_size(b.shape),
                                   rtol=PLAIN_TOL, atol=PLAIN_TOL)


def _plain_partials(ds, group):
    """The partials as the kernels write them, from the plane: dS summed over
    each group of batch rows (dq), and over all queries (dk/dv)."""
    B = ds.shape[0]
    rows = torch.stack([ds[b0:b0 + group].sum(0) for b0 in range(0, B, group)])
    return rows, ds.sum(2, keepdim=True)


def test_merge_of_the_partials_gives_the_reduced_gradients():
    """The merge's plain version over the partials the kernels write (row
    sums per group of batch rows, column sums over the queries), with each
    bias's ``merge_flags``, gives the reduced gradients, for biases broadcast
    over the batch, the heads, the queries and combinations of them."""
    gen = torch.Generator().manual_seed(14)
    ds = torch.randn(7, 3, 70, 70, generator=gen, dtype=torch.float64)
    rows, cols = _plain_partials(ds, group=3)
    assert rows.shape == (3, 3, 70, 70) and cols.shape == (7, 3, 1, 70)
    for dims in [(0,), (0, 1), (1, 2), (2,), (0, 2), (0, 1, 2)]:
        src = rows if 2 not in dims else cols
        got = pevo.evoformer_bias_grad_merge_reference(src, pevo.merge_flags(dims))
        torch.testing.assert_close(got, ds.sum(dim=list(dims), keepdim=True))


def test_bias_grad_plan_takes_the_plane_only_for_what_it_cannot_reduce(monkeypatch):
    """A spy on the plain backward: the mask and the pair bias broadcast over
    the batch take the reduced form (no plane); a materialized pair bias
    ([2, 1, h, s, s] under [2, n]), a third bias (folded into the second
    operand), a bias broadcast over heads only and a bias that is itself an
    expanded view take the plane form; every gradient still matches
    autograd through the dense oracle."""
    seen = []
    real = pevo.evoformer_bwd_reference

    def spy(*a, want_ds=True, sums=(), **kw):
        seen.append("plane" if want_ds else "reduced" if sums else "none")
        return real(*a, want_ds=want_ds, sums=sums, **kw)

    monkeypatch.setattr(pevo, "evoformer_bwd_reference", spy)
    s, h, d = 24, 2, 16
    rng = np.random.default_rng(15)

    def run(lead, shapes, expand=None):
        (Q, K, V), _ = _inputs(lead, s, h, d, "", seed=16)
        qkv = [torch.tensor(x, requires_grad=True) for x in (Q, K, V)]
        bs = [torch.tensor(rng.standard_normal(sh).astype(np.float32) * 0.5,
                           requires_grad=True) for sh in shapes]
        used = [b.expand(expand) if expand and i == 0 else b for i, b in enumerate(bs)]
        got = torch.autograd.grad(pevo.DS4Sci_EvoformerAttention(*qkv, used).square().sum(),
                                  bs)
        want = torch.autograd.grad(pevo.evoformer_reference(*qkv, used).square().sum(), bs)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        return seen.pop()

    assert run((1, 3), [(1, 3, 1, 1, s), (1, 1, h, s, s)]) == "reduced"
    assert run((2, 3), [(2, 3, 1, 1, s), (1, 1, h, s, s)]) == "reduced"
    assert run((2, 3), [(2, 3, 1, 1, s), (2, 1, h, s, s)]) == "plane"
    assert run((1, 3), [(1, 3, 1, 1, s), (1, 1, h, s, s), (1, 1, 1, s, s)]) == "plane"
    assert run((1, 3), [(1, 3, 1, s, s)]) == "plane"
    assert run((1, 3), [(1, 3, 1, 1, s)], expand=(1, 3, h, 1, s)) == "plane"
    assert not seen


# ---------------------------------------------------------------------------
# no fallback for device tensors; the kernels on the card
# ---------------------------------------------------------------------------
def test_wrappers_never_fall_back_for_device_tensors(monkeypatch):
    """The plain versions are poisoned; a meta tensor (standing in for a
    CUDA one) must reach the kernels' own checks, and what the kernels do
    not take (fp16, head_dim 96) is refused, never run on the plain
    version."""
    def poisoned(*a, **k):
        raise AssertionError("a plain version ran for a device tensor")

    for name in ("evoformer_fwd_reference", "evoformer_bwd_reference"):
        monkeypatch.setattr(pevo, name, poisoned)
    q = torch.zeros(2, 64, 4, 32, device="meta", dtype=torch.bfloat16)
    lse = torch.zeros(2, 4, 64, device="meta")
    for call in (lambda: pevo.DS4Sci_EvoformerAttention(q, q, q),
                 lambda: pevo.evoformer_fwd_cuda(q, q, q),
                 lambda: pevo.evoformer_bwd_dq_cuda(q, q, q, q, q, lse),
                 lambda: pevo.evoformer_bwd_dkv_cuda(q, q, q, q, lse, lse),
                 lambda: pevo.evoformer_bias_grad_merge_cuda([(lse[None], 1)]),
                 lambda: pevo.evoformer_fwd_cuda(q, q, q, [torch.zeros(2, 1, 1, 64)])):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(NotImplementedError, match="fp16.*queue 2, item 11"):
        pevo.evoformer_fwd_cuda(q.half(), q.half(), q.half())
    q96 = torch.zeros(2, 64, 4, 96, device="meta", dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="head_dim 96.*queue 2, item 13"):
        pevo.evoformer_fwd_cuda(q96, q96, q96)


def test_kernels_are_registered_with_their_pallas_bodies():
    """Each wrapper's kernel and the Pallas body it replaces (file:line of
    the JAX kernel function)."""
    root = Path(__file__).resolve().parents[1]
    for name, fn in zip(EVO_KERNELS, ("_fwd_kernel", "_bwd_dq_kernel", "_bwd_dkv_kernel")):
        path, line = KERNELS[name].replaces.rsplit(":", 1)
        assert path == "deepspeed_tpu/ops/deepspeed4science/evoformer_attn.py"
        src = (root / path).read_text().splitlines()
        assert src[int(line) - 1].startswith(f"def {fn}(")
        assert KERNELS[name].source in ("evoformer_fwd.cu", "evoformer_bwd.cu")


def test_merge_kernel_finishes_the_dq_kernels_bias_gradient():
    """The merge has no Pallas body of its own: it is the second pass of
    ``_bwd_dq_kernel``'s bias gradient (XLA sums that kernel's dS plane in the
    JAX package), built from the dq kernel's source."""
    merge, dq = KERNELS["evoformer_bias_grad_merge"], KERNELS["evoformer_bwd_dq"]
    assert merge.replaces == dq.replaces and merge.source == dq.source == "evoformer_bwd.cu"


CUDA_CASES = {
    # name: (leading dims, s, h, d, biases, dtype); "m": a -inf masked row
    "msa_bf16_d32": ((1, 8), 384, 8, 32, "12", torch.bfloat16),
    "msa_fp32_d32": ((1, 8), 384, 8, 32, "12", torch.float32),
    "triangle_bf16_s100": ((1, 6), 100, 4, 32, "12", torch.bfloat16),
    "fp32_s40_d16": ((2, 3), 40, 2, 16, "2", torch.float32),
    "bf16_d64_no_bias": ((1, 3), 128, 4, 64, "", torch.bfloat16),
    "fp32_d128_one_bias": ((1, 2), 96, 2, 128, "1", torch.float32),
    "bf16_d128_masked_row": ((1, 4), 130, 2, 128, "1m", torch.bfloat16),
    "fp32_d8_padded": ((1, 3), 72, 2, 8, "12", torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_kernels_match_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    lead, s, h, d, which, dtype = CUDA_CASES[case]
    (Q, K, V), biases = _inputs(lead, s, h, d, which.replace("m", ""), seed=s + d)
    if "m" in which:
        biases[0][0, 1] = -np.inf
    B = int(np.prod(lead))
    q, k, v = (torch.tensor(x).reshape(B, s, h, d).to("cuda", dtype) for x in (Q, K, V))
    ops = pevo._operands([torch.tensor(b, device="cuda") for b in biases], lead, h, s)
    do = torch.randn(q.shape, device="cuda").to(dtype)
    out, lse = pevo.evoformer_fwd_cuda(q, k, v, ops)
    ref, ref_lse = pevo.evoformer_fwd_reference(q, k, v, ops)
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=2e-5)
    dq, delta, ds, _ = pevo.evoformer_bwd_dq_cuda(q, k, v, out, do, lse, ops, want_ds=bool(ops))
    dk, dv, _ = pevo.evoformer_bwd_dkv_cuda(q, k, v, do, lse, delta, ops)
    rdq, rdk, rdv, rds, _ = pevo.evoformer_bwd_reference(q, k, v, out, do, lse, ops,
                                                         want_ds=bool(ops))
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv), (ds, rds)):
        if want is None:
            assert got is None
            continue
        scale = max(1.0, float(want.float().abs().max()))
        torch.testing.assert_close(got.float(), want.float(), atol=tol * scale, rtol=tol)
    if "m" in which:
        assert not out[1].float().abs().max() and bool((lse[1] == -1e30).all())
        assert not dq[1].float().abs().max() and not ds[1].abs().max()


@pytest.mark.cuda
def test_evoformer_op_on_the_card(monkeypatch):
    """Through the registry on a card: the evoformer sources build, and a
    call whose biases both need gradients launches each evoformer kernel
    once per forward and backward (the merge of the bias gradients
    included), and no other kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.accelerator import real_accelerator
    from deepspeed_tpu_torch.ops import kernels as K

    monkeypatch.setattr(real_accelerator, "_accelerator", None)
    monkeypatch.delenv("DS_ACCELERATOR", raising=False)
    evo = deepspeed_tpu_torch.get_accelerator().create_op_builder("evoformer_attn").load()
    (Q, K_, V), (b1, b2) = _inputs((1, 16), 96, 4, 32, "12", seed=9)
    ts = [torch.tensor(x, device="cuda").bfloat16().requires_grad_(True) for x in (Q, K_, V)]
    bs = [torch.tensor(b, device="cuda").requires_grad_(True) for b in (b1, b2)]
    K.reset_counts()
    evo(*ts, bs).float().square().sum().backward()
    torch.cuda.synchronize()
    assert K.counts() == {n: int(n in ALL_EVO_KERNELS) for n in K.KERNELS}
    assert bs[0].grad.shape == bs[0].shape and bs[1].grad.shape == bs[1].shape


def _cuda_case(lead, s, h, d, which, dtype, seed):
    (Q, K, V), biases = _inputs(lead, s, h, d, which, seed=seed)
    B = int(np.prod(lead))
    q, k, v = (torch.tensor(x).reshape(B, s, h, d).to("cuda", dtype) for x in (Q, K, V))
    bs = [torch.tensor(b, device="cuda") for b in biases]
    ops = pevo._operands(bs, lead, h, s)
    plan = pevo.bias_grad_plan([b.shape for b in bs], ops, lead, h, s, [True] * len(bs))
    do = torch.randn(q.shape, device="cuda").to(dtype)
    out, lse = pevo.evoformer_fwd_cuda(q, k, v, ops)
    return q, k, v, do, out, lse, ops, plan


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_cuda_reduced_bias_grads_match_plain_and_repeat(d, dtype):
    """The reduced form on the card (dq's partials, then the merge) against
    the plain backward's sums at every head dim, mask and pair bias at s
    100; dq, dk, dv and both bias gradients the same bits in two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    q, k, v, do, out, lse, ops, plan = _cuda_case((1, 6), 100, 2, d, "12", dtype, seed=d)
    assert plan.form == "reduced"
    first = pevo.evoformer_bwd_cuda(q, k, v, out, do, lse, ops, None, plan)
    again = pevo.evoformer_bwd_cuda(q, k, v, out, do, lse, ops, None, plan)
    torch.cuda.synchronize()
    rdq, rdk, rdv, _, rsums = pevo.evoformer_bwd_reference(q, k, v, out, do, lse, ops,
                                                           want_ds=False, sums=plan.dims)
    for a, b in zip(first[:3] + tuple(first[4]), again[:3] + tuple(again[4])):
        assert torch.equal(a, b)
    assert first[3] is None
    for got, want in zip(first[4], rsums):
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, atol=2e-5 * scale, rtol=1e-4)
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 2e-5
    for got, want in zip(first[:3], (rdq, rdk, rdv)):
        scale = max(1.0, float(want.float().abs().max()))
        torch.testing.assert_close(got.float(), want.float(), atol=tol * scale, rtol=tol)


@pytest.mark.cuda
def test_cuda_reduced_form_allocates_no_plane():
    """Broadcast biases on the card: the call's peak memory above its inputs
    stays below the [B, h, s, s] fp32 plane the plane form would allocate."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    lead, s, h, d = (1, 64), 256, 4, 32
    (Q, K, V), (b1, b2) = _inputs(lead, s, h, d, "12", seed=17)
    ts = [torch.tensor(x, device="cuda").bfloat16().requires_grad_(True) for x in (Q, K, V)]
    bs = [torch.tensor(b, device="cuda").requires_grad_(True) for b in (b1, b2)]
    do = torch.randn(ts[0].shape, device="cuda").bfloat16()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pevo.DS4Sci_EvoformerAttention(*ts, bs).backward(do)
    torch.cuda.synchronize()
    plane = int(np.prod(lead)) * h * s * s * 4
    assert torch.cuda.max_memory_allocated() - base < plane


@pytest.mark.cuda
@pytest.mark.parametrize("n", [7, 9])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_cuda_unpaired_last_row_matches_plain(n, dtype):
    """An odd count of batch rows in a CTA's group leaves its last row
    without a pair partner (B 7: one group of 7; B 9: groups of 8 and 1).
    Both bias-gradient forms match the plain backward there, and give the
    same dq, dk and dv bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    q, k, v, do, out, lse, ops, plan = _cuda_case((1, n), 130, 2, 32, "12", dtype, seed=18)
    assert plan.form == "reduced" and pevo.rows_per_cta(n, 2, 130) == min(n, 8)
    plane = pevo.evoformer_bwd_cuda(q, k, v, out, do, lse, ops, None,
                                    pevo.BiasGradPlan("plane", (None, None)))
    reduced = pevo.evoformer_bwd_cuda(q, k, v, out, do, lse, ops, None, plan)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(plane[:3], reduced[:3]))
    rdq, rdk, rdv, rds, rsums = pevo.evoformer_bwd_reference(q, k, v, out, do, lse, ops,
                                                             sums=plan.dims)
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 2e-5
    for got, want in zip(plane[:3], (rdq, rdk, rdv)):
        scale = max(1.0, float(want.float().abs().max()))
        torch.testing.assert_close(got.float(), want.float(), atol=tol * scale, rtol=tol)
    for got, want in [(plane[3], rds)] + list(zip(reduced[4], rsums)):
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, atol=2e-5 * scale, rtol=1e-4)


@pytest.mark.parametrize("B,h,s,want", [
    (512, 8, 384, 16),   # msa_row: 32 groups x 8 heads x 6 query tiles = 1536 CTAs
    (384, 4, 384, 8),    # triangle: 48 x 4 x 6 = 1152 CTAs
    (5, 8, 384, 5),      # an odd batch below 8: one group walks every row
    (999, 8, 384, 31),   # an odd batch: 33 groups, the last of 7 rows
])
def test_forward_and_backward_walk_the_same_row_groups(B, h, s, want):
    """The forward kernel's CTAs walk groups of ``rows_per_cta`` batch rows
    (as the backward's): the batch-invariant pair bias is read once a group.
    The groups cover every batch row exactly once, and the last may be
    short."""
    G = pevo.rows_per_cta(B, h, s)
    assert G == want
    groups = [list(range(b0, min(B, b0 + G))) for b0 in range(0, B, G)]
    assert sorted(r for g in groups for r in g) == list(range(B))
    assert len(groups) == -(-B // G) and 0 < len(groups[-1]) <= G


# d, dtype, s (130: the pair bias's query stride is no multiple of 4, so
# the bias regions copy 4 bytes at a time; 192: 16-byte copies)
FWD_CUDA_CASES = [(d, dt, s) for d in (16, 32, 64, 128)
                  for dt in (torch.bfloat16, torch.float32) for s in (130, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype,s", FWD_CUDA_CASES)
def test_cuda_forward_matches_plain_by_head_dim(d, dtype, s):
    """The forward kernel against its plain version at every head dim, both
    dtypes and both bias copy widths, over an odd batch (warpgroups with
    unequal rows): a per-row mask and a pair bias shared by the batch (the
    slab staged once a CTA), then the pair bias materialized per row (a
    tile per step)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 2e-5
    for lead, mat in (((1, 21), False), ((3, 5), True)):
        (Q, K, V), biases = _inputs(lead, s, 2, d, "12", seed=s + d)
        if mat:
            biases[1] = np.broadcast_to(biases[1], (*lead, 2, s, s)).copy()
        B = int(np.prod(lead))
        q, k, v = (torch.tensor(x).reshape(B, s, 2, d).to("cuda", dtype) for x in (Q, K, V))
        ops = pevo._operands([torch.tensor(b, device="cuda") for b in biases], lead, 2, s)
        assert (ops[1].stride(0) != 0) == mat
        out, lse = pevo.evoformer_fwd_cuda(q, k, v, ops)
        ref, ref_lse = pevo.evoformer_fwd_reference(q, k, v, ops)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=2e-5)
