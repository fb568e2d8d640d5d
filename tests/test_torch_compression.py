"""The compression suite, MoQ and the eigenvalue estimator in the port
against the JAX package, on the CPU.

Mirrors ``tests/unit/test_compression.py`` (its LoRA half is
``tests/test_torch_lora.py``). The same numpy-seeded weights go through
both packages, eager on both sides: ``fake_quantize`` (symmetric and not,
stacked leaves with their own scales) and its straight-through gradient,
the sparse, row and head masks, ``prune_weights``, ``sparsity``,
``reduce_layers``, the scheduler's gating and bit ramp, ``init_compression``
and ``redundancy_clean`` equal JAX's bit for bit; MoQ's ``bits_for`` and
``quantize`` too (per-layer bits from eigenvalues included). ``Eigenvalue``
converges to the same top eigenvalue as JAX's on quadratics whose
eigenvalues are known (1e-3 relative), and per layer of a stacked tree.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import compression as jc
from deepspeed_tpu.runtime.eigenvalue import Eigenvalue as JaxEigenvalue
from deepspeed_tpu.runtime.quantize import Quantizer as JaxQuantizer
from deepspeed_tpu_torch import compression as pc
from deepspeed_tpu_torch.compression.transforms import match_leaves
from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue, quantize_period_scale
from deepspeed_tpu_torch.runtime.quantize import Quantizer
from deepspeed_tpu_torch.utils.pytree import path_str, segments_match


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _w(seed, shape):
    """Normal values, each matrix of a stack at its own scale."""
    rng = np.random.default_rng(seed)
    scale = np.exp(rng.uniform(-2, 2, size=shape[:-2] + (1,) * min(len(shape), 2)))
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _eq(t, j, msg=""):
    np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j), err_msg=msg)


def _tree_eq(t, j, prefix=""):
    for k, v in t.items():
        if isinstance(v, dict):
            _tree_eq(v, j[k], prefix + k + "/")
        else:
            _eq(v, j[k], prefix + k)


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            {k: _both(v)[1] if isinstance(v, dict) else torch.from_numpy(v) for k, v in tree.items()})


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("shape", [(16, 32), (2, 16, 32), (16,)])
def test_fake_quantize_equals_jax(shape, bits, symmetric):
    w = _w(bits + len(shape), shape)
    _eq(pc.fake_quantize(torch.from_numpy(w), bits, symmetric),
        jc.fake_quantize(jnp.asarray(w), bits, symmetric))


def test_fake_quantize_bf16_and_precision_order():
    w = _w(0, (16, 32))
    wb = torch.from_numpy(w).bfloat16()
    jb = jnp.asarray(w).astype(jnp.bfloat16)
    got = pc.fake_quantize(wb, 4)
    assert got.dtype == torch.bfloat16
    _eq(got.float(), jc.fake_quantize(jb, 4).astype(jnp.float32))
    errs = [float((pc.fake_quantize(torch.from_numpy(w), b) - torch.from_numpy(w)).abs().mean())
            for b in (8, 4, 2)]
    assert errs[0] < errs[1] < errs[2]


def test_fake_quantize_straight_through_gradient_equals_jax():
    w = _w(1, (16, 32))
    g = np.random.default_rng(2).normal(size=(16, 32)).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(jc.fake_quantize(a, 4) * jnp.asarray(g)))(jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_(True)
    (pg,) = torch.autograd.grad((pc.fake_quantize(tw, 4) * torch.from_numpy(g)).sum(), tw)
    _eq(pg, jg)
    np.testing.assert_array_equal(pg.numpy(), g)  # the identity backward
    _eq(pc.quantize_activation(torch.from_numpy(w), 8), jc.quantize_activation(jnp.asarray(w), 8))


@pytest.mark.parametrize("ratio", [0.25, 0.5, 0.9])
@pytest.mark.parametrize("shape", [(32, 32), (2, 16, 32)])
def test_masks_equal_jax(shape, ratio):
    w = _w(int(ratio * 100), shape)
    t, j = torch.from_numpy(w), jnp.asarray(w)
    _eq(pc.sparse_mask(t, ratio), jc.sparse_mask(j, ratio))
    _eq(pc.row_mask(t, ratio), jc.row_mask(j, ratio))
    _eq(pc.head_mask(t, 4, ratio), jc.head_mask(j, 4, ratio))
    assert abs(float(pc.sparse_mask(t, ratio).mean()) - ratio) < 0.02


def test_structured_masks_keep_the_strong_rows_and_heads():
    w = torch.cat([torch.ones(8, 8), torch.full((8, 8), 1e-3)], dim=1)
    m = pc.head_mask(w, num_heads=4, dense_ratio=0.5)
    assert bool((m[:, :8] == 1).all()) and bool((m[:, 8:] == 0).all())
    m = pc.row_mask(w, dense_ratio=0.5)
    assert bool((m[:, :8] == 1).all()) and bool((m[:, 8:] == 0).all())
    with pytest.raises(ValueError, match="divisible"):
        pc.head_mask(w, num_heads=3, dense_ratio=0.5)


def _model_tree(seed=0):
    """A stacked-layer tree with norms, biases and an embedding beside the
    matmul weights."""
    return {
        "embed": _w(seed, (32, 16)),
        "layers": {"wq": _w(seed + 1, (2, 16, 16)), "wq_b": _w(seed + 2, (2, 16)),
                   "attn_norm": _w(seed + 3, (2, 16)), "w_up": _w(seed + 4, (2, 16, 32))},
        "final_norm": _w(seed + 5, (16,)),
        "lm_head": _w(seed + 6, (16, 32)),
    }


@pytest.mark.parametrize("method", ["sparse", "row", "head"])
def test_prune_quantize_and_sparsity_equal_jax(method):
    jt, tt = _both(_model_tree())
    for pats in (["*"], ["layers"], ["wq"], ["layers/w_up"]):
        _tree_eq(pc.prune_weights(tt, pats, 0.5, method=method, num_heads=4),
                 jc.prune_weights(jt, pats, 0.5, method=method, num_heads=4))
        _tree_eq(pc.quantize_weights(tt, pats, 4), jc.quantize_weights(jt, pats, 4))
        pruned_t = pc.prune_weights(tt, pats, 0.5, method=method, num_heads=4)
        pruned_j = jc.prune_weights(jt, pats, 0.5, method=method, num_heads=4)
        assert pc.sparsity(pruned_t, pats) == jc.sparsity(pruned_j, pats)
    with pytest.raises(ValueError, match="pruning method"):
        pc.prune_weights(tt, ["*"], 0.5, method="block")


def test_reduce_layers_equals_jax():
    jt, tt = _both(_model_tree())
    _tree_eq(pc.reduce_layers(tt, [1]), jc.reduce_layers(jt, [1]))
    out = pc.reduce_layers({"layers": {"w": torch.arange(8)[:, None] * torch.ones(8, 3)}},
                           [0, 3, 7])
    assert out["layers"]["w"][:, 0].tolist() == [0, 3, 7]


def test_path_matching_is_segment_precise():
    params = {f"layer_{i}": {"w": torch.zeros(4, 4)} for i in (1, 10, 11)}
    assert {p[0] for p, _ in match_leaves(params, ["layer_1"])} == {"layer_1"}
    assert path_str(("Layers", "WQ")) == "layers/wq"
    assert segments_match("layers/layer_1/w", "layer_1.w")
    assert not segments_match("layers/layer_10/w", "layer_1")


# ---------------------------------------------------------------------------
# scheduler and entry points
# ---------------------------------------------------------------------------
CONFIG = {
    "compression_training": {
        "weight_quantization": {
            "shared_parameters": {"enabled": True, "schedule_offset": 10, "quantize_period": 5},
            "different_groups": {
                "wq1": {"params": {"start_bits": 8, "target_bits": 4}, "modules": ["layer_0"]}
            },
        },
        "sparse_pruning": {
            "shared_parameters": {"enabled": True, "schedule_offset": 20},
            "different_groups": {"sp1": {"params": {"dense_ratio": 0.5}, "modules": ["layer_1"]}},
        },
        "row_pruning": {
            "shared_parameters": {"enabled": True, "schedule_offset": 30,
                                  "schedule_offset_end": 40},
            "different_groups": {"rp1": {"params": {"dense_ratio": 0.75}, "modules": ["layer_2"]}},
        },
        "head_pruning": {
            "shared_parameters": {"enabled": True, "schedule_offset": 5},
            "different_groups": {"hp1": {"params": {"dense_ratio": 0.5, "num_heads": 4},
                                         "modules": ["layer_2"]}},
        },
    }
}


def _layer_tree():
    return {f"layer_{i}": {"w": _w(10 + i, (32, 32))} for i in range(3)}


def test_schedule_and_bits_ramp_equal_jax():
    _, jsched, _ = jc.init_compression(*_both(_layer_tree())[:1], copy.deepcopy(CONFIG))
    _, psched, _ = pc.init_compression(_both(_layer_tree())[1], copy.deepcopy(CONFIG))
    for step in range(0, 60, 3):
        assert sorted(psched.active_techniques(step)) == sorted(jsched.active_techniques(step))
        for name, t in psched.techniques.items():
            assert t.bits_at(step) == jsched.techniques[name].bits_at(step)
    wq = psched.techniques["weight_quantization"]
    assert (wq.bits_at(10), wq.bits_at(16), wq.bits_at(100), wq.bits_at(None)) == (8, 4, 4, 4)


@pytest.mark.parametrize("step", [0, 7, 15, 25, 35, 45, None])
def test_compress_fn_equals_jax(step):
    jt, tt = _both(_layer_tree())
    _, _, jfn = jc.init_compression(jt, copy.deepcopy(CONFIG))
    _, _, pfn = pc.init_compression(tt, copy.deepcopy(CONFIG))
    _tree_eq(pfn(tt, step), jfn(jt, step))


def test_redundancy_clean_and_layer_reduction_equal_jax():
    jt, tt = _both(_layer_tree())
    _tree_eq(pc.redundancy_clean(tt, CONFIG), jc.redundancy_clean(jt, CONFIG))
    assert pc.sparsity(pc.redundancy_clean(tt, CONFIG), ["layer_1"]) == pytest.approx(0.5, abs=0.02)
    cfg = {"compression_training": {"layer_reduction": {"enabled": True, "teacher_layer": [1, 0]}}}
    jt, tt = _both(_model_tree())
    (pp, _, _), (jp, _, _) = pc.init_compression(tt, cfg), jc.init_compression(jt, cfg)
    _tree_eq(pp, jp)
    assert pp["layers"]["wq"].shape == (2, 16, 16) and torch.equal(pp["layers"]["wq"][1],
                                                                   tt["layers"]["wq"][0])
    with pytest.raises(ValueError, match="teacher_layer"):
        pc.init_compression(tt, {"compression_training": {"layer_reduction": {"enabled": True}}})


def test_head_pruning_without_heads_refuses():
    cfg = {"compression_training": {"head_pruning": {
        "shared_parameters": {"enabled": True, "schedule_offset": 0},
        "different_groups": {"g": {"params": {"dense_ratio": 0.5}}}}}}
    with pytest.raises(ValueError, match="num_heads"):
        pc.init_compression({"w": torch.zeros(4, 4)}, cfg)


def test_compressed_params_train_through_the_straight_through_estimator():
    """The compressed tree feeds a loss and autograd reaches the wide
    weights through the fake-quant (the masks zero the pruned entries)."""
    _, tt = _both(_layer_tree())
    tt = {k: {"w": v["w"].requires_grad_(True)} for k, v in tt.items()}
    _, _, fn = pc.init_compression(tt, CONFIG)
    loss = sum((v["w"] ** 2).sum() for v in fn(tt, 25).values())
    grads = torch.autograd.grad(loss, [v["w"] for v in tt.values()])
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert float((grads[1] == 0).float().mean()) == pytest.approx(0.5, abs=0.02)


# ---------------------------------------------------------------------------
# eigenvalue and MoQ
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("evals", [(5.0, 2.0, 1.0, 0.25), (3.0, -1.0, 0.5, 2.5)])
def test_eigenvalue_agrees_with_jax_on_a_known_quadratic(evals):
    """0.5 x^T A x with A = Q diag(evals) Q^T: the top eigenvalue (in
    magnitude) is known; the port and JAX converge to it, and to each
    other within 1e-3 relative (their start vectors differ)."""
    n = len(evals)
    q, _ = np.linalg.qr(np.random.default_rng(n).normal(size=(n, n)))
    a = (q * np.asarray(evals)) @ q.T
    top = max(abs(e) for e in evals)
    je = JaxEigenvalue(max_iter=200, tol=1e-7).compute_eigenvalue(
        lambda x: 0.5 * x @ jnp.asarray(a, jnp.float32) @ x, jnp.ones(n))
    at = torch.from_numpy(a.astype(np.float32))
    pe = Eigenvalue(max_iter=200, tol=1e-7).compute_eigenvalue(lambda x: 0.5 * x @ at @ x,
                                                                torch.ones(n))
    assert pe == pytest.approx(je, rel=1e-3)
    assert pe == pytest.approx(top, rel=1e-3)


def test_layer_eigenvalues_over_a_stacked_tree():
    """Per-layer curvature: layer i's loss term is c_i * |w_i|^2 / 2 over a
    dict of stacked leaves, so layer i's top eigenvalue is c_i."""
    coef = torch.tensor([4.0, 1.0, 2.5])
    params = {"a": torch.ones(3, 4), "b": {"c": torch.ones(3, 2, 2)}}

    def loss(p):
        sq = p["a"].square().sum(-1) + p["b"]["c"].square().sum((-1, -2))
        return 0.5 * (coef * sq).sum()

    eig = Eigenvalue(max_iter=50, tol=1e-6).compute_layer_eigenvalues(loss, params)
    assert list(eig) == [0, 1, 2]
    for i, c in enumerate(coef.tolist()):
        assert eig[i] == pytest.approx(c, rel=1e-4)
    assert quantize_period_scale(eig) == pytest.approx({0: 1.0, 1: 0.25, 2: 0.625}, rel=1e-4)


def test_eigenvalue_takes_no_kernel_function():
    """Forward-mode AD does not pass an autograd.Function (the qmatmul
    Function here, as the kernel wrappers): a loss that runs one raises."""
    from deepspeed_tpu_torch.ops.qmatmul import qmatmul

    w = torch.ones(4, 4)
    with pytest.raises(RuntimeError):
        Eigenvalue(max_iter=2).compute_eigenvalue(
            lambda x: qmatmul(x[None], w, "int8").square().sum(), torch.ones(4))


def test_moq_bits_equal_jax():
    for kw in (dict(q_start_bits=16, q_target_bits=4, q_period=10, q_offset=0),
               dict(q_start_bits=8, q_target_bits=2, q_period=3, q_offset=5),
               dict(q_start_bits=16, q_target_bits=4, q_period=10,
                    eigenvalues={0: 10.0, 1: 1.0, 2: 4.0})):
        j, p = JaxQuantizer(**kw), Quantizer(**kw)
        for step in range(0, 80, 3):
            for layer in (None, 0, 1, 2):
                assert p.bits_for(step, layer) == j.bits_for(step, layer)
    q = Quantizer(q_start_bits=16, q_target_bits=4, q_period=10, eigenvalues={0: 10.0, 1: 1.0})
    assert q.bits_for(22, layer=0) == 8 and q.bits_for(22, layer=1) == 4


@pytest.mark.parametrize("eigen", [False, True])
def test_moq_quantize_equals_jax(eigen):
    """Without eigenvalues the whole tree at the step's bits; with them each
    layer of a stacked leaf at its own bits. On that path JAX names a
    top-level leaf by its empty path, so ``embed`` is fake-quantized too:
    the port does the same (ROADMAP section 3)."""
    kw = dict(q_start_bits=16, q_target_bits=2, q_period=4)
    if eigen:
        kw["eigenvalues"] = {0: 10.0, 1: 1.0}
    jt, tt = _both(_model_tree(3))
    for step in (0, 5, 9, 40):
        got = Quantizer(**kw).quantize(tt, step)
        _tree_eq(got, JaxQuantizer(**kw).quantize(jt, step))
        assert list(got) == list(tt)
    got = Quantizer(**kw).quantize(tt, 9)
    assert torch.equal(got["final_norm"], tt["final_norm"])
    assert torch.equal(got["layers"]["attn_norm"], tt["layers"]["attn_norm"])
    assert torch.equal(got["embed"], tt["embed"]) != eigen
