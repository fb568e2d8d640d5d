"""The port's FusedAdam and optimizers against the JAX package's.

The same numpy arrays go through ``deepspeed_tpu.ops.adam.fused_adam_step``
(its Pallas kernel in interpret mode, as ``tests/unit/ops/test_kernels.py``
runs it on the CPU) and the port's ``fused_adam_step`` (on CPU tensors: the
plain ``_adam_math``, which the CUDA kernel repeats operation by operation),
over several steps, both decay modes, with and without bias correction, and
on a leaf with a ragged tail. Then the ``FusedAdam`` tree walk against
``fused_adam_transform``, ``opt_state_from_numpy``, and 4-step engine
trajectories of every ported optimizer type against the JAX engine.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops.adam import fused_adam as jfa
from deepspeed_tpu.ops.muon import newton_schulz_orthogonalize as j_newton_schulz
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.models.convert import opt_state_from_numpy, params_from_numpy
from deepspeed_tpu_torch.ops.adam import fused_adam as pfa
from deepspeed_tpu_torch.ops.muon import newton_schulz_orthogonalize as p_newton_schulz
from deepspeed_tpu_torch.runtime.optimizers import _leaves


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# fp32 elementwise chains: XLA contracts multiply-adds and computes b^t with
# its own pow; a few units in the last place per step
RTOL = 2e-6
ATOL = 2e-7

MODES = {
    "adamw": dict(weight_decay=0.01, adam_w_mode=True, bias_correction=True),
    "l2": dict(weight_decay=0.01, adam_w_mode=False, bias_correction=True),
    "no_bias_correction": dict(weight_decay=0.01, adam_w_mode=True, bias_correction=False),
    "no_decay": dict(weight_decay=0.0, adam_w_mode=True, bias_correction=True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("numel", [4096, 3001])  # 3001: a ragged tail
def test_steps_match_jax_kernel(mode, numel):
    rng = np.random.default_rng(numel)
    p = rng.standard_normal(numel).astype(np.float32)
    m = np.zeros(numel, np.float32)
    v = np.zeros(numel, np.float32)
    kw = dict(lr=1e-2, **MODES[mode])
    jhp, php = jfa.AdamParams(**kw), pfa.AdamParams(**kw)
    jp, jm, jv = jnp.asarray(p), jnp.asarray(m), jnp.asarray(v)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    for step in range(1, 5):
        g = rng.standard_normal(numel).astype(np.float32)
        lr = 1e-2 / step
        jp, jm, jv = jfa.fused_adam_step(jp, jnp.asarray(g), jm, jv, step, jhp, lr=lr,
                                         block=256, interpret=True)
        out = pfa.fused_adam_step(tp, torch.from_numpy(g), tm, tv, step, php, lr=lr)
        assert out[0] is tp and out[1] is tm and out[2] is tv  # in place
        for got, want in ((tp, jp), (tm, jm), (tv, jv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_step_writes_the_half_precision_param():
    rng = np.random.default_rng(0)
    p, g = (torch.from_numpy(rng.standard_normal(300).astype(np.float32)) for _ in range(2))
    m, v = torch.zeros(300), torch.zeros(300)
    low = torch.zeros(300, dtype=torch.bfloat16)
    pfa.fused_adam_step(p, g, m, v, 1, pfa.AdamParams(), param_out=low)
    assert torch.equal(low, p.to(torch.bfloat16))


def test_cuda_wrapper_raises_off_the_card_and_a_mesh_waits():
    t = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA device"):
        pfa.fused_adam_cuda(t, t, t, t, 1, pfa.AdamParams(), 1e-3)
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        pfa.FusedAdam(mesh=object())


def _tree(rng):
    # one leaf above the kernel threshold, one below, one nested
    return {"big": rng.standard_normal((1 << 16) + 5).astype(np.float32),
            "nest": {"small": rng.standard_normal((7, 9)).astype(np.float32)}}


def test_fused_adam_tree_matches_jax_transform():
    """The tree walk against ``fused_adam_transform`` (its jnp path: off the
    TPU the JAX transform takes ``_adam_math`` for every leaf). The JAX
    engine forms ``master + (p_new - master)``, the port writes ``p_new``:
    at most one fp32 ulp apart, inside RTOL."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    kw = dict(lr=1e-3, weight_decay=0.01)
    tx = jfa.fused_adam_transform(jfa.AdamParams(**kw), use_pallas=False)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jparams)
    fused = pfa.FusedAdam(**kw)
    master = params_from_numpy(params)
    low = jax.tree.map(lambda t: t.to(torch.bfloat16), master)
    state = fused.init(master)
    for step in range(1, 4):
        grads = _tree(rng)
        upd, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams, lr=1e-3)
        jparams = optax.apply_updates(jparams, upd)
        state = fused.step(params_from_numpy(grads), state, master, 1e-3, params=low)
        assert state["count"] == step == int(jstate.count)
    jl = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    jm = dict(_leaves(jax.tree.map(np.asarray, jstate.m)))
    for name, t in _leaves(master):
        np.testing.assert_allclose(t.numpy(), jl[name], rtol=RTOL, atol=ATOL, err_msg=name)
    for name, t in _leaves(state["m"]):
        np.testing.assert_allclose(t.numpy(), jm[name], rtol=RTOL, atol=ATOL, err_msg=name)
    for (_, t), (_, lo) in zip(_leaves(master), _leaves(low)):
        assert torch.equal(lo, t.to(torch.bfloat16))


def test_opt_state_from_numpy_fused_adam_and_optax():
    rng = np.random.default_rng(1)
    params = jax.tree.map(jnp.asarray, _tree(rng))
    from deepspeed_tpu.runtime.optimizers import OptState as JOptState

    tx = jfa.fused_adam_transform(jfa.AdamParams(), use_pallas=False)
    st = tx.init(params)
    _, st = tx.update(params, st, params, lr=1e-3)
    got = opt_state_from_numpy(jax.tree.map(np.asarray, JOptState(master=params, inner=st)),
                               ("m", "v", "count"))
    assert got.inner["count"] == 1
    np.testing.assert_array_equal(got.inner["v"]["nest"]["small"].numpy(),
                                  np.asarray(st.v["nest"]["small"]))
    np.testing.assert_array_equal(got.master["big"].numpy(), np.asarray(params["big"]))
    otx = optax.adamw(1e-3)
    ost = otx.init(params)
    _, ost = otx.update(params, ost, params)
    got = opt_state_from_numpy(jax.tree.map(np.asarray, JOptState(master=params, inner=ost)),
                               ("count", "mu", "nu"))
    assert got.inner["count"] == 1
    np.testing.assert_array_equal(got.inner["mu"]["big"].numpy(), np.asarray(ost[0].mu["big"]))
    with pytest.raises(KeyError, match="trace"):
        opt_state_from_numpy(JOptState(master={}, inner=ost), ("trace",))


def test_newton_schulz_matches_jax():
    """Five bf16 iterations amplify where XLA and torch round bf16 products
    and sums: each result sits ~0.06 of the largest element from the same
    iteration in fp32 (0.029 and 0.027 against a largest element of 0.49),
    and so up to 0.15 of it from the other."""
    rng = np.random.default_rng(2)
    for shape in ((24, 40), (40, 24)):
        g = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(j_newton_schulz(jnp.asarray(g)))
        got = p_newton_schulz(torch.from_numpy(g)).numpy()
        np.testing.assert_allclose(got, want, atol=0.15 * np.abs(want).max(), rtol=0)


# ---------------------------------------------------------------------------
# engine trajectories, every ported optimizer type
# ---------------------------------------------------------------------------
BASE = dict(vocab_size=256, hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=64,
            remat=False, dtype="float32")
# (optimizer section, loss rtol, weight atol, share of elements allowed
# beyond it). Elementwise chains follow the JAX engine as AdamW does
# (test_torch_train.py): a gradient element near 0 under a square root turns
# a 1e-7 difference into an update difference of up to 2 * lr. Lion takes a
# sign: an element whose (1 - b1) g + b1 mu is within rounding of 0 flips and
# lands 2 * lr per step away, so a small share of elements may sit up to
# 8 * lr off while the rest agree tightly. Muon's 2-D leaves go through five
# bf16 Newton-Schulz iterations (see above).
OPTIMIZERS = {
    "fused_adam": ({"type": "FusedAdam", "params": {"lr": 1e-3, "weight_decay": 0.01}},
                   1e-5, 1e-4, 0.0),
    "fused_adam_l2": ({"type": "FusedAdam", "params": {"lr": 1e-3, "weight_decay": 0.01,
                                                       "adam_w_mode": False}}, 1e-5, 1e-4, 0.0),
    "fused_adam_no_bias_correction": (
        {"type": "FusedAdam", "params": {"lr": 1e-3, "bias_correction": False}}, 1e-5, 1e-4, 0.0),
    "lamb": ({"type": "Lamb", "params": {"lr": 1e-3, "weight_decay": 0.01}}, 1e-5, 1e-4, 0.0),
    "fused_lamb": ({"type": "FusedLamb", "params": {"lr": 1e-3}}, 1e-5, 1e-4, 0.0),
    "lion": ({"type": "Lion", "params": {"lr": 1e-3, "weight_decay": 0.01,
                                         "betas": [0.9, 0.99]}}, 1e-4, 1e-5, 2e-3),
    "fused_lion": ({"type": "FusedLion", "params": {"lr": 1e-3}}, 1e-4, 1e-5, 2e-3),
    "adagrad": ({"type": "Adagrad", "params": {"lr": 1e-2}}, 1e-5, 1e-4, 0.0),
    "sgd": ({"type": "SGD", "params": {"lr": 1e-2}}, 1e-5, 1e-5, 0.0),
    "sgd_momentum_nesterov": (
        {"type": "SGD", "params": {"lr": 1e-2, "momentum": 0.9, "nesterov": True}},
        1e-5, 1e-5, 0.0),
    "sgd_momentum": ({"type": "SGD", "params": {"lr": 1e-2, "momentum": 0.9}}, 1e-5, 1e-5, 0.0),
    "muon": ({"type": "Muon", "params": {"lr": 1e-3, "weight_decay": 0.01}}, 2e-3, 3e-4, 0.0),
    "adam": ({"type": "Adam", "params": {"lr": 1e-3, "adam_w_mode": False}}, 1e-5, 1e-4, 0.0),
}


def _engines(opt, **extra):
    jc, pc = JT.get_config("tiny", **BASE), PT.get_config("tiny", **BASE)
    jp = JT.init_params(jc, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "optimizer": opt, "gradient_clipping": 1.0, "steps_per_print": 1000,
           "scheduler": {"type": "WarmupLR", "params": {
               "warmup_num_steps": 2, "warmup_max_lr": opt["params"]["lr"]}}, **extra}
    je, *_ = deepspeed_tpu.initialize(model=JT.make_loss_fn(jc), model_parameters=jp,
                                      config=copy.deepcopy(cfg))
    pe, *_ = deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc), model_parameters=tp,
                                            config=copy.deepcopy(cfg))
    return je, pe


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_trajectory_matches_jax(name):
    opt, loss_rtol, w_atol, outliers = OPTIMIZERS[name]
    je, pe = _engines(opt)
    start = {k: w.detach().clone() for k, w in _leaves(pe.params)}
    rng = np.random.default_rng(3)
    for _ in range(4):
        batch = {"input_ids": rng.integers(0, 256, size=(4, 17)).astype(np.int32)}
        jl, pl = float(je.train_batch(batch=batch)), float(pe.train_batch(batch=batch))
        np.testing.assert_allclose(pl, jl, rtol=loss_rtol)
        np.testing.assert_allclose(pe.get_global_grad_norm(), je.get_global_grad_norm(),
                                   rtol=10 * loss_rtol)
    jw = dict(_leaves(jax.tree.map(np.asarray, je.params)))
    moved = 0.0
    for pname, w in _leaves(pe.params):
        diff = np.abs(w.detach().numpy() - jw[pname])
        assert np.mean(diff > w_atol) <= outliers, (pname, float(diff.max()))
        assert diff.max() <= max(w_atol, 8 * opt["params"]["lr"] * bool(outliers)), pname
        moved = max(moved, float((w.detach() - start[pname]).abs().max()))
    assert moved > 5 * w_atol  # the tolerance is small beside what the weights moved
    assert pe.optimizer.name == je.optimizer.name


# add_decayed_weights in front of an lr-injected transform: the JAX package's
# chain calls the inner update without its ``lr`` (ROADMAP section 3), so
# these two modes are held to optax itself
DECAY_FIRST = {
    "adam_l2": ({"type": "Adam", "params": {"lr": 1e-2, "weight_decay": 0.1,
                                            "adam_w_mode": False}},
                lambda: optax.chain(optax.add_decayed_weights(0.1), optax.adam(1e-2))),
    "sgd_decay": ({"type": "SGD", "params": {"lr": 1e-2, "weight_decay": 0.1, "momentum": 0.9,
                                             "nesterov": True}},
                  lambda: optax.chain(optax.add_decayed_weights(0.1),
                                      optax.sgd(1e-2, momentum=0.9, nesterov=True))),
}


@pytest.mark.parametrize("name", sorted(DECAY_FIRST))
def test_decay_first_modes_match_optax_and_jax_package_raises(name):
    from deepspeed_tpu.runtime.config import OptimizerConfig as JOptimizerConfig
    from deepspeed_tpu.runtime.optimizers import build_optimizer as j_build
    from deepspeed_tpu_torch.runtime.config import OptimizerConfig
    from deepspeed_tpu_torch.runtime.optimizers import build_optimizer

    section, make_tx = DECAY_FIRST[name]
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((8, 6)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = j_build(JOptimizerConfig(type=section["type"], params=dict(section["params"])))
    with pytest.raises(TypeError, match="lr"):  # the fault, pinned
        jopt.step(jparams, jopt.init(jparams), jparams, jnp.float32(1e-2))
    tx = make_tx()
    ost = tx.init(jparams)
    popt = build_optimizer(OptimizerConfig(type=section["type"], params=dict(section["params"])))
    tparams = params_from_numpy(params)
    state = popt.init(tparams)
    for _ in range(3):
        grads = {"w": rng.standard_normal((8, 6)).astype(np.float32),
                 "b": {"c": rng.standard_normal(5).astype(np.float32)}}
        upd, ost = tx.update(jax.tree.map(jnp.asarray, grads), ost, jparams)
        jparams = optax.apply_updates(jparams, upd)
        state = popt.step(params_from_numpy(grads), state, tparams, 1e-2)
    want = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    for pname, w in _leaves(tparams):
        np.testing.assert_allclose(w.numpy(), want[pname], rtol=RTOL, atol=ATOL, err_msg=pname)


@pytest.mark.parametrize("kind", ["OneBitAdam", "ZeroOneAdam", "OneBitLamb",
                                  "ZenFlowSelectiveAdam"])
def test_optimizers_still_waiting_raise(kind):
    pc = PT.get_config("tiny", **BASE)
    tp = PT.init_params(pc, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        deepspeed_tpu_torch.initialize(
            model=PT.make_loss_fn(pc), model_parameters=tp,
            config={"train_micro_batch_size_per_gpu": 1,
                    "optimizer": {"type": kind, "params": {"lr": 1e-3}}})


@pytest.mark.cuda
@pytest.mark.parametrize("numel", [1 << 16, (1 << 18) + 3])
def test_cuda_kernel_matches_plain(numel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(numel)
    p, g, m = (torch.randn(numel, generator=gen, device="cuda") for _ in range(3))
    v = torch.rand(numel, generator=gen, device="cuda")
    for mode in sorted(MODES):
        hp = pfa.AdamParams(lr=1e-3, **MODES[mode])
        want = pfa._adam_math(p, g, m, v, 3, hp, 1e-3)
        kp, km, kv = p.clone(), m.clone(), v.clone()
        low = torch.empty(numel, device="cuda", dtype=torch.float16)
        pfa.fused_adam_step(kp, g, km, kv, 3, hp, 1e-3, param_out=low)
        for got, ref in zip((kp, km, kv), want):
            torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
        assert torch.equal(low, kp.to(torch.float16))
