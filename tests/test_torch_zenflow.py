"""The port's ZenFlow against the JAX package's.

``runtime/zenflow.py``'s ``ZenFlowOptimizer`` against the JAX class on the
same seeded params and grads, across warm-up steps, selective steps and
two boundaries (one reselecting the columns): the selected columns equal,
every fp32 tensor of the state within 1e-6 of its largest element (the
JAX module computes 1 - b^t with XLA's pow and runs its step as one
program; the port divides by the bias corrections exactly, on every
device), the counts equal. Through ``initialize`` -> ``train_batch`` the
engine's ZenFlow follows the JAX engine's at the JAX suite's offload
tolerance (rtol 2e-4, atol 2e-5), its state on the device under
``offload_optimizer`` as the JAX engine keeps it, and a checkpoint
round-trips.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.runtime import zenflow as JZ
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.runtime import zenflow as PZ
from deepspeed_tpu_torch.runtime.optimizers import _leaves

STATE_RTOL = 1e-6
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng):
    return {"w": rng.standard_normal((8, 40)).astype(np.float32),
            "b": rng.standard_normal(40).astype(np.float32),
            "layers": {"s": rng.standard_normal((2, 4, 6)).astype(np.float32)}}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not want.size:
        return 0.0
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def _port_tree(tree, dtype):
    return jax.tree.map(lambda a: torch.from_numpy(a.copy()).to(dtype), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("warmup,wd", [(0, 0.0), (1, 0.01)])
def test_zenflow_steps_equal_jax_across_two_boundaries(dtype, warmup, wd):
    section = {"topk_ratio": 0.25, "update_interval": 2, "select_interval": 4,
               "full_warm_up_rounds": warmup}
    jcfg, pcfg = JZ.ZenFlowConfig.from_dict(section), PZ.ZenFlowConfig.from_dict(section)
    assert jcfg.resolved_intervals() == pcfg.resolved_intervals() == (4, 2)
    jo = JZ.ZenFlowOptimizer(jcfg, lr=1e-2, weight_decay=wd)
    po = PZ.ZenFlowOptimizer(pcfg, lr=1e-2, weight_decay=wd)
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jd), tree)
    pparams = _port_tree(tree, getattr(torch, dtype))
    jstate, pstate = jo.init(jparams), po.init(pparams)
    boundaries = 0
    for step in range(5):
        grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape)).astype(np.float32), tree)
        jparams, jstate = jo.step(jax.tree.map(jnp.asarray, grads), jstate, jparams, 1e-2)
        pstate = po.step(_port_tree(grads, torch.float32), pstate, pparams, 1e-2)
        boundaries += int(pstate["acc_steps"] == 0)
        for c in PZ.COUNTS:
            assert pstate[c] == int(getattr(jstate, c)), (step, c)
        jleaves = jax.tree_util.tree_leaves(jstate.leaves,
                                            is_leaf=lambda x: isinstance(x, JZ.ZenFlowLeafState))
        for (path, _), jl in zip(_leaves(pstate["master"]), jleaves):
            for f in PZ.LEAF_FIELDS:
                got = dict(_leaves(pstate[f]))[path]
                want = np.asarray(getattr(jl, f))
                if f == "indices":
                    assert got.tolist() == want.tolist(), (step, path)
                else:
                    assert _rel(got.numpy(), want) <= STATE_RTOL, (step, path, f)
        jp = dict(_leaves(jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)))
        for path, t in _leaves(pparams):
            assert _rel(t.float().numpy(), jp[path]) <= (STATE_RTOL if dtype == "float32"
                                                         else 2 ** -8), (step, path)
    assert boundaries == 2 + warmup  # c = 2 and 4 (and the warm-up step)


def test_zenflow_config_and_builder():
    from deepspeed_tpu_torch.runtime.config_utils import ConfigError

    assert PZ.ZenFlowConfig.from_dict({}).resolved_intervals() == \
        JZ.ZenFlowConfig.from_dict({}).resolved_intervals() == (100, 4)
    assert PZ.ZenFlowConfig.from_dict({"select_interval": 6, "update_interval": 4}) \
        .resolved_intervals() == (4, 4)
    with pytest.raises(ConfigError, match="topk_ratio"):
        PZ.ZenFlowConfig.from_dict({"topk_ratio": 1.5})
    with pytest.raises(ConfigError, match="select_strategy"):
        PZ.ZenFlowConfig.from_dict({"select_strategy": "often"})

    class Opt:
        params = {"lr": 3e-4, "betas": [0.8, 0.9], "weight_decay": 0.1}

    z = PZ.build_zenflow_optimizer({"topk_ratio": 0.2}, Opt)
    assert (z.name, z.b1, z.b2, z.wd, z.get_lr()) == ("zenflow", 0.8, 0.9, 0.1, 3e-4)


BASE = dict(vocab_size=256, hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2,
            max_seq_len=64, remat=False, dtype="float32")
ZF = {"topk_ratio": 0.25, "update_interval": 2, "select_interval": 2}


def _ds(**extra):
    return {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "steps_per_print": 1000, "zero_optimization": {"stage": 2}, "zenflow": dict(ZF),
            **extra}


def _engines(cfg):
    jc, pc = JT.get_config("tiny", **BASE), PT.get_config("tiny", **BASE)
    jp = JT.init_params(jc, jax.random.key(0))
    je, *_ = deepspeed_tpu.initialize(model=JT.make_loss_fn(jc), model_parameters=jp,
                                      config=copy.deepcopy(cfg))
    pe, *_ = deepspeed_tpu_torch.initialize(
        model=PT.make_loss_fn(pc), model_parameters=params_from_numpy(
            jax.tree.map(np.asarray, jp)), config=copy.deepcopy(cfg))
    return je, pe


@pytest.mark.parametrize("offload", [False, True])
def test_engine_zenflow_follows_the_jax_engine(offload):
    cfg = _ds(**({"zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}}}
                 if offload else {}))
    je, pe = _engines(cfg)
    assert pe.optimizer.name == je.optimizer.name == "zenflow"
    assert not pe._offload_opt  # ZenFlow keeps its state beside the params
    rng = np.random.default_rng(5)
    for _ in range(5):
        b = {"input_ids": rng.integers(0, 256, size=(4, 17)).astype(np.int32)}
        np.testing.assert_allclose(float(pe.train_batch(batch=b)), float(je.train_batch(batch=b)),
                                   rtol=RTOL, atol=ATOL)
    assert pe.opt_state["count"] == int(je.opt_state.count) == 5


def test_engine_zenflow_checkpoint_round_trips(tmp_path):
    cfg = _ds()
    _, a = _engines(cfg)
    _, b = _engines(cfg)
    rng = np.random.default_rng(6)
    batches = [{"input_ids": rng.integers(0, 256, size=(4, 17)).astype(np.int32)}
               for _ in range(4)]
    for batch in batches[:3]:
        a.train_batch(batch=batch)
    a.save_checkpoint(str(tmp_path))
    b.load_checkpoint(str(tmp_path))
    for c in PZ.COUNTS:
        assert b.opt_state[c] == a.opt_state[c]
    for f in PZ.LEAF_FIELDS:
        for (name, x), (_, y) in zip(_leaves(a.opt_state[f]), _leaves(b.opt_state[f])):
            assert torch.equal(x, y), (f, name)
    assert float(a.train_batch(batch=batches[3])) == float(b.train_batch(batch=batches[3]))


def test_zenflowselectiveadam_without_the_section_is_adam():
    """As in the JAX package, the optimizer name alone builds Adam / AdamW."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.optimizers import build_optimizer

    cfg = DeepSpeedConfig.load({"train_batch_size": 1, "optimizer": {
        "type": "ZenFlowSelectiveAdam", "params": {"lr": 1e-3}}})
    assert build_optimizer(cfg.optimizer).name == "adamw"
