"""The port's offload tiers against the JAX package's.

* ``NVMeOptimizerSwapper`` (``runtime/swap_tensor.py``) and
  ``SuperOffloadHostOptimizer`` (``runtime/superoffload.py``) hold the
  same state as the JAX classes, bit for bit, over three steps (both drive
  the same native CPU-Adam).
* ``initialize`` -> ``train_batch`` under ``offload_optimizer`` ``cpu``
  (with ``ratio`` 0.4 too), ``super_offload``, ``nvme`` and
  ``offload_param: cpu`` follows the JAX engine on the same tier at the JAX
  suite's own tolerance (``tests/unit/test_engine.py``: rtol 2e-4, atol
  2e-5), and the fall back to the pinned-host tier logs the JAX engine's
  warning.
* Where the JAX engine has no like tier to hold the port to (client and
  other optimizers under offload), the tier equals the port's own run
  without offload: on the CPU the state's placement changes nothing.
* A host-tier checkpoint round-trips through the default store, and
  ``zero_to_fp32`` reads the host masters.
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
from deepspeed_tpu.runtime import engine as jengine
from deepspeed_tpu.runtime.superoffload import SuperOffloadHostOptimizer as JSuper
from deepspeed_tpu.runtime.swap_tensor import NVMeOptimizerSwapper as JSwapper
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.ops.adam import cpu_adam
from deepspeed_tpu_torch.runtime import engine as pengine
from deepspeed_tpu_torch.runtime.optimizers import _leaves
from deepspeed_tpu_torch.runtime.superoffload import SuperOffloadHostOptimizer as PSuper
from deepspeed_tpu_torch.runtime.swap_tensor import NVMeOptimizerSwapper as PSwapper

RTOL, ATOL = 2e-4, 2e-5  # tests/unit/test_engine.py's, for the offload tiers
BASE = dict(vocab_size=256, hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2,
            max_seq_len=64, remat=False, dtype="float32")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op torch thread and one OpenMP thread for the native
    library: the CPU tests run in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = cpu_adam.set_num_threads(1)
    yield
    cpu_adam.set_num_threads(prev)
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the host optimizers
# ---------------------------------------------------------------------------
def _leaves_np(seed=0):
    rng = np.random.default_rng(seed)
    return [("layers.wq", rng.standard_normal((3, 40, 24)).astype(np.float32)),
            ("embed", rng.standard_normal((50, 24)).astype(np.float32)),
            ("norm", rng.standard_normal(24).astype(np.float32)),
            ("head_bf16", np.asarray(jnp.asarray(rng.standard_normal((24, 16)), jnp.bfloat16)))]


def _as_torch(a):
    if a.dtype == np.float32:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)


def _bits(x):
    x = x.detach() if isinstance(x, torch.Tensor) else x
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x


@pytest.mark.parametrize("tier", ["nvme", "super_offload"])
def test_host_optimizer_state_equals_jax_over_three_steps(tier, tmp_path):
    kw = dict(lr=1e-3, betas=(0.9, 0.99), eps=1e-8, weight_decay=0.01, adamw_mode=True)
    if tier == "nvme":
        j = JSwapper(str(tmp_path / "jax"), buffer_count=4, **kw)
        p = PSwapper(str(tmp_path / "port"), buffer_count=4, **kw)
    else:
        j, p = JSuper(**kw), PSuper(**kw)
    named = _leaves_np()
    j.init_from_params(named)
    p.init_from_params([(n, _as_torch(a)) for n, a in named])
    rng = np.random.default_rng(1)
    for step in range(3):
        grads = [(n, (rng.standard_normal(a.shape) * 1e-2).astype(np.float32)) for n, a in named]
        jout = j.step(grads, lr=1e-3 * (step + 1))
        pout = p.step([(n, torch.from_numpy(g)) for n, g in grads], lr=1e-3 * (step + 1))
        for name, a in named:
            assert pout[name].shape == a.shape
            assert np.array_equal(_bits(pout[name]), _bits(jout[name])), name
    jt, pt = j.as_state_tree(), p.as_state_tree()
    assert jt.keys() == pt.keys() and jt["steps"] == pt["steps"] == 3
    for k in jt:
        if k != "steps":
            assert np.array_equal(np.asarray(jt[k]), pt[k].numpy()), k
    tmpl = p.state_tree_template()
    assert {k: tuple(v.shape) for k, v in tmpl.items() if k != "steps"} == \
        {k: tuple(v.shape) for k, v in pt.items() if k != "steps"}
    if tier == "nvme":
        assert p.bytes_read > 0 and p.bytes_written == 3 * 12 * sum(a.size for _, a in named)


def test_swapper_without_the_pipeline_and_a_state_tree_round_trip(tmp_path):
    """The unpipelined swapper and a state tree written back equal the
    pipelined one; SuperOffload's state is page-locked host memory only
    where there is a card."""
    kw = dict(lr=1e-3, weight_decay=0.0)
    a = PSwapper(str(tmp_path / "a"), **kw)
    b = PSwapper(str(tmp_path / "b"), pipeline_read=False, pipeline_write=False, **kw)
    named = [(n, _as_torch(x)) for n, x in _leaves_np(2)]
    a.init_from_params(named)
    b.init_from_params(named)
    rng = np.random.default_rng(3)
    for _ in range(2):
        g = [(n, torch.from_numpy((rng.standard_normal(t.shape) * 1e-2).astype(np.float32)))
             for n, t in named]
        a.step(g)
        b.step(g)
    ta, tb = a.as_state_tree(), b.as_state_tree()
    assert all(torch.equal(ta[k], tb[k]) for k in ta if k != "steps")
    c = PSwapper(str(tmp_path / "c"), **kw)
    c.init_from_params(named)
    c.load_state_tree(ta)
    tc = c.as_state_tree()
    assert tc["steps"] == 2 and all(torch.equal(ta[k], tc[k]) for k in ta if k != "steps")
    s = PSuper()
    s.init_from_params(named)
    assert all(not t.is_pinned() for t in s._state.values())


# ---------------------------------------------------------------------------
# the engine's tiers against the JAX engine's
# ---------------------------------------------------------------------------
def _configs(**over):
    kw = dict(BASE, **over)
    return JT.get_config("tiny", **kw), PT.get_config("tiny", **kw)


def _ds(zero=None, **extra):
    return {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "steps_per_print": 1000, "zero_optimization": dict(stage=2, **(zero or {})),
            **extra}


def _batches(n=4, seed=1):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, size=(4, 17)).astype(np.int32)}
            for _ in range(n)]


def _engines(cfg, jax_too=True, model_over=None, **init_kw):
    jc, pc = _configs(**(model_over or {}))
    jp = JT.init_params(jc, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    je = None
    if jax_too:
        je, *_ = deepspeed_tpu.initialize(model=JT.make_loss_fn(jc), model_parameters=jp,
                                          config=copy.deepcopy(cfg))
    pe, *_ = deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc), model_parameters=tp,
                                            config=copy.deepcopy(cfg), **init_kw)
    return je, pe


TIERS = {
    "cpu": {"offload_optimizer": {"device": "cpu"}},
    "cpu_ratio": {"offload_optimizer": {"device": "cpu", "ratio": 0.4}},
    "super_offload": {"offload_optimizer": {"device": "cpu", "super_offload": True}},
    "nvme": {"offload_optimizer": {"device": "nvme", "nvme_path": None}},
    "offload_param": {"offload_param": {"device": "cpu"}},
}


def _tier(name, tmp_path):
    z = copy.deepcopy(TIERS[name])
    if name == "nvme":
        z["offload_optimizer"]["nvme_path"] = str(tmp_path)
    return z


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_tier_follows_the_jax_engine(tier, tmp_path):
    je, pe = _engines(_ds(_tier(tier, tmp_path)))
    host = tier in ("super_offload", "nvme")
    assert (pe._host_opt is not None) == (je._host_opt is not None) == host
    assert pe._offload_opt == (tier.startswith("cpu"))
    for b in _batches():
        jl, pl = float(je.train_batch(batch=b)), float(pe.train_batch(batch=b))
        np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL)
    assert pe.global_steps == je.global_steps == 4
    jw = dict(_leaves_np_tree(je.params))
    for name, w in _leaves(pe.params):
        np.testing.assert_allclose(w.detach().numpy(), jw[name], atol=1e-4, rtol=0,
                                   err_msg=name)


def _leaves_np_tree(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [("/".join(str(getattr(k, "key", k)) for k in path), np.asarray(v))
            for path, v in flat]


def test_twin_flow_puts_the_largest_leaves_on_the_host():
    """ratio 0.4: the host holds state leaves largest first until 0.4 of the
    state's bytes (the JAX plan's mask); the counts stay as they were."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import tree_leaves

    _, pe = _engines(_ds(TIERS["cpu_ratio"]), jax_too=False)
    flat = [t for t in tree_leaves(pe._opt_state_payload()) if isinstance(t, torch.Tensor)]
    total = sum(t.numel() * 4 for t in flat)
    assert 0.4 * total <= pe._host_state_bytes < 0.4 * total + max(t.numel() * 4 for t in flat)


@pytest.mark.parametrize("opt", ["Lamb", "FusedAdam", "Muon", "client"])
def test_pinned_host_tier_is_the_run_without_offload(opt):
    """Other optimizers under ``offload_optimizer: cpu``: Lamb's update runs
    on the host over the host state, FusedAdam and Muon stage it through the
    device a leaf at a time, a client torch optimizer steps host masters.
    On the CPU the losses and params equal the run without offload."""
    def build(zero):
        cfg = _ds(zero)
        kw = {}
        if opt == "client":
            del cfg["optimizer"]
            kw["optimizer"] = lambda params: torch.optim.AdamW(
                [p for _, p in _leaves(params)], lr=1e-3)
        else:
            cfg["optimizer"] = {"type": opt, "params": {"lr": 1e-3}}
        return _engines(cfg, jax_too=False, **kw)[1]

    a, b = build({}), build(TIERS["cpu"])
    assert b._offload_opt and not a._offload_opt
    for batch in _batches(3):
        assert float(a.train_batch(batch=batch)) == float(b.train_batch(batch=batch))
    for (name, x), (_, y) in zip(_leaves(a.params), _leaves(b.params)):
        assert torch.equal(x, y), name


def _fallback_messages(monkeypatch):
    got = {"jax": [], "port": []}
    monkeypatch.setattr(jengine, "log_dist", lambda m, **k: got["jax"].append(m))
    monkeypatch.setattr(pengine, "log_dist", lambda m, **k: got["port"].append(m))
    return got


@pytest.mark.parametrize("case", ["nvme_no_path", "lamb", "zenflow"])
def test_host_tier_falls_back_with_the_jax_warning(case, monkeypatch):
    got = _fallback_messages(monkeypatch)
    zero = {"offload_optimizer": {"device": "nvme"}} if case == "nvme_no_path" else \
        {"offload_optimizer": {"device": "cpu", "super_offload": True}}
    cfg = _ds(zero)
    if case == "lamb":
        cfg["optimizer"] = {"type": "Lamb", "params": {"lr": 1e-3}}
    if case == "zenflow":
        cfg["zenflow"] = {"topk_ratio": 0.5, "update_interval": 2}
    je, pe = _engines(cfg)
    assert je._host_opt is None and pe._host_opt is None
    falls = [[m for m in got[k] if "falling back" in m] for k in ("jax", "port")]
    assert falls[0] == falls[1] and len(falls[0]) == 1
    for b in _batches(2):
        np.testing.assert_allclose(float(pe.train_batch(batch=b)), float(je.train_batch(batch=b)),
                                   rtol=RTOL, atol=ATOL)


def test_client_optimizer_falls_back_with_the_jax_warning(monkeypatch):
    got = _fallback_messages(monkeypatch)
    cfg = _ds({"offload_optimizer": {"device": "cpu", "super_offload": True}})
    del cfg["optimizer"]
    jc, pc = _configs()
    jp = JT.init_params(jc, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    import optax

    deepspeed_tpu.initialize(model=JT.make_loss_fn(jc), model_parameters=jp,
                             optimizer=optax.adamw(1e-3), config=copy.deepcopy(cfg))
    pe, *_ = deepspeed_tpu_torch.initialize(
        model=PT.make_loss_fn(pc), model_parameters=tp, config=copy.deepcopy(cfg),
        optimizer=torch.optim.AdamW([p for _, p in _leaves(tp)], lr=1e-3))
    assert pe._host_opt is None and pe._offload_opt
    jm = [m for m in got["jax"] if "falling back" in m]
    pm = [m for m in got["port"] if "falling back" in m]
    # the same sentence; the optimizer named is each package's own class
    assert [m.replace("GradientTransformationExtraArgs", "X") for m in jm] == \
        [m.replace("AdamW", "X") for m in pm]


def test_host_tiers_refuse_the_imperative_step(tmp_path):
    _, pe = _engines(_ds(_tier("nvme", tmp_path)), jax_too=False)
    b = _batches(1)[0]
    for half in (b["input_ids"][:2], b["input_ids"][2:]):
        pe.forward({"input_ids": half})
        pe.backward()
    pe.micro_steps = 1
    with pytest.raises(NotImplementedError, match="train_batch"):
        pe.step()


def test_offload_param_keeps_the_params_on_the_host_between_steps():
    """offload_param: the imperative path and eval stage the host params
    too, and train as the run without offload."""
    _, a = _engines(_ds(), jax_too=False)
    _, b = _engines(_ds(TIERS["offload_param"]), jax_too=False)
    assert b._offload_par and b._staged_params is None
    for batch in _batches(2):
        for e in (a, b):
            for half in (batch["input_ids"][:2], batch["input_ids"][2:]):
                e.forward({"input_ids": half})
                e.backward()
                e.step()
        assert b._staged_params is None
    assert float(a.eval_batch(_batches(1)[0])) == float(b.eval_batch(_batches(1)[0]))
    for (name, x), (_, y) in zip(_leaves(a.params), _leaves(b.params)):
        assert torch.equal(x, y), name


# ---------------------------------------------------------------------------
# checkpoints of the host tiers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tier", ["super_offload", "nvme"])
def test_host_tier_checkpoint_round_trips_and_zero_to_fp32_reads_the_masters(tier, tmp_path):
    from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint

    cfg = _ds(_tier(tier, tmp_path / "swap_a"))
    _, pe = _engines(cfg, jax_too=False)
    batches = _batches(3)
    for b in batches[:2]:
        pe.train_batch(batch=b)
    pe.save_checkpoint(str(tmp_path / "ckpt"))
    want = pe._host_opt.as_state_tree()
    sd = get_fp32_state_dict_from_zero_checkpoint(str(tmp_path / "ckpt"))
    for path, _ in _leaves(pe.params):
        name = path.replace("/", ".")
        assert np.array_equal(sd[name], want[f"{name}.master"].numpy()), name
    cfg2 = _ds(_tier(tier, tmp_path / "swap_b"))
    _, other = _engines(cfg2, jax_too=False, model_over={})
    for _, t in _leaves(other.params):
        with torch.no_grad():
            t.add_(1.0)  # other weights: the load must overwrite them
    other.load_checkpoint(str(tmp_path / "ckpt"))
    got = other._host_opt.as_state_tree()
    assert got["steps"] == want["steps"] == 2
    for k in want:
        if k != "steps":
            assert torch.equal(got[k], want[k]), k
    assert other.global_steps == 2
    assert float(other.train_batch(batch=batches[2])) == float(pe.train_batch(batch=batches[2]))
