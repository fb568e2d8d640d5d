"""Training in the PyTorch port against the JAX package.

Both packages are loaded; the JAX package's seeded parameters cross over
through ``params_from_numpy``, and the same numpy batches go through both.

  * ``make_loss_fn``: loss and every leaf's gradient against
    ``jax.value_and_grad`` of the JAX one, in fp32, on several
    architectures and on a packed batch with segment ids and positions;
  * ``remat`` on and off give the same gradients;
  * the engine: ``initialize(...).train_batch`` trajectories against
    ``deepspeed_tpu.initialize(...).train_batch`` with gradient
    accumulation, clipping, WarmupLR and AdamW with weight decay, in fp32,
    bf16 and fp16 (dynamic loss scaling through overflows);
  * lr schedules and ``DeepSpeedConfig.load``'s batch arithmetic, exactly;
  * every option the slice does not run raises ``NotImplementedError``.
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
from deepspeed_tpu.runtime import lr_schedules as jls
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.runtime import lr_schedules as pls
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as PConfig
from deepspeed_tpu_torch.runtime.config_utils import ConfigError
from deepspeed_tpu_torch.runtime.optimizers import _leaves

BASE = dict(vocab_size=256, hidden_size=64, n_layers=2, n_heads=4, max_seq_len=64,
            remat=False, dtype="float32")
# fp32 on both sides: the same function, summed in another order
LOSS_RTOL = 1e-5
GRAD_ATOL = GRAD_RTOL = 2e-5


def _configs(**over):
    kw = dict(BASE, **over)
    return JT.get_config("tiny", **kw), PT.get_config("tiny", **kw)


def _params(jc, seed=0):
    jp = JT.init_params(jc, jax.random.key(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _leaf_dict(tree):
    return dict(_leaves(tree))


def _port_value_and_grad(pc, tp, batch):
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    loss = PT.make_loss_fn(pc)(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    leaves = _leaf_dict(tp)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, (g.numpy() for g in grads)))


def _packed_batch(b, s, vocab, seed):
    """input_ids [b, s + 1] with two packed sequences per row: segment ids
    and positions that restart at each boundary (for the s inputs)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(b, s + 1)).astype(np.int32)
    seg = np.zeros((b, s), np.int32)
    pos = np.zeros((b, s), np.int32)
    for i in range(b):
        cut = int(rng.integers(s // 4, 3 * s // 4))
        seg[i, cut:] = 1
        pos[i] = np.concatenate([np.arange(cut), np.arange(s - cut)])
    return {"input_ids": toks, "segment_ids": seg, "positions": pos}


ARCHS = {
    "tiny": {},
    "gqa": dict(n_kv_heads=2),
    "sliding_window": dict(n_kv_heads=2, sliding_window=8),
    "attn_layer_pattern": dict(sliding_window=8, attn_layer_pattern=(1, 0)),
    "qk_norm": dict(qk_norm=True),
    "parallel_block": dict(parallel_block=True),
    "packed": dict(n_kv_heads=2),
}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_match_jax(arch):
    jc, pc = _configs(**ARCHS[arch])
    jp, tp = _params(jc)
    if arch == "packed":
        batch = _packed_batch(2, 32, jc.vocab_size, seed=1)
    else:
        rng = np.random.default_rng(len(arch))
        batch = {"input_ids": rng.integers(0, jc.vocab_size, size=(2, 33)).astype(np.int32)}
    jl, jg = jax.value_and_grad(JT.make_loss_fn(jc))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    pl, pg = _port_value_and_grad(pc, tp, batch)
    np.testing.assert_allclose(pl, float(jl), rtol=LOSS_RTOL)
    jg = _leaf_dict(jax.tree.map(np.asarray, jg))
    assert sorted(pg) == sorted(jg)
    for name, g in pg.items():
        np.testing.assert_allclose(g, jg[name], atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_packed_batch_is_not_the_unpacked_batch():
    """Control: the packed batch's segment ids and positions change the
    loss (so the packed case above compares something)."""
    jc, pc = _configs(n_kv_heads=2)
    _, tp = _params(jc)
    batch = _packed_batch(2, 32, jc.vocab_size, seed=1)
    packed, _ = _port_value_and_grad(pc, tp, batch)
    plain, _ = _port_value_and_grad(pc, tp, {"input_ids": batch["input_ids"]})
    assert abs(packed - plain) > 1e-3


def test_remat_on_and_off_give_equal_grads():
    jc, pc = _configs(n_kv_heads=2, sliding_window=8)
    _, pr = _configs(n_kv_heads=2, sliding_window=8, remat=True, remat_policy="nothing")
    _, tp = _params(jc)
    batch = _packed_batch(2, 32, 256, seed=4)
    l0, g0 = _port_value_and_grad(pc, tp, batch)
    l1, g1 = _port_value_and_grad(pr, tp, batch)
    assert l0 == l1
    for name in g0:
        np.testing.assert_array_equal(g0[name], g1[name], err_msg=name)


def test_forward_is_the_plain_forward_on_cpu():
    """On CPU tensors the training forward and the plain oracle compute the
    same logits (the plain versions on both sides)."""
    jc, pc = _configs(n_kv_heads=2, sliding_window=8)
    _, tp = _params(jc)
    batch = _packed_batch(1, 32, 256, seed=5)
    toks = torch.from_numpy(batch["input_ids"][:, :-1])
    kw = dict(positions=torch.from_numpy(batch["positions"]),
              segment_ids=torch.from_numpy(batch["segment_ids"]))
    a = PT.forward(tp, toks, pc, **kw)[0]
    b = PT.forward_reference(tp, toks, pc, **kw)[0]
    flash = PT.forward(tp, toks, PT.get_config("tiny", **dict(BASE, n_kv_heads=2,
                                                              sliding_window=8,
                                                              attention_impl="flash")), **kw)[0]
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    torch.testing.assert_close(flash, b, atol=2e-5, rtol=2e-5)


def test_lm_head_loss_matches_jax():
    """The model's head (final norm, logits, masked NLL) on the same hidden
    states and a loss mask."""
    jc, pc = _configs()
    jp, tp = _params(jc)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 16, jc.hidden_size)).astype(np.float32)
    labels = rng.integers(0, jc.vocab_size, size=(2, 16)).astype(np.int32)
    mask = (rng.random(size=(2, 16)) < 0.7).astype(np.float32)
    want = JT.lm_head_loss(jp, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mask), jc)
    got = PT.lm_head_loss(tp, torch.from_numpy(x), torch.from_numpy(labels),
                          torch.from_numpy(mask), pc)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_flops_per_token_matches_jax():
    for preset in ("tiny", "llama-7b", "llama-1b"):
        jc = JT.get_config(preset, n_layers=8)
        pc = PT.get_config(preset, n_layers=8)
        assert PT.flops_per_token(pc, 4096) == JT.flops_per_token(jc, 4096)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _ds_config(lr=1e-3, **extra):
    return {
        "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "AdamW", "params": {"lr": lr, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_num_steps": 2, "warmup_max_lr": lr}},
        "gradient_clipping": 1.0, "steps_per_print": 1000, **extra,
    }


def _trajectories(dtype, extra, steps=4, packed=False):
    jc, pc = _configs(n_kv_heads=2, dtype=dtype)
    jp, tp = _params(jc)
    cfg = _ds_config(**extra)
    je, *_ = deepspeed_tpu.initialize(model=JT.make_loss_fn(jc), model_parameters=jp,
                                      config=copy.deepcopy(cfg))
    pe, popt, _, psched = deepspeed_tpu_torch.initialize(
        model=PT.make_loss_fn(pc), model_parameters=tp, config=copy.deepcopy(cfg))
    assert popt is pe.optimizer and psched is pe.lr_scheduler
    rng = np.random.default_rng(1)
    rows = []
    for _ in range(steps):
        if packed:
            batch = _packed_batch(4, 16, 256, seed=int(rng.integers(1 << 30)))
        else:
            batch = {"input_ids": rng.integers(0, 256, size=(4, 17)).astype(np.int32)}
        jl = je.train_batch(batch=batch)
        pl = pe.train_batch(batch=batch)
        rows.append((float(jl), float(pl), je.loss_scale, pe.loss_scale,
                     bool(je._last_overflow), bool(pe._last_overflow),
                     je.get_global_grad_norm(), pe.get_global_grad_norm(),
                     je.get_lr()[0], pe.get_lr()[0]))
    return rows, je, pe


def test_engine_fp32_trajectory_matches_jax():
    rows, je, pe = _trajectories("float32", {}, packed=True)
    for jl, pl, _, _, _, _, jn, pn, jlr, plr in rows:
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
        np.testing.assert_allclose(pn, jn, rtol=1e-5)  # clipping computes the norm
        assert plr == jlr
    assert pe.global_steps == je.global_steps == 4
    # Adam divides by sqrt(v): a gradient element near 0 turns a 1e-7 grad
    # difference into an update difference of up to 2 * lr per step
    jw = _leaf_dict(jax.tree.map(np.asarray, je.params))
    for name, w in _leaf_dict(pe.params).items():
        np.testing.assert_allclose(w.detach().numpy(), jw[name], atol=1e-4, rtol=0,
                                   err_msg=name)


def test_engine_bf16_trajectory_matches_jax():
    """bf16 forward and backward round at other places in XLA and torch
    (3.5e-4 relative on the first loss): losses within 2e-3 relative, grad
    norms within 1e-2."""
    rows, _, pe = _trajectories("bfloat16", {"bf16": {"enabled": True}})
    for jl, pl, _, _, _, _, jn, pn, _, _ in rows:
        np.testing.assert_allclose(pl, jl, rtol=2e-3)
        np.testing.assert_allclose(pn, jn, rtol=1e-2)
    assert pe.params["layers"]["wq"].dtype == torch.bfloat16
    assert pe.opt_state.master["layers"]["wq"].dtype == torch.float32


def test_engine_fp16_dynamic_scaling_matches_jax():
    """2^16 with hysteresis 1 overflows on the first two steps: both
    engines skip them (params unchanged), halve the scale twice and then
    train on; skipped steps are counted on every step."""
    extra = {"fp16": {"enabled": True, "initial_scale_power": 16, "hysteresis": 1}}
    rows, _, pe = _trajectories("float16", extra, steps=5)
    overflow = [r[4] for r in rows]
    assert overflow == [True, True, False, False, False]
    for jl, pl, js, ps, jo, po, jn, pn, _, _ in rows:
        assert (ps, po) == (js, jo)
        np.testing.assert_allclose(pl, jl, rtol=2e-4)
        np.testing.assert_allclose(pn, jn, rtol=2e-3)
    assert [r[3] for r in rows] == [32768.0, 16384.0, 16384.0, 16384.0, 16384.0]
    assert pe.skipped_steps == 2


def test_engine_skip_step_leaves_params_and_state_unchanged():
    jc, pc = _configs(dtype="float16")
    _, tp = _params(jc)
    pe, *_ = deepspeed_tpu_torch.initialize(
        model=PT.make_loss_fn(pc), model_parameters=tp,
        config=_ds_config(fp16={"enabled": True, "initial_scale_power": 30}))
    before = {k: v.detach().clone() for k, v in _leaf_dict(pe.params).items()}
    master = {k: v.clone() for k, v in _leaf_dict(pe.opt_state.master).items()}
    toks = np.random.default_rng(0).integers(0, 256, size=(4, 17)).astype(np.int32)
    pe.train_batch(batch={"input_ids": toks})
    assert pe._last_overflow and pe.opt_state.inner["count"] == 0
    for k, v in _leaf_dict(pe.params).items():
        assert torch.equal(v, before[k]), k
    for k, v in _leaf_dict(pe.opt_state.master).items():
        assert torch.equal(v, master[k]), k


def test_skipped_steps_counted_off_the_print_steps():
    """Fault pinned (ROADMAP §3): the JAX engine counts a skipped step only
    on a ``steps_per_print`` step; the port counts every one."""
    extra = {"fp16": {"enabled": True, "initial_scale_power": 16, "hysteresis": 1}}
    _, je, pe = _trajectories("float16", extra, steps=2)
    assert bool(je._last_overflow) and pe._last_overflow
    assert (je.skipped_steps, pe.skipped_steps) == (0, 2)


def test_engine_eval_batch_and_getters():
    jc, pc = _configs()
    _, tp = _params(jc)
    pe, *_ = deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc), model_parameters=tp,
                                            config=_ds_config())
    toks = np.random.default_rng(0).integers(0, 256, size=(2, 17)).astype(np.int32)
    want = PT.make_loss_fn(pc)(tp, {"input_ids": torch.from_numpy(toks)})
    torch.testing.assert_close(pe.eval_batch({"input_ids": toks}), want, atol=0, rtol=0)
    assert (pe.train_batch_size(), pe.train_micro_batch_size_per_gpu(),
            pe.gradient_accumulation_steps()) == (4, 2, 2)
    assert pe.zero_optimization_stage() == 0 and not pe.zero_optimization()
    assert pe.gradient_clipping() == 1.0 and pe.loss_scale == 1.0
    assert pe.get_global_grad_norm() is None
    # the caller's params are copies, never the engine's
    assert all(not t.requires_grad for _, t in _leaves(tp))


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_stages_train_identically_on_one_device(stage):
    jc, pc = _configs()
    _, tp = _params(jc)
    toks = np.random.default_rng(0).integers(0, 256, size=(4, 17)).astype(np.int32)
    losses = []
    for st in (0, stage):
        pe, *_ = deepspeed_tpu_torch.initialize(
            model=PT.make_loss_fn(pc), model_parameters=tp,
            config=_ds_config(zero_optimization={"stage": st}))
        losses.append([float(pe.train_batch(batch={"input_ids": toks})) for _ in range(2)])
    assert losses[0] == losses[1]


# ---------------------------------------------------------------------------
# schedules, config
# ---------------------------------------------------------------------------
SCHEDULES = {
    "WarmupLR": dict(warmup_min_lr=1e-5, warmup_max_lr=1e-3, warmup_num_steps=10),
    "WarmupDecayLR": dict(total_num_steps=40, warmup_max_lr=1e-3, warmup_num_steps=8,
                          warmup_type="linear"),
    "WarmupCosineLR": dict(total_num_steps=45, warmup_num_steps=5, cos_min_ratio=0.01),
    "OneCycle": dict(cycle_min_lr=1e-4, cycle_max_lr=1e-3, cycle_first_step_size=10,
                     decay_lr_rate=0.1, decay_step_size=5),
    "LRRangeTest": dict(lr_range_test_min_lr=1e-4, lr_range_test_step_size=7,
                        lr_range_test_staircase=True),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedules_match_jax_exactly(name):
    j = jls.get_lr_scheduler(name, **SCHEDULES[name])
    p = pls.get_lr_scheduler(name, **SCHEDULES[name])
    if hasattr(j, "set_base_lr"):
        j.set_base_lr(3e-4)
        p.set_base_lr(3e-4)
    assert [j.step() for _ in range(50)] == [p.step() for _ in range(50)]
    assert j.state_dict() == p.state_dict()


BATCHES = [
    dict(train_batch_size=32, train_micro_batch_size_per_gpu=4, gradient_accumulation_steps=8),
    dict(train_batch_size=32, train_micro_batch_size_per_gpu=4),
    dict(train_batch_size=32, gradient_accumulation_steps=4),
    dict(train_micro_batch_size_per_gpu=3, gradient_accumulation_steps=5),
    dict(train_batch_size=12),
    dict(train_micro_batch_size_per_gpu=6),
]


@pytest.mark.parametrize("i", range(len(BATCHES)))
def test_config_batch_arithmetic_matches_jax(i):
    keys = ("train_batch_size", "train_micro_batch_size_per_gpu", "gradient_accumulation_steps")
    for dp in (1, 2):
        cfg = BATCHES[i]
        try:
            want = JConfig.load(dict(cfg), dp_world_size=dp)
        except Exception as e:  # the same refusal on both sides
            with pytest.raises(Exception) as got:
                PConfig.load(dict(cfg), dp_world_size=dp)
            assert type(got.value).__name__ == type(e).__name__
            continue
        got = PConfig.load(dict(cfg), dp_world_size=dp)
        assert [getattr(got, k) for k in keys] == [getattr(want, k) for k in keys]


def test_config_rejects_what_jax_rejects(tmp_path):
    with pytest.raises(ConfigError):
        PConfig.load({})
    with pytest.raises(ConfigError):
        PConfig.load(dict(train_batch_size=10, train_micro_batch_size_per_gpu=3,
                          gradient_accumulation_steps=3))
    path = tmp_path / "ds.json"
    path.write_text('{"train_batch_size": 8, "train_batch_size": 16}')
    with pytest.raises(ConfigError, match="Duplicate"):
        PConfig.load(str(path))


# ---------------------------------------------------------------------------
# what the slice does not run
# ---------------------------------------------------------------------------
UNPORTED_CONFIG = {
    "offload": ({"zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}}},
                "queue 1, item 7"),
    "qgz": ({"zero_optimization": {"stage": 2, "zero_quantized_gradients": True}},
            "queue 1, item 6"),
    "zenflow": ({"zenflow": {"topk_ratio": 0.1}}, "queue 1, item 7"),
    "curriculum": ({"curriculum_learning": {"enabled": True}}, "queue 1, item 9"),
    "flops_profiler": ({"flops_profiler": {"enabled": True}}, "queue 1, item 9"),
    "monitor": ({"tensorboard": {"enabled": True}}, "queue 1, item 5"),
    "fused_adam": ({"optimizer": {"type": "FusedAdam", "params": {}}}, "queue 2, item 7"),
    "lamb": ({"optimizer": {"type": "Lamb", "params": {}}}, "queue 1, item 3"),
    "onebit": ({"optimizer": {"type": "OneBitAdam", "params": {}}}, "queue 1, item 6"),
    "mesh": ({"mesh": {"data": 2}}, "queue 1, item 6"),
    "tp": ({"tensor_parallel": {"tp_size": 2}}, "queue 1, item 6"),
    "pipeline": ({"pipeline": {"stages": 2}}, "queue 1, item 6"),
}


@pytest.mark.parametrize("name", sorted(UNPORTED_CONFIG))
def test_unported_config_raises(name):
    over, match = UNPORTED_CONFIG[name]
    jc, pc = _configs()
    _, tp = _params(jc)
    cfg = _ds_config()
    cfg.update(over)
    with pytest.raises(NotImplementedError, match=match):
        deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc), model_parameters=tp, config=cfg)


@pytest.mark.parametrize("over,match", [
    (dict(fused_ce=True), "queue 2, item 6"),
    (dict(loss_tiles=2), "queue 1, item 6"),
])
def test_unported_loss_options_raise(over, match):
    with pytest.raises(NotImplementedError, match=match):
        PT.make_loss_fn(_configs(**over)[1])


@pytest.mark.parametrize("over,match", [
    (dict(remat=True), "remat_policy"),
    (dict(remat=True, remat_policy="flash"), "remat_policy"),
    (dict(attention_impl="splash"), "queue 2, item 4"),
    (dict(n_experts=2), "queue 1, item 2"),
    (dict(position="alibi"), "alibi"),
])
def test_unported_model_options_raise(over, match):
    jc, pc = _configs(**over)
    _, tp = _params(_configs()[0])
    with pytest.raises(NotImplementedError, match=match):
        PT.forward(tp, torch.zeros(1, 8, dtype=torch.long), pc)


def test_unported_engine_api_raises():
    jc, pc = _configs()
    _, tp = _params(jc)
    pe, *_ = deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc), model_parameters=tp,
                                            config=_ds_config())
    for fn, match in ((pe.forward, "queue 1, item 3"), (pe.step, "queue 1, item 3"),
                      (pe.save_checkpoint, "queue 1, item 8")):
        with pytest.raises(NotImplementedError, match=match):
            fn({})
