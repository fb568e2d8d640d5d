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
  * the fused configuration as a whole: ``fused_ce=True`` with ``FusedAdam``
    against the JAX engine, ``loss_tiles``, the imperative ``forward`` /
    ``backward`` / ``step`` against ``train_batch`` and against JAX, the
    dataloader and the wall-clock timers;
  * lr schedules and ``DeepSpeedConfig.load``'s batch arithmetic, exactly;
  * every option the port does not run yet raises ``NotImplementedError``.
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
                None),
    "qgz": ({"zero_optimization": {"stage": 2, "zero_quantized_gradients": True}},
            "queue 1, item 6"),
    "zenflow": ({"zenflow": {"topk_ratio": 0.1}}, None),
    "curriculum": ({"curriculum_learning": {"enabled": True}}, "queue 1, item 9"),
    "flops_profiler": ({"flops_profiler": {"enabled": True}}, "queue 1, item 9"),
    "monitor": ({"tensorboard": {"enabled": True}}, None),
    "fused_adam": ({"optimizer": {"type": "FusedAdam", "params": {}}}, None),
    "lamb": ({"optimizer": {"type": "Lamb", "params": {}}}, None),
    "onebit": ({"optimizer": {"type": "OneBitAdam", "params": {}}}, "queue 1, item 6"),
    "mesh": ({"mesh": {"model": 2}}, "queue 1, item 6"),
    "tp": ({"tensor_parallel": {"tp_size": 2}}, "queue 1, item 6"),
    "pipeline": ({"pipeline": {"stages": 2}}, "queue 1, item 6"),
}


@pytest.mark.parametrize("name", sorted(UNPORTED_CONFIG))
def test_unported_config_raises(name, tmp_path, monkeypatch):
    """A section the port does not run yet raises, naming its ROADMAP item.
    The FusedAdam and Lamb types, the monitors, offload and ZenFlow are
    ported (match None): they build an engine that trains (the TensorBoard
    writer's files, where its package is installed, land under the test's
    own directory)."""
    monkeypatch.chdir(tmp_path)
    over, match = UNPORTED_CONFIG[name]
    jc, pc = _configs()
    _, tp = _params(jc)
    cfg = _ds_config()
    cfg.update(over)
    if match is None:
        pe, *_ = deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc), model_parameters=tp,
                                                config=cfg)
        toks = np.random.default_rng(0).integers(0, 256, size=(4, 17)).astype(np.int32)
        first = float(pe.train_batch(batch={"input_ids": toks}))
        for _ in range(3):
            last = float(pe.train_batch(batch={"input_ids": toks}))
        assert np.isfinite(first) and last < first
        return
    with pytest.raises(NotImplementedError, match=match):
        deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc), model_parameters=tp, config=cfg)


@pytest.mark.parametrize("over,match", [
    (dict(fused_ce=True), "queue 2, item 6"),
    (dict(loss_tiles=2), "queue 1, item 6"),
])
def test_unported_loss_options_raise(over, match):
    """The fused and the tiled head are ported (``match`` names the ROADMAP
    items they used to raise with): they build, and give the dense head's
    loss and gradients in fp32 (the same function summed in another order)."""
    jc, pc = _configs(**over)
    _, tp = _params(jc)
    batch = _packed_batch(2, 32, jc.vocab_size, seed=2)
    loss, grads = _port_value_and_grad(pc, tp, batch)
    dense, dense_grads = _port_value_and_grad(_configs()[1], tp, batch)
    np.testing.assert_allclose(loss, dense, rtol=LOSS_RTOL)
    for name, g in grads.items():
        np.testing.assert_allclose(g, dense_grads[name], atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("over,match", [
    (dict(remat=True), "remat_policy"),
    (dict(remat=True, remat_policy="flash"), "remat_policy"),
    (dict(attention_impl="splash"), "queue 2, item 4"),
    (dict(n_experts=2), "queue 1, item 2"),
    (dict(position="alibi"), "alibi"),
])
def test_unported_model_options_raise(over, match):
    """Options the model once refused (``match`` names the refusal) are
    ported. Splash: without a window its derived schedule is the causal
    mask, so the forward is the dense one. The remat policies, MoE and
    ALiBi: the forward is the JAX model's on the same weights."""
    jc, pc = _configs(**over)
    tokens = torch.arange(8, dtype=torch.long)[None]
    if over == dict(attention_impl="splash"):
        _, tp = _params(_configs()[0])
        got = PT.forward(tp, tokens, pc)[0]
        torch.testing.assert_close(got, PT.forward(tp, tokens, _configs()[1])[0],
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)
        return
    jp, tp = _params(jc)
    want = np.asarray(JT.forward(jp, jnp.asarray(tokens.numpy()), jc)[0])
    got = PT.forward(tp, tokens, pc)[0].detach().numpy()
    np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.fixture
def one_thread():
    """One intra-op thread for the tiny models below (the suite runs in
    several worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("impl", ["auto", "flash"])
@pytest.mark.parametrize("policy", PT.REMAT_POLICIES)
def test_remat_policies_match_no_remat(policy, impl, monkeypatch, one_thread):
    """Every remat policy gives remat=False's loss and gradients bit for
    bit (a policy changes memory and recompute, never values). With the
    flash Function ("flash", its plain versions here) the flash forward
    runs once a layer in the forward, again in the backward under
    "nothing" and the dots policies, and not again under "flash",
    "flash_qkv" and "everything"."""
    from deepspeed_tpu_torch.ops.attention import flash as pf

    calls = []
    real = pf.flash_fwd_reference
    monkeypatch.setattr(pf, "flash_fwd_reference", lambda *a, **k: calls.append(1) or real(*a, **k))
    jc, pc = _configs(n_kv_heads=2, attention_impl=impl, remat=True, remat_policy=policy)
    _, tp = _params(jc)
    batch = _packed_batch(2, 32, jc.vocab_size, seed=4)
    loss, grads = _port_value_and_grad(pc, tp, batch)
    n_remat = len(calls)
    del calls[:]
    plain_loss, plain_grads = _port_value_and_grad(_configs(n_kv_heads=2, attention_impl=impl)[1],
                                                   tp, batch)
    assert loss == plain_loss
    for name, g in grads.items():
        np.testing.assert_array_equal(g, plain_grads[name], err_msg=name)
    if impl == "flash":
        layers = pc.n_layers
        assert len(calls) == layers
        again = policy in ("nothing", "dots", "dots_with_no_batch_dims")
        assert n_remat == layers * (2 if again else 1)


def test_unknown_remat_policy_raises():
    """An unknown remat_policy raises ValueError in both packages (the
    port also under no_grad, as the JAX model checks it whenever remat is
    on)."""
    jc, pc = _configs(remat=True, remat_policy="offload")
    jp, tp = _params(_configs()[0])
    with pytest.raises(ValueError, match="remat_policy"):
        JT.forward(jp, jnp.arange(8)[None], jc)
    for grad in (True, False):
        with torch.set_grad_enabled(grad), pytest.raises(ValueError, match="remat_policy"):
            PT.forward(tp, torch.arange(8)[None], pc)


def test_unported_engine_api_raises(tmp_path):
    """What the engine's API still refuses: a tag that holds only the JAX
    package's orbax store (with no ``checkpoint.writer`` the port saves and
    loads the npz archive), and the imperative calls out of order."""
    jc, pc = _configs()
    _, tp = _params(jc)
    pe, *_ = deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc), model_parameters=tp,
                                            config=_ds_config())
    assert pe.save_checkpoint(str(tmp_path / "npz"))
    assert pe.load_checkpoint(str(tmp_path / "npz"))[0].endswith("global_step0")
    (tmp_path / "orbax" / "t" / "state").mkdir(parents=True)
    (tmp_path / "orbax" / "latest").write_text("t")
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        pe.load_checkpoint(str(tmp_path / "orbax"))
    with pytest.raises(RuntimeError, match="forward"):
        pe.backward()
    pe.step()  # micro-step 1 of 2: no boundary, nothing to apply
    with pytest.raises(RuntimeError, match="no accumulated gradients"):
        pe.step()


# ---------------------------------------------------------------------------
# the fused configuration, the imperative API, data, timers
# ---------------------------------------------------------------------------
FUSED_ADAM = {"type": "FusedAdam", "params": {"lr": 1e-3, "weight_decay": 0.01}}


@pytest.mark.parametrize("over", [dict(), dict(tie_embeddings=True)], ids=["untied", "tied"])
def test_fused_ce_loss_and_grads_match_jax(over):
    """``fused_ce=True``: on the CPU the JAX loss takes its dense branch (its
    fused branch asks for a TPU), the port the fused Function's plain
    versions; 2 * 29 rows pad to 256 with zero mask. A loss mask and a tied
    head (dW lands on the embedding) ride along."""
    jc, pc = _configs(fused_ce=True, n_kv_heads=2, **over)
    jp, tp = _params(jc)
    rng = np.random.default_rng(7)
    batch = {"input_ids": rng.integers(0, 256, size=(2, 30)).astype(np.int32),
             "loss_mask": (rng.random((2, 30)) < 0.8).astype(np.float32)}
    jl, jg = jax.value_and_grad(JT.make_loss_fn(jc))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    pl, pg = _port_value_and_grad(pc, tp, batch)
    np.testing.assert_allclose(pl, float(jl), rtol=LOSS_RTOL)
    jg = _leaf_dict(jax.tree.map(np.asarray, jg))
    assert sorted(pg) == sorted(jg) and ("lm_head" in pg) == (not over)
    for name, g in pg.items():
        np.testing.assert_allclose(g, jg[name], atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_loss_tiles_match_jax():
    jc, pc = _configs(loss_tiles=4, n_kv_heads=2)
    jp, tp = _params(jc)
    batch = _packed_batch(2, 32, jc.vocab_size, seed=3)
    batch["loss_mask"] = (np.random.default_rng(3).random((2, 33)) < 0.7).astype(np.float32)
    jl, jg = jax.value_and_grad(JT.make_loss_fn(jc))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    pl, pg = _port_value_and_grad(pc, tp, batch)
    np.testing.assert_allclose(pl, float(jl), rtol=LOSS_RTOL)
    jg = _leaf_dict(jax.tree.map(np.asarray, jg))
    for name, g in pg.items():
        np.testing.assert_allclose(g, jg[name], atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_tiled_compute_and_mlp_match_jax():
    from deepspeed_tpu.parallel.sequence import tiled as jt
    from deepspeed_tpu_torch.parallel.sequence import tiled as pt

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 8)).astype(np.float32)
    w = rng.standard_normal((8, 8)).astype(np.float32)
    want = np.asarray(jt.tiled_mlp(lambda t: jnp.tanh(t @ jnp.asarray(w)), jnp.asarray(x), 3))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w)
    got = pt.tiled_mlp(lambda t: torch.tanh(t @ wt), xt, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, rtol=1e-6)
    (g,) = torch.autograd.grad(got.sum(), xt)
    (g0,) = torch.autograd.grad(torch.tanh(xt @ wt).sum(), xt)
    torch.testing.assert_close(g, g0)
    # tiles that do not divide the axis run untiled, as in the JAX package
    assert pt.tiled_compute(lambda t: t * 2, xt, 5).shape == xt.shape


def _fused_engines(dtype="float32", **extra):
    jc, pc = _configs(n_kv_heads=2, dtype=dtype, fused_ce=True)
    jp, tp = _params(jc)
    cfg = _ds_config(**extra)
    cfg["optimizer"] = copy.deepcopy(FUSED_ADAM)
    je, *_ = deepspeed_tpu.initialize(model=JT.make_loss_fn(jc), model_parameters=jp,
                                      config=copy.deepcopy(cfg))
    pe, *_ = deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc), model_parameters=tp,
                                            config=copy.deepcopy(cfg))
    return je, pe


def test_fused_configuration_trajectory_matches_jax():
    """The slice as a whole: ``fused_ce=True`` + ``FusedAdam`` through
    ``train_batch`` for 4 steps against the JAX engine with the same config
    (on the CPU the JAX loss takes its dense branch and its FusedAdam the
    jnp math; the port takes the fused Function's and the kernel's plain
    versions). fp32, tolerances as for AdamW above."""
    je, pe = _fused_engines()
    assert pe.optimizer.name == je.optimizer.name == "fused_adam"
    rng = np.random.default_rng(1)
    for _ in range(4):
        batch = _packed_batch(4, 16, 256, seed=int(rng.integers(1 << 30)))
        jl, pl = je.train_batch(batch=batch), pe.train_batch(batch=batch)
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
        np.testing.assert_allclose(pe.get_global_grad_norm(), je.get_global_grad_norm(),
                                   rtol=1e-5)
        assert pe.get_lr()[0] == je.get_lr()[0]
    jw = _leaf_dict(jax.tree.map(np.asarray, je.params))
    for name, w in _leaf_dict(pe.params).items():
        np.testing.assert_allclose(w.detach().numpy(), jw[name], atol=1e-4, rtol=0,
                                   err_msg=name)
    assert pe.opt_state.inner["count"] == int(je.opt_state.inner.count) == 4


def test_fused_configuration_bf16_trajectory_matches_jax():
    """bf16 params with fp32 masters: FusedAdam writes the bf16 param in the
    same pass as its master. Tolerances of the bf16 AdamW trajectory."""
    je, pe = _fused_engines("bfloat16", bf16={"enabled": True})
    rng = np.random.default_rng(2)
    for _ in range(4):
        batch = {"input_ids": rng.integers(0, 256, size=(4, 17)).astype(np.int32)}
        jl, pl = je.train_batch(batch=batch), pe.train_batch(batch=batch)
        np.testing.assert_allclose(float(pl), float(jl), rtol=2e-3)
    for (_, p), (_, m) in zip(_leaves(pe.params), _leaves(pe.opt_state.master)):
        assert p.dtype == torch.bfloat16 and torch.equal(p, m.to(torch.bfloat16))


def _imperative(engine, batch, gas):
    """gas micro-batches through forward / backward / step; the losses."""
    micro = len(batch["input_ids"]) // gas
    losses = []
    for i in range(gas):
        mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
        assert engine.is_gradient_accumulation_boundary() == (i == gas - 1)
        loss = engine.forward(mb)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
    return losses


def test_imperative_api_equals_train_batch_and_jax():
    """forward / backward / step over the micro-batches is train_batch: the
    same update inside the port bit for bit, and the JAX engine's imperative
    trajectory within the fp32 tolerances; counters as the JAX engine's."""
    je, pe = _fused_engines()
    _, pf = _fused_engines()
    rng = np.random.default_rng(4)
    for _ in range(3):
        batch = _packed_batch(4, 16, 256, seed=int(rng.integers(1 << 30)))
        fused_loss = float(pf.train_batch(batch=batch))
        pl = _imperative(pe, batch, 2)
        jl = _imperative(je, batch, 2)
        np.testing.assert_allclose(np.mean(pl), fused_loss, rtol=1e-6)
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
        np.testing.assert_allclose(pe.get_global_grad_norm(), je.get_global_grad_norm(),
                                   rtol=1e-5)
    for (name, a), (_, b) in zip(_leaves(pe.params), _leaves(pf.params)):
        assert torch.equal(a, b), name
    assert (pe.micro_steps, pe.global_steps) == (je.micro_steps, je.global_steps) == (6, 3)
    # micro-batch size times the data-parallel world: 1 in the port
    assert pe.global_samples == 12 and je.global_samples == 12 * je.topo.dp_world_size
    assert (pf.micro_steps, pf.global_steps) == (0, 3)  # train_batch counts no micro-steps


def test_no_sync_and_boundary_override():
    _, pe = _fused_engines()
    batch = _packed_batch(2, 16, 256, seed=9)
    with pe.no_sync():
        for _ in range(3):  # past gas = 2: the boundary is forced off
            pe.backward(pe.forward(batch))
            pe.step()
    assert (pe.micro_steps, pe.global_steps) == (3, 0)
    pe.set_gradient_accumulation_boundary(True)
    pe.backward(pe.forward(batch))
    pe.step()
    assert (pe.micro_steps, pe.global_steps) == (4, 1)
    assert pe.eval() is pe and pe.train() is pe


def test_training_data_loader_matches_jax():
    """``initialize(training_data=...)`` returns the loader; both packages
    draw the same epoch-seeded order, and ``train_batch(data_iter=...)``
    consumes gas micro-batches from it."""
    from deepspeed_tpu.runtime.dataloader import DeepSpeedDataLoader as JLoader
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    jc, pc = _configs()
    _, tp = _params(jc)
    data = {"input_ids": np.random.default_rng(0).integers(0, 256, size=(10, 17)).astype(np.int32)}
    cfg = _ds_config()
    pe, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=PT.make_loss_fn(pc), model_parameters=tp, config=cfg, training_data=data)
    assert loader is pe.training_dataloader and loader.batch_size == 4 and len(loader) == 2
    want = list(JLoader(data, batch_size=4, seed=pe.config.seed))
    got = list(loader)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    # a Dataset-style object through collate_fn; micro-batches to train_batch
    rows = [{"input_ids": r} for r in data["input_ids"]]
    micro = pe.deepspeed_io(rows, batch_size=2)
    it = RepeatingLoader(micro)
    losses = [float(pe.train_batch(data_iter=it)) for _ in range(3)]  # 6 of 5 batches: repeats
    assert all(np.isfinite(losses)) and pe.global_steps == 3


def test_wall_clock_breakdown_timers(caplog):
    from deepspeed_tpu.utils import timer as jt
    from deepspeed_tpu_torch.utils import timer as pt

    jc, pc = _configs()
    _, tp = _params(jc)
    pe, *_ = deepspeed_tpu_torch.initialize(
        model=PT.make_loss_fn(pc), model_parameters=tp,
        config=_ds_config(wall_clock_breakdown=True, steps_per_print=1))
    assert isinstance(pe.timers, pt.SynchronizedWallClockTimer)
    batch = _packed_batch(4, 16, 256, seed=1)
    pe.train_batch(batch=batch)
    _imperative(pe, batch, 2)
    for name in (pt.FORWARD_GLOBAL_TIMER, pt.BACKWARD_GLOBAL_TIMER, pt.STEP_GLOBAL_TIMER):
        assert name in pe.timers.get_timers()
    assert pe.tput_timer.global_step_count == 1  # train_batch steps only, as in the JAX engine
    with pytest.raises(RuntimeError, match="already been started"):
        t = pe.timers("x")
        t.start()
        t.start()
    off, *_ = deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc), model_parameters=tp,
                                             config=_ds_config())
    assert isinstance(off.timers, pt.NoopTimer) and off.timers("fwd").elapsed() == 0
    data = [5.0, 1.0, 9.0, 3.0, 100.0, 2.0]
    for pct in (0.0, 0.2, 0.5):
        assert pt.trim_mean(data, pct) == jt.trim_mean(data, pct)
    assert pt.trim_mean([], 0.1) == 0
    assert (pt.FORWARD_GLOBAL_TIMER, pt.BACKWARD_GLOBAL_TIMER, pt.STEP_GLOBAL_TIMER) == (
        jt.FORWARD_GLOBAL_TIMER, jt.BACKWARD_GLOBAL_TIMER, jt.STEP_GLOBAL_TIMER)


# ---------------------------------------------------------------------------
# splash attention through the model and the engine
# ---------------------------------------------------------------------------
SPLASH_ARCHS = {
    "splash": dict(attention_impl="splash"),
    "splash_window": dict(attention_impl="splash", n_kv_heads=2, sliding_window=8),
    "splash_block": dict(attention_impl="splash", n_kv_heads=2, sliding_window=12,
                         splash_block=8),
    "bigbird": dict(attn_sparsity=("bigbird", (("block", 8), ("num_random_blocks", 1)))),
    "fixed_splash_per_head": dict(attention_impl="splash", attn_sparsity=(
        "fixed", (("block", 8), ("num_local_blocks", 2), ("different_layout_per_head", True),
                  ("num_different_global_patterns", 2)))),
    "packed_splash_window": dict(attention_impl="splash", n_kv_heads=2, sliding_window=8),
}


@pytest.mark.parametrize("arch", sorted(SPLASH_ARCHS))
def test_splash_forward_loss_and_grads_match_jax(arch):
    """attention_impl="splash" (with and without a window, at the default
    and at an explicit splash_block) and attn_sparsity layouts (BigBird's
    random blocks; per-head Fixed layouts), packed segments too: logits of
    ``forward``, loss and every leaf's gradient of ``make_loss_fn`` against
    the JAX model, whose attention takes its Pallas splash bodies in
    interpret mode. ``forward_reference`` (the plain oracle) agrees."""
    jc, pc = _configs(**SPLASH_ARCHS[arch])
    jp, tp = _params(jc)
    rng = np.random.default_rng(len(arch) + 40)
    if arch.startswith("packed"):
        batch = _packed_batch(2, 32, jc.vocab_size, seed=3)
    else:
        batch = {"input_ids": rng.integers(0, jc.vocab_size, size=(2, 33)).astype(np.int32)}
    toks = batch["input_ids"][:, :-1]
    want = np.asarray(JT.forward(jp, jnp.asarray(toks), jc)[0])
    for fwd in (PT.forward, PT.forward_reference):
        got = fwd(tp, torch.from_numpy(toks), pc)[0]
        np.testing.assert_allclose(got.detach().numpy(), want, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    jl, jg = jax.value_and_grad(JT.make_loss_fn(jc))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    pl, pg = _port_value_and_grad(pc, tp, batch)
    np.testing.assert_allclose(pl, float(jl), rtol=LOSS_RTOL)
    jg = _leaf_dict(jax.tree.map(np.asarray, jg))
    for name, g in pg.items():
        np.testing.assert_allclose(g, jg[name], atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_splash_sparsity_is_not_the_dense_mask():
    """Control: a sparsity layout changes the logits against the dense
    causal model (so the layout cases above compare something), and the
    layout's schedule is built once for every layer and step."""
    _, pc = _configs(**SPLASH_ARCHS["bigbird"])
    _, dense = _configs()
    _, tp = _params(_configs()[0])
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 256, size=(1, 64)))
    assert (PT.forward(tp, toks, pc)[0] - PT.forward(tp, toks, dense)[0]).abs().max() > 1e-3
    assert PT._attention_schedule(pc, 64) is PT._attention_schedule(pc, 64)
    assert PT._attention_schedule(pc, 64).density < 0.5


def test_splash_engine_trajectory_matches_jax():
    """4 train_batch steps of attention_impl="splash" with a window (gas 2,
    packed micro-batches, AdamW, WarmupLR, clipping) against the JAX engine,
    in fp32."""
    over = dict(n_kv_heads=2, attention_impl="splash", sliding_window=8)
    jc, pc = _configs(**over)
    jp, tp = _params(jc)
    cfg = _ds_config()
    je, *_ = deepspeed_tpu.initialize(model=JT.make_loss_fn(jc), model_parameters=jp,
                                      config=copy.deepcopy(cfg))
    pe, *_ = deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc), model_parameters=tp,
                                            config=copy.deepcopy(cfg))
    rng = np.random.default_rng(11)
    for _ in range(4):
        batch = _packed_batch(4, 16, 256, seed=int(rng.integers(1 << 30)))
        np.testing.assert_allclose(float(pe.train_batch(batch=batch)),
                                   float(je.train_batch(batch=batch)), rtol=1e-5)
        np.testing.assert_allclose(pe.get_global_grad_norm(), je.get_global_grad_norm(),
                                   rtol=1e-5)
    jw = _leaf_dict(jax.tree.map(np.asarray, je.params))
    for name, w in _leaf_dict(pe.params).items():
        np.testing.assert_allclose(w.detach().numpy(), jw[name], atol=1e-4, rtol=0,
                                   err_msg=name)
