"""The training engine's leftovers in the port against the JAX package.

  * a client ``torch.optim.SGD(momentum=0.9)`` and ``torch.optim.AdamW``
    against the JAX engine given ``optax.sgd`` / ``optax.adamw`` (fp32, 3
    steps, gas 2, clipping), the callable form, and the engine's LR
    schedule driving the client's ``param_groups``;
  * ``grad_accum_dtype`` "bf16" at gas 4 against the JAX engine;
  * a loss that takes an rng and does not draw from it against the JAX
    engine, and the port's rng stream (a ``torch.Generator`` seeded by the
    counter hash of seed, step and micro-batch);
  * checkpoints with ``checkpoint.writer`` unset (the npz archive), a tag
    holding only an orbax store refused, ``zero_to_fp32`` against the JAX
    package's on an orbax checkpoint of the same state, its shipped copy
    run standalone, and the params-only fallback;
  * ``module_loss_fn`` against the JAX package's ``_default_loss``;
  * ``graft_entry.entry`` against the JAX forward on the same params.
"""

import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint import zero_to_fp32 as jz
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.adapters import _default_loss as jax_default_loss
from deepspeed_tpu_torch.checkpoint import zero_to_fp32 as pz
from deepspeed_tpu_torch.models import adapters
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
    TorchCheckpointEngine,
    tree_leaves,
    tree_paths,
)
from deepspeed_tpu_torch.runtime.optimizers import TorchOptimizer, _leaves


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = dict(vocab_size=256, hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2,
            max_seq_len=64, remat=False, dtype="float32")
# fp32 on both sides: the same function summed in another order
LOSS_RTOL = 1e-5
# SGD's update is linear in the gradient; AdamW divides by sqrt(v), which
# turns a 1e-7 gradient difference near 0 into up to 2 lr a step
PARAM_ATOL = {"sgd": 1e-6, "adamw": 1e-4}
STEPS = 3


def _configs(**over):
    kw = dict(BASE, **over)
    return JT.get_config("tiny", **kw), PT.get_config("tiny", **kw)


def _params(jc, seed=0):
    jp = JT.init_params(jc, jax.random.key(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _batches(n, rows=4, seed=1):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, size=(rows, 17)).astype(np.int32)}
            for _ in range(n)]


def _config(gas=2, **extra):
    return {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": gas,
            "gradient_clipping": 1.0, "steps_per_print": 1000, **extra}


def _leaf_dict(tree):
    return dict(_leaves(tree))


def _assert_params_close(pe, je, atol):
    jw = _leaf_dict(jax.tree.map(np.asarray, je.params))
    pw = _leaf_dict(pe.params)
    assert sorted(pw) == sorted(jw)
    for name, w in pw.items():
        np.testing.assert_allclose(w.detach().float().numpy(), np.asarray(jw[name], np.float32),
                                   atol=atol, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# client optimizers
# ---------------------------------------------------------------------------
CLIENTS = {
    "sgd": (lambda ps: torch.optim.SGD(ps, lr=1e-2, momentum=0.9),
            lambda: optax.sgd(1e-2, momentum=0.9)),
    "adamw": (lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=0.01),
              lambda: optax.adamw(1e-3, weight_decay=0.01)),
}


@pytest.mark.parametrize("name", sorted(CLIENTS))
def test_client_torch_optimizer_matches_jax_optax(name):
    torch_opt, optax_opt = CLIENTS[name]
    jc, pc = _configs()
    jp, tp = _params(jc)
    je, *_ = deepspeed_tpu.initialize(model=JT.make_loss_fn(jc), model_parameters=jp,
                                      optimizer=optax_opt(), config=_config())
    client = torch_opt([t for _, t in _leaves(tp)])
    pe, popt, *_ = deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc),
                                                  model_parameters=tp, optimizer=client,
                                                  config=_config())
    assert isinstance(popt, TorchOptimizer) and popt.optimizer is client
    before = {k: v.clone() for k, v in _leaf_dict(tp).items()}
    for batch in _batches(STEPS):
        jl, pl = float(je.train_batch(batch=batch)), float(pe.train_batch(batch=batch))
        np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    _assert_params_close(pe, je, PARAM_ATOL[name])
    # the client's params are the engine's fp32 masters; the user's tensors are untouched
    masters = {id(t) for _, t in _leaves(pe.opt_state.master)}
    assert all(id(p) in masters for g in client.param_groups for p in g["params"])
    for k, v in _leaf_dict(tp).items():
        assert torch.equal(v, before[k]), k


def test_client_optimizer_callable_and_frozen_leaves():
    """``optimizer=callable(params)`` builds over the engine's params and
    trains as the direct form does; leaves the optimizer does not hold stay
    frozen."""
    jc, pc = _configs()
    _, tp = _params(jc)
    direct = torch.optim.SGD([t for _, t in _leaves(tp)], lr=1e-2, momentum=0.9)
    e1, *_ = deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc), model_parameters=tp,
                                            optimizer=direct, config=_config())
    e2, *_ = deepspeed_tpu_torch.initialize(
        model=PT.make_loss_fn(pc), model_parameters=tp,
        optimizer=lambda ps: torch.optim.SGD([t for _, t in _leaves(ps)], lr=1e-2,
                                             momentum=0.9),
        config=_config())
    frozen = tp["embed"]
    e3, *_ = deepspeed_tpu_torch.initialize(
        model=PT.make_loss_fn(pc), model_parameters=tp,
        optimizer=torch.optim.SGD([t for k, t in _leaves(tp) if k != "embed"], lr=1e-2),
        config=_config())
    for batch in _batches(2):
        assert float(e1.train_batch(batch=batch)) == float(e2.train_batch(batch=batch))
        e3.train_batch(batch=batch)
    for (k, a), (_, b) in zip(_leaves(e1.params), _leaves(e2.params)):
        assert torch.equal(a, b), k
    assert torch.equal(e3.params["embed"], frozen)
    assert not torch.equal(e3.params["layers"]["wq"], tp["layers"]["wq"])
    with pytest.raises(ValueError, match="not one of model_parameters"):
        deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc), model_parameters=tp,
                                       optimizer=torch.optim.SGD([torch.zeros(3)], lr=0.1),
                                       config=_config())


def test_lr_schedule_drives_the_client_param_groups():
    """WarmupLR sets each group's lr; a second group keeps its ratio to the
    first."""
    jc, pc = _configs()
    _, tp = _params(jc)
    leaves = [t for _, t in _leaves(tp)]
    client = torch.optim.SGD([{"params": leaves[:3]}, {"params": leaves[3:], "lr": 2e-2}],
                             lr=1e-2)
    cfg = _config(scheduler={"type": "WarmupLR",
                             "params": {"warmup_num_steps": 10, "warmup_max_lr": 1e-2}})
    pe, *_ = deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc), model_parameters=tp,
                                            optimizer=client, config=cfg)
    seen = []
    for batch in _batches(3):
        pe.train_batch(batch=batch)
        lr = pe.get_lr()[0]
        seen.append(lr)
        assert client.param_groups[0]["lr"] == pytest.approx(lr, rel=1e-12)
        assert client.param_groups[1]["lr"] == pytest.approx(2 * lr, rel=1e-12)
    assert seen[0] < seen[1] < seen[2]


# ---------------------------------------------------------------------------
# grad_accum_dtype and rng-taking losses
# ---------------------------------------------------------------------------
ADAMW = {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}}


def _engines(loss_j, loss_p, cfg, jc=None, pc=None):
    if jc is None:
        jc, pc = _configs()
    jp, tp = _params(jc)
    je, *_ = deepspeed_tpu.initialize(model=loss_j, model_parameters=jp,
                                      config=copy.deepcopy(cfg))
    pe, *_ = deepspeed_tpu_torch.initialize(model=loss_p, model_parameters=tp,
                                            config=copy.deepcopy(cfg))
    return je, pe


def test_bf16_grad_accumulation_matches_jax():
    """gas 4 with the grads accumulated in bf16 (fp32 compute): each
    micro-batch's fp32 grads round to bf16 before the add, on both sides.
    Grads that differ by fp32 noise can round to neighbouring bf16 values,
    so losses are held at 1e-4 relative; the fp32-accumulated run differs
    from the bf16 one by more (the control)."""
    jc, pc = _configs()
    cfg = _config(gas=4, optimizer=ADAMW, data_types={"grad_accum_dtype": "bf16"})
    je, pe = _engines(JT.make_loss_fn(jc), PT.make_loss_fn(pc), cfg)
    assert pe.grad_accum_dtype == torch.bfloat16
    _, ref = _engines(JT.make_loss_fn(jc), PT.make_loss_fn(pc), _config(gas=4, optimizer=ADAMW))
    gap = []
    for batch in _batches(STEPS, rows=8):
        jl, pl = float(je.train_batch(batch=batch)), float(pe.train_batch(batch=batch))
        np.testing.assert_allclose(pl, jl, rtol=1e-4)
        gap.append(abs(float(ref.train_batch(batch=batch)) - pl))
    assert max(gap) > 1e-5
    _assert_params_close(pe, je, 2e-3)


def test_accumulation_buffers_take_the_configured_dtype():
    jc, pc = _configs()
    _, tp = _params(jc)
    for name, dtype in (("bf16", torch.bfloat16), ("fp16", torch.float16),
                        ("fp32", torch.float32), (None, torch.float32)):
        pe, *_ = deepspeed_tpu_torch.initialize(
            model=PT.make_loss_fn(pc), model_parameters=tp,
            config=_config(optimizer=ADAMW, data_types={"grad_accum_dtype": name}))
        _, grads = pe._micro_grads({"input_ids": torch.zeros(2, 9, dtype=torch.long)}, 1.0)
        acc = pe._accumulate(None, grads)
        assert {a.dtype for _, a in _leaves(acc)} == {dtype}


def test_rng_loss_that_does_not_draw_matches_jax():
    jc, pc = _configs()
    j_loss, p_loss = JT.make_loss_fn(jc), PT.make_loss_fn(pc)
    seen = []

    def jax_rng_loss(params, batch, rng):
        return j_loss(params, batch)

    def port_rng_loss(params, batch, rng):
        seen.append(rng)
        return p_loss(params, batch)

    je, pe = _engines(jax_rng_loss, port_rng_loss, _config(optimizer=ADAMW))
    assert je._loss_fn_takes_rng and pe._loss_takes_rng
    for batch in _batches(STEPS):
        np.testing.assert_allclose(float(pe.train_batch(batch=batch)),
                                   float(je.train_batch(batch=batch)), rtol=LOSS_RTOL)
    assert len(seen) == 2 * STEPS
    assert all(isinstance(g, torch.Generator) and g.device == pe.device for g in seen)


def _draws(seed, steps=2, gas=2):
    jc, pc = _configs()
    _, tp = _params(jc)
    p_loss = PT.make_loss_fn(pc)
    draws = []

    def loss(params, batch, rng=None):
        draws.append(torch.randint(0, 1 << 30, (4,), generator=rng).tolist())
        return p_loss(params, batch)

    pe, *_ = deepspeed_tpu_torch.initialize(model=loss, model_parameters=tp,
                                            config=_config(gas=gas, optimizer=ADAMW, seed=seed))
    for batch in _batches(steps):
        pe.train_batch(batch=batch)
    pe.forward(_batches(1)[0])  # the imperative path: step 2, micro-batch 0
    return draws


def test_rng_stream_repeats_for_a_seed_and_differs_across_steps():
    a, b, c = _draws(7), _draws(7), _draws(8)
    assert a == b
    assert a != c
    # (step 0, micro 0/1), (step 1, micro 0/1), (step 2, micro 0): all distinct
    assert len({tuple(d) for d in a}) == len(a) == 5


# ---------------------------------------------------------------------------
# checkpoints: the default store and zero_to_fp32
# ---------------------------------------------------------------------------
BF16 = {"bf16": {"enabled": True}}


def _bf16_engines():
    jc, pc = _configs(dtype="bfloat16")
    cfg = _config(optimizer=ADAMW, **BF16)
    return _engines(JT.make_loss_fn(jc), PT.make_loss_fn(pc), cfg, jc, pc), pc


def test_default_store_round_trip(tmp_path):
    """checkpoint.writer unset: the npz archive with its names, the recovery
    script and ``latest``; a fresh engine loads params, masters, moments and
    count bit for bit and takes the same next step."""
    (_, pe), pc = _bf16_engines()
    batches = _batches(3)
    for batch in batches[:2]:
        pe.train_batch(batch=batch)
    assert pe.config.checkpoint.writer is None
    pe.save_checkpoint(str(tmp_path))
    tag = (tmp_path / "latest").read_text()
    assert tag == "global_step2"
    assert sorted(os.listdir(tmp_path / tag)) == ["state.meta.json", "state.names.json",
                                                   "state.npz"]
    assert (tmp_path / "zero_to_fp32.py").is_file()
    jc, _ = _configs(dtype="bfloat16")
    _, fresh = _engines(JT.make_loss_fn(jc), PT.make_loss_fn(pc),
                        _config(optimizer=ADAMW, **BF16))
    path, client = fresh.load_checkpoint(str(tmp_path))
    assert path.endswith(tag) and fresh.global_steps == 2
    for (k, a), (_, b) in zip(_leaves(pe.params), _leaves(fresh.params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), k
    for tree in ("master", "mu", "nu"):
        src = pe.opt_state.master if tree == "master" else pe.opt_state.inner[tree]
        dst = fresh.opt_state.master if tree == "master" else fresh.opt_state.inner[tree]
        for (k, a), (_, b) in zip(_leaves(src), _leaves(dst)):
            assert torch.equal(a, b), (tree, k)
    assert fresh.opt_state.inner["count"] == pe.opt_state.inner["count"] == 2
    assert float(fresh.train_batch(batch=batches[2])) == float(pe.train_batch(batch=batches[2]))


def test_damaged_archive_is_refused(tmp_path):
    """The reader maps the archive instead of copying it, and still checks
    every entry's CRC: one flipped bit in a leaf's data is refused."""
    import zipfile

    (_, pe), _ = _bf16_engines()
    pe.save_checkpoint(str(tmp_path))
    archive = tmp_path / "global_step0" / "state.npz"
    raw = bytearray(archive.read_bytes())
    with zipfile.ZipFile(archive) as zf:
        info = zf.getinfo("params::000000.npy")
    assert info.file_size > 4096  # the embedding, [256, 64] bf16
    raw[info.header_offset + 2048] ^= 1  # a bit of its data
    archive.write_bytes(bytes(raw))
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        pe.load_checkpoint(str(tmp_path))


def test_client_optimizer_state_round_trips(tmp_path):
    jc, pc = _configs()
    _, tp = _params(jc)

    def engine():
        return deepspeed_tpu_torch.initialize(
            model=PT.make_loss_fn(pc), model_parameters=tp,
            optimizer=lambda ps: torch.optim.AdamW([t for _, t in _leaves(ps)], lr=1e-3),
            config=_config())[0]

    pe = engine()
    batches = _batches(3)
    for batch in batches[:2]:
        pe.train_batch(batch=batch)
    pe.save_checkpoint(str(tmp_path))
    fresh = engine()
    fresh.load_checkpoint(str(tmp_path))
    want, got = pe.optimizer.optimizer.state_dict()["state"], \
        fresh.optimizer.optimizer.state_dict()["state"]
    assert sorted(want) == sorted(got)
    for i in want:
        for key in want[i]:
            assert torch.equal(want[i][key], got[i][key]), (i, key)
    assert float(fresh.train_batch(batch=batches[2])) == float(pe.train_batch(batch=batches[2]))


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """One JAX engine state (bf16, one AdamW step) saved twice: in orbax
    (its default store) and in the npz archive."""
    jc, pc = _configs(dtype="bfloat16")
    jp, _ = _params(jc)
    je, *_ = deepspeed_tpu.initialize(model=JT.make_loss_fn(jc), model_parameters=jp,
                                      config=_config(optimizer=ADAMW, **BF16))
    je.train_batch(batch=_batches(1)[0])
    root = tmp_path_factory.mktemp("jax_saved")
    je.save_checkpoint(str(root / "orbax"))
    je.config.checkpoint.writer = "sync"
    je.save_checkpoint(str(root / "npz"))
    return root, pc


def test_orbax_only_tag_is_refused(jax_saved):
    root, pc = jax_saved
    assert (root / "orbax" / "global_step1" / "state").is_dir()
    (_, pe), _ = _bf16_engines()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        pe.load_checkpoint(str(root / "orbax"))


def test_zero_to_fp32_matches_jax_on_the_same_state(jax_saved, tmp_path):
    """The port loads the JAX engine's npz archive and saves it with its
    default store. The port's zero_to_fp32 equals JAX's on the orbax store
    of the same state: the same names, fp32 values equal (the masters,
    which differ from the bf16 params), and equal to the port engine's
    masters."""
    root, _ = jax_saved
    (_, pe), _ = _bf16_engines()
    pe.config.checkpoint.writer = "sync"
    pe.load_checkpoint(str(root / "npz"))
    pe.config.checkpoint.writer = None
    pe.save_checkpoint(str(tmp_path / "port"))
    want = jz.get_fp32_state_dict_from_zero_checkpoint(str(root / "orbax"))
    got = pz.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path / "port"))
    assert sorted(got) == sorted(want)
    masters = dict(zip(tree_paths(pe.opt_state.master), tree_leaves(pe.opt_state.master)))
    params = {k.replace("/", "."): v.detach().float().numpy() for k, v in _leaves(pe.params)}
    differs = False
    for name, w in want.items():
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], w, err_msg=name)
        np.testing.assert_array_equal(got[name], masters[name].numpy(), err_msg=name)
        differs |= not np.array_equal(got[name], params[name])
    assert differs  # the masters were taken, not the bf16 params


def test_shipped_script_runs_standalone(tmp_path):
    (_, pe), _ = _bf16_engines()
    pe.train_batch(batch=_batches(1)[0])
    ckpt = tmp_path / "ckpt"
    pe.save_checkpoint(str(ckpt))
    work = tmp_path / "elsewhere"
    work.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(ckpt / "zero_to_fp32.py"), str(ckpt),
                          str(work / "fp32")], cwd=work, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = np.load(work / "fp32.npz")
    want = pz.get_fp32_state_dict_from_zero_checkpoint(str(ckpt))
    assert sorted(got.files) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_zero_to_fp32_casts_params_without_masters(tmp_path):
    x = (torch.randn(3, 4) * 3).bfloat16()
    y = torch.randn(5)
    tag = tmp_path / "t1"
    TorchCheckpointEngine().save({"params": {"b": y, "a": {"x": x}}, "__meta__": {}},
                                 str(tag / "state"))
    (tmp_path / "latest").write_text("t1")
    got = pz.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path))
    assert sorted(got) == ["a.x", "b"]
    np.testing.assert_array_equal(got["a.x"], x.float().numpy())
    np.testing.assert_array_equal(got["b"], y.numpy())


# ---------------------------------------------------------------------------
# module_loss_fn and graft_entry
# ---------------------------------------------------------------------------
class _TinyLM(torch.nn.Module):
    def __init__(self, vocab=32, h=16):
        super().__init__()
        self.embed = torch.nn.Embedding(vocab, h)
        self.head = torch.nn.Linear(h, vocab)

    def forward(self, x):
        return self.head(torch.tanh(self.embed(x)))


def test_default_loss_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 9, 32)).astype(np.float32)
    labels = rng.integers(0, 32, size=(2, 9)).astype(np.int64)
    labels[0, 3] = labels[1, 7] = -100
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32)
    for batch in ({"labels": labels}, {"labels": labels, "loss_mask": mask}):
        want = float(jax_default_loss(jnp.asarray(logits), {k: jnp.asarray(v)
                                                            for k, v in batch.items()}))
        got = float(adapters._default_loss(torch.from_numpy(logits),
                                           {k: torch.from_numpy(v) for k, v in batch.items()}))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    y = rng.normal(size=(4, 3)).astype(np.float32)
    out = rng.normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(adapters._default_loss(torch.from_numpy(out), {"y": torch.from_numpy(y)})),
        float(jax_default_loss(jnp.asarray(out), {"y": jnp.asarray(y)})), rtol=1e-6)


def test_module_loss_fn_trains_an_nn_module():
    torch.manual_seed(0)
    module = _TinyLM()
    params = {k: v.detach().clone() for k, v in module.named_parameters()}
    toks = np.random.default_rng(4).integers(0, 32, size=(4, 9))
    batch = {"input_ids": toks, "labels": toks}
    loss_fn = deepspeed_tpu_torch.models.module_loss_fn(module)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        want = float(adapters._default_loss(module(tb["input_ids"]), tb))
    with torch.no_grad():
        assert float(loss_fn(params, tb)) == want
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=loss_fn, model_parameters=params,
        config={"train_micro_batch_size_per_gpu": 4,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}})
    losses = [float(eng.train_batch(batch=batch)) for _ in range(4)]
    assert losses[0] == pytest.approx(want, rel=1e-6) and losses[-1] < losses[0]


def test_graft_entry_matches_jax_forward():
    from deepspeed_tpu_torch.graft_entry import ENTRY_OVERRIDES, entry

    fn, (params, tokens) = entry(device="cpu", dtype="float32")
    assert tuple(tokens.shape) == (2, 128) and fn.config.head_dim == 64
    np.testing.assert_array_equal(
        tokens.numpy(), np.random.default_rng(0).integers(0, fn.config.vocab_size, size=(2, 128)))
    jc = JT.get_config("tiny", dtype="float32", **ENTRY_OVERRIDES)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    with torch.no_grad():
        got = fn(params, tokens).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JT.forward(jp, jnp.asarray(tokens.numpy()), jc)[0])
    assert got.shape == (2, 128, fn.config.vocab_size)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
