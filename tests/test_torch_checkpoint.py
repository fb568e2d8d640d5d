"""Checkpoints between the port and the JAX package.

Both engines write the same archive with ``checkpoint.writer = "sync"``
(``<dir>/<tag>/state.npz`` of ``section::000042.npy`` entries in the JAX
package's tree-flatten order, ``state.meta.json``, a ``latest`` marker), so
each loads the other's: after a load the next step's loss equals the
writer's next step (fp32 tolerance: the same function in another
framework), and inside the port a reload continues bit for bit. bf16 leaves
travel as 2-byte void entries in both directions without ``ml_dtypes``.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.runtime import checkpoint_engine as pce
from deepspeed_tpu_torch.runtime.checkpoint_engine import checkpoint_engine as pce_mod
from deepspeed_tpu_torch.runtime.optimizers import _leaves


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = dict(vocab_size=256, hidden_size=64, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=64,
            remat=False)
OPTIMIZERS = {
    "fused_adam": {"type": "FusedAdam", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "adamw": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "sgd_momentum": {"type": "SGD", "params": {"lr": 1e-2, "momentum": 0.9}},
    "lion": {"type": "Lion", "params": {"lr": 1e-4}},
}


def _config(opt="fused_adam", writer="sync", **extra):
    return {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "optimizer": copy.deepcopy(OPTIMIZERS[opt]),
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_num_steps": 5, "warmup_max_lr": 1e-3}},
            "gradient_clipping": 1.0, "steps_per_print": 1000,
            "checkpoint": {"writer": writer}, **extra}


def _jax_engine(cfg, seed=0, dtype="float32", fused_ce=True):
    jc = JT.get_config("tiny", dtype=dtype, fused_ce=fused_ce, **BASE)
    je, *_ = deepspeed_tpu.initialize(model=JT.make_loss_fn(jc),
                                      model_parameters=JT.init_params(jc, jax.random.key(seed)),
                                      config=copy.deepcopy(cfg))
    return je


def _port_engine(cfg, seed=0, dtype="float32", fused_ce=True):
    pc = PT.get_config("tiny", dtype=dtype, fused_ce=fused_ce, **BASE)
    jc = JT.get_config("tiny", dtype=dtype, **BASE)
    tp = params_from_numpy(jax.tree.map(np.asarray, JT.init_params(jc, jax.random.key(seed))))
    pe, *_ = deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc), model_parameters=tp,
                                            config=copy.deepcopy(cfg))
    return pe


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, size=(4, 17)).astype(np.int32)} for _ in range(n)]


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_port_loads_a_jax_checkpoint(tmp_path, opt):
    cfg = _config(opt)
    je = _jax_engine(cfg)
    b = _batches(4)
    for x in b[:2]:
        je.train_batch(batch=x)
    je.save_checkpoint(str(tmp_path), client_state={"note": "from jax"})
    pe = _port_engine(cfg, seed=1)  # other weights: the load must replace them
    path, client = pe.load_checkpoint(str(tmp_path))
    assert path == os.path.join(str(tmp_path), "global_step2") and client["note"] == "from jax"
    assert (pe.global_steps, pe.micro_steps) == (2, 0)
    for x in b[2:]:
        np.testing.assert_allclose(float(pe.train_batch(batch=x)),
                                   float(je.train_batch(batch=x)), rtol=1e-5)
        assert pe.get_lr()[0] == je.get_lr()[0]  # the scheduler's state came along
    assert pe.global_steps == je.global_steps == 4


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_jax_loads_a_port_checkpoint(tmp_path, opt):
    cfg = _config(opt)
    pe = _port_engine(cfg)
    b = _batches(4, seed=1)
    for x in b[:2]:
        pe.train_batch(batch=x)
    assert pe.save_checkpoint(str(tmp_path), tag="handover")
    assert open(tmp_path / "latest").read() == "handover"
    je = _jax_engine(cfg, seed=1)
    path, client = je.load_checkpoint(str(tmp_path))
    assert path.endswith("handover") and client["global_steps"] == 2
    for x in b[2:]:
        np.testing.assert_allclose(float(je.train_batch(batch=x)),
                                   float(pe.train_batch(batch=x)), rtol=1e-5)
        assert pe.get_lr()[0] == je.get_lr()[0]


def test_archives_have_one_layout(tmp_path):
    """Entry for entry: the same names, shapes and dtypes from both engines
    after the same two steps, values within the trajectory tolerance."""
    cfg = _config("fused_adam", fp16={"enabled": True, "initial_scale_power": 8})
    je, pe = _jax_engine(cfg, dtype="float16"), _port_engine(cfg, dtype="float16")
    for x in _batches(2):
        je.train_batch(batch=x)
        pe.train_batch(batch=x)
    je.save_checkpoint(str(tmp_path / "j"), tag="t")
    pe.save_checkpoint(str(tmp_path / "p"), tag="t")
    ja = np.load(tmp_path / "j" / "t" / "state.npz")
    pa = np.load(tmp_path / "p" / "t" / "state.npz")
    assert ja.files == pa.files
    assert any(k.startswith("scaler_state::") for k in ja.files)
    for k in ja.files:
        assert ja[k].shape == pa[k].shape and ja[k].dtype == pa[k].dtype, k
        np.testing.assert_allclose(pa[k].astype(np.float32), ja[k].astype(np.float32),
                                   atol=2e-3, rtol=2e-3, err_msg=k)
    jm = json.load(open(tmp_path / "j" / "t" / "state.meta.json"))
    pm = json.load(open(tmp_path / "p" / "t" / "state.meta.json"))
    assert sorted(jm) == sorted(pm) and pm["global_steps"] == 2
    assert pm["lr_scheduler"] == jm["lr_scheduler"]


def test_port_resume_is_bit_exact(tmp_path):
    cfg = _config("fused_adam")
    b = _batches(5, seed=2)
    whole = _port_engine(cfg)
    want = [float(whole.train_batch(batch=x)) for x in b]
    first = _port_engine(cfg)
    for x in b[:3]:
        first.train_batch(batch=x)
    first.save_checkpoint(str(tmp_path))
    second = _port_engine(cfg, seed=3)
    second.load_checkpoint(str(tmp_path))
    got = [float(second.train_batch(batch=x)) for x in b[3:]]
    assert got == want[3:]
    for (name, a), (_, c) in zip(_leaves(second.params), _leaves(whole.params)):
        assert torch.equal(a, c), name
    assert second.opt_state.inner["count"] == 5


def test_bf16_leaves_cross_both_ways_without_ml_dtypes(tmp_path):
    """A bf16 leaf is a 2-byte void entry ('<V2') in the JAX package's
    archive. The port reads it through its bits and writes the same bytes.
    (The JAX engine cannot read such an entry back, its own included: its
    restore hands the void array to ``jnp.asarray``, ROADMAP section 3.)"""
    cfg = _config("fused_adam", bf16={"enabled": True})
    je = _jax_engine(cfg, dtype="bfloat16")
    je.train_batch(batch=_batches(1)[0])
    je.save_checkpoint(str(tmp_path / "j"), tag="t")
    pe = _port_engine(cfg, seed=1, dtype="bfloat16")
    pe.load_checkpoint(str(tmp_path / "j"), tag="t")
    jw = dict(_leaves(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), je.params)))
    for name, w in _leaves(pe.params):
        assert w.dtype == torch.bfloat16
        np.testing.assert_array_equal(w.detach().float().numpy(), jw[name], err_msg=name)
    pe.save_checkpoint(str(tmp_path / "p"), tag="t")
    ja = np.load(tmp_path / "j" / "t" / "state.npz")
    pa = np.load(tmp_path / "p" / "t" / "state.npz")
    assert ja.files == pa.files
    for k in ja.files:
        assert ja[k].dtype == pa[k].dtype, k
        if k.startswith("params::"):
            assert ja[k].dtype == np.dtype("V2")
            np.testing.assert_array_equal(ja[k].view(np.uint16), pa[k].view(np.uint16), err_msg=k)
    with pytest.raises(ValueError, match="No cast function"):  # the JAX-side fault, pinned
        je.load_checkpoint(str(tmp_path / "j"), tag="t")
    t = torch.randn(5, 3).to(torch.bfloat16)
    assert torch.equal(pce_mod.numpy_to_tensor(pce_mod.tensor_to_numpy(t)), t)


@pytest.mark.parametrize("writer", ["async", "fast", "decoupled", "torch"])
def test_writers_two_phase_commit(tmp_path, writer):
    cfg = _config("adamw", writer=writer)
    pe = _port_engine(cfg, fused_ce=False)
    b = _batches(3, seed=4)
    pe.train_batch(batch=b[0])
    pe.save_checkpoint(str(tmp_path), tag="one")
    if writer in ("async", "fast", "decoupled"):
        # the tag publishes at the next save or an explicit commit
        assert not (tmp_path / "latest").exists()
        pe.train_batch(batch=b[1])
        pe.save_checkpoint(str(tmp_path), tag="two")
        assert open(tmp_path / "latest").read() == "one"
        pe.checkpoint_commit()
        assert open(tmp_path / "latest").read() == "two"
        assert pe._ckpt_writer.in_flight == 0
    else:
        assert open(tmp_path / "latest").read() == "one"
    name = "state.rank0.npz" if writer == "decoupled" else "state.npz"
    assert (tmp_path / "one" / name).exists()
    want = float(pe.train_batch(batch=b[2]))
    again = _port_engine(cfg, seed=5, fused_ce=False)
    again.load_checkpoint(str(tmp_path))
    assert float(again.train_batch(batch=b[2])) == want


def test_load_options_and_missing_latest(tmp_path):
    cfg = _config("adamw")
    pe = _port_engine(cfg, fused_ce=False)
    assert pe.load_checkpoint(str(tmp_path)) == (None, {})
    for x in _batches(2, seed=6):
        pe.train_batch(batch=x)
    pe.save_checkpoint(str(tmp_path), save_latest=False, tag="quiet")
    assert not (tmp_path / "latest").exists()
    other = _port_engine(cfg, seed=2, fused_ce=False)
    other.load_checkpoint(str(tmp_path), tag="quiet", load_module_only=True)
    assert other.global_steps == 0 and other.opt_state.inner["count"] == 0
    for (name, a), (_, c) in zip(_leaves(other.params), _leaves(pe.params)):
        assert torch.equal(a, c), name
    wrong = _port_engine(_config("lion"), fused_ce=False)
    with pytest.raises(ValueError, match="leaf count"):
        wrong.load_checkpoint(str(tmp_path), tag="quiet")


def test_registry_and_save_16bit_model(tmp_path):
    calls = []

    class Spy(pce.TorchCheckpointEngine):
        def save(self, state_dict, path):
            calls.append(path)
            super().save(state_dict, path)

    pce.register_checkpoint_engine("spy", Spy)
    with pytest.raises(ValueError, match="already registered"):
        pce.register_checkpoint_engine("spy", Spy)
    with pytest.raises(TypeError, match="subclass"):
        pce.register_checkpoint_engine("bad", dict)
    with pytest.raises(ValueError, match="unknown checkpoint engine"):
        pce.create_checkpoint_engine("nope")
    try:
        pe = _port_engine(_config("adamw", writer="spy", bf16={"enabled": True}),
                          dtype="bfloat16", fused_ce=False)
        pe.save_checkpoint(str(tmp_path), tag="x")
        assert calls == [os.path.join(str(tmp_path), "x", "state")]
        assert not (tmp_path / "latest").exists()  # only sync/torch commit by themselves
        pe.checkpoint_commit()
        assert open(tmp_path / "latest").read() == "x"
        out = pe.save_16bit_model(str(tmp_path / "export"))
        assert out.endswith("pytorch_model.npz")
        flat = np.load(out)
        assert "layers.wq" in flat.files and flat["layers.wq"].dtype == np.dtype("V2")
        back = pce_mod.numpy_to_tensor(flat["embed"])
        assert torch.equal(back, pe.params["embed"].detach())
    finally:
        pce_mod.ENGINES.pop("spy", None)
