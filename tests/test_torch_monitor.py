"""Monitors in the port's training engine against the JAX engine's.

Both engines train the same tiny fp32 model (``tests/test_torch_train.py``'s
helpers: the JAX package's seeded weights carried over by
``params_from_numpy``) on the same numpy batches with a ``csv_monitor`` and
a ``prometheus`` section. The events land at the same print steps, under
the same names and sample counts, with values equal within fp32 tolerance
(loss rtol 1e-5, the grad norm 1e-4 relative: the same reduction summed in
another order; lr and loss scale exactly). A monitor whose package is
missing warns and training goes on; so does one whose writes fail.
"""

import copy
import csv
import sys

import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu_torch.models import transformer as PT
from tests.test_torch_train import _configs, _ds_config, _params

LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
STEPS = 4
EVENTS = ("Train_Samples_train_loss", "Train_Samples_lr", "Train_Samples_grad_norm",
          "Train_Samples_loss_scale")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the CPU tests run in parallel workers, and tiny
    ops gain nothing from a thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(tmp_path, extra, steps=STEPS):
    """Both engines through ``train_batch`` with monitors writing under
    ``tmp_path/<package>``; returns {package: engine}."""
    jc, pc = _configs(n_kv_heads=2)
    jp, tp = _params(jc)
    rng = np.random.default_rng(3)
    batches = [{"input_ids": rng.integers(0, jc.vocab_size, size=(4, 17)).astype(np.int32)}
               for _ in range(steps)]
    out = {}
    for name, init, loss_fn, params in (
            ("jax", deepspeed_tpu.initialize, JT.make_loss_fn(jc), jp),
            ("port", deepspeed_tpu_torch.initialize, PT.make_loss_fn(pc), tp)):
        d = str(tmp_path / name)
        cfg = _ds_config(steps_per_print=2, **copy.deepcopy(extra(d)))
        eng, *_ = init(model=loss_fn, model_parameters=params, config=cfg)
        for b in batches:
            eng.train_batch(batch=b)
        out[name] = eng
    return out


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], [(int(r[0]), float(r[1])) for r in rows[1:]]


def _assert_values(name, got, want):
    for (gs, gv), (ws, wv) in zip(got, want, strict=True):
        assert gs == ws, name
        if name.endswith("grad_norm"):
            np.testing.assert_allclose(gv, wv, rtol=NORM_RTOL, err_msg=name)
        elif name.endswith("train_loss"):
            np.testing.assert_allclose(gv, wv, rtol=LOSS_RTOL, err_msg=name)
        else:
            assert gv == wv, name


def test_csv_and_prometheus_events_match_jax(tmp_path):
    engs = _train(tmp_path, lambda d: {
        "csv_monitor": {"enabled": True, "output_path": d, "job_name": "run"},
        "prometheus": {"enabled": True, "output_path": d, "job_name": "run"}})
    files = {}
    for name in ("jax", "port"):
        run = tmp_path / name / "run"
        files[name] = sorted(p.name for p in run.iterdir())
    assert files["port"] == files["jax"] == sorted(f"{e}.csv" for e in EVENTS)
    for event in EVENTS:
        jh, jrows = _read_csv(tmp_path / "jax" / "run" / f"{event}.csv")
        ph, prows = _read_csv(tmp_path / "port" / "run" / f"{event}.csv")
        assert ph == jh
        assert len(prows) == STEPS // 2  # the print steps: 2 and 4
        _assert_values(event, prows, jrows)
    # the Prometheus textfile: the same names, the same last steps
    jt = (tmp_path / "jax" / "run.prom").read_text().splitlines()
    pt = (tmp_path / "port" / "run.prom").read_text().splitlines()
    assert [line.split()[0] for line in pt] == [line.split()[0] for line in jt]
    assert [line for line in pt if "_last_step" in line] == \
        [line for line in jt if "_last_step" in line]
    pe = engs["port"]
    assert pe.monitor.enabled and pe.global_steps == STEPS
    # the monitor turned the norm on (auto), as in the JAX engine
    assert np.isfinite(float(pe.get_global_grad_norm()))


def test_missing_tensorboard_warns_and_trains(tmp_path, monkeypatch):
    """TensorBoard without its package: the writer disables itself with a
    warning and the engine trains; the csv writer beside it still writes."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "tensorboard", None)
    engs = _train(tmp_path, lambda d: {
        "tensorboard": {"enabled": True, "output_path": d, "job_name": "tb"},
        "csv_monitor": {"enabled": True, "output_path": d, "job_name": "run"}}, steps=2)
    pe = engs["port"]
    assert not pe.monitor.tb_monitor.enabled and pe.monitor.csv_monitor.enabled
    assert not (tmp_path / "port" / "tb").exists()
    assert (tmp_path / "port" / "run" / "Train_Samples_train_loss.csv").exists()
    assert pe.global_steps == engs["jax"].global_steps == 2


def test_a_failing_monitor_never_stops_training(tmp_path):
    """A writer that raises on every write: the steps still run and their
    losses equal those of an engine without monitors."""
    jc, pc = _configs(n_kv_heads=2)
    _, tp = _params(jc)
    rng = np.random.default_rng(4)
    batch = {"input_ids": rng.integers(0, jc.vocab_size, size=(4, 17)).astype(np.int32)}
    losses = []
    for monitored in (False, True):
        extra = ({"csv_monitor": {"enabled": True, "output_path": str(tmp_path),
                                  "job_name": "x"}} if monitored else {})
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=PT.make_loss_fn(pc), model_parameters=copy.deepcopy(tp),
            config=_ds_config(steps_per_print=1, monitor_grad_norm=True, **extra))
        if monitored:
            def broken(events):
                raise OSError("disk full")

            eng.monitor.write_events = broken
        losses.append([float(eng.train_batch(batch=batch)) for _ in range(2)])
    assert losses[0] == losses[1]


def test_no_monitor_section_means_a_disabled_master():
    """Without a monitor section the master is built and disabled, and the
    grad norm stays off (auto), as in the JAX engine."""
    jc, pc = _configs()
    _, tp = _params(jc)
    eng, *_ = deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(pc), model_parameters=tp,
                                             config=_ds_config(gradient_clipping=0.0))
    assert eng.monitor is not None and not eng.monitor.enabled
    assert eng._grad_epilogue_flags()[1] is False
