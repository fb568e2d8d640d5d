"""``train_batch`` with context parallelism: the loopback form and gloo processes.

A tiny fp32 model (the JAX package's ``TestModelContextParallel`` config:
vocab 64, h 32, 4 heads; here 2 layers) trains 3 steps:

  * in one process on a loopback ``Topology(context=4)`` passed as ``mpu``
    (the ring's N ranks driven in lock-step);
  * in 4 gloo processes with ``"mesh": {"data": 2, "context": 2}`` and with
    ``{"context": 4}`` in the config: every rank gets the global batch,
    takes its data rows and its context chunk, and the ring runs over
    ``comm.ppermute`` (ranks are fresh interpreters running this file, as
    in ``test_torch_comm.py``: a FileStore rendezvous under ``tmp_path``, a
    60 s process-group timeout, a join limit per rank);

and each run's per-step losses must equal the port's single-process run
(``attention_impl="auto"``, the reference attention on the CPU) within
1e-6 and the JAX package's single-device engine within 1e-5, relative
(fp32: the same function summed in another order), and the final
parameters must be
equal on every rank bit for bit. One batch masks most of one data rank's
tokens and few of the other's, which pins the global masked mean. The
refusals (other mesh axes, ZeRO above 0 across processes, a ring with a
window, non-causal, or ALiBi) raise.
"""

import copy
import json
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch.models import transformer as PT  # noqa: E402
from deepspeed_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from deepspeed_tpu_torch.parallel.topology import (  # noqa: E402
    Topology,
    get_topology,
    reset_topology,
)
from deepspeed_tpu_torch.utils.tree import leaves as _leaves  # noqa: E402
from deepspeed_tpu_torch.utils.tree import tree_map  # noqa: E402

MODEL = dict(vocab_size=64, hidden_size=32, n_layers=2, n_heads=4, max_seq_len=64,
             dtype="float32", remat=False)
SEQ, MICRO, GAS, STEPS = 32, 2, 2, 3
# relative: fp32 losses of ~4.6 (an ulp is 4.8e-7) whose gradients and
# masked sums add over ranks, and whose attention sums over chunks, in
# another order than one process's
LOSS_PORT_RTOL, LOSS_JAX_RTOL = 1e-6, 1e-5
JOIN_S = 150


def ds_config(micro, **extra):
    return {
        "train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": GAS,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-2, "weight_decay": 0.01}},
        "gradient_clipping": 1.0, "zero_optimization": {"stage": 0}, "steps_per_print": 1000,
        **extra,
    }


def batches(rows, masked):
    """STEPS global batches of ``rows`` rows; with ``masked`` a loss mask
    that keeps 3 tokens of each row in the first half of every micro-batch
    and all of the second half's (so two data ranks hold very different
    token counts)."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        b = {"input_ids": rng.integers(0, MODEL["vocab_size"], size=(rows, SEQ + 1))}
        if masked:
            mask = np.ones((rows, SEQ + 1), np.float32)
            per_micro = rows // GAS
            for m in range(GAS):
                lo = m * per_micro
                mask[lo:lo + per_micro // 2, 4:] = 0.0
            b["loss_mask"] = mask
        out.append(b)
    return out


def init_params(path):
    """Seeded port params, saved for the child processes."""
    cfg = PT.get_config("tiny", **MODEL)
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat = {name: t.numpy() for name, t in _leaves(params)}
    np.savez(path, **flat)
    return cfg, params


def load_params(path):
    flat = dict(np.load(path))
    tree = {}
    for name, a in flat.items():
        node = tree
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a
    return params_from_numpy(tree)


def train(engine, rows, masked):
    return [float(engine.train_batch(batch={k: torch.as_tensor(v) for k, v in b.items()}))
            for b in batches(rows, masked)]


# ---------------------------------------------------------------------------
# the worker (run in the child processes)
# ---------------------------------------------------------------------------
def worker(rank, world, tmp, scenario):
    from deepspeed_tpu_torch import comm

    torch.set_num_threads(1)
    store = torch.distributed.FileStore(str(Path(tmp) / "store"), world)
    comm.init_distributed(dist_backend="gloo", store=store, world_size=world, rank=rank,
                          timeout=timedelta(seconds=60))
    spec = json.loads(scenario)
    mesh, masked = spec["mesh"], spec["masked"]
    cfg = PT.get_config("tiny", **MODEL, **spec.get("model", {}))
    out = {}
    if spec.get("refusals"):
        for name, (over, model) in spec["refusals"].items():
            try:
                c = PT.get_config("tiny", **MODEL, **model)
                eng, *_ = deepspeed_tpu_torch.initialize(
                    model=PT.make_loss_fn(c), model_parameters=load_params(Path(tmp) / "p.npz"),
                    config=ds_config(MICRO, mesh=mesh, **over))
                train(eng, MICRO * GAS * mesh.get("data", 1), masked)
                out[name] = np.array("no error")
            except NotImplementedError as e:
                out[name] = np.array(str(e))
        np.savez(Path(tmp) / f"rank{rank}.npz", **out)
        return
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=PT.make_loss_fn(cfg), model_parameters=load_params(Path(tmp) / "p.npz"),
        config=ds_config(MICRO, mesh=mesh))
    topo = get_topology()
    assert topo.distributed and topo.process_count == world and not topo.loopback
    out["losses"] = np.array(train(eng, MICRO * GAS * mesh.get("data", 1), masked))
    out.update({"p/" + name: t.detach().numpy() for name, t in _leaves(eng.params)})
    np.savez(Path(tmp) / f"rank{rank}.npz", **out)


def spawn(world, tmp_path, spec):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, "-S", __file__, str(r), str(world), str(tmp_path),
                               json.dumps(spec)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    errors = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=JOIN_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"rank {r} did not finish in {JOIN_S} s")
        if p.returncode != 0:
            errors.append(f"rank {r} exit {p.returncode}:\n{err[-3000:]}")
    assert not errors, "\n".join(errors)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


# ---------------------------------------------------------------------------
# the single-process references
# ---------------------------------------------------------------------------
def port_losses(params, rows, masked, mpu=None, attention_impl="auto"):
    """The port in one process on the same global batches (micro-batch =
    the global micro-batch's rows)."""
    cfg = PT.get_config("tiny", **dict(MODEL, attention_impl=attention_impl))
    reset_topology()
    try:
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=PT.make_loss_fn(cfg), model_parameters=params,
            config=ds_config(rows // GAS), mpu=mpu)
        return train(eng, rows, masked), eng
    finally:
        reset_topology()


def jax_losses(params, rows, masked):
    """The JAX package's engine on one device, same params and batches."""
    import jax

    import deepspeed_tpu
    from deepspeed_tpu.models import transformer as JT
    from deepspeed_tpu.parallel.topology import Topology as JTopology
    from deepspeed_tpu.parallel.topology import reset_topology as jreset

    jc = JT.get_config("tiny", **MODEL)
    jp = tree_map(lambda t: jax.numpy.asarray(t.detach().numpy()), params)
    jreset()
    try:
        je, *_ = deepspeed_tpu.initialize(
            model=JT.make_loss_fn(jc), model_parameters=jp,
            config=copy.deepcopy(ds_config(rows // GAS)),
            mpu=JTopology(data=1, devices=jax.devices()[:1]))
        return [float(je.train_batch(batch=b)) for b in batches(rows, masked)]
    finally:
        jreset()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
def test_loopback_context_matches_single_process_and_jax(tmp_path):
    """``initialize(mpu=Topology(context=4, loopback=True))``: the model's
    "auto" attention takes the loopback ring (chunks of 8 tokens) and the
    run equals the single-process one."""
    _, params = init_params(tmp_path / "p.npz")
    rows = MICRO * GAS
    calls = []
    from deepspeed_tpu_torch.ops.attention import sharded as ps

    fwd = ps.ring_forward

    def spy(ring, qs, *rest):
        calls.append(len(qs))
        return fwd(ring, qs, *rest)

    ps.ring_forward = spy
    try:
        ring, eng = port_losses(params, rows, False, mpu=Topology(context=4, loopback=True))
    finally:
        ps.ring_forward = fwd
    assert calls and set(calls) == {4}  # every layer, every micro-batch: 4 chunks
    assert not eng.topology.distributed and eng.topology.world_size == 4
    single, _ = port_losses(params, rows, False)
    np.testing.assert_allclose(ring, single, rtol=LOSS_PORT_RTOL)
    np.testing.assert_allclose(ring, jax_losses(params, rows, False), rtol=LOSS_JAX_RTOL)


@pytest.mark.parametrize("mesh,masked", [({"data": 2, "context": 2}, False),
                                         ({"context": 4}, False),
                                         ({"data": 2, "context": 2}, True)])
def test_gloo_processes_match_single_process_and_jax(mesh, masked, tmp_path):
    """4 gloo processes on ``mesh``: per-step losses (the global mean on
    every rank) against one process and against JAX; final params equal
    on every rank bit for bit."""
    _, params = init_params(tmp_path / "p.npz")
    res = spawn(4, tmp_path, {"mesh": mesh, "masked": masked})
    rows = MICRO * GAS * mesh.get("data", 1)
    single, _ = port_losses(params, rows, masked)
    for r in range(4):
        np.testing.assert_allclose(res[r]["losses"], single, rtol=LOSS_PORT_RTOL,
                                   err_msg=f"rank {r}")
        for name in res[0]:
            if name.startswith("p/"):
                np.testing.assert_array_equal(res[r][name], res[0][name], err_msg=name)
    np.testing.assert_allclose(res[0]["losses"], jax_losses(params, rows, masked),
                               rtol=LOSS_JAX_RTOL)
    if masked:  # the control: a per-rank mean would differ from the global one
        unmasked, _ = port_losses(params, rows, False)
        assert np.abs(np.asarray(unmasked) - np.asarray(single)).max() > 1e-3


def test_refusals_over_processes(tmp_path):
    """Over 4 gloo processes on {data: 2, context: 2}: ZeRO above 0 raises
    (ZeRO sharded across ranks, queue 1 item 6), and the ring refuses a
    window, non-causal attention and ALiBi; in one process another mesh
    axis above 1 raises, and so does a mesh larger than the process count."""
    init_params(tmp_path / "p.npz")
    refusals = {
        "zero": ({"zero_optimization": {"stage": 1}}, {}),
        "window": ({}, {"sliding_window": 8}),
        "non_causal": ({}, {"attn_causal": False}),
        "alibi": ({}, {"position": "alibi"}),
    }
    res = spawn(4, tmp_path, {"mesh": {"data": 2, "context": 2}, "masked": False,
                              "refusals": refusals})
    for r in range(4):
        assert "queue 1, item 6" in str(res[r]["zero"])
        assert "sliding_window" in str(res[r]["window"])
        assert "causal-only" in str(res[r]["non_causal"])
        assert "alibi" in str(res[r]["alibi"]).lower()
    cfg = PT.get_config("tiny", **MODEL)
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(cfg), model_parameters=params,
                                       config=ds_config(MICRO, mesh={"model": 2}))
    try:
        with pytest.raises(ValueError, match="process count 1"):
            deepspeed_tpu_torch.initialize(model=PT.make_loss_fn(cfg), model_parameters=params,
                                           config=ds_config(MICRO, mesh={"context": 4}))
    finally:
        reset_topology()


if __name__ == "__main__":
    rank, world, tmp, scenario = sys.argv[1:]
    worker(int(rank), int(world), tmp, scenario)
