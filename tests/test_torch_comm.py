"""The port's ``comm`` and ``Topology`` over gloo, in 2 and 4 processes.

Each test starts its ranks as fresh interpreters running this file
(``python -S tests/test_torch_comm.py SCENARIO RANK WORLD DIR``: no site
customization, so no JAX in the children). They meet through a
``FileStore`` under the test's ``tmp_path`` (no TCP port, so parallel test
workers cannot collide), give the process group a 60 s timeout, write what
they computed to ``DIR/rank{r}.npz`` and exit; the parent waits for each
with its own limit, so a hung collective fails one test. The parent then
holds every result to the single-process arithmetic on the ranks' inputs:

  * each collective (all_reduce SUM/AVG/MAX/MIN/PRODUCT, all_gather tiled
    and stacked, reduce_scatter, broadcast, ppermute, send_recv_next /
    prev) over ``data``, ``context`` and both;
  * the rank layout is ``MESH_AXES``' reshape of ``arange(world)``;
  * the process ring over gloo (``ring_attention_local``, forward and both
    gradient rings) equals the loopback ring on the gathered arrays bit for
    bit (the same plain chunk versions on the same chunks, one thread each);
  * a CUDA tensor on a gloo group raises;
  * ``init_distributed`` takes the CPU and gloo only when asked.
"""

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

from deepspeed_tpu_torch.parallel.topology import MESH_AXES  # noqa: E402

JOIN_S = 150
MESHES = {2: dict(context=2), 4: dict(data=2, context=2)}


def spawn(script, scenario, world, tmp_path, *extra):
    """Run ``world`` ranks of ``script``'s worker; return their results."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, "-S", str(script), scenario, str(r), str(world),
                               str(tmp_path), *map(str, extra)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    errors = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=JOIN_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"rank {r} of {scenario} did not finish in {JOIN_S} s")
        if p.returncode != 0:
            errors.append(f"rank {r} exit {p.returncode}:\n{err[-3000:]}")
    assert not errors, "\n".join(errors)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


# ---------------------------------------------------------------------------
# the workers (run in the child processes)
# ---------------------------------------------------------------------------
def init_rank(rank, world, tmp, mesh):
    """gloo through a FileStore with a 60 s timeout, then the topology."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.topology import Topology, set_topology

    torch.set_num_threads(1)
    store = torch.distributed.FileStore(str(Path(tmp) / "store"), world)
    comm.init_distributed(dist_backend="gloo", store=store, world_size=world, rank=rank,
                          timeout=timedelta(seconds=60))
    topo = Topology(timeout=timedelta(seconds=60), **mesh)
    set_topology(topo)
    return topo


def rank_input(rank, shape=(4, 6)):
    return torch.from_numpy(np.random.default_rng(100 + rank).normal(size=shape).astype(
        np.float32))


def worker_collectives(rank, world, tmp):
    from types import SimpleNamespace

    from deepspeed_tpu_torch import comm

    topo = init_rank(rank, world, tmp, MESHES[world])
    out = {"coords": np.array([topo.coords()[a] for a in MESH_AXES]),
           "sizes": np.array([topo.sizes[a] for a in MESH_AXES])}
    x = rank_input(rank)
    axes = {"data": "data", "context": "context", "both": ("data", "context")}
    for tag, axis in axes.items():
        out[f"index_{tag}"] = np.array(topo.axis_index(axis))
        g = topo.group(axis)
        out[f"group_{tag}"] = np.array(g[1] if g is not None else [rank])
        for op in ("sum", "avg", "max", "min", "product"):
            out[f"all_reduce_{op}_{tag}"] = comm.all_reduce(x.clone(), axis=axis, op=op).numpy()
        out[f"all_gather_{tag}"] = comm.all_gather(x, axis=axis, gather_dim=1).numpy()
        out[f"all_gather_stacked_{tag}"] = comm.all_gather(x, axis=axis, tiled=False).numpy()
        out[f"reduce_scatter_{tag}"] = comm.reduce_scatter(x, axis=axis).numpy()
        out[f"broadcast_{tag}"] = comm.broadcast(x.clone(), src=1, axis=axis).numpy()
        n = topo.axis_size(axis)
        out[f"ppermute_{tag}"] = comm.ppermute(
            x, [(r, (r - 1) % n) for r in range(n)], axis=axis).numpy()
        out[f"next_{tag}"] = comm.send_recv_next(x, axis=axis).numpy()
        out[f"prev_{tag}"] = comm.send_recv_prev(x, axis=axis).numpy()
    try:
        comm.all_reduce(SimpleNamespace(is_cuda=True), axis="context")
        out["cuda_on_gloo"] = np.array("no error")
    except ValueError as e:
        out["cuda_on_gloo"] = np.array(str(e))
    comm.barrier()
    np.savez(Path(tmp) / f"rank{rank}.npz", **out)


def ring_inputs(h_kv, with_seg, b=1, h=4, s=512, d=64):
    rng = np.random.default_rng(7 + h_kv)
    q, k, v, do = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
                   for sh in ((b, h, s, d), (b, h_kv, s, d), (b, h_kv, s, d), (b, h, s, d)))
    seg = None
    if with_seg:
        seg = torch.from_numpy((np.arange(s)[None] // 200).repeat(b, 0).astype(np.int32))
    return q, k, v, do, seg


def worker_ring(rank, world, tmp, h_kv, with_seg):
    from deepspeed_tpu_torch.ops.attention.core import attention
    from deepspeed_tpu_torch.parallel.topology import CONTEXT_AXIS

    topo = init_rank(rank, world, tmp, dict(context=world))
    q, k, v, do, seg = ring_inputs(int(h_kv), with_seg == "1")
    i, n = topo.axis_index(CONTEXT_AXIS), world
    local = [t.chunk(n, dim=2)[i].contiguous().requires_grad_(True) for t in (q, k, v)]
    lseg = None if seg is None else seg.chunk(n, dim=1)[i].contiguous()
    out = attention(*local, segment_ids=lseg, impl="flash_ring")
    grads = torch.autograd.grad(out, local, do.chunk(n, dim=2)[i])
    np.savez(Path(tmp) / f"rank{rank}.npz", out=out.detach().numpy(),
             **{name: g.numpy() for name, g in zip(("dq", "dk", "dv"), grads)})


# ---------------------------------------------------------------------------
# the tests (the parent)
# ---------------------------------------------------------------------------
def _group_members(world, axis_names):
    sizes = MESHES[world]
    shape = tuple(sizes.get(a, 1) for a in MESH_AXES)
    ranks = np.arange(world).reshape(shape)
    idx = [MESH_AXES.index(a) for a in axis_names]
    other = [i for i in range(len(MESH_AXES)) if i not in idx]
    n = int(np.prod([shape[i] for i in idx]))
    return [list(r) for r in np.transpose(ranks, other + idx).reshape(-1, n)]


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_equal_single_process_arithmetic(world, tmp_path):
    res = spawn(__file__, "collectives", world, tmp_path)
    xs = [rank_input(r).numpy() for r in range(world)]
    layout = np.arange(world).reshape(tuple(MESHES[world].get(a, 1) for a in MESH_AXES))
    for r, got in enumerate(res):
        # the rank layout is MESH_AXES' reshape of arange(world)
        assert tuple(got["coords"]) == tuple(int(i) for i in np.argwhere(layout == r)[0])
        assert "gloo" in str(got["cuda_on_gloo"]) and "CUDA tensor" in str(got["cuda_on_gloo"])
    for tag, names in (("data", ("data",)), ("context", ("context",)),
                       ("both", ("data", "context"))):
        groups = [g for g in _group_members(world, names)]
        for members in groups:
            n = len(members)
            vals = [xs[m] for m in members]
            for i, r in enumerate(members):
                got = res[r]
                if n == 1:
                    assert got[f"group_{tag}"].tolist() == [r]
                else:
                    assert got[f"group_{tag}"].tolist() == members
                assert int(got[f"index_{tag}"]) == i
                want = {
                    "all_reduce_sum": np.sum(vals, 0), "all_reduce_avg": np.sum(vals, 0) / n,
                    "all_reduce_max": np.max(vals, 0), "all_reduce_min": np.min(vals, 0),
                    "all_reduce_product": np.prod(vals, 0),
                    "all_gather": np.concatenate(vals, 1), "all_gather_stacked": np.stack(vals),
                    "reduce_scatter": np.split(np.sum(vals, 0), n, 0)[i],
                    "broadcast": vals[1 % n] if n > 1 else vals[0],
                    "ppermute": vals[(i + 1) % n],
                    "next": vals[i - 1] if i > 0 else np.zeros_like(vals[0]),
                    "prev": vals[i + 1] if i < n - 1 else np.zeros_like(vals[0]),
                }
                for key, w in want.items():
                    # fp32 sums and products over n ranks in gloo's order
                    np.testing.assert_allclose(got[f"{key}_{tag}"], w, rtol=1e-6, atol=1e-6,
                                               err_msg=f"rank {r} {key} over {tag}")


@pytest.mark.parametrize("world,h_kv,with_seg", [(2, 2, 0), (4, 4, 1), (4, 2, 0)])
def test_process_ring_equals_loopback_ring(world, h_kv, with_seg, tmp_path):
    """The ring in ``world`` gloo processes (each rank its chunk) against
    the loopback ring over the same global arrays: out, dq, dk, dv bit for
    bit, and within fp32 rounding of ``mha_reference``."""
    from deepspeed_tpu_torch.ops.attention.core import attention, mha_reference
    from deepspeed_tpu_torch.parallel.topology import Topology, reset_topology, set_topology

    res = spawn(__file__, "ring", world, tmp_path, h_kv, with_seg)
    q, k, v, do, seg = ring_inputs(h_kv, bool(with_seg))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    set_topology(Topology(context=world, loopback=True))
    try:
        out = attention(*leaves, segment_ids=seg, impl="flash_ring")
        grads = torch.autograd.grad(out, leaves, do)
    finally:
        reset_topology()
        torch.set_num_threads(threads)
    ref = mha_reference(*leaves, segment_ids=seg)
    ref_grads = torch.autograd.grad(ref, leaves, do)
    for name, want, r in zip(("out", "dq", "dk", "dv"), (out,) + grads, (ref,) + ref_grads):
        got = np.concatenate([res[i][name] for i in range(world)], axis=2)
        np.testing.assert_array_equal(got, want.detach().numpy(), err_msg=name)
        np.testing.assert_allclose(got, r.detach().numpy(), atol=1e-5, rtol=1e-5, err_msg=name)


def test_topology_refusals_and_counts():
    """Axes other than data and context above 1 raise citing the ROADMAP;
    a grid larger than the process count raises; the loopback form keeps
    the grid's size apart from its one process."""
    from deepspeed_tpu_torch.parallel.topology import Topology

    for kw in (dict(model=2), dict(pipe=2), dict(sequence=2), dict(expert=2), dict(zero=2)):
        with pytest.raises(NotImplementedError, match="queue 1, item 6"):
            Topology(loopback=True, **kw)
    with pytest.raises(ValueError, match="process count 1"):
        Topology(context=4)
    t = Topology(data=2, context=4, loopback=True)
    assert (t.world_size, t.process_count, t.distributed) == (8, 1, False)
    assert t.dp_world_size == 2 and t.context_parallel_size == 4
    assert t.group("context") is None and t.axis_index("context") == 0
    assert json.dumps(repr(t))


def test_init_distributed_takes_the_cpu_only_when_asked(monkeypatch):
    """Unasked, ``init_distributed`` wants the card and raises where none is
    visible, before any rendezvous; ``dist_backend="gloo"`` (or
    ``device="cpu"``) still brings a one-rank gloo group up on the CPU."""
    from deepspeed_tpu_torch import comm

    if comm.is_initialized():
        pytest.skip("a process group is already up in this process")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}, {"dist_backend": "nccl"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            comm.init_distributed(store=torch.distributed.HashStore(), world_size=1, rank=0,
                                  **kw)
        assert not comm.is_initialized()
    for kw in ({"dist_backend": "gloo"}, {"device": "cpu"}):
        comm.init_distributed(store=torch.distributed.HashStore(), world_size=1, rank=0,
                              timeout=timedelta(seconds=60), **kw)
        try:
            assert comm.is_initialized() and comm.get_world_size() == 1
            assert torch.distributed.get_backend() == "gloo"
        finally:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    scenario, rank, world, tmp, *rest = sys.argv[1:]
    {"collectives": worker_collectives, "ring": worker_ring}[scenario](
        int(rank), int(world), tmp, *rest)
