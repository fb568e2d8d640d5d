"""Collective communication of the port over ``torch.distributed``.

Counterpart of ``deepspeed_tpu/comm/comm.py``. The JAX package's
collectives name a mesh axis and lower to ``jax.lax`` collectives inside
``shard_map``; here the same calls name the same axes, which map to the
process groups of the port's ``Topology`` (``parallel/topology.py``), and
run eagerly: NCCL for CUDA tensors, gloo for CPU tensors.

  * ``init_distributed``: the default process group (NCCL when the device
    is CUDA, gloo for the CPU), from arguments or the usual ``RANK`` /
    ``WORLD_SIZE`` / ``MASTER_ADDR`` variables;
  * ``all_reduce`` / ``broadcast`` work in place and return the tensor;
    ``all_gather`` / ``reduce_scatter`` / ``ppermute`` return new tensors;
  * ``ppermute`` (and ``send_recv_next`` / ``send_recv_prev``) is one
    ``batch_isend_irecv``: a rank that receives from nobody gets zeros, as
    ``jax.lax.ppermute`` gives.

An axis whose group is this process alone (size 1, or the loopback form)
makes each collective its single-process arithmetic. A CUDA tensor on a
gloo group, or a CPU tensor on an NCCL group, raises: nothing copies
through the host. ``async_op=True`` raises, as in the JAX package.
"""

import os
from datetime import timedelta
from typing import Optional, Sequence

import torch

from deepspeed_tpu_torch.parallel.topology import DATA_AXIS, PIPE_AXIS, get_topology


class ReduceOp:
    """torch.distributed.ReduceOp parity, as the JAX package's strings."""

    SUM = "sum"
    AVG = "avg"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


_VALID_OPS = (ReduceOp.SUM, ReduceOp.AVG, ReduceOp.PRODUCT, ReduceOp.MIN, ReduceOp.MAX)


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def init_distributed(dist_backend: Optional[str] = None, distributed_port: int = 29500,
                     init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, timeout: Optional[timedelta] = None,
                     store=None, device: Optional[str] = None):
    """Initialize the default process group once (later calls return).
    ``device`` defaults to "cuda" (to "cpu" when ``dist_backend`` is
    "gloo"): the CPU and gloo are taken only when the caller asks for
    them, and asking for a card where none is visible raises.
    ``dist_backend`` defaults to NCCL on a card, gloo on the CPU. Without
    ``init_method`` or ``store`` the rendezvous is
    ``tcp://MASTER_ADDR:MASTER_PORT`` (default localhost and
    ``distributed_port``); rank and world size default to ``RANK`` and
    ``WORLD_SIZE`` (0 and 1)."""
    if is_initialized():
        return
    dist = _dist()
    if device is None:
        device = "cpu" if dist_backend == "gloo" else "cuda"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_distributed: no CUDA device is visible; pass device='cpu' or "
            "dist_backend='gloo' to run the process group on the CPU")
    backend = dist_backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    if init_method is None and store is None:
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT", str(distributed_port))
        init_method = f"tcp://{addr}:{port}"
    kw = {"timeout": timeout} if timeout is not None else {}
    dist.init_process_group(backend, init_method=init_method, store=store,
                            world_size=world_size, rank=rank, **kw)


def get_rank() -> int:
    return _dist().get_rank() if is_initialized() else 0


def get_world_size() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", get_rank() if get_world_size() > 1 else 0))


def barrier(group=None):
    if is_initialized():
        _dist().barrier(group=group)


def _resolve_op(op):
    if op not in _VALID_OPS:
        raise ValueError(f"Unsupported reduce op {op!r}; expected one of {list(_VALID_OPS)}")
    return op


def _check_async_op(async_op, name):
    if async_op:
        raise NotImplementedError(
            f"{name}(async_op=True): the port's collectives return their result; "
            "call with async_op=False")


def _group(axis, tensor, name):
    """(process group, global ranks, this process's index) over ``axis``,
    or None when the group is this process alone. Raises for a tensor the
    group's backend does not take."""
    g = get_topology().group(axis)
    if g is None:
        return None
    pg, ranks = g
    backend = _dist().get_backend(pg)
    if backend == "gloo" and tensor.is_cuda:
        raise ValueError(f"{name}: a CUDA tensor on a gloo group over {axis!r} (use NCCL; "
                         "nothing copies through the host)")
    if backend == "nccl" and not tensor.is_cuda:
        raise ValueError(f"{name}: a CPU tensor on an NCCL group over {axis!r} (use gloo)")
    return pg, ranks, ranks.index(get_rank())


def _torch_op(op):
    R = _dist().ReduceOp
    return {ReduceOp.SUM: R.SUM, ReduceOp.AVG: R.SUM, ReduceOp.PRODUCT: R.PRODUCT,
            ReduceOp.MIN: R.MIN, ReduceOp.MAX: R.MAX}[op]


def all_reduce(tensor, axis=DATA_AXIS, op=ReduceOp.SUM, group=None, async_op=False):
    """Reduce over ``axis`` in place (AVG: the sum divided by the group's
    size); returns ``tensor``."""
    _check_async_op(async_op, "all_reduce")
    op = _resolve_op(op)
    g = _group(axis, tensor, "all_reduce")
    if g is None:
        return tensor
    _dist().all_reduce(tensor, op=_torch_op(op), group=g[0])
    if op == ReduceOp.AVG:
        tensor.div_(len(g[1]))
    return tensor


def all_gather(tensor, axis=DATA_AXIS, group=None, async_op=False, tiled=True, gather_dim=0):
    """Gather over ``axis``: ``tiled`` concatenates the members' tensors
    along ``gather_dim`` in axis order, else stacks them on a new leading
    axis."""
    _check_async_op(async_op, "all_gather")
    g = _group(axis, tensor, "all_gather")
    if g is None:
        return tensor.clone() if tiled else tensor[None].clone()
    tensor = tensor.contiguous()
    outs = [torch.empty_like(tensor) for _ in g[1]]
    _dist().all_gather(outs, tensor, group=g[0])
    return torch.cat(outs, dim=gather_dim) if tiled else torch.stack(outs)


def reduce_scatter(tensor, axis=DATA_AXIS, op=ReduceOp.SUM, group=None, async_op=False,
                   scatter_dim=0):
    """Reduce over ``axis`` and keep this member's equal slice along
    ``scatter_dim`` (SUM or AVG). gloo has no reduce-scatter: there it is an
    all-reduce of a copy, then the slice."""
    _check_async_op(async_op, "reduce_scatter")
    op = _resolve_op(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"reduce_scatter supports SUM/AVG only, got {op!r}")
    g = _group(axis, tensor, "reduce_scatter")
    if g is None:
        return tensor.clone()
    pg, ranks, me = g
    n = len(ranks)
    if tensor.shape[scatter_dim] % n:
        raise ValueError(f"reduce_scatter: dim {scatter_dim} of {tuple(tensor.shape)} does "
                         f"not divide over {n} members")
    dist = _dist()
    if dist.get_backend(pg) == "nccl":
        src = tensor.movedim(scatter_dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=pg)
        out = out.movedim(0, scatter_dim)
    else:
        full = tensor.clone()
        dist.all_reduce(full, op=dist.ReduceOp.SUM, group=pg)
        out = full.chunk(n, dim=scatter_dim)[me].clone()
    if op == ReduceOp.AVG:
        out = out / n
    return out


reduce_scatter_tensor = reduce_scatter


def broadcast(tensor, src=0, axis=DATA_AXIS, group=None, async_op=False):
    """Member ``src`` (an index along ``axis``) sends its tensor to every
    member, in place; returns ``tensor``."""
    _check_async_op(async_op, "broadcast")
    g = _group(axis, tensor, "broadcast")
    if g is None:
        return tensor
    _dist().broadcast(tensor, g[1][src], group=g[0])
    return tensor


def ppermute(tensor, perm: Sequence, axis=PIPE_AXIS):
    """Point-to-point permutation along ``axis``: ``perm`` holds (source,
    destination) index pairs; returns what this member received (zeros
    when nobody sends to it)."""
    g = _group(axis, tensor, "ppermute")
    if g is None:
        hit = [s for s, d in perm if s == 0 and d == 0]
        return tensor.clone() if hit else torch.zeros_like(tensor)
    pg, ranks, me = g
    dist = _dist()
    tensor = tensor.contiguous()
    out = torch.zeros_like(tensor)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(tensor)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, tensor, ranks[d], group=pg))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s], group=pg))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def send_recv_next(tensor, axis=PIPE_AXIS):
    """Shift +1 along axis: member i sends to i+1 (member 0 receives zeros)."""
    n = get_topology().axis_size(axis)
    return ppermute(tensor, [(i, i + 1) for i in range(n - 1)], axis)


def send_recv_prev(tensor, axis=PIPE_AXIS):
    """Shift -1 along axis: member i sends to i-1 (the last receives zeros)."""
    n = get_topology().axis_size(axis)
    return ppermute(tensor, [(i + 1, i) for i in range(n - 1)], axis)
