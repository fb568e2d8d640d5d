"""Collective communication (mirrors deepspeed_tpu/comm) over torch.distributed."""

from deepspeed_tpu_torch.comm.comm import (  # noqa: F401
    ReduceOp,
    all_gather,
    all_reduce,
    barrier,
    broadcast,
    get_local_rank,
    get_rank,
    get_world_size,
    init_distributed,
    is_initialized,
    ppermute,
    reduce_scatter,
    reduce_scatter_tensor,
    send_recv_next,
    send_recv_prev,
)
