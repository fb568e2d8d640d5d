"""Parallel-group queries over the port's ``Topology``.

Counterpart of ``deepspeed_tpu/utils/groups.py`` (the reference
``deepspeed/utils/groups.py`` query surface). World sizes are the grid's
axis sizes; a group handle is the axis name, as in the JAX package, which
``comm``'s collectives take and map to the topology's process group
(``group_of`` gives the ``torch.distributed`` group itself, None where the
group is this process alone). Ranks are this process's index along the
axis (0 in the loopback form, whose one process holds every index).
"""

from deepspeed_tpu_torch.parallel.topology import (
    CONTEXT_AXIS,
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQUENCE_AXIS,
    ZERO_AXIS,
    get_topology,
)


def initialize(ep_size=1, mpu=None):
    """Reference groups.initialize: the topology made every group already."""


# ---- world sizes ----
def get_data_parallel_world_size():
    return get_topology().dp_world_size


def get_model_parallel_world_size():
    return get_topology().model_parallel_size


get_tensor_model_parallel_world_size = get_model_parallel_world_size


def get_pipe_parallel_world_size():
    return get_topology().pipe_parallel_size


def get_sequence_parallel_world_size():
    return get_topology().sequence_parallel_size


def get_context_parallel_world_size():
    return get_topology().context_parallel_size


def get_expert_parallel_world_size(group_name=None):
    return get_topology().expert_parallel_size


def get_expert_data_parallel_world_size(group_name=None):
    return get_topology().data_parallel_size


def get_world_size():
    return get_topology().world_size


# ---- group handles: axis names, as in the JAX package ----
def get_data_parallel_group():
    """The non-expert data-parallel axes (data, and zero when it is above 1)."""
    if get_topology().zero_shard_size > 1:
        return (DATA_AXIS, ZERO_AXIS)
    return DATA_AXIS


def get_model_parallel_group():
    return MODEL_AXIS


get_tensor_model_parallel_group = get_model_parallel_group


def get_pipe_parallel_group():
    return PIPE_AXIS


def get_sequence_parallel_group():
    return SEQUENCE_AXIS


def get_context_parallel_group():
    return CONTEXT_AXIS


def get_expert_parallel_group(group_name=None):
    return EXPERT_AXIS


def get_expert_data_parallel_group(group_name=None):
    return DATA_AXIS


def group_of(axes):
    """The ``torch.distributed`` process group over ``axes`` for this
    process, or None where the group is this process alone."""
    g = get_topology().group(axes)
    return None if g is None else g[0]


# ---- this process's ranks ----
def get_data_parallel_rank():
    return get_topology().axis_index(get_data_parallel_group())


def get_model_parallel_rank():
    return get_topology().axis_index(MODEL_AXIS)


def get_sequence_parallel_rank():
    return get_topology().axis_index(SEQUENCE_AXIS)


def get_context_parallel_rank():
    return get_topology().axis_index(CONTEXT_AXIS)


def get_expert_parallel_rank(group_name=None):
    return get_topology().axis_index(EXPERT_AXIS)
