"""TP <-> EP token remaps (the JAX package's ``parallel/moe/mappings.py``).

Both are identities while no ``model`` axis is live, as in the JAX package
(and the reference at tp_world_size 1). The port runs no tensor
parallelism, so a live model axis raises (ROADMAP queue 1, item 6).
"""

from deepspeed_tpu_torch.parallel.topology import EXPERT_AXIS, get_topology


def _no_model_axis(what: str):
    if get_topology().model_parallel_size > 1:
        raise NotImplementedError(
            f"{what}: tensor parallelism (a model axis above 1) is not ported yet "
            "(ROADMAP queue 1, item 6)")


def gather_tokens(x, dim: int = 1):
    """TP-sharded tokens -> every rank sees the full ``dim``: the identity
    with no model axis."""
    _no_model_axis("gather_tokens")
    return x


def drop_tokens(x, dim: int = 1):
    """Replicated tokens -> each TP rank's slice of ``dim``: the identity
    with no model axis."""
    _no_model_axis("drop_tokens")
    return x


def quantized_ep_active(config) -> bool:
    """Whether the MoE dispatch/combine exchange would run int8 inside the
    collective: ``comm_quant="int8"`` and an expert axis above 1 (at expert
    degree 1 the exchange is local and "int8" a validated no-op), as in the
    JAX package."""
    return (getattr(config, "comm_quant", "none") == "int8"
            and get_topology().axis_size(EXPERT_AXIS) > 1)
