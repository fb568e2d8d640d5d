"""Tiled compute along the sequence axis (memory reducers), in the port.

Counterpart of ``deepspeed_tpu/parallel/sequence/tiled.py``: the sequence
dim is cut into tiles so that MLP or logits activations never exist for
the whole sequence. Each tile runs under ``torch.utils.checkpoint`` (where
autograd records), as the JAX body runs under ``jax.checkpoint``: only the
tile's input is kept and the backward recomputes tile by tile. Plain
torch; the JAX package has no kernel here either.
"""

import inspect
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint


def _run(fn, *args):
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def tiled_compute(fn: Callable, x: torch.Tensor, num_tiles: int, axis: int = 1) -> torch.Tensor:
    """Apply ``fn`` over ``num_tiles`` chunks of ``x`` along ``axis``.

    ``fn`` must preserve the shape of the tiled axis (elementwise over the
    sequence, like an MLP applied per position). A size the tiles do not
    divide runs untiled, as in the JAX package."""
    size = x.shape[axis]
    if num_tiles <= 1 or size % num_tiles != 0:
        return fn(x)
    return torch.cat([_run(fn, t) for t in x.chunk(num_tiles, dim=axis)], dim=axis)


def tiled_mlp(mlp_fn: Callable, x: torch.Tensor, num_tiles: int = 4) -> torch.Tensor:
    """Cut the [b, s, h] input into sequence tiles and run the MLP per tile."""
    return tiled_compute(mlp_fn, x, num_tiles, axis=1)


def tiled_logits_loss(loss_of_logits: Callable, hidden: torch.Tensor, lm_head: torch.Tensor,
                      labels: torch.Tensor, num_tiles: int = 8,
                      mask: Optional[torch.Tensor] = None):
    """Never materialize [b, s, vocab] logits: compute the loss per sequence
    tile and reduce.

    ``loss_of_logits(logits, labels, mask) -> (sum_loss, count)`` (a
    two-argument form is called without the mask). Returns the mean loss
    over unmasked positions."""
    b, s, h = hidden.shape
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=hidden.device)
    try:
        if len(inspect.signature(loss_of_logits).parameters) == 2:
            two_arg = loss_of_logits
            loss_of_logits = lambda lg, lb, m: two_arg(lg, lb)  # noqa: E731
    except (TypeError, ValueError):
        pass
    if num_tiles <= 1 or s % num_tiles != 0:
        total, count = loss_of_logits(hidden @ lm_head, labels, mask)
        return total / count.clamp_min(1.0)

    def body(h_tile, head, l_tile, m_tile):
        t, c = loss_of_logits(h_tile @ head, l_tile, m_tile)
        return torch.stack([t.float(), c.float()])

    total = torch.zeros(2, dtype=torch.float32, device=hidden.device)
    for h_tile, l_tile, m_tile in zip(hidden.chunk(num_tiles, dim=1),
                                      labels.chunk(num_tiles, dim=1),
                                      mask.chunk(num_tiles, dim=1)):
        total = total + _run(body, h_tile, lm_head, l_tile, m_tile)
    return total[0] / total[1].clamp_min(1.0)


__all__ = ["tiled_compute", "tiled_logits_loss", "tiled_mlp"]
