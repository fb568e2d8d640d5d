"""Random-LTD token sampling, gather and scatter (counterpart of
``deepspeed_tpu/ops/random_ltd.py``).

The reference's ``csrc/random_ltd/`` kernels (token_sort, gather_scatter)
are plain XLA in the JAX package and plain torch here. The sampling takes
an explicit ``torch.Generator`` where the JAX package takes a key: the port
does not reimplement threefry (the sampling decision of the port's first
slice), so the two packages draw different tokens from the same seed and
agree on what the draws are (sorted, unique, in range, ``kept`` per row)
and on the gather and scatter of given indices, exactly.
"""

from typing import Tuple

import torch


def gpt_sample_tokens(generator: torch.Generator, seq_len: int, kept: int, batch: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``kept`` token indices per batch row, sorted ascending so the
    causal order survives (reference gpt_sample_tokens: a sorted random
    sample), on the generator's device. Returns (indices [batch, kept]
    int32, mask [batch, seq_len] bool)."""
    dev = generator.device
    idx = torch.stack([
        torch.randperm(seq_len, generator=generator, device=dev)[:kept].sort().values
        for _ in range(batch)
    ]) if batch else torch.zeros(0, kept, dtype=torch.long, device=dev)
    idx = idx.to(torch.int32)
    mask = torch.zeros(batch, seq_len, dtype=torch.bool, device=dev)
    mask.scatter_(1, idx.long(), True)
    return idx, mask


def bert_sample_tokens(generator: torch.Generator, seq_len: int, kept: int, batch: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional variant: the same sampling; kept indices sorted for
    stable layouts."""
    return gpt_sample_tokens(generator, seq_len, kept, batch)


def token_gather(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Gather kept tokens: x [b, s, ...] + indices [b, k] -> [b, k, ...]
    (reference token_gather kernel)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, indices.long()]


def token_scatter(full: torch.Tensor, kept_values: torch.Tensor,
                  indices: torch.Tensor) -> torch.Tensor:
    """Scatter processed kept tokens back into the full sequence; dropped
    positions keep ``full``'s values (reference token_scatter_: the dropped
    tokens bypass the layer). Returns a new tensor, as the JAX function
    does."""
    out = full.clone()
    rows = torch.arange(full.shape[0], device=full.device)[:, None]
    out[rows, indices.long()] = kept_values.to(full.dtype)
    return out
