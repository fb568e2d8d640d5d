"""A counter-based 32-bit hash in torch integer ops.

murmur3's 32-bit finalizer over int64 tensors that hold 32-bit words, with
every multiplication split so that no product leaves int64. The sampler
(``inference/sampling.py``) draws its random bits from it, and the block
quantizer's stochastic rounding (``ops/quantizer/block_quant.py``) too; the
``block_quant`` CUDA kernel computes the same words in uint32 arithmetic,
so a CPU tensor, the plain version on a card and the kernel agree bit for
bit.
"""

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B1


def mul32(h, c: int):
    """(h * c) mod 2^32 for int64 tensors h in [0, 2^32): the constant is
    split in 16-bit halves so every product stays below 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & M32


def mix32(h):
    """murmur3 fmix32 on int64 tensors holding 32-bit words."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def fold(key, word):
    """mix32(key ^ word * GOLDEN): ``word`` (its low 32 bits) folded into
    ``key``."""
    return mix32(key ^ mul32(torch.as_tensor(word).to(torch.int64) & M32, GOLDEN))
