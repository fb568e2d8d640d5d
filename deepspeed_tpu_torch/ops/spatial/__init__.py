"""Spatial (diffusion) ops (counterpart of ``deepspeed_tpu/ops/spatial``).

The reference's ``csrc/spatial/`` opt_bias_add / opt_bias_add_add kernels
and the diffusers GroupNorm fusion over NHWC activations. They are plain
XLA in the JAX package and plain torch here: no kernel, so they run on
whatever device their tensors are on."""

import torch


def nhwc_bias_add(activation: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """act [n, h, w, c] + bias [c] (reference opt_bias_add)."""
    return activation + bias.to(activation.dtype)


def bias_add_add(activation: torch.Tensor, other: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """act + other + bias (reference opt_bias_add_add — the residual form)."""
    return activation + other + bias.to(activation.dtype)


def nhwc_group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC (channels last; diffusion UNet blocks), in fp32,
    returned in x's dtype."""
    n, h, w, c = x.shape
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups}")
    g = x.float().reshape(n, h, w, num_groups, c // num_groups)
    mean = g.mean(dim=(1, 2, 4), keepdim=True)
    var = (g - mean).square().mean(dim=(1, 2, 4), keepdim=True)
    out = ((g - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    return (out * gamma.float() + beta.float()).to(x.dtype)
