"""Muon optimizer core: Newton-Schulz momentum orthogonalization.

Counterpart of ``deepspeed_tpu/ops/muon.py``: SGD-momentum whose 2-D
updates are orthogonalized by a quintic Newton-Schulz iteration (five
matrix products of the parameter's own shape, in bf16). Leaves that are
not matrices (anything but ``ndim == 2`` with both sides above 1, so the
model's stacked ``[layers, ...]`` weights too) take Adam at a tenth of the
learning rate, as the JAX transform routes them. Plain torch: the JAX
package has no kernel here either.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.utils.tree import tree_map, walk

NS_COEFFS = (3.4445, -4.7750, 2.0315)


def newton_schulz_orthogonalize(g: torch.Tensor, steps: int = 5, eps: float = 1e-7) -> torch.Tensor:
    """Quintic Newton-Schulz iteration producing an approximate orthogonal
    factor of ``g``, computed in bf16 and returned in ``g``'s dtype."""
    a, b, c = NS_COEFFS
    transposed = g.shape[-2] > g.shape[-1]
    x = g.to(torch.bfloat16)
    if transposed:
        x = x.transpose(-1, -2)
    x = x / (torch.linalg.matrix_norm(x.float()).to(torch.bfloat16) + eps)
    for _ in range(steps):
        gram = x @ x.transpose(-1, -2)
        update = b * gram + c * (gram @ gram)
        x = a * x + update @ x
    if transposed:
        x = x.transpose(-1, -2)
    return x.to(g.dtype)


def _is_matrix(p) -> bool:
    return p.ndim == 2 and min(p.shape) > 1


class MuonTransform:
    """Muon for 2-D params, Adam for the rest; in place on the masters."""

    state_fields = ("momentum", "adam_mu", "adam_nu", "count")

    def __init__(self, beta=0.95, ns_steps=5, weight_decay=0.0, adam_betas=(0.9, 0.95), eps=1e-8,
                 adam_lr_ratio=0.1):
        self.beta, self.ns_steps, self.wd = float(beta), int(ns_steps), float(weight_decay)
        self.b1, self.b2 = (float(b) for b in adam_betas)
        self.eps, self.adam_lr_ratio = float(eps), float(adam_lr_ratio)

    def init(self, master):
        zeros = lambda: tree_map(torch.zeros_like, master)  # noqa: E731
        return {"momentum": zeros(), "adam_mu": zeros(), "adam_nu": zeros(), "count": 0}

    @torch.no_grad()
    def step(self, grads, state, master, lr, params):
        count = state["count"] + 1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        for p, g, mom, mu, nu, out in walk(master, grads, state["momentum"], state["adam_mu"],
                                            state["adam_nu"], params):
            g = g.float()
            decay = self.wd * p if self.wd else 0.0
            if _is_matrix(g):
                mom.mul_(self.beta).add_(g)
                ortho = newton_schulz_orthogonalize(self.beta * mom + g, steps=self.ns_steps)
                # scale to the RMS of Adam-style updates: 0.2 * sqrt(max dim)
                scale = float(0.2 * np.sqrt(np.float32(max(g.shape))))
                p.add_(-lr * (ortho * scale + decay))
            else:
                mu.mul_(self.b1).add_((1 - self.b1) * g)
                nu.mul_(self.b2).add_((1 - self.b2) * g.square())
                u = (mu / bc1) / ((nu / bc2).sqrt() + self.eps) + decay
                p.add_(-lr * self.adam_lr_ratio * u)
            if out is not p:
                out.copy_(p)
        return dict(state, count=count)


__all__ = ["MuonTransform", "NS_COEFFS", "newton_schulz_orthogonalize"]
