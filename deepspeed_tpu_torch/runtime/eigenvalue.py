"""Eigenvalue estimation by power iteration (counterpart of
``deepspeed_tpu/runtime/eigenvalue.py``; reference ``runtime/eigenvalue.py``):
the top Hessian eigenvalue per layer block drives MoQ's quantization
period scaling (layers with high curvature quantize later).

The Hessian-vector product is ``torch.func.jvp`` of ``torch.func.grad``.
Forward-mode AD does not pass through an ``autograd.Function``: the
port's kernel wrappers (flash, RMSNorm, fused CE, qmatmul) are such
Functions, as the JAX package's custom-vjp kernels take no jvp either. The
loss handed in must run the plain path: ``models.transformer.
forward_reference`` (``mha_reference``, ``rms_norm_reference``) or plain
torch of its own. Random start vectors come from a ``torch.Generator``, so
they differ from the JAX package's draws; the eigenvalue they converge to
does not.
"""

from typing import Any, Callable, Dict, Optional

import torch

from deepspeed_tpu_torch.utils.tree import leaves, tree_map


def _leaves(t):
    """The leaves of a nested dict of tensors, or the one tensor."""
    return [l for _, l in leaves(t)] if isinstance(t, dict) else [t]


def _map(fn, t, *rest):
    return tree_map(fn, t, *rest) if isinstance(t, dict) else fn(t, *rest)


class Eigenvalue:
    def __init__(self, max_iter: int = 100, tol: float = 1e-2, stability: float = 1e-6):
        self.max_iter = max_iter
        self.tol = tol
        self.stability = stability

    def _hvp(self, loss_fn: Callable, params: Any, vec: Any) -> Any:
        """Hessian-vector product: jvp of grad."""
        _, hv = torch.func.jvp(torch.func.grad(loss_fn), (params,), (vec,))
        return hv

    def compute_eigenvalue(self, loss_fn: Callable, params: Any,
                           rng: Optional[torch.Generator] = None) -> float:
        """Top eigenvalue (its magnitude) of the loss Hessian w.r.t.
        ``params`` (a nested dict of tensors or one tensor) by normalized
        power iteration (the reference's Rayleigh loop)."""
        rng = rng if rng is not None else torch.Generator().manual_seed(0)
        # tangents match the primal dtypes (bf16 params stay bf16)
        v = _map(lambda l: torch.randn(l.shape, generator=rng).to(device=l.device, dtype=l.dtype),
                 params)

        def norm(t):
            return torch.sqrt(sum(l.float().square().sum() for l in _leaves(t)))

        def normalize(t, n):
            return _map(lambda l: (l.float() / (n + self.stability)).to(l.dtype), t)

        eig = 0.0
        v = normalize(v, norm(v))
        for _ in range(self.max_iter):
            hv = self._hvp(loss_fn, params, v)
            rayleigh = sum((a.float() * b.float()).sum() for a, b in zip(_leaves(v), _leaves(hv)))
            v = normalize(hv, norm(hv))
            new_eig = float(rayleigh)
            if eig and abs(new_eig - eig) / (abs(eig) + self.stability) < self.tol:
                eig = new_eig
                break
            eig = new_eig
        return abs(eig)

    def compute_layer_eigenvalues(self, loss_of_layers: Callable, layer_params: Any,
                                  rng: Optional[torch.Generator] = None) -> Dict[int, float]:
        """Per-layer top eigenvalues over a stacked [L, ...] layer tree (the
        reference's per-block loop): layer i's params vary, the others stay
        fixed. Layer i's start vector is drawn from a generator seeded with
        the given one's seed + i."""
        L = _leaves(layer_params)[0].shape[0]
        seed = rng.initial_seed() if rng is not None else 0
        out = {}
        for i in range(L):
            sub = _map(lambda l: l[i], layer_params)

            def loss_i(p_i, i=i):
                full = _map(lambda l, x: torch.cat([l[:i], x[None].to(l.dtype), l[i + 1:]]),
                            layer_params, p_i)
                return loss_of_layers(full)

            out[i] = self.compute_eigenvalue(loss_i, sub, torch.Generator().manual_seed(seed + i))
        return out


def quantize_period_scale(eigenvalues: Dict[int, float]) -> Dict[int, float]:
    """Reference MoQ scaling: layers with larger curvature get proportionally
    longer quantization periods (normalized to the max)."""
    mx = max(eigenvalues.values()) or 1.0
    return {k: v / mx for k, v in eigenvalues.items()}
