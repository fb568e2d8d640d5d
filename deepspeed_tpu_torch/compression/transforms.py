"""Compression transforms (counterpart of
``deepspeed_tpu/compression/transforms.py``): functional forms of the
reference's ``compression/basic_layer.py`` mixins (``LinearLayer_Compress``
— weight / activation quantization, sparse / row / head pruning).

Each technique is a leaf transform applied to the params whose paths match
the reference's ``different_groups`` ``modules`` patterns (QAT fake-quant
during training, masks for pruning). Leaves with more than two dims
(stacked layers, experts) get their own scales and masks per leading
index. Scales divide as the JAX package's eager ops do, on any device
(``true_div``).
"""

from typing import Any, Dict, List, Sequence, Tuple

import torch

from deepspeed_tpu_torch.ops.quantizer.block_quant import true_div
from deepspeed_tpu_torch.utils.pytree import path_str, segments_match
from deepspeed_tpu_torch.utils.tree import leaves, tree_map, tree_map_with_path


def match_leaves(params: Any, patterns: Sequence[str]) -> List[Tuple[tuple, Any]]:
    """(key path, leaf) pairs matching any pattern by FULL path segments
    ('layer_1' does not match 'layer_10'; '*' matches everything — the
    reference's catch-all group)."""
    return [(tuple(name.split("/")), leaf) for name, leaf in leaves(params)
            if any(segments_match(name.lower(), p) for p in patterns)]


# norms/biases/embedding gathers are not matmul weights: the reference scopes
# techniques to Linear modules; the catch-all '*' group must not QAT-distort
# normalization scales (they are also what stacked [L, h] leaves mostly are)
NON_WEIGHT_PATTERNS = ("norm", "bias", "ln_", "layernorm", "embed", "pos_embed")


def _is_weight_leaf(name: str, leaf) -> bool:
    if getattr(leaf, "ndim", 0) < 2:
        return False
    last = name.rsplit("/", 1)[-1]
    return not any(p in last for p in NON_WEIGHT_PATTERNS)


def _apply_to_matched(params, patterns, leaf_fn, weights_only: bool = True):
    matched = {path for path, _ in match_leaves(params, patterns)}

    def visit(path, leaf):
        if path not in matched:
            return leaf
        if weights_only and not _is_weight_leaf(path_str(path), leaf):
            return leaf
        return leaf_fn(leaf)

    return tree_map_with_path(visit, params)


# ---------------------------------------------------------------------------
# quantization (QAT fake-quant)
# ---------------------------------------------------------------------------
def fake_quantize(x, bits: int, symmetric: bool = True):
    """Quantize-dequantize at ``bits`` (reference LinearLayer_Compress weight
    quantization forward), straight-through in the backward: the result is
    ``xf + (deq - xf).detach()``, the JAX package's expression op for op, so
    its bits match. Dims beyond the last two get their own scales."""
    levels = 2.0 ** (bits - 1) - 1 if symmetric else 2.0 ** bits - 1
    xf = x.float()
    dims = tuple(range(max(xf.dim() - 2, 0), xf.dim()))
    if symmetric:
        scale = true_div(xf.abs().amax(dim=dims, keepdim=True), levels).clamp_min(1e-12)
        deq = torch.clamp(torch.round(xf / scale), -levels, levels) * scale
    else:
        lo = xf.amin(dim=dims, keepdim=True)
        hi = xf.amax(dim=dims, keepdim=True)
        scale = true_div(hi - lo, levels).clamp_min(1e-12)
        deq = torch.clamp(torch.round((xf - lo) / scale), 0, levels) * scale + lo
    return (xf + (deq - xf).detach()).to(x.dtype)


def quantize_weights(params, patterns: Sequence[str], bits: int, symmetric: bool = True):
    return _apply_to_matched(params, patterns, lambda w: fake_quantize(w, bits, symmetric))


def quantize_activation(x, bits: int, range_calibration: str = "dynamic"):
    """Reference QuantAct (basic_layer.py:17): activation fake-quant."""
    return fake_quantize(x, bits, symmetric=True)


# ---------------------------------------------------------------------------
# pruning masks
# ---------------------------------------------------------------------------
def _top_k_threshold(a, ratio: float):
    """The k-th largest value along the last dim (k = ratio of it, at
    least 1), keepdim."""
    k = max(int(a.shape[-1] * ratio), 1)
    return torch.sort(a, dim=-1).values[..., -k][..., None]


def sparse_mask(w, dense_ratio: float, method: str = "l1"):
    """Unstructured magnitude mask keeping the top ``dense_ratio`` fraction
    per matrix (reference sparse_pruning l1/topk)."""
    lead = tuple(w.shape[:-2]) if w.dim() > 2 else ()
    a = w.float().abs().reshape(lead + (-1,))
    return (a >= _top_k_threshold(a, dense_ratio)).reshape(w.shape).to(w.dtype)


def row_mask(w, dense_ratio: float):
    """Structured mask by L2 norm over the input dim ([.., in, out]: prune
    OUTPUT features — reference nn.Linear rows)."""
    norms = torch.linalg.vector_norm(w.float(), dim=-2)  # [.., out]
    keep = (norms >= _top_k_threshold(norms, dense_ratio)).to(w.dtype)
    return keep[..., None, :].expand(w.shape)


def head_mask(w, num_heads: int, dense_ratio: float):
    """Attention-head mask: [.., in, H*d] weights pruned per head by L2
    norm (reference head_pruning on the attention output projection)."""
    in_dim, out_dim = w.shape[-2], w.shape[-1]
    if out_dim % num_heads != 0:
        raise ValueError(f"out dim {out_dim} not divisible by heads {num_heads}")
    d = out_dim // num_heads
    lead = tuple(w.shape[:-2])
    per_head = torch.linalg.vector_norm(
        w.float().reshape(lead + (in_dim, num_heads, d)), dim=(-3, -1))  # [.., H]
    keep = (per_head >= _top_k_threshold(per_head, dense_ratio)).to(w.dtype)
    keep = torch.repeat_interleave(keep, d, dim=-1)  # [.., H*d]
    return keep[..., None, :].expand(w.shape)


def prune_weights(params, patterns, dense_ratio, method: str = "sparse", num_heads: int = 0):
    def leaf_fn(w):
        if w.dim() < 2:
            return w
        if method == "sparse":
            return w * sparse_mask(w, dense_ratio)
        if method == "row":
            return w * row_mask(w, dense_ratio)
        if method == "head":
            return w * head_mask(w, num_heads, dense_ratio)
        raise ValueError(f"unknown pruning method {method!r}")

    return _apply_to_matched(params, patterns, leaf_fn)


def sparsity(params, patterns=("*",)) -> float:
    """Realized zero fraction over matched leaves."""
    total, zeros = 0, 0
    for _, leaf in match_leaves(params, patterns):
        if leaf.dim() >= 2:
            total += leaf.numel()
            zeros += int((leaf == 0).sum())
    return zeros / max(total, 1)


# ---------------------------------------------------------------------------
# layer reduction (depth distillation prep)
# ---------------------------------------------------------------------------
def reduce_layers(params: Dict[str, Any], keep_layers: Sequence[int], layers_key: str = "layers"):
    """Reference layer_reduction: keep only the listed layer indices of the
    stacked [L, ...] layer tree (student initialization from teacher
    depths)."""
    idx = list(keep_layers)
    out = dict(params)
    out[layers_key] = tree_map(lambda l: l[torch.as_tensor(idx, device=l.device)],
                               params[layers_key])
    return out
