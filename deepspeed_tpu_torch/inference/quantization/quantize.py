"""Weight-only quantization of inference params (counterpart of
``deepspeed_tpu/inference/quantization/quantize.py``).

A quantized weight is a :class:`QuantizedWeight` holding the int8 (or
packed int4) payload and fp32 scales per block of ``group`` along the LAST
dim; the model dequantizes it to its dtype before the product. Norm
scales, biases and embeddings are meant to stay wide (the exclusion list
of ``compression.transforms``). The list matches a leaf's last path
segment by substring, and the model names its biases ``wq_b``,
``w_up_b`` and so on: stacked [L, n] biases have two dims, none of the
list's patterns, and are quantized, in the JAX package as here (ROADMAP
section 3 records it).
"""

from typing import Any, Sequence

import torch

from deepspeed_tpu_torch.compression.transforms import NON_WEIGHT_PATTERNS
from deepspeed_tpu_torch.ops.quantizer.block_quant import true_div
from deepspeed_tpu_torch.utils.pytree import path_str
from deepspeed_tpu_torch.utils.tree import leaves, tree_map_with_path

_QMAX = {8: 127.0, 4: 7.0}


class QuantizedWeight:
    """An int payload ``q`` (int8; for bits 4 two codes + 7 a byte, low
    nibble first) and fp32 block scales ``s`` [..., d / group]. ``w[li]``
    slices the leading (layer) dim of both."""

    def __init__(self, q, s, bits: int, group: int):
        self.q = q
        self.s = s
        self.bits = bits
        self.group = group

    @property
    def shape(self):
        d = self.q.shape[-1] * (2 if self.bits == 4 else 1)
        return torch.Size(tuple(self.q.shape[:-1]) + (d,))

    @property
    def nbytes(self):
        return int(self.q.numel() * self.q.element_size() + self.s.numel() * self.s.element_size())

    def __getitem__(self, idx):
        return QuantizedWeight(self.q[idx], self.s[idx], self.bits, self.group)

    def __repr__(self):
        return (f"QuantizedWeight(shape={tuple(self.shape)}, bits={self.bits}, "
                f"group={self.group})")


def is_quantized_leaf(node) -> bool:
    return isinstance(node, QuantizedWeight)


def _quantize_block_rows(w, bits: int, group: int):
    d = w.shape[-1]
    qmax = _QMAX[bits]
    blocks = w.float().reshape(tuple(w.shape[:-1]) + (d // group, group))
    absmax = blocks.abs().amax(dim=-1, keepdim=True)
    scales = true_div(absmax, qmax).clamp_min(1e-12)
    q = torch.clamp(torch.round(blocks / scales), -qmax, qmax).reshape(w.shape)
    if bits == 4:
        lo, hi = q[..., ::2], q[..., 1::2]
        payload = ((lo + 7).to(torch.uint8) | ((hi + 7).to(torch.uint8) << 4)).view(torch.int8)
    else:
        payload = q.to(torch.int8)
    return payload, scales[..., 0]


def _quantize_leaf(w, bits: int, group: int) -> QuantizedWeight:
    if w.dim() < 3:
        return QuantizedWeight(*_quantize_block_rows(w, bits, group), bits, group)
    # stacked layers one at a time: the fp32 transients are one layer's
    parts = [_quantize_block_rows(w[i], bits, group) for i in range(w.shape[0])]
    return QuantizedWeight(torch.stack([p[0] for p in parts]),
                           torch.stack([p[1] for p in parts]), bits, group)


def dequantize_leaf(node: QuantizedWeight, dtype=torch.bfloat16):
    """codes x block scales in fp32, rounded once to ``dtype``: the JAX
    package's values, bit for bit. One product over the integer codes
    writes ``dtype`` directly (no fp32 copy of the weight in between)."""
    if node.bits == 4:
        u = node.q.view(torch.uint8)
        codes = torch.stack([u & 0xF, u >> 4], dim=-1).view(torch.int8).reshape(node.shape) - 7
    else:
        codes = node.q
    d = codes.shape[-1]
    blocks = codes.reshape(tuple(codes.shape[:-1]) + (d // node.group, node.group))
    out = torch.empty(blocks.shape, dtype=dtype, device=codes.device)
    torch.mul(blocks, node.s[..., None], out=out)
    return out.reshape(node.shape)


def maybe_dequantize(node, dtype=torch.bfloat16):
    """Identity for wide leaves; the dequantized tensor for a
    QuantizedWeight. The model calls this on one layer's slice at a time,
    so the wide copy is one layer's weights, never the model's."""
    return dequantize_leaf(node, dtype) if isinstance(node, QuantizedWeight) else node


def quantize_inference_params(params: Any, bits: int = 8, group_size: int = 128,
                              exclude: Sequence[str] = NON_WEIGHT_PATTERNS) -> Any:
    """Matmul-weight leaves -> :class:`QuantizedWeight`; everything else
    unchanged (a leaf whose last dim the group does not divide stays
    wide). The model and both engines take the result as they take wide
    params."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def visit(path, leaf):
        last = path_str(path).rsplit("/", 1)[-1]
        if getattr(leaf, "ndim", 0) < 2 or any(p in last for p in exclude):
            return leaf
        if leaf.shape[-1] % group_size or (bits == 4 and leaf.shape[-1] % 2):
            return leaf
        return _quantize_leaf(leaf, bits, group_size)

    return tree_map_with_path(visit, params)


def model_memory_bytes(params: Any) -> int:
    """Bytes held by the (possibly quantized) param tree."""
    total = 0
    for _, leaf in leaves(params):
        total += leaf.nbytes if isinstance(leaf, QuantizedWeight) else (
            leaf.numel() * leaf.element_size())
    return int(total)
