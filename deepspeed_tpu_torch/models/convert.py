"""Parameters and optimizer state between the two packages.

``params_from_numpy`` turns the JAX package's parameter pytree, taken to
the host as numpy (``jax.tree.map(np.asarray, params)``), into the port's
parameters: the same nested dict of the same shapes and layout, as torch
tensors on ``device``, every family's leaves included (the MoE router and
[L, E, h, f] experts, residual and shared experts, ``type_embed``, the
``mlm_*`` head), and the JAX package's weight-only quantized leaves
(``QuantizedWeight``: its int8 payload, fp32 scales, bits and group) as the
port's ``QuantizedWeight``. Both packages then compute on identical weights.
``opt_state_from_numpy`` does the same for an optimizer state (masters,
moments, count), so a trajectory can continue in the port from where the
JAX engine stands.
"""

from typing import Any, Dict, Optional

import numpy as np
import torch

_NUMPY_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int8): torch.int8,
}


def _leaf(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16: go through its raw bits (ml_dtypes arrays)
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    elif a.dtype in _NUMPY_TO_TORCH:
        t = torch.from_numpy(np.array(a))  # a writable copy
    else:
        raise TypeError(f"params_from_numpy: unsupported leaf dtype {a.dtype}")
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def quantized_from_numpy(node, device="cpu"):
    """A JAX ``QuantizedWeight`` holding numpy arrays (``q`` int8, ``s``
    fp32, ``bits``, ``group``) -> the port's ``QuantizedWeight`` with the
    same payload and scales, bit for bit."""
    from deepspeed_tpu_torch.inference.quantization.quantize import QuantizedWeight

    return QuantizedWeight(_leaf(node.q, device, None), _leaf(node.s, device, None),
                           int(node.bits), int(node.group))


def _is_quantized(v) -> bool:
    return all(hasattr(v, a) for a in ("q", "s", "bits", "group"))


def params_from_numpy(tree: Dict[str, Any], device="cpu",
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same dict of torch tensors on
    ``device``; floating leaves cast to ``dtype`` when given. Quantized
    leaves cross as they are (``quantized_from_numpy``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = params_from_numpy(v, device, dtype)
        elif _is_quantized(v):
            out[k] = quantized_from_numpy(v, device)
        else:
            out[k] = _leaf(v, device, dtype)
    return out


def _named_fields(state, found):
    """Collect the fields of every named tuple inside ``state`` (a named
    tuple, or nested tuples of them, as optax chains its states)."""
    if hasattr(state, "_asdict"):
        for k, v in state._asdict().items():
            found.setdefault(k, v)
    elif isinstance(state, (tuple, list)):
        for s in state:
            _named_fields(s, found)
    return found


def opt_state_from_numpy(state, fields, device="cpu"):
    """The JAX package's ``OptState(master, inner)``, taken to the host as
    numpy, as the port's ``OptState``. ``fields`` are the port transform's
    ``state_fields`` (e.g. ``("m", "v", "count")`` for FusedAdam, ``("count",
    "mu", "nu")`` for Adam): each is looked up by name among the named
    tuples of ``inner`` (a ``FusedAdamState``, or optax's chained states);
    trees become tensors on ``device``, counts Python ints."""
    from deepspeed_tpu_torch.runtime.optimizers import OptState

    found = _named_fields(state.inner, {})
    inner = {}
    for f in fields:
        if f not in found:
            raise KeyError(f"opt_state_from_numpy: no field {f!r} in {sorted(found)}")
        v = found[f]
        inner[f] = params_from_numpy(v, device) if isinstance(v, dict) else int(np.asarray(v))
    return OptState(master=params_from_numpy(state.master, device), inner=inner)
