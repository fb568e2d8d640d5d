"""Parameters between the two packages.

``params_from_numpy`` turns the JAX package's parameter pytree, taken to
the host as numpy (``jax.tree.map(np.asarray, params)``), into the port's
parameters: the same nested dict of the same shapes and layout, as torch
tensors on ``device``. Both packages then compute on identical weights.
"""

from typing import Any, Dict, Optional

import numpy as np
import torch

_NUMPY_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
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


def params_from_numpy(tree: Dict[str, Any], device="cpu",
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same dict of torch tensors on
    ``device``; floating leaves cast to ``dtype`` when given."""
    out = {}
    for k, v in tree.items():
        out[k] = params_from_numpy(v, device, dtype) if isinstance(v, dict) else _leaf(v, device, dtype)
    return out
