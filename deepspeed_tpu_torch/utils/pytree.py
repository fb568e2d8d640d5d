"""Tree-path helpers for the port's parameter trees (counterpart of
``deepspeed_tpu/utils/pytree.py``, used by the compression matchers and
the quantizers; ``utils.tree.tree_map_with_path`` walks the paths).

The port's params are nested dicts of tensors; a leaf's path is the tuple
of its keys, and ``path_str`` renders it as the JAX package renders a
``tree_flatten_with_path`` key path: '/'-joined and lowercased
(``layers/wq``, ``lm_head``), so every pattern matches the same leaves in
both packages.
"""


def path_str(path) -> str:
    """'/'-joined, lowercased render of a leaf's key path."""
    return "/".join(str(p) for p in path).lower()


def segments_match(name: str, pattern: str) -> bool:
    """Pattern matches when its '/'- or '.'-separated segments appear as a
    CONTIGUOUS run of full segments in ``name`` — 'layer_1' matches
    'layers/layer_1/w' but not 'layers/layer_10/w' (bare substring matching
    silently over-matches numbered modules)."""
    if pattern == "*":
        return True
    nsegs = name.lower().split("/")
    psegs = pattern.lower().replace(".", "/").split("/")
    n, m = len(nsegs), len(psegs)
    return any(nsegs[i : i + m] == psegs for i in range(n - m + 1))

