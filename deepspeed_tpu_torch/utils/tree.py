"""Nested dicts of tensors: the port's parameter and state trees.

Leaves come in insertion order (the JAX package's pytrees sort dict keys;
where that order matters, as in a checkpoint, the writer sorts).
"""


def leaves(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of ``rest``, in step)."""
    return {
        k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
        else fn(v, *(r[k] for r in rest))
        for k, v in tree.items()
    }


def tree_map_with_path(fn, tree, path=()):
    """``fn(key path, leaf)`` over the leaves of a nested dict; the path is
    the tuple of keys (``utils.pytree.path_str`` renders it)."""
    return {k: tree_map_with_path(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def walk(tree, *rest):
    """Tuples of the leaves of ``tree`` and of ``rest``, in step."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from walk(v, *(r[k] for r in rest))
        else:
            yield (v, *(r[k] for r in rest))
