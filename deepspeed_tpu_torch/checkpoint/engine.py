"""The port's default checkpoint store and consolidated exports.

Counterpart of ``deepspeed_tpu/checkpoint/engine.py``. The JAX package's
default store (``checkpoint.writer`` unset) is orbax, which the port may not
import. The port's default is the synchronous npz writer's archive
(``runtime/checkpoint_engine``), which the JAX engine reads with
``checkpoint.writer = "sync"``:

    <save_dir>/<tag>/state.npz         leaves in the JAX package's flatten order
    <save_dir>/<tag>/state.meta.json   the client state and counters
    <save_dir>/<tag>/state.names.json  each leaf's dotted path
    <save_dir>/latest                  the newest tag
    <save_dir>/zero_to_fp32.py         the standalone fp32 recovery script

A tag that holds only an orbax ``state/`` directory (the JAX package's
default) is refused with that reason (``check_loadable``).
"""

import os
import shutil

import numpy as np

from deepspeed_tpu_torch.utils.logging import log_dist, logger

DEFAULT_WRITER = "sync"


def copy_recovery_script(save_dir: str):
    """Ship the standalone fp32 recovery script with the checkpoint (as the
    JAX package does on every save)."""
    try:
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "zero_to_fp32.py")
        shutil.copy2(src, os.path.join(save_dir, "zero_to_fp32.py"))
    except OSError as e:
        logger.warning(f"could not copy zero_to_fp32.py into checkpoint dir: {e}")


def check_loadable(state_path: str):
    """Refuse a tag that holds only the JAX package's orbax store."""
    base = os.path.dirname(state_path)
    if os.path.isdir(state_path) and not any(
            f.startswith("state") and f.endswith(".npz") for f in os.listdir(base)):
        raise NotImplementedError(
            f"{state_path} is an orbax store (the JAX package's default). The port's "
            "default checkpoint store is the npz archive, and the port reads no orbax "
            "store (ROADMAP queue 1, item 8): save it from the JAX engine with "
            "checkpoint.writer 'sync'")


def save_16bit_model(save_dir: str, save_filename: str, params) -> str:
    """Consolidated single-file export of ``params`` in their own dtype: one
    ``.npz`` with dotted names (bf16 leaves as 2-byte void entries, as the
    checkpoint archive stores them)."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
        tensor_to_numpy,
        tree_leaves,
        tree_paths,
    )

    os.makedirs(save_dir, exist_ok=True)
    flat = {name: tensor_to_numpy(t) for name, t in zip(tree_paths(params), tree_leaves(params))}
    name = (save_filename.replace(".bin", ".npz") if save_filename.endswith(".bin")
            else save_filename)
    out = os.path.join(save_dir, name)
    np.savez(out, **flat)
    log_dist(f"Saved 16-bit model to {out}", ranks=[0])
    return out


__all__ = ["DEFAULT_WRITER", "check_loadable", "copy_recovery_script", "save_16bit_model"]
