"""zero_to_fp32: consolidated fp32 weights from a checkpoint of the port.

Counterpart of ``deepspeed_tpu/checkpoint/zero_to_fp32.py`` over the port's
npz archive (``checkpoint/engine.py``). The engine copies this file into
every checkpoint directory; it needs only numpy and the standard library,
so it runs anywhere:

    python zero_to_fp32.py <checkpoint_dir> <output_file> [--tag TAG]

The output is an ``.npz`` mapping dotted parameter names (the JAX package's
names: ``embed``, ``layers.wq``, ...) to fp32 arrays. Where the optimizer
state carries fp32 masters (the first element of the archived optimizer
state) those are taken, being the exact values; otherwise the params are
cast.
"""

import argparse
import json
import os
import sys

import numpy as np


def _state_base(checkpoint_dir, tag):
    if tag is None:
        latest = os.path.join(checkpoint_dir, "latest")
        if not os.path.isfile(latest):
            raise FileNotFoundError(f"no 'latest' in {checkpoint_dir}; pass --tag")
        with open(latest) as f:
            tag = f.read().strip()
    for name in ("state", "state.rank0"):
        base = os.path.join(checkpoint_dir, str(tag), name)
        if os.path.isfile(base + ".npz"):
            if not os.path.isfile(base + ".names.json"):
                raise FileNotFoundError(
                    f"{base}.names.json is missing: the archive does not name its leaves")
            return base
    raise FileNotFoundError(f"no state.npz under {os.path.join(checkpoint_dir, str(tag))}")


def _fp32(a):
    a = np.asarray(a)
    if a.dtype == np.dtype("V2"):  # bf16 bits
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag=None):
    """Returns {dotted_name: fp32 ndarray} (the JAX package's function name)."""
    base = _state_base(checkpoint_dir, tag)
    with open(base + ".names.json") as f:
        names = json.load(f)
    data = np.load(base + ".npz", allow_pickle=False)

    def entry(section, i):
        return data[f"{section}::{i:06d}"]

    masters = {p[2:]: i for i, p in enumerate(names.get("opt_state", []))
               if p.startswith("0.")}
    out = {}
    for i, name in enumerate(names["params"]):
        j = masters.get(name)
        out[name] = _fp32(entry("opt_state", j) if j is not None else entry("params", i))
    return out


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir, output_file, tag=None):
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    if not output_file.endswith(".npz"):
        output_file += ".npz"
    np.savez(output_file, **sd)
    total = sum(v.size for v in sd.values())
    print(json.dumps({"output": output_file, "tensors": len(sd), "params": total}))
    return output_file


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "zero_to_fp32", description="Reconstruct consolidated fp32 weights from a checkpoint"
    )
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file")
    p.add_argument("--tag", default=None)
    args = p.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir, args.output_file, args.tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
