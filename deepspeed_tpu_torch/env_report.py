"""Environment report of the port (counterpart of ``deepspeed_tpu/env_report.py``,
the reference's ``ds_report``).

Prints the software stack (Python, the port, torch and the CUDA it was
built for, nvcc), the card's name and power limit as ``nvidia-smi`` reads
them, and the ``[OKAY]``/``[NO]`` table of the op registry. Run it as

    python -m deepspeed_tpu_torch.env_report
"""

import importlib
import re
import subprocess
import sys

GREEN_OK = "\033[92m[OKAY]\033[0m"
RED_NO = "\033[91m[NO]\033[0m"


def _try_version(mod: str):
    try:
        return getattr(importlib.import_module(mod), "__version__", "unknown")
    except Exception:
        return None


def _stdout(cmd):
    """A command's standard output, or None when it cannot run or fails."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout if out.returncode == 0 else None


def nvcc_version():
    """nvcc's release (e.g. "12.8, V12.8.93"), or None without nvcc."""
    from deepspeed_tpu_torch.ops.kernels import nvcc_path

    try:
        nvcc = nvcc_path()
    except RuntimeError:
        return None
    m = re.search(r"release (.+)$", _stdout([nvcc, "--version"]) or "", re.M)
    return m.group(1).strip() if m else None


def card():
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (the first card), or None without nvidia-smi."""
    lines = (_stdout(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]) or "").strip().splitlines()
    return lines[0].strip() if lines else None


def op_report():
    """(name, compatible) for every registered op."""
    import deepspeed_tpu_torch.ops  # noqa: F401  (populates the registry)
    from deepspeed_tpu_torch.ops.op_builder import ALL_OPS

    rows = []
    for name, builder in sorted(ALL_OPS.items()):
        try:
            compatible = builder().is_compatible()
        except Exception:
            compatible = False
        rows.append((name, compatible))
    return rows


def main():
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.accelerator import get_accelerator

    def row(what, value):
        print(f"{what:<22}{'.' * max(1, 22 - len(what))} {value if value else RED_NO}")

    print("-" * 60)
    print("DeepSpeed-TPU PyTorch/CUDA port environment report")
    print("-" * 60)
    row("python", sys.version.split()[0])
    row("deepspeed_tpu_torch", deepspeed_tpu_torch.__version__)
    row("torch", torch.__version__)
    row("torch cuda", torch.version.cuda)
    row("numpy", _try_version("numpy"))
    row("nvcc", nvcc_version())
    print("-" * 60)
    accel = get_accelerator()
    row("accelerator", accel._name)
    row("comm backend", accel.communication_backend_name())
    row("card", card())
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            print(f"  device {i}: {torch.cuda.get_device_name(i)}")
    print("-" * 60)
    print("op availability:")
    for name, ok in op_report():
        print(f"  {name:<28} {GREEN_OK if ok else RED_NO}")
    print("-" * 60)
    return 0


if __name__ == "__main__":
    sys.exit(main())
