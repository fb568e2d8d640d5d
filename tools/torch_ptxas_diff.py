#!/usr/bin/env python3
"""The ptxas reports of the port's kernel sources in two checkouts, side by
side, per kernel function.

Run from the root of a checkout on a machine with nvcc:

    python3 tools/torch_ptxas_diff.py OTHER_ROOT [SOURCE ...]

SOURCE names files of ``deepspeed_tpu_torch/ops/kernels/csrc`` (default
``flash_fwd.cu flash_bwd.cu flash_chunk.cu``). Each is compiled in both
trees with the kernels' own flags (``ops/kernels.NVCC_FLAGS``, ``-Xptxas
-v``) into a temporary directory. A kernel function's report is its lines
of registers, barriers, stack, spills and shared memory; the function is
named by its mangled name with the anonymous namespace's per-file hash
taken out, so the same template instance matches across trees. Prints one
JSON line per function: ``same`` (both reports equal), ``only_here`` or
``only_there`` (the function exists in one tree), and both reports, then a
summary line. Exits 1 when a function of both trees has another report.
"""

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from deepspeed_tpu_torch.ops import kernels as K  # noqa: E402

DEFAULT = ("flash_fwd.cu", "flash_bwd.cu", "flash_chunk.cu")
ENTRY = re.compile(r"(?:Compiling entry function|Function properties for) '?(\w+)'?")
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")


def reports(root: Path, source: str, out: Path):
    csrc = root / "deepspeed_tpu_torch" / "ops" / "kernels" / "csrc"
    proc = subprocess.run([K.nvcc_path(), *K.NVCC_FLAGS, "-I", str(csrc), "-o", str(out),
                           str(csrc / source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}/{source}: nvcc exit {proc.returncode}\n{proc.stderr}")
    found, cur = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = ENTRY.search(line)
        if m:
            cur = ANON.sub("_anon_", m.group(1))
            found.setdefault(cur, [])
            continue
        if cur and (("ptxas" in line and "Used" in line) or "spill" in line):
            found[cur].append(line.split(":", 1)[-1].strip() if "ptxas" in line
                              else line.strip())
    return found


def main(argv):
    if not argv:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    other = Path(argv[0]).resolve()
    sources = argv[1:] or DEFAULT
    differ = 0
    with tempfile.TemporaryDirectory() as tmp:
        for source in sources:
            here = reports(ROOT, source, Path(tmp) / f"here_{source}.so")
            there = reports(other, source, Path(tmp) / f"there_{source}.so")
            for name in sorted(set(here) | set(there)):
                a, b = here.get(name), there.get(name)
                state = ("only_here" if b is None else "only_there" if a is None
                         else "same" if a == b else "differ")
                differ += state == "differ"
                print(json.dumps({"source": source, "function": name, "state": state,
                                  "here": a, "there": b}), flush=True)
    print(json.dumps({"sources": list(sources), "functions_differing": differ}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
