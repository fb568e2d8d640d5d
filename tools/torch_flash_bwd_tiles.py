#!/usr/bin/env python3
"""The flash backward kernels built with other tiles than the tree's, timed
in turns with the tree's own build on one card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_flash_bwd_tiles.py [NAME=D:FIELD=V[,FIELD=V...] ...]

Each variant rewrites the ``BwdTiles<D>`` specialisation of
``csrc/flash_hopper_bwd.cuh`` (fields BQ, BK, KV_BK, KV_BQ, STAGES,
KV_STAGES) and, with the fields CONSUMER_REGS and PRODUCER_REGS, the
header's setmaxnreg split (both CTA bodies), in a copy of ``csrc/`` under
``build/``, and builds
``flash_bwd.cu`` from it with the registry's ``nvcc`` flags. Then the
tree's build and each variant time ``flash_bwd_dq`` and ``flash_bwd_dkv``
at ``chip_smoke.py``'s train shape (b 1, 32/8 heads, s 4096, causal, window
4096) at the variant's head dim, each in a fresh process, in turns (the
tree, then the variant; the variants in order, then in reverse); every
result is first held per 64-row tile against the plain backward
(``chip_smoke.tile_rel_err``). With no arguments the variants are the ones
the tree's tiles were chosen against. Prints the card's name and power
limit first, then one JSON object per run.
"""

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("BQ", "BK", "KV_BK", "KV_BQ", "STAGES", "KV_STAGES")
REG_FIELDS = ("CONSUMER_REGS", "PRODUCER_REGS")
DEFAULT = (
    "two_stages_d128=128:STAGES=2,KV_STAGES=2",
    "four_stages_d128=128:STAGES=4",
    "four_stages_d64=64:STAGES=4,KV_STAGES=4",
    "kv_bq32_d256=256:KV_BQ=32,KV_STAGES=3",
    "regs240_d128=128:CONSUMER_REGS=240,PRODUCER_REGS=24",
)

CHILD = r"""
import ctypes, json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as C
from deepspeed_tpu_torch.ops import kernels as K
from deepspeed_tpu_torch.ops.attention import flash as F
lib_path, d = sys.argv[2], int(sys.argv[3])
if lib_path != "tree":
    lib = ctypes.CDLL(lib_path)
    lib.dstt_error_string.argtypes = [ctypes.c_int]
    lib.dstt_error_string.restype = ctypes.c_char_p
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        k = K.KERNELS[name]
        fn = getattr(lib, k.symbol)
        fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
        k._lib, k._fn = lib, fn
dev = torch.device("cuda", 0)
q, k, v, do = C.flash_inputs(torch, dev, 1, 32, 8, 4096, d, seed=10)
kw = dict(causal=True, window=4096)
out, lse = F.flash_fwd_cuda(q, k, v, **kw)
got = (F.flash_bwd_dq_cuda(q, k, v, out, do, lse, **kw),
       *F.flash_bwd_dkv_cuda(q, k, v, out, do, lse, **kw))
want = F.flash_bwd_reference(q, k, v, out, do, lse, **kw)
tile = max(C.tile_rel_err(torch, f"d{d}", g, w) for g, w in zip(got, want))
del got, want
torch.cuda.empty_cache()
ms = {"flash_bwd_dq": C.time_ms(torch, lambda: F.flash_bwd_dq_cuda(q, k, v, out, do, lse, **kw),
                                iters=10),
      "flash_bwd_dkv": C.time_ms(torch, lambda: F.flash_bwd_dkv_cuda(q, k, v, out, do, lse, **kw),
                                 iters=10)}
print(json.dumps({"lib": lib_path, "d": d, "ms": ms, "tile_rel_frobenius": tile}))
"""


def parse(spec):
    """``NAME=D:FIELD=V,...`` -> (name, d, {field: value})."""
    name, rest = spec.split("=", 1)
    d, fields = rest.split(":", 1)
    over = {}
    for item in fields.split(","):
        key, val = item.split("=")
        if key not in FIELDS + REG_FIELDS:
            raise SystemExit(f"{spec}: {key} is not one of {FIELDS + REG_FIELDS}")
        over[key] = int(val)
    return name, int(d), over


def rewrite_tiles(text, d, over):
    """The header's text with the fields ``over`` of ``BwdTiles<d>`` (and of
    the register split) replaced, the others kept."""
    regs = {key: val for key, val in over.items() if key in REG_FIELDS}
    over = {key: val for key, val in over.items() if key not in REG_FIELDS}
    if regs:
        pat = re.compile(r"constexpr int CONSUMER_REGS = (\d+), PRODUCER_REGS = (\d+);")
        m = pat.search(text)
        if m is None:
            raise ValueError("no register split in the header")
        cur = {"CONSUMER_REGS": m.group(1), "PRODUCER_REGS": m.group(2)}
        cur.update({key: str(val) for key, val in regs.items()})
        text = text[:m.start()] + (f"constexpr int CONSUMER_REGS = {cur['CONSUMER_REGS']}, "
                                   f"PRODUCER_REGS = {cur['PRODUCER_REGS']};") + text[m.end():]
    pat = re.compile(r"(struct BwdTiles<%d> \{\s*static constexpr int )([^;]*);" % d)
    m = pat.search(text)
    if m is None:
        raise ValueError(f"no BwdTiles<{d}> in the header")
    fields = dict(item.strip().split(" = ") for item in m.group(2).split(","))
    if set(fields) != set(FIELDS):
        raise ValueError(f"BwdTiles<{d}> has fields {sorted(fields)}, expected {FIELDS}")
    fields.update({key: str(val) for key, val in over.items()})
    return text[:m.start(2)] + ", ".join(f"{key} = {fields[key]}" for key in FIELDS) + \
        text[m.end(2):]


def build_variant(name, d, over):
    """A copy of csrc/ with BwdTiles<d> rewritten, flash_bwd.cu built from
    it; returns the library's path."""
    sys.path.insert(0, str(ROOT))
    from deepspeed_tpu_torch.ops import kernels as K

    src_dir = ROOT / "build" / "bwd_tiles" / name
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(K.CSRC, src_dir)
    hdr = src_dir / "flash_hopper_bwd.cuh"
    hdr.write_text(rewrite_tiles(hdr.read_text(), d, over))
    lib = src_dir / "libflash_bwd.so"
    cmd = [K.nvcc_path(), *K.NVCC_FLAGS, "-I", str(src_dir), "-o", str(lib),
           str(src_dir / "flash_bwd.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{name}: nvcc exit {proc.returncode}\n{proc.stderr[-3000:]}")
    return str(lib)


def run_child(lib, d):
    out = subprocess.run([sys.executable, "-c", CHILD, str(ROOT), lib, str(d)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
        raise SystemExit(1)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(DEFAULT),
                    help="NAME=D:FIELD=V[,FIELD=V...] (fields: %s)" % ", ".join(FIELDS))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_flash_bwd_tiles: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    sys.path.insert(0, str(ROOT))
    from deepspeed_tpu_torch.ops import kernels as K

    K.build([K.KERNELS["flash_fwd"], K.KERNELS["flash_bwd_dq"]])
    variants = [parse(spec) for spec in args.variants]
    libs = [(name, d, build_variant(name, d, over)) for name, d, over in variants]
    for name, d, lib in libs + libs[::-1]:
        tree = run_child("tree", d)
        tree["variant"] = "tree"
        mine = run_child(lib, d)
        mine["variant"] = name
        for rec in (tree, mine):
            rec["card"] = card
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
