#!/usr/bin/env python3
"""The evoformer forward kernel built in other forms than the tree's, timed
in turns with the tree's own build on one card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_evoformer_fwd_forms.py [NAME ...] [--rounds 1]

Each form rewrites ``csrc/evoformer_fwd.cu`` in a copy of ``csrc/`` under
``build/`` and builds it with the registry's ``nvcc`` flags:

  * ``wgs2`` / ``wgs1``: at most two / one warpgroups a CTA at d <= 64 in
    bf16 (the tree takes up to four, three rows of the slab's readers more);
  * ``stages2``: two stages a warpgroup in bf16 too (each step issues the
    next step's copies before its own products; the tree takes one in bf16,
    two in fp32 up to d 64);
  * ``no_slab``: the batch-invariant pair bias copied per step and per row,
    a [64, 64] tile from L2, as the operands that differ per row are (what
    the group of rows a CTA saves);
  * ``no_bias_reads``: the per-pair reads of the staged bias replaced by 0
    (wrong values; timed only): the most that keeping the bias in
    registers across rows (key tile outer, the group's rows inner, each
    row's softmax state in registers) could save over the tree's rows-outer
    walk, which reads each pair's bias from shared memory once a row.

Then the tree's build and each form time ``evoformer_fwd`` at
``chip_smoke.py``'s msa_row and triangle shapes (AlphaFold's mask and a
pair bias, ``evo_inputs``) in bf16, and msa_row in fp32, each in a fresh
process, in turns (the tree, then the form; the forms in order, then in
reverse); every form but ``no_bias_reads`` is first held against the
plain forward (max abs err). Prints the card's name and power limit first,
then one JSON object per run and a summary.
"""

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = "evoformer_fwd.cu"
FORMS = {
    "wgs2": [("return is_bf16<T>() && D <= 64 ? 4 : 2;",
              "return is_bf16<T>() && D <= 64 ? 2 : 2;")],
    "wgs1": [("return is_bf16<T>() && D <= 64 ? 4 : 2;",
              "return is_bf16<T>() && D <= 64 ? 1 : 1;")],
    "stages2": [("return is_bf16<T>() || D > 64 ? 1 : 2;", "return D > 64 ? 1 : 2;")],
    "no_slab": [("return (slab && fit(true, most < 2 ? most : 2)) || fit(false, 1);",
                 "return fit(false, 1);")],
    "no_bias_reads": [("return make_float2(a.x + b.x, a.y + b.y);",
                       "return make_float2(0.f, 0.f);")],
}

CHILD = r"""
import ctypes, json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as C
from deepspeed_tpu_torch.ops import kernels as K
from deepspeed_tpu_torch.ops.deepspeed4science import evoformer_attn as E
lib_path, check = sys.argv[2], sys.argv[3] == "1"
k = K.KERNELS["evoformer_fwd"]
if lib_path != "tree":
    lib = ctypes.CDLL(lib_path)
    lib.dstt_error_string.argtypes = [ctypes.c_int]
    lib.dstt_error_string.restype = ctypes.c_char_p
    fn = getattr(lib, k.symbol)
    fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
    k._lib, k._fn = lib, fn
else:
    K.build([k])
dev = torch.device("cuda", 0)
ms, err = {}, {}
for name, dtype in (("msa_row", torch.bfloat16), ("triangle", torch.bfloat16),
                    ("msa_row", torch.float32)):
    sh = C.EVOFORMER_SHAPES[name]
    n, s, h, d = sh["n"], sh["s"], sh["h"], sh["d"]
    tag = f"{name}_{'bf16' if dtype == torch.bfloat16 else 'fp32'}"
    q, k_, v, do, b1, b2 = C.evo_inputs(torch, dev, n, s, h, d, dtype, 300)
    q, k_, v = (t.reshape(n, s, h, d) for t in (q, k_, v))
    ops = E._operands([b1, b2], (1, n), h, s)
    if check:
        out, lse = E.evoformer_fwd_cuda(q, k_, v, ops)
        ref, ref_lse = E.evoformer_fwd_reference(q, k_, v, ops)
        err[tag] = max(float((out.float() - ref.float()).abs().max()),
                       float((lse - ref_lse).abs().max() / ref_lse.abs().max()))
        del out, lse, ref, ref_lse
    ms[tag] = C.time_ms(torch, lambda: E.evoformer_fwd_cuda(q, k_, v, ops), iters=10)
    del q, k_, v, do, b1, b2, ops
    torch.cuda.empty_cache()
print(json.dumps({"ms": ms, "max_abs_err": err}))
"""


def build_form(name, edits):
    """A copy of csrc/ with the form's edits, and evoformer_fwd.cu built
    from it; returns the library's path."""
    sys.path.insert(0, str(ROOT))
    from deepspeed_tpu_torch.ops import kernels as K

    where = ROOT / "build" / "evoformer_fwd_forms" / name
    if where.exists():
        shutil.rmtree(where)
    shutil.copytree(K.CSRC, where / "csrc")
    src = where / "csrc" / SRC
    text = src.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"form {name}: '{old}' not in {SRC}")
        text = text.replace(old, new)
    src.write_text(text)
    lib = where / "evoformer_fwd.so"
    cmd = [K.nvcc_path(), *K.NVCC_FLAGS, "-I", str(where / "csrc"), "-o", str(lib), str(src)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise SystemExit(f"form {name}: nvcc failed\n{out.stdout[-3000:]}{out.stderr[-3000:]}")
    return str(lib)


def run(lib, check):
    out = subprocess.run([sys.executable, "-c", CHILD, str(ROOT), lib, "1" if check else "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
        raise SystemExit(1)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("forms", nargs="*", default=list(FORMS), help=f"of {sorted(FORMS)}")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_evoformer_fwd_forms: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    libs = {name: build_form(name, FORMS[name]) for name in args.forms}
    ms = {name: [] for name in ["tree"] + args.forms}
    for _ in range(args.rounds):
        for name in args.forms + args.forms[::-1]:
            for who in ("tree", name):
                rec = run("tree" if who == "tree" else libs[who], who != "no_bias_reads")
                rec["form"] = who
                print(json.dumps(rec), flush=True)
                ms[who].append(rec["ms"])
    print(json.dumps({"card": card, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
