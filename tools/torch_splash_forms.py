#!/usr/bin/env python3
"""The splash forward and dq kernels built in other forms than the tree's,
timed in turns with the tree's own build on one card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_splash_forms.py [NAME ...] [--rounds 1]

Each form rewrites sources in a copy of ``csrc/`` under ``build/`` and
builds ``splash_fwd.cu`` and ``splash_bwd.cu`` from it with the registry's
``nvcc`` flags:

  * ``v_after_k``: the forward's producer issues each tile's V right after
    its K, as the flash walk does, and walks the next tile after that (the
    tree walks the next tile before it waits for the V stage);
  * ``flash_consumer``: both bodies' consumers take the flash walk's whole
    tile rule and ``visible`` in place of the stage's code and kinds (right
    only where the schedule is the flash window: the timed LocalMask); what
    the scheduled predicate costs the consumers;
  * ``flash_both``: the same, and the producers walk the flash key range
    (key_tiles) in place of the schedule, handing over plain key positions:
    the flash kernels' code under the splash entry points (the timed
    LocalMask only); what the scheduled producer walk costs.

Then the tree's build and each form time ``splash_fwd`` and
``splash_bwd_dq`` at ``chip_smoke.py``'s timed splash shape (b 1, 32/8 heads
of 128, s 16384, LocalMask(16384, 4096) in 512-blocks) beside the tree's
flash forward and dq with the same window, each in a fresh process, in
turns (the tree, then the form; the forms in order, then in reverse). Each
run first checks that out, lse and dq equal flash's (as values). Prints the
card's name and power limit first, then one JSON object per run and a
summary.
"""

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the consumers' scheduled predicate (both bodies: the same text)
KEEP = ("""        if constexpr (W::SCHEDULED) {
          // both loads unconditional""", """        if constexpr (false) {
          // both loads unconditional""")
FLASH_WHOLE = ("""      whole = code == SCHEDULED_WHOLE;""",
               """      whole = !tile.segk && (!p.causal || k0 + BK - 1 <= r_lo) &&
              (!p.window || r_hi - k0 < p.window) && k0 + BK <= p.s && r_hi < p.s;""")
# the consumers' decoding of the stage word (the flash producer hands over k0)
DECODE = ("""    if constexpr (W::SCHEDULED) {
      code = """, """    if constexpr (false) {
      code = """)
FORMS = {
    "v_after_k": [("splash_common.cuh", """      if (n > 0) then(n - 1, last);
      issue(n, word, kc, ids);""", """      issue(n, word, kc, ids);
      then(n, k0);"""),
                  ("splash_common.cuh", """    if (n > 0) then(n - 1, last);
    return n;""", """    return n;""")],
    "flash_consumer": [(f, *e) for f in ("flash_hopper.cuh", "flash_hopper_bwd.cuh")
                       for e in (KEEP, FLASH_WHOLE)],
    "flash_both": [(f, *e) for f in ("flash_hopper.cuh", "flash_hopper_bwd.cuh")
                   for e in (KEEP, DECODE)] + [
        ("flash_hopper.cuh", """  if constexpr (W::SCHEDULED) {
    it = walk.template produce<D>""", """  if constexpr (false) {
    it = walk.template produce<D>"""),
        ("flash_hopper_bwd.cuh", """  if constexpr (W::SCHEDULED) {
    it = walk.template produce<D>(sm, maps, p, tile, lane);""", """  if constexpr (false) {
    it = walk.template produce<D>(sm, maps, p, tile, lane);""")],
}
SOURCES = ("splash_fwd.cu", "splash_bwd.cu")

CHILD = r"""
import ctypes, json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as C
from deepspeed_tpu_torch.ops import kernels as K
from deepspeed_tpu_torch.ops.attention import flash as F
from deepspeed_tpu_torch.ops.sparse_attention import LocalMask, schedule_from_mask
from deepspeed_tpu_torch.ops.sparse_attention import splash as SP
libs = json.loads(sys.argv[2])
K.build([K.KERNELS[n] for n in ("flash_fwd", "flash_bwd_dq")]
        + ([K.KERNELS[n] for n in ("splash_fwd", "splash_bwd_dq")] if not libs else []))
for name, path in libs.items():
    k = K.KERNELS[name]
    lib = ctypes.CDLL(path)
    lib.dstt_error_string.argtypes = [ctypes.c_int]
    lib.dstt_error_string.restype = ctypes.c_char_p
    fn = getattr(lib, k.symbol)
    fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
    k._lib, k._fn = lib, fn
dev = torch.device("cuda", 0)
t = C.SPLASH_TIMED
s, w = t["s"], t["window"]
sched = schedule_from_mask(LocalMask((s, s), w), t["block"])
q, k, v, do = C.flash_inputs(torch, dev, 1, 32, 8, s, 128, seed=71)
kw = dict(causal=True, window=w)
out, lse = SP.splash_fwd_cuda(q, k, v, sched)
fo, fl = F.flash_fwd_cuda(q, k, v, **kw)
dq = SP.splash_bwd_dq_cuda(q, k, v, out, do, lse, sched)
fdq = F.flash_bwd_dq_cuda(q, k, v, out, do, lse, **kw)
equal = {"out": bool(torch.equal(out, fo)), "lse": bool(torch.equal(lse, fl)),
         "dq": bool(torch.equal(dq, fdq))}
del fo, fl, dq, fdq
ms = {"splash_fwd": C.time_ms(torch, lambda: SP.splash_fwd_cuda(q, k, v, sched), iters=10),
      "flash_fwd": C.time_ms(torch, lambda: F.flash_fwd_cuda(q, k, v, **kw), iters=10),
      "splash_bwd_dq": C.time_ms(torch, lambda: SP.splash_bwd_dq_cuda(q, k, v, out, do, lse,
                                                                      sched), iters=10),
      "flash_bwd_dq": C.time_ms(torch, lambda: F.flash_bwd_dq_cuda(q, k, v, out, do, lse, **kw),
                                iters=10)}
print(json.dumps({"ms": ms, "equal_to_flash": equal}))
"""


def build_form(name, edits):
    """A copy of csrc/ with the form's edits, and the splash sources built
    from it; returns {kernel name: library path}."""
    sys.path.insert(0, str(ROOT))
    from deepspeed_tpu_torch.ops import kernels as K

    where = ROOT / "build" / "splash_forms" / name
    if where.exists():
        shutil.rmtree(where)
    shutil.copytree(K.CSRC, where / "csrc")
    for fname, old, new in edits:
        src = where / "csrc" / fname
        text = src.read_text()
        if old not in text:
            raise SystemExit(f"form {name}: '{old}' not in {fname}")
        src.write_text(text.replace(old, new))
    libs = {}
    for src in SOURCES:
        lib = where / src.replace(".cu", ".so")
        cmd = [K.nvcc_path(), *K.NVCC_FLAGS, "-I", str(where / "csrc"), "-o", str(lib),
               str(where / "csrc" / src)]
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            raise SystemExit(f"form {name}: nvcc failed\n{out.stdout[-3000:]}{out.stderr[-3000:]}")
        for kname, k in K.KERNELS.items():
            if k.source == src and kname in ("splash_fwd", "splash_bwd_dq"):
                libs[kname] = str(lib)
    return libs


def run(libs):
    out = subprocess.run([sys.executable, "-c", CHILD, str(ROOT), json.dumps(libs)],
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
        print("torch_splash_forms: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    libs = {name: build_form(name, FORMS[name]) for name in args.forms}
    ms = {name: [] for name in ["tree"] + args.forms}
    for _ in range(args.rounds):
        for name in args.forms + args.forms[::-1]:
            for who in ("tree", name):
                rec = run({} if who == "tree" else libs[who])
                rec["form"] = who
                print(json.dumps(rec), flush=True)
                ms[who].append(rec["ms"])
    print(json.dumps({"card": card, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
