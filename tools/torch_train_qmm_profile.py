#!/usr/bin/env python3
"""Where a ``matmul_precision`` training step spends its device time.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_train_qmm_profile.py

First runs ``chip_smoke.py``'s train_qmm phase (Mistral-7B width, 2 layers,
seq 4096, gas 2, FusedAdam in AdamW mode) with one more step per precision
(default, int8, fp8) under torch.profiler: each step's device time by
kernel (the top 24) and summed by kernel-name family (``QMM_PROFILE_SUMS``).
Then times, in CUDA graphs, the pieces of one projection's ``qmatmul`` on a
micro-batch through w_up ([4096, 4096] @ [4096, 14336]) and w_down
([4096, 14336] @ [14336, 4096]): per mode the forward's casts and its
library product; the backward's dx; its dw as ``qmatmul_vjp`` computes it
(fp32 operands, an fp32 product) and dw from the bf16 operands with fp32
accumulation (one bf16 product, rounded once), with that form's bit
mismatches and relative Frobenius error against the fp32 one. TF32 is off,
as in ``chip_smoke.py``. Prints the card's name and power limit, then one JSON object per part.
"""

import json
import sys
from pathlib import Path


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke as C
    from deepspeed_tpu_torch.ops import kernels as K
    from deepspeed_tpu_torch.ops import qmatmul as Q

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = C.card_info()
    print(card, flush=True)
    K.build()

    rec, _ = C.train_qmm_phase(torch, dev, K, profile=True)
    for mode, r in rec["modes"].items():
        prof = r["profile"][f"train_qmm[{mode}]_step"]
        print(json.dumps({"part": "step_profile", "mode": mode, "card": card,
                          "mean_step_seconds": r["mean_step_seconds"], "tok_s": r["tok_s"],
                          **prof}), flush=True)

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    for name, (m, k, n) in {"w_up": (4096, 4096, 14336), "w_down": (4096, 14336, 4096)}.items():
        g = torch.Generator(device=dev).manual_seed(C.SEED)
        x = torch.randn(m, k, generator=g, device=dev).bfloat16()
        w = (torch.randn(k, n, generator=g, device=dev) * k ** -0.5).bfloat16()
        gy = torch.randn(m, n, generator=g, device=dev).bfloat16()
        out = {"part": "projection", "name": name, "m": m, "k": k, "n": n, "card": card,
               "bf16_product_ms": C.time_ms(torch, lambda: x @ w)}
        for mode in Q.MODES:
            if mode == "fp8":
                def cast():
                    return Q._cast_fp8(x), Q._cast_fp8(w)

                (xq, sx), (wq, sw) = cast()

                def product():
                    return Q._fp8_library(xq, wq, sx, sw, x.dtype)
            else:
                dims = (-1, 0) if mode == "int8" else (None, None)

                def cast():
                    return Q._cast_i8(x, dims[0]), Q._cast_i8(w, dims[1])

                (xq, sx), (wq, sw) = cast()

                def product():
                    return Q._int8_library(xq, wq)
            out[mode] = {"forward_ms": C.time_ms(torch, lambda: Q.qmatmul_forward(x, w, mode)),
                         "cast_ms": C.time_ms(torch, cast),
                         "library_product_ms": C.time_ms(torch, product)}
        out["dx_ms"] = C.time_ms(torch, lambda: gy @ w.t())
        out["dw_fp32_ms"] = C.time_ms(torch, lambda: (x.t().float() @ gy.float()).to(w.dtype))
        out["dw_bf16_operands_ms"] = C.time_ms(torch, lambda: x.t() @ gy)
        dw32 = (x.t().float() @ gy.float()).to(w.dtype)
        dw16 = x.t() @ gy
        out["dw_bf16_operands_mismatch_share"] = C._bits_mismatch(torch, dw16, dw32) / dw32.numel()
        out["dw_bf16_operands_rel_frobenius"] = C._rel_fro(torch, dw16, dw32)
        print(json.dumps(out), flush=True)
        del x, w, gy, dw32, dw16
    return 0


if __name__ == "__main__":
    sys.exit(main())
