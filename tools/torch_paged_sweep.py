#!/usr/bin/env python3
"""The paged-decode kernels across split plans and ring shapes.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_paged_sweep.py [--targets 384,512,768,1024,2048]

For ``paged_decode`` and ``paged_decode_int8`` at ``chip_smoke.py``'s
kernel shapes (the Mistral-7B flat pool, R 32, 32/8 heads of 128, 5 blocks
of 128, E 64), times the round form (E 64), the split form (E 1) and the
per-row form (256 queries over one table, stride-0 extras), rotating over 8
layers as ``chip_smoke.py`` does, for each split-plan target
(``paged.SPLIT_TARGET_CTAS``) and for variants of the kernel source built
beside the real one: ``stages3`` (a 3-stage ring) and ``tile32_stages4``
(32-key tiles, 2 warps a CTA, a 4-stage ring). Every call is checked
against the plain version first. Prints the card's name and power limit,
then one JSON object per (kernel, variant, target).
"""

import argparse
import json
import sys
from pathlib import Path

VARIANTS = {
    "base": [],
    "stages3": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    "tile32_stages4": [("constexpr int STAGES = 2;", "constexpr int STAGES = 4;"),
                       ("return D == 256 ? 32 : 64;", "return 32;")],
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--targets", default="384,512,768,1024,2048")
    args = ap.parse_args(argv)
    targets = [int(x) for x in args.targets.split(",")]

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_paged_sweep: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke as C
    from deepspeed_tpu_torch.ops import kernels as K
    from deepspeed_tpu_torch.ops.attention import paged as pt

    class Variant(K.Kernel):
        """A kernel built from a rewritten copy of its source (in the build
        directory; the headers still come from csrc)."""

        def __init__(self, base, name, edits):
            stem = Path(base.source).stem
            super().__init__(f"{base.name}_{name}", f"{stem}_{name}.cu", base.symbol,
                             base.argtypes, base.replaces)
            text = base.source_path.read_text()
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"{name}: {old!r} is not in {base.source}")
                text = text.replace(old, new)
            self._path = K.BUILD_DIR / "variants" / self.source
            self._path.parent.mkdir(parents=True, exist_ok=True)
            self._path.write_text(text)

        @property
        def source_path(self):
            return self._path

    print(C.card_info(), flush=True)
    kernels = {(v, b): Variant(K.KERNELS[b], v, edits) if edits else K.KERNELS[b]
               for v, edits in VARIANTS.items() for b in ("paged_decode", "paged_decode_int8")}
    K.build(list(kernels.values()))
    dev = torch.device("cuda", 0)
    default_target = pt.SPLIT_TARGET_CTAS
    for int8 in (False, True):
        base = "paged_decode_int8" if int8 else "paged_decode"
        world = C.PagedWorld(torch, dev, torch.bfloat16, 32, 512, 128, 8, 128, C.SEED, int8=int8)
        cases = dict(C.paged_cases(torch, world, np.random.default_rng(C.SEED), 32, 32, 5, 31, 64))
        forms = {"round": cases["round_E64_limit"], "split": cases["split_E1_limit"],
                 "per_row": cases["per_row_t256"]}
        by_layer = {}
        for form, kw0 in forms.items():
            by_layer[form] = []
            for li in range(8):
                kw = dict(kw0, trash_block=world.trash(li))
                kw["block_tables"] = kw0["block_tables"] + (li - 31) * world.NBp
                by_layer[form].append(kw)
        for variant in VARIANTS:
            setattr(pt, "PAGED_INT8_KERNEL" if int8 else "PAGED_KERNEL", kernels[(variant, base)])
            for target in targets:
                pt.SPLIT_TARGET_CTAS = target
                rec = {"kernel": base, "variant": variant, "target_ctas": target}
                for form, kw0 in forms.items():
                    got = pt.paged_decode(**world.pool(), **kw0)
                    want = pt.paged_decode_attention_dense(**world.pool(), **kw0)
                    label = f"{base} {variant} {target} {form}"
                    C.check_close(torch, label, got, want, C.BF16_ATOL, C.BF16_RTOL)
                    C.check_rows(torch, label, got, want, C.PAGED_ROW_RTOL["bf16"])
                    it = iter(range(1 << 30))
                    layers = by_layer[form]
                    rec[f"{form}_ms"] = C.time_ms(
                        torch, lambda: pt.paged_decode(**world.pool(), **layers[next(it) % 8]))
                    rec[f"{form}_splits"] = C.paged_plan(world, kw0)["splits"]
                print(json.dumps(rec), flush=True)
        setattr(pt, "PAGED_INT8_KERNEL" if int8 else "PAGED_KERNEL", kernels[("base", base)])
        pt.SPLIT_TARGET_CTAS = default_target
        del world
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
