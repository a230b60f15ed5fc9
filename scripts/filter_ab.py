#!/usr/bin/env python3
"""Time one checkout's filter levels on the card, for comparing two trees.

    python3 scripts/filter_ab.py ROOT OUT.json [--build-only]

Imports ``alivevc_tpu_torch`` and ``chip_smoke`` from the checkout at ROOT
(its kernels are built from ROOT's sources into ROOT's own build
directory), then runs ``chip_smoke.check_filter_levels`` on a decoder drawn
from seed 0: the four up levels at the bench shape (16 windows of 144 000
samples) in float32 and bf16, and at the streaming hop's shape (N = 1,
7 680 samples) in float32.  Each row holds the kernel's time, the plain
version's, the level's eight products in cuDNN/cuBLAS and the bound; the
rows, the card's name and power limit go to OUT.json.  ``--build-only``
builds ROOT's filter kernels and stops.

Two trees are compared within one call on one card, in turns (A, B, B, A):
the card's times move between calls.  For example, with the parent commit
unpacked by ``git archive`` into ``archive_check/parent``:

    python3 scripts/filter_ab.py archive_check/parent --build-only &
    python3 scripts/filter_ab.py . --build-only; wait
    for r in archive_check/parent . . archive_check/parent; do
        python3 scripts/filter_ab.py $r chiprun_out/ab_$(basename $(realpath $r))_$((i++)).json
    done
"""

from __future__ import annotations

import json
import os
import sys
import time


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.realpath(sys.argv[1])
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("filter_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from alivevc_tpu_torch.config import DecoderConfig
    from alivevc_tpu_torch.kernels import _lib
    from alivevc_tpu_torch.models.decoder import Decoder

    if not os.path.realpath(_lib.PKG).startswith(root):
        print(f"filter_ab: imported {_lib.PKG}, not the package under {root}", file=sys.stderr)
        return 2
    secs = _lib.build_all(["filter"])
    if "--build-only" in sys.argv[3:]:
        print(f"filter_ab: built {root} in {secs:.1f} s")
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    card = chip_smoke.card_line()
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    dec = Decoder(DecoderConfig(), generator=torch.Generator().manual_seed(chip_smoke.SEED)).cuda().eval()
    t0 = time.perf_counter()
    rows = chip_smoke.check_filter_levels(gen, dec)
    rows += chip_smoke.check_filter_levels(gen, dec, n=1, lw=chip_smoke.HOP_WINDOW, dtypes=("f32",),
                                           tag=" (hop)")
    chip_smoke.print_rows(rows, card)
    with open(sys.argv[2], "w") as f:
        json.dump({"root": root, "card": card, "seconds": time.perf_counter() - t0, "rows": rows}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
