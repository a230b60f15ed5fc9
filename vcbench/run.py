#!/usr/bin/env python3
"""The benchmark of ``alivevc_tpu_torch`` (the PyTorch and CUDA port) on
one NVIDIA card:

    python3 vcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  One run: set up (import, the card, the
port's kernels from ``alivevc_tpu_torch/_build/``, weights and inputs drawn
on the card from the seed, the cell's own shapes warmed up), measure for
``--seconds``, compare what the timed path produced with the plain
reference (``vcbench/reference/``), and print one JSON line last:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and ``checks``, each number compared with its
limit (also the last lines on standard error).

Exits non-zero, printing no result, without a CUDA card (or fewer than the
cell asks for), and when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / "out" / "cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the run at a fixed place inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT))
    import cell

    with open(ROOT / "BENCHMARK.json") as f:
        spec = cell.Spec(json.load(f), args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.cell["chips"]:
        print(f"needs {spec.cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    res = cell.run(spec, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = cell.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 4
    line = cell.result_line(spec, res, bool(args.trace), res.get("view"))
    print(f"correct: {line['correct']}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
