#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference, put in the
program's place and computed in the configuration's ``control`` precision
(the nearest below the one it states), judged exactly as a run judges the
program.  It has to come out not correct.

    python3 vcbench/control.py --workload <cell> --seed <n> [--seed <m> ...] [--seconds <s>]

prints one JSON line a seed: the numbers compared and their limits.  The
benchmark's own runs never run it.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--seconds", type=float, default=20.0, help="the window a run of the cell measures")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    import cell

    with open(ROOT / "BENCHMARK.json") as f:
        spec = cell.Spec(json.load(f), args.workload, ROOT)
    kind = spec.kind()
    for seed in args.seed:
        checks = kind.control(spec, seed, args.device, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": cell.judge(checks),
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
