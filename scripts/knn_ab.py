#!/usr/bin/env python3
"""The kNN forms side by side on the card, at the carried form's shapes;
or one checkout's two-pass rows timed into a JSON file.

    python3 scripts/knn_ab.py
    python3 scripts/knn_ab.py ROOT OUT.json [--build-only]

With ROOT and OUT.json: imports ``alivevc_tpu_torch`` and ``chip_smoke``
from the checkout at ROOT (its kernels built from ROOT's sources into
ROOT's own build directory) and runs ``chip_smoke.check_knn`` on the
two-pass form's rows, each on its own seeded draw: 7 200 queries x 100 352
rows x 768 in 'default', packed, 'high', 'highest' and 'high' with a 0/-4
penalty; 7 200 x 524 288 (phase 4's shard, its last row excluded by a
device count) in 'default' and 'highest'; and the bench step's 28 800 x
100 352 in 'default' and 'high'.  Each row holds the wrapper's time (CUDA
events), the kernels' device time alone, the plain version's, ``matmul``
+ ``topk`` with and without the normalisation, the bound and the plan; the
rows, the card's name and power limit go to OUT.json.  ``--build-only``
builds ROOT's two-pass kernels and stops.  Two trees are compared within
one call on one card, in turns (A, B, B, A), as ``scripts/filter_ab.py``
says.

Without arguments:
Builds ``csrc/knn.cu`` and ``csrc/knn_carried.cu`` (their ptxas lines from
``_build/<name>.log`` are printed), then for each shape (the streaming hop,
24 x 887, 'high' and 'default'; a fine-tuning step, 960 x 512 'highest';
offline with a 512-token library, 7 200 x 512 in every mode, 'highest' over
509 valid rows, packed) holds the carried form to ``knn_topk_plain``
(values 1e-4, index sets where the plain 4th and 5th scores are 1e-4
apart) and prints, in ms: the carried wrapper and the forced two-pass
wrapper (CUDA events, median of >= 20 runs, in the order carried,
two-pass, two-pass, carried), each form's device time alone (torch.profiler
over 20 calls; the carried form's first launch, the normalisation, apart), ``matmul`` + ``topk`` on operands normalised beforehand
(chip_smoke.py's library column) and the same with the normalisation
(the fair column).  First it prints the host's microseconds a carried call
at the hop's shape, split into the wrapper's Python, its three allocations
and the C call (two launches, the tensor maps), each over 2 000 calls
enqueued without a wait (the card keeps up, so the loop runs at the host's
pace).
"""

import statistics
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from alivevc_tpu_torch.kernels import _lib  # noqa: E402
from alivevc_tpu_torch.kernels import knn as kknn  # noqa: E402

SHAPES = [(24, 887, "high", {}), (24, 887, "default", {}), (960, 512, "highest", {}),
          (7200, 512, "default", {}), (7200, 512, "high", {}), (7200, 512, "highest", {}),
          (7200, 512, "highest", {"valid_rows": 509}), (7200, 512, "default", {"extraction": "packed"})]


def events_ms(fn, runs=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, keys, runs=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and any(k in e.name for k in keys)]
    return sum(spans) / 1e3 / runs if spans else None


def host_us(fn, calls=2000):
    import time

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def host_split(card):
    """The host's share of one carried call at the hop (24 x 887 'high')."""
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(24, 768, generator=g, device="cuda")
    lib = torch.randn(887, 768, generator=g, device="cuda")
    plan = kknn.knn_plan(24, 887, "high")
    scratch = torch.empty(plan.scratch, dtype=torch.uint8, device="cuda")
    out_v = torch.empty((24, 4), dtype=torch.float32, device="cuda")
    out_i = torch.empty((24, 4), dtype=torch.int64, device="cuda")
    fn = _lib.function("knn_carried", "knn_carried", "ppppplppiiiiiiiiiip")
    stream = _lib.stream_of(q)
    args = (q.data_ptr(), lib.data_ptr(), 0, 0, scratch.data_ptr(), plan.scratch, out_v.data_ptr(),
            out_i.data_ptr(), 24, 887, 887, 768, 4, 0, plan.nq, plan.wg, plan.split, plan.stages, stream)

    def allocations():
        torch.empty(plan.scratch, dtype=torch.uint8, device="cuda")
        torch.empty((24, 4), dtype=torch.float32, device="cuda")
        torch.empty((24, 4), dtype=torch.int64, device="cuda")

    whole = host_us(lambda: kknn.knn_topk_carried(q, lib, 4, "high"))
    alloc = host_us(allocations)
    c_call = host_us(lambda: fn(*args))
    print(f"host us a carried call at the hop [{card}]: the wrapper {whole:.2f} = Python "
          f"{whole - alloc - c_call:.2f} + allocations {alloc:.2f} + the C call {c_call:.2f}")


TWOPASS_ROWS = [(7200, 100_352, "default", {}), (7200, 100_352, "default", {"extraction": "packed"}),
                (7200, 100_352, "high", {}), (7200, 100_352, "highest", {}),
                (7200, 100_352, "high", {"penalty": True}), (7200, 524_288, "default", {"valid_rows": 524_287}),
                (7200, 524_288, "highest", {"valid_rows": 524_287}), (28_800, 100_352, "default", {}),
                (28_800, 100_352, "high", {})]


def twopass_rows(root: str, out: str, build_only: bool) -> int:
    """One checkout's two-pass rows (see the docstring) into ``out``."""
    import json
    import os
    import time

    root = os.path.realpath(root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m in ("chip_smoke", "alivevc_tpu_torch")
                 or m.startswith("alivevc_tpu_torch.")]:
        del sys.modules[name]
    import chip_smoke
    from alivevc_tpu_torch.kernels import _lib as root_lib

    if not os.path.realpath(root_lib.PKG).startswith(root):
        print(f"knn_ab: imported {root_lib.PKG}, not the package under {root}", file=sys.stderr)
        return 2
    secs = root_lib.build_all(["knn"])
    if build_only:
        print(f"knn_ab: built {root} in {secs:.1f} s")
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    t0 = time.perf_counter()
    rows = []
    for i, (ls, lr, precision, kw) in enumerate(TWOPASS_ROWS):
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 100 + i)
        rows.append(chip_smoke.check_knn(gen, lr, precision, ls=ls, **kw))
    chip_smoke.print_rows(rows, card)
    with open(out, "w") as f:
        json.dump({"root": root, "card": card, "seconds": time.perf_counter() - t0, "rows": rows}, f, indent=1)
    return 0


def main() -> int:
    if len(sys.argv) >= 3:
        if not torch.cuda.is_available():
            print("knn_ab: CUDA is not available", file=sys.stderr)
            return 2
        return twopass_rows(sys.argv[1], sys.argv[2], "--build-only" in sys.argv[3:])
    if not torch.cuda.is_available():
        print("knn_ab: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print(f"build {_lib.build_all(['knn', 'knn_carried']):.1f} s")
    for name in ("knn", "knn_carried"):
        log = (_lib.BUILD_DIR / f"{name}.log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    host_split(card)
    g = torch.Generator(device="cuda").manual_seed(0)
    for ls, lr, precision, kw in SHAPES:
        q = torch.randn(ls, 768, generator=g, device="cuda")
        lib = torch.randn(lr, 768, generator=g, device="cuda")
        if "valid_rows" in kw:
            kw = {"valid_rows": torch.tensor(kw["valid_rows"], device="cuda")}
        plan = kknn.knn_plan(ls, lr, precision, 4, packed="extraction" in kw)
        v, i = kknn.knn_topk_cuda(q, lib, 4, precision, form="carried", **kw)
        pv, pi = kknn.knn_topk_plain(q, lib, 5, precision, **kw)
        torch.cuda.synchronize()
        err = float((v - pv[:, :4]).abs().max())
        clear = (pv[:, 3] - pv[:, 4]) > 1e-4
        same = (torch.sort(i, 1).values == torch.sort(pi[:, :4], 1).values).all(1)
        bad = int((clear & ~same).sum())
        ok = err <= 1e-4 and bad == 0
        tag = f"{ls} x {lr} {precision}{' ' + ','.join(kw) if kw else ''}"
        print(f"{tag}: plan nq={plan.nq} wg={plan.wg} grid {plan.q_tiles} x {plan.lib_blocks} x {plan.split} "
              f"stages {plan.stages} smem {plan.smem}; max abs err {err:.2e}, {bad} index sets "
              f"differ -> {'ok' if ok else 'FAILED'}")
        if not ok:
            return 1
        carried = lambda: kknn.knn_topk_cuda(q, lib, 4, precision, form="carried", **kw)  # noqa: E731
        twopass = lambda: kknn.knn_topk_cuda(q, lib, 4, precision, form="twopass", **kw)  # noqa: E731
        src, lb = kknn.prep_operands(q, lib, precision)

        def library_call():
            torch.topk(src @ lb.t(), 4, dim=1)

        def fair_call():
            s, b = kknn.prep_operands(q, lib, precision)
            torch.topk(s @ b.t(), 4, dim=1)

        times = {}
        for name, fn in (("carried", carried), ("twopass", twopass), ("twopass", twopass),
                         ("carried", carried)):
            times.setdefault(name, []).append(events_ms(fn))
        dev_c = device_ms(carried, ("knn_carried",))
        dev_prep = device_ms(carried, ("knn_carried_prep",))
        dev_t = device_ms(twopass, ("knn_tile", "knn_merge"))
        print(f"  ms [{card}]: carried {times['carried']}, two-pass {times['twopass']}, device alone "
              f"carried {dev_c} (prep {dev_prep}), two-pass {dev_t}; matmul + topk {events_ms(library_call):.4f}, "
              f"with the normalisation {events_ms(fair_call):.4f}")
    print("knn_ab: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
