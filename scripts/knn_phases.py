#!/usr/bin/env python3
"""Where a block of the carried kNN kernel spends its time, on the card.

    python3 scripts/knn_phases.py

Builds an instrumented copy of ``alivevc_tpu_torch/csrc/knn_carried.cu``
(into ``alivevc_tpu_torch/_build/``; the source in the package is not
changed): thread 0 of every block of ``knn_carried_kernel`` reads the global
timer at its start, after the set-up, when the first slab has landed, after
the slab loop, after its own top-k and at its end, and sums the SM clock
cycles it waits for landed slabs, for the previous slab's products
(``wgmma.wait_group 1``) and for a free stage to refill.  Then it runs the
carried form (the package's wrapper, the instrumented library in place of
the built one) at the streaming hop (24 x 887, 'high' and 'default'), a
fine-tuning step (960 x 512 'highest') and 7 200 x 512 'high', and prints
the kernel's span, the spread of the blocks' starts, and the microseconds
a block spends in each phase (averaged over the blocks), and the last
block's merge.

The instrumentation finds its places by exact lines of the kernel; a
changed kernel needs them changed here too.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from alivevc_tpu_torch.kernels import _lib  # noqa: E402
from alivevc_tpu_torch.kernels import knn as kknn  # noqa: E402

SLOTS = 1 << 14
PATCHES = [
    ("#include <cuda.h>\n", "#include <cuda.h>\n__device__ unsigned long long g_phase[11][%d];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n" % SLOTS),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wgi = warp >> 2;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wgi = warp >> 2;\n"
     "  const unsigned long long t0 = gtime(), c_start = clock64();\n"
     "  unsigned long long w_full = 0, w_mma = 0, w_refill = 0, t1_ = 0, t2 = 0;\n"
     "  auto record = [&](unsigned long long t3, unsigned long long t4, int last) {\n"
     "    if (threadIdx.x != 0) return;\n"
     "    const int b = (blockIdx.y * gridDim.x + blockIdx.x) % " + str(SLOTS) + ";\n"
     "    g_phase[0][b] = t0; g_phase[1][b] = t1_; g_phase[2][b] = t2; g_phase[3][b] = t3;\n"
     "    g_phase[4][b] = t4; g_phase[5][b] = gtime(); g_phase[6][b] = w_full; g_phase[7][b] = w_mma;\n"
     "    g_phase[8][b] = w_refill; g_phase[9][b] = clock64() - c_start; g_phase[10][b] = last;\n"
     "  };\n"),
    ("    for (int s = 0; s < stages && s < n_steps; ++s) fetch(s);\n  }\n  __syncthreads();\n",
     "    for (int s = 0; s < stages && s < n_steps; ++s) fetch(s);\n  }\n  __syncthreads();\n"
     "  t1_ = gtime();\n"),
    ("    mbar_wait(full + 8 * slot, (step / stages) & 1);   // slab `step` has landed\n",
     "    const unsigned long long f0 = clock64();\n"
     "    mbar_wait(full + 8 * slot, (step / stages) & 1);   // slab `step` has landed\n"
     "    w_full += clock64() - f0;\n    if (step == 0) t2 = gtime();\n"),
    ("    wgmma_wait<1>();\n    if (step >= 1) {\n",
     "    const unsigned long long m0 = clock64();\n    wgmma_wait<1>();\n    w_mma += clock64() - m0;\n"
     "    if (step >= 1) {\n"),
    ("      if (tid == 0 && step - 1 + stages < n_steps) {\n",
     "      const unsigned long long r0 = clock64();\n"
     "      if (tid == 0 && step - 1 + stages < n_steps) {\n"),
    ("        fetch(step - 1 + stages);\n      }\n",
     "        fetch(step - 1 + stages);\n      }\n      w_refill += clock64() - r0;\n"),
    ("  __syncthreads();   // every warp is past its last wgmma: the ring is free\n",
     "  __syncthreads();   // every warp is past its last wgmma: the ring is free\n"
     "  const unsigned long long t3 = gtime();\n"),
    ("  const bool owner = mine && p == 0;\n",
     "  const bool owner = mine && p == 0;\n  const unsigned long long t4 = gtime();\n"),
    ("    if (owner) write_answer<K, PACKED>(v, id, qg, k, out_v, out_i);\n    return;\n  }\n",
     "    if (owner) write_answer<K, PACKED>(v, id, qg, k, out_v, out_i);\n"
     "    record(t3, t4, 1);\n    return;\n  }\n"),
    ("  if (!last_block) return;\n", "  if (!last_block) {\n    record(t3, t4, 0);\n    return;\n  }\n"),
    ("  group_merge<K>(v, id, tpq);\n  if (owner) write_answer<K, PACKED>(v, id, qg, k, out_v, out_i);\n}\n",
     "  group_merge<K>(v, id, tpq);\n  if (owner) write_answer<K, PACKED>(v, id, qg, k, out_v, out_i);\n"
     "  record(t3, t4, 1);\n}\n"),
]
SHAPES = [(24, 887, "high"), (24, 887, "default"), (960, 512, "highest"), (7200, 512, "high")]


def build() -> ctypes.CDLL:
    src = (_lib.CSRC / "knn_carried.cu").read_text()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"knn_phases: the kernel has changed; no single place for:\n{old}")
        src = src.replace(old, new)
    src += ("\nextern \"C\" int knn_phases_read(void* host) {\n"
            "  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));\n}\n"
            "extern \"C\" int knn_phases_clear() {\n"
            "  static unsigned long long zero[11][%d];\n"
            "  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));\n}\n" % SLOTS)
    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = _lib.BUILD_DIR / "knn_phases.cu", _lib.BUILD_DIR / "libknn_phases.so"
    cu.write_text(src)
    out = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", str(_lib.CSRC), "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(out.stdout[-4000:] + out.stderr[-4000:])
    lib = ctypes.CDLL(str(so))
    fn = lib.knn_carried
    fn.argtypes = [_lib._CTYPES[c] for c in "ppppplppiiiiiiiiiip"]
    fn.restype = ctypes.c_int
    _lib._FNS[("knn_carried", "knn_carried")] = fn     # the wrapper launches the copy
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("knn_phases: CUDA is not available", file=sys.stderr)
        return 2
    lib = build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for ls, lr, precision in SHAPES:
        q = torch.randn(ls, 768, generator=gen, device="cuda")
        lib_rows = torch.randn(lr, 768, generator=gen, device="cuda")
        plan = kknn.knn_plan(ls, lr, precision)
        for _ in range(3):          # warm, then the read run
            lib.knn_phases_clear()
            kknn.knn_topk_carried(q, lib_rows, 4, precision)
            torch.cuda.synchronize()
        buf = np.zeros((11, SLOTS), dtype=np.uint64)
        if lib.knn_phases_read(ctypes.c_void_p(buf.ctypes.data)):
            raise RuntimeError("knn_phases: reading the counters failed")
        used = buf[0] > 0
        b = buf[:, used].astype(np.float64)
        mhz = b[9].sum() / (b[5] - b[0]).sum() * 1e3      # SM cycles a microsecond
        start = b[0].min()
        phase = {"set-up": b[1] - b[0], "first slab": b[2] - b[1], "slab loop": b[3] - b[2],
                 "own top-k": b[4] - b[3], "publish / merge": b[5] - b[4]}
        last = b[10] > 0
        print(f"{ls} x {lr} {precision} nq={plan.nq} wg={plan.wg} grid {plan.q_tiles} x {plan.lib_blocks} "
              f"x {plan.split}, "
              f"stages {plan.stages} [{card}]: kernel span {(b[5].max() - start) / 1e3:.2f} us, block "
              f"starts spread {(b[0].max() - start) / 1e3:.2f} us, SM clock {mhz:.0f} MHz")
        print("  a block, us: " + ", ".join(f"{k} {v.mean() / 1e3:.2f} (max {v.max() / 1e3:.2f})"
                                             for k, v in phase.items()))
        print(f"  in the loop, us: waiting for slabs {b[6].mean() / mhz:.2f}, for the previous products "
              f"{b[7].mean() / mhz:.2f}, refilling {b[8].mean() / mhz:.2f}; the last blocks' publish / "
              f"merge {(b[5] - b[4])[last].mean() / 1e3:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
