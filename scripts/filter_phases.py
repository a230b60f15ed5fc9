#!/usr/bin/env python3
"""Where a block of the wide filter kernel spends its time, on the card.

    python3 scripts/filter_phases.py

Builds an instrumented copy of ``alivevc_tpu_torch/csrc/filter.cu`` (into
``alivevc_tpu_torch/_build/``; the source in the package is not changed):
``clock64`` read around each phase of ``filter_wide_kernel`` by the first
cook thread and the first consumer thread of every block, summed over the
block's items.  Then it runs one causal conv (k = 5, dilation 2, with a
residual) at the bench shape of levels 0 and 1 (16 windows; C = 256 at
4 500 samples, C = 64 at 36 000) in bf16 and float32 and prints, averaged
over the blocks, the microseconds a block spends (cycles over the SM clock,
which the first consumer thread reads beside the global timer):

  cook: waiting for a free operand buffer, waiting for the raw rows (TMA),
        computing the operand, signalling and issuing the next raw rows;
  consumer: waiting for the operand, the taps (weights, ldmatrix, wgmma),
        the epilogue, and the whole kernel.

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
from alivevc_tpu_torch.kernels import filter as kf  # noqa: E402

PATCHES = [
    ("#include <type_traits>\n", "#include <type_traits>\n__device__ unsigned long long g_phase[9][1024];\n"),
    ("""    for (int item = 0; item < items; ++item) {
      const int b = item & 1, k = item % my_chunks;
      const Where w = where(item);
      if (item >= 2) mbar_wait(aempty""", """    unsigned long long q0 = 0, q1 = 0, q2 = 0, q3 = 0;
    for (int item = 0; item < items; ++item) {
      const int b = item & 1, k = item % my_chunks;
      const Where w = where(item);
      const unsigned long long c0 = clock64();
      if (item >= 2) mbar_wait(aempty"""),
    ("""      mbar_wait(rawfull + 8 * b, (unsigned)((item >> 1) & 1));
      // raw -> operand""", """      const unsigned long long c1 = clock64();
      mbar_wait(rawfull + 8 * b, (unsigned)((item >> 1) & 1));
      const unsigned long long c2 = clock64();
      // raw -> operand"""),
    ("""      __syncwarp();
      if (lane == 0) mbar_arrive(afull + 8 * b);""", """      const unsigned long long c3 = clock64();
      __syncwarp();
      if (lane == 0) mbar_arrive(afull + 8 * b);"""),
    ("""        cluster_sync();
        cluster_sync();
      }
    }
    return;""", """        cluster_sync();
        cluster_sync();
      }
      const unsigned long long c4 = clock64();
      q0 += c1 - c0; q1 += c2 - c1; q2 += c3 - c2; q3 += c4 - c3;
    }
    if (ct == 0) {
      g_phase[0][blockIdx.x] = q0; g_phase[1][blockIdx.x] = q1;
      g_phase[2][blockIdx.x] = q2; g_phase[3][blockIdx.x] = q3;
    }
    return;"""),
    ("""  int step = 0;
  for (int item = 0; item < items; ++item) {""", """  int step = 0;
  unsigned long long u0 = 0, u1 = 0, u2 = 0, ns0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
  const unsigned long long ustart = clock64();
  for (int item = 0; item < items; ++item) {"""),
    ("""    mbar_wait(afull + 8 * b, (unsigned)((item >> 1) & 1));
    const unsigned a_row""", """    const unsigned long long d0 = clock64();
    mbar_wait(afull + 8 * b, (unsigned)((item >> 1) & 1));
    const unsigned long long d1 = clock64();
    const unsigned a_row"""),
    ("""    step += p.taps;
""", """    step += p.taps;
    const unsigned long long d2 = clock64();
    u0 += d1 - d0; u1 += d2 - d1;
"""),
    ("""      continue;
    }
    const float* bs = bias_s + w.n0;""", """      continue;
    }
    const unsigned long long d3 = clock64();
    const float* bs = bias_s + w.n0;"""),
    ("""    __syncwarp();
    if (lane == 0) mbar_arrive(aempty + 8 * b);   // the operand buffer (the epilogue's scratch) is free
  }
}""", """    u2 += clock64() - d3;
    __syncwarp();
    if (lane == 0) mbar_arrive(aempty + 8 * b);   // the operand buffer (the epilogue's scratch) is free
  }
  if (tid == 0) {
    g_phase[4][blockIdx.x] = u0; g_phase[5][blockIdx.x] = u1;
    g_phase[6][blockIdx.x] = u2; g_phase[7][blockIdx.x] = clock64() - ustart;
    unsigned long long ns1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
    g_phase[8][blockIdx.x] = ns1 - ns0;   // the same span in ns: the SM clock
  }
}"""),
]
NAMES = ["cook: wait buffer", "cook: wait raw rows", "cook: compute", "cook: signal + next rows",
         "consumer: wait operand", "consumer: taps", "consumer: epilogue", "consumer: total"]


def build() -> ctypes.CDLL:
    src = (_lib.CSRC / "filter.cu").read_text()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"filter_phases: the kernel has changed; no single place for:\n{old}")
        src = src.replace(old, new)
    src += ("\nextern \"C\" int filter_phases_read(void* host) {\n"
            "  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));\n}\n")
    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = _lib.BUILD_DIR / "filter_phases.cu", _lib.BUILD_DIR / "libfilter_phases.so"
    cu.write_text(src)
    out = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", str(_lib.CSRC), "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(out.stdout[-4000:] + out.stderr[-4000:])
    lib = ctypes.CDLL(str(so))
    lib.filter_wide.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    lib.filter_wide.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("filter_phases: CUDA is not available", file=sys.stderr)
        return 2
    lib = build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dt in (torch.bfloat16, torch.float32):
        for n, length, c, fr in ((16, 4500, 256, 10), (16, 36000, 64, 80)):
            x = (0.3 * torch.randn(n, length, c, generator=gen, device="cuda")).to(dt)
            w = (torch.randn(5, c, c, generator=gen, device="cuda") * (5 * c) ** -0.5).to(dt)
            hi, lo, _ = kf._wide_weights([w], dt, x.device)
            bias = torch.zeros(c, device="cuda", dtype=dt)
            frames = length // fr
            film = torch.randn(n, frames, 12 * c, generator=gen, device="cuda").to(dt)
            out = torch.zeros(n, length, c, device="cuda", dtype=dt)
            plan = kf.wide_plan(n, length, c, c, 5, dt)
            rc = lib.filter_wide(x.data_ptr(), None, hi.data_ptr(), None if lo is None else lo.data_ptr(),
                                 bias.data_ptr(), out.data_ptr(), out.data_ptr(), film.data_ptr(), n, length,
                                 c, c, 5, 2, c, frames, fr, 12 * c, 0, plan["tn"], plan["wgs"], plan["split"],
                                 int(dt == torch.bfloat16), _lib.stream_of(x))
            if rc:
                raise RuntimeError(f"filter_phases: launch failed with error {rc}")
            torch.cuda.synchronize()
            buf = np.zeros((9, 1024), dtype=np.uint64)
            if lib.filter_phases_read(ctypes.c_void_p(buf.ctypes.data)):
                raise RuntimeError("filter_phases: reading the counters failed")
            used = buf[7] > 0
            clock_mhz = float(buf[7, used].sum()) / float(buf[8, used].sum()) * 1e3   # cycles a microsecond
            us = buf[:8, used].astype(np.float64).mean(1) / clock_mhz
            print(f"{str(dt)[6:]} [{n}, {length}, {c}] tile {plan['tm']} x {plan['tn']}, {int(used.sum())} blocks, "
                  f"SM clock {clock_mhz:.0f} MHz: " + " | ".join(f"{name} {v:.1f}" for name, v in zip(NAMES, us)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
