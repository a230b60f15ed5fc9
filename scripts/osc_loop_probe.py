#!/usr/bin/env python3
"""The Chebyshev oscillator's inner loop alone on the card, against the
card's float32 FMA peak.

    python3 scripts/osc_loop_probe.py

``csrc/oscillator.cu:osc_cheb_kernel`` spends 3 FMAs on each sample and
harmonic: the recurrence sin((k+1) t) = 2 cos(t) sin(k t) - sin((k-1) t) and
one accumulation into each of two amplitude sums.  This script builds two
microbenchmarks with nvcc (no PyTorch headers) and times them with CUDA
events, 528 blocks of 256 threads (4 an SM on an H100):

  * ``ffma``: 8 independent FMA chains a thread whose multiplier and addend
    are the same registers throughout; the rate the card reaches with FMAs
    alone;
  * ``loop``: the kernel's loop, 5 samples a thread, 64 harmonics,
    amplitudes read from shared memory as float4 broadcasts, in the
    kernel's operand order.

It prints TFLOP/s (2 per FMA) for each, and the card's name and power
limit.  Needs a CUDA card and nvcc (CUDA_HOME or /usr/local/cuda).
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

SRC = r"""
#include <cuda_runtime.h>
constexpr int P = 5;   // samples a thread, as in the kernel
__global__ void __launch_bounds__(256, 4) cheb_loop(float* out, int reps, int nh) {
  __shared__ float4 a4[128];
  for (int i = threadIdx.x; i < 128; i += blockDim.x) a4[i] = make_float4(1e-3f * i, 2e-3f * i, 1.f, 0.5f);
  __syncthreads();
  float twoc[P], s[P], sp[P], lo[P], hi[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    twoc[j] = 1.9f - 0.01f * j - 1e-5f * threadIdx.x;
    s[j] = 0.3f; sp[j] = 0.f; lo[j] = 0.f; hi[j] = 0.f;
  }
  for (int rep = 0; rep < reps; ++rep) {
    const float4* alo = a4 + (rep & 1) * 16;
    const float4* ahi = alo + 64;
#pragma unroll 4
    for (int k4 = 0; k4 < nh / 4; ++k4) {
      const float4 al = alo[k4], ah = ahi[k4];
#define STEP(A, B) _Pragma("unroll") for (int j = 0; j < P; ++j) {                       \
        lo[j] = fmaf(s[j], (A), lo[j]); hi[j] = fmaf(s[j], (B), hi[j]);               \
        const float nx = fmaf(s[j], twoc[j], -sp[j]); sp[j] = s[j]; s[j] = nx; }
      STEP(al.x, ah.x) STEP(al.y, ah.y) STEP(al.z, ah.z) STEP(al.w, ah.w)
#undef STEP
    }
#pragma unroll
    for (int j = 0; j < P; ++j) { s[j] = 0.3f; sp[j] = 0.f; }
  }
  float r = 0.f;
#pragma unroll
  for (int j = 0; j < P; ++j) r += lo[j] + hi[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
}
__global__ void ffma_chains(float* out, int iters, float m, float c) {
  float x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = threadIdx.x * 1e-3f + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = fmaf(x[i], m, c);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += x[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_ffma(float* out, int blocks, int iters) {
  ffma_chains<<<blocks, 256>>>(out, iters, 0.9999f, 1e-4f);
  return (int)cudaGetLastError();
}
extern "C" int run_loop(float* out, int blocks, int reps, int nh) {
  cheb_loop<<<blocks, 256>>>(out, reps, nh);
  return (int)cudaGetLastError();
}
"""
SAMPLES = 5   # a thread, as in the kernel
BLOCKS, REPS, NH, FFMA_ITERS = 132 * 4, 400, 64, 4096


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = Path(tmp) / "probe.cu", Path(tmp) / "libprobe.so"
        cu.write_text(SRC)
        built = subprocess.run([str(nvcc), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                                "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(so), str(cu)],
                               capture_output=True, text=True)
        if built.returncode:
            print(built.stdout + built.stderr, file=sys.stderr)
            return 1
        print("\n".join(ln.strip() for ln in (built.stdout + built.stderr).splitlines()
                        if "registers" in ln or "spill" in ln))
        lib = ctypes.CDLL(str(so))
        out = torch.empty(BLOCKS * 256, device="cuda")

        def tflops(call, flops):
            call()
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                rc = call()
                b.record()
                b.synchronize()
                if rc:
                    raise RuntimeError(f"launch failed: {rc}")
                times.append(a.elapsed_time(b))
            return flops / statistics.median(times) / 1e9

        ptr = ctypes.c_void_p(out.data_ptr())
        rate = tflops(lambda: lib.run_ffma(ptr, BLOCKS, FFMA_ITERS), BLOCKS * 256 * FFMA_ITERS * 64 * 2)
        print(f"ffma: {rate:.1f} TFLOP/s [{card}]")
        rate = tflops(lambda: lib.run_loop(ptr, BLOCKS, REPS, NH), BLOCKS * 256 * REPS * NH * SAMPLES * 3 * 2)
        print(f"loop ({SAMPLES} samples a thread): {rate:.1f} TFLOP/s [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
