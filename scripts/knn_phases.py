#!/usr/bin/env python3
"""Where a block of the kNN kernels spends its time, on the card.

    python3 scripts/knn_phases.py [--carried] [--twopass] [--json OUT] [ROOT]

Without ``--carried`` or ``--twopass`` it measures both.  ROOT (default:
this checkout) is the checkout whose kernels are measured: its package is
imported and its sources are copied.  The instrumented copies are built
into ROOT's ``alivevc_tpu_torch/_build/`` (the sources are not changed) and
launched through ROOT's own wrappers, in place of the built libraries.

``--carried``: ``csrc/knn_carried.cu``.  Thread 0 of every block of
``knn_carried_kernel`` reads the global timer at its start, after the
set-up, when the first slab has landed, after the slab loop, after its own
top-k and at its end, and sums the SM clock cycles it waits for landed
slabs, for the previous slab's products (``wgmma.wait_group 1``) and for a
free stage to refill.  It runs the carried form at the streaming hop (24 x
887, 'high' and 'default'), a fine-tuning step (960 x 512 'highest') and
7 200 x 512 'high', and prints the kernel's span, the spread of the blocks'
starts, and the microseconds a block spends in each phase (averaged over
the blocks), and the last block's merge.

``--twopass``: the two-pass tile kernel of ``csrc/knn.cu`` (the earlier
``knn_tile_kernel`` of three warpgroups, whose thread 0 also refilled the
ring, or its warp-specialised redesign; each prints its own phase names), at 7 200 x 100 352 'default' and 'high', the bench step's
28 800 x 100 352 'default' and 7 200 x 524 288 'highest' (768 columns,
k = 4).  Three builds of the copy: the kernel with ``clock64`` summed around
each phase of two threads of every block (averaged over the blocks, in
microseconds at the SM clock the thread reads beside the global timer);
a TMA-only variant (products and fold removed: the rate at which the ring
brings operand bytes from L2 into shared memory); and a products-only
variant (no loads: the slabs' full barriers complete at once; the
library split and the fold removed: the tensor cores' rate at this tile).
Each variant's device time is the tile kernel's alone (torch.profiler).
``--json OUT`` also writes the two-pass rows to OUT.

The instrumentation finds its places by exact lines of the kernel; a
changed kernel needs them changed here too.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
_lib = kknn = None    # ROOT's kernels/_lib.py and kernels/knn.py, imported by main()

# ---------------------------------------------------------------------------
# the carried form
# ---------------------------------------------------------------------------

SLOTS = 1 << 14
CARRIED_PATCHES = [
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
CARRIED_SHAPES = [(24, 887, "high"), (24, 887, "default"), (960, 512, "highest"), (7200, 512, "high")]


def patched(src: str, patches, what: str) -> str:
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"knn_phases: the {what} kernel has changed; no single place for:\n{old}")
        src = src.replace(old, new)
    return src


def nvcc(name: str, src: str, defines=()) -> subprocess.Popen:
    """Start nvcc on ``src`` (written to ``_build/<name>.cu``) into
    ``_build/lib<name>.so``."""
    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = _lib.BUILD_DIR / f"{name}.cu", _lib.BUILD_DIR / f"lib{name}.so"
    cu.write_text(src)
    return subprocess.Popen([_lib._nvcc(), *_lib.NVCC_FLAGS, *[f"-D{d}" for d in defines], "-I", str(_lib.CSRC),
                             "-o", str(so), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(name: str, proc: subprocess.Popen) -> ctypes.CDLL:
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(log[-8000:])
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Warning" in line or "warning" in line:
            print(f"  {name}: {line.strip()}")
    return ctypes.CDLL(str(_lib.BUILD_DIR / f"lib{name}.so"))


def signature(symbol: str) -> str:
    """The ctypes spelling ROOT's kernels/knn.py gives ``symbol``."""
    text = (Path(_lib.PKG) / "kernels" / "knn.py").read_text()
    m = re.search(r'_lib\.function\("knn\w*", "%s", "(\w+)"\)' % symbol, text)
    if m is None:
        raise RuntimeError(f"knn_phases: no _lib.function(..., {symbol!r}, ...) in ROOT's kernels/knn.py")
    return m.group(1)


def install(lib: ctypes.CDLL, lib_name: str, symbol: str) -> None:
    """Make ROOT's wrappers launch ``symbol`` of ``lib``."""
    fn = getattr(lib, symbol)
    fn.argtypes = [_lib._CTYPES[c] for c in signature(symbol)]
    fn.restype = ctypes.c_int
    _lib._FNS[(lib_name, symbol)] = fn


def run_carried(card: str) -> None:
    src = patched((_lib.CSRC / "knn_carried.cu").read_text(), CARRIED_PATCHES, "carried")
    src += ("\nextern \"C\" int knn_phases_read(void* host) {\n"
            "  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));\n}\n"
            "extern \"C\" int knn_phases_clear() {\n"
            "  static unsigned long long zero[11][%d];\n"
            "  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));\n}\n" % SLOTS)
    lib = finish("knn_phases", nvcc("knn_phases", src))
    install(lib, "knn_carried", "knn_carried")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for ls, lr, precision in CARRIED_SHAPES:
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

# ---------------------------------------------------------------------------
# the two-pass tile kernel
# ---------------------------------------------------------------------------

TP_SLOTS = 1 << 13
TP_NPH = 10      # phase sums a thread records; then its cycles, start and end times, bytes into
                 # shared memory, bytes read from L2, operations
TP_ROWS = TP_NPH + 6
TP_HEADER = r'''#include <cuda.h>
#ifndef KNN_VARIANT
#define KNN_VARIANT 0   // 0: the kernel; 1: loads only; 2: no loads; 3: products only
#endif
__device__ unsigned long long g_tp[3][%d][%d];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
// thread `which` (0-2; -1 records nothing) of this block: its phase sums,
// its cycles since c0, the global timer at t0 and now, the operand bytes the
// block's loads bring into its shared memory and read from L2, and the
// products' operations
__device__ __forceinline__ void record(int which, const unsigned (&ph)[%d], unsigned long long t0, long long c0,
                                       unsigned long long bytes, unsigned long long l2, unsigned long long flop) {
  if (which < 0) return;
  const int b = (blockIdx.y * gridDim.x + blockIdx.x) %% %d;
#pragma unroll
  for (int i = 0; i < %d; ++i) g_tp[which][i][b] = ph[i];
  g_tp[which][%d][b] = clock64() - c0;
  g_tp[which][%d][b] = t0;
  g_tp[which][%d][b] = gtime();
  g_tp[which][%d][b] = bytes;
  g_tp[which][%d][b] = l2;
  g_tp[which][%d][b] = flop;
}
''' % (TP_ROWS, TP_SLOTS, TP_NPH, TP_SLOTS, TP_NPH, TP_NPH, TP_NPH + 1, TP_NPH + 2, TP_NPH + 3,
       TP_NPH + 4, TP_NPH + 5)
TP_TAIL = r'''
extern "C" int knn_phases_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_tp, sizeof(g_tp));
}
extern "C" int knn_phases_clear() {
  static unsigned long long zero[3][%d][%d];
  return (int)cudaMemcpyToSymbol(g_tp, zero, sizeof(zero));
}
''' % (TP_ROWS, TP_SLOTS)
PH = ("#define PH_SETUP 0\n#define PH_FULL 1\n#define PH_ISSUE 2\n#define PH_WAIT 3\n#define PH_SPLIT 4\n"
      "#define PH_BARRIER 5\n#define PH_QFRAG 6\n#define PH_FOLD 7\n#define PH_REFILL 8\n#define PH_EPILOGUE 9\n")
TP_PARENT_OLD_LOOP = r'''  int slot = 0, ks = 0, l0 = l_begin;
  for (int step = 0; step < n_steps; ++step) {
    // refill the stage released one step ago (its warps are most likely done)
    if (tid == 0 && step >= 1 && step - 1 + STAGES < n_steps) {
      const int prev = step - 1;
      mbar_wait(empty + 8 * (prev % STAGES), (prev / STAGES) & 1);
      fetch(prev + STAGES);
    }
    mbar_wait(full + 8 * slot, (step / STAGES) & 1);   // slab `step` has landed
    const unsigned st = ring + slot * STAGE_BYTES;
    if (BF16) {
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < KSTEPS; ++k)
        wgmma_ss_bf16_n128(acc, desc_sw128(st + (warp >> 2) * 64 * SLAB_BYTES + 32 * k), desc_sw128(st + A_SLAB + 32 * k));
    } else {
      // split the library slab: hi in place, lo beside it (positions, and
      // so the swizzle, unchanged)
      float4* bh = reinterpret_cast<float4*>(smem + (st - base) + A_SLAB);
      float4* bl = bh + B_SLAB / 16;
      for (int i = tid; i < B_SLAB / 16; i += THREADS) {
        const float4 x = bh[i];
        uint32_t h[4], l[4];
        split_tf32(x.x, h[0], l[0]);
        split_tf32(x.y, h[1], l[1]);
        split_tf32(x.z, h[2], l[2]);
        split_tf32(x.w, h[3], l[3]);
        bh[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]), __uint_as_float(h[3]));
        bl[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // generic writes -> wgmma reads
      asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");

      uint32_t ah[KSTEPS][4], al[KSTEPS][4];
#pragma unroll
      for (int k = 0; k < KSTEPS; ++k) {
        uint32_t f[4];
        ldsm_x4(f, st + a_row + (((2 * k + ha) ^ sw) << 4));
#pragma unroll
        for (int j = 0; j < 4; ++j) split_tf32(__uint_as_float(f[j]), ah[k][j], al[k][j]);
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < KSTEPS; ++k) {
        const uint64_t dh = desc_sw128(st + A_SLAB + 32 * k), dl = desc_sw128(st + A_SLAB + B_SLAB + 32 * k);
        wgmma_rs_tf32<128>(acc, al[k], dh);
        wgmma_rs_tf32<128>(acc, ah[k], dl);
        wgmma_rs_tf32<128>(acc, ah[k], dh);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);      // this warp is done with the stage
    slot = slot + 1 == STAGES ? 0 : slot + 1;

    if (++ks == slabs) {   // the tile is complete: fold it
      // Only the chunk's last tile can be partial.
      const bool whole = l0 + LT <= l_end;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + t2 + e;
            float x = acc[4 * j + 2 * h + e];
            if (penalty) x += (l0 + c < l_end) ? __ldg(penalty + l0 + c) : 0.f;
            if (PACKED) x = packed_key(x, c);
            acc[4 * j + 2 * h + e] = x;
            if (whole || l0 + c < l_end) m = fmaxf(m, x);
          }
        if (m >= v[h][K - 1]) {   // some score reaches the k-th best (ties included)
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * j + t2 + e;
              if (whole || l0 + c < l_end) insert<K>(v[h], id[h], acc[4 * j + 2 * h + e], l0 + c);
            }
        }
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
      ks = 0;
      l0 += LT;
    }
  }

  quad_merge<K, 2>(v, id);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + 16 * warp + 8 * r + (lane >> 2);
      if (q < ls) {
        const size_t out = ((size_t)q * n_chunks + chunk) * K;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          // key - 2 is exact, so the merge keeps the packed order
          cand_v[out + s] = PACKED ? v[r][s] - 2.0f : v[r][s];
          cand_i[out + s] = id[r][s];
        }
      }
    }
  }
}
'''

TP_PARENT_NEW_LOOP = r'''  int slot = 0, ks = 0, l0 = l_begin;
  for (int step = 0; step < n_steps; ++step) {
    long long ck = clock64(), c1;
    // refill the stage released one step ago (its warps are most likely done)
    if (tid == 0 && step >= 1 && step - 1 + STAGES < n_steps) {
      const int prev = step - 1;
      mbar_wait(empty + 8 * (prev % STAGES), (prev / STAGES) & 1);
      fetch(prev + STAGES);
    }
    c1 = clock64(); ph[PH_REFILL] += (unsigned)(c1 - ck); ck = c1;
    mbar_wait(full + 8 * slot, (step / STAGES) & 1);   // slab `step` has landed
    c1 = clock64(); ph[PH_FULL] += (unsigned)(c1 - ck); ck = c1;
    const unsigned st = ring + slot * STAGE_BYTES;
    if (KNN_VARIANT == 1) {
    } else if (BF16) {
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < KSTEPS; ++k)
        wgmma_ss_bf16_n128(acc, desc_sw128(st + (warp >> 2) * 64 * SLAB_BYTES + 32 * k), desc_sw128(st + A_SLAB + 32 * k));
    } else {
      if (KNN_VARIANT == 0 || KNN_VARIANT == 2) {
        float4* bh = reinterpret_cast<float4*>(smem + (st - base) + A_SLAB);
        float4* bl = bh + B_SLAB / 16;
        for (int i = tid; i < B_SLAB / 16; i += THREADS) {
          const float4 x = bh[i];
          uint32_t h[4], l[4];
          split_tf32(x.x, h[0], l[0]);
          split_tf32(x.y, h[1], l[1]);
          split_tf32(x.z, h[2], l[2]);
          split_tf32(x.w, h[3], l[3]);
          bh[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]), __uint_as_float(h[3]));
          bl[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // generic writes -> wgmma reads
      }
      c1 = clock64(); ph[PH_SPLIT] += (unsigned)(c1 - ck); ck = c1;
      if (KNN_VARIANT == 0 || KNN_VARIANT == 2) asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
      c1 = clock64(); ph[PH_BARRIER] += (unsigned)(c1 - ck); ck = c1;

      uint32_t ah[KSTEPS][4], al[KSTEPS][4];
#pragma unroll
      for (int k = 0; k < KSTEPS; ++k) {
        uint32_t f[4];
        ldsm_x4(f, st + a_row + (((2 * k + ha) ^ sw) << 4));
#pragma unroll
        for (int j = 0; j < 4; ++j) split_tf32(__uint_as_float(f[j]), ah[k][j], al[k][j]);
      }
      c1 = clock64(); ph[PH_QFRAG] += (unsigned)(c1 - ck); ck = c1;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < KSTEPS; ++k) {
        const uint64_t dh = desc_sw128(st + A_SLAB + 32 * k), dl = desc_sw128(st + A_SLAB + B_SLAB + 32 * k);
        wgmma_rs_tf32<128>(acc, al[k], dh);
        wgmma_rs_tf32<128>(acc, ah[k], dl);
        wgmma_rs_tf32<128>(acc, ah[k], dh);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    c1 = clock64(); ph[PH_ISSUE] += (unsigned)(c1 - ck); ck = c1;
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    c1 = clock64(); ph[PH_WAIT] += (unsigned)(c1 - ck); ck = c1;
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);      // this warp is done with the stage
    slot = slot + 1 == STAGES ? 0 : slot + 1;

    if (++ks == slabs) {   // the tile is complete: fold it
      if (KNN_VARIANT == 0 || KNN_VARIANT == 2) {
      // Only the chunk's last tile can be partial.
      const bool whole = l0 + LT <= l_end;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + t2 + e;
            float x = acc[4 * j + 2 * h + e];
            if (penalty) x += (l0 + c < l_end) ? __ldg(penalty + l0 + c) : 0.f;
            if (PACKED) x = packed_key(x, c);
            acc[4 * j + 2 * h + e] = x;
            if (whole || l0 + c < l_end) m = fmaxf(m, x);
          }
        if (m >= v[h][K - 1]) {   // some score reaches the k-th best (ties included)
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * j + t2 + e;
              if (whole || l0 + c < l_end) insert<K>(v[h], id[h], acc[4 * j + 2 * h + e], l0 + c);
            }
        }
      }
      } else if (KNN_VARIANT == 3) {   // keep the products alive
        float s_ = 0.f;
#pragma unroll
        for (int e = 0; e < 64; ++e) s_ += acc[e];
        if (s_ == 1234.5f) cand_v[0] = s_;
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
      ks = 0;
      l0 += LT;
      c1 = clock64(); ph[PH_FOLD] += (unsigned)(c1 - ck); ck = c1;
    }
  }

  const long long c_epi = clock64();
  quad_merge<K, 2>(v, id);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + 16 * warp + 8 * r + (lane >> 2);
      if (q < ls) {
        const size_t out = ((size_t)q * n_chunks + chunk) * K;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          // key - 2 is exact, so the merge keeps the packed order
          cand_v[out + s] = PACKED ? v[r][s] - 2.0f : v[r][s];
          cand_i[out + s] = id[r][s];
        }
      }
    }
  }
  ph[PH_EPILOGUE] = (unsigned)(clock64() - c_epi);
  record(tid == 0 ? 0 : tid == THREADS - 128 ? 1 : -1, ph, t_start, c_start,
         (unsigned long long)n_steps * (A_SLAB + B_SLAB), (unsigned long long)n_steps * (A_SLAB + B_SLAB),
         (unsigned long long)n_steps * ELEMS * QT * LT * 2 * (BF16 ? 1 : 3));
}
'''

# the warp-specialised kernel: its producer, then its consumers' loop and epilogue
TP_NEW_OLD_PRODUCER = r'''    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) {
      const int piece = LT / cl;                            // library rows this block copies
      const uint16_t mask = (uint16_t)((1u << cl) - 1);
      const int qy = q0 < ls ? q0 : 0;                      // a padding tile reads real rows
      for (int step = 0; step < n_steps; ++step) {
        const int slot = step % stages, round = step / stages;
        if (round > 0) mbar_wait(empty + 8 * slot, (round - 1) & 1);   // every consumer of the cluster is done
        const int col = (step % slabs) * T::ELEMS;
        // rows past the tensor are zero-filled (a piece wholly past it
        // starts at its last row); rows past l_end never rank
        const int ly = min(l_begin + (step / slabs) * LT + rank * piece, lr - 1);
        const unsigned bar = full + 8 * slot, st = ring + slot * T::STAGE;
        const unsigned lst = st + T::Q_BYTES + rank * piece * SLAB_BYTES;
        mbar_expect_tx(bar, T::STAGE);
        tma_load(st, tm_qh, col, qy, bar);
        if (T::TF32) tma_load(st + TQ * SLAB_BYTES, tm_ql, col, qy, bar);
        if (cl > 1) {
          tma_load_multicast(lst, tm_lh, col, ly, bar, mask);
          if (T::TF32) tma_load_multicast(lst + LT * SLAB_BYTES, tm_ll, col, ly, bar, mask);
        } else {
          tma_load(lst, tm_lh, col, ly, bar);
          if (T::TF32) tma_load(lst + LT * SLAB_BYTES, tm_ll, col, ly, bar);
        }
      }
    }
    cluster_sync();   // no block leaves while another may still copy into it or arrive on it
    return;
  }

'''

TP_NEW_PRODUCER = r'''    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    ph[PH_SETUP] = (unsigned)(clock64() - c_start);
    if (tid == CONSUMERS) {
      const int piece = LT / cl;                            // library rows this block copies
      const uint16_t mask = (uint16_t)((1u << cl) - 1);
      const int qy = q0 < ls ? q0 : 0;                      // a padding tile reads real rows
      for (int step = 0; step < n_steps; ++step) {
        const int slot = step % stages, round = step / stages;
        ck = clock64();
        if (round > 0) mbar_wait(empty + 8 * slot, (round - 1) & 1);   // every consumer of the cluster is done
        c1 = clock64(); ph[PH_REFILL] += (unsigned)(c1 - ck); ck = c1;
        const int col = (step % slabs) * T::ELEMS;
        // rows past the tensor are zero-filled (a piece wholly past it
        // starts at its last row); rows past l_end never rank
        const int ly = min(l_begin + (step / slabs) * LT + rank * piece, lr - 1);
        const unsigned bar = full + 8 * slot, st = ring + slot * T::STAGE;
        const unsigned lst = st + T::Q_BYTES + rank * piece * SLAB_BYTES;
#if KNN_VARIANT >= 2
        (void)qy; (void)ly; (void)lst; (void)mask; (void)col; (void)st;
        mbar_arrive(bar);
#else
        mbar_expect_tx(bar, T::STAGE);
        tma_load(st, tm_qh, col, qy, bar);
        if (T::TF32) tma_load(st + TQ * SLAB_BYTES, tm_ql, col, qy, bar);
        if (cl > 1) {
          tma_load_multicast(lst, tm_lh, col, ly, bar, mask);
          if (T::TF32) tma_load_multicast(lst + LT * SLAB_BYTES, tm_ll, col, ly, bar, mask);
        } else {
          tma_load(lst, tm_lh, col, ly, bar);
          if (T::TF32) tma_load(lst + LT * SLAB_BYTES, tm_ll, col, ly, bar);
        }
#endif
        ph[PH_ISSUE] += (unsigned)(clock64() - ck);
      }
    }
    const long long c_epi = clock64();
    cluster_sync();   // no block leaves while another may still copy into it or arrive on it
    ph[PH_EPILOGUE] = (unsigned)(clock64() - c_epi);
    record(tid == CONSUMERS ? 0 : -1, ph, t_start, c_start, 0, 0, 0);
    return;
  }

'''

def _tick(phase: str, indent: int = 4) -> str:
    """C lines adding the cycles since the last tick to ``phase``."""
    return " " * indent + f"c1 = clock64(); ph[{phase}] += (unsigned)(c1 - ck); ck = c1;\n"


# The earlier kernel (three warpgroups): thread 0 (which also refills the
# ring) and the first thread of the last warpgroup
TP_PARENT = {
    "names": ("set-up", "waits on full", "wgmma issue", "wgmma wait", "3xTF32 library split",
              "its block barrier", "query fragments (ldmatrix + split)", "fold", "refill (waits on empty)",
              "epilogue"),
    "threads": (("thread 0 (refills)", 0), ("first thread of the last warpgroup", 1)),
    "bytes_thread": 0,
    "kernel": "knn_tile_kernel",
    "patches": [
        ("#include <cuda.h>\n", TP_HEADER + PH),
        ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n  const int q0 = blockIdx.x * QT;\n",
         "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n  const int q0 = blockIdx.x * QT;\n"
         "  const unsigned long long t_start = gtime();\n  const long long c_start = clock64();\n"
         "  unsigned ph[%d] = {};\n" % TP_NPH),
        ("    for (int s = 0; s < STAGES && s < n_steps; ++s) fetch(s);\n  }\n  __syncthreads();\n",
         "    for (int s = 0; s < STAGES && s < n_steps; ++s) fetch(s);\n  }\n  __syncthreads();\n"
         "  ph[PH_SETUP] = (unsigned)(clock64() - c_start);\n"),
        ("    mbar_expect_tx(bar, A_SLAB + B_SLAB);\n    tma_load(st, tm_src, col, q0, bar);\n"
         "    tma_load(st + A_SLAB, tm_lib, col, l_begin + (step / slabs) * LT, bar);\n",
         "#if KNN_VARIANT >= 2\n    (void)st; (void)col;\n    mbar_arrive(bar);\n#else\n"
         "    mbar_expect_tx(bar, A_SLAB + B_SLAB);\n    tma_load(st, tm_src, col, q0, bar);\n"
         "    tma_load(st + A_SLAB, tm_lib, col, l_begin + (step / slabs) * LT, bar);\n#endif\n"),
        (TP_PARENT_OLD_LOOP, TP_PARENT_NEW_LOOP),
    ],
}
# The warp-specialised kernel: the producer thread and the first thread of
# each consumer warpgroup
TP_NEW = {
    "names": ("set-up", "waits on full", "wgmma issue (producer: TMA issue)", "wgmma waits", None,
              None, None, "fold", "releases (producer: waits on empty)",
              "epilogue (and the cluster barrier)"),
    "threads": (("producer", 0), ("consumer 0", 1), ("consumer 1", 2)),
    "bytes_thread": 1,
    "kernel": "knn_tile_kernel",
    "patches": [
        ("#include <cuda.h>\n", TP_HEADER + PH),
        ("  const int cl = (int)cluster_blocks(), rank = (int)cluster_rank();\n",
         "  const int cl = (int)cluster_blocks(), rank = (int)cluster_rank();\n"
         "  const unsigned long long t_start = gtime();\n  const long long c_start = clock64();\n"
         "  unsigned ph[%d] = {};\n  long long ck = 0, c1 = 0;\n" % TP_NPH),
        (TP_NEW_OLD_PRODUCER, TP_NEW_PRODUCER),
        ("  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 %0;\\n\" ::\"n\"(CONSUMER_REGS));\n",
         "  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 %0;\\n\" ::\"n\"(CONSUMER_REGS));\n"
         "  ph[PH_SETUP] = (unsigned)(clock64() - c_start);\n  ck = clock64();\n"),
        ("      mbar_wait(full + 8 * slot, (step / stages) & 1);   // slab `step` has landed\n",
         "      mbar_wait(full + 8 * slot, (step / stages) & 1);   // slab `step` has landed\n" + _tick("PH_FULL", 6)),
        ("      if (s & 1)\n        slab_products<MODE>(acc, fb_h, fb_l, st, a_off, a_row, sw, ha, s == 0);\n"
         "      else\n        slab_products<MODE>(acc, fa_h, fa_l, st, a_off, a_row, sw, ha, s == 0);\n",
         "#if KNN_VARIANT != 1\n      if (s & 1)\n        slab_products<MODE>(acc, fb_h, fb_l, st, a_off, a_row, sw, ha, s == 0);\n"
         "      else\n        slab_products<MODE>(acc, fa_h, fa_l, st, a_off, a_row, sw, ha, s == 0);\n"
         "#else\n      (void)st;\n#endif\n" + _tick("PH_ISSUE", 6)),
        ("      wgmma_wait<1>();                                  // the previous slab's products are done\n",
         "#if KNN_VARIANT != 1\n      wgmma_wait<1>();\n#endif\n" + _tick("PH_WAIT", 6)),
        ("      slot = slot + 1 == stages ? 0 : slot + 1;\n",
         "      slot = slot + 1 == stages ? 0 : slot + 1;\n" + _tick("PH_REFILL", 6)),
        ("    wgmma_wait<0>();   // the tile is complete: fold it\n",
         "#if KNN_VARIANT != 1\n    wgmma_wait<0>();\n#endif\n" + _tick("PH_WAIT")),
        ("    if (penalty)\n      fold<K, T::ACC, PACKED, true>(acc, v, id, l0, lim, penalty, t2, live);\n    else\n"
         "      fold<K, T::ACC, PACKED, false>(acc, v, id, l0, lim, penalty, t2, live);\n",
         "#if KNN_VARIANT == 3\n    {   // keep the products alive\n      float s_ = 0.f;\n#pragma unroll\n"
         "      for (int e = 0; e < T::ACC; ++e) s_ += acc[e];\n      if (s_ == 1234.5f) cand_v[0] = s_ + (float)lim;\n"
         "    }\n#elif KNN_VARIANT != 1\n"
         "    if (penalty)\n      fold<K, T::ACC, PACKED, true>(acc, v, id, l0, lim, penalty, t2, live);\n    else\n"
         "      fold<K, T::ACC, PACKED, false>(acc, v, id, l0, lim, penalty, t2, live);\n#endif\n" + _tick("PH_FOLD")),
        ("  quad_merge<K, 2>(v, id);\n  if ((lane & 3) == 0) {",
         "  const long long c_epi = clock64();\n  quad_merge<K, 2>(v, id);\n  if ((lane & 3) == 0) {"),
        ("  cluster_sync();\n}\n\n// Pass B",
         "  cluster_sync();\n  ph[PH_EPILOGUE] = (unsigned)(clock64() - c_epi);\n"
         "  record(tid == 0 ? 1 : tid == 128 ? 2 : -1, ph, t_start, c_start, (unsigned long long)n_steps * T::STAGE,\n"
         "         (unsigned long long)n_steps * (T::Q_BYTES + (T::STAGE - T::Q_BYTES) / cl),\n"
         "         (unsigned long long)n_steps * T::ELEMS * TQ * LT * 2 * (T::TF32 ? 3 : 1));\n}\n\n// Pass B"),
    ],
}
TP_SHAPES = [(7200, 100_352, "default"), (7200, 100_352, "high"), (28_800, 100_352, "default"),
             (7200, 524_288, "highest")]
TP_VARIANTS = ("kernel", "TMA only", "no loads", "products only")


def tp_spec(src: str) -> dict:
    """The instrumentation of the two-pass kernel found in ``src``."""
    return TP_NEW if "setmaxnreg" in src else TP_PARENT


def tile_ms(fn, kernel: str, runs: int = 3) -> float:
    """Mean device ms of ``kernel`` a call of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    if not spans:
        raise RuntimeError(f"knn_phases: the profiler recorded no {kernel} span")
    return sum(spans) / 1e3 / runs


def tp_read(lib, call, spec, kernel_ms) -> dict:
    """One instrumented call's record: its rates, and each recorded thread's
    phases (microseconds a block, averaged over the blocks)."""
    call()
    torch.cuda.synchronize()
    lib.knn_phases_clear()
    call()
    torch.cuda.synchronize()
    buf = np.zeros((3, TP_ROWS, TP_SLOTS), dtype=np.uint64)
    if lib.knn_phases_read(ctypes.c_void_p(buf.ctypes.data)):
        raise RuntimeError("knn_phases: reading the counters failed")
    used = buf[0, TP_NPH] > 0
    slots = np.nonzero(used)[0]
    b = buf[:, :, used].astype(np.float64)
    mhz = b[0, TP_NPH].sum() / (b[0, TP_NPH + 2] - b[0, TP_NPH + 1]).sum() * 1e3
    t = spec["bytes_thread"]
    smem, l2, flop = b[t, TP_NPH + 3].sum(), b[t, TP_NPH + 4].sum(), b[t, TP_NPH + 5].sum()
    sec = kernel_ms * 1e-3
    span = b[0, TP_NPH + 2] - b[0, TP_NPH + 1]            # each block's global-timer span, ns
    out = {"ms": kernel_ms, "blocks": int(used.sum()), "sm_mhz": mhz, "smem_GB": smem / 1e9,
           "l2_GB": l2 / 1e9, "smem_TBps": smem / sec / 1e12, "l2_TBps": l2 / sec / 1e12,
           "tflop": flop / 1e12, "tflops": flop / sec / 1e12,
           "span_ms": (b[0, TP_NPH + 2].max() - b[0, TP_NPH + 1].min()) / 1e6,
           "block_us_percentiles_0_50_90_100": [float(np.percentile(span, p)) / 1e3 for p in (0, 50, 90, 100)],
           # the slowest blocks: (blockIdx.y * gridDim.x + blockIdx.x, us after the first start, us)
           "slowest_blocks": [(int(slots[i]), float(b[0, TP_NPH + 1, i] - b[0, TP_NPH + 1].min()) / 1e3,
                               float(span[i]) / 1e3) for i in np.argsort(-span)[:8]]}
    for who, w in spec["threads"]:
        us = {name: b[w, i].mean() / mhz for i, name in enumerate(spec["names"]) if name}
        us["whole block"] = b[w, TP_NPH].mean() / mhz
        out[who] = us
    return out


def tp_line(tag: str, e: dict, card: str) -> str:
    return (f"{tag}: tile kernel {e['ms']:.3f} ms, {e['blocks']} blocks, SM {e['sm_mhz']:.0f} MHz; operands "
            f"{e['smem_GB']:.2f} GB into shared memory ({e['smem_TBps']:.2f} TB/s), {e['l2_GB']:.2f} GB from L2 "
            f"({e['l2_TBps']:.2f} TB/s); products {e['tflop']:.3f} TFLOP ({e['tflops']:.1f} TFLOP/s); blocks' span "
            f"{e['span_ms']:.3f} ms, a block's us min / median / p90 / max "
            + " / ".join(f"{x:.1f}" for x in e["block_us_percentiles_0_50_90_100"]) + f" [{card}]\n"
            + "  slowest blocks (index, start us, us): "
            + ", ".join(f"({i}, {t:.0f}, {d:.0f})" for i, t, d in e["slowest_blocks"]))


def run_twopass(card: str, out_json) -> None:
    src = (_lib.CSRC / "knn.cu").read_text()
    spec = tp_spec(src)
    src = patched(src, spec["patches"], "two-pass") + TP_TAIL
    procs = [(v, nvcc(f"knn_tp{v}", src, (f"KNN_VARIANT={v}",))) for v in range(len(TP_VARIANTS))]
    libs = [finish(f"knn_tp{v}", p) for v, p in procs]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for ls, lr, precision in TP_SHAPES:
        q = torch.randn(ls, 768, generator=gen, device="cuda")
        lib_rows = torch.randn(lr, 768, generator=gen, device="cuda")
        plan = kknn.knn_plan(ls, lr, precision, 4, form="twopass")
        shape = f"{ls} x {lr} x 768 {precision}"
        row = {"shape": shape, "plan": plan._asdict(), "card": card}
        for v, lib in enumerate(libs):
            install(lib, "knn", "knn_topk")
            call = lambda: kknn.knn_topk_cuda(q, lib_rows, 4, precision, form="twopass")  # noqa: E731
            entry = tp_read(lib, call, spec, tile_ms(call, spec["kernel"]))
            print(tp_line(f"{shape} {TP_VARIANTS[v]}", entry, card))
            if v == 0:
                for who, _ in spec["threads"]:
                    print(f"  {who}, us a block: " + ", ".join(f"{k} {x:.1f}" for k, x in entry[who].items()))
            row[TP_VARIANTS[v]] = entry
        print(f"  plan: {row['plan']}")
        rows.append(row)
    if out_json:
        Path(out_json).write_text(json.dumps(rows, indent=1))


def main() -> int:
    global _lib, kknn
    argv = sys.argv[1:]
    out_json = None
    if "--json" in argv:
        out_json = argv[argv.index("--json") + 1]
        argv = [a for a in argv if a not in ("--json", out_json)]
    sections = [a for a in argv if a in ("--carried", "--twopass")] or ["--carried", "--twopass"]
    roots = [a for a in argv if not a.startswith("--")]
    root = Path(roots[0]).resolve() if roots else HERE
    sys.path.insert(0, str(root))
    from alivevc_tpu_torch.kernels import _lib as lib_mod
    from alivevc_tpu_torch.kernels import knn as knn_mod

    _lib, kknn = lib_mod, knn_mod
    if not str(Path(_lib.PKG).resolve()).startswith(str(root)):
        print(f"knn_phases: imported {_lib.PKG}, not the package under {root}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("knn_phases: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"{card}; kernel sources {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--carried" in sections:
        run_carried(card)
    if "--twopass" in sections:
        run_twopass(card, out_json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
