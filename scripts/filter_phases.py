#!/usr/bin/env python3
"""Where a block of the filter kernels spends its time, on the card.

    python3 scripts/filter_phases.py [--wide] [--narrow] [ROOT]

Builds an instrumented copy of ``ROOT/alivevc_tpu_torch/csrc/filter.cu``
(ROOT defaults to this checkout; the copy goes into this checkout's
``alivevc_tpu_torch/_build/``, the source is not changed) with ``clock64``
read around each phase of a kernel, summed over a block's work, and prints
the microseconds a block spends in each phase, averaged over the blocks
(cycles over the SM clock, which the instrumented thread reads beside the
global timer).  Without ``--wide`` or ``--narrow`` it measures both.

``--wide``: one causal conv of ``filter_wide_kernel`` (k = 5, dilation 2,
with a residual) at the bench shape of levels 0 and 1 (16 windows; C = 256
at 4 500 samples, C = 64 at 36 000) in bf16 and float32, read by the first
cook thread and the first consumer thread of every block:

  cook: waiting for a free operand buffer, waiting for the raw rows (TMA),
        computing the operand, signalling and issuing the next raw rows;
  consumer: waiting for the operand, the taps (weights, ldmatrix, wgmma),
        the epilogue, and the whole kernel.

``--narrow``: whole narrow levels (C = 16 from 64 input channels, C = 8
from 16, rate 2, six convs at dilations 1, 1, 2, 2, 4, 4, a FiLM frame
every 320 samples) at the bench shape (16 windows, 72 000 and 144 000
output samples) in bf16 and float32 and at the streaming hop's (N = 1,
3 840 and 7 680 samples) in float32,
read by the first thread of every block (of every warpgroup, where the
kernel's warpgroups own their own tiles).  The phases are those of the
source found in ROOT: the PR 4 kernel (``mma.sync``) or its redesign
(``wgmma``, TMA); each prints its own names.

The instrumentation finds its places by exact lines of the kernel; a
changed kernel needs them changed here too.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
_lib = kf = None    # ROOT's kernels/_lib.py and kernels/filter.py, imported by main()

WIDE_PATCHES = [
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
WIDE_NAMES = ["cook: wait buffer", "cook: wait raw rows", "cook: compute", "cook: signal + next rows",
         "consumer: wait operand", "consumer: taps", "consumer: epilogue", "consumer: total"]


# The PR 4 narrow kernel (mma.sync, one block a tile): the first thread of
# every block sums each phase of its tiles; phase 9 is every block barrier.
NARROW_PR4_PATCHES = [
    ("  if (tid < ZERO_BYTES / 4) reinterpret_cast<float*>(smem)[tid] = 0.f;\n",
     """  if (tid < ZERO_BYTES / 4) reinterpret_cast<float*>(smem)[tid] = 0.f;
  unsigned long long ph[10] = {}, c_ = clock64(), ns0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
  const unsigned long long k0 = c_;
  auto lap = [&](int i) { const unsigned long long c = clock64(); ph[i] += c - c_; c_ = c; };
"""),
    ("  // one wave of blocks, each walking over tiles\n", "  lap(8);\n  // one wave of blocks, each walking over tiles\n"),
    ("""        store8(U + (size_t)row * ldu + c, v);   // bf16: rounds the sum
      }
    }
  }
  __syncthreads();
""", """        store8(U + (size_t)row * ldu + c, v);   // bf16: rounds the sum
      }
    }
  }
  lap(0);
  __syncthreads();
  lap(9);
"""),
    ("""  __syncthreads();

  // 2. the 1x1 input conv; conv 0's FiLM frames load meanwhile
""", """  lap(1);
  __syncthreads();
  lap(9);

  // 2. the 1x1 input conv; conv 0's FiLM frames load meanwhile
"""),
    ("""    store8(G + (HOFF + row) * LDX + c, v);
  }
  __syncthreads();
""", """    store8(G + (HOFF + row) * LDX + c, v);
  }
  lap(2);
  __syncthreads();
  lap(9);
"""),
    ("""  __syncthreads();

  // 3. the causal convs""", """  lap(2);
  __syncthreads();
  lap(9);

  // 3. the causal convs"""),
    ("""    __syncthreads();   // G is whole; the previous conv is done with buffer (ci + 1) & 1
    if (ci + 1 < p.n_conv) load_film(ci + 1);
""", """    lap(3);
    __syncthreads();   // G is whole; the previous conv is done with buffer (ci + 1) & 1
    lap(9);
    if (ci + 1 < p.n_conv) load_film(ci + 1);
    lap(4);
"""),
    ("""    __syncthreads();   // the conv's output is whole; G and buffer ci & 1 are free
""", """    lap(5);
    __syncthreads();   // the conv's output is whole; G and buffer ci & 1 are free
    lap(9);
"""),
    ("""  __syncthreads();   // X is read out before the next tile's up conv writes it
  }
}""", """  lap(6);
  __syncthreads();   // X is read out before the next tile's up conv writes it
  lap(9);
  }
  if (tid == 0) {
    for (int i = 0; i < 10; ++i) g_narrow[i][blockIdx.x] = ph[i];
    g_narrow[14][blockIdx.x] = clock64() - k0;
    unsigned long long ns1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
    g_narrow[15][blockIdx.x] = ns1 - ns0;
  }
}"""),
]
NARROW_PR4_NAMES = ["load x_prev + skip, FiLM mix", "up conv", "1x1 (copy, conv 0's FiLM, product)",
                    "gelu/FiLM passes", "FiLM frame loads", "conv products + epilogues", "store",
                    "-", "weights", "block barriers"]

# The redesigned narrow kernel (wgmma, TMA): the first thread of every
# warpgroup sums each phase of its tiles.  The products'
# phases (fragments and issue, waits, epilogues) cover the 1x1 and the
# convs together.
NARROW_PATCHES = [
    ("""  const bool lead = tt == 0;
""", """  const bool lead = tt == 0;
  unsigned long long ph[14] = {}, c_ = clock64(), ns0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
  const unsigned long long k0 = c_;
  auto lap = [&](int i) { const unsigned long long c = clock64(); ph[i] += c - c_; c_ = c; };
"""),
    ("""      load_conv(nk, gsrc, sub, 0, nks, taps, d, f);
      issue(nk, wm, C, 0, nks, f, acc);
""", """      load_conv(nk, gsrc, sub, 0, nks, taps, d, f);
      issue(nk, wm, C, 0, nks, f, acc);
      lap(10);
"""),
    ("""          wgmma_wait<0>();
          load_conv(nk, gsrc, m, q * NK, nks, taps, d, f);
          issue(nk, wm, C, q * NK, nks, f, acc);
        }
        wgmma_wait<0>();
""", """          wgmma_wait<0>();
          lap(11);
          load_conv(nk, gsrc, m, q * NK, nks, taps, d, f);
          issue(nk, wm, C, q * NK, nks, f, acc);
          lap(10);
        }
        wgmma_wait<0>();
        lap(11);
"""),
    ("""          load_conv(nk, gsrc, m + wpt, 0, nks, taps, d, f);
          issue(nk, wm, C, 0, nks, f, acc);
        }
        finish(mode, m, ep, bv, fc, gb, head);
""", """          load_conv(nk, gsrc, m + wpt, 0, nks, taps, d, f);
          issue(nk, wm, C, 0, nks, f, acc);
        }
        lap(10);
        finish(mode, m, ep, bv, fc, gb, head);
        lap(12);
"""),
    ("""          load_conv(nk, gsrc, m, q * NK, nks, taps, d, f);
          issue(nk, wm, C, q * NK, nks, f, acc);
          wgmma_wait<0>();
        }
        finish(mode, m, acc, bv, fc, gb, head);
""", """          load_conv(nk, gsrc, m, q * NK, nks, taps, d, f);
          issue(nk, wm, C, q * NK, nks, f, acc);
          lap(10);
          wgmma_wait<0>();
          lap(11);
        }
        finish(mode, m, acc, bv, fc, gb, head);
        lap(12);
"""),
    ("""    named_barrier(bar_id, team);   // (A) the previous tile is done
""", """    lap(13);
    named_barrier(bar_id, team);   // (A) the previous tile is done
    lap(0);
"""),
    ("""      tma_load_3d(smem_u32(xreg), m_f, 0, fb, tl.n, fbar);
    }
""", """      tma_load_3d(smem_u32(xreg), m_f, 0, fb, tl.n, fbar);
    }
    lap(1);
"""),
    ("""      RT[row] = make_int2(min(max(f - fb, 0), p.fbox - 1), __float_as_int(lam));
    }
""", """      RT[row] = make_int2(min(max(f - fb, 0), p.fbox - 1), __float_as_int(lam));
    }
    lap(2);
"""),
    ("""      mbar_wait(full + 8 * s, (unsigned)((c / p.stages) & 1));
""", """      mbar_wait(full + 8 * s, (unsigned)((c / p.stages) & 1));
      lap(3);
"""),
    ("""      // this warp has read the stage; the last warp's read lets the next chunk in
""", """      lap(4);
      // this warp has read the stage; the last warp's read lets the next chunk in
"""),
    ("""        fetch_chunk(c + p.stages);
      }
    }
""", """        fetch_chunk(c + p.stages);
      }
      lap(5);
    }
"""),
    ("""    if (lead) bulk_wait_read<0>();   // the previous tile's staging rows (G1) are read out
    named_barrier(bar_id, team);     // (B)
""", """    if (lead) bulk_wait_read<0>();   // the previous tile's staging rows (G1) are read out
    lap(6);
    named_barrier(bar_id, team);     // (B)
    lap(7);
"""),
    ("""    named_barrier(bar_id, team);   // (C)
""", """    lap(13);
    named_barrier(bar_id, team);   // (C)
    lap(7);
"""),
    ("""        named_barrier(bar_id, team);
      }
""", """        lap(13);
        named_barrier(bar_id, team);
        lap(7);
      }
"""),
    ("""  if (lead) {
    store_tile(my_tiles - 1);
    bulk_wait<0>();
  }
}""", """  if (lead) {
    store_tile(my_tiles - 1);
    bulk_wait<0>();
  }
  if (wt == 0) {
    const int row = gw * wpt + sub;
    for (int i = 0; i < 14; ++i) g_narrow[i][row] = ph[i];
    g_narrow[14][row] = clock64() - k0;
    unsigned long long ns1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
    g_narrow[15][row] = ns1 - ns0;
  }
}"""),
]
NARROW_NAMES = ["(A) barrier", "store + FiLM request", "FiLM mix a row", "up: wait input", "up: products",
                "up: release + refill", "FiLM wait + table", "(B), (C), conv barriers", "-", "-",
                "fragments + wgmma issue", "wgmma waits", "epilogues (gelu/FiLM)", "other"]
PHASE_ROWS = 1024      # blocks (or warpgroups) the counters hold


def build(root: Path, wide: bool, narrow: bool):
    """The instrumented library (installed as ROOT's ``filter`` library, so
    that its wrappers launch it) and the narrow patch set's names (or None)."""
    src = (root / "alivevc_tpu_torch" / "csrc" / "filter.cu").read_text()
    head = ""
    patches = []
    names = None
    if wide:
        head += f"__device__ unsigned long long g_phase[9][{PHASE_ROWS}];\n"
        patches += WIDE_PATCHES
    if narrow:
        head += f"__device__ unsigned long long g_narrow[16][{PHASE_ROWS}];\n"
        if "warp_mma" in src:
            patches += NARROW_PR4_PATCHES
            names = NARROW_PR4_NAMES
        else:
            patches += NARROW_PATCHES
            names = NARROW_NAMES
    src = src.replace("#include <type_traits>\n", "#include <type_traits>\n" + head, 1)
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"filter_phases: the kernel has changed; no single place for:\n{old}")
        src = src.replace(old, new)
    if wide:
        src += ("\nextern \"C\" int filter_phases_read(void* host) {\n"
                "  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));\n}\n")
    if narrow:
        src += ("\nextern \"C\" int filter_narrow_phases_read(void* host) {\n"
                "  cudaError_t e = cudaMemcpyFromSymbol(host, g_narrow, sizeof(g_narrow));\n"
                "  static unsigned long long zero[16][%d];\n"
                "  return (int)(e != cudaSuccess ? e : cudaMemcpyToSymbol(g_narrow, zero, sizeof(zero)));\n}\n"
                % PHASE_ROWS)
    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = _lib.BUILD_DIR / "filter_phases.cu", _lib.BUILD_DIR / "libfilter_phases.so"
    cu.write_text(src)
    out = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", str(root / "alivevc_tpu_torch" / "csrc"),
                          "-o", str(so), str(cu)], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(out.stdout[-4000:] + out.stderr[-4000:])
    lib = ctypes.CDLL(str(so))
    _lib._LIBS["filter"] = lib
    for key in [k for k in _lib._FNS if k[0] == "filter"]:
        del _lib._FNS[key]
    lib.filter_wide.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    lib.filter_wide.restype = ctypes.c_int
    return lib, names


def run_wide(lib) -> None:
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
            buf = np.zeros((9, PHASE_ROWS), dtype=np.uint64)
            if lib.filter_phases_read(ctypes.c_void_p(buf.ctypes.data)):
                raise RuntimeError("filter_phases: reading the counters failed")
            used = buf[7] > 0
            clock_mhz = float(buf[7, used].sum()) / float(buf[8, used].sum()) * 1e3   # cycles a microsecond
            us = buf[:8, used].astype(np.float64).mean(1) / clock_mhz
            print(f"wide {str(dt)[6:]} [{n}, {length}, {c}] tile {plan['tm']} x {plan['tn']}, {int(used.sum())} "
                  f"blocks, SM clock {clock_mhz:.0f} MHz: "
                  + " | ".join(f"{name} {v:.1f}" for name, v in zip(WIDE_NAMES, us)), flush=True)


# the narrow levels measured: (label, windows, output samples, C_in, C)
NARROW_SHAPES = [("level 2", 16, 72_000, 64, 16), ("level 3", 16, 144_000, 16, 8),
                 ("hop level 2", 1, 3_840, 64, 16), ("hop level 3", 1, 7_680, 16, 8)]


def random_level(gen, dt, n, l_in, cin, c, rate, k, dilations, frames):
    """A level's inputs and weights in ``kernels/filter.py``'s layouts,
    random with unit-scale activations."""
    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")).to(dt)

    n_conv = len(dilations)
    return dict(
        x_prev=rnd(n, l_in, cin, scale=0.3), skip=rnd(n, l_in, cin, scale=0.3),
        up_w=rnd(cin, rate * c, scale=cin ** -0.5), up_b=rnd(c, scale=0.1),
        in_w=rnd(c, c, scale=c ** -0.5), in_b=rnd(c, scale=0.1),
        conv_w=[rnd(k, c, c, scale=(k * c) ** -0.5) for _ in range(n_conv)],
        conv_b=[rnd(c, scale=0.1) for _ in range(n_conv)],
        film=torch.cat([torch.cat([1.0 + rnd(n, frames, c, scale=0.2), rnd(n, frames, c, scale=0.2)], 2)
                        for _ in range(n_conv)], 2),
        rate=rate, dilations=list(dilations))


def run_narrow(lib, names) -> None:
    """Each narrow shape through ROOT's ``filter_level_cuda`` (which launches
    the instrumented kernel), once to warm up and once measured."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dilations = [1, 1, 2, 2, 4, 4]
    for label, n, length, cin, c in NARROW_SHAPES:
        for dt in ((torch.float32,) if n == 1 else (torch.bfloat16, torch.float32)):
            args = random_level(gen, dt, n, length // 2, cin, c, 2, 5, dilations, length // 320)
            planner = getattr(kf, "narrow_plan", None)
            plan = planner(n, length, cin, c, 2, dt, 320) if planner else {"rows": kf.NARROW_ROWS}
            for _ in range(2):
                buf = np.zeros((16, PHASE_ROWS), dtype=np.uint64)
                if lib.filter_narrow_phases_read(ctypes.c_void_p(buf.ctypes.data)):
                    raise RuntimeError("filter_phases: clearing the counters failed")
                with torch.no_grad():
                    kf.filter_level_cuda(**args)
                torch.cuda.synchronize()
                if lib.filter_narrow_phases_read(ctypes.c_void_p(buf.ctypes.data)):
                    raise RuntimeError("filter_phases: reading the counters failed")
            used = buf[14] > 0
            clock_mhz = float(buf[14, used].sum()) / float(buf[15, used].sum()) * 1e3
            us = buf[:15, used].astype(np.float64).mean(1) / clock_mhz
            names = names + ["-"] * (14 - len(names)) + ["total"]
            shown = [(name, v) for name, v in zip(names, us) if name != "-"]
            print(f"narrow {label} {str(dt)[6:]} [{n}, {length // 2}, {cin}] -> C {c}, plan {plan}, "
                  f"{int(used.sum())} counted, SM clock {clock_mhz:.0f} MHz, us a block: "
                  + " | ".join(f"{name} {v:.2f}" for name, v in shown), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("filter_phases: CUDA is not available", file=sys.stderr)
        return 2
    argv = sys.argv[1:]
    wide, narrow = "--wide" in argv, "--narrow" in argv
    if not (wide or narrow):
        wide = narrow = True
    roots = [a for a in argv if not a.startswith("--")]
    root = Path(roots[0]).resolve() if roots else HERE
    sys.path.insert(0, str(root))
    global _lib, kf
    from alivevc_tpu_torch.kernels import _lib
    from alivevc_tpu_torch.kernels import filter as kf
    if not str(Path(_lib.PKG).resolve()).startswith(str(root)):
        print(f"filter_phases: imported {_lib.PKG}, not the package under {root}", file=sys.stderr)
        return 2
    lib, names = build(root, wide, narrow)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"{card}; kernel source {root}")
    if wide:
        run_wide(lib)
    if narrow:
        run_narrow(lib, names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
