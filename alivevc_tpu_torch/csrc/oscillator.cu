// Three DDSP harmonic sources.  The first two have the offline semantics: phi
// = 0, crop = (0, -1) (the phase is re-zeroed at the first sample).  osc_cheb
// launches one kernel on the caller's stream; osc_formant two, the phase
// scan and then the source.  The third, osc_stream, has the streaming
// semantics (a carried phase phi, the phase re-zeroed at any sample): two
// launches, the phase chain and then the source (section 3 below).
//
// 1. osc_cheb, the decoder's source, by the Chebyshev recurrence: x``seg``
// linear upsampling of the frame-rate f0 and amplitudes, closed-form phase
// integral, sin(k theta) for k = 1..NH by sin(k t) = 2 cos(t) sin((k-1) t)
// - sin((k-2) t), and the amplitude-weighted mean over the harmonics.
// Replaces: alivevc_tpu/kernels/oscillator_pallas.py:harmonic_source_cheb_pallas
// (_osc_cheb_kernel, pallas_call at :229).
//
// 2. osc_formant, the full-formant source over any formants [N, Lf, NH] (not
// f0 multiples), each harmonic with its own phase.  Replaces:
// alivevc_tpu/kernels/oscillator_pallas.py:harmonic_source_pallas (_osc_kernel
// :59-111, pallas_call at :281).
//
// What bounds them on an H100: operations.  16 windows x 144 000 samples x
// 64 harmonics are 147.5 M sample-harmonic pairs; the frame-rate inputs and
// one float per output sample are 11 MB.
//
// The base phases.  The TPU kernels carry a running phase across sequential
// time tiles; blocks here run in no order, so each frame's base phase is
// computed apart: per (window, column) the float64 exclusive prefix of the
// float32 frame totals, minus the phase of sample 0, wrapped mod 1.  The
// formant source has NH columns: osc_scan_kernel computes them first into
// a float32 [N, Lf, NH] scratch, O(Lf) work a column, in parallel over
// chunks of frames (see the kernel).  The Chebyshev source has one column
// of at most Lf floats, so each of its blocks sums the prefix of its own
// tile while it stages its amplitudes: no second launch, no scratch, and
// O(Lf) more L2 reads a block.  The frame totals, the first sample's phase
// and f = Hz * (1 / sample rate) are rounded exactly as the plain version
// rounds them on the card (no contracted products), so the offsets match it.
//
// The two-frame form.  Sample r of frame q mixes frames (q-1, q) for r <
// seg / 2 and (q, q+1) after (one weight of the three is exactly 0; for an
// odd seg the middle sample has weight 1 on frame q).  So the amplitude
// mix factors out of the harmonic sum: with A_lo = sum_k s_k a_lo,k and
// A_hi = sum_k s_k a_hi,k, the sample is (w_lo A_lo + w_hi A_hi) / NH, the
// plain version's own weights with no difference a_hi - a_lo formed.  Per
// pair the Chebyshev source does 3 FMAs: the recurrence and two
// accumulations.  In the formant source the phase mix is also two frames:
// in the second half the prefix weight of frame q-1 is constant, so it folds
// into a per-frame, per-harmonic constant beside the offset: 2 FMAs, then
// the reduction x - rint(x) (two adds by the 1.5 * 2^23 constant and a
// subtraction), one SFU sine of 2 pi x on [-pi, pi] (__sinf, absolute error
// about 4e-7), and 2 FMAs.  On an H100 the Chebyshev loop alone issues its
// FMAs at about two thirds of the card's float32 FMA rate, in any source
// order of the three (scripts/osc_loop_probe.py times it).  Not measured
// why; each recurrence FMA reads three registers that no neighbouring
// instruction shares, so register-bank conflicts are the suspect.
//
// Register blocking.  A warp task is 160 samples of one half-frame: a thread
// holds SPT = 5 samples, strided by 32 so that stores coalesce.  Amplitudes
// (and the formant source's frequencies and phase constants) are staged in
// shared memory once per tile of FB = 4 frames and read as float4 (four
// harmonics) that every lane of the warp shares (a broadcast), so each load
// feeds 4 x 5 pairs: 0.1 shared loads a pair (Chebyshev), 0.25 (formants).
// One block a tile, 8 warps for its 8 half-frames, in a plain grid: the
// block scheduler refills an SM as soon as a block ends, so a partial last
// wave costs at most one block's time.  (A persistent grid of resident
// blocks walking the tiles was no faster on the H100: its blocks stage and
// compute in step.)
//
// Sines.  The recurrence grows an error in 2 cos(theta) about k^2/2-fold by
// k = 64, so theta's sine and cosine are full float32 (sincosf).  theta is
// formed as the plain version forms it, (2 pi rounded to float) * x with x
// = the frame's mixed phase + offset: a sincospif of the wrapped phase would
// be closer to float64 by the plain version's own rounding of 2 pi x (a few
// 1e-6 rad at 50 rad), and the recurrence carries that to ~1e-4 at k = 64.
//
// 3. osc_stream, the streaming source (module/decoder.py:80-95), which the
// streaming hop runs: per harmonic h the float32 running sum dt of its
// frequency f0 * h / sample rate, upsampled x``seg``, re-zeroed at sample
// crop0, then theta = 2 pi dt + phi[h]; wave = the mean over h of sin(theta)
// times the upsampled amplitude, and phi_out = asin(sin theta) at every
// sample and harmonic.  Replaces no Pallas kernel: the JAX package's
// streaming source is plain jnp.cumsum (alivevc_tpu/models/decoder.py:139).
//
// The order of the sum is the contract.  Harmonic 64's phase reaches 1e4 to
// 1e5 cycles, where one float32 ulp is 1/1024 to 1/64 of a cycle: a sum in
// blocks (a parallel scan) or in float64 moves the source by 10 % of its
// peak at 150 Hz and by more than its peak at 2 kHz.  So the kernel forms
// the plain version's own float32 values on the card, every product and sum
// rounded on its own as its separate tensor operations round them
// (__fmul_rn / __fadd_rn / __fsub_rn: nothing contracted into an FMA), the
// running sum in time order from 0 as ATen's tensor_kernel_scan_outer_dim
// takes it, accurate sinf and asinf; only the mean over the harmonics is
// summed in another order.  An increment mixes two frames: the third
// weight of the x``seg`` upsampling is exactly 0 in each half-frame, and a
// zero product added to the sum leaves it as it is (a zero increment's sign
// never reaches the running sum, which starts at +0).
//
// What bounds it on an H100: the chain, Lw dependent float32 adds a
// harmonic (7 680 at the hop, about 16 us at 4 cycles an add); the sines
// and stores are about 1 us of the card.  ATen's scan spent 1.3 ms there:
// one thread a column, each step a dependent load from L2.  Here
// osc_stream_chain_kernel runs one block a row and one thread a harmonic;
// the running sum lives in a register, and each thread forms its own
// increments from its frames' f0 * h (registers) and the sample's two
// weights (shared memory, two samples a 16-byte load), so no step of the
// chain waits on a load: by hand-made software pipelining a batch of 8 adds
// and their coalesced row stores of dt (256 bytes a step at 64 harmonics)
// run beside the next batch's increments, whose weights were loaded a batch
// before.  Each warp then runs ~10 instructions a step (4 products and
// sums of the increment, the add, the store and its address), so the
// instruction rate, not the adds' latency, sets the pace: 65 us at the hop
// on the H100 (PERF.md).  Then osc_stream_kernel, a warp a sample over the whole
// card, reads dt back from L2, forms theta, its sine and asin, and sums the
// harmonics' products by warp shuffles (6 us).

#include "common.cuh"

#include <limits.h>

#include <algorithm>

namespace {

constexpr int NH_MAX = 256;       // harmonics held in shared memory
constexpr int SEG_MAX = 1024;     // samples a frame
constexpr int SPT = 5;            // samples a thread
constexpr int CHUNK = 32 * SPT;   // samples of a warp task
constexpr int WARPS = 8;          // warps a block
constexpr int THREADS = 32 * WARPS;
constexpr int FB = 4;             // frames a tile
constexpr int SCAN_THREADS = 1024;
constexpr float TWO_PI = 6.28318530717958647692f;
constexpr float RINT_MAGIC = 12582912.0f;   // 1.5 * 2^23: (x + M) - M = rint(x), |x| < 2^22

// a * wa + b * wb + c * wc, each product and sum rounded as the plain
// version's separate tensor operations round them
__device__ __forceinline__ float mix3(float a, float b, float c, float wa, float wb, float wc) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb)), __fmul_rn(c, wc));
}

__device__ __forceinline__ int clampq(int q, int lf) { return max(0, min(q, lf - 1)); }

// fin [N, Lf, H] Hz -> off [N, Lf, H]: the wrapped base phase of each frame.
// ws is the [3, seg] table of prefix-summed weights.  A block takes a window
// and CW columns; thread t takes column t % CW of chunk t / CW, a chunk
// being ceil(Lf / (1024 / CW)) consecutive frames (one frame at H = 1 and Lf
// <= 1024; four at H = 64, Lf = 450), so every load of a thread is in flight
// at once.  The chunks' float64 sums are scanned by warp shuffles, then
// across warps through shared memory.
template <int CW>
__global__ void __launch_bounds__(SCAN_THREADS)
osc_scan_kernel(const float* __restrict__ fin, float inv_sr, const float* __restrict__ ws,
                float* __restrict__ off, int lf, int h, int seg) {
  constexpr int CHUNKS = SCAN_THREADS / CW;
  __shared__ double warp_sum[SCAN_THREADS / 32][CW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = threadIdx.x % CW, chunk = threadIdx.x / CW;
  const int col = blockIdx.x * CW + c;
  const bool live = col < h;
  const int per = (lf + CHUNKS - 1) / CHUNKS;
  const int q0 = min(chunk * per, lf), q1 = min(q0 + per, lf);
  const size_t base_idx = (size_t)blockIdx.y * lf * h + (live ? col : 0);
  const float* fb = fin + base_idx;
  const float wa = ws[seg - 1], wb = ws[2 * seg - 1], wc = ws[3 * seg - 1];
  auto freq = [&](int q) { return __fmul_rn(fb[(size_t)clampq(q, lf) * h], inv_sr); };

  double sum = 0.0;
  if (live) {
    float fm = freq(q0 - 1), fq = freq(q0);
#pragma unroll 4
    for (int q = q0; q < q1; ++q) {
      const float fp = freq(q + 1);
      sum += (double)mix3(fm, fq, fp, wa, wb, wc);
      fm = fq;
      fq = fp;
    }
  }
  // inclusive scan over this column's chunks in the warp (lanes CW apart)
  double incl = sum;
#pragma unroll
  for (int d = CW; d < 32; d <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  double run = __shfl_up_sync(0xffffffffu, incl, CW);
  if (lane < CW) run = 0.0;
  if (lane >= 32 - CW) warp_sum[warp][c] = incl;
  __syncthreads();
  if (!live || q0 >= q1) return;
  for (int j = 0; j < warp; ++j) run += warp_sum[j][c];
  const double p0 = (double)mix3(freq(-1), freq(0), freq(1), ws[0], ws[seg], ws[2 * seg]);
  float* ob = off + base_idx;
  float fm = freq(q0 - 1), fq = freq(q0);
#pragma unroll 4
  for (int q = q0; q < q1; ++q) {
    const double o = run - p0;
    ob[(size_t)q * h] = (float)(o - floor(o));
    const float fp = freq(q + 1);
    run += (double)mix3(fm, fq, fp, wa, wb, wc);
    fm = fq;
    fq = fp;
  }
}

// A warp task: frame fi of the tile, half 0 (r < seg / 2) or 1, chunk ck of
// that half.  Returns false where the task holds no sample.
struct Task {
  int fi, half, rb, r_end;
};

__device__ __forceinline__ bool task_of(int task, int nck, int q0, int lf, int seg, Task& t) {
  t.fi = task / (2 * nck);
  t.half = (task / nck) & 1;
  const int h1 = seg / 2;
  t.rb = (t.half ? h1 : 0) + (task % nck) * CHUNK;
  t.r_end = t.half ? seg : h1;
  return q0 + t.fi < lf && t.rb < t.r_end;
}

// f0 [N, Lf] Hz, amps [N, Lf, NH] (float or bf16), tab [6, seg] = (w rows,
// ws rows) -> out [N, Lf * seg].  Dynamic shared memory: (FB + 2) rows of nh4
// amplitudes, frames q0 - 1 .. q0 + FB.  The block computes its frames' base
// phase itself (one column, so the prefix is at most Lf floats of L2): the
// float64 sum of the totals of frames p < q0, one frame a thread in rounds
// of 256 (two rounds at the decoder's 450 frames; the neighbours' f by
// warp shuffles), reduced by warp shuffles; then each warp adds its tile's
// earlier frames, as osc_scan_kernel does.  The amplitudes are loaded into
// registers first and stored to shared memory after the prefix, so their
// loads are in flight while it runs.
template <typename AT>
__global__ void __launch_bounds__(THREADS, 4)
osc_cheb_kernel(const float* __restrict__ fin, const AT* __restrict__ amps,
                const float* __restrict__ tab, float* __restrict__ out, int lf, int nh, int seg,
                float inv_sr) {
  constexpr int STAGE_ROUNDS = (FB + 2) * NH_MAX / THREADS;
  extern __shared__ float4 smem4[];
  __shared__ float f_s[FB + 2];
  __shared__ double part_s[WARPS], p0_s;
  float* a_s = reinterpret_cast<float*>(smem4);
  const int nh4 = (nh + 3) & ~3, r4 = nh4 / 4;
  const int nck = (seg - seg / 2 + CHUNK - 1) / CHUNK;
  const int tiles_per_row = (lf + FB - 1) / FB;
  const float* w = tab;
  const float* ws = tab + 3 * seg;
  const float wa = ws[seg - 1], wb = ws[2 * seg - 1], wc = ws[3 * seg - 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_nh = 1.0f / (float)nh;
  const int b = blockIdx.x / tiles_per_row, q0 = (blockIdx.x % tiles_per_row) * FB;
  const float* fb_row = fin + (size_t)b * lf;
  auto freq = [&](int q) { return __fmul_rn(fb_row[clampq(q, lf)], inv_sr); };

  // element e = threadIdx.x + 256 i of the staged rows is (row fr, column k)
  float av[STAGE_ROUNDS];
  const int step_fr = THREADS / nh4, step_k = THREADS - step_fr * nh4;
  int fr = threadIdx.x / nh4, k = threadIdx.x - fr * nh4;
#pragma unroll
  for (int i = 0; i < STAGE_ROUNDS; ++i) {
    av[i] = fr < FB + 2 && k < nh
                ? to_f32(amps[((size_t)b * lf + clampq(q0 - 1 + fr, lf)) * nh + k]) : 0.0f;
    fr += step_fr;
    k += step_k;
    if (k >= nh4) {
      k -= nh4;
      ++fr;
    }
  }
  double part = 0.0;
#pragma unroll 2
  for (int pb = 0; pb < q0; pb += THREADS) {
    const int p = pb + threadIdx.x;
    const float fq = freq(p);
    float fm = __shfl_up_sync(0xffffffffu, fq, 1), fp = __shfl_down_sync(0xffffffffu, fq, 1);
    if (lane == 0) fm = freq(p - 1);
    if (lane == 31) fp = freq(p + 1);
    if (p < q0) part += (double)mix3(fm, fq, fp, wa, wb, wc);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) part += __shfl_xor_sync(0xffffffffu, part, d);
  if (lane == 0) part_s[warp] = part;
#pragma unroll
  for (int i = 0; i < STAGE_ROUNDS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (e < (FB + 2) * nh4) a_s[e] = av[i];
  }
  if (threadIdx.x < FB + 2) f_s[threadIdx.x] = freq(q0 - 1 + threadIdx.x);
  if (threadIdx.x == FB + 2) p0_s = (double)mix3(freq(-1), freq(0), freq(1), ws[0], ws[seg], ws[2 * seg]);
  __syncthreads();

  for (int task = warp; task < FB * 2 * nck; task += WARPS) {
    Task t;
    if (!task_of(task, nck, q0, lf, seg, t)) continue;
    const float fa = f_s[t.fi], fb = f_s[t.fi + 1], fc = f_s[t.fi + 2];
    double run = 0.0;
#pragma unroll
    for (int j = 0; j < WARPS; ++j) run += part_s[j];
    for (int i = 0; i < t.fi; ++i) run += (double)mix3(f_s[i], f_s[i + 1], f_s[i + 2], wa, wb, wc);
    const double o64 = run - p0_s;
    const float o = (float)(o64 - floor(o64));
    // s = sin(k theta) and sp = sin((k-1) theta), from k = 1; lanes past
    // the half-frame's end carry zeros
    float twoc[SPT], s[SPT], sp[SPT], lo[SPT], hi[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int r = t.rb + lane + 32 * j;
      const int rr = r < t.r_end ? r : t.rb;
      const float x = __fadd_rn(mix3(fa, fb, fc, ws[rr], ws[seg + rr], ws[2 * seg + rr]), o);
      float sn, cs;
      sincosf(__fmul_rn(TWO_PI, x), &sn, &cs);
      const bool ok = r < t.r_end;
      twoc[j] = ok ? 2.0f * cs : 0.0f;
      s[j] = ok ? sn : 0.0f;
      sp[j] = 0.0f;
      lo[j] = 0.0f;
      hi[j] = 0.0f;
    }
    const float4* alo = smem4 + (t.fi + t.half) * r4;
    const float4* ahi = alo + r4;
    // one harmonic: the two accumulations, then sin((k+1) theta)
#define OSC_CHEB_STEP(A, B)                                   \
  _Pragma("unroll") for (int j = 0; j < SPT; ++j) {           \
    lo[j] = fmaf(s[j], (A), lo[j]);                         \
    hi[j] = fmaf(s[j], (B), hi[j]);                         \
    const float nx = fmaf(s[j], twoc[j], -sp[j]);           \
    sp[j] = s[j];                                           \
    s[j] = nx;                                              \
  }
#pragma unroll 4
    for (int k4 = 0; k4 < r4; ++k4) {
      const float4 al = alo[k4], ah = ahi[k4];
      OSC_CHEB_STEP(al.x, ah.x)
      OSC_CHEB_STEP(al.y, ah.y)
      OSC_CHEB_STEP(al.z, ah.z)
      OSC_CHEB_STEP(al.w, ah.w)
    }
#undef OSC_CHEB_STEP
    float* ob = out + (size_t)b * lf * seg + (size_t)(q0 + t.fi) * seg;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int r = t.rb + lane + 32 * j;
      if (r < t.r_end)
        ob[r] = fmaf(w[t.half * seg + r], lo[j], __fmul_rn(w[(t.half + 1) * seg + r], hi[j])) * inv_nh;
    }
  }
}

// formants [N, Lf, NH] Hz, amps [N, Lf, NH] (float or bf16), off [N, Lf, NH]
// from the scan, tab as above -> out [N, Lf * seg].  Dynamic shared memory,
// rows of nh4 floats: (FB + 2) rows of f = Hz / sample rate and (FB + 2) of
// amplitudes for frames q0 - 1 .. q0 + FB, then per frame of the tile the
// first half's phase constant (the offset) and the second half's (offset +
// f[q-1] * ws[0][seg-1]).
template <typename AT>
__global__ void __launch_bounds__(THREADS, 4)
osc_formant_kernel(const float* __restrict__ fin, const AT* __restrict__ amps,
                   const float* __restrict__ off, const float* __restrict__ tab,
                   float* __restrict__ out, int lf, int nh, int seg, float inv_sr) {
  extern __shared__ float4 smem4[];
  const int nh4 = (nh + 3) & ~3, r4 = nh4 / 4;
  float* f_s = reinterpret_cast<float*>(smem4);
  float* a_s = f_s + (FB + 2) * nh4;
  float* c_s = a_s + (FB + 2) * nh4;
  const int nck = (seg - seg / 2 + CHUNK - 1) / CHUNK;
  const int tiles_per_row = (lf + FB - 1) / FB;
  const float* w = tab;
  const float* ws = tab + 3 * seg;
  const float ws0_tot = ws[seg - 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_nh = 1.0f / (float)nh;
  const int b = blockIdx.x / tiles_per_row, q0 = (blockIdx.x % tiles_per_row) * FB;

  for (int e = threadIdx.x; e < (FB + 2) * nh4; e += THREADS) {
    const int fr = e / nh4, k = e - fr * nh4;
    const size_t idx = ((size_t)b * lf + clampq(q0 - 1 + fr, lf)) * nh + k;
    f_s[e] = k < nh ? __fmul_rn(fin[idx], inv_sr) : 0.0f;
    a_s[e] = k < nh ? to_f32(amps[idx]) : 0.0f;
  }
  for (int e = threadIdx.x; e < FB * nh4; e += THREADS) {
    const int fi = e / nh4, k = e - fi * nh4;
    const int q = q0 + fi;
    float o = 0.0f, fm = 0.0f;
    if (q < lf && k < nh) {
      o = off[((size_t)b * lf + q) * nh + k];
      fm = __fmul_rn(fin[((size_t)b * lf + clampq(q - 1, lf)) * nh + k], inv_sr);
    }
    c_s[(2 * fi) * nh4 + k] = o;
    c_s[(2 * fi + 1) * nh4 + k] = fmaf(fm, ws0_tot, o);
  }
  __syncthreads();

  const float4* f4 = smem4;
  const float4* a4 = f4 + (FB + 2) * r4;
  const float4* c4 = a4 + (FB + 2) * r4;
  for (int task = warp; task < FB * 2 * nck; task += WARPS) {
    Task t;
    if (!task_of(task, nck, q0, lf, seg, t)) continue;
    float wslo[SPT], wshi[SPT], lo[SPT], hi[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int r = t.rb + lane + 32 * j;
      const int rr = r < t.r_end ? r : t.rb;
      wslo[j] = ws[t.half * seg + rr];
      wshi[j] = ws[(t.half + 1) * seg + rr];
      lo[j] = 0.0f;
      hi[j] = 0.0f;
    }
    const float4* flo = f4 + (t.fi + t.half) * r4;
    const float4* fhi = flo + r4;
    const float4* alo = a4 + (t.fi + t.half) * r4;
    const float4* ahi = alo + r4;
    const float4* cc = c4 + (2 * t.fi + t.half) * r4;
#define OSC_FORMANT_PAIR(FL, FH, C, AL, AH)                                   \
  _Pragma("unroll") for (int j = 0; j < SPT; ++j) {                           \
    const float x = fmaf((FH), wshi[j], fmaf((FL), wslo[j], (C)));          \
    const float xr = x - __fsub_rn(__fadd_rn(x, RINT_MAGIC), RINT_MAGIC);   \
    const float s = __sinf(TWO_PI * xr);                                    \
    lo[j] = fmaf(s, (AL), lo[j]);                                           \
    hi[j] = fmaf(s, (AH), hi[j]);                                           \
  }
#pragma unroll 2
    for (int k4 = 0; k4 < r4; ++k4) {
      const float4 fl = flo[k4], fh = fhi[k4], c = cc[k4], al = alo[k4], ah = ahi[k4];
      OSC_FORMANT_PAIR(fl.x, fh.x, c.x, al.x, ah.x)
      OSC_FORMANT_PAIR(fl.y, fh.y, c.y, al.y, ah.y)
      OSC_FORMANT_PAIR(fl.z, fh.z, c.z, al.z, ah.z)
      OSC_FORMANT_PAIR(fl.w, fh.w, c.w, al.w, ah.w)
    }
#undef OSC_FORMANT_PAIR
    float* ob = out + (size_t)b * lf * seg + (size_t)(q0 + t.fi) * seg;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int r = t.rb + lane + 32 * j;
      if (r < t.r_end)
        ob[r] = fmaf(w[t.half * seg + r], lo[j], __fmul_rn(w[(t.half + 1) * seg + r], hi[j])) * inv_nh;
    }
  }
}

constexpr int CHAIN_BATCH = 8;   // samples whose increments the chain computes ahead

// Samples [0, len) of a half-frame whose two mixed frames hold lo and hi (f0
// * h): inc = (lo w_lo + hi w_hi) / sample rate, dt = dt + inc, each dt
// stored to out[r * nh]; returns the running sum.  w holds the samples'
// weights as (w_lo, w_hi) pairs, two samples a float4.  Software-pipelined
// by hand, in registers the loop carries: a batch's adds and stores run
// beside the next batch's increments, whose weights were loaded a batch
// before.  (Compiled step by step, each step's shared load, products, sum
// and add waited on one another: ~25 cycles a step.)
__device__ __forceinline__ float chain_half(float acc, float* __restrict__ out,
                                            const float4* __restrict__ w, int len, float lo,
                                            float hi, int nh, float inv_sr) {
  constexpr int P = CHAIN_BATCH / 2;
  const int batches = len / CHAIN_BATCH;
  float4 wb[P];
  float inc[CHAIN_BATCH];
  auto increment = [&](int j) {
    const float wl = j & 1 ? wb[j / 2].z : wb[j / 2].x, wh = j & 1 ? wb[j / 2].w : wb[j / 2].y;
    return __fmul_rn(__fadd_rn(__fmul_rn(lo, wl), __fmul_rn(hi, wh)), inv_sr);
  };
#pragma unroll
  for (int j = 0; j < P; ++j) wb[j] = w[j];
#pragma unroll
  for (int j = 0; j < CHAIN_BATCH; ++j) inc[j] = increment(j);
#pragma unroll
  for (int j = 0; j < P; ++j) wb[j] = w[P + j];
  for (int b = 0; b < batches; ++b) {
    float* o = out + (size_t)b * CHAIN_BATCH * nh;
#pragma unroll
    for (int j = 0; j < CHAIN_BATCH; ++j) {
      acc = __fadd_rn(acc, inc[j]);
      o[j * nh] = acc;
      inc[j] = increment(j);    // the next batch's (past the half-frame's end: unused)
    }
#pragma unroll
    for (int j = 0; j < P; ++j) wb[j] = w[(b + 2) * P + j];
  }
  const float2* w2 = reinterpret_cast<const float2*>(w);
  for (int r = batches * CHAIN_BATCH; r < len; ++r) {
    const float2 x = w2[r];
    acc = __fadd_rn(acc, __fmul_rn(__fadd_rn(__fmul_rn(lo, x.x), __fmul_rn(hi, x.y)), inv_sr));
    out[(size_t)r * nh] = acc;
  }
  return acc;
}

// f0 [N, Lf] Hz, tab as above -> dt [N, Lf * seg, NH]: per (row, harmonic)
// the float32 running sum of the sample's frequency in cycles, in time
// order.  One block a row, thread k the harmonic k + 1.  w_s holds each
// sample's (lower, upper) frame weights, the second half-frame from an even
// pair so that both halves start on a float4, and two batches of padding
// that the last prefetches read.  The next frame's f0 is loaded a frame ahead.
__global__ void __launch_bounds__(NH_MAX)
osc_stream_chain_kernel(const float* __restrict__ f0, const float* __restrict__ tab,
                        float* __restrict__ dt, int lf, int nh, int seg, float inv_sr) {
  __shared__ float4 w_s[SEG_MAX / 2 + 1 + CHAIN_BATCH];
  float2* w2 = reinterpret_cast<float2*>(w_s);
  const int h1 = seg / 2, second = h1 + (h1 & 1);
  for (int i = threadIdx.x; i < 2 * (SEG_MAX / 2 + 1 + CHAIN_BATCH); i += blockDim.x) {
    const int r = i < second ? i : i - second + h1;
    w2[i] = i < h1 ? make_float2(tab[r], tab[seg + r])
            : i >= second && r < seg ? make_float2(tab[seg + r], tab[2 * seg + r])
                                     : make_float2(0.0f, 0.0f);
  }
  __syncthreads();
  const int k = threadIdx.x;
  if (k >= nh) return;
  const float mul = (float)(k + 1);
  const float* fr = f0 + (size_t)blockIdx.x * lf;
  float* out = dt + (size_t)blockIdx.x * lf * seg * nh + k;
  float acc = 0.0f, xm = __fmul_rn(fr[0], mul), xq = xm, fnext = fr[min(1, lf - 1)];
  for (int q = 0; q < lf; ++q, out += (size_t)seg * nh) {
    const float xp = __fmul_rn(fnext, mul);
    fnext = fr[min(q + 2, lf - 1)];
    acc = chain_half(acc, out, w_s, h1, xm, xq, nh, inv_sr);
    acc = chain_half(acc, out + (size_t)h1 * nh, w_s + second / 2, seg - h1, xq, xp, nh, inv_sr);
    xm = xq;
    xq = xp;
  }
}

// dt [N, Lw, NH] from the chain, amps [N, Lf, NH] (float or bf16), phi: the
// NH values of row b at phi + b * phi_stride, or the number phi_c where phi
// is null; tab as above -> wave [N, Lw], phi_out [N, Lw, NH].  A warp a
// sample, lane l the harmonics l, l + 32, ...
template <typename AT>
__global__ void __launch_bounds__(THREADS)
osc_stream_kernel(const float* __restrict__ dt, const AT* __restrict__ amps,
                  const float* __restrict__ phi, int phi_stride, float phi_c,
                  const float* __restrict__ tab, float* __restrict__ wave,
                  float* __restrict__ phi_out, int n, int lf, int nh, int seg, int crop0) {
  const int lane = threadIdx.x & 31;
  const int lw = lf * seg;
  const float inv_nh = 1.0f / (float)nh;
  const long long total = (long long)n * lw;
  for (long long s = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5); s < total;
       s += (long long)gridDim.x * WARPS) {
    const int b = (int)(s / lw), t = (int)(s - (long long)b * lw);
    const int q = t / seg, r = t - q * seg;
    const bool first = r < seg / 2;
    const int qa = first ? max(q - 1, 0) : q, qb = first ? q : min(q + 1, lf - 1);
    const float wa = tab[(first ? 0 : seg) + r], wb = tab[(first ? seg : 2 * seg) + r];
    const size_t row = (size_t)b * lw;
    const float* d = dt + (row + t) * nh;
    const float* dc = dt + (row + crop0) * nh;
    const AT* al = amps + ((size_t)b * lf + qa) * nh;
    const AT* ah = amps + ((size_t)b * lf + qb) * nh;
    const float* ph = phi == nullptr ? nullptr : phi + (size_t)b * phi_stride;
    float* po = phi_out + (row + t) * nh;
    float sum = 0.0f;
    for (int h = lane; h < nh; h += 32) {
      const float x = __fadd_rn(__fmul_rn(TWO_PI, __fsub_rn(d[h], dc[h])), ph == nullptr ? phi_c : ph[h]);
      const float sn = sinf(x);
      po[h] = asinf(sn);
      const float a = __fadd_rn(__fmul_rn(to_f32(al[h]), wa), __fmul_rn(to_f32(ah[h]), wb));
      sum = __fadd_rn(sum, __fmul_rn(sn, a));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) wave[row + t] = sum * inv_nh;
  }
}

size_t cheb_smem(int nh) { return (size_t)(FB + 2) * ((nh + 3) & ~3) * sizeof(float); }
size_t formant_smem(int nh) { return (size_t)(4 * FB + 4) * ((nh + 3) & ~3) * sizeof(float); }

bool bad_shape(int n, int lf, int nh, int seg) {
  return n < 1 || n > 65535 || lf < 1 || nh < 1 || nh > NH_MAX || seg < 1 || seg > SEG_MAX ||
         (long long)n * ((lf + FB - 1) / FB) > INT_MAX;
}

void launch_scan(const float* fin, float inv_sr, const float* ws, float* off, int n, int lf, int h,
                 int seg, cudaStream_t st) {
  // columns a block: the least power of two >= H, at most 8
  const int cw = h >= 5 ? 8 : h >= 3 ? 4 : h;
  const dim3 grid((h + cw - 1) / cw, n);
  if (cw == 8)
    osc_scan_kernel<8><<<grid, SCAN_THREADS, 0, st>>>(fin, inv_sr, ws, off, lf, h, seg);
  else if (cw == 4)
    osc_scan_kernel<4><<<grid, SCAN_THREADS, 0, st>>>(fin, inv_sr, ws, off, lf, h, seg);
  else if (cw == 2)
    osc_scan_kernel<2><<<grid, SCAN_THREADS, 0, st>>>(fin, inv_sr, ws, off, lf, h, seg);
  else
    osc_scan_kernel<1><<<grid, SCAN_THREADS, 0, st>>>(fin, inv_sr, ws, off, lf, h, seg);
}

// one tile of FB frames a block; the block scheduler refills each SM as its
// blocks end
int source_blocks(int n, int lf) { return n * ((lf + FB - 1) / FB); }

}  // namespace

// f0 [n, lf] float32 Hz; amps [n, lf, nh] float32 or bf16 (amps_bf16 != 0),
// nh <= 256; tab [6, seg] float32: interpolation weights w [3, seg], then
// their inclusive prefix sums ws; out [n, lf * seg] float32; inv_sr = 1 /
// sample rate in float32.  One launch: the kernel computes its own base
// phases.
extern "C" int osc_cheb(const void* f0, const void* amps, int amps_bf16, const void* tab, void* out,
                        int n, int lf, int nh, int seg, float inv_sr, void* stream) {
  if (bad_shape(n, lf, nh, seg)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fin = static_cast<const float*>(f0);
  const float* t = static_cast<const float*>(tab);
  float* o = static_cast<float*>(out);
  if (amps_bf16)
    osc_cheb_kernel<<<source_blocks(n, lf), THREADS, cheb_smem(nh), st>>>(
        fin, static_cast<const __nv_bfloat16*>(amps), t, o, lf, nh, seg, inv_sr);
  else
    osc_cheb_kernel<<<source_blocks(n, lf), THREADS, cheb_smem(nh), st>>>(
        fin, static_cast<const float*>(amps), t, o, lf, nh, seg, inv_sr);
  RETURN_LAUNCH_STATUS();
}

// formants [n, lf, nh] float32 Hz; amps [n, lf, nh] float32 or bf16; tab,
// inv_sr as above; off [n, lf, nh] float32 scratch; out [n, lf * seg].
extern "C" int osc_formant(const void* formants, const void* amps, int amps_bf16, const void* tab,
                           void* off, void* out, int n, int lf, int nh, int seg, float inv_sr,
                           void* stream) {
  if (bad_shape(n, lf, nh, seg)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fin = static_cast<const float*>(formants);
  const float* t = static_cast<const float*>(tab);
  float* o = static_cast<float*>(off);
  launch_scan(fin, inv_sr, t + 3 * seg, o, n, lf, nh, seg, st);
  const cudaError_t scan_status = cudaGetLastError();
  if (scan_status != cudaSuccess) return static_cast<int>(scan_status);
  float* dst = static_cast<float*>(out);
  if (amps_bf16)
    osc_formant_kernel<<<source_blocks(n, lf), THREADS, formant_smem(nh), st>>>(
        fin, static_cast<const __nv_bfloat16*>(amps), o, t, dst, lf, nh, seg, inv_sr);
  else
    osc_formant_kernel<<<source_blocks(n, lf), THREADS, formant_smem(nh), st>>>(
        fin, static_cast<const float*>(amps), o, t, dst, lf, nh, seg, inv_sr);
  RETURN_LAUNCH_STATUS();
}

// f0 [n, lf] float32 Hz; amps [n, lf, nh] float32 or bf16; phi: float32, nh
// values a row, row b at phi + b * phi_stride (phi_stride 0: one row for
// all), or null for the number phi_c; tab, inv_sr as above; crop0 in [0,
// lf * seg); dt [n, lf * seg, nh] float32 scratch; wave [n, lf * seg];
// phi_out [n, lf * seg, nh].  Two launches: the chain, then the source.
extern "C" int osc_stream(const void* f0, const void* amps, int amps_bf16, const void* phi,
                          int phi_stride, float phi_c, const void* tab, void* dt, void* wave,
                          void* phi_out, int n, int lf, int nh, int seg, int crop0, float inv_sr,
                          void* stream) {
  if (bad_shape(n, lf, nh, seg) || (long long)lf * seg > INT_MAX || crop0 < 0 || crop0 >= lf * seg)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(tab);
  float* d = static_cast<float*>(dt);
  osc_stream_chain_kernel<<<n, (nh + 31) & ~31, 0, st>>>(static_cast<const float*>(f0), t, d, lf, nh,
                                                          seg, inv_sr);
  const cudaError_t chain_status = cudaGetLastError();
  if (chain_status != cudaSuccess) return static_cast<int>(chain_status);
  const long long samples = (long long)n * lf * seg;
  const int blocks = (int)std::min<long long>((samples + WARPS - 1) / WARPS, 1 << 16);
  const float* p = static_cast<const float*>(phi);
  float* w = static_cast<float*>(wave);
  float* po = static_cast<float*>(phi_out);
  if (amps_bf16)
    osc_stream_kernel<<<blocks, THREADS, 0, st>>>(d, static_cast<const __nv_bfloat16*>(amps), p,
                                                   phi_stride, phi_c, t, w, po, n, lf, nh, seg, crop0);
  else
    osc_stream_kernel<<<blocks, THREADS, 0, st>>>(d, static_cast<const float*>(amps), p, phi_stride,
                                                   phi_c, t, w, po, n, lf, nh, seg, crop0);
  RETURN_LAUNCH_STATUS();
}

// Blocks of the Chebyshev (formant = 0) or formant source kernel resident
// on one SM at once for nh harmonics (float32 amplitudes).
extern "C" int osc_blocks_per_sm(int formant, int nh) {
  if (nh < 1 || nh > NH_MAX) return -1;
  int per_sm = 0;
  const cudaError_t status =
      formant ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, osc_formant_kernel<float>, THREADS,
                                                              formant_smem(nh))
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, osc_cheb_kernel<float>, THREADS,
                                                              cheb_smem(nh));
  return status == cudaSuccess ? per_sm : -1;
}
