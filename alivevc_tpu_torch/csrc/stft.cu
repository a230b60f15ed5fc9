// STFT magnitude: framing + rectangular-window real FFT + |.| in one kernel.
//
// Replaces: alivevc_tpu/kernels/stft_pallas.py:stft_magnitude_pallas
// (_stft_kernel, pallas_call at :77).  out[b, f, k] = |sum_n xp[b, f*hop + n]
// * e^{-2 pi i n k / 1280}| over xp, x reflect-padded by 640 at both ends;
// n_fft 1280, 641 bins, float32.
//
// What bounds it on an H100: bytes.  At the conversion path's shape (16 x
// 144 000 samples, 451 frames) it reads 9.2 MB and writes 18.5 MB, 0.0083 ms
// at 3.35 TB/s; a real FFT is ~0.1 GFLOP, far below the card's float32
// ridge point.  (The dense DFT product it replaces was 23.7 GFLOP.)
//
// Design: a block owns FPB consecutive frames of one window.  It loads their
// sample span from x once (16-byte loads where aligned), reading the reflect
// pad by index arithmetic at both edges, so no padded copy exists and the 4x
// frame overlap costs no extra device-memory traffic.  Each 1280-point real
// frame is a 640-point complex FFT of z[m] = x[2m] + i x[2m+1] followed by
// the real-FFT split step.  640 = 5 * 8 * 16: a radix-5, a radix-8 and a
// radix-16 stage (the latter two composed of radix-4/2 steps in
// registers), Stockham order, ping-ponging between two shared-memory
// buffers (the plan is FFT_RADICES in
// kernels/stft.py; the CPU tests run it in numpy).  Twiddles come from a
// float32 table e^{-2 pi i t / 1280}, t < 1280, computed in float64 by the
// wrapper.  The magnitude is taken in registers and each frame's 641 bins
// are written contiguously.

#include "common.cuh"

#include <cstdint>

namespace {

constexpr int NFFT = 1280;
constexpr int NC = NFFT / 2;      // complex FFT length
constexpr int NBINS = NC + 1;
constexpr int FPB = 4;            // frames per block
constexpr int THREADS = 256;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cscale(float2 a, float s) { return make_float2(a.x * s, a.y * s); }
// a - i b and a + i b
__device__ __forceinline__ float2 sub_i(float2 a, float2 b) { return make_float2(a.x + b.y, a.y - b.x); }
__device__ __forceinline__ float2 add_i(float2 a, float2 b) { return make_float2(a.x - b.y, a.y + b.x); }

// forward DFTs of length R in place (w = e^{-2 pi i / R})
__device__ __forceinline__ void dft4(float2 (&u)[4]) {
  const float2 s02 = cadd(u[0], u[2]), d02 = csub(u[0], u[2]);
  const float2 s13 = cadd(u[1], u[3]), d13 = csub(u[1], u[3]);
  u[0] = cadd(s02, s13);
  u[2] = csub(s02, s13);
  u[1] = sub_i(d02, d13);
  u[3] = add_i(d02, d13);
}

__device__ __forceinline__ void dft5(float2 (&u)[5]) {
  constexpr float C1 = 0.309016994374947424f;    // cos(2 pi / 5)
  constexpr float C2 = -0.809016994374947424f;   // cos(4 pi / 5)
  constexpr float S1 = 0.951056516295153572f;    // sin(2 pi / 5)
  constexpr float S2 = 0.587785252292473129f;    // sin(4 pi / 5)
  const float2 t1 = cadd(u[1], u[4]), t2 = cadd(u[2], u[3]);
  const float2 t3 = csub(u[1], u[4]), t4 = csub(u[2], u[3]);
  const float2 a1 = cadd(u[0], cadd(cscale(t1, C1), cscale(t2, C2)));
  const float2 a2 = cadd(u[0], cadd(cscale(t1, C2), cscale(t2, C1)));
  const float2 b1 = cadd(cscale(t3, S1), cscale(t4, S2));
  const float2 b2 = csub(cscale(t3, S2), cscale(t4, S1));
  u[0] = cadd(u[0], cadd(t1, t2));
  u[1] = sub_i(a1, b1);
  u[4] = add_i(a1, b1);
  u[2] = sub_i(a2, b2);
  u[3] = add_i(a2, b2);
}

// e^{-2 pi i e / 16}
__device__ __forceinline__ float2 w16(int e) {
  constexpr float C[16] = {1.f, 0.923879532511286756f, 0.707106781186547524f, 0.382683432365089772f,
                           0.f, -0.382683432365089772f, -0.707106781186547524f, -0.923879532511286756f,
                           -1.f, -0.923879532511286756f, -0.707106781186547524f, -0.382683432365089772f,
                           0.f, 0.382683432365089772f, 0.707106781186547524f, 0.923879532511286756f};
  return make_float2(C[e & 15], -C[(e + 12) & 15]);   // sin(x) = cos(x - pi / 2)
}

// length 8: two length-4 DFTs of the even and odd inputs, then radix 2
__device__ __forceinline__ void dft8(float2 (&u)[8]) {
  float2 a[4] = {u[0], u[2], u[4], u[6]}, b[4] = {u[1], u[3], u[5], u[7]};
  dft4(a);
  dft4(b);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = cmul(w16(2 * k), b[k]);
    u[k] = cadd(a[k], t);
    u[k + 4] = csub(a[k], t);
  }
}

// length 16 as 4 x 4: DFTs over m of u[j + 4 m], twiddles W16^{j q}, then
// DFTs over j: y[q + 4 p]
__device__ __forceinline__ void dft16(float2 (&u)[16]) {
  float2 c[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int m = 0; m < 4; ++m) c[j][m] = u[j + 4 * m];
    dft4(c[j]);
#pragma unroll
    for (int q = 1; q < 4; ++q) c[j][q] = cmul(c[j][q], w16(j * q));
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float2 r[4] = {c[0][q], c[1][q], c[2][q], c[3][q]};
    dft4(r);
#pragma unroll
    for (int p = 0; p < 4; ++p) u[q + 4 * p] = r[p];
  }
}

template <int R> __device__ __forceinline__ void dft(float2 (&u)[R]);
template <> __device__ __forceinline__ void dft<5>(float2 (&u)[5]) { dft5(u); }
template <> __device__ __forceinline__ void dft<8>(float2 (&u)[8]) { dft8(u); }
template <> __device__ __forceinline__ void dft<16>(float2 (&u)[16]) { dft16(u); }

// One Stockham radix-R stage over nf frames: p is the product of the
// radices before it.  Butterfly i of a frame reads in[i + r M] (M = NC/R),
// twiddles input r by e^{-2 pi i r k / (p R)} with k = i mod p, and writes
// out[(i - k) R + k + r p].  FIRST reads z from the sample span instead.
template <int R, bool FIRST>
__device__ __forceinline__ void fft_stage(const float* __restrict__ span, int hop,
                                          const float2* __restrict__ in, float2* __restrict__ out,
                                          int p, const float2* __restrict__ tw, int nf) {
  constexpr int M = NC / R;
  for (int w = threadIdx.x; w < nf * M; w += THREADS) {
    const int fr = w / M, i = w - fr * M;
    const int k = i % p;
    float2 u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (FIRST) {
        const float* s = span + fr * hop + 2 * (i + r * M);
        u[r] = make_float2(s[0], s[1]);
      } else {
        u[r] = in[fr * NC + i + r * M];
      }
    }
    if (!FIRST) {
      const int step = 2 * (NC / (p * R)) * k;     // index into the 1280-entry table
#pragma unroll
      for (int r = 1; r < R; ++r) u[r] = cmul(u[r], __ldg(tw + r * step));
    }
    dft<R>(u);
    const int j = (i - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) out[fr * NC + j + r * p] = u[r];
  }
  __syncthreads();
}

__device__ __forceinline__ int reflect(int i, int len) {
  return i < 0 ? -i : (i >= len ? 2 * (len - 1) - i : i);
}

__global__ void __launch_bounds__(THREADS)
stft_fft_kernel(const float* __restrict__ x, const float2* __restrict__ tw, float* __restrict__ out,
                int len, int t, int hop, int blocks_per_row, int span_cap) {
  extern __shared__ __align__(16) float smem[];
  float* span = smem;                                          // [span_cap]
  float2* bufa = reinterpret_cast<float2*>(smem + span_cap);   // [FPB][NC]
  float2* bufb = bufa + FPB * NC;                              // [FPB][NC]

  const int b = blockIdx.x / blocks_per_row;
  const int f0 = (blockIdx.x - b * blocks_per_row) * FPB;
  const int nf = min(FPB, t - f0);
  const int slen = (nf - 1) * hop + NFFT;
  const int s0 = f0 * hop - NC;                  // x index of span[0]
  const float* row = x + (size_t)b * len;

  // s0 is a multiple of 4 (f0 and NC are), so a group of
  // four span samples is 16-byte aligned in x whenever the row start is
  const bool vec = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  for (int j = 4 * threadIdx.x; j < slen; j += 4 * THREADS) {
    const int g = s0 + j;
    if (vec && g >= 0 && g + 3 < len && j + 3 < slen) {
      *reinterpret_cast<float4*>(span + j) = __ldg(reinterpret_cast<const float4*>(row + g));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j + e < slen) span[j + e] = __ldg(row + reflect(g + e, len));
    }
  }
  __syncthreads();

  fft_stage<5, true>(span, hop, nullptr, bufa, 1, tw, nf);
  fft_stage<8, false>(span, hop, bufa, bufb, 5, tw, nf);
  fft_stage<16, false>(span, hop, bufb, bufa, 40, tw, nf);

  // real-FFT split: X[k] = E_k + W^k O_k with E_k = (Z_k + conj Z_{NC-k}) / 2,
  // O_k = (Z_k - conj Z_{NC-k}) / 2i, W = e^{-2 pi i / NFFT}
  float* dst = out + ((size_t)b * t + f0) * NBINS;
  for (int w = threadIdx.x; w < nf * NBINS; w += THREADS) {
    const int fr = w / NBINS, k = w - fr * NBINS;
    const float2* z = bufa + fr * NC;
    float re, im;
    if (k == 0 || k == NC) {
      re = k == 0 ? z[0].x + z[0].y : z[0].x - z[0].y;
      im = 0.f;
    } else {
      const float2 zk = z[k];
      const float2 zc = make_float2(z[NC - k].x, -z[NC - k].y);
      const float2 e = cscale(cadd(zk, zc), 0.5f);
      const float2 d = csub(zk, zc);
      const float2 o = make_float2(0.5f * d.y, -0.5f * d.x);
      const float2 x2 = cadd(e, cmul(__ldg(tw + k), o));
      re = x2.x;
      im = x2.y;
    }
    dst[w] = sqrtf(re * re + im * im);
  }
}

}  // namespace

// x [n, len] float32 (len > 640), tw [1280] complex float32 (e^{-2 pi i t /
// 1280}), out [n, t, 641] float32 with t = len / hop + 1.
extern "C" int stft_fft_mag_f32(const void* x, const void* tw, void* out, int n, int len, int t,
                                int hop, void* stream) {
  if (len <= NC || hop < 1 || t < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int span_cap = ((FPB - 1) * hop + NFFT + 3) & ~3;   // floats, a multiple of 4
  const int smem = span_cap * 4 + 2 * FPB * NC * 8;
  const int blocks_per_row = (t + FPB - 1) / FPB;
  const long long blocks = (long long)n * blocks_per_row;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(stft_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  stft_fft_kernel<<<(unsigned)blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float2*>(tw), static_cast<float*>(out), len, t,
      hop, blocks_per_row, span_cap);
  RETURN_LAUNCH_STATUS();
}
