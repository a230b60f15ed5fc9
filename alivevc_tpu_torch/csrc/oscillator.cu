// Two DDSP harmonic sources, both with the offline semantics: phi = 0,
// crop = (0, -1) (the phase is re-zeroed at the first sample).
//
// 1. osc_cheb_f32, the decoder's source, by the Chebyshev recurrence: x320
// linear upsampling of the frame-rate f0 and amplitudes, closed-form phase
// integral, sin(k theta) for k = 1..NH by sin(k t) = 2 cos(t) sin((k-1) t)
// - sin((k-2) t), and the amplitude-weighted mean over the harmonics.
//
// Replaces: alivevc_tpu/kernels/oscillator_pallas.py:harmonic_source_cheb_pallas
// (_osc_cheb_kernel, pallas_call at :229).
//
// What bounds it on an H100: operations.  Per output sample it does one
// sinf, one cosf and ~6 float32 operations per harmonic (amplitude mix,
// recurrence, accumulate): 0.9 GFLOP at 16 x 144 000 samples x 64
// harmonics, against 11 MB of traffic (frame-rate inputs, one float per
// output sample).  No sample-rate intermediate touches device memory.
//
// Phase precision decides the result.  The TPU kernel carries a running
// phase across sequential time tiles, wrapped mod 1.  Blocks here run in no
// order, so each block (one window row x 8 frames) computes its own base
// phase: the sum of the float32 frame totals of every earlier frame, taken
// in float64 by a block reduction, minus the first sample's phase, wrapped
// mod 1 before it is cast to float32.  Inside a frame the phase stays below
// a few cycles, so sin(k theta) keeps float32 accuracy up to k = 64.
//
// 2. osc_formant_f32, the full-formant source over any formants [N, Lf, NH]
// (not f0 multiples).  Replaces:
// alivevc_tpu/kernels/oscillator_pallas.py:harmonic_source_pallas (_osc_kernel
// :59-111, pallas_call at :281).  Each harmonic has its own phase: the same
// closed-form mix with prefix-summed weights, a per-frame base taken as a
// float64 sum of the earlier frames' float32 totals, wrapped mod 1 (the TPU
// kernel carries it unwrapped in float32, which at harmonic 64 over a
// 450-frame window reaches ~1.7e5 cycles, a float32 ulp of ~0.016 cycles).
// The output is the mean over harmonics of sin(2 pi phase) amp, with the
// phase reduced mod 1 in float32 before sinpif.  Bound by operations: per
// sample and harmonic 7 FMAs (phase mix, amplitude mix, the weighted sum)
// and one sine, 16 x 144 000 x 64 of them in a 16-window step; the
// frame-rate inputs stage through shared memory, so traffic is the
// [N, Lf, NH] inputs and one float per output sample.

#include "common.cuh"

namespace {

constexpr int FT = 8;         // frames per block
constexpr int NH_MAX = 256;   // harmonics held in shared memory

__device__ __forceinline__ float frame_val(const float* f, int q, int lf) {
  return f[max(0, min(q, lf - 1))];   // edge replication (align_corners=False)
}

__global__ void osc_cheb_kernel(const float* __restrict__ f, const float* __restrict__ amps,
                                const float* __restrict__ w, const float* __restrict__ ws,
                                float* __restrict__ out, int lf, int nh, int seg) {
  __shared__ float a_s[(FT + 2) * NH_MAX];
  __shared__ double red[32];
  __shared__ float off_s[FT];

  const int b = blockIdx.y;
  const int q_start = blockIdx.x * FT;
  const float* fb = f + (size_t)b * lf;
  const float wsa = ws[seg - 1], wsb = ws[2 * seg - 1], wsc = ws[3 * seg - 1];

  // float64 sum of the frame totals before this block's first frame
  double part = 0.0;
  for (int q = threadIdx.x; q < q_start; q += blockDim.x)
    part += (double)(frame_val(fb, q - 1, lf) * wsa + frame_val(fb, q, lf) * wsb +
                     frame_val(fb, q + 1, lf) * wsc);
  for (int o = 16; o > 0; o >>= 1) part += __shfl_down_sync(0xffffffffu, part, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    double base = 0.0;
    for (int i = 0; i < (int)(blockDim.x + 31) / 32; ++i) base += red[i];
    // phase of sample 0, which the offline path re-zeroes against
    const float p0 = frame_val(fb, -1, lf) * ws[0] + frame_val(fb, 0, lf) * ws[seg] +
                     frame_val(fb, 1, lf) * ws[2 * seg];
    for (int i = 0; i < FT; ++i) {
      const int q = q_start + i;
      const double o = base - (double)p0;
      off_s[i] = (float)(o - floor(o));
      if (q < lf)
        base += (double)(frame_val(fb, q - 1, lf) * wsa + frame_val(fb, q, lf) * wsb +
                         frame_val(fb, q + 1, lf) * wsc);
    }
  }
  // amplitudes of frames q_start-1 .. q_start+FT, edge-replicated
  for (int e = threadIdx.x; e < (FT + 2) * nh; e += blockDim.x) {
    const int fr = e / nh, k = e % nh;
    const int q = max(0, min(q_start - 1 + fr, lf - 1));
    a_s[e] = amps[((size_t)b * lf + q) * nh + k];
  }
  __syncthreads();

  for (int r = threadIdx.x; r < seg; r += blockDim.x) {
    const float wa = w[r], wb = w[seg + r], wc = w[2 * seg + r];
    const float sa = ws[r], sb = ws[seg + r], sc = ws[2 * seg + r];
    for (int i = 0; i < FT; ++i) {
      const int q = q_start + i;
      if (q >= lf) break;
      const float cseg = frame_val(fb, q - 1, lf) * sa + frame_val(fb, q, lf) * sb +
                         frame_val(fb, q + 1, lf) * sc;
      const float theta = 6.28318530717958647692f * (cseg + off_s[i]);
      const float s1 = sinf(theta);
      const float twoc = 2.0f * cosf(theta);
      const float* a0 = a_s + i * nh;   // frame q - 1
      const float* a1 = a0 + nh;        // frame q
      const float* a2 = a1 + nh;        // frame q + 1
      float acc = s1 * (a0[0] * wa + a1[0] * wb + a2[0] * wc);
      float s_km2 = 0.0f, s_km1 = s1;
      for (int k = 1; k < nh; ++k) {
        const float s_k = twoc * s_km1 - s_km2;
        acc += s_k * (a0[k] * wa + a1[k] * wb + a2[k] * wc);
        s_km2 = s_km1;
        s_km1 = s_k;
      }
      out[(size_t)b * lf * seg + (size_t)q * seg + r] = acc / (float)nh;
    }
  }
}

constexpr int FS = FT + 2;    // staged frames q_start-1 .. q_start+FT

__global__ void osc_formant_kernel(const float* __restrict__ f, const float* __restrict__ amps,
                                   const float* __restrict__ w, const float* __restrict__ ws,
                                   float* __restrict__ out, int lf, int nh, int seg) {
  __shared__ float f_s[FS * NH_MAX];   // formants / sample_rate, edge-replicated
  __shared__ float a_s[FS * NH_MAX];
  __shared__ float off_s[FT * NH_MAX]; // per-frame base phase mod 1

  const int b = blockIdx.y;
  const int q_start = blockIdx.x * FT;
  const float* fb = f + (size_t)b * lf * nh;
  const float* ab = amps + (size_t)b * lf * nh;
  for (int e = threadIdx.x; e < FS * nh; e += blockDim.x) {
    const int fr = e / nh, h = e % nh;
    const int q = max(0, min(q_start - 1 + fr, lf - 1));
    f_s[e] = fb[(size_t)q * nh + h];
    a_s[e] = ab[(size_t)q * nh + h];
  }
  // one thread per harmonic: float64 sum of the frame totals before this
  // block, minus the phase of sample 0, wrapped mod 1
  const float wsa = ws[seg - 1], wsb = ws[2 * seg - 1], wsc = ws[3 * seg - 1];
  for (int h = threadIdx.x; h < nh; h += blockDim.x) {
    double base = 0.0;
    for (int q = 0; q < q_start; ++q)
      base += (double)(fb[(size_t)max(q - 1, 0) * nh + h] * wsa + fb[(size_t)q * nh + h] * wsb +
                       fb[(size_t)min(q + 1, lf - 1) * nh + h] * wsc);
    const float p0 = fb[h] * ws[0] + fb[h] * ws[seg] + fb[(size_t)min(1, lf - 1) * nh + h] * ws[2 * seg];
    for (int i = 0; i < FT; ++i) {
      const int q = q_start + i;
      const double o = base - (double)p0;
      off_s[i * nh + h] = (float)(o - floor(o));
      if (q < lf)
        base += (double)(fb[(size_t)max(q - 1, 0) * nh + h] * wsa + fb[(size_t)q * nh + h] * wsb +
                         fb[(size_t)min(q + 1, lf - 1) * nh + h] * wsc);
    }
  }
  __syncthreads();

  for (int r = threadIdx.x; r < seg; r += blockDim.x) {
    const float wa = w[r], wb = w[seg + r], wc = w[2 * seg + r];
    const float sa = ws[r], sb = ws[seg + r], sc = ws[2 * seg + r];
    for (int i = 0; i < FT; ++i) {
      const int q = q_start + i;
      if (q >= lf) break;
      const float* f0 = f_s + i * nh;   // frame q - 1
      const float* a0 = a_s + i * nh;
      const float* off = off_s + i * nh;
      float acc = 0.0f;
      for (int h = 0; h < nh; ++h) {
        float x = f0[h] * sa + f0[nh + h] * sb + f0[2 * nh + h] * sc + off[h];
        x -= floorf(x);
        acc += sinpif(2.0f * x) * (a0[h] * wa + a0[nh + h] * wb + a0[2 * nh + h] * wc);
      }
      out[(size_t)b * lf * seg + (size_t)q * seg + r] = acc / (float)nh;
    }
  }
}

}  // namespace

// f [n, lf] float32 = f0 / sample_rate; amps [n, lf, nh] float32 (nh <= 256);
// w, ws [3, seg] float32 interpolation weights and their prefix sums;
// out [n, lf * seg] float32.
extern "C" int osc_cheb_f32(const void* f, const void* amps, const void* w, const void* ws,
                            void* out, int n, int lf, int nh, int seg, void* stream) {
  if (nh > NH_MAX || nh < 1 || seg < 1 || seg > 1024) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((lf + FT - 1) / FT, n);
  const int threads = ((seg + 31) / 32) * 32;
  osc_cheb_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(amps),
      static_cast<const float*>(w), static_cast<const float*>(ws),
      static_cast<float*>(out), lf, nh, seg);
  RETURN_LAUNCH_STATUS();
}

// f [n, lf, nh] float32 = formants / sample_rate; amps [n, lf, nh] float32
// (nh <= 256); w, ws as above; out [n, lf * seg] float32.
extern "C" int osc_formant_f32(const void* f, const void* amps, const void* w, const void* ws,
                               void* out, int n, int lf, int nh, int seg, void* stream) {
  if (nh > NH_MAX || nh < 1 || seg < 1 || seg > 1024) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((lf + FT - 1) / FT, n);
  const int threads = ((seg + 31) / 32) * 32;
  osc_formant_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(amps),
      static_cast<const float*>(w), static_cast<const float*>(ws),
      static_cast<float*>(out), lf, nh, seg);
  RETURN_LAUNCH_STATUS();
}
