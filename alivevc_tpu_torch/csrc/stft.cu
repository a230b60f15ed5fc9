// STFT magnitude: framing + rectangular-window DFT + |.| in one kernel.
//
// Replaces: alivevc_tpu/kernels/stft_pallas.py:stft_magnitude_pallas
// (_stft_kernel, pallas_call at :77).  out[b, f, k] = |sum_n xp[b, f*hop + n]
// * (cos - i sin)(2 pi n k / n_fft)| over a reflect-padded signal xp.
//
// What bounds it on an H100: operations.  At the conversion path's shape
// (16 x 144 000 samples, 451 frames, 641 bins) it is 2 products of
// [7 216 x 1280] x [1280 x 641] = 23.7 GFLOP in float32 against ~34 MB of
// traffic, far above the card's float32 ridge point.  The design is a plain
// register-tiled float32 GEMM whose A operand is never materialised: the
// frame matrix is index arithmetic on xp (row m = (b, f), column n reads
// xp[b, f*hop + n]), so the 4x-overlapping frames cost no extra memory
// traffic, and the re/im products share each loaded frame value before the
// magnitude is taken in registers.  (The TPU kernel's four shifted views
// were a lane-alignment trick and are not carried over.)  Tensor cores are
// not used: the JAX path's front end is float32.

#include "common.cuh"

namespace {

constexpr int BM = 64;   // frames per block
constexpr int BN = 64;   // bins per block
constexpr int BK = 16;   // samples per k-step

__global__ void __launch_bounds__(256)
stft_mag_kernel(const float* __restrict__ xp, const float* __restrict__ cosb,
                const float* __restrict__ sinb, float* __restrict__ out,
                int n_frames, int lp, int t, int nfft, int hop, int nbins) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ float Cs[BK][BN + 1];
  __shared__ float Ss[BK][BN + 1];

  const int tid = threadIdx.x;
  const int ty = tid / 16;      // 16 row groups of 4 frames
  const int tx = tid % 16;      // 16 column groups, columns tx + 16 j
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float re[4][4], im[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) { re[i][j] = 0.f; im[i][j] = 0.f; }

  for (int k0 = 0; k0 < nfft; k0 += BK) {
    // A tile: 64 frames x 16 samples, framing done by index arithmetic
#pragma unroll
    for (int q = 0; q < (BM * BK) / 256; ++q) {
      const int e = tid + 256 * q;
      const int r = e / BK, kk = e % BK;
      const int m = m0 + r;
      float v = 0.f;
      if (m < n_frames) {
        const int b = m / t, f = m % t;
        v = xp[(size_t)b * lp + (size_t)f * hop + k0 + kk];
      }
      As[kk][r] = v;
    }
    // basis tiles: 16 samples x 64 bins each
#pragma unroll
    for (int q = 0; q < (BN * BK) / 256; ++q) {
      const int e = tid + 256 * q;
      const int kk = e / BN, c = e % BN;
      const int col = n0 + c;
      const bool ok = col < nbins;
      Cs[kk][c] = ok ? cosb[(size_t)(k0 + kk) * nbins + col] : 0.f;
      Ss[kk][c] = ok ? sinb[(size_t)(k0 + kk) * nbins + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      float cb[4], sb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) { cb[j] = Cs[kk][tx + 16 * j]; sb[j] = Ss[kk][tx + 16 * j]; }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          re[i][j] = fmaf(a[i], cb[j], re[i][j]);
          im[i][j] = fmaf(a[i], sb[j], im[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= n_frames) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < nbins)
        out[(size_t)m * nbins + col] = sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
    }
  }
}

}  // namespace

// xp [n, lp] float32 (reflect-padded), cosb/sinb [nfft, nbins] float32,
// out [n, t, nbins] float32.  nfft must be a multiple of 16.
extern "C" int stft_mag_f32(const void* xp, const void* cosb, const void* sinb, void* out,
                            int n, int lp, int t, int nfft, int hop, int nbins,
                            void* stream) {
  const int n_frames = n * t;
  dim3 grid((nbins + BN - 1) / BN, (n_frames + BM - 1) / BM);
  stft_mag_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const float*>(cosb),
      static_cast<const float*>(sinb), static_cast<float*>(out),
      n_frames, lp, t, nfft, hop, nbins);
  RETURN_LAUNCH_STATUS();
}
