// One up level of the filter U-Net: (x_prev + skip) -> transposed rate conv
// -> 1x1 input conv -> 3 residual blocks (dilations 1, 2, 4), each
// [gelu -> FiLM -> causal conv k=5] x 2 + residual.  FiLM is scale and shift
// at frame rate (linear(cond) + 1, linear(cond)), interpolated to sample rate
// in-kernel with the align_corners=False 3-tap weights.  Every causal conv
// reflect-pads its input on the left over (k-1)*d samples.
//
// Replaces: alivevc_tpu/kernels/filter_pallas.py:_fused_impl (pallas_call at
// :771, _stack_kernel :308), entered by fused_filter_block_up :910 from
// models/filter_packed.py:428-440.  The TPU kernel's 128-lane time packing,
// selector-matmul FiLM and head-strip recompute are TPU layout and are not
// carried over; here a level is a handful of launches on channels-last
// [N, L, C] tensors:
//   gemm_bias  x2   transposed rate conv of (x_prev + skip), as one product
//                   [N*L_in, C_in] x [C_in, r*C] whose rows reshape to
//                   [N, L_in*r, C]; then the 1x1 input conv [N*L, C] x [C, C]
//   res_conv   x6   gelu -> FiLM -> dilated causal conv (+ residual on the
//                   second conv of each block)
//
// What bounds it on an H100: operations at the wide levels, bytes at the
// narrow ones.  At 16 windows x 144 000 samples the six causal convs cost
// 2*5*C*C MACs per sample: 283 GFLOP at C=256 (72 000 samples), 142 at
// C=64, 18 at C=16, 9 at C=8, against 74-147 MB per pass of the level
// tensor.  Storage is float32 or bf16; arithmetic is float32 in registers
// (exact erf GELU in both modes).  The res_conv block stages its input window
// (tile + halo) in shared memory already passed through gelu and FiLM, so
// each input value is transformed once per block and never written back,
// then each thread accumulates 8 output channels for 1-4 samples.  Tensor
// cores are not used yet.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// C[M, Nc] = (A (+ A2))[M, K] @ B[K, Nc] + bias[col % nbias]
// ---------------------------------------------------------------------------

constexpr int GM = 64, GN = 64, GK = 16;

template <typename T>
__global__ void __launch_bounds__(256)
gemm_bias_kernel(const T* __restrict__ A, const T* __restrict__ A2, const T* __restrict__ B,
                 const T* __restrict__ bias, T* __restrict__ C, long long M, int K, int Nc,
                 int nbias) {
  __shared__ __align__(16) float As[GK][GM + 4];
  __shared__ float Bs[GK][GN + 1];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long long m0 = (long long)blockIdx.x * GM;
  const int n0 = blockIdx.y * GN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GK) {
#pragma unroll
    for (int q = 0; q < (GM * GK) / 256; ++q) {
      const int e = tid + 256 * q;
      const int r = e / GK, kk = e % GK;
      const long long m = m0 + r;
      const int k = k0 + kk;
      float v = 0.f;
      if (m < M && k < K) {
        v = to_f32(A[m * K + k]);
        if (A2 != nullptr) v += to_f32(A2[m * K + k]);
      }
      As[kk][r] = v;
    }
#pragma unroll
    for (int q = 0; q < (GN * GK) / 256; ++q) {
      const int e = tid + 256 * q;
      const int kk = e / GN, c = e % GN;
      const int k = k0 + kk, col = n0 + c;
      Bs[kk][c] = (k < K && col < Nc) ? to_f32(B[(size_t)k * Nc + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < Nc) C[m * Nc + col] = from_f32<T>(acc[i][j] + to_f32(bias[col % nbias]));
    }
  }
}

// ---------------------------------------------------------------------------
// out = causal_conv_k,d( FiLM( gelu(h) ) ) + bias (+ res)
// ---------------------------------------------------------------------------

constexpr int K_MAX = 7;
constexpr int HALO_MAX = 24;

// FiLM value of channel c at sample s: the frame-rate tensor v [F, C]
// upsampled x r (align_corners=False) as the mix of frames q-1, q, q+1.
template <typename T>
__device__ __forceinline__ float film_at(const T* __restrict__ v, int s, int c, int C, int F,
                                         int r) {
  const int q = s / r, rr = s % r;
  const float u = ((float)rr + 0.5f) / (float)r - 0.5f;
  const float wa = u < 0.f ? -u : 0.f;
  const float wb = u < 0.f ? 1.f + u : 1.f - u;
  const float wc = u >= 0.f ? u : 0.f;
  const float x0 = to_f32(v[(size_t)max(q - 1, 0) * C + c]);
  const float x1 = to_f32(v[(size_t)min(q, F - 1) * C + c]);
  const float x2 = to_f32(v[(size_t)min(q + 1, F - 1) * C + c]);
  return x0 * wa + x1 * wb + x2 * wc;
}

template <typename T, int CO_T, int RS, int CI_T>
__global__ void __launch_bounds__(256)
res_conv_kernel(const T* __restrict__ h, const T* __restrict__ W, const T* __restrict__ bias,
                const T* __restrict__ scale, const T* __restrict__ shift,
                const T* __restrict__ res, T* __restrict__ out,
                int L, int C, int F, int r, int K, int d) {
  constexpr int NCG = CO_T / 8;      // channel groups of 8 outputs
  constexpr int NSG = 256 / NCG;     // sample groups
  constexpr int TT = NSG * RS;       // samples per block
  constexpr int XS_LD = CI_T + 1;
  __shared__ float xs[(TT + HALO_MAX) * XS_LD];
  __shared__ __align__(16) float wsm[K_MAX * CI_T * CO_T];

  const int tid = threadIdx.x;
  const int cg = tid % NCG, sg = tid / NCG;
  const int t0 = blockIdx.x * TT;
  const int co0 = blockIdx.y * CO_T;
  const int n = blockIdx.z;
  const int halo = (K - 1) * d;
  const T* hn = h + (size_t)n * L * C;
  const T* sc = scale + (size_t)n * F * C;
  const T* sh = shift + (size_t)n * F * C;

  float acc[RS][8];
#pragma unroll
  for (int i = 0; i < RS; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int ci0 = 0; ci0 < C; ci0 += CI_T) {
    __syncthreads();
    // input window [t0 - halo, t0 + TT), reflected at the left edge
    for (int e = tid; e < (TT + halo) * CI_T; e += 256) {
      const int row = e / CI_T, ci = e % CI_T;
      const int s = t0 - halo + row;
      float v = 0.f;
      if (s < L) {
        const int sr = s < 0 ? -s : s;
        const int c = ci0 + ci;
        v = gelu_erf(to_f32(hn[(size_t)sr * C + c])) * film_at(sc, sr, c, C, F, r) +
            film_at(sh, sr, c, C, F, r);
      }
      xs[row * XS_LD + ci] = v;
    }
    for (int e = tid; e < K * CI_T * CO_T; e += 256) {
      const int j = e / (CI_T * CO_T), rem = e % (CI_T * CO_T);
      const int ci = rem / CO_T, co = rem % CO_T;
      wsm[e] = to_f32(W[((size_t)j * C + ci0 + ci) * C + co0 + co]);
    }
    __syncthreads();
    for (int ci = 0; ci < CI_T; ++ci) {
      for (int j = 0; j < K; ++j) {
        float a[RS];
#pragma unroll
        for (int i = 0; i < RS; ++i) a[i] = xs[(sg + NSG * i + j * d) * XS_LD + ci];
        const float4 w0 = *reinterpret_cast<const float4*>(&wsm[(j * CI_T + ci) * CO_T + cg * 8]);
        const float4 w1 = *reinterpret_cast<const float4*>(&wsm[(j * CI_T + ci) * CO_T + cg * 8 + 4]);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < RS; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], wv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    const int t = t0 + sg + NSG * i;
    if (t >= L) continue;
    const size_t o = ((size_t)n * L + t) * C + co0 + cg * 8;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float v = acc[i][c] + to_f32(bias[co0 + cg * 8 + c]);
      if (res != nullptr) v += to_f32(res[o + c]);
      out[o + c] = from_f32<T>(v);
    }
  }
}

template <typename T, int CO_T, int RS, int CI_T>
int launch_res_conv(const void* h, const void* w, const void* bias, const void* scale,
                    const void* shift, const void* res, void* out, int n, int L, int C, int F,
                    int r, int K, int d, cudaStream_t stream) {
  constexpr int TT = (256 / (CO_T / 8)) * RS;
  dim3 grid((L + TT - 1) / TT, C / CO_T, n);
  res_conv_kernel<T, CO_T, RS, CI_T><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const T*>(scale), static_cast<const T*>(shift), static_cast<const T*>(res),
      static_cast<T*>(out), L, C, F, r, K, d);
  RETURN_LAUNCH_STATUS();
}

template <typename T>
int res_conv_dispatch(const void* h, const void* w, const void* bias, const void* scale,
                      const void* shift, const void* res, void* out, int n, int L, int C, int F,
                      int r, int K, int d, cudaStream_t s) {
  if (C % 64 == 0)
    return launch_res_conv<T, 64, 4, 16>(h, w, bias, scale, shift, res, out, n, L, C, F, r, K, d, s);
  if (C % 16 == 0)
    return launch_res_conv<T, 16, 2, 16>(h, w, bias, scale, shift, res, out, n, L, C, F, r, K, d, s);
  if (C % 8 == 0)
    return launch_res_conv<T, 8, 1, 8>(h, w, bias, scale, shift, res, out, n, L, C, F, r, K, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// a, a2 (may be null) [M, K]; b [K, Nc]; bias [nbias]; c [M, Nc].  All of
// one storage type: bf16 when bf16 != 0, else float32.
extern "C" int filter_gemm_bias(const void* a, const void* a2, const void* b, const void* bias,
                                void* c, long long M, int K, int Nc, int nbias, int bf16,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((unsigned)((M + GM - 1) / GM), (Nc + GN - 1) / GN);
  if (bf16)
    gemm_bias_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(a2),
        static_cast<const __nv_bfloat16*>(b), static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(c), M, K, Nc, nbias);
  else
    gemm_bias_kernel<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(a2),
        static_cast<const float*>(b), static_cast<const float*>(bias),
        static_cast<float*>(c), M, K, Nc, nbias);
  RETURN_LAUNCH_STATUS();
}

// h, res (may be null), out [n, L, C]; w [K, C, C] (tap, in, out); bias [C];
// scale, shift [n, F, C] at frame rate with L == F * r; (K-1)*d <= 24,
// K <= 7, L > (K-1)*d, C a multiple of 8.
extern "C" int filter_res_conv(const void* h, const void* w, const void* bias,
                               const void* scale, const void* shift, const void* res, void* out,
                               int n, int L, int C, int F, int r, int K, int d, int bf16,
                               void* stream) {
  if (K > K_MAX || (K - 1) * d > HALO_MAX || L <= (K - 1) * d)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return res_conv_dispatch<__nv_bfloat16>(h, w, bias, scale, shift, res, out, n, L, C, F, r,
                                            K, d, s);
  return res_conv_dispatch<float>(h, w, bias, scale, shift, res, out, n, L, C, F, r, K, d, s);
}
