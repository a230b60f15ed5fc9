// One up level of the filter U-Net: (x_prev + skip) -> transposed rate conv
// -> 1x1 input conv -> 3 residual blocks (dilations 1, 2, 4), each
// [gelu -> FiLM -> causal conv k=5] x 2 + residual.  FiLM is scale and shift
// at frame rate (linear(cond) + 1, linear(cond)), interpolated to sample rate
// in-kernel with the align_corners=False 3-tap weights.  Every causal conv
// reflect-pads its input on the left over (k-1)*d samples.
//
// Replaces: alivevc_tpu/kernels/filter_pallas.py:_fused_impl (pallas_call at
// :771, _stack_kernel :308), entered by fused_filter_block_up :910 from
// models/filter_packed.py:428-440.  The TPU kernel's 128-lane time packing
// and selector-matmul FiLM are TPU layout and are not carried over; its
// head-strip recompute becomes an in-place reflect (below).
//
// What bounds it on an H100: operations at the wide levels (C = 256, 64: the
// six causal convs are 2*5*C*C MACs a sample, 283 GFLOP at C = 256 and 16
// windows), bytes at the narrow ones (C = 16, 8: one read of the level's
// input, one write of its output).  Products run on the tensor cores with
// float32 accumulation: bf16 operands in bf16 storage; 3xTF32 in float32
// storage, each operand split as hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v -
// hi) and lo.hi + hi.lo + hi.hi accumulated (kernels/filter.py:product_3xtf32
// emulates it).
//
//   filter_wide_kernel    one product or causal conv of a wide level (any C
//                         but the narrow kernel's), on wgmma.  A level is 8
//                         launches (up conv: rows of [N*L_in, C_in] x
//                         [C_in, r*C] are the rows of [N, L, C]; 1x1; six
//                         convs) after one filter_wide_weights_kernel launch
//                         that writes every weight of the level K-major,
//                         [out][(tap, in)] (float32: its TF32 hi and lo).
//   filter_narrow_kernel  a whole narrow level (C = 8 or 16) in one launch:
//                         for each tile of T output samples plus the level's
//                         lookback (56 samples: 2*(k-1)*(1+2+4)) a block
//                         computes the up conv, the 1x1 and the six convs in
//                         shared memory and writes its T samples once.  Rows
//                         whose history the tile cut feed only rows it does
//                         not write; a tile whose rows start at sample 0
//                         reflects each conv's head in place, so no second
//                         pass is needed.  Its products are mma.sync.
//
// The wide kernel.  A block owns a tile of TM = 64 or 128 time rows (one or
// two consumer warpgroups, 64 rows each) x TN = 32-256 output columns and
// walks K in chunks of 128 bytes of input channels (64 bf16, 32 float32),
// all taps of a chunk before the next.  Each (chunk, tap) is one wgmma
// k-slab (4 k-steps):
//   - A (the operand) from registers: tap j reads the operand rows shifted by
//     (k-1-j)*d, d = 1, 2, 4 -- not a multiple of the 8-row atom a 128-byte
//     swizzled descriptor starts on, so A cannot be a shared-memory
//     descriptor (and one swizzled copy a shift class would stage every
//     chunk three times).  A chunk is staged once, unswizzled, in rows of 144
//     bytes (8 ldmatrix rows in distinct banks), and ldmatrix loads each
//     warp's m16 fragment at any row; float32 splits it into TF32 hi/lo in
//     registers.
//   - B (the weights, K-major) from shared memory through a 128-byte
//     swizzled descriptor: one 2-D TMA box of TN rows x 128 bytes a slab
//     (float32: the hi and the lo box) into a ring of stages, each with a
//     full mbarrier (the copy's bytes) and a count of the consumer warps
//     done with it: the last of them refills it, so that no warp waits for
//     another.  Two taps are in flight (two register sets of fragments).
//     Where a block has one column tile and all its slabs fit (C = 64 in
//     bf16: 40 KB), the weights are loaded once and stay.
//   - The operand is computed, not copied (gelu(x) * scale + shift, or
//     round(x_prev + skip)), so TMA cannot bring it in whole: TMA brings the
//     chunk's raw rows (source rows + halo, the skip, the FiLM frames the
//     tile interpolates) two chunks ahead, and two warpgroups of their own
//     (the cooks, registers handed to the consumers by setmaxnreg) compute
//     the operand into one of two buffers while the consumer warpgroups
//     multiply the other and write the last tile out.  The grid is
//     persistent (one wave of blocks walks the tiles).
//   - Few rows (the streaming hop, N = 1): the plan (kernels/filter.py:
//     wide_plan) narrows the column tile and splits K over a cluster of 2 or
//     4 blocks, block s taking chunks [s*chunks/S, (s+1)*chunks/S).  Each
//     block writes its float32 partial tile to its shared memory; after a
//     cluster barrier block s reduces rows [s*TM/S, (s+1)*TM/S) of the tile,
//     reading the S partials through distributed shared memory in rank order
//     (a fixed order, no atomics: the same bits every call), and runs the
//     epilogue on them.
//     (The ring's refill counts are integer atomics; no sum is.)
//   - Epilogue: each consumer warp writes its accumulators + bias (the bias
//     row staged in shared memory once a launch), rounded to the storage
//     type, into its 16 rows of the free operand buffer, then reads them
//     back a row piece a lane-octet and adds the residual (prefetched into
//     L2 while the tile multiplies, and each piece's loads issued before its
//     scratch rows are written; a plain load: it may alias the output, and
//     each element is read and then written by one thread), rounded again:
//     global loads and stores of 16 bytes a lane, whole 128-byte row pieces
//     an instruction, where the accumulator layout gave 8 rows of 16 bytes.
//   - GELU's erf is a branch-free polynomial (gelu_fast, within 4e-7 of the
//     exact-erf GELU in float32), the rest of the function exactly that of
//     kernels/filter.py:filter_level_plain: its bf16 rounding points, the
//     reflect head, FiLM interpolated from frame rate (align_corners=False).

#include "common.cuh"

#include <algorithm>
#include <cstdint>
#include <utility>
#include <type_traits>

namespace {

constexpr int K_MAX = 7;       // taps of a causal conv, at most
constexpr int HALO_MAX = 24;   // (k - 1) * d, at most
constexpr int ZERO_BYTES = 128;

// Row stride (elements) of a shared tile whose rows hold n values (n a
// multiple of 8), chosen so that the 8 rows an ldmatrix phase or a TF32
// fragment load touches fall in distinct banks: bf16 8 (mod 16) elements,
// float32 4 (mod 8).
template <bool BF16>
__host__ __device__ constexpr int ld_of(int n) { return BF16 ? (n % 16 == 0 ? n + 8 : n + 16) : n + 4; }
__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// d += a . b over one m16 x n8 tile: k16 of bf16, or k8 of TF32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 consecutive values (16-byte aligned) <-> float registers
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a, float& b) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = f.x;
  b = f.y;
}
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  a = f.x;
  b = f.y;
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
// 16 bytes (8 bf16 or 4 float32 values, 16-byte aligned) <-> float registers
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) { load8(p, v); }
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) { store8(p, v); }
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
// GELU with a branch-free erf (Abramowitz and Stegun 7.1.26: 1 - t P(t)
// exp(-a^2), t = 1 / (1 + 0.3275911 a)), within 6e-7 of erf in float32, so
// within 4e-7 of the exact-erf GELU: about one rounding of float32, in 14
// instructions where erff takes a branch a lane
__device__ __forceinline__ float gelu_fast(float x) {
  const float z = x * 0.70710678118654752f, a = fabsf(z);
  const float t = __fdividef(1.0f, fmaf(0.3275911f, a, 1.0f));
  const float y = t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f), -0.284496736f),
                           0.254829592f);
  const float e = copysignf(1.0f - y * __expf(-a * a), z);
  return 0.5f * x * (1.0f + e);
}
// round to the storage type and back (bf16), or nothing (float32)
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

// Global loads of 8 consecutive values (16-byte aligned) through the
// read-only path, kept raw so that a loop can put several in flight before
// it converts them.
template <typename T>
struct Raw8 {
  uint4 u[sizeof(T) / 2];
};
template <typename T>
__device__ __forceinline__ Raw8<T> ldg8(const T* p) {
  Raw8<T> r;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i) r.u[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  return r;
}
__device__ __forceinline__ void unpack8(const Raw8<__nv_bfloat16>& r, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.u[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack8(const Raw8<float>& r, float (&v)[8]) {
  const float* f = reinterpret_cast<const float*>(&r.u[0]);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = f[i];
}

// The align_corners=False interpolation of sample s at r samples a frame:
// before the middle of its frame q it mixes frames q - 1 and q, from the
// middle on q and q + 1 (clamped to [0, F)); the third of the 3-tap weights
// is 0.  One divide a row.
struct Taps2 {
  int lo, hi;
  float wl, wh;
};
__device__ __forceinline__ Taps2 film_taps(int s, int r, int F) {
  const int q = s / r;
  const float u = ((float)(s - q * r) + 0.5f) / (float)r - 0.5f;
  Taps2 t;
  if (u < 0.f) {
    t.lo = max(q - 1, 0); t.hi = q; t.wl = -u; t.wh = 1.f + u;
  } else {
    t.lo = q; t.hi = min(q + 1, F - 1); t.wl = 1.f - u; t.wh = u;
  }
  return t;
}

// ---------------------------------------------------------------------------
// The narrow kernel's products: one warp's share from shared memory,
//   acc[WM][WN] (m16 x n8 tiles) += A . B over k-groups [kg0, kg1)
// A k-group is 8 consecutive rows of B, i.e. 8 input channels of one tap:
// k-group kg is tap kg / cg, channels 8 (kg % cg) ..; its A rows for the
// warp's output row m are plane rows arow + 16 mi + tap * d + (row in tile).
// B is held transposed, [n][k]: output channel nb + n is row nb + n of
// ``b`` (``ldb`` elements a row), and k-group kg is its columns
// 8 (kg - kg0) ...  bf16 takes k-groups in pairs (k16); an odd last group
// pairs with the zero block, and its B columns must hold zeros.  TF32:
// SPLIT reads hi and lo planes (a_lo), else float32 values split here.
// B fragments are 32-bit shared loads on this layout.
// ---------------------------------------------------------------------------
template <bool BF16, bool SPLIT, int WM, int WN>
__device__ __forceinline__ void warp_mma(float (&acc)[WM][WN][4], const void* a, const float* a_lo,
                                         int lda, int arow, int d, int cg, int kg0, int kg1,
                                         int kg_total, const void* b, int ldb, int nb,
                                         const void* zero) {
  const int lane = threadIdx.x & 31;
  if (BF16) {
    const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(a);
    const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(b);
    for (int kg = kg0; kg < kg1 && kg < kg_total; kg += 2) {
      // lanes 0-15 address the first k-group's rows, 16-31 the second's
      // (addresses only in the branch: ldmatrix runs converged)
      const int mine = kg + (lane >> 4);
      unsigned addr = smem_u32(zero), step = 0;
      if (mine < kg_total) {
        const int tap = mine / cg, ch = mine - tap * cg;
        addr = smem_u32(A + (size_t)(arow + tap * d + (lane & 15)) * lda + 8 * ch);
        step = 32u * lda;   // 16 rows of bf16
      }
      uint32_t af[WM][4];
#pragma unroll
      for (int mi = 0; mi < WM; ++mi) ldsm_x4(af[mi], addr + mi * step);
      // b0 / b1 of n-tile ni: columns 2 t4 .. and 8 + 2 t4 .. of row g,
      // one 32-bit load each
      const __nv_bfloat16* brow = B + (size_t)(nb + (lane >> 2)) * ldb + 8 * (kg - kg0) + 2 * (lane & 3);
#pragma unroll
      for (int ni = 0; ni < WN; ++ni) {
        const uint32_t* bp = reinterpret_cast<const uint32_t*>(brow + (size_t)8 * ni * ldb);
        const uint32_t b0 = bp[0], b1 = bp[4];
#pragma unroll
        for (int mi = 0; mi < WM; ++mi) mma_bf16(acc[mi][ni], af[mi], b0, b1);
      }
    }
  } else {
    const float* A = static_cast<const float*>(a);
    const float* B = static_cast<const float*>(b);
    const int g = lane >> 2, t4 = lane & 3;
    for (int kg = kg0; kg < kg1 && kg < kg_total; ++kg) {
      const int tap = kg / cg, ch = kg - tap * cg;
      uint32_t ah[WM][4], al[WM][4];
#pragma unroll
      for (int mi = 0; mi < WM; ++mi) {
        const size_t o = (size_t)(arow + tap * d + 16 * mi + g) * lda + 8 * ch + t4;
        const size_t idx[4] = {o, o + (size_t)8 * lda, o + 4, o + (size_t)8 * lda + 4};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (SPLIT) {
            ah[mi][e] = __float_as_uint(A[idx[e]]);
            al[mi][e] = __float_as_uint(a_lo[idx[e]]);
          } else {
            split_tf32(A[idx[e]], ah[mi][e], al[mi][e]);
          }
        }
      }
      const float* bb = B + (size_t)(nb + g) * ldb + 8 * (kg - kg0) + t4;
#pragma unroll
      for (int ni = 0; ni < WN; ++ni) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(bb[(size_t)8 * ni * ldb], bh0, bl0);
        split_tf32(bb[(size_t)8 * ni * ldb + 4], bh1, bl1);
#pragma unroll
        for (int mi = 0; mi < WM; ++mi) {
          mma_tf32(acc[mi][ni], al[mi], bh0, bh1);
          mma_tf32(acc[mi][ni], ah[mi], bl0, bl1);
          mma_tf32(acc[mi][ni], ah[mi], bh0, bh1);
        }
      }
    }
  }
}

constexpr int ROWS_CAP = 256;   // rows a narrow tile holds: T output samples + lookback + alignment
constexpr int HOFF = HALO_MAX;         // operand rows above sample b0 (a conv's reflected head)
constexpr int MAX_CONV = 8;
constexpr int NARROW_THREADS = 256;

struct NarrowArgs {
  const void *x_prev, *skip, *up_w, *up_b, *in_w, *in_b, *film;
  void* out;
  const void* conv_w[MAX_CONV];
  const void* conv_b[MAX_CONV];
  int dil[MAX_CONV];
  int n_conv, K, L, cin, r, F, fr, film_ld, T, lookback, tiles;   // r: up rate, fr = L / F: FiLM rate
  int total;          // tiles in all windows
  int off_x, off_u, off_h, off_g, off_w, w_in, w_conv, w_stride, off_f, f_stride, off_t;   // shared (bytes)
};

// A row's FiLM mix: frames lo, hi (relative to the tile's first frame) and weights
struct RowTap {
  int lo, hi;
  float wl, wh;
};

// One wave of blocks walks the tiles (window, t0).  A tile writes samples
// [t0, t0 + T) and computes rows [b0, t0 + T), b0 = max(0, t0 - lookback)
// rounded down to a multiple of r.  Shared buffers: X (the level state) and
// H (a block's first conv's output), [rows][C]; G, the staged operand,
// HOFF + rows rows (row HOFF is sample b0; above it a conv's reflected head
// when b0 = 0); U, the up conv's input rows (x_prev + skip), aliasing H and
// G; the level's weights, loaded once a block; two FiLM frame buffers
// (float32), so that the next conv's frames load while the current conv
// multiplies; RT, each row's FiLM mix.  Two barriers a conv.  Each warp
// owns whole 16-row tiles (all C columns) of every product.
template <bool BF16, int C>
__global__ void __launch_bounds__(NARROW_THREADS)
filter_narrow_kernel(const NarrowArgs p) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  constexpr int NWARPS = NARROW_THREADS / 32, NT = C / 8, CG = C / 8;
  constexpr int LDX = ld_of<BF16>(C);   // X, H and G rows
  extern __shared__ __align__(128) unsigned char smem[];
  T* X = reinterpret_cast<T*>(smem + p.off_x);
  T* U = reinterpret_cast<T*>(smem + p.off_u);
  T* H = reinterpret_cast<T*>(smem + p.off_h);
  T* G = reinterpret_cast<T*>(smem + p.off_g);
  RowTap* RT = reinterpret_cast<RowTap*>(smem + p.off_t);
  // the weights, resident: up conv, 1x1, then one tile a causal conv
  T* W_up = reinterpret_cast<T*>(smem + p.off_w);
  T* W_in = reinterpret_cast<T*>(smem + p.off_w + p.w_in);
  auto wconv = [&](int i) { return reinterpret_cast<T*>(smem + p.off_w + p.w_conv + i * p.w_stride); };
  auto fbuf = [&](int i) { return reinterpret_cast<float*>(smem + p.off_f + (i & 1) * p.f_stride); };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int l_in = p.L / p.r;
  const int ldu = ld_of<BF16>(p.cin);
  const int NU = p.r * C;
  // weight tiles are held transposed ([n][k]); their row strides
  const int ldwu = ld_of<BF16>(round_up(p.cin, 16)), ldw1 = ld_of<BF16>(round_up(C, 16));
  const int ldwc = ld_of<BF16>(round_up(p.K * C, 16));
  if (tid < ZERO_BYTES / 4) reinterpret_cast<float*>(smem)[tid] = 0.f;

  // weights [rows][cols] -> dst transposed, [cols][rows] (ldw a row);
  // columns rows .. up to a multiple of 16 are zeros
  auto load_w = [&](T* dst, const void* wsrc, int rows, int cols, int ldw) {
    const T* s = static_cast<const T*>(wsrc);
    const int vpr = cols / 8, rows16 = round_up(rows, 16);
    for (int i = tid; i < rows16 * vpr; i += NARROW_THREADS) {
      const int row = i / vpr, c = (i - row * vpr) * 8;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
      if (row < rows) unpack8(ldg8(s + (size_t)row * cols + c), v);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(size_t)(c + j) * ldw + row] = from_f32<T>(v[j]);
    }
  };
  // The 1x1 and the causal convs arrive in the modules' own layouts,
  // [out][in] and [out][in][tap]: tile column tap C + in of row out.
  // Columns past the weights, up to a multiple of 16, are zeros.
  auto load_native = [&](T* dst, const void* wsrc, int taps, int ldw) {
    const T* s = static_cast<const T*>(wsrc);
    const int k16 = round_up(taps * C, 16);
    for (int i = tid; i < C * k16; i += NARROW_THREADS) {
      const int n = i / k16, k = i - n * k16;
      const int tap = k / C, ci = k - tap * C;
      dst[n * ldw + k] = k < taps * C ? s[((size_t)n * C + ci) * taps + tap] : from_f32<T>(0.f);
    }
  };
  load_w(W_up, p.up_w, p.cin, NU, ldwu);
  load_native(W_in, p.in_w, 1, ldw1);
  for (int ci = 0; ci < p.n_conv; ++ci) load_native(wconv(ci), p.conv_w[ci], p.K, ldwc);

  // one wave of blocks, each walking over tiles
  for (int tile = blockIdx.x; tile < p.total; tile += gridDim.x) {
  const int n = tile / p.tiles;
  const int t0 = (tile - n * p.tiles) * p.T;
  const int b0 = max(0, t0 - p.lookback) / p.r * p.r;
  const int e = min(t0 + p.T, p.L);
  const int R = e - b0, q0 = b0 / p.r, Q = (R + p.r - 1) / p.r;
  const int fa = max(b0 / p.fr - 1, 0), nf = min((e - 1) / p.fr + 1, p.F - 1) - fa + 1;
  const T* film = static_cast<const T*>(p.film) + ((size_t)n * p.F + fa) * p.film_ld;
  // conv ci's FiLM frames fa .. fa + nf (scale, shift) -> its float32 buffer
  auto load_film = [&](int ci) {
    float* fr = fbuf(ci);
    for (int i = tid; i < nf * 2 * C; i += NARROW_THREADS) {
      const int f = i / (2 * C), c = i - f * 2 * C;
      fr[i] = to_f32(film[(size_t)f * p.film_ld + 2 * ci * C + c]);
    }
  };

  // 1. the up conv: input rows q0 .. q0 + Q of x_prev + skip (rounded to the
  // storage type), [Q, cin] x [cin, r C]; column j C + c of input row q is
  // sample q r + j.  Meanwhile each row's FiLM mix.
  for (int row = tid; row < R; row += NARROW_THREADS) {
    const Taps2 tp = film_taps(b0 + row, p.fr, p.F);
    RT[row] = RowTap{tp.lo - fa, tp.hi - fa, tp.wl, tp.wh};
  }
  {
    const T* xp = static_cast<const T*>(p.x_prev) + (size_t)n * l_in * p.cin;
    const T* sk = static_cast<const T*>(p.skip) + (size_t)n * l_in * p.cin;
    const int vpr = p.cin / 8, tasks = Q * vpr;
    constexpr int UNR = BF16 ? 4 : 2;
    for (int e0 = tid; e0 < tasks; e0 += UNR * NARROW_THREADS) {
      Raw8<T> ra[UNR], rb[UNR];
#pragma unroll
      for (int k = 0; k < UNR; ++k) {
        const int i = e0 + k * NARROW_THREADS;
        if (i < tasks) {
          const int row = i / vpr, c = (i - row * vpr) * 8;
          ra[k] = ldg8(xp + (size_t)(q0 + row) * p.cin + c);
          rb[k] = ldg8(sk + (size_t)(q0 + row) * p.cin + c);
        }
      }
#pragma unroll
      for (int k = 0; k < UNR; ++k) {
        const int i = e0 + k * NARROW_THREADS;
        if (i >= tasks) break;
        const int row = i / vpr, c = (i - row * vpr) * 8;
        float v[8], u[8];
        unpack8(ra[k], v);
        unpack8(rb[k], u);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] += u[j];
        store8(U + (size_t)row * ldu + c, v);   // bf16: rounds the sum
      }
    }
  }
  __syncthreads();
  {
    const T* bias = static_cast<const T*>(p.up_b);
    const int kg = p.cin / 8;
    for (int mt = warp; mt < (Q + 15) / 16; mt += NWARPS)
      for (int j = 0; j < p.r; ++j) {
        float acc[1][NT][4] = {};
        warp_mma<BF16, false, 1, NT>(acc, U, nullptr, ldu, 16 * mt, 0, kg, 0, kg, kg, W_up, ldwu, j * C,
                                     smem);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int qi = 16 * mt + g + 8 * h, row = qi * p.r + j, col = 8 * ni + 2 * t4;
            if (qi < Q && row < R)
              store2(X + row * LDX + col, acc[0][ni][2 * h] + to_f32(bias[col]),
                     acc[0][ni][2 * h + 1] + to_f32(bias[col + 1]));
          }
      }
  }
  __syncthreads();

  // 2. the 1x1 input conv; conv 0's FiLM frames load meanwhile
  const int mtx = (R + 15) / 16;
  load_film(0);
  for (int i = tid; i < R * CG; i += NARROW_THREADS) {
    const int row = i / CG, c = (i - row * CG) * 8;
    float v[8];
    load8(X + row * LDX + c, v);
    store8(G + (HOFF + row) * LDX + c, v);
  }
  __syncthreads();
  {
    const T* bias = static_cast<const T*>(p.in_b);
    for (int mt = warp; mt < mtx; mt += NWARPS) {
      float acc[1][NT][4] = {};
      warp_mma<BF16, false, 1, NT>(acc, G, nullptr, LDX, HOFF + 16 * mt, 0, CG, 0, CG, CG, W_in, ldw1, 0,
                                   smem);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * mt + g + 8 * h, col = 8 * ni + 2 * t4;
          if (row < R)
            store2(X + row * LDX + col, acc[0][ni][2 * h] + to_f32(bias[col]),
                   acc[0][ni][2 * h + 1] + to_f32(bias[col + 1]));
        }
    }
  }
  __syncthreads();

  // 3. the causal convs: conv 2i reads X and writes H, conv 2i + 1 reads H
  // and adds into X.  Conv ci's FiLM frames are in buffer ci & 1.
  for (int ci = 0; ci < p.n_conv; ++ci) {
    const int d = p.dil[ci];
    const float* fr = fbuf(ci);
    const T* src = (ci & 1) ? H : X;
    for (int i = tid; i < R * CG; i += NARROW_THREADS) {
      const int row = i / CG, c = (i - row * CG) * 8;
      const RowTap rt = RT[row];
      float v[8], sl[8], sh[8], hl[8], hh[8];
      load8(fr + rt.lo * 2 * C + c, sl);
      load8(fr + rt.hi * 2 * C + c, sh);
      load8(fr + rt.lo * 2 * C + C + c, hl);
      load8(fr + rt.hi * 2 * C + C + c, hh);
      load8(src + row * LDX + c, v);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = gelu_erf(v[j]) * (sl[j] * rt.wl + sh[j] * rt.wh) + (hl[j] * rt.wl + hh[j] * rt.wh);
      store8(G + (HOFF + row) * LDX + c, v);   // bf16: rounds the operand
      if (b0 == 0 && row >= 1 && row <= HOFF) store8(G + (HOFF - row) * LDX + c, v);   // reflect
    }
    __syncthreads();   // G is whole; the previous conv is done with buffer (ci + 1) & 1
    if (ci + 1 < p.n_conv) load_film(ci + 1);
    const T* bias = static_cast<const T*>(p.conv_b[ci]);
    float bv[NT][2];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      bv[ni][0] = to_f32(bias[8 * ni + 2 * t4]);
      bv[ni][1] = to_f32(bias[8 * ni + 2 * t4 + 1]);
    }
    T* dst = (ci & 1) ? X : H;
    for (int mt = warp; mt < mtx; mt += NWARPS) {
      float acc[1][NT][4] = {};
      warp_mma<BF16, false, 1, NT>(acc, G, nullptr, LDX, HOFF - (p.K - 1) * d + 16 * mt, d, CG, 0,
                                   p.K * CG, p.K * CG, wconv(ci), ldwc, 0, smem);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * mt + g + 8 * h, col = 8 * ni + 2 * t4;
          if (row >= R) continue;
          float v0 = round_to<T>(acc[0][ni][2 * h] + bv[ni][0]);
          float v1 = round_to<T>(acc[0][ni][2 * h + 1] + bv[ni][1]);
          if (ci & 1) {
            v0 += to_f32(X[row * LDX + col]);
            v1 += to_f32(X[row * LDX + col + 1]);
          }
          store2(dst + row * LDX + col, v0, v1);
        }
    }
    __syncthreads();   // the conv's output is whole; G and buffer ci & 1 are free
  }

  // 4. the tile's samples [t0, e), once
  T* out = static_cast<T*>(p.out) + (size_t)n * p.L * C;
  const int first = t0 - b0;
  for (int i = tid; i < (R - first) * CG; i += NARROW_THREADS) {
    const int row = first + i / CG, c = (i % CG) * 8;
    float v[8];
    load8(X + row * LDX + c, v);
    store8(out + (size_t)(b0 + row) * C + c, v);
  }
  __syncthreads();   // X is read out before the next tile's up conv writes it
  }
}

size_t align128(size_t b) { return (b + 127) & ~(size_t)127; }

template <bool BF16, int C>
int launch_narrow(NarrowArgs p, int n, cudaStream_t stream) {
  const size_t sz = BF16 ? 2 : 4;
  const int ldx = ld_of<BF16>(C);
  const int ldu = ld_of<BF16>(p.cin);
  const int q_cap = round_up((ROWS_CAP + p.r - 1) / p.r, 16);
  size_t off = ZERO_BYTES;
  p.off_x = (int)off;
  off += align128((size_t)ROWS_CAP * ldx * sz);
  const size_t h_bytes = align128((size_t)ROWS_CAP * ldx * sz);
  const size_t g_bytes = align128((size_t)(HOFF + ROWS_CAP) * ldx * sz);
  const size_t u_bytes = align128((size_t)q_cap * ldu * sz);
  p.off_u = p.off_h = (int)off;
  p.off_g = (int)(off + h_bytes);
  off += u_bytes > h_bytes + g_bytes ? u_bytes : h_bytes + g_bytes;
  p.off_w = (int)off;
  p.w_in = (int)align128((size_t)p.r * C * ld_of<BF16>(round_up(p.cin, 16)) * sz);
  p.w_conv = p.w_in + (int)align128((size_t)C * ld_of<BF16>(round_up(C, 16)) * sz);
  p.w_stride = (int)align128((size_t)C * ld_of<BF16>(round_up(p.K * C, 16)) * sz);
  off += (size_t)p.w_conv + (size_t)p.n_conv * p.w_stride;
  p.off_f = (int)off;
  p.f_stride = (int)align128((size_t)((ROWS_CAP + p.fr - 1) / p.fr + 3) * 2 * C * 4);
  off += 2 * (size_t)p.f_stride;
  p.off_t = (int)off;
  off += align128((size_t)ROWS_CAP * sizeof(RowTap));
  if (off > 232448) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = filter_narrow_kernel<BF16, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)off);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.tiles = (p.L + p.T - 1) / p.T;
  if ((long long)n * p.tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  p.total = n * p.tiles;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NARROW_THREADS, off);
  kernel<<<(unsigned)min(p.total, max(1, sms * per_sm)), NARROW_THREADS, off, stream>>>(p);
  RETURN_LAUNCH_STATUS();
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

// ---------------------------------------------------------------------------
// Wide levels: one product or causal conv a launch, on wgmma (see the header)
// ---------------------------------------------------------------------------

constexpr int CHUNK_BYTES = 128;               // a K chunk: 128 bytes of input channels (one TMA box row)
constexpr int A_LD = CHUNK_BYTES + 16;         // bytes a staged operand row (ldmatrix rows in distinct banks)
constexpr int WIDE_HEAD = 1024;                // mbarriers; the weight ring starts 1024-aligned (swizzle)
constexpr int WIDE_MAX_STAGES = 16;
constexpr int WIDE_STREAM_STAGES = 4;          // ring depth where the weights stream
constexpr int KSTEPS = CHUNK_BYTES / 32;       // 32-byte wgmma k-steps a slab
constexpr int SMEM_MAX = 232448;
constexpr int COOK_WGS = 2;                    // warpgroups that cook the operand
// Registers a cook thread keeps (setmaxnreg) and a consumer takes: 256 x
// 200 + 256 x 56 = 65 536; at TN = 256 the consumers' 128 accumulators
// take 216 and the cooks 40 (10 % faster at level 0 in bf16 than 200 / 56,
// whose consumers spilled; the narrower tiles lose with 216 / 40, whose
// cooks spill)
template <int TN> __host__ __device__ constexpr int cook_regs() { return TN == 256 ? 40 : 56; }
template <int TN> __host__ __device__ constexpr int consumer_regs() { return TN == 256 ? 216 : 200; }

struct WideArgs {
  const void* bias;   // column c takes bias[c % nbias]
  const void* res;    // residual with out's layout, or null (may alias out)
  void* out;          // [L, N] or [n, L, N]
  int has_a2, has_film;   // the up conv's skip; a conv (else a product)
  int L, cin, N, taps, d, nbias, F, r, film_off;   // r = L / F; film_off: this conv's scale column
  int tiles_w, col_tiles, tiles;   // row tiles a window, column tiles, tiles in all
  int split, chunks;               // blocks of a cluster sharing a tile's K; K chunks of cin
  int stages, resident;            // ring depth; 1 when the weights are loaded once
  int a_buf, raw_buf, raw_a2, raw_f, fr_box;   // shared-memory layout (bytes); FiLM frames a box
  int bias_len;                                // floats of the bias row (N, rounded up)
};

// d = A . B (+ d where sd) over one k-step for the warpgroup's 64 rows x TN
// columns (bf16; TN = 256 as two n128 halves of the B box, 16 KB apart)
template <int TN>
__device__ __forceinline__ void wgmma_bf16_tile(float (&acc)[TN / 2], const uint32_t (&a)[4], unsigned b, int sd) {
  if constexpr (TN == 256) {
    wgmma_rs_bf16<128>(*reinterpret_cast<float(*)[64]>(&acc[0]), a, desc_sw128(b), sd);
    wgmma_rs_bf16<128>(*reinterpret_cast<float(*)[64]>(&acc[64]), a, desc_sw128(b + 128 * CHUNK_BYTES), sd);
  } else {
    wgmma_rs_bf16<TN>(acc, a, desc_sw128(b), sd);
  }
}

// Persistent grid (blocks, split): block (x, s) walks tiles x, x + gridDim.x,
// ... (column tile fastest; a conv's row tiles do not straddle windows) and
// takes chunks [s*chunks/split, (s+1)*chunks/split) of each.  Its work is a
// sequence of items (tile, chunk).  Warp roles: warpgroups 0 .. wgs-1
// consume (wgmma and the epilogue); the last COOK_WGS warpgroups cook.  Item
// i's raw rows (the operand source, the up conv's skip, the FiLM frames
// the tile's rows interpolate) arrive by TMA in raw buffer i & 1, issued
// two items ahead by the first cook thread; the cooks compute the operand
// into operand buffer i & 1 and signal afull; the consumers multiply it tap
// by tap against the weight ring and release the buffer (aempty) after the
// item's last tap.  So the cooking of items i + 1 and i + 2 overlaps the
// products and the epilogue of item i.  Registers move from the cooks to
// the consumers (setmaxnreg).  Shared memory: the mbarriers, the weight
// ring, two operand buffers, two raw buffers, the bias row, and with a
// split the partial tile.
template <bool BF16, int TN>
__global__ void __launch_bounds__(128 * (2 + COOK_WGS), 1)
filter_wide_kernel(const __grid_constant__ CUtensorMap w_hi, const __grid_constant__ CUtensorMap w_lo,
                   const __grid_constant__ CUtensorMap m_x, const __grid_constant__ CUtensorMap m_a2,
                   const __grid_constant__ CUtensorMap m_f, const WideArgs p) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  constexpr int CH = CHUNK_BYTES / (int)sizeof(T);   // channels a chunk: 64 bf16, 32 float32
  constexpr int E = 16 / (int)sizeof(T);             // values in 16 bytes
  constexpr int VPR = CHUNK_BYTES / 16;              // 16-byte vectors a chunk row
  constexpr int SLAB = TN * CHUNK_BYTES;             // one weight box: TN output channels x 128 bytes
  constexpr int STAGE = SLAB * (BF16 ? 1 : 2);       // float32: the TF32 hi box, then the lo box
  constexpr int LDP = TN + 8;                        // row stride of the split's partial tile (floats)
  constexpr int COOKS = 128 * COOK_WGS;
  static_assert(TN % 32 == 0 && TN <= (BF16 ? 256 : 128), "column tile");
  extern __shared__ unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wgs = (int)blockDim.x / 128 - COOK_WGS;  // consumer warpgroups
  const int tm = 64 * wgs;                           // 64 rows a consumer warpgroup
  const int consumers = 128 * wgs;
  const unsigned raw_addr = smem_u32(smem_raw);
  const unsigned base = (raw_addr + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw_addr);
  // mbarriers: the weight ring's full; raw full, operand full and empty, two each
  const unsigned full = base, rawfull = base + 8 * WIDE_MAX_STAGES;
  const unsigned afull = rawfull + 16, aempty = rawfull + 32;
  // consumer warps done with each stage (the ring's releases)
  unsigned* released = reinterpret_cast<unsigned*>(smem + 512);
  const unsigned ring = base + WIDE_HEAD;
  unsigned char* abuf = smem + WIDE_HEAD + p.stages * STAGE;
  unsigned char* rawb = abuf + 2 * p.a_buf;
  float* bias_s = reinterpret_cast<float*>(rawb + 2 * p.raw_buf);   // [N]: bias[c % nbias]
  float* part = bias_s + p.bias_len;                                 // split > 1: [tm][LDP]

  const int rank = p.split > 1 ? (int)cluster_rank() : 0;
  const int c_begin = rank * p.chunks / p.split;
  const int my_chunks = (rank + 1) * p.chunks / p.split - c_begin;
  const int halo = (p.taps - 1) * p.d, rows = tm + halo;
  const int my_tiles = (p.tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int items = my_tiles * my_chunks;
  const int total_steps = items * p.taps;            // weight slabs, one an (item, tap)

  struct Where {
    int n, t0, n0, chunk;
  };
  auto where = [&](int item) {
    const int tile = (int)blockIdx.x + (item / my_chunks) * (int)gridDim.x;
    const int rt = tile / p.col_tiles, ct = tile - rt * p.col_tiles;
    const int n = rt / p.tiles_w;
    return Where{n, (rt - n * p.tiles_w) * tm, ct * TN, c_begin + item % my_chunks};
  };
  // the first FiLM frame of a tile's box: every frame its rows (t0 - halo ..
  // t0 + tm, or 0 .. halo reflected) interpolate lies in [fb, fb + fr_box)
  auto film_base = [&](int t0) { return max(0, min(max(t0 - halo, 0) / p.r - 1, p.F - p.fr_box)); };

  // weight slab `step` (its item's chunk, tap step % taps) -> its stage
  auto fetch = [&](int step) {
    const int slot = p.resident ? step : step % p.stages;
    const Where w = where(step / p.taps);
    const int x = (step % p.taps) * p.cin + w.chunk * CH;
    const unsigned bar = full + 8 * slot, st = ring + slot * STAGE;
    mbar_expect_tx(bar, STAGE);
    tma_load(st, w_hi, x, w.n0, bar);
    if (!BF16) tma_load(st + SLAB, w_lo, x, w.n0, bar);
  };
  // item's raw rows -> raw buffer item & 1: the operand source's rows
  // t0 - halo .. t0 + tm of the chunk's channels (rows before the window's
  // first are another window's or zeros, and are read only reflected; rows
  // past the tensor are zeros), the skip's rows, the FiLM frames (scale box,
  // then shift box)
  auto fetch_raw = [&](int item) {
    const Where w = where(item);
    const unsigned bar = rawfull + 8 * (item & 1), dst = smem_u32(rawb) + (item & 1) * p.raw_buf;
    const int col = w.chunk * CH;
    mbar_expect_tx(bar, (rows + (p.has_a2 ? tm : 0) + (p.has_film ? 2 * p.fr_box : 0)) * CHUNK_BYTES);
    tma_load(dst, m_x, col, w.n * p.L + w.t0 - halo, bar);
    if (p.has_a2) tma_load(dst + p.raw_a2, m_a2, col, w.t0, bar);
    if (p.has_film) {
      const int fy = w.n * p.F + film_base(w.t0);
      tma_load(dst + p.raw_f, m_f, p.film_off + col, fy, bar);
      tma_load(dst + p.raw_f + p.fr_box * CHUNK_BYTES, m_f, p.film_off + p.cin + col, fy, bar);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      released[s] = 0;
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(rawfull + 8 * b, 1);
      mbar_init(afull + 8 * b, COOKS / 32);
      mbar_init(aempty + 8 * b, consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = tid; c < p.N; c += blockDim.x) bias_s[c] = to_f32(static_cast<const T*>(p.bias)[c % p.nbias]);
  __syncthreads();   // the barriers are initialised, the bias is in place

  if (tid >= consumers) {
    // ---- the cooks -------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(cook_regs<TN>()));
    const int ct = tid - consumers;
    if (ct == 0) {
      fetch_raw(0);
      if (items > 1) fetch_raw(1);
    }
    for (int item = 0; item < items; ++item) {
      const int b = item & 1, k = item % my_chunks;
      const Where w = where(item);
      if (item >= 2) mbar_wait(aempty + 8 * b, (unsigned)(((item >> 1) - 1) & 1));   // item - 2 is done
      mbar_wait(rawfull + 8 * b, (unsigned)((item >> 1) & 1));
      // raw -> operand: gelu(x) * scale + shift (row -s takes sample s: the
      // reflect pad), or round(a + skip); rows past L and channels past cin
      // are zeros.  A task is 16 bytes of a row.
      const T* raw = reinterpret_cast<const T*>(rawb + b * p.raw_buf);
      const T* fs = reinterpret_cast<const T*>(rawb + b * p.raw_buf + p.raw_f);
      const T* fh = fs + p.fr_box * CH;
      const T* ra2 = reinterpret_cast<const T*>(rawb + b * p.raw_buf + p.raw_a2);
      T* dst = reinterpret_cast<T*>(abuf + b * p.a_buf);
      const int fb = p.has_film ? film_base(w.t0) : 0;
      for (int e = ct; e < rows * VPR; e += COOKS) {
        const int i = e / VPR, v = e - i * VPR, c = w.chunk * CH + E * v;
        float x[E];
#pragma unroll
        for (int j = 0; j < E; ++j) x[j] = 0.f;
        if (c < p.cin) {
          if (p.has_film) {
            const int s = w.t0 - halo + i;
            if (s < p.L) {
              const int sr = s < 0 ? -s : s;
              const Taps2 tp = film_taps(sr, p.r, p.F);
              float s0[E], s1[E], h0[E], h1[E];
              load16(raw + (sr - (w.t0 - halo)) * CH + E * v, x);
              load16(fs + (tp.lo - fb) * CH + E * v, s0);
              load16(fs + (tp.hi - fb) * CH + E * v, s1);
              load16(fh + (tp.lo - fb) * CH + E * v, h0);
              load16(fh + (tp.hi - fb) * CH + E * v, h1);
#pragma unroll
              for (int j = 0; j < E; ++j)
                x[j] = gelu_fast(x[j]) * (s0[j] * tp.wl + s1[j] * tp.wh) + (h0[j] * tp.wl + h1[j] * tp.wh);
            }
          } else if (w.t0 + i < p.L) {
            load16(raw + i * CH + E * v, x);
            if (p.has_a2) {
              float u[E];
              load16(ra2 + i * CH + E * v, u);
#pragma unroll
              for (int j = 0; j < E; ++j) x[j] = round_to<T>(x[j] + u[j]);
            }
          }
        }
        store16(dst + i * (A_LD / (int)sizeof(T)) + E * v, x);   // bf16: rounds
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(afull + 8 * b);   // this warp's share of the operand is written
      // every cook is done with raw buffer b: item + 2's rows go there
      asm volatile("bar.sync 1, %0;\n" ::"n"(COOKS) : "memory");
      if (ct == 0 && item + 2 < items) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        fetch_raw(item + 2);
      }
      if (p.split > 1 && k == my_chunks - 1) {   // the consumers' two cluster barriers of the tile
        cluster_sync();
        cluster_sync();
      }
    }
    return;
  }

  // ---- the consumers -----------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(consumer_regs<TN>()));
  const T* res = static_cast<const T*>(p.res);
  T* out = static_cast<T*>(p.out);
  if (tid == 0) {
    const int first = p.resident ? my_chunks * p.taps : min(p.stages, total_steps);
    for (int s = 0; s < first; ++s) fetch(s);
  }
  // output pair (tile row `row`, absolute column col, col + 1; tile column
  // c): + bias, rounded; + residual, rounded again
  auto store_pair = [&](const Where& w, const float* bs, int row, int col, int c, float v0, float v1) {
    const int t = w.t0 + row;
    if (t >= p.L || col >= p.N) return;
    const size_t o = ((size_t)w.n * p.L + t) * p.N + col;
    v0 = round_to<T>(v0 + bs[c]);
    v1 = round_to<T>(v1 + bs[c + 1]);
    if (res != nullptr) {
      float r0, r1;
      load2(res + o, r0, r1);
      v0 += r0;
      v1 += r1;
    }
    store2(out + o, v0, v1);
  };
  // this thread's fragment rows: the warp's 16 rows of its warpgroup's 64
  const int wrow = (warp >> 2) * 64 + (warp & 3) * 16;
  const int g = lane >> 2, t4 = lane & 3;
  // A tile's first wgmma overwrites the accumulators (scale-d 0): no
  // other instruction writes them while products are in flight, which would
  // make ptxas serialize the wgmmas
  float acc[TN / 2];
#pragma unroll
  for (int e = 0; e < TN / 2; ++e) acc[e] = 0.f;
  int step = 0;
  for (int item = 0; item < items; ++item) {
    const int b = item & 1, k = item % my_chunks;
    const Where w = where(item);
    if (k == 0) {
      if (tid == 32 && res != nullptr) {   // the tile's residual rows into L2 while it multiplies
        const int t1 = min(w.t0 + tm, p.L);
        asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(res + ((size_t)w.n * p.L + w.t0) * p.N),
                     "r"((unsigned)((size_t)(t1 - w.t0) * p.N * sizeof(T))) : "memory");
      }
    }
    mbar_wait(afull + 8 * b, (unsigned)((item >> 1) & 1));
    const unsigned a_row = smem_u32(abuf + b * p.a_buf) + (wrow + (lane & 15)) * A_LD + (lane >> 4) * 16;
    // Two taps in flight: tap j + 1's fragments load into the other
    // register set while tap j multiplies; a set is rewritten only after
    // the products that read it are done (wait_group 1).
    auto load_tap = [&](int j, uint32_t (&aa)[KSTEPS][4], uint32_t (&ll)[KSTEPS][4]) {
      const int slot = p.resident ? k * p.taps + j : (step + j) % p.stages;
      mbar_wait(full + 8 * slot, p.resident ? 0u : (unsigned)(((step + j) / p.stages) & 1));
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        ldsm_x4(aa[ks], a_row + j * p.d * A_LD + 32 * ks);
        if constexpr (!BF16) {
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(aa[ks][e]), aa[ks][e], ll[ks][e]);
        }
      }
    };
    auto issue = [&](int j, uint32_t (&aa)[KSTEPS][4], uint32_t (&ll)[KSTEPS][4]) {
      const unsigned st = ring + (p.resident ? k * p.taps + j : (step + j) % p.stages) * STAGE;
      const int sd = k != 0 || j != 0;   // 0: the tile's first k-step
      wgmma_fence();
      if constexpr (BF16) {
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) wgmma_bf16_tile<TN>(acc, aa[ks], st + 32 * ks, ks ? 1 : sd);
      } else {
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          const uint64_t dh = desc_sw128(st + 32 * ks), dl = desc_sw128(st + SLAB + 32 * ks);
          wgmma_rs_tf32<TN>(acc, ll[ks], dh, ks ? 1 : sd);
          wgmma_rs_tf32<TN>(acc, aa[ks], dl);
          wgmma_rs_tf32<TN>(acc, aa[ks], dh);
        }
      }
      wgmma_commit();
    };
    // this warp is done with weight step s; the last consumer warp to be
    // done refills the stage (no warp waits for another)
    auto release = [&](int s) {
      if (p.resident) return;
      __syncwarp();
      if (lane == 0) {
        const int slot = s % p.stages;
        __threadfence_block();
        if (atomicAdd(&released[slot], 1u) == (unsigned)(consumers / 32 - 1)) {
          released[slot] = 0;
          __threadfence_block();
          if (s + p.stages < total_steps) {
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            fetch(s + p.stages);
          }
        }
      }
      __syncwarp();   // the warp whole again before its ldmatrix and wgmma
    };
    uint32_t a0[KSTEPS][4], lo0[KSTEPS][4], a1[KSTEPS][4], lo1[KSTEPS][4];
    load_tap(0, a0, lo0);
#pragma unroll 1
    for (int j = 0; j < p.taps; j += 2) {
      issue(j, a0, lo0);
      if (j + 1 < p.taps) {
        if (j >= 1) {
          wgmma_wait<1>();   // tap j - 1 is done: set 1 and its stage are free
          release(step + j - 1);
        }
        load_tap(j + 1, a1, lo1);
        issue(j + 1, a1, lo1);
        if (j + 2 < p.taps) {
          wgmma_wait<1>();   // tap j is done: set 0 and its stage are free
          release(step + j);
          load_tap(j + 2, a0, lo0);
        }
      }
    }
    wgmma_wait<0>();
    if (p.taps >= 2) release(step + p.taps - 2);
    release(step + p.taps - 1);
    step += p.taps;
    if (k != my_chunks - 1) {   // the tile's K is not done (this block's share of it)
      __syncwarp();
      if (lane == 0) mbar_arrive(aempty + 8 * b);   // the operand buffer is free
      continue;
    }
    const float* bs = bias_s + w.n0;
    if (p.split == 1) {
      // Through this warp's 16 rows of the operand buffer (free now), PW
      // columns (128 bytes, or the tile where narrower) at a time, so that
      // global loads and stores move 16 bytes a lane and whole row pieces an
      // instruction: the fragments, + bias and rounded, into the scratch
      // rows; then each row + residual, rounded.
      T* scr = reinterpret_cast<T*>(abuf + b * p.a_buf + warp * 16 * A_LD);
      constexpr int PW = TN < CH ? TN : CH;   // columns a piece
      constexpr int VR = PW / E, RPI = 32 / VR;   // 16-byte vectors a piece row; rows an instruction
      // every consumer warp is done reading the buffer (a warp's taps read
      // the next warp's first rows)
      constexpr int LDS = A_LD / (int)sizeof(T);
      const int v = lane % VR;
      // a piece's residual rows, raw, in flight while its scratch rows are
      // written (the first piece's across the barrier)
      uint4 y[16 / RPI];
      auto load_res = [&](int c0) {
        const int col = w.n0 + c0 + E * v;
#pragma unroll
        for (int q = 0; q < 16 / RPI; ++q) {
          const int t = w.t0 + wrow + RPI * q + lane / VR;
          y[q] = make_uint4(0u, 0u, 0u, 0u);
          if (res != nullptr && t < p.L && col < p.N)
            y[q] = *reinterpret_cast<const uint4*>(res + ((size_t)w.n * p.L + t) * p.N + col);
        }
      };
      load_res(0);
      asm volatile("bar.sync 2, %0;\n" ::"r"(consumers) : "memory");
#pragma unroll
      for (int c0 = 0; c0 < TN; c0 += PW) {
        if (c0 > 0) load_res(c0);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int jb = c0 / 8; jb < (c0 + PW) / 8; ++jb) {
            const int c = 8 * jb + 2 * t4;
            store2(scr + (g + 8 * h) * LDS + c - c0, round_to<T>(acc[4 * jb + 2 * h] + bs[c]),
                   round_to<T>(acc[4 * jb + 2 * h + 1] + bs[c + 1]));
          }
        __syncwarp();
        const int col = w.n0 + c0 + E * v;
#pragma unroll
        for (int q = 0; q < 16 / RPI; ++q) {
          const int r = RPI * q + lane / VR, t = w.t0 + wrow + r;
          float x[E], u[E];
          load16(scr + r * LDS + E * v, x);
          if constexpr (E == 8) {
            Raw8<T> rr;
            rr.u[0] = y[q];
            unpack8(rr, u);
          } else {
            u[0] = __uint_as_float(y[q].x); u[1] = __uint_as_float(y[q].y);
            u[2] = __uint_as_float(y[q].z); u[3] = __uint_as_float(y[q].w);
          }
#pragma unroll
          for (int j = 0; j < E; ++j) x[j] += u[j];
          if (t < p.L && col < p.N) store16(out + ((size_t)w.n * p.L + t) * p.N + col, x);
        }
        __syncwarp();
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int jb = 0; jb < TN / 8; ++jb)
          *reinterpret_cast<float2*>(part + (wrow + g + 8 * h) * LDP + 8 * jb + 2 * t4) =
              make_float2(acc[4 * jb + 2 * h], acc[4 * jb + 2 * h + 1]);
      cluster_sync();   // every block's partial tile is written
      const int r0 = rank * tm / p.split, nr = (rank + 1) * tm / p.split - r0;
      for (int e = tid; e < nr * (TN / 2); e += consumers) {
        const int row = r0 + e / (TN / 2), cc = 2 * (e % (TN / 2));
        const unsigned addr = smem_u32(part + row * LDP + cc);
        float s0 = 0.f, s1 = 0.f;
        for (int q = 0; q < p.split; ++q) {   // in rank order
          const float2 v = ld_cluster_f2(addr, (unsigned)q);
          s0 += v.x;
          s1 += v.y;
        }
        store_pair(w, bs, row, w.n0 + cc, cc, s0, s1);
      }
      cluster_sync();   // every block is done reading the partial tiles
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(aempty + 8 * b);   // the operand buffer (the epilogue's scratch) is free
  }
}

// The level's weights K-major for the wide kernel, one 32 x 32 tile (output
// channels x (tap, in)) a block, through shared memory: job j's [taps, cin,
// N] tensor (element strides s_tap, s_in, s_out) -> rows [N][(tap, in)] at
// element `begin` of hi (float32: TF32 hi, and lo = TF32 of the rest).
constexpr int PREP_MAX_JOBS = 8;
struct PrepJob {
  const void* src;
  long long s_tap, s_in, s_out, begin;
  int taps, cin, N, tiles_k, first_tile;   // 32-wide tiles along K; the job's first tile
};
struct PrepArgs {
  PrepJob job[PREP_MAX_JOBS];
  void* hi;
  float* lo;
  int jobs;
};

template <bool BF16>
__global__ void __launch_bounds__(256) filter_wide_weights_kernel(const PrepArgs p) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  __shared__ float tile[32][33];
  int j = 0;
  while (j + 1 < p.jobs && (int)blockIdx.x >= p.job[j + 1].first_tile) ++j;
  const PrepJob& q = p.job[j];
  const int t = blockIdx.x - q.first_tile, tn = t / q.tiles_k, tk = t - tn * q.tiles_k;
  const int kk = q.taps * q.cin, tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const T* src = static_cast<const T*>(q.src);
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // read: output channels along the warp
    const int k = tk * 32 + ty + 8 * i, n = tn * 32 + tx;
    float v = 0.f;
    if (k < kk && n < q.N) {
      const int tap = k / q.cin, ci = k - tap * q.cin;
      v = to_f32(src[tap * q.s_tap + ci * q.s_in + n * q.s_out]);
    }
    tile[ty + 8 * i][tx] = v;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // write: K along the warp
    const int n = tn * 32 + ty + 8 * i, k = tk * 32 + tx;
    if (n >= q.N || k >= kk) continue;
    const long long e = q.begin + (long long)n * kk + k;
    const float v = tile[tx][ty + 8 * i];
    if constexpr (BF16) {
      static_cast<T*>(p.hi)[e] = from_f32<T>(v);
    } else {
      uint32_t h, l;
      split_tf32(v, h, l);
      static_cast<float*>(p.hi)[e] = __uint_as_float(h);
      p.lo[e] = __uint_as_float(l);
    }
  }
}

int sm_count() {
  static int sms[64] = {};   // by device (the hop is host-bound: no query a launch)
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 1;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

int align_up(int b, int a) { return (b + a - 1) / a * a; }

template <bool BF16, int TN>
int launch_wide(const CUtensorMap (&maps)[5], WideArgs p, int wgs, cudaStream_t stream) {
  auto kernel = filter_wide_kernel<BF16, TN>;
  const int threads = 128 * (wgs + COOK_WGS), tm = 64 * wgs;
  const int rows = tm + (p.taps - 1) * p.d;
  p.a_buf = align_up(rows * A_LD, 128);
  p.raw_a2 = rows * CHUNK_BYTES;
  p.raw_f = p.raw_a2 + (p.has_a2 ? tm * CHUNK_BYTES : 0);
  p.raw_buf = align_up(p.raw_f + (p.has_film ? 2 * p.fr_box * CHUNK_BYTES : 0), 128);
  const size_t stage = (size_t)TN * CHUNK_BYTES * (BF16 ? 1 : 2);
  p.bias_len = align_up(p.N, 32);
  const size_t fixed = 1024 + WIDE_HEAD + 2 * (size_t)p.a_buf + 2 * (size_t)p.raw_buf + 4 * (size_t)p.bias_len +
                       (p.split > 1 ? (size_t)tm * (TN + 8) * 4 : 0);
  if (fixed + stage > (size_t)SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int fit = (int)std::min<size_t>(WIDE_MAX_STAGES, (SMEM_MAX - fixed) / stage);
  const int slabs = (p.chunks + p.split - 1) / p.split * p.taps;   // a block's slabs a tile, at most
  p.resident = p.col_tiles == 1 && slabs <= fit;
  p.stages = p.resident ? slabs : std::min(fit, WIDE_STREAM_STAGES);
  if (!p.resident && p.stages < 2) return static_cast<int>(cudaErrorInvalidValue);   // two taps in flight
  const size_t smem = fixed + (size_t)p.stages * stage;
  // On each card the shared-memory limit is raised once to the most any
  // launch of this instance asks, and each launch shape's occupancy is asked
  // once (the hop is host-bound)
  int dev = 0;
  cudaGetDevice(&dev);
  static size_t smem_set[64] = {};
  static std::pair<size_t, int> occupancy[8] = {};   // ((card, smem, threads), blocks an SM), newest first
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = smem;
  }
  const size_t key = ((size_t)dev << 40) + smem * 1024 + (size_t)threads;
  int per_sm = 0;
  for (const auto& e : occupancy)
    if (e.first == key) per_sm = e.second;
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    for (int i = 7; i > 0; --i) occupancy[i] = occupancy[i - 1];
    occupancy[0] = {key, per_sm};
  }
  cudaError_t err = cudaSuccess;
  const int blocks = std::min(p.tiles, std::max(1, sm_count() * std::max(per_sm, 1) / p.split));
  if (p.split == 1) {
    kernel<<<blocks, threads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], p);
    RETURN_LAUNCH_STATUS();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, (unsigned)p.split, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)p.split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], maps[3], maps[4], p);
  if (err != cudaSuccess) return static_cast<int>(err);
  RETURN_LAUNCH_STATUS();
}

}  // namespace

// One product (film == null) or causal conv (film != null) of a wide level.
// Products: a (+ a2) [L, cin] x w [cin, N] + bias[col % nbias] -> out [L, N]
// (n = 1).  Convs: gelu/FiLM of a [n, L, cin], causal taps k = taps at
// dilation d, + bias (+ res) -> out [n, L, N]; film [n, F, film_ld] with
// this conv's scale at column film_off and its shift at film_off + cin, at r
// samples a frame (L == F * r).  w_hi (and, in float32, w_lo): the weights
// K-major, [N][taps * cin] (filter_wide_weights).  The plan
// (kernels/filter.py:wide_plan): tn output columns a tile (32, 64, 128, or
// 256 in bf16), wgs warpgroups (64 rows each), split blocks a cluster
// sharing a tile's K (1, 2 or 4, at most the K chunks of cin).  bf16
// storage when bf16 != 0, else float32.  cin, N, film_ld multiples of 8;
// every pointer 16-byte aligned.
extern "C" int filter_wide(const void* a, const void* a2, const void* w_hi, const void* w_lo,
                           const void* bias, const void* res, void* out, const void* film, int n,
                           int L, int cin, int N, int taps, int d, int nbias, int F, int r,
                           int film_ld, int film_off, int tn, int wgs, int split, int bf16,
                           void* stream) {
  const int ch = CHUNK_BYTES / (bf16 ? 2 : 4);
  const int chunks = (cin + ch - 1) / ch;
  if (cin < 8 || cin % 8 || N < 8 || N % 8 || taps < 1 || taps > K_MAX || d < 0 ||
      (taps - 1) * d > HALO_MAX || nbias < 1 || n < 1 || L < 1 || misaligned(a) || misaligned(a2) ||
      misaligned(w_hi) || misaligned(w_lo) || misaligned(out) || misaligned(film) ||
      (!bf16 && w_lo == nullptr) || (wgs != 1 && wgs != 2) || (split != 1 && split != 2 && split != 4) ||
      split > chunks || (tn != 32 && tn != 64 && tn != 128 && !(tn == 256 && bf16)) ||
      (long long)n * L > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (film != nullptr && (L <= (taps - 1) * d || F < 1 || (long long)F * r != L || film_ld % 8 || film_off % 8 ||
                          film_off + cin > film_ld || (long long)n * F > 0x7fffffff))
    return static_cast<int>(cudaErrorInvalidValue);
  WideArgs p{};
  p.bias = bias; p.res = res; p.out = out;
  p.has_a2 = a2 != nullptr; p.has_film = film != nullptr;
  p.L = L; p.cin = cin; p.N = N; p.taps = taps; p.d = d; p.nbias = nbias; p.F = F; p.r = r;
  p.film_off = film_off;
  const int tm = 64 * wgs, rows = tm + (taps - 1) * d;
  p.tiles_w = (L + tm - 1) / tm;
  p.col_tiles = (N + tn - 1) / tn;
  const long long tiles = (long long)n * p.tiles_w * p.col_tiles;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = (int)tiles;
  p.split = split;
  p.chunks = chunks;
  p.fr_box = film != nullptr ? std::min(F, (rows - 1) / r + 4) : 0;
  // maps: the weights (hi, lo), the operand source, the skip, the FiLM
  CUtensorMap maps[5];
  if (!make_map(&maps[0], w_hi, bf16, N, taps * cin, tn) ||
      (!bf16 && !make_map(&maps[1], w_lo, false, N, taps * cin, tn)) ||
      !make_map(&maps[2], a, bf16, n * L, cin, rows, false) ||
      (a2 != nullptr && !make_map(&maps[3], a2, bf16, L, cin, tm, false)) ||
      (film != nullptr && !make_map(&maps[4], film, bf16, n * F, film_ld, p.fr_box, false)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) maps[1] = maps[0];
  if (a2 == nullptr) maps[3] = maps[2];
  if (film == nullptr) maps[4] = maps[2];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    switch (tn) {
      case 32: return launch_wide<true, 32>(maps, p, wgs, s);
      case 64: return launch_wide<true, 64>(maps, p, wgs, s);
      case 128: return launch_wide<true, 128>(maps, p, wgs, s);
      default: return launch_wide<true, 256>(maps, p, wgs, s);
    }
  }
  switch (tn) {
    case 32: return launch_wide<false, 32>(maps, p, wgs, s);
    case 64: return launch_wide<false, 64>(maps, p, wgs, s);
    default: return launch_wide<false, 128>(maps, p, wgs, s);
  }
}

// A level's weights K-major, in one launch: job j reads src[j] as [taps,
// cin, N] with element strides strides[3 j .. 3 j + 2] (tap, in, out) and
// dims[3 j ..] = (taps, cin, N), and writes [N][taps * cin] at element
// begin_j of hi (the jobs one after another); float32 (bf16 == 0) writes
// the TF32 split, hi and lo.
extern "C" int filter_wide_weights(int jobs, const void* const* src, const long long* strides,
                                   const int* dims, void* hi, void* lo, int bf16, void* stream) {
  if (jobs < 1 || jobs > PREP_MAX_JOBS || misaligned(hi) || (!bf16 && (lo == nullptr || misaligned(lo))))
    return static_cast<int>(cudaErrorInvalidValue);
  PrepArgs p{};
  long long begin = 0;
  int tiles = 0;
  for (int j = 0; j < jobs; ++j) {
    const int taps = dims[3 * j], cin = dims[3 * j + 1], nn = dims[3 * j + 2];
    if (taps < 1 || cin < 1 || nn < 1 || src[j] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int tiles_k = (taps * cin + 31) / 32;
    p.job[j] = PrepJob{src[j], strides[3 * j], strides[3 * j + 1], strides[3 * j + 2], begin,
                       taps, cin, nn, tiles_k, tiles};
    begin += (long long)taps * cin * nn;
    tiles += tiles_k * ((nn + 31) / 32);
  }
  p.hi = hi;
  p.lo = static_cast<float*>(lo);
  p.jobs = jobs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) filter_wide_weights_kernel<true><<<tiles, 256, 0, s>>>(p);
  else filter_wide_weights_kernel<false><<<tiles, 256, 0, s>>>(p);
  RETURN_LAUNCH_STATUS();
}

// A whole narrow level (C = 8 or 16) in one launch.  x_prev, skip
// [n, l_in, cin]; up_w [cin, r C], up_b [C]; in_w [C, C] ([out, in]), in_b
// [C]; conv_w and conv_b: host arrays of n_conv device pointers ([C, C, K]:
// [out, in, tap], a Conv1d weight; and [C]);
// dil: host array of n_conv dilations; film [n, F, 2 n_conv C] (conv i:
// scale at 2 i C, shift at (2 i + 1) C) with F dividing l_in r; out
// [n, l_in r, C].
extern "C" int filter_narrow(const void* x_prev, const void* skip, const void* up_w,
                             const void* up_b, const void* in_w, const void* in_b,
                             const void* const* conv_w, const void* const* conv_b, const int* dil,
                             const void* film, int n_conv, int K, void* out, int n, int l_in,
                             int cin, int C, int r, int F, int bf16, void* stream) {
  const long long L = (long long)l_in * r;
  if (n_conv < 2 || n_conv > MAX_CONV || n_conv % 2 || K < 1 || K > K_MAX || cin < 8 || cin % 8 ||
      r < 1 || n < 1 || l_in < 1 || L > 0x7fffffff || F < 1 || L % F || misaligned(x_prev) ||
      misaligned(skip) || misaligned(up_w) || misaligned(in_w) || misaligned(film) || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  NarrowArgs p{};
  p.x_prev = x_prev; p.skip = skip; p.up_w = up_w; p.up_b = up_b; p.in_w = in_w; p.in_b = in_b;
  p.film = film; p.out = out;
  int lookback = 0;
  for (int i = 0; i < n_conv; ++i) {
    if (dil[i] < 1 || (K - 1) * dil[i] > HALO_MAX || L <= (K - 1) * dil[i] || misaligned(conv_w[i]))
      return static_cast<int>(cudaErrorInvalidValue);
    p.conv_w[i] = conv_w[i];
    p.conv_b[i] = conv_b[i];
    p.dil[i] = dil[i];
    lookback += (K - 1) * dil[i];
  }
  p.n_conv = n_conv; p.K = K; p.L = (int)L; p.cin = cin; p.r = r; p.F = F; p.fr = (int)(L / F);
  p.film_ld = 2 * n_conv * C;
  p.lookback = lookback;
  p.T = ROWS_CAP - lookback - (r - 1);
  if (p.T < 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 16) return bf16 ? launch_narrow<true, 16>(p, n, s) : launch_narrow<false, 16>(p, n, s);
  if (C == 8) return bf16 ? launch_narrow<true, 8>(p, n, s) : launch_narrow<false, 8>(p, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
