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
// input, one write of its output).  Every product runs on the tensor cores
// as mma.sync with float32 accumulation: bf16 operands (m16n8k16) in bf16
// storage; 3xTF32 (m16n8k8) in float32 storage, each operand split as
// hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v - hi) and lo.hi + hi.lo + hi.hi
// accumulated (kernels/filter.py:product_3xtf32 emulates it).  A causal tap
// reads the operand rows shifted by j*d, d = 1, 2, 4 not a multiple of 8, so
// the A fragments come from ldmatrix (bf16) or 32-bit loads (TF32) at any row
// address of an operand tile held in shared memory.  The operand is
// gelu(x) * scale + shift, computed once per element as the block stages it
// and rounded there to bf16; in float32 the TF32 split happens there too
// (hi and lo planes) or, where two planes do not fit, as each warp loads a
// fragment.  The weights are read transposed, [out][(tap, in)].
//
//   filter_wide_kernel    one product or causal conv of a wide level: a block
//                         owns TM time rows x TN output channels (all of C at
//                         C = 256 and 64); its operand tile (+ (k-1)*d halo
//                         rows, reflected at sample 0) is staged once, the
//                         weights stream through a ring of cp.async stages
//                         (one barrier a KCH-column slice) or stay resident;
//                         bias, residual and a coalesced store in the
//                         epilogue.  A level is 8 launches: up conv (rows of
//                         [N*L_in, C_in] x [C_in, r*C] are the rows of
//                         [N, L, C]), 1x1, six convs.
//   filter_narrow_kernel  a whole narrow level (C = 8 or 16) in one launch:
//                         for each tile of T output samples plus the level's
//                         lookback (56 samples: 2*(k-1)*(1+2+4)) a block
//                         computes the up conv, the 1x1 and the six convs in
//                         shared memory and writes its T samples once.  Rows
//                         whose history the tile cut feed only rows it does
//                         not write; a tile whose rows start at sample 0
//                         reflects each conv's head in place, so no second
//                         pass is needed.

#include "common.cuh"

#include <cstdint>
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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

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

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// the 3xTF32 split: x ~ hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// 16 bytes global -> shared; src_bytes = 0 fills zeros
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
// One warp's share of a product from shared memory:
//   acc[WM][WN] (m16 x n8 tiles) += A . B over k-groups [kg0, kg1)
// A k-group is 8 consecutive rows of B, i.e. 8 input channels of one tap:
// k-group kg is tap kg / cg, channels 8 (kg % cg) ..; its A rows for the
// warp's output row m are plane rows arow + 16 mi + tap * d + (row in tile).
// B is held transposed, [n][k]: output channel nb + n is row nb + n of
// ``b`` (``ldb`` elements a row), and k-group kg is its columns
// 8 (kg - kg0) ...  bf16 takes k-groups in pairs (k16); an odd last group
// pairs with the zero block, and its B columns must hold zeros.  TF32:
// SPLIT reads hi and lo planes (a_lo), else float32 values split here.
// B fragments are 32-bit shared loads on this layout (ldmatrix on the B
// tile, in either orientation, faulted on the card with an illegal address
// at some tile shapes, where plain loads of the same addresses ran clean).
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

// ---------------------------------------------------------------------------
// Wide levels: one product or causal conv a launch
// ---------------------------------------------------------------------------

struct WideArgs {
  const void* a;      // operand source: [rows, cin] (products) or [n, L, cin] (convs)
  const void* a2;     // added to a before the product (the up conv's skip), or null
  const void* w;      // [N, taps * cin]: out x (tap, in)
  const void* bias;   // column c takes bias[c % nbias]
  const void* res;    // residual with out's layout, or null (may alias out)
  void* out;          // [rows, N] or [n, L, N]
  const void* film;   // [n, F, film_ld], this conv's scale at film_off, shift at film_off + cin
  int L, cin, N, taps, d, nbias, F, r, film_ld, film_off;   // r = L / F
  int tiles, total;   // row tiles a window, row tiles in all
};

// Grid (row tiles, column tiles).  A block stages its operand tile once:
// FILM: rows t0 - halo .. t0 + TM of window n as gelu(x) * scale + shift
// (row -s read for s < 0: the reflect pad); else rows of a (+ a2) rounded to
// the storage type.  bf16 keeps one plane; float32 keeps TF32 hi and lo
// planes (PLANES) or one float32 plane.  The weights' KCH-column slices
// stream through a ring of STAGES cp.async stages, one barrier a slice (a
// ring with a full and an empty mbarrier a stage in place of that barrier
// ran 3-9 % slower at C = 256 on the H100: PERF.md §6).
// Where every slice fits in the ring (C = 64: 320 weights a channel) the
// weights are loaded once and stay: the grid is then one wave of blocks
// that each walk over row tiles, with one barrier a tile.  Warp (wm, wn)
// owns rows 16 WM wm .. and columns 8 WN wn .. of the TM x TN tile.
template <bool BF16, int TM, int TN, int WARPS_M, int WARPS_N, int KCH, int STAGES, int PLANES, bool FILM>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32, 1)
filter_wide_kernel(const WideArgs p) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  constexpr bool SPLIT = !BF16 && PLANES;   // TF32 hi and lo planes, else one float32 plane
  constexpr int THREADS = WARPS_M * WARPS_N * 32;
  constexpr int WM = TM / (16 * WARPS_M), WN = TN / (8 * WARPS_N);
  constexpr int LDB = ld_of<BF16>(KCH);   // ring rows: output channels, KCH weights each
  constexpr int VEC = 16 / sizeof(T);
  static_assert(WM * 16 * WARPS_M == TM && WN * 8 * WARPS_N == TN && KCH % 16 == 0, "tile shape");
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int halo = (p.taps - 1) * p.d;
  const int n0 = blockIdx.y * TN;
  const int lda = ld_of<BF16>(p.cin);
  const int rows = TM + halo;
  const int krows = p.taps * p.cin, kg_total = krows / 8, cg = p.cin / 8;
  const int nchunks = (krows + KCH - 1) / KCH;
  const T* w = static_cast<const T*>(p.w);
  T* ring = reinterpret_cast<T*>(smem + ZERO_BYTES);
  T* plane = ring + (size_t)STAGES * TN * LDB;
  float* plane_lo = reinterpret_cast<float*>(plane) + (size_t)rows * lda;   // SPLIT only

  if (tid < ZERO_BYTES / 4) reinterpret_cast<float*>(smem)[tid] = 0.f;

  // weight slice c (columns c KCH .. of the [N, taps * cin] weights, rows
  // n0 .. n0 + TN) -> its stage; columns past the weights and rows past N
  // are zeros
  auto load_b = [&](int c) {
    if (c < nchunks) {
      T* dst = ring + (size_t)(c % STAGES) * TN * LDB;
      constexpr int PER_ROW = KCH / VEC;
      for (int e = tid; e < TN * PER_ROW; e += THREADS) {
        const int nn = e / PER_ROW, kv = (e - nn * PER_ROW) * VEC;
        const int k = c * KCH + kv;
        const bool ok = k < krows && n0 + nn < p.N;
        cp_async16(smem_u32(dst + nn * LDB + kv), ok ? w + (size_t)(n0 + nn) * krows + k : w, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  const bool resident = nchunks <= STAGES;
  for (int s = 0; s < (resident ? nchunks : STAGES - 1); ++s) load_b(s);
  const int wm = warp / WARPS_N, wn = warp - wm * WARPS_N;
  const int g = lane >> 2, t4 = lane & 3;
  const T* bias = static_cast<const T*>(p.bias);
  const T* res = static_cast<const T*>(p.res);
  T* out = static_cast<T*>(p.out);
  // the epilogue goes through shared memory (the operand plane, free once
  // the products are done) where the TM x TN tile fits there
  constexpr int LDO = ld_of<BF16>(TN);
  const bool staged_out =
      (size_t)TM * LDO * sizeof(T) <= (size_t)rows * lda * (BF16 ? 2 : PLANES ? 8 : 4);

  for (int tile = blockIdx.x; tile < p.total; tile += gridDim.x) {
  const int n = tile / p.tiles;
  const int t0 = (tile - n * p.tiles) * TM;
  if (tile != (int)blockIdx.x) __syncthreads();   // the last tile's products are done with the plane

  // the operand tile, transformed once per element; UNR tasks (8 values of a
  // row) a thread put their global loads in flight together
  const T* src = static_cast<const T*>(p.a);
  const T* src2 = static_cast<const T*>(p.a2);
  const T* film = static_cast<const T*>(p.film) + (size_t)n * p.F * p.film_ld + p.film_off;
  const int vpr = p.cin / 8, tasks = rows * vpr;
  constexpr int UNR = 2;   // (4 spilled registers at C = 64 and gained nothing measurable)
  for (int e0 = tid; e0 < tasks; e0 += UNR * THREADS) {
    Raw8<T> rx[UNR], rs[UNR][2], rh[UNR][2];
    float wl[UNR], wh[UNR];
    bool valid[UNR];
#pragma unroll
    for (int k = 0; k < UNR; ++k) {
      const int e = e0 + k * THREADS;
      const int i = e / vpr, c = (e - i * vpr) * 8;
      if (FILM) {
        const int s = t0 - halo + i;
        valid[k] = e < tasks && s < p.L;
        if (valid[k]) {
          const int sr = s < 0 ? -s : s;   // the reflect pad
          rx[k] = ldg8(src + ((size_t)n * p.L + sr) * p.cin + c);
          const Taps2 tp = film_taps(sr, p.r, p.F);
          wl[k] = tp.wl;
          wh[k] = tp.wh;
          rs[k][0] = ldg8(film + (size_t)tp.lo * p.film_ld + c);
          rs[k][1] = ldg8(film + (size_t)tp.hi * p.film_ld + c);
          rh[k][0] = ldg8(film + (size_t)tp.lo * p.film_ld + p.cin + c);
          rh[k][1] = ldg8(film + (size_t)tp.hi * p.film_ld + p.cin + c);
        }
      } else {
        const long long row = (long long)t0 + i;
        valid[k] = e < tasks && row < p.L;
        if (valid[k]) {
          rx[k] = ldg8(src + (size_t)row * p.cin + c);
          if (src2 != nullptr) rs[k][0] = ldg8(src2 + (size_t)row * p.cin + c);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < UNR; ++k) {
      const int e = e0 + k * THREADS;
      if (e >= tasks) break;
      const int i = e / vpr, c = (e - i * vpr) * 8;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
      if (valid[k]) {
        unpack8(rx[k], v);
        if (FILM) {
          float s0[8], s1[8], h0[8], h1[8];
          unpack8(rs[k][0], s0); unpack8(rs[k][1], s1);
          unpack8(rh[k][0], h0); unpack8(rh[k][1], h1);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = gelu_erf(v[j]) * (s0[j] * wl[k] + s1[j] * wh[k]) + (h0[j] * wl[k] + h1[j] * wh[k]);
        } else if (src2 != nullptr) {
          float u[8];
          unpack8(rs[k][0], u);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = round_to<T>(v[j] + u[j]);
        }
      }
      if (!SPLIT) {
        store8(plane + (size_t)i * lda + c, v);   // bf16: rounds
      } else {
        float hi[8], lo[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t h, l;
          split_tf32(v[j], h, l);
          hi[j] = __uint_as_float(h);
          lo[j] = __uint_as_float(l);
        }
        store8(reinterpret_cast<float*>(plane) + (size_t)i * lda + c, hi);
        store8(plane_lo + (size_t)i * lda + c, lo);
      }
    }
  }

  float acc[WM][WN][4];
#pragma unroll
  for (int mi = 0; mi < WM; ++mi)
#pragma unroll
    for (int ni = 0; ni < WN; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    if (resident) {
      if (c == 0) {
        if (tile == (int)blockIdx.x) cp_async_wait<0>();
        __syncthreads();   // the operand tile (and, the first time, the weights) are in place
      }
    } else {
      cp_async_wait<STAGES - 2>();
      __syncthreads();   // slice c landed; every warp is done with slice c - 1's stage
      load_b(c + STAGES - 1);
    }
    const int kg0 = c * (KCH / 8);
    warp_mma<BF16, SPLIT, WM, WN>(acc, plane, plane_lo, lda, 16 * WM * wm, p.d, cg, kg0, kg0 + KCH / 8,
                                 kg_total, ring + (size_t)(c % STAGES) * TN * LDB, LDB, 8 * WN * wn,
                                 smem);
  }

  // epilogue: + bias, rounded to the storage type; + residual (rounded again,
  // as the plain version and the JAX kernel round)
  float bv[WN][2];
#pragma unroll
  for (int ni = 0; ni < WN; ++ni) {
    const int col = n0 + 8 * (WN * wn + ni) + 2 * t4;
    bv[ni][0] = col < p.N ? to_f32(bias[col % p.nbias]) : 0.f;
    bv[ni][1] = col < p.N ? to_f32(bias[(col + 1) % p.nbias]) : 0.f;
  }
  // global row of tile row `row`, or -1 past the rows
  auto out_row = [&](int row) -> long long {
    const long long t = (long long)t0 + row;
    if (t >= p.L) return -1;
    return FILM ? (long long)n * p.L + t : t;
  };
  if (staged_out) {
    T* ot = plane;   // [TM][LDO]
    __syncthreads();   // every warp is done with the plane
#pragma unroll
    for (int mi = 0; mi < WM; ++mi)
#pragma unroll
      for (int ni = 0; ni < WN; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store2(ot + (16 * (WM * wm + mi) + g + 8 * h) * LDO + 8 * (WN * wn + ni) + 2 * t4,
                 acc[mi][ni][2 * h] + bv[ni][0], acc[mi][ni][2 * h + 1] + bv[ni][1]);
    __syncthreads();
    constexpr int VPR = TN / 8;
    for (int e = tid; e < TM * VPR; e += THREADS) {
      const int row = e / VPR, c = (e - row * VPR) * 8;
      const long long orow = out_row(row);
      if (orow < 0 || n0 + c >= p.N) continue;
      const size_t o = (size_t)orow * p.N + n0 + c;
      float v[8];
      load8(ot + row * LDO + c, v);
      if (res != nullptr) {   // a plain load: res may alias out
        float u[8];
        load8(res + o, u);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] += u[j];
      }
      store8(out + o, v);
    }
  } else {
#pragma unroll
    for (int mi = 0; mi < WM; ++mi)
#pragma unroll
      for (int ni = 0; ni < WN; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n0 + 8 * (WN * wn + ni) + 2 * t4;
          const long long orow = out_row(16 * (WM * wm + mi) + g + 8 * h);
          if (col >= p.N || orow < 0) continue;
          const size_t o = (size_t)orow * p.N + col;
          float v0 = round_to<T>(acc[mi][ni][2 * h] + bv[ni][0]);
          float v1 = round_to<T>(acc[mi][ni][2 * h + 1] + bv[ni][1]);
          if (res != nullptr) {
            float r0, r1;
            load2(res + o, r0, r1);
            v0 += r0;
            v1 += r1;
          }
          store2(out + o, v0, v1);
        }
  }
  }
}

template <bool BF16, typename S, bool FILM>
int launch_wide(WideArgs p, int n, cudaStream_t stream) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  constexpr int TM = S::TM, TN = S::TN, WARPS_M = S::WARPS_M, WARPS_N = S::WARPS_N, KCH = S::KCH,
                STAGES = S::STAGES, PLANES = S::PLANES;
  auto kernel = filter_wide_kernel<BF16, TM, TN, WARPS_M, WARPS_N, KCH, STAGES, PLANES, FILM>;
  const int halo = (p.taps - 1) * p.d;
  const int lda = ld_of<BF16>(p.cin);
  const size_t smem = ZERO_BYTES + (size_t)STAGES * TN * ld_of<BF16>(KCH) * sizeof(T) +
                      (size_t)(TM + halo) * lda * (BF16 ? 2 : PLANES ? 8 : 4);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.tiles = (p.L + TM - 1) / TM;
  if ((long long)n * p.tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  p.total = n * p.tiles;
  int blocks = p.total;
  if ((p.taps * p.cin + KCH - 1) / KCH <= STAGES) {   // resident weights: one wave of blocks
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS_M * WARPS_N * 32, smem);
    blocks = min(blocks, max(1, sms * per_sm));
  }
  dim3 grid((unsigned)blocks, (p.N + TN - 1) / TN);
  kernel<<<grid, WARPS_M * WARPS_N * 32, smem, stream>>>(p);
  RETURN_LAUNCH_STATUS();
}

// Tile shapes (TM, TN, WARPS_M, WARPS_N, KCH, STAGES, PLANES): TN = 256 where
// N is a multiple of 256 (C = 256; the up conv at r * C = 512 and 2560),
// else TN = 64 with masked columns.  128-row operand tiles; bf16 warps of 64
// rows, so that each B fragment feeds 4 m16 tiles.  float32 at TN = 256
// keeps one float32 plane and splits A as it loads fragments (4 warps split
// each element): TF32 hi/lo planes of 128 rows x 256 channels do not fit
// beside the ring, and 64-row tiles stream the weights twice as often.  At
// TN = 64 (C = 64) the ring holds all 320 weights a channel (resident), and
// float32 keeps hi/lo planes where they fit (C_in <= 128).  To try another
// shape, edit these and rerun chip_smoke.py (phase 2 times every level).
template <int TM_, int TN_, int WARPS_M_, int WARPS_N_, int KCH_, int STAGES_, int PLANES_>
struct Tile {
  static constexpr int TM = TM_, TN = TN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, KCH = KCH_,
                       STAGES = STAGES_, PLANES = PLANES_;
};
using FILTER_BF16_N256 = Tile<128, 256, 2, 4, 64, 3, 0>;
using FILTER_BF16_N64 = Tile<128, 64, 2, 2, 64, 5, 0>;
using FILTER_F32_N256 = Tile<128, 256, 2, 4, 16, 3, 0>;
using FILTER_F32_N64 = Tile<128, 64, 4, 2, 32, 10, 1>;
using FILTER_F32_N64_WIDE_CIN = Tile<64, 64, 4, 2, 32, 3, 1>;

template <bool BF16, bool FILM>
int wide_dispatch(const WideArgs& p, int n, cudaStream_t s) {
  if (p.N % 256 == 0) {
    if constexpr (BF16) return launch_wide<true, FILTER_BF16_N256, FILM>(p, n, s);
    else return launch_wide<false, FILTER_F32_N256, FILM>(p, n, s);
  }
  if constexpr (BF16) {
    return launch_wide<true, FILTER_BF16_N64, FILM>(p, n, s);
  } else {
    if (p.cin <= 128) return launch_wide<false, FILTER_F32_N64, FILM>(p, n, s);
    return launch_wide<false, FILTER_F32_N64_WIDE_CIN, FILM>(p, n, s);
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

}  // namespace

// One product (film == null) or causal conv (film != null) of a wide level.
// Products: a (+ a2) [L, cin] x w [cin, N] + bias[col % nbias] -> out [L, N]
// (n = 1).  Convs: gelu/FiLM of a [n, L, cin], causal taps k = taps at
// dilation d, w [taps * cin, N], + bias (+ res) -> out [n, L, N]; film
// [n, F, film_ld] with this conv's scale at column film_off and its shift at
// film_off + cin, at r samples a frame (L == F * r).  bf16 storage when bf16 != 0, else float32.
// cin, N multiples of 8; every pointer 16-byte aligned.
extern "C" int filter_wide(const void* a, const void* a2, const void* w, const void* bias,
                           const void* res, void* out, const void* film, int n, int L, int cin,
                           int N, int taps, int d, int nbias, int F, int r, int film_ld,
                           int film_off, int bf16, void* stream) {
  if (cin < 8 || cin % 8 || N < 8 || N % 8 || taps < 1 || taps > K_MAX || d < 0 ||
      (taps - 1) * d > HALO_MAX || nbias < 1 || n < 1 || L < 1 || misaligned(a) ||
      misaligned(a2) || misaligned(w) || misaligned(out) || misaligned(film))
    return static_cast<int>(cudaErrorInvalidValue);
  if (film != nullptr && (L <= (taps - 1) * d || (long long)F * r != L || film_ld % 8 || film_off % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WideArgs p{a, a2, w, bias, res, out, film, L, cin, N, taps, d, nbias, F, r, film_ld, film_off, 0, 0};
  if (bf16) return film ? wide_dispatch<true, true>(p, n, s) : wide_dispatch<true, false>(p, 1, s);
  return film ? wide_dispatch<false, true>(p, n, s) : wide_dispatch<false, false>(p, 1, s);
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
