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
//   filter_narrow_kernel  a whole narrow level (C = 8 or 16) in one launch,
//                         after one filter_narrow_weights_kernel launch that
//                         writes the level's weights in the layout wgmma
//                         reads and its biases as float32 (below).
//
// The narrow kernel.  Per output sample the level does ~9 000 MACs at C = 16
// but reads 64 input values and writes 16, so the tensor cores are not the
// bound: the bytes are (0.056 ms bf16 at the bench shape), and beside them
// the gelu/FiLM pass of every conv (six passes of C values a sample, on the
// CUDA cores).  The design keeps every intermediate on chip and overlaps
// the copies, the products and that pass:
//   - Tiles: a tile writes T samples and computes T + A rows before them, A
//     >= the convs' lookback (56 at k = 5, dilations 1, 1, 2, 2, 4, 4):
//     rows whose history the tile cut feed only rows it does not write; the
//     tile at sample 0 reflects each conv's head in place.  The plan
//     (kernels/filter.py:narrow_plan) sizes T per shape: large at the bench
//     shape (the lookback under 10 % in bf16), narrow at the streaming hop
//     so that the grid covers at least 64 SMs.
//   - Tile owners: a block holds 1-2 tile owners (each with its buffers
//     and its own named barrier, bar.sync 1 + i over its threads, 8 a
//     tile) of 1-4 warpgroups that split the tile's 64-row subtiles, up to
//     4 warpgroups a block (2 in float32 at C = 16: registers); the
//     persistent grid gives each owner its own sequence of tiles, so one
//     owner's barrier waits overlap the other's work.
//   - Copies by TMA: the level's weights (one bulk copy a block, resident);
//     x_prev and skip in chunks of 64 input rows (3-D tensor maps, swizzled
//     by the row's width) into a ring of 2-4 stages with full and empty
//     mbarriers (each stage read by one warpgroup), the next chunks
//     requested while the current tile computes;
//     the tile's FiLM frames (one box); the output by TMA store from dense
//     staging rows, issued at the next tile's start.
//   - Products on wgmma (m64nCk16 bf16, m64nCk8 3xTF32), B (weights,
//     K-major, 32-byte slabs with the 32-byte swizzle) by descriptor, A from
//     registers: ldmatrix at any row of a 16-byte-chunk-swizzled operand
//     buffer (the dilated taps shift rows by 1-4, which a swizzled
//     descriptor cannot start on); the up conv's A is x_prev + skip, added
//     and rounded in registers, one wgmma per phase j of the rate.  A conv
//     runs a warpgroup's 64-row subtiles in turn; in bf16 subtile m + 1's
//     products are in flight while subtile m's epilogue runs (TF32's hi and
//     lo fragments and the epilogue's registers together do not fit: there
//     the other warpgroups of the SM overlap the epilogues).
//   - The epilogue works on the accumulators in registers: bias, rounding,
//     the residual (the level state X, which each thread keeps in shared
//     memory in its own fragment order), then gelu (gelu_fast) and FiLM for
//     the next conv (each row's frame and weight, and a float32 table of
//     scale, shift and their steps to the next frame, computed once a
//     tile), written once into the other operand buffer.
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
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block may take

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

// 8 consecutive values (16 bytes of bf16, 32 of float32) held raw
template <typename T>
struct Raw8 {
  uint4 u[sizeof(T) / 2];
};
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
// The narrow kernel (C = 8 or 16; see the header)
// ---------------------------------------------------------------------------

constexpr int MAX_CONV = 8;
constexpr int HOFF = HALO_MAX;         // operand rows above a tile's first row (a conv's reflected head)
// warpgroups a block: 4 (128 registers a thread), 2 in float32 at C = 16
// (its TF32 fragments take more)
template <bool BF16, int C> __host__ __device__ constexpr int narrow_max_wgs() { return BF16 || C == 8 ? 4 : 2; }
constexpr int NARROW_MAX_STAGES = 4;   // input chunks in flight a tile owner
constexpr int UP_ROWS = 64;            // input rows an up-conv subtile (one wgmma M)
constexpr int KG = 8;                  // k-steps a group of products, at most: one register set of A fragments
constexpr int SLAB = 32;               // bytes of K a weight slab row: one k-step, 32-byte swizzle
constexpr int OUT_BOX = 64;            // rows a TMA store box

int align_to(long long b, int a) { return (int)((b + a - 1) / a * a); }

// The narrow level's shared memory and weight blob, from its shape and plan
// (kernels/filter.py:narrow_layout mirrors it; the card test
// test_narrow_layout_formula_on_card holds the two to each other).
//   head (1024 bytes): mbarriers (the weights'; a warpgroup's ring full and
//     empty and its FiLM box's), 256 bytes of zeros (A rows of a padded
//     k-group);
//   the weight blob (filter_narrow_weights), 1024-aligned;
//   per tile owner (1 or 2 a block): the input ring (stages x [x_prev box, skip box], each
//     UP_ROWS rows of cin values, TMA-swizzled by the row's width), the
//     operand buffers G0 and G1 ((HOFF + 64 ms) rows of C values, rows
//     16-byte-chunk swizzled; G1 is also the tile's output staging, dense
//     rows), X (the level state a thread holds, in its fragment order; the
//     next tile's FiLM frames land there first), RT (each row's FiLM
//     frame and weight) and the FiLM table (frame, conv, channel: scale,
//     its step to the next frame, shift, its step).
struct NarrowLayout {
  int es, rb, ms, us, fbox, bw, nbx, swz;   // bytes a value and a G row; subtiles; up subtiles; FiLM frames; input box
  int stage, g, x, rt, tab, wg;             // bytes of each per-warpgroup buffer, and of a warpgroup's region
  int w_in, w_conv, conv_bytes, w_lo, b_off, blob, w_bytes;   // blob offsets (the up conv's matrix at 0)
  long long smem;
};

NarrowLayout narrow_layout(int n_conv, int K, int cin, int C, int r, int fr, int rows, int owners, int stages,
                           bool bf16) {
  NarrowLayout l{};
  l.es = bf16 ? 2 : 4;
  l.rb = C * l.es;
  l.ms = (rows + 63) / 64;
  l.us = (rows + UP_ROWS * r - 1) / (UP_ROWS * r);
  l.fbox = (rows - 1 + fr - 1) / fr + 2;
  const int rowbytes = cin * l.es;
  l.swz = (rowbytes == 32 || rowbytes == 64 || rowbytes == 128) ? rowbytes : (rowbytes % 128 == 0 ? 128 : 0);
  l.bw = l.swz ? std::min(rowbytes, 128) : rowbytes;
  l.nbx = rowbytes / l.bw;
  l.stage = align_to(2LL * l.nbx * UP_ROWS * l.bw, 1024);
  l.g = align_to((long long)(HOFF + 64 * l.ms) * l.rb, 128);
  l.x = align_to(std::max(64LL * l.ms * C * l.es, (long long)l.fbox * 2 * n_conv * C * l.es), 128);
  l.rt = align_to(64LL * l.ms * 8, 128);
  l.tab = align_to((long long)l.fbox * n_conv * C * 16, 128);
  l.wg = align_to((long long)stages * l.stage + 2LL * l.g + l.x + l.rt + l.tab, 1024);
  auto slabs = [&](int kdim) { return (kdim * l.es + SLAB - 1) / SLAB; };
  l.w_in = r * C * SLAB * slabs(cin);
  l.w_conv = l.w_in + C * SLAB * slabs(C);
  l.conv_bytes = C * SLAB * slabs(K * C);
  const int hi = l.w_conv + n_conv * l.conv_bytes;
  l.w_lo = bf16 ? 0 : hi;
  l.b_off = bf16 ? hi : 2 * hi;
  l.blob = l.b_off + (2 + n_conv) * C * 4;
  l.w_bytes = align_to(l.blob, 1024);
  l.smem = 1024LL + 1024 + l.w_bytes + (long long)owners * l.wg;
  return l;
}

struct NarrowArgs {
  NarrowLayout ly;
  const void* blob;          // the prepared weights and biases
  int dil[MAX_CONV];
  int n_conv, K, L, cin, r, F, fr, fbox;    // fbox: FiLM frames a tile's box (<= F)
  int T, A, tiles_w, tiles, stages, ob;     // samples a tile writes, rows before them; a store box's rows
  int wpt;                                  // warpgroups a tile
};

// A thread's A fragments of one group of k-steps (TF32: hi, and lo in l)
template <bool BF16>
struct Frag {
  uint32_t a[KG][4];
  uint32_t l[BF16 ? 1 : KG][4];
};

// The persistent grid: a block holds `owners` tile owners of `wpt`
// warpgroups each (1 x 2 where two tiles' buffers do not fit, else 2 x 1);
// owner o = block * owners + i takes tiles o, o + owners * gridDim.x, ...;
// its warpgroups split a tile's 64-row subtiles (subtile m to warpgroup m %
// wpt).  Tile j of window n writes samples [j T, (j + 1) T) and computes
// rows [b0, b0 + 64 ms), b0 = max(0, j T - A): the lookback rows feed only
// rows it does not write; a tile at b0 = 0 reflects each conv's head in
// place.  Per tile (the owner's named barrier 1 + i, 128 wpt threads,
// between the steps):
//   (A) the previous tile's output leaves by TMA store; this tile's FiLM
//       box is requested; RT;
//   the up conv, chunk by chunk from the ring (x_prev + skip rounded in
//   registers, one wgmma a phase j of the rate: rows [j C, (j + 1) C) of its
//   weight matrix), into G0; the next chunks are requested as each is read;
//   the FiLM table from the box;
//   (B) the 1x1: G0 -> X (rounded) and G1 (conv 0's operand);
//   (C) conv i: G[(i + 1) & 1] -> G[i & 1] (conv i + 1's operand; X on the
//       second conv of a block), the last conv -> the staging rows.
// Each conv runs a warpgroup's subtiles in turn: subtile m + wpt's products
// are issued before subtile m's epilogue (gelu/FiLM, rounding, residual), so
// the tensor cores work while the epilogue runs.
template <bool BF16, int C>
__global__ void __launch_bounds__(128 * narrow_max_wgs<BF16, C>(), 1)
filter_narrow_kernel(const __grid_constant__ CUtensorMap m_x, const __grid_constant__ CUtensorMap m_s,
                     const __grid_constant__ CUtensorMap m_f, const __grid_constant__ CUtensorMap m_o1,
                     const __grid_constant__ CUtensorMap m_o2, const NarrowArgs p) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  using T2 = typename std::conditional<BF16, __nv_bfloat162, float2>::type;
  constexpr int ES = sizeof(T), RB = C * ES, RBM = RB / 16 - 1, NP = C / 4, J = C / 8;
  // k-steps a group: the up conv's (all of the decoder's levels': 64 input
  // channels at C = 16, 16 at C = 8; other widths take more groups); the
  // 1x1's (all of them); a conv's (all of a k = 5 conv's, in float32 at
  // C = 16 half of them)
  constexpr int NK_UP = (C == 16 ? 4 : 1) * (BF16 ? 1 : 2), NK_IN = BF16 ? 1 : C / 8;
  constexpr int NK_CONV = BF16 && C == 8 ? 3 : 5;
  static_assert(NK_UP <= KG && NK_IN <= KG && NK_CONV <= KG, "a group's fragments");
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw_addr = smem_u32(smem_raw);
  const unsigned base = (raw_addr + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw_addr);
  const NarrowLayout& ly = p.ly;
  const int wpt = p.wpt, owners = (int)blockDim.x / (128 * wpt), team = 128 * wpt;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int own = wg / wpt, sub = wg - own * wpt, tt = tid - own * team;   // tt: thread of the team
  const bool lead = tt == 0;
  const unsigned wbar = base, full = base + 64 + 128 * own, empty = full + 32, fbar = full + 64;
  const unsigned zeros = base + 768;
  const unsigned wsm = base + 1024;
  const float* bias_s = reinterpret_cast<const float*>(smem + 1024 + ly.b_off);   // up, 1x1, convs: C each
  unsigned char* region = smem + 1024 + ly.w_bytes + own * ly.wg;
  const unsigned ring = smem_u32(region);
  unsigned char* gbuf[2] = {region + p.stages * ly.stage, region + p.stages * ly.stage + ly.g};
  unsigned char* xreg = gbuf[1] + ly.g;
  T2* X = reinterpret_cast<T2*>(xreg);
  int2* RT = reinterpret_cast<int2*>(xreg + ly.x);
  float4* TAB = reinterpret_cast<float4*>(xreg + ly.x + ly.rt);

  if (tid == 0) {
    mbar_init(wbar, 1);
    for (int o = 0; o < owners; ++o) {
      const unsigned f = base + 64 + 128 * o;
      for (int s = 0; s < p.stages; ++s) {
        mbar_init(f + 8 * s, 1);
        mbar_init(f + 32 + 8 * s, 4);   // a stage is free when each warp of the warpgroup that read it has
      }
      mbar_init(f + 64, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 64) reinterpret_cast<float*>(smem + 768)[tid] = 0.f;
  __syncthreads();
  if (tid == 0) {   // the weights, once a block
    mbar_expect_tx(wbar, ly.blob);
    bulk_load(wsm, p.blob, ly.blob, wbar);
  }

  const int gw = blockIdx.x * owners + own, nw = gridDim.x * owners;
  if (gw >= p.tiles) return;   // (never owner 0: the grid has no block without tiles)
  const int my_tiles = (p.tiles - 1 - gw) / nw + 1, chunks = my_tiles * ly.us;
  struct Tile {
    int n, t0, b0;
  };
  auto tile_of = [&](int k) {
    const int tile = gw + k * nw, n = tile / p.tiles_w, t0 = (tile - n * p.tiles_w) * p.T;
    return Tile{n, t0, max(0, t0 - p.A)};
  };
  // input chunk c (tile c / us, up subtile c % us) -> ring stage c % stages
  auto fetch_chunk = [&](int c) {
    const Tile t = tile_of(c / ly.us);
    const int q = t.b0 / p.r + UP_ROWS * (c % ly.us), s = c % p.stages;
    const unsigned bar = full + 8 * s, dst = ring + s * ly.stage, box = UP_ROWS * ly.bw;
    mbar_expect_tx(bar, 2 * ly.nbx * box);
    for (int b = 0; b < ly.nbx; ++b) {
      tma_load_3d(dst + b * box, m_x, b * ly.bw / ES, q, t.n, bar);
      tma_load_3d(dst + (ly.nbx + b) * box, m_s, b * ly.bw / ES, q, t.n, bar);
    }
  };
  // row t's FiLM mix (align_corners=False, fr samples a frame): frame f
  // plus lam times the step to frame f + 1
  auto film_row = [&](int t, int& f, float& lam) {
    if (t >= p.L) {
      f = p.F - 1;
      lam = 0.f;
      return;
    }
    const int q = t / p.fr;
    const float u = ((float)(t - q * p.fr) + 0.5f) / (float)p.fr - 0.5f;
    if (u >= 0.f) {
      f = q;
      lam = u;
    } else {
      f = max(q - 1, 0);
      lam = q > 0 ? 1.f + u : 0.f;
    }
  };
  auto film_first = [&](int b0) {
    int f;
    float lam;
    film_row(b0, f, lam);
    return max(0, min(f, p.F - p.fbox));
  };
  // the tile's staging rows [t0 - b0, t0 - b0 + T) -> out by TMA (rows past L are not written)
  auto store_tile = [&](int k) {
    const Tile t = tile_of(k);
    const unsigned src = smem_u32(gbuf[1]) + (t.t0 - t.b0) * RB;
    int o = 0;
    for (; o + p.ob <= p.T; o += p.ob) tma_store_3d(m_o1, 0, t.t0 + o, t.n, src + o * RB);
    if (o < p.T) tma_store_3d(m_o2, 0, t.t0 + o, t.n, src + o * RB);
    bulk_commit();
  };
  // byte offset of channel c of row `row` in an operand buffer (16-byte
  // chunks swizzled by the row, so that 8 consecutive rows of a chunk lie
  // in distinct banks)
  auto g_off = [&](int row, int c) {
    const int byte = c * ES;
    return row * RB + ((((byte >> 4) ^ ((row * RB >> 7) & RBM)) << 4) | (byte & 15));
  };
  auto pack = [&](float v0, float v1) {
    if constexpr (BF16) return __floats2bfloat162_rn(v0, v1);
    else return make_float2(v0, v1);
  };
  auto unpack = [&](const T2 v, float& a, float& b) {
    if constexpr (BF16) {
      const float2 f = __bfloat1622float2(v);
      a = f.x;
      b = f.y;
    } else {
      a = v.x;
      b = v.y;
    }
  };

  // The products: A fragments of k-steps [ks0, ks0 + NK) of a subtile
  // (ldmatrix at the rows each tap reads; past the last k-step, zeros),
  // then the wgmmas against the weight slabs (slab ks of a matrix of
  // `nrows` rows at wm + ks nrows SLAB).  NK is a compile-time count
  // (std::integral_constant), so that every wgmma of a group issues
  // unconditionally and ptxas keeps them in flight together.
  auto load_conv = [&](auto nk, const unsigned char* gsrc, int m, int ks0, int nks, int taps, int d,
                       Frag<BF16>& f) {
    constexpr int NK = decltype(nk)::value;
    const unsigned gs = smem_u32(gsrc);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int ks = ks0 + kk;
      const int k0 = BF16 ? 16 * ks + 8 * (lane >> 4) : 8 * ks;
      const int tap = k0 / C, c0 = k0 - tap * C;
      unsigned addr = zeros;
      if (ks < nks && tap < taps) {
        const int row = HOFF + 64 * m + 16 * warp + (lane & 15) - (taps - 1 - tap) * d;
        const int ch = BF16 ? c0 / 8 : c0 / 4 + (lane >> 4);
        addr = gs + row * RB + ((ch ^ ((row * RB >> 7) & RBM)) << 4);
      }
      ldsm_x4(f.a[kk], addr);
      if constexpr (!BF16) {
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(f.a[kk][e]), f.a[kk][e], f.l[kk][e]);
      }
    }
  };
  auto issue = [&](auto nk, unsigned wm, int nrows, int ks0, int nks, Frag<BF16>& f, float (&acc)[C / 2]) {
    constexpr int NK = decltype(nk)::value;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int ks = ks0 + kk;
      const unsigned b = wm + (ks < nks ? ks : 0) * nrows * SLAB;   // zero A past the last k-step
      if constexpr (BF16) {
        wgmma_rs_bf16<C>(acc, f.a[kk], desc_sw32(b), ks != 0);
      } else {
        const uint64_t dh = desc_sw32(b), dl = desc_sw32(b + ly.w_lo);
        wgmma_rs_tf32<C>(acc, f.l[kk], dh, ks != 0);
        wgmma_rs_tf32<C>(acc, f.a[kk], dl);
        wgmma_rs_tf32<C>(acc, f.a[kk], dh);
      }
    }
    wgmma_commit();
  };
  // The epilogue of subtile m: this thread's values (rows 64 m + 16 warp +
  // g + 8 h, channels 8 jj + 2 t4 + e) + bias, rounded; then by MODE (a
  // compile-time std::integral_constant, so that no branch on it sits
  // between a wgmma and its wait):
  //   0 (the 1x1)              -> X; conv fc's operand into gb
  //   1 (a block's first conv) -> conv fc's operand into gb
  //   2 (a block's second)     -> + X, rounded again -> X; conv fc's operand
  //   3 (the last conv)        -> + X, rounded again -> the level's output
  //                               in the dense staging rows of gb.
  // An operand is gelu(v) * scale + shift, reflected into the head on the
  // tile at sample 0.  Every load comes first, so that a subtile's loads are
  // in flight together.
  auto finish = [&](auto mode, int m, const float (&ep)[C / 2], const float (&bv)[C / 4], int fc,
                    unsigned char* gb, bool head) {
    constexpr int MODE = decltype(mode)::value;
    constexpr bool ADD_X = MODE >= 2, KEEP_X = MODE == 0 || MODE == 2, FILM = MODE != 3;
    int rows[2];
    int2 rt[2];
    T2 xo[J][2];
    float4 tb[J][2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) rows[h] = 64 * m + 16 * warp + g + 8 * h;
    if constexpr (FILM) {
#pragma unroll
      for (int h = 0; h < 2; ++h) rt[h] = RT[rows[h]];
    }
    if constexpr (ADD_X) {
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) xo[jj][h] = X[(m * NP + 2 * jj + h) * 128 + wt];
    }
    if constexpr (FILM) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4* tr = TAB + (rt[h].x * p.n_conv + fc) * C + 2 * t4;
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          tb[jj][h][0] = tr[8 * jj];
          tb[jj][h][1] = tr[8 * jj + 1];
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < J; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cc = 8 * jj + 2 * t4;
        float v0 = round_to<T>(ep[4 * jj + 2 * h] + bv[2 * jj]);
        float v1 = round_to<T>(ep[4 * jj + 2 * h + 1] + bv[2 * jj + 1]);
        if constexpr (ADD_X) {   // + the block's input, rounded again
          float x0, x1;
          unpack(xo[jj][h], x0, x1);
          v0 = round_to<T>(v0 + x0);
          v1 = round_to<T>(v1 + x1);
        }
        if constexpr (KEEP_X) X[(m * NP + 2 * jj + h) * 128 + wt] = pack(v0, v1);
        if constexpr (FILM) {
          const float lam = __int_as_float(rt[h].y);
          const float4 f0 = tb[jj][h][0], f1 = tb[jj][h][1];
          const T2 a = pack(gelu_fast(v0) * fmaf(lam, f0.y, f0.x) + fmaf(lam, f0.w, f0.z),
                            gelu_fast(v1) * fmaf(lam, f1.y, f1.x) + fmaf(lam, f1.w, f1.z));
          *reinterpret_cast<T2*>(gb + g_off(HOFF + rows[h], cc)) = a;
          if (head && rows[h] >= 1 && rows[h] <= HOFF)
            *reinterpret_cast<T2*>(gb + g_off(HOFF - rows[h], cc)) = a;
        } else {
          *reinterpret_cast<T2*>(gb + rows[h] * RB + cc * ES) = pack(v0, v1);
        }
      }
  };
  // one product over this warpgroup's subtiles m = sub, sub + wpt, ... (the
  // plan gives every warpgroup one); the bias of this thread's channels in
  // registers.  bf16: subtile m + wpt's first group of k-steps in flight
  // while subtile m's epilogue runs.  TF32 keeps no products in flight
  // through an epilogue: its fragments (hi and lo) and the epilogue's
  // registers together would not fit, and ptxas would then serialise every
  // wgmma; the other warpgroups of the SM overlap its epilogues.
  auto product = [&](auto nk, auto mode, const unsigned char* gsrc, unsigned wm, int taps, int d, int nks,
                     int bias_off, int fc, unsigned char* gb, bool head) {
    constexpr int NK = decltype(nk)::value;
    Frag<BF16> f;
    float acc[C / 2], bv[C / 4];
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      bv[2 * jj] = bias_s[bias_off + 8 * jj + 2 * t4];
      bv[2 * jj + 1] = bias_s[bias_off + 8 * jj + 2 * t4 + 1];
    }
    const int groups = (nks + NK - 1) / NK;
    if constexpr (BF16) {
      float ep[C / 2];
      load_conv(nk, gsrc, sub, 0, nks, taps, d, f);
      issue(nk, wm, C, 0, nks, f, acc);
#pragma unroll 1
      for (int m = sub; m < ly.ms; m += wpt) {
#pragma unroll 1
        for (int q = 1; q < groups; ++q) {
          wgmma_wait<0>();
          load_conv(nk, gsrc, m, q * NK, nks, taps, d, f);
          issue(nk, wm, C, q * NK, nks, f, acc);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < C / 2; ++e) {
          ep[e] = acc[e];
          asm volatile("" : "+f"(ep[e]));   // the copy stays before the next products' fence
        }
        if (m + wpt < ly.ms) {
          load_conv(nk, gsrc, m + wpt, 0, nks, taps, d, f);
          issue(nk, wm, C, 0, nks, f, acc);
        }
        finish(mode, m, ep, bv, fc, gb, head);
      }
      wgmma_wait<0>();   // nothing in flight past the loop on any path (else ptxas serialises every wgmma)
    } else {
#pragma unroll 1
      for (int m = sub; m < ly.ms; m += wpt) {
#pragma unroll 1
        for (int q = 0; q < groups; ++q) {
          load_conv(nk, gsrc, m, q * NK, nks, taps, d, f);
          issue(nk, wm, C, q * NK, nks, f, acc);
          wgmma_wait<0>();
        }
        finish(mode, m, acc, bv, fc, gb, head);
      }
    }
  };

  if (lead)
    for (int c = 0; c < min(p.stages, chunks); ++c) fetch_chunk(c);
  mbar_wait(wbar, 0u);
  const int nks_up = BF16 ? (p.cin + 15) / 16 : p.cin / 8;
  const int nks_in = BF16 ? 1 : C / 8;
  const int nks_conv = BF16 ? (p.K * C + 15) / 16 : p.K * C / 8;
  const int up_rows = p.r * C;   // the up conv's weight rows
  const int film_ld = 2 * p.n_conv * C;
  const int bar_id = 1 + own;
#pragma unroll 1
  for (int k = 0; k < my_tiles; ++k) {
    const Tile tl = tile_of(k);
    const int fb = film_first(tl.b0);
    const bool head = tl.b0 == 0;
    named_barrier(bar_id, team);   // (A) the previous tile is done
    if (lead) {
      if (k > 0) store_tile(k - 1);
      fence_async_shared();
      mbar_expect_tx(fbar, p.fbox * film_ld * ES);
      tma_load_3d(smem_u32(xreg), m_f, 0, fb, tl.n, fbar);
    }
    for (int row = tt; row < 64 * ly.ms; row += team) {
      int f;
      float lam;
      film_row(tl.b0 + row, f, lam);
      RT[row] = make_int2(min(max(f - fb, 0), p.fbox - 1), __float_as_int(lam));
    }

    // the up conv: input rows q (this lane's ldmatrix row of the chunk)
    // -> samples q r + j of G0.  Chunk c to warpgroup c % wpt: with stages
    // a multiple of wpt, each stage has one consumer, which is never two
    // phases ahead of its full barrier (mbarrier parity waits alias there)
#pragma unroll 1
    for (int u = (sub - (k * ly.us) % wpt + wpt) % wpt; u < ly.us; u += wpt) {
      const int c = k * ly.us + u, s = c % p.stages;
      mbar_wait(full + 8 * s, (unsigned)((c / p.stages) & 1));
      const unsigned xs = ring + s * ly.stage, box = UP_ROWS * ly.bw;
      const int q = 16 * warp + (lane & 15), cpb = ly.bw / 16;
      const int sw = ly.swz ? ((q * ly.bw) >> 7) & (cpb - 1) : 0;
      Frag<BF16> f;
      auto load_up = [&](int ks0) {
#pragma unroll
        for (int kk = 0; kk < NK_UP; ++kk) {
          const int ks = ks0 + kk;
          const int k0 = BF16 ? 16 * ks + 8 * (lane >> 4) : 8 * ks;
          const int ch = BF16 ? k0 / 8 : k0 / 4 + (lane >> 4), b = ch / cpb;
          const unsigned off = b * box + q * ly.bw + (((ch - b * cpb) ^ sw) << 4);
          const bool in = ks < nks_up && k0 < p.cin;
          uint32_t xa[4], sa[4];
          ldsm_x4(xa, in ? xs + off : zeros);
          ldsm_x4(sa, in ? xs + ly.nbx * box + off : zeros);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (BF16) {
              float a0, a1, b0, b1;
              unpack(*reinterpret_cast<const __nv_bfloat162*>(&xa[e]), a0, a1);
              unpack(*reinterpret_cast<const __nv_bfloat162*>(&sa[e]), b0, b1);
              const __nv_bfloat162 v = __floats2bfloat162_rn(a0 + b0, a1 + b1);   // the sum, rounded
              f.a[kk][e] = *reinterpret_cast<const uint32_t*>(&v);
            } else {
              split_tf32(__uint_as_float(xa[e]) + __uint_as_float(sa[e]), f.a[kk][e], f.l[kk][e]);
            }
          }
        }
      };
      const int groups = (nks_up + NK_UP - 1) / NK_UP;
#pragma unroll 1
      for (int j = 0; j < p.r; ++j) {
        float acc[C / 2];
#pragma unroll 1
        for (int gq = 0; gq < groups; ++gq) {
          if (j == 0 || groups > 1) load_up(gq * NK_UP);
          issue(std::integral_constant<int, NK_UP>{}, wsm + j * C * SLAB, up_rows, gq * NK_UP, nks_up, f, acc);
          wgmma_wait<0>();
        }
#pragma unroll
        for (int jj = 0; jj < J; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = (UP_ROWS * u + 16 * warp + g + 8 * h) * p.r + j, cc = 8 * jj + 2 * t4;
            if (row < 64 * ly.ms)
              *reinterpret_cast<T2*>(gbuf[0] + g_off(HOFF + row, cc)) =
                  pack(round_to<T>(acc[4 * jj + 2 * h] + bias_s[cc]), round_to<T>(acc[4 * jj + 2 * h + 1] + bias_s[cc + 1]));
          }
      }
      // this warp has read the stage; the last warp's read lets the next chunk in
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if (wt == 0 && c + p.stages < chunks) {
        mbar_wait(empty + 8 * s, (unsigned)((c / p.stages) & 1));
        fence_async_shared();
        fetch_chunk(c + p.stages);
      }
    }

    // the FiLM table from the box in X
    mbar_wait(fbar, (unsigned)(k & 1));
    {
      const T* raw = reinterpret_cast<const T*>(xreg);
      for (int e = tt; e < p.fbox * p.n_conv * C; e += team) {
        const int fr = e / (p.n_conv * C), rem = e - fr * p.n_conv * C, ci = rem / C, cc = rem - ci * C;
        const T* at = raw + fr * film_ld + 2 * ci * C + cc;
        const float sc = to_f32(at[0]), sh = to_f32(at[C]);
        float ds = 0.f, dh = 0.f;
        if (fr + 1 < p.fbox) {
          ds = to_f32(at[film_ld]) - sc;
          dh = to_f32(at[film_ld + C]) - sh;
        }
        TAB[e] = make_float4(sc, ds, sh, dh);
      }
    }
    if (lead) bulk_wait_read<0>();   // the previous tile's staging rows (G1) are read out
    named_barrier(bar_id, team);     // (B)

    // the 1x1: G0 -> X (rounded) and conv 0's operand in G1
    using Mode0 = std::integral_constant<int, 0>;
    using Mode1 = std::integral_constant<int, 1>;
    using Mode2 = std::integral_constant<int, 2>;
    using Mode3 = std::integral_constant<int, 3>;
    using NkConv = std::integral_constant<int, NK_CONV>;
    product(std::integral_constant<int, NK_IN>{}, Mode0{}, gbuf[0], wsm + ly.w_in, 1, 0, nks_in, C, 0, gbuf[1],
            head);
    named_barrier(bar_id, team);   // (C)

    // the causal convs: conv ci reads G[(ci + 1) & 1] and writes G[ci & 1]
#pragma unroll 1
    for (int ci = 0; ci < p.n_conv; ++ci) {
      const unsigned char* src = gbuf[(ci + 1) & 1];
      const unsigned wm = wsm + ly.w_conv + ci * ly.conv_bytes;
      const int d = p.dil[ci], b = (2 + ci) * C;
      if (ci + 1 == p.n_conv) {
        product(NkConv{}, Mode3{}, src, wm, p.K, d, nks_conv, b, 0, gbuf[ci & 1], head);
      } else {
        if (ci & 1) product(NkConv{}, Mode2{}, src, wm, p.K, d, nks_conv, b, ci + 1, gbuf[ci & 1], head);
        else product(NkConv{}, Mode1{}, src, wm, p.K, d, nks_conv, b, ci + 1, gbuf[ci & 1], head);
        named_barrier(bar_id, team);
      }
    }
    fence_async_shared();   // the staging rows, before the TMA store reads them
  }
  named_barrier(bar_id, team);
  if (lead) {
    store_tile(my_tiles - 1);
    bulk_wait<0>();
  }
}

template <bool BF16, int C>
int launch_narrow(const CUtensorMap (&maps)[5], const NarrowArgs& p, int owners, int blocks, cudaStream_t stream) {
  auto kernel = filter_narrow_kernel<BF16, C>;
  const size_t smem = (size_t)p.ly.smem;
  int dev = 0;
  cudaGetDevice(&dev);
  static size_t smem_set[64] = {};   // the shared-memory limit raised once a card to the most any launch asks
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = smem;
  }
  kernel<<<blocks, 128 * owners * p.wpt, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], p);
  RETURN_LAUNCH_STATUS();
}

// The narrow level's weights and biases in the blob the kernel copies to
// shared memory whole: matrix j (the up conv [r C][cin], the 1x1 [C][C],
// conv i [C][K C]: [out][(tap, in)], K-major) as 32-byte slabs of K, each
// [rows][32 bytes] with the 32-byte swizzle (chunk h of row n at h ^ ((n >>
// 2) & 1)), the layout wgmma reads B in; float32 as TF32 hi, and the lo
// half after all the hi matrices; then every bias as float32.  One thread
// writes 16 bytes (one chunk of a row).
struct NarrowPrepArgs {
  const void* src[2 + MAX_CONV];
  const void* bias[2 + MAX_CONV];
  long long st[2 + MAX_CONV][3];   // element strides of the [taps, in, out] view: tap, in, out
  int taps[2 + MAX_CONV], cin[2 + MAX_CONV], rows[2 + MAX_CONV], off[2 + MAX_CONV], first[2 + MAX_CONV];
  int jobs, items, C, lo, b_off;
};

template <bool BF16>
__global__ void __launch_bounds__(256) filter_narrow_weights_kernel(const NarrowPrepArgs p, unsigned char* blob) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  constexpr int E = 16 / (int)sizeof(T);
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= p.items) {
    const int b = i - p.items;
    if (b < p.jobs * p.C)
      reinterpret_cast<float*>(blob + p.b_off)[b] = to_f32(static_cast<const T*>(p.bias[b / p.C])[b % p.C]);
    return;
  }
  int j = 0;
  while (j + 1 < p.jobs && i >= p.first[j + 1]) ++j;
  const int kk = p.taps[j] * p.cin[j], units = (kk * (int)sizeof(T) + SLAB - 1) / SLAB * 2;
  const int local = i - p.first[j], nr = local / units, q = local - nr * units;
  const T* src = static_cast<const T*>(p.src[j]);
  float v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int kx = q * E + e, tap = kx / p.cin[j], ci = kx - tap * p.cin[j];
    v[e] = kx < kk ? to_f32(src[tap * p.st[j][0] + ci * p.st[j][1] + nr * p.st[j][2]]) : 0.f;
  }
  const int s = q >> 1, h = q & 1;
  const size_t dst = (size_t)p.off[j] + (size_t)s * p.rows[j] * SLAB + nr * SLAB + ((h ^ ((nr >> 2) & 1)) << 4);
  if constexpr (BF16) {
    uint4 u;
    __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) hp[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(blob + dst) = u;
  } else {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(v[e], hi[e], lo[e]);
    *reinterpret_cast<uint4*>(blob + dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(blob + p.lo + dst) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
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
      named_barrier(1, COOKS);
      if (ct == 0 && item + 2 < items) {
        fence_async_shared();
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
            fence_async_shared();
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
      named_barrier(2, consumers);
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

// The narrow level's weights and biases -> blob (filter_narrow_kernel's
// layout), one launch.  mats: host array of 2 + n_conv device pointers (the
// up conv, the 1x1, the causal convs), each read as [taps, in, out] with
// element strides strides[3 j .. 3 j + 2]; biases: 2 + n_conv device
// pointers ([C] each); blob: filter_narrow_layout's bytes.
static int launch_narrow_weights(const void* const* mats, const long long* strides, const void* const* biases, int n_conv,
                          int K, int cin, int C, int r, void* blob, int bf16, cudaStream_t s) {
  if ((C != 8 && C != 16) || n_conv < 2 || n_conv > MAX_CONV || K < 1 || K > K_MAX || cin < 8 || r < 1 ||
      misaligned(blob))
    return static_cast<int>(cudaErrorInvalidValue);
  const NarrowLayout l = narrow_layout(n_conv, K, cin, C, r, 1, 64, 1, 1, bf16 != 0);
  NarrowPrepArgs p{};
  p.jobs = 2 + n_conv;
  p.C = C;
  p.lo = l.w_lo;
  p.b_off = l.b_off;
  int items = 0;
  for (int j = 0; j < p.jobs; ++j) {
    if (mats[j] == nullptr || biases[j] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    p.src[j] = mats[j];
    p.bias[j] = biases[j];
    for (int e = 0; e < 3; ++e) p.st[j][e] = strides[3 * j + e];
    p.taps[j] = j < 2 ? 1 : K;
    p.cin[j] = j == 0 ? cin : C;
    p.rows[j] = j == 0 ? r * C : C;
    p.off[j] = j == 0 ? 0 : j == 1 ? l.w_in : l.w_conv + (j - 2) * l.conv_bytes;
    p.first[j] = items;
    items += p.rows[j] * ((p.taps[j] * p.cin[j] * l.es + SLAB - 1) / SLAB * 2);
  }
  p.items = items;
  const int blocks = (items + p.jobs * C + 255) / 256;
  unsigned char* b = static_cast<unsigned char*>(blob);
  if (bf16) filter_narrow_weights_kernel<true><<<blocks, 256, 0, s>>>(p, b);
  else filter_narrow_weights_kernel<false><<<blocks, 256, 0, s>>>(p, b);
  return static_cast<int>(cudaGetLastError());
}

// A whole narrow level (C = 8 or 16): the weights' launch, then one launch
// of filter_narrow_kernel, back to back (the tensor maps are encoded
// first).  x_prev, skip [n, l_in, cin]; mats, strides, biases: the level's
// weights and biases as launch_narrow_weights reads them, into blob
// (filter_narrow_layout's bytes); film [n, F, 2 n_conv C] (conv i: scale
// at 2 i C, shift at (2 i + 1) C) with F dividing l_in r; dil: host array of
// n_conv dilations; out [n, l_in r, C].  The plan (kernels/filter.py:
// narrow_plan): a tile writes T samples after A rows of lookback (A >= the
// convs' lookback, A and T multiples of 8 and of r) and computes rows
// samples (>= A + T); owners (1, 2) tiles a block at once, of wpt
// warpgroups each (owners x wpt <= 4; 2 in float32 at C = 16); stages input
// chunks in flight a tile (a multiple of wpt, at most 4); blocks, the
// persistent grid.  bf16 storage when bf16 != 0, else float32 (3xTF32
// products).  Every pointer 16-byte aligned.
extern "C" int filter_narrow(const void* x_prev, const void* skip, const void* const* mats, const long long* strides,
                             const void* const* biases, void* blob, const void* film, void* out,
                             const int* dil, int n_conv, int K, int n, int l_in, int cin, int C, int r, int F,
                             int rows, int T, int A, int owners, int wpt, int stages, int blocks, int bf16,
                             void* stream) {
  const long long L = (long long)l_in * r;
  if ((C != 8 && C != 16) || n_conv < 2 || n_conv > MAX_CONV || n_conv % 2 || K < 1 || K > K_MAX || cin < 8 ||
      cin % 8 || r < 1 || n < 1 || l_in < 1 || L > 0x7fffffff || F < 1 || L % F || 2 * n_conv * C > 256 ||
      misaligned(x_prev) || misaligned(skip) || misaligned(blob) || misaligned(film) || misaligned(out) ||
      owners < 1 || owners > 2 || wpt < 1 || owners * wpt > (bf16 || C == 8 ? 4 : 2) || stages < 1 ||
      stages > NARROW_MAX_STAGES || stages % wpt ||
      blocks < 1 || T < 8 || T % 8 || T % r || A < 0 || A % 8 || A % r || rows < A + T)
    return static_cast<int>(cudaErrorInvalidValue);
  NarrowArgs p{};
  int lookback = 0;
  for (int i = 0; i < n_conv; ++i) {
    if (dil[i] < 1 || (K - 1) * dil[i] > HALO_MAX || L <= (K - 1) * dil[i]) return static_cast<int>(cudaErrorInvalidValue);
    p.dil[i] = dil[i];
    lookback += (K - 1) * dil[i];
  }
  if (A < lookback) return static_cast<int>(cudaErrorInvalidValue);
  p.ly = narrow_layout(n_conv, K, cin, C, r, (int)(L / F), rows, owners, stages, bf16 != 0);
  if (p.ly.smem > SMEM_MAX || p.ly.bw % 16 || wpt > p.ly.ms) return static_cast<int>(cudaErrorInvalidValue);
  p.blob = blob;
  p.n_conv = n_conv; p.K = K; p.L = (int)L; p.cin = cin; p.r = r; p.F = F; p.fr = (int)(L / F);
  p.fbox = std::min(p.ly.fbox, F);
  p.T = T; p.A = A; p.stages = stages; p.wpt = wpt;
  p.tiles_w = (int)((L + T - 1) / T);
  if ((long long)n * p.tiles_w > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = n * p.tiles_w;
  p.ob = std::min(OUT_BOX, T);
  const int film_ld = 2 * n_conv * C, es = bf16 ? 2 : 4;
  // maps: x_prev and skip (boxes of UP_ROWS rows x the input box), the FiLM
  // box, the output in boxes of ob rows and of the last T % ob
  CUtensorMap maps[5];
  if (!make_map_3d(&maps[0], x_prev, bf16, cin, l_in, n, p.ly.bw / es, UP_ROWS, p.ly.swz) ||
      !make_map_3d(&maps[1], skip, bf16, cin, l_in, n, p.ly.bw / es, UP_ROWS, p.ly.swz) ||
      !make_map_3d(&maps[2], film, bf16, film_ld, F, n, film_ld, p.fbox, 0) ||
      !make_map_3d(&maps[3], out, bf16, C, L, n, C, p.ob, 0) ||
      (T % p.ob && !make_map_3d(&maps[4], out, bf16, C, L, n, C, T % p.ob, 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T % p.ob == 0) maps[4] = maps[3];
  blocks = std::min(blocks, (p.tiles + owners - 1) / owners);   // every block has a tile for its first owner
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = launch_narrow_weights(mats, strides, biases, n_conv, K, cin, C, r, blob, bf16, s);
  if (rc != 0) return rc;
  if (C == 16)
    return bf16 ? launch_narrow<true, 16>(maps, p, owners, blocks, s) : launch_narrow<false, 16>(maps, p, owners, blocks, s);
  return bf16 ? launch_narrow<true, 8>(maps, p, owners, blocks, s) : launch_narrow<false, 8>(maps, p, owners, blocks, s);
}

// The narrow kernel's layout for a plan: {shared-memory bytes, blob bytes}
// into out[0..1] (kernels/filter.py:narrow_layout computes the same).
extern "C" int filter_narrow_layout(int n_conv, int K, int cin, int C, int r, int fr, int rows, int owners,
                                    int stages, int bf16, long long* out) {
  if (n_conv < 1 || K < 1 || cin < 8 || C < 8 || r < 1 || fr < 1 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const NarrowLayout l = narrow_layout(n_conv, K, cin, C, r, fr, rows, owners, stages, bf16 != 0);
  out[0] = l.smem;
  out[1] = l.blob;
  return 0;
}

