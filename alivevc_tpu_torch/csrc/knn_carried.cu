// Cosine top-k of every query row against a small library (under 4 096
// rows) in one launch that merges its own blocks' winners, after one launch
// that normalises both operands.
//
// Replaces: alivevc_tpu/kernels/knn_pallas.py:knn_topk_pallas's carried
// kernel (pallas_call at :331; _knn_kernel, and _knn_kernel_fast for the
// packed extraction), the route that knn_pallas.py:244-259 takes for
// libraries under 4 096 rows, and at those shapes the merge
// (knn_twopass.py:195 _merge_exact), which runs inside the launch.  The
// function is that of csrc/knn.cu (kernels/knn.py states it): rows
// normalised in float32 (x * rsqrt(max(sum x^2, 1e-30))) before the mode's
// cast; 'default' as bf16 operands with float32 sums; 'high'/'highest' as
// 3xTF32 (lo.hi + hi.lo + hi.hi a k-step, the k-steps in csrc/knn.cu's
// order); valid_rows (a host count, or one int32 on the device); a float32
// penalty added after the product; the packed extraction; k <= 8, ties to
// the smallest index, missing places (-inf, 0x7fffffff).
//
// What bounds it on an H100: latency.  At the streaming hop (24 queries x
// 887 rows x 768, 'high') the function reads 2.8 MB and does 98 MFLOP
// (0.8 us at 3.35 TB/s); csrc/knn.cu's pair spent ~77 us there (7 blocks
// of 192 query slots, 24 of them used, a block barrier each slab, a
// second launch).  Design:
//  * knn_carried_prep_kernel, a warp a row of both operands: the row's sum
//    of squares (lane-strided, then a shuffle tree), the scale, and the
//    operand in the mode's form, its columns zero-padded to whole 128-byte
//    slabs: bf16, or two float32 planes holding TF32 hi and lo.  The split
//    happens once per row, not once per slab and block.
//  * knn_carried_kernel: the library on the wgmma's M side (64 rows a
//    warpgroup, WG = 1 or 2 warpgroups a block) and a tile of NQ queries on
//    its N side (8, 24, 64 or 128: the hop's 24 queries fill N = 24).
//    Grid (query tiles, library blocks, split): where the queries fit one
//    tile, a cluster of 4 blocks (at most the slabs a row has) splits the
//    depth, and rank 0 adds the others' partial sums in rank order through
//    distributed shared memory (the hop: 56 blocks of 6 slabs, not 14 of
//    24).  Each block walks its slabs through a ring of 128-byte slabs of
//    both operands (hi and lo planes in 3xTF32) by TMA, 128-byte swizzle,
//    one "full" and one "empty" mbarrier a stage; both operands by
//    descriptor, so no block barrier in the loop; one slab's wgmma group in
//    flight while the next one's issue, and the stage it frees refilled by
//    thread 0 meanwhile (a producer warp of its own was slower: it polled
//    for freed stages while the consumers were the bound).
//    The first k-step's wgmma sets scale-d 0 (nothing else writes the
//    accumulators).  Then the block's scores go through shared memory,
//    [NQ][rows], and TPQ threads a query (a power of two in one warp) scan
//    them into sorted register top-k lists, merged by shuffles.
//  * The merge: with one library block the block writes the answer.  Else
//    each block writes its lists ([ls][blocks][K]), fences, and adds one to
//    its query tile's counter; the block that brings the counter to the
//    number of library blocks merges the tile's lists (the top-k of a total
//    order: the same answer in any arrival order) and writes [ls][k]
//    values and int64 indices.  The prep launch zeroes the counters first,
//    so a CUDA-graph replay starts from zero.
// A score's float32 sum: the k-steps above in order over each rank's
// slabs, the ranks' partial sums added in rank order.  The split depends
// on the queries and the width alone (kernels/knn.py:carried_split), so a
// row scores the same bits wherever it falls in a block, a library or a
// shard; the sharded path routes every shard by the size of the whole
// library (kernels/knn.py:knn_plan), so a shard and one rank take the same
// form.  (The two forms may differ in a score's last bits: their
// normalisations and sums run in other orders.)

#include "common.cuh"

#include <cstdint>
#include <cuda.h>

namespace {

constexpr int SLAB_BYTES = 128;   // bytes of each row a slab: one 128-byte swizzle span
constexpr int HEAD_BYTES = 1024;  // the mbarriers; operands start 1024-aligned (swizzle)
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448 - 1024;   // a block's 227 KB, less room for the static flag
constexpr int PREP_WARPS = 8;
constexpr int MAX_WG = 2;
constexpr int S_PAD = 4;          // score rows [NQ][rows + S_PAD]: conflict-free stores
enum { MODE_TF32 = 0, MODE_BF16 = 1, MODE_PACKED = 2 };

// d[0:N/2] (+)= A . B^T over one k-step (8 TF32 or 16 bf16 values) for the
// warpgroup's 64 rows x N columns, both operands K-major in shared memory
// with the 128-byte swizzle; scale_d = 0: d = A . B.
template <int N>
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
template <> __device__ __forceinline__ void wgmma_ss_tf32<8>(float (&d)[4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <> __device__ __forceinline__ void wgmma_ss_tf32<24>(float (&d)[12], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <> __device__ __forceinline__ void wgmma_ss_tf32<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <> __device__ __forceinline__ void wgmma_ss_tf32<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <> __device__ __forceinline__ void wgmma_ss_bf16<8>(float (&d)[4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <> __device__ __forceinline__ void wgmma_ss_bf16<24>(float (&d)[12], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <> __device__ __forceinline__ void wgmma_ss_bf16<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <> __device__ __forceinline__ void wgmma_ss_bf16<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// Insert (nv, ni) into a list sorted best-first.
template <int K>
__device__ __forceinline__ void insert(float (&v)[K], int (&id)[K], float nv, int ni) {
  if (!better(nv, ni, v[K - 1], id[K - 1])) return;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (better(nv, ni, v[s], id[s])) {
      const float tv = v[s];
      const int ti = id[s];
      v[s] = nv; id[s] = ni;
      nv = tv; ni = ti;
    }
  }
}

// Merge the lists of each aligned group of tpq lanes into all of them.
template <int K>
__device__ __forceinline__ void group_merge(float (&v)[K], int (&id)[K], int tpq) {
  for (int off = 1; off < tpq; off <<= 1) {
    float pv[K];
    int pi[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      pv[s] = __shfl_xor_sync(0xffffffffu, v[s], off);
      pi[s] = __shfl_xor_sync(0xffffffffu, id[s], off);
    }
#pragma unroll
    for (int s = 0; s < K; ++s) insert<K>(v, id, pv[s], pi[s]);
  }
}

// The packed extraction's ranking key (csrc/knn.cu): bits(s + 2) with the
// low 7 mantissa bits set to 127 - (row % 128).
__device__ __forceinline__ float packed_key(float s, int c) {
  const unsigned bits = __float_as_uint(s + 2.0f);
  return __uint_as_float((bits & ~127u) | (127u - (unsigned)c));
}

// One warp a row: rows [0, ls) of src, then rows [0, lr) of lib.  q_out /
// l_out [rows][dp]: bf16, or float32 hi then, ``plane`` floats further, lo.
// Block 0 also zeroes the main launch's n_counters counters.
__global__ void __launch_bounds__(32 * PREP_WARPS)
knn_carried_prep_kernel(const float* __restrict__ src, const float* __restrict__ lib, int ls, int lr,
                        int d, int dp, int bf16, void* q_out, void* l_out, unsigned* counters,
                        int n_counters) {
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < n_counters; i += blockDim.x) counters[i] = 0;
  const int row_all = blockIdx.x * PREP_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row_all >= ls + lr) return;
  const bool is_q = row_all < ls;
  const int row = is_q ? row_all : row_all - ls;
  const float* x = (is_q ? src : lib) + (size_t)row * d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = __ldg(x + c);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float scale = rsqrtf(fmaxf(ss, 1e-30f));
  if (bf16) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(is_q ? q_out : l_out) + (size_t)row * dp;
    for (int c = lane; c < dp; c += 32) out[c] = __float2bfloat16(c < d ? __ldg(x + c) * scale : 0.f);
  } else {
    const size_t plane = (size_t)(is_q ? ls : lr) * dp;
    float* hi = static_cast<float*>(is_q ? q_out : l_out) + (size_t)row * dp;
    for (int c = lane; c < dp; c += 32) {
      uint32_t h, l;
      split_tf32(c < d ? __ldg(x + c) * scale : 0.f, h, l);
      hi[c] = __uint_as_float(h);
      hi[plane + c] = __uint_as_float(l);
    }
  }
}

// The answer of query q: the first k places, packed keys back to scores,
// missing places as (-inf, 0x7fffffff).
template <int K, bool PACKED>
__device__ __forceinline__ void write_answer(const float (&v)[K], const int (&id)[K], int q, int k,
                                             float* __restrict__ out_v, long long* __restrict__ out_i) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < k) {
      const bool none = v[s] == -INFINITY;
      out_v[(size_t)q * k + s] = none ? -INFINITY : (PACKED ? v[s] - 2.0f : v[s]);
      out_i[(size_t)q * k + s] = none ? 0x7fffffffLL : (long long)id[s];
    }
  }
}

// Grid (query tiles, library blocks, split); 128 wg threads.  A stage holds
// the library slab [64 wg][128 B] (hi, then lo in 3xTF32) and the query
// slab [NQ][128 B] (hi, then lo).
template <int K, int MODE, int NQ>
__global__ void __launch_bounds__(128 * MAX_WG, 1)
knn_carried_kernel(const __grid_constant__ CUtensorMap tm_lh, const __grid_constant__ CUtensorMap tm_ll,
                   const __grid_constant__ CUtensorMap tm_qh, const __grid_constant__ CUtensorMap tm_ql,
                   const float* __restrict__ penalty, const int* __restrict__ valid_rows,
                   float* __restrict__ cand_v, int* __restrict__ cand_i, unsigned* __restrict__ counters,
                   float* __restrict__ out_v, long long* __restrict__ out_i,
                   int ls, int lr, int lv_host, int slabs, int k, int stages) {
  // blockIdx.z: this block's rank in a cluster of gridDim.z blocks that
  // split the depth: slabs [rank slabs / split, (rank + 1) slabs / split)
  constexpr bool TF32 = MODE == MODE_TF32;
  constexpr bool PACKED = MODE == MODE_PACKED;
  constexpr int PLANES = TF32 ? 2 : 1;
  constexpr int KSTEPS = SLAB_BYTES / 32;               // 32-byte wgmma k-steps a slab
  constexpr int ELEMS = SLAB_BYTES / (TF32 ? 4 : 2);    // tensor columns a slab
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last_block;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wgi = warp >> 2;
  const int threads = blockDim.x, rows = threads / 2;   // 64 library rows a warpgroup
  const int q0 = blockIdx.x * NQ;
  const int lblk = blockIdx.y, n_lb = gridDim.y;
  const int l0 = lblk * rows;

  // rows at index >= lv are excluded
  int lv = min(lr, lv_host);
  if (valid_rows) lv = min(lv, max(0, *valid_rows));
  const int rows_here = max(0, min(rows, lv - l0));
  const int split = gridDim.z, rank = blockIdx.z;
  const int s_begin = rank * slabs / split;
  const int n_steps = rows_here > 0 ? (rank + 1) * slabs / split - s_begin : 0;

  const unsigned a_bytes = rows * SLAB_BYTES, b_bytes = NQ * SLAB_BYTES;
  const unsigned stage_bytes = PLANES * (a_bytes + b_bytes);
  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));
  const unsigned base = (raw + HEAD_BYTES - 1) & ~(unsigned)(HEAD_BYTES - 1);
  unsigned char* smem = smem_raw + (base - raw);
  const unsigned full = base, empty = base + 8 * MAX_STAGES;
  const unsigned ring = base + HEAD_BYTES;

  auto fetch = [&](int step) {
    const int slot = step % stages, col = (s_begin + step) * ELEMS;
    const unsigned bar = full + 8 * slot, st = ring + slot * stage_bytes;
    mbar_expect_tx(bar, stage_bytes);
    tma_load(st, tm_lh, col, l0, bar);
    if (TF32) tma_load(st + a_bytes, tm_ll, col, l0, bar);
    tma_load(st + PLANES * a_bytes, tm_qh, col, q0, bar);
    if (TF32) tma_load(st + PLANES * a_bytes + b_bytes, tm_ql, col, q0, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, threads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < stages && s < n_steps; ++s) fetch(s);
  }
  __syncthreads();

  float acc[NQ / 2];
  int slot = 0, prev = 0;
  for (int step = 0; step < n_steps; ++step) {
    mbar_wait(full + 8 * slot, (step / stages) & 1);   // slab `step` has landed
    const unsigned st = ring + slot * stage_bytes;
    const unsigned a_hi = st + wgi * 64 * SLAB_BYTES, a_lo = a_hi + a_bytes;
    const unsigned b_hi = st + PLANES * a_bytes, b_lo = b_hi + b_bytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int scale_d = (step > 0 || kk > 0) ? 1 : 0;
      if constexpr (TF32) {
        // the products of csrc/knn.cu's k-step, in its order: q.lo l.hi, q.hi l.lo, q.hi l.hi
        wgmma_ss_tf32<NQ>(acc, desc_sw128(a_hi + 32 * kk), desc_sw128(b_lo + 32 * kk), scale_d);
        wgmma_ss_tf32<NQ>(acc, desc_sw128(a_lo + 32 * kk), desc_sw128(b_hi + 32 * kk), 1);
        wgmma_ss_tf32<NQ>(acc, desc_sw128(a_hi + 32 * kk), desc_sw128(b_hi + 32 * kk), 1);
      } else {
        wgmma_ss_bf16<NQ>(acc, desc_sw128(a_hi + 32 * kk), desc_sw128(b_hi + 32 * kk), scale_d);
      }
    }
    wgmma_commit();
    // one group in flight: slab step - 1's products are done, so its stage
    // is released and refilled while slab `step`'s run
    wgmma_wait<1>();
    if (step >= 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * prev);
      if (tid == 0 && step - 1 + stages < n_steps) {
        mbar_wait(empty + 8 * prev, ((step - 1) / stages) & 1);
        fetch(step - 1 + stages);
      }
    }
    prev = slot;
    slot = slot + 1 == stages ? 0 : slot + 1;
  }
  wgmma_wait<0>();
  __syncthreads();   // every warp is past its last wgmma: the ring is free

  // a split depth: rank 0 adds the other ranks' partial sums in rank order
  // (the same bits every call), read from their shared memory
  float* part = reinterpret_cast<float*>(smem + HEAD_BYTES);
  if (split > 1) {
    if (rank > 0) {
#pragma unroll
      for (int i = 0; i < NQ / 2; i += 2)
        *reinterpret_cast<float2*>(part + (i / 2) * 2 * threads + 2 * tid) = make_float2(acc[i], acc[i + 1]);
    }
    cluster_sync();
    if (rank == 0) {
      for (int r = 1; r < split; ++r)
#pragma unroll
        for (int i = 0; i < NQ / 2; i += 2) {
          const float2 x = ld_cluster_f2(smem_u32(part + (i / 2) * 2 * threads + 2 * tid), r);
          acc[i] += x.x;
          acc[i + 1] += x.y;
        }
    }
    cluster_sync();   // the partial sums are read: the other ranks may leave
    if (rank > 0) return;
  }

  // scores (+ penalty, or packed keys) -> S [NQ][rows + S_PAD]; this
  // thread's library rows 64 wgi + 16 (warp % 4) + g (+ 8), queries 8 j + 2 (lane % 4) + e
  const int sp = rows + S_PAD;
  float* S = part;
  if (n_steps > 0) {
    const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 64 * wgi + 16 * (warp & 3) + g + 8 * h;
          const int l = l0 + r;
          float x = acc[4 * j + 2 * h + e];
          if (penalty && l < lr) x += __ldg(penalty + l);
          if (PACKED) x = packed_key(x, l & 127);
          S[(8 * j + t2 + e) * sp + r] = x;
        }
  }
  __syncthreads();

  // tpq threads a query scan its scores; the groups merge by shuffles
  int tpq = 32;
  while (tpq > 1 && tpq * NQ > threads) tpq >>= 1;
  const int qq = tid / tpq, p = tid % tpq, qg = q0 + qq;
  const bool mine = qq < NQ && qg < ls;
  float v[K];
  int id[K];
#pragma unroll
  for (int s = 0; s < K; ++s) { v[s] = -INFINITY; id[s] = 0x7fffffff; }
  if (mine)
    for (int r = p; r < rows_here; r += tpq) insert<K>(v, id, S[qq * sp + r], l0 + r);
  group_merge<K>(v, id, tpq);
  const bool owner = mine && p == 0;
  if (n_lb == 1) {
    if (owner) write_answer<K, PACKED>(v, id, qg, k, out_v, out_i);
    return;
  }

  // more than one library block: publish this block's lists; the last
  // block of the query tile merges them
  if (owner) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      cand_v[((size_t)qg * n_lb + lblk) * K + s] = v[s];
      cand_i[((size_t)qg * n_lb + lblk) * K + s] = id[s];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(counters + blockIdx.x, 1u) == (unsigned)(n_lb - 1);
  __syncthreads();
  if (!last_block) return;
  __threadfence();
#pragma unroll
  for (int s = 0; s < K; ++s) { v[s] = -INFINITY; id[s] = 0x7fffffff; }
  if (mine)
    for (int b0 = p; b0 < n_lb; b0 += 4 * tpq) {
      float cv[4][K];
      int ci[4][K];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int b = b0 + u * tpq;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          cv[u][s] = b < n_lb ? __ldcg(cand_v + ((size_t)qg * n_lb + b) * K + s) : -INFINITY;
          ci[u][s] = b < n_lb ? __ldcg(cand_i + ((size_t)qg * n_lb + b) * K + s) : 0x7fffffff;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int s = 0; s < K; ++s) insert<K>(v, id, cv[u][s], ci[u][s]);
    }
  group_merge<K>(v, id, tpq);
  if (owner) write_answer<K, PACKED>(v, id, qg, k, out_v, out_i);
}

size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

template <int K, int MODE, int NQ>
int launch_main(const CUtensorMap* tm, const float* penalty, const int* valid_rows, float* cand_v,
                int* cand_i, unsigned* counters, float* out_v, long long* out_i, int ls, int lr,
                int lv_host, int slabs, int k, int stages, int q_tiles, int n_lb, int wg, int split,
                size_t smem, cudaStream_t stream) {
  auto kernel = knn_carried_kernel<K, MODE, NQ>;
  static size_t cap[64] = {};   // per device: the dynamic shared memory allowed so far
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > cap[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cap[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(q_tiles, n_lb, split);
  cfg.blockDim = dim3(128 * wg);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = (unsigned)split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tm[0], tm[1], tm[2], tm[3], penalty, valid_rows, cand_v, cand_i,
                           counters, out_v, out_i, ls, lr, lv_host, slabs, k, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int K, int MODE>
int launch_nq(int nq, const CUtensorMap* tm, const float* penalty, const int* valid_rows, float* cand_v,
              int* cand_i, unsigned* counters, float* out_v, long long* out_i, int ls, int lr, int lv_host,
              int slabs, int k, int stages, int q_tiles, int n_lb, int wg, int split, size_t smem,
              cudaStream_t s) {
#define KNN_CARRIED_NQ(N)                                                                              \
  if (nq == N)                                                                                         \
    return launch_main<K, MODE, N>(tm, penalty, valid_rows, cand_v, cand_i, counters, out_v, out_i, ls, \
                                   lr, lv_host, slabs, k, stages, q_tiles, n_lb, wg, split, smem, s);
  KNN_CARRIED_NQ(8)
  KNN_CARRIED_NQ(24)
  KNN_CARRIED_NQ(64)
  KNN_CARRIED_NQ(128)
#undef KNN_CARRIED_NQ
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The bytes of scratch ``knn_carried`` needs: the prepared operands (query
// rows, then library rows; bf16, or hi and lo planes), then with more than
// one library block the per-block lists ([ls][n_lb][kk] values, then
// indices) and a counter per query tile; each region 1024-aligned.  n_lb =
// ceil(min(lr, lv_host) / (64 wg)); kk = 4 or 8.
extern "C" long long knn_carried_scratch_bytes(int ls, int lr, int lv_host, int d, int kk, int mode,
                                               int nq, int wg) {
  const bool tf32 = mode == MODE_TF32;
  const size_t dp = round_up(d, tf32 ? 32 : 64), esize = tf32 ? 4 : 2, planes = tf32 ? 2 : 1;
  const int lr_eff = lr < lv_host ? lr : lv_host;
  const int n_lb = (lr_eff + 64 * wg - 1) / (64 * wg), q_tiles = (ls + nq - 1) / nq;
  size_t bytes = round_up(planes * ls * dp * esize, 1024) + round_up(planes * lr * dp * esize, 1024);
  if (n_lb > 1)
    bytes += 2 * round_up((size_t)ls * n_lb * kk * 4, 1024) + round_up((size_t)q_tiles * 4, 1024);
  return (long long)bytes;
}

// src [ls, d], lib [lr, d] float32 (rows as they come; the kernels
// normalise them), 4-byte aligned.  penalty: float32 [lr] or null.
// valid_rows: one int32 on the device or null; lv_host: rows >= lv_host are
// excluded too (lr when there is no host count).  mode: 0 3xTF32 ('high',
// 'highest'), 1 bf16 ('default'), 2 bf16 with the packed extraction.  nq in
// {8, 24, 64, 128} queries a block, wg in {1, 2} warpgroups (64 library rows
// each), split in {1, 2, 4} blocks of a cluster over the depth (at most its
// slabs), stages 2-4 (the plan: kernels/knn.py:knn_plan).  scratch: at
// least knn_carried_scratch_bytes, 256-aligned.  out_v [ls, k] float32,
// out_i [ls, k] int64; 1 <= k <= 8.
extern "C" int knn_carried(const void* src, const void* lib, const void* penalty, const void* valid_rows,
                           void* scratch, long long scratch_bytes, void* out_v, void* out_i, int ls, int lr,
                           int lv_host, int d, int k, int mode, int nq, int wg, int split, int stages,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tf32 = mode == MODE_TF32, bf16 = !tf32;
  const int kk = k <= 4 ? 4 : 8;
  if (mode < 0 || mode > 2 || k < 1 || k > 8 || ls < 1 || lr < 1 || lv_host < 1 || d < 1 || wg < 1 ||
      wg > MAX_WG || stages < 2 || stages > MAX_STAGES || (nq != 8 && nq != 24 && nq != 64 && nq != 128) ||
      (split != 1 && split != 2 && split != 4) ||
      reinterpret_cast<uintptr_t>(scratch) % 256 ||
      scratch_bytes < knn_carried_scratch_bytes(ls, lr, lv_host, d, kk, mode, nq, wg))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = static_cast<int>(round_up(d, tf32 ? 32 : 64));
  const size_t esize = tf32 ? 4 : 2, planes = tf32 ? 2 : 1;
  const int rows = 64 * wg, lr_eff = lr < lv_host ? lr : lv_host;
  const int n_lb = (lr_eff + rows - 1) / rows, q_tiles = (ls + nq - 1) / nq;
  const int slabs = static_cast<int>(dp * esize / SLAB_BYTES);
  if (split > slabs) return static_cast<int>(cudaErrorInvalidValue);
  const size_t stage_bytes = planes * (size_t)(rows + nq) * SLAB_BYTES;
  const size_t smem = 2 * HEAD_BYTES +
                      (stage_bytes * stages > (size_t)nq * (rows + S_PAD) * 4 ? stage_bytes * stages
                                                                              : (size_t)nq * (rows + S_PAD) * 4);
  if (smem > SMEM_LIMIT || q_tiles > 2147483647 / 2 || n_lb > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);

  unsigned char* q_ops = static_cast<unsigned char*>(scratch);
  unsigned char* l_ops = q_ops + round_up(planes * ls * dp * esize, 1024);
  unsigned char* cand = l_ops + round_up(planes * lr * dp * esize, 1024);
  float* cand_v = reinterpret_cast<float*>(cand);
  int* cand_i = reinterpret_cast<int*>(cand + round_up((size_t)ls * n_lb * kk * 4, 1024));
  unsigned* counters = reinterpret_cast<unsigned*>(cand + 2 * round_up((size_t)ls * n_lb * kk * 4, 1024));

  CUtensorMap tm[4];
  if (!make_map(&tm[0], l_ops, bf16, lr, dp, rows) || !make_map(&tm[2], q_ops, bf16, ls, dp, nq))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tf32) {
    if (!make_map(&tm[1], l_ops + (size_t)lr * dp * esize, false, lr, dp, rows) ||
        !make_map(&tm[3], q_ops + (size_t)ls * dp * esize, false, ls, dp, nq))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    tm[1] = tm[0];
    tm[3] = tm[2];
  }

  knn_carried_prep_kernel<<<(ls + lr + PREP_WARPS - 1) / PREP_WARPS, 32 * PREP_WARPS, 0, s>>>(
      static_cast<const float*>(src), static_cast<const float*>(lib), ls, lr, d, dp, bf16, q_ops, l_ops,
      counters, n_lb > 1 ? q_tiles : 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* pen = static_cast<const float*>(penalty);
  const int* vr = static_cast<const int*>(valid_rows);
  float* ov = static_cast<float*>(out_v);
  long long* oi = static_cast<long long*>(out_i);
#define KNN_CARRIED_MODE(KK, M)                                                                        \
  if (kk == KK && mode == M)                                                                           \
    return launch_nq<KK, M>(nq, tm, pen, vr, cand_v, cand_i, counters, ov, oi, ls, lr, lv_host, slabs, \
                            k, stages, q_tiles, n_lb, wg, split, smem, s);
  KNN_CARRIED_MODE(4, MODE_TF32)
  KNN_CARRIED_MODE(4, MODE_BF16)
  KNN_CARRIED_MODE(4, MODE_PACKED)
  KNN_CARRIED_MODE(8, MODE_TF32)
  KNN_CARRIED_MODE(8, MODE_BF16)
  KNN_CARRIED_MODE(8, MODE_PACKED)
#undef KNN_CARRIED_MODE
  return static_cast<int>(cudaErrorInvalidValue);
}
