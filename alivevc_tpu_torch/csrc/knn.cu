// Cosine top-k of every query row against a library of 4 096 rows or more:
// a launch that normalises both operands into the mode's planes, tile
// scores + exact per-chunk top-k (pass A), then an exact merge of the
// chunks' winners (pass B).
//
// Replaces: alivevc_tpu/kernels/knn_twopass.py:knn_topk_twopass (pass A
// _tile_kernel / _tile_kernel_exact, pallas_call at :331/:344/:395; pass B
// _merge_packed_kernel :372 and _merge_exact :195): the route of libraries
// of 4096 rows and more.  Smaller libraries take csrc/knn_carried.cu (JAX's
// carried kernel, knn_pallas.py:331); kernels/knn.py:knn_plan routes, and
// either form takes any library of at least k rows when forced.
//
// knn_prep_kernel normalises every row (x * scale in float32, the scale
// rsqrt(max(sum x^2, 1e-30)) from PyTorch's own sum,
// kernels/knn.py:row_scales, as the plain version takes it; a warp a row)
// and writes it in the mode's form, its columns
// zero-padded to whole 128-byte slabs: bf16 for 'default', or two float32
// planes, TF32 hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), for
// 'high'/'highest'.  So the split happens once a row and call, not in
// every block.  Scores run on the tensor cores, wgmma with float32
// accumulation: bf16, or 3xTF32 (lo.hi + hi.lo + hi.hi a k-step, ~2^-22
// relative per product, so the ranking is float32-faithful;
// kernels/knn.py:scores_3xtf32 emulates it).  A score's summation order is the k-steps in order, the first with
// scale-d 0, the same for every row wherever it falls in a tile, a chunk or
// a shard (the tile does not depend on the library, and the sharded path
// routes its shards by the whole library's rows, so a shard takes the
// form one rank takes).  Ties go to the smallest library index.
//
// Row exclusion (the sharded path's shard padding): rows at index >=
// min(lr, valid_rows) never win, in every mode, and a tile wholly past
// them is never loaded; the count may live on the device (read by the
// kernel, no host sync).  An optional float32 penalty[l] is added to each
// score after the product (JAX appends it as an operand column,
// knn_twopass.py:238-242, so its 'default' mode rounds it to bf16).  With
// fewer valid rows than k the missing places keep the sentinel (-inf,
// 0x7fffffff).
//
// Packed extraction (MODE_PACKED, 'default' only, no exclusion; replaces
// knn_pallas.py:_knn_kernel_fast / _pack_topk :51-135): each score s is
// ranked as bits(s + 2) with the low 7 mantissa bits replaced by 127 - c,
// c its library index mod 128, so within a 128-row subtile no two keys tie
// and the key of s is within 127 ulps (3.1e-5) of s + 2.  The register
// top-k orders keys by (key desc, global index asc), which is the TPU
// kernel's per-subtile extraction followed by its exact merge; the
// winners' keys minus 2 (exact in float32) are written.
//
// What bounds it on an H100: operations.  At the conversion path's shape
// (7 200 queries x 100 352 rows x 768) the products are 1.11 TFLOP (3x that
// in 3xTF32).  The kernel's earlier design (three warpgroups of 64 queries
// a block) ran them at a third of the peak: its fold
// stopped every warpgroup's products after each tile (41 % of a block),
// one consumer thread refilled the ring once all 12 warps had released a
// stage (26 %), and in 3xTF32 every block split the library in shared
// memory and the query fragments in registers for every tile (26-47 %);
// the ring alone brought operands at 7.6-9.1 TB/s (scripts/knn_phases.py).
// Design (kernels/knn.py:twopass_plan chooses the grid):
//  * A block tile of TQ = 128 queries x LT library rows: LT = 256 in bf16
//    (m64n256k16, both operands by descriptor, 128 accumulators a thread),
//    128 in 3xTF32 (m64n128k8 with the query fragments in registers by
//    ldmatrix from the prepared hi and lo planes: shared-memory A ran at
//    two thirds of the register-A rate).  Warp roles: warpgroups 0-1
//    consume (64 queries each: products and the fold; setmaxnreg up to
//    232 registers); warpgroup 2 produces (setmaxnreg down to 40; one
//    thread issues the TMA copies).  No consumer refills or waits on a free
//    stage.
//  * A ring of 128-byte slabs of both operands (bf16 4 stages of 48 KB,
//    3xTF32 3 of 64 KB: hi then lo planes), 128-byte swizzle, a "full"
//    mbarrier a stage (the producer's expect-tx, the copies' bytes) and an
//    "empty" one (every consumer warp of every block of the cluster).
//    64-byte slabs, twice the stages in the same memory, ran the products
//    alone 1.2x-1.4x slower (twice the commits and waits a product).
//  * A cluster of 1 or 2 blocks along the queries shares each library
//    slab: each block copies 1 / cluster of its rows with .multicast into
//    every block's stage at the same offset, and a stage is free once every
//    consumer warp of the cluster has released it (a remote arrival on
//    each block's barrier).  Operand bytes an L2 read brings, for the
//    products it feeds (bf16, 768 columns): the earlier 192 x 128 tile 77
//    FLOP/B; 128 x 256: 85, 128 with a cluster of 2.  The plan takes 2
//    where there are two query tiles or more.
//  * Products stay in flight: each slab's wgmma group is committed and
//    wgmma.wait_group 1 retires the one before, whose stage is then
//    released; a tile ends with wait_group 0.  In 3xTF32 the slabs of a
//    tile alternate between two fragment sets, so a slab never writes
//    registers that products in flight read.  No instruction but a wgmma
//    writes the accumulators (a tile's first k-step sets them).
//  * The two consumers run free of each other (nothing but the ring's
//    barriers orders them): one consumer's fold overlaps the other's
//    products only as their warps drift apart.  A stagger by a named
//    barrier each tile (consumer 1 some slabs behind consumer 0) was
//    measured and removed: it bought nothing (PERF.md).
//    The fold skips every 8-score group in which no lane of the warp
//    reaches its row's bound (the largest of the quad's list tails), and
//    inserts the rest into sorted register lists (2 query rows a thread;
//    a row's scores lie in one lane quad).
//  * The quad then merges by shuffles and the block writes k winners per
//    query and chunk.  Pass B merges the chunks with a warp per query:
//    lanes stride over the chunks, then a shuffle merge.

#include "common.cuh"

#include <cstdint>
#include <cuda.h>

namespace {

constexpr int TQ = 128;             // queries a block tile: two consumer warpgroups of 64
constexpr int SLAB_BYTES = 128;     // bytes of each row a slab: one 128-byte swizzle span
constexpr int HEAD_BYTES = 1024;    // the mbarriers; operands start 1024-aligned (swizzle)
constexpr int MAX_STAGES = 4;
constexpr int CONSUMERS = 256;      // threads of the two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;   // and the producer warpgroup
constexpr int PRODUCER_REGS = 40;   // 128 x 40 + 256 x 232 = 64 512 of the SM's 65 536
constexpr int CONSUMER_REGS = 232;
constexpr int PREP_WARPS = 8;
constexpr int SMEM_LIMIT = 232448;  // a block's 227 KB
enum { MODE_TF32 = 0, MODE_BF16 = 1, MODE_PACKED = 2 };

// The block tile of a mode.
template <int MODE>
struct Tile {
  static constexpr bool TF32 = MODE == MODE_TF32;
  static constexpr int PLANES = TF32 ? 2 : 1;          // TF32 hi and lo
  static constexpr int LT = TF32 ? 128 : 256;          // library rows (the wgmma N)
  static constexpr int ACC = LT / 2;                   // accumulators a consumer thread
  static constexpr int ELEMS = SLAB_BYTES / (TF32 ? 4 : 2);   // columns a slab
  static constexpr int KSTEPS = SLAB_BYTES / 32;       // 32-byte wgmma k-steps a slab
  static constexpr int Q_BYTES = PLANES * TQ * SLAB_BYTES;
  static constexpr int STAGE = Q_BYTES + PLANES * LT * SLAB_BYTES;
};

int tile_rows(int mode) { return mode == MODE_TF32 ? Tile<MODE_TF32>::LT : Tile<MODE_BF16>::LT; }
// The dynamic shared memory of a tile block: alignment slack and the
// mbarriers, then `stages` stages of the mode's tile.
size_t twopass_smem(int mode, int stages) {
  return 2 * HEAD_BYTES + (size_t)stages * (mode == MODE_TF32 ? Tile<MODE_TF32>::STAGE : Tile<MODE_BF16>::STAGE);
}

// d = A . B^T (+ d where scale_d) over one k-step of 16 bf16 values for the
// warpgroup's 64 rows x 256 columns, both operands K-major in shared
// memory with the 128-byte swizzle.
__device__ __forceinline__ void mma_bf16_n256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}


__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// Insert (nv, ni) into a list sorted best-first; compile-time indices keep
// the list in registers.
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

// Merge the lists of the 4 lanes of each quad (disjoint candidates of the
// same rows) into every lane of the quad.
template <int K, int R>
__device__ __forceinline__ void quad_merge(float (&v)[R][K], int (&id)[R][K]) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float pv[K];
      int pi[K];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        pv[s] = __shfl_xor_sync(0xffffffffu, v[r][s], off);
        pi[s] = __shfl_xor_sync(0xffffffffu, id[r][s], off);
      }
#pragma unroll
      for (int s = 0; s < K; ++s) insert<K>(v[r], id[r], pv[s], pi[s]);
    }
}

// The ranking key of the packed extraction (see the header).
__device__ __forceinline__ float packed_key(float s, int c) {
  const unsigned bits = __float_as_uint(s + 2.0f);
  return __uint_as_float((bits & ~127u) | (127u - (unsigned)c));
}

// The score of accumulator 4 j + 2 h + e: column c = 8 j + t2 + e of the
// tile (library row l0 + c), plus its penalty, or its packed key.
template <bool PACKED, bool PEN>
__device__ __forceinline__ float score(float x, int c, int l0, int lim, const float* __restrict__ penalty) {
  if (PEN) x += c < lim ? __ldg(penalty + l0 + c) : 0.f;
  return PACKED ? packed_key(x, c & 127) : x;
}

// A finished tile's scores into this thread's lists (rows h = 0, 1, those
// `live`; the first `lim` columns rank).  No score below a bound of its
// row's k-th best from the quad's four lists can be among the row's k best.
// So a row
// first takes the maximum of each group of 8 of its scores; only in a
// group where some lane of the warp reaches that bound does each score that
// reaches it go to its list (a runtime loop over their bits with one
// insertion site: inlined insertions at every score made the code too large
// to stay in the instruction cache).  The list keeps ties to the smaller
// index, in any order of insertion.
template <int K, int ACC, bool PACKED, bool PEN>
__device__ __forceinline__ void fold(const float (&acc)[ACC], float (&v)[2][K], int (&id)[2][K], int l0, int lim,
                                     const float* __restrict__ penalty, int t2, const bool (&live)[2]) {
  constexpr int GROUPS = ACC / 16;   // groups of 8 scores (4 j x 2 e) a row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // the row's k-th best is at least each lane's k-th, and at least the
    // smallest lane's (k / 4)-th: the four lanes' first k / 4 are k scores
    float tail = v[h][K - 1], head = v[h][K / 4 - 1];
    tail = fmaxf(tail, __shfl_xor_sync(0xffffffffu, tail, 1));
    head = fminf(head, __shfl_xor_sync(0xffffffffu, head, 1));
    tail = fmaxf(tail, __shfl_xor_sync(0xffffffffu, tail, 2));
    head = fminf(head, __shfl_xor_sync(0xffffffffu, head, 2));
    // every score in the lists comes from an earlier tile, so a score of
    // this tile that only ties the bound has a larger index than k scores
    // at least as high: a score enters only above it.  A row past the
    // queries (zero-filled: all its scores tie) takes none.
    const float thr = live[h] ? fmaxf(tail, head) : INFINITY;
    float gm[GROUPS];
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) gm[g] = -INFINITY;
    if (lim == ACC * 2) {   // a whole tile
#pragma unroll
      for (int g = 0; g < GROUPS; ++g)
#pragma unroll
        for (int j = 4 * g; j < 4 * g + 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            gm[g] = fmaxf(gm[g], score<PACKED, PEN>(acc[4 * j + 2 * h + e], 8 * j + t2 + e, l0, lim, penalty));
    } else {
#pragma unroll
      for (int g = 0; g < GROUPS; ++g)
#pragma unroll
        for (int j = 4 * g; j < 4 * g + 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + t2 + e;
            if (c < lim) gm[g] = fmaxf(gm[g], score<PACKED, PEN>(acc[4 * j + 2 * h + e], c, l0, lim, penalty));
          }
    }
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      if (!__any_sync(0xffffffffu, gm[g] > thr)) continue;
      // the group's scores that reach the bound, as bits u = 2 (j - 4 g) + e
      float xs[8];
      unsigned mask = 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = 8 * (4 * g + u / 2) + t2 + (u & 1);
        xs[u] = score<PACKED, PEN>(acc[4 * (4 * g + u / 2) + 2 * h + (u & 1)], c, l0, lim, penalty);
        if (c < lim && xs[u] > thr) mask |= 1u << u;
      }
      // one insertion site for them all: the code stays small
      while (mask) {
        const int u = __ffs(mask) - 1;
        mask &= mask - 1;
        float x = xs[0];
#pragma unroll
        for (int w = 1; w < 8; ++w) x = u == w ? xs[w] : x;
        insert<K>(v[h], id[h], x, l0 + 8 * (4 * g + u / 2) + t2 + (u & 1));
      }
    }
  }
}

// One slab's products into acc: 3xTF32 takes this warp's query fragments
// (hi, lo) of the slab from the prepared planes by ldmatrix into fh / fl
// (a_row: this lane's row and the swizzle), then q.lo l.hi + q.hi l.lo +
// q.hi l.hi a k-step, in this order; bf16 takes both operands by
// descriptor.  The tile's first k-step sets the scores (scale-d 0).
template <int MODE>
__device__ __forceinline__ void slab_products(float (&acc)[Tile<MODE>::ACC], uint32_t (&fh)[Tile<MODE>::KSTEPS][4],
                                              uint32_t (&fl)[Tile<MODE>::KSTEPS][4], unsigned st, unsigned a_off, unsigned a_row,
                                              int sw, int ha, bool first) {
  using T = Tile<MODE>;
  const unsigned lb = st + T::Q_BYTES;
  if constexpr (T::TF32) {
#pragma unroll
    for (int k = 0; k < T::KSTEPS; ++k) {
      ldsm_x4(fh[k], st + a_row + (((2 * k + ha) ^ sw) << 4));
      ldsm_x4(fl[k], st + TQ * SLAB_BYTES + a_row + (((2 * k + ha) ^ sw) << 4));
    }
  }
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < T::KSTEPS; ++k) {
    const int sd = (!first || k > 0) ? 1 : 0;
    if constexpr (T::TF32) {
      wgmma_rs_tf32<128>(acc, fl[k], desc_sw128(lb + 32 * k), sd);
      wgmma_rs_tf32<128>(acc, fh[k], desc_sw128(lb + T::LT * SLAB_BYTES + 32 * k), 1);
      wgmma_rs_tf32<128>(acc, fh[k], desc_sw128(lb + 32 * k), 1);
    } else {
      mma_bf16_n256(acc, desc_sw128(st + a_off + 32 * k), desc_sw128(lb + 32 * k), sd);
    }
  }
  wgmma_commit();
}

// One warp a row: rows [0, ls) of src, then rows [0, lr) of lib, each
// times its scale (scale_q / scale_l) into q_out / l_out [rows][dp]: bf16,
// or float32 TF32 hi and, one plane (rows x dp floats) further, lo; columns
// past d are zeros.  The product is rounded once (__fmul_rn: never fused
// into the split's subtraction), as PyTorch's multiply rounds it.
// VEC: d a multiple of 4 and the rows 16-byte aligned, written 16 bytes a
// lane.
__device__ __forceinline__ void prep_store(void* out, size_t plane, size_t at, float x, bool bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(x);
  } else {
    uint32_t h, l;
    split_tf32(x, h, l);
    static_cast<float*>(out)[at] = __uint_as_float(h);
    static_cast<float*>(out)[plane + at] = __uint_as_float(l);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(32 * PREP_WARPS)
knn_prep_kernel(const float* __restrict__ src, const float* __restrict__ lib, const float* __restrict__ scale_q,
                const float* __restrict__ scale_l, int ls, int lr, int d, int dp, int bf16, void* q_out,
                void* l_out) {
  const int row_all = blockIdx.x * PREP_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row_all >= ls + lr) return;
  const bool is_q = row_all < ls;
  const int row = is_q ? row_all : row_all - ls;
  const float* x = (is_q ? src : lib) + (size_t)row * d;
  void* out = is_q ? q_out : l_out;
  const size_t plane = (size_t)(is_q ? ls : lr) * dp, at = (size_t)row * dp;
  const float scale = __ldg((is_q ? scale_q : scale_l) + row);
  int c0 = 0;
  if (VEC) {
    for (int c = 4 * lane; c < d; c += 128) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x + c));
      const float y[4] = {__fmul_rn(v.x, scale), __fmul_rn(v.y, scale), __fmul_rn(v.z, scale),
                          __fmul_rn(v.w, scale)};
      if (bf16) {
        __nv_bfloat162 lo2 = __floats2bfloat162_rn(y[0], y[1]), hi2 = __floats2bfloat162_rn(y[2], y[3]);
        uint2 w;
        w.x = *reinterpret_cast<uint32_t*>(&lo2);
        w.y = *reinterpret_cast<uint32_t*>(&hi2);
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + at + c) = w;
      } else {
        uint32_t h[4], l[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(y[i], h[i], l[i]);
        float* o = static_cast<float*>(out) + at + c;
        *reinterpret_cast<float4*>(o) = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                                                    __uint_as_float(h[2]), __uint_as_float(h[3]));
        *reinterpret_cast<float4*>(o + plane) = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                                                            __uint_as_float(l[2]), __uint_as_float(l[3]));
      }
    }
    c0 = d;
  }
  for (int c = c0 + lane; c < dp; c += 32)
    prep_store(out, plane, at + c, c < d ? __fmul_rn(__ldg(x + c), scale) : 0.f, bf16);
}

// Pass A.  Grid (query tiles, padded to whole clusters; chunks), clusters
// of `cluster` blocks along the query tiles, THREADS threads.  A stage
// holds the query slab [TQ][128 B] (TF32: hi, then lo) and the library
// slab [LT][128 B] (hi, then lo), both 128-byte swizzled.  rows_per_chunk
// is a multiple of LT; slabs = the 128-byte slabs of a row.
template <int K, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
knn_tile_kernel(const __grid_constant__ CUtensorMap tm_qh, const __grid_constant__ CUtensorMap tm_ql,
                const __grid_constant__ CUtensorMap tm_lh, const __grid_constant__ CUtensorMap tm_ll,
                const float* __restrict__ penalty, const int* __restrict__ valid_rows,
                float* __restrict__ cand_v, int* __restrict__ cand_i,
                int ls, int lr, int slabs, int rows_per_chunk, int n_chunks, int stages) {
  using T = Tile<MODE>;
  constexpr bool PACKED = MODE == MODE_PACKED;
  constexpr int LT = T::LT;
  extern __shared__ unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * TQ, chunk = blockIdx.y;
  const int cl = (int)cluster_blocks(), rank = (int)cluster_rank();

  // rows at index >= lv are excluded; every block of a cluster has the
  // same chunk, so the same tiles
  const int lv = valid_rows ? min(lr, max(0, *valid_rows)) : lr;
  const int l_begin = chunk * rows_per_chunk;
  const int l_end = min(lv, l_begin + rows_per_chunk);
  const int n_tiles = l_end > l_begin ? (l_end - l_begin + LT - 1) / LT : 0;
  const int n_steps = n_tiles * slabs;

  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + HEAD_BYTES - 1) & ~(unsigned)(HEAD_BYTES - 1);
  const unsigned full = base, empty = base + 8 * MAX_STAGES;   // one mbarrier a stage each
  const unsigned ring = base + HEAD_BYTES;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, (CONSUMERS / 32) * cl);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // every block's barriers are ready before a copy or an arrival reaches them

  if (tid >= CONSUMERS) {
    // ---- the producer --------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) {
      const int piece = LT / cl;                            // library rows this block copies
      const uint16_t mask = (uint16_t)((1u << cl) - 1);
      const int qy = q0 < ls ? q0 : 0;                      // a padding tile reads real rows
      for (int step = 0; step < n_steps; ++step) {
        const int slot = step % stages, round = step / stages;
        if (round > 0) mbar_wait(empty + 8 * slot, (round - 1) & 1);   // every consumer of the cluster is done
        const int col = (step % slabs) * T::ELEMS;
        // rows past the tensor are zero-filled (a piece wholly past it
        // starts at its last row); rows past l_end never rank
        const int ly = min(l_begin + (step / slabs) * LT + rank * piece, lr - 1);
        const unsigned bar = full + 8 * slot, st = ring + slot * T::STAGE;
        const unsigned lst = st + T::Q_BYTES + rank * piece * SLAB_BYTES;
        mbar_expect_tx(bar, T::STAGE);
        tma_load(st, tm_qh, col, qy, bar);
        if (T::TF32) tma_load(st + TQ * SLAB_BYTES, tm_ql, col, qy, bar);
        if (cl > 1) {
          tma_load_multicast(lst, tm_lh, col, ly, bar, mask);
          if (T::TF32) tma_load_multicast(lst + LT * SLAB_BYTES, tm_ll, col, ly, bar, mask);
        } else {
          tma_load(lst, tm_lh, col, ly, bar);
          if (T::TF32) tma_load(lst + LT * SLAB_BYTES, tm_ll, col, ly, bar);
        }
      }
    }
    cluster_sync();   // no block leaves while another may still copy into it or arrive on it
    return;
  }

  // ---- the consumers ---------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int c = warp >> 2;                       // queries 64 c .. 64 c + 63 of the tile
  const int t2 = 2 * (lane & 3);
  const int q_row = q0 + 64 * c + 16 * (warp & 3) + (lane >> 2);   // this thread's rows: q_row, q_row + 8
  const bool live[2] = {q_row < ls, q_row + 8 < ls};
  float v[2][K];
  int id[2][K];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int s = 0; s < K; ++s) { v[r][s] = -INFINITY; id[r][s] = 0x7fffffff; }
  float acc[T::ACC];

  // this stage's release: one arrival a warp on each block of the cluster
  auto release = [&](int s) {
    __syncwarp();
    if (lane < cl) mbar_arrive_cluster(empty + 8 * s, lane);
  };
  const unsigned a_off = c * 64 * SLAB_BYTES;
  // 3xTF32: this lane's ldmatrix row of the warp's 16 query rows, and the
  // swizzled 16-byte chunk of k-step k: (2 k + lane / 16) ^ (lane & 7)
  const unsigned a_row = a_off + (16 * (warp & 3) + (lane & 15)) * SLAB_BYTES;
  const int sw = lane & 7, ha = lane >> 4;
  // two sets of query fragments, by slab parity: the set a slab writes was
  // read by products already retired
  uint32_t fa_h[T::KSTEPS][4], fa_l[T::KSTEPS][4], fb_h[T::KSTEPS][4], fb_l[T::KSTEPS][4];
  int slot = 0, step = 0;
  for (int t = 0, l0 = l_begin; t < n_tiles; ++t, l0 += LT) {
    int prev = 0;
    for (int s = 0; s < slabs; ++s, ++step) {
      mbar_wait(full + 8 * slot, (step / stages) & 1);   // slab `step` has landed
      const unsigned st = ring + slot * T::STAGE;
      if (s & 1)
        slab_products<MODE>(acc, fb_h, fb_l, st, a_off, a_row, sw, ha, s == 0);
      else
        slab_products<MODE>(acc, fa_h, fa_l, st, a_off, a_row, sw, ha, s == 0);
      wgmma_wait<1>();                                  // the previous slab's products are done
      if (s > 0) release(prev);
      prev = slot;
      slot = slot + 1 == stages ? 0 : slot + 1;
    }
    wgmma_wait<0>();   // the tile is complete: fold it
    release(prev);
    const int lim = min(LT, l_end - l0);   // only the chunk's last tile can be partial
    if (penalty)
      fold<K, T::ACC, PACKED, true>(acc, v, id, l0, lim, penalty, t2, live);
    else
      fold<K, T::ACC, PACKED, false>(acc, v, id, l0, lim, penalty, t2, live);
  }

  quad_merge<K, 2>(v, id);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + 64 * c + 16 * (warp & 3) + 8 * r + (lane >> 2);
      if (q < ls) {
        const size_t out = ((size_t)q * n_chunks + chunk) * K;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          // key - 2 is exact, so the merge keeps the packed order
          cand_v[out + s] = PACKED ? v[r][s] - 2.0f : v[r][s];
          cand_i[out + s] = id[r][s];
        }
      }
    }
  }
  cluster_sync();
}

// Pass B: a warp per query; lanes stride over the chunks, then a shuffle
// merge.  cand [ls][n_chunks][K].
template <int K>
__global__ void __launch_bounds__(256)
knn_merge_kernel(const float* __restrict__ cand_v, const int* __restrict__ cand_i,
                 float* __restrict__ out_v, int* __restrict__ out_i, int ls, int n_chunks) {
  const int lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (q >= ls) return;
  float v[K];
  int id[K];
#pragma unroll
  for (int s = 0; s < K; ++s) { v[s] = -INFINITY; id[s] = 0x7fffffff; }
  const size_t row = (size_t)q * n_chunks * K;
  for (int c = lane; c < n_chunks; c += 32)
#pragma unroll
    for (int s = 0; s < K; ++s) insert<K>(v, id, cand_v[row + c * K + s], cand_i[row + c * K + s]);
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
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
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) { out_v[(size_t)q * K + s] = v[s]; out_i[(size_t)q * K + s] = id[s]; }
  }
}

template <int K, int MODE>
int launch_tile(const CUtensorMap* tm, const float* penalty, const int* valid_rows, float* cand_v, int* cand_i,
                int ls, int lr, int slabs, int rows_per_chunk, int n_chunks, int cluster, int stages,
                cudaStream_t stream) {
  auto kernel = knn_tile_kernel<K, MODE>;
  const size_t smem = twopass_smem(MODE, stages);
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
  const int q_tiles = (ls + TQ - 1) / TQ;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((q_tiles + cluster - 1) / cluster * cluster), (unsigned)n_chunks, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tm[0], tm[1], tm[2], tm[3], penalty, valid_rows, cand_v, cand_i, ls, lr,
                           slabs, rows_per_chunk, n_chunks, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src [ls, d], lib [lr, d] float32 (rows as they come), 4-byte aligned,
// and their rows' scales scale_q [ls], scale_l [lr] float32 -> q_out
// [ls][dp], l_out [lr][dp]: bf16 when mode != 0, else float32 TF32 hi then
// lo planes ([2][rows][dp]); dp a multiple of 64 (bf16) or 32, >= d.
extern "C" int knn_prep(const void* src, const void* lib, const void* scale_q, const void* scale_l, void* q_out,
                        void* l_out, int ls, int lr, int d, int dp, int mode, void* stream) {
  if (mode < 0 || mode > 2 || ls < 1 || lr < 1 || d < 1 || dp < d || dp % (mode == MODE_TF32 ? 32 : 64) ||
      (reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(lib)) % 4 ||
      (reinterpret_cast<uintptr_t>(q_out) | reinterpret_cast<uintptr_t>(l_out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = (long long)ls + lr;
  const unsigned blocks = (unsigned)((rows + PREP_WARPS - 1) / PREP_WARPS);
  const float* s = static_cast<const float*>(src);
  const float* l = static_cast<const float*>(lib);
  const float* sq = static_cast<const float*>(scale_q);
  const float* sl = static_cast<const float*>(scale_l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && (reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(lib)) % 16 == 0)
    knn_prep_kernel<true><<<blocks, 32 * PREP_WARPS, 0, st>>>(s, l, sq, sl, ls, lr, d, dp, mode != MODE_TF32, q_out,
                                                               l_out);
  else
    knn_prep_kernel<false><<<blocks, 32 * PREP_WARPS, 0, st>>>(s, l, sq, sl, ls, lr, d, dp, mode != MODE_TF32, q_out,
                                                                l_out);
  RETURN_LAUNCH_STATUS();
}

// q_ops [ls][dp], l_ops [lr][dp]: knn_prep's planes (mode 0 3xTF32, 1 bf16,
// 2 bf16 with the packed extraction), 16-byte aligned.  penalty: float32
// [lr] or null.  valid_rows: one int32 on the device or null (rows >=
// min(lr, *valid_rows) are excluded).  cand_v/cand_i [ls, ceil(lr /
// rows_per_chunk), kk], out_v/out_i [ls, kk] with kk = 4 or 8 (the caller
// keeps the first k columns).  The plan (kernels/knn.py:twopass_plan):
// rows_per_chunk a multiple of the mode's tile rows (256 bf16, 128 3xTF32),
// cluster 1 or 2 blocks along the queries, stages 2-4 (within a block's
// shared memory).
extern "C" int knn_topk(const void* q_ops, const void* l_ops, const void* penalty, const void* valid_rows,
                        void* cand_v, void* cand_i, void* out_v, void* out_i, int ls, int lr, int dp, int kk,
                        int mode, int rows_per_chunk, int cluster, int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tf32 = mode == MODE_TF32;
  if (mode < 0 || mode > 2 || (kk != 4 && kk != 8) || ls < 1 || lr < 1 || dp < 1 || dp % (tf32 ? 32 : 64) ||
      rows_per_chunk < 1 || rows_per_chunk % tile_rows(mode) || (cluster != 1 && cluster != 2) ||
      stages < 2 || stages > MAX_STAGES || twopass_smem(mode, stages) > SMEM_LIMIT ||
      (reinterpret_cast<uintptr_t>(q_ops) | reinterpret_cast<uintptr_t>(l_ops)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (int)(((long long)lr + rows_per_chunk - 1) / rows_per_chunk);
  if (n_chunks > 65535)   // chunks ride gridDim.y
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int esize = tf32 ? 4 : 2, slabs = dp * esize / SLAB_BYTES, piece = tile_rows(mode) / cluster;
  const unsigned char* q = static_cast<const unsigned char*>(q_ops);
  const unsigned char* l = static_cast<const unsigned char*>(l_ops);
  CUtensorMap tm[4];
  if (!make_map(&tm[0], q, !tf32, ls, dp, TQ) || !make_map(&tm[2], l, !tf32, lr, dp, piece))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tf32) {
    if (!make_map(&tm[1], q + (size_t)ls * dp * 4, false, ls, dp, TQ) ||
        !make_map(&tm[3], l + (size_t)lr * dp * 4, false, lr, dp, piece))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    tm[1] = tm[0];
    tm[3] = tm[2];
  }
  const float* pen = static_cast<const float*>(penalty);
  const int* vr = static_cast<const int*>(valid_rows);
  float* cv = static_cast<float*>(cand_v);
  int* ci = static_cast<int*>(cand_i);
  int rc = static_cast<int>(cudaErrorInvalidValue);
#define KNN_TILE(KK, M)                                                                                      \
  if (kk == KK && mode == M)                                                                                 \
    rc = launch_tile<KK, M>(tm, pen, vr, cv, ci, ls, lr, slabs, rows_per_chunk, n_chunks, cluster, stages, s);
  KNN_TILE(4, MODE_TF32)
  KNN_TILE(4, MODE_BF16)
  KNN_TILE(4, MODE_PACKED)
  KNN_TILE(8, MODE_TF32)
  KNN_TILE(8, MODE_BF16)
  KNN_TILE(8, MODE_PACKED)
#undef KNN_TILE
  if (rc != 0) return rc;
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  if (kk == 4)
    knn_merge_kernel<4><<<(ls + 7) / 8, 256, 0, s>>>(cv, ci, ov, oi, ls, n_chunks);
  else
    knn_merge_kernel<8><<<(ls + 7) / 8, 256, 0, s>>>(cv, ci, ov, oi, ls, n_chunks);
  RETURN_LAUNCH_STATUS();
}
