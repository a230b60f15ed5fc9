// Cosine top-k of every query row against a library: tile scores + exact
// per-block top-k (pass A), then an exact merge of the per-block winners
// (pass B).
//
// Replaces: alivevc_tpu/kernels/knn_twopass.py:knn_topk_twopass (pass A
// _tile_kernel / _tile_kernel_exact, pallas_call at :331/:344/:395; pass B
// _merge_packed_kernel :372 and _merge_exact :195): the route of libraries
// of 4096 rows and more.  Smaller libraries take csrc/knn_carried.cu (JAX's
// carried kernel, knn_pallas.py:331); kernels/knn.py:knn_plan routes, and
// either form takes any library of at least k rows when forced.
//
// Inputs arrive L2-normalised (x * rsqrt(max(sum x^2, 1e-30)), done in
// float32 by the wrapper) and, for precision 'default', rounded to bf16.
// Scores run on the tensor cores in every mode, as wgmma with float32
// accumulation: bf16 operands for 'default'; 3xTF32 for 'high'/'highest'.
// There each float32 operand is split as hi = cvt.rna.tf32(x), lo =
// cvt.rna.tf32(x - hi), and the score accumulates lo.hi + hi.lo + hi.hi per
// k-step (~2^-22 relative per product, so the ranking is float32-faithful;
// kernels/knn.py:scores_3xtf32 emulates it).  A score's summation order is
// the same for every row wherever it falls in a tile, a chunk or a shard
// (the sharded path routes its shards by the whole library's rows, so a
// shard takes the form one rank takes).
// Ties go to the smallest library index.
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
// Packed extraction (PACKED, 'default' only, no exclusion; replaces
// knn_pallas.py:_knn_kernel_fast / _pack_topk :51-135): each score s is
// ranked as bits(s + 2) with the low 7 mantissa bits replaced by 127 - c,
// c its column in the 128-aligned score tile, so within a 128-column
// subtile no two keys tie and the key of s is within 127 ulps (3.1e-5) of
// s + 2.  The block's register top-k orders keys by (key desc, global index
// asc), which is the TPU kernel's per-subtile extraction followed by its
// exact merge; the winners' keys minus 2 (exact in float32) are written.
//
// What bounds it on an H100: operations.  At the conversion path's shape
// (7 200 queries x 100 352 rows x 768) the score products are 1.11 TFLOP
// (3x that in 3xTF32) against 154 MB (bf16) of library.  Design: a block of
// WG warpgroups owns QT = 64 WG queries and a chunk of library rows, walked
// as QT x 128 score tiles; warpgroup w computes rows 64 w .. 64 w + 63 of a
// tile in 64 accumulator registers a thread.  Operand slabs (128 bytes of
// each row) arrive by TMA (one 2-D tensor copy per operand and slab,
// 128-byte swizzle, rows past the tensor zero-filled) into a ring of
// STAGES shared-memory stages.  Each stage has a "full" mbarrier that the
// copies complete and an "empty" one on which every warp releases it; one
// thread keeps the ring full.  In bf16 wgmma reads both operands from
// shared memory through descriptors.  In 3xTF32 the block first splits the
// library slab in place into its hi part plus a lo slab beside it (one
// pass, then a barrier of the block); the query fragments come from
// ldmatrix and split in registers.  The query tile (192 rows) does not fit
// in shared memory beside a ring, so both operands stream; L2 serves the
// repeats.  After a tile's last slab each thread folds its accumulators
// into sorted top-k lists in registers (2 query rows a thread; a row's
// 128 scores lie in one lane quad), skipping the row when none of its
// scores reaches its k-th best, while the next slabs land.  The quad then
// merges by shuffles and the block writes k winners per query and chunk.
// Pass B merges the chunks with a warp per query: lanes stride over the
// chunks, then a shuffle merge.

#include "common.cuh"

#include <cstdint>
#include <cuda.h>

namespace {

constexpr int WG = 3;             // warpgroups a block, 64 queries each
constexpr int QT = 64 * WG;       // queries per block
constexpr int LT = 128;           // library rows per score tile (the wgmma N)
constexpr int THREADS = 128 * WG;
constexpr int STAGES = 4;         // ring depth
constexpr int SLAB_BYTES = 128;   // bytes of each row per slab: one 128-byte swizzle span
constexpr int HEAD_BYTES = 1024;  // the mbarriers; operands start 1024-aligned (swizzle)
constexpr int A_SLAB = QT * SLAB_BYTES;
constexpr int B_SLAB = LT * SLAB_BYTES;

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

// Pass A.  Grid (query tiles, chunks).  A stage holds the query slab
// [QT][128 B] and the library slab [LT][128 B] (tm_src, tm_lib boxes), both
// 128-byte swizzled (16-byte chunk c of row r at chunk c ^ (r & 7)), and in
// 3xTF32 the library slab's lo part [LT][128 B] beside them.
template <int K, bool BF16, bool PACKED>
__global__ void __launch_bounds__(THREADS, 1)
knn_tile_kernel(const __grid_constant__ CUtensorMap tm_src, const __grid_constant__ CUtensorMap tm_lib,
                const float* __restrict__ penalty, const int* __restrict__ valid_rows,
                float* __restrict__ cand_v, int* __restrict__ cand_i,
                int ls, int lr, int d, int rows_per_chunk, int n_chunks) {
  constexpr int STAGE_BYTES = A_SLAB + (BF16 ? 1 : 2) * B_SLAB;
  constexpr int ELEMS = SLAB_BYTES / (BF16 ? 2 : 4);   // tensor columns per slab
  constexpr int KSTEPS = SLAB_BYTES / 32;               // 32-byte wgmma k-steps per slab
  extern __shared__ unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QT;
  const int chunk = blockIdx.y;

  // rows at index >= lv are excluded
  const int lv = valid_rows ? min(lr, max(0, *valid_rows)) : lr;
  const int l_begin = chunk * rows_per_chunk;
  const int l_end = min(lv, l_begin + rows_per_chunk);
  const int n_tiles = l_end > l_begin ? (l_end - l_begin + LT - 1) / LT : 0;
  const int slabs = d / ELEMS;                         // slabs per row
  const int n_steps = n_tiles * slabs;

  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));
  const unsigned base = (raw + HEAD_BYTES - 1) & ~(unsigned)(HEAD_BYTES - 1);
  unsigned char* smem = smem_raw + (base - raw);
  const unsigned full = base, empty = base + 8 * STAGES;   // one mbarrier per stage each
  const unsigned ring = base + HEAD_BYTES;

  // slab `step` (tile step / slabs, columns (step % slabs) * ELEMS) of
  // both operands into its stage
  auto fetch = [&](int step) {
    const int slot = step % STAGES, col = (step % slabs) * ELEMS;
    const unsigned bar = full + 8 * slot, st = ring + slot * STAGE_BYTES;
    mbar_expect_tx(bar, A_SLAB + B_SLAB);
    tma_load(st, tm_src, col, q0, bar);
    tma_load(st + A_SLAB, tm_lib, col, l_begin + (step / slabs) * LT, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < STAGES && s < n_steps; ++s) fetch(s);
  }
  __syncthreads();

  // this thread's rows: 16 warp + g and + 8 (g = lane / 4); its columns of
  // a tile: 8 j + 2 (lane % 4) + e, accumulator 4 j + 2 h + e for row h
  float v[2][K];
  int id[2][K];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int s = 0; s < K; ++s) { v[r][s] = -INFINITY; id[r][s] = 0x7fffffff; }
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;

  // 3xTF32: this lane's ldmatrix row of the warp's 16 query rows, and the
  // swizzled 16-byte chunk of k-step k: (2 k + lane / 16) ^ (lane & 7)
  const unsigned a_row = (16 * warp + (lane & 15)) * SLAB_BYTES;
  const int sw = lane & 7, ha = lane >> 4, t2 = 2 * (lane & 3);
  int slot = 0, ks = 0, l0 = l_begin;
  for (int step = 0; step < n_steps; ++step) {
    // refill the stage released one step ago (its warps are most likely done)
    if (tid == 0 && step >= 1 && step - 1 + STAGES < n_steps) {
      const int prev = step - 1;
      mbar_wait(empty + 8 * (prev % STAGES), (prev / STAGES) & 1);
      fetch(prev + STAGES);
    }
    mbar_wait(full + 8 * slot, (step / STAGES) & 1);   // slab `step` has landed
    const unsigned st = ring + slot * STAGE_BYTES;
    if (BF16) {
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < KSTEPS; ++k)
        wgmma_ss_bf16_n128(acc, desc_sw128(st + (warp >> 2) * 64 * SLAB_BYTES + 32 * k), desc_sw128(st + A_SLAB + 32 * k));
    } else {
      // split the library slab: hi in place, lo beside it (positions, and
      // so the swizzle, unchanged)
      float4* bh = reinterpret_cast<float4*>(smem + (st - base) + A_SLAB);
      float4* bl = bh + B_SLAB / 16;
      for (int i = tid; i < B_SLAB / 16; i += THREADS) {
        const float4 x = bh[i];
        uint32_t h[4], l[4];
        split_tf32(x.x, h[0], l[0]);
        split_tf32(x.y, h[1], l[1]);
        split_tf32(x.z, h[2], l[2]);
        split_tf32(x.w, h[3], l[3]);
        bh[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]), __uint_as_float(h[3]));
        bl[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // generic writes -> wgmma reads
      asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");

      uint32_t ah[KSTEPS][4], al[KSTEPS][4];
#pragma unroll
      for (int k = 0; k < KSTEPS; ++k) {
        uint32_t f[4];
        ldsm_x4(f, st + a_row + (((2 * k + ha) ^ sw) << 4));
#pragma unroll
        for (int j = 0; j < 4; ++j) split_tf32(__uint_as_float(f[j]), ah[k][j], al[k][j]);
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < KSTEPS; ++k) {
        const uint64_t dh = desc_sw128(st + A_SLAB + 32 * k), dl = desc_sw128(st + A_SLAB + B_SLAB + 32 * k);
        wgmma_rs_tf32<128>(acc, al[k], dh);
        wgmma_rs_tf32<128>(acc, ah[k], dl);
        wgmma_rs_tf32<128>(acc, ah[k], dh);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);      // this warp is done with the stage
    slot = slot + 1 == STAGES ? 0 : slot + 1;

    if (++ks == slabs) {   // the tile is complete: fold it
      // Only the chunk's last tile can be partial.
      const bool whole = l0 + LT <= l_end;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + t2 + e;
            float x = acc[4 * j + 2 * h + e];
            if (penalty) x += (l0 + c < l_end) ? __ldg(penalty + l0 + c) : 0.f;
            if (PACKED) x = packed_key(x, c);
            acc[4 * j + 2 * h + e] = x;
            if (whole || l0 + c < l_end) m = fmaxf(m, x);
          }
        if (m >= v[h][K - 1]) {   // some score reaches the k-th best (ties included)
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * j + t2 + e;
              if (whole || l0 + c < l_end) insert<K>(v[h], id[h], acc[4 * j + 2 * h + e], l0 + c);
            }
        }
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
      ks = 0;
      l0 += LT;
    }
  }

  quad_merge<K, 2>(v, id);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + 16 * warp + 8 * r + (lane >> 2);
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

template <int K, bool BF16, bool PACKED>
int launch_tile(const CUtensorMap& tm_src, const CUtensorMap& tm_lib, const float* penalty,
                const int* valid_rows, float* cand_v, int* cand_i, int ls, int lr, int d,
                int rows_per_chunk, int n_chunks, cudaStream_t stream) {
  auto kernel = knn_tile_kernel<K, BF16, PACKED>;
  const size_t smem = 2 * HEAD_BYTES + (size_t)STAGES * (A_SLAB + (BF16 ? 1 : 2) * B_SLAB);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((ls + QT - 1) / QT, n_chunks);
  kernel<<<grid, THREADS, smem, stream>>>(tm_src, tm_lib, penalty, valid_rows, cand_v, cand_i, ls, lr, d,
                                          rows_per_chunk, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch(const void* src, const void* lib, const float* penalty, const int* valid_rows,
           float* cand_v, int* cand_i, float* out_v, int* out_i, int ls, int lr, int d,
           int bf16, int packed, int rows_per_chunk, cudaStream_t stream) {
  const int n_chunks = (lr + rows_per_chunk - 1) / rows_per_chunk;
  if (n_chunks > 65535)   // chunks ride gridDim.y
    return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap tm_src, tm_lib;
  if (!make_map(&tm_src, src, bf16, ls, d, QT) || !make_map(&tm_lib, lib, bf16, lr, d, LT))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (!bf16)
    rc = launch_tile<K, false, false>(tm_src, tm_lib, penalty, valid_rows, cand_v, cand_i, ls, lr, d,
                                      rows_per_chunk, n_chunks, stream);
  else if (packed)
    rc = launch_tile<K, true, true>(tm_src, tm_lib, penalty, valid_rows, cand_v, cand_i, ls, lr, d,
                                    rows_per_chunk, n_chunks, stream);
  else
    rc = launch_tile<K, true, false>(tm_src, tm_lib, penalty, valid_rows, cand_v, cand_i, ls, lr, d,
                                     rows_per_chunk, n_chunks, stream);
  if (rc != 0) return rc;
  knn_merge_kernel<K><<<(ls + 7) / 8, 256, 0, stream>>>(cand_v, cand_i, out_v, out_i, ls, n_chunks);
  RETURN_LAUNCH_STATUS();
}

}  // namespace

// src [ls, d], lib [lr, d]: bf16 when bf16 != 0, else float32; d a multiple
// of 64, both 16-byte aligned.  penalty: float32 [lr] or null.  valid_rows:
// one int32 on the device or null (rows >= min(lr, *valid_rows) are
// excluded).  packed != 0 (bf16 only) selects the packed extraction.
// cand_v/cand_i [ls, ceil(lr / rows_per_chunk), kk], out_v/out_i [ls, kk]
// with kk = 4 or 8 (the caller keeps the first k columns); rows_per_chunk a
// multiple of 128.
extern "C" int knn_topk(const void* src, const void* lib, const void* penalty,
                        const void* valid_rows, void* cand_v, void* cand_i, void* out_v,
                        void* out_i, int ls, int lr, int d, int kk, int bf16, int packed,
                        int rows_per_chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pen = static_cast<const float*>(penalty);
  const int* vr = static_cast<const int*>(valid_rows);
  float* cv = static_cast<float*>(cand_v);
  int* ci = static_cast<int*>(cand_i);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  if ((packed && !bf16) || d % 64 || rows_per_chunk % LT || ls < 1 || lr < 1 ||
      (reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(lib)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kk == 4)
    return launch<4>(src, lib, pen, vr, cv, ci, ov, oi, ls, lr, d, bf16, packed, rows_per_chunk, s);
  if (kk == 8)
    return launch<8>(src, lib, pen, vr, cv, ci, ov, oi, ls, lr, d, bf16, packed, rows_per_chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
