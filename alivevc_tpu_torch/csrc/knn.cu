// Cosine top-k of every query row against a library: tile scores + exact
// per-block top-k (pass A), then an exact merge of the per-block winners
// (pass B).
//
// Replaces: alivevc_tpu/kernels/knn_twopass.py:knn_topk_twopass (pass A
// _tile_kernel / _tile_kernel_exact, pallas_call at :331/:344/:395; pass B
// _merge_packed_kernel :372 and _merge_exact :195) and
// alivevc_tpu/kernels/knn_pallas.py:knn_topk_pallas (the carried kernel,
// pallas_call at :331, used below 4096 library rows).  One kernel pair
// serves any library of at least k rows.
//
// Inputs arrive L2-normalised (x * rsqrt(max(sum x^2, 1e-30)), done in
// float32 by the wrapper) and, for precision 'default', rounded to bf16.
// Scores: bf16 operands on the tensor cores (WMMA 16x16x16, float32
// accumulation) for 'default'; float32 FMA for 'high'/'highest', so the
// ranking is that of float32 scores.  Ties go to the smallest library index.
//
// Row exclusion (the sharded path's shard padding): rows at index >=
// min(lr, valid_rows) are never loaded and never win, in every mode; the
// count may live on the device (read by the kernel, no host sync).  An
// optional float32 penalty[l] is added to each score after the product
// (JAX appends it as an operand column, knn_twopass.py:238-242, so its
// 'default' mode rounds it to bf16).  With fewer valid rows than k the
// missing places keep the sentinel (-inf, 0x7fffffff).
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
// against 154 MB (bf16) of library; the top-k extraction is a few compare
// and swap steps per score.  The design keeps the [Ls, Lr] score matrix out
// of device memory: a block of 256 threads owns 64 queries and a chunk of
// 16 x 128 library rows, computes each 64 x 128 score tile into shared
// memory, and four threads per query fold the tile into a sorted top-k held
// in registers.  Blocks run in no order, so there is no carry across the
// library: each (query tile, chunk) block writes its k winners and pass B
// merges the n_chunks * k candidates per query.  Operand tiles are reloaded
// from L2 without double buffering; wgmma and TMA are later work.

#include "common.cuh"
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int QT = 64;        // queries per block
constexpr int LT = 128;       // library rows per score tile
constexpr int SC_LD = 132;    // score tile row stride (floats)
constexpr int BK16 = 32;      // bf16 k-step
constexpr int BKP = BK16 + 8; // padded bf16 row (elements)
constexpr int BK32 = 16;      // float32 k-step

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

// 64 x 128 score tile on the tensor cores: Sc[q][l] = src[q0+q] . lib[l0+l]
__device__ __forceinline__ void scores_bf16(const __nv_bfloat16* __restrict__ src,
                                            const __nv_bfloat16* __restrict__ lib,
                                            int ls, int lr, int d, int q0, int l0,
                                            unsigned char* smem) {  // rows >= lr read as 0
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [QT][BKP]
  __nv_bfloat16* Bs = As + QT * BKP;                            // [LT][BKP]
  float* Sc = reinterpret_cast<float*>(smem);                   // aliases As/Bs
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp % 4;   // rows wr*16 .. +16
  const int wc = warp / 4;   // cols wc*64 .. +64

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int k0 = 0; k0 < d; k0 += BK16) {
    {
      const int r = tid / 4, c8 = (tid % 4) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (q0 + r < ls) v = *reinterpret_cast<const uint4*>(src + (size_t)(q0 + r) * d + k0 + c8);
      *reinterpret_cast<uint4*>(As + r * BKP + c8) = v;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = tid + 256 * q;
      const int r = e / 4, c8 = (e % 4) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (l0 + r < lr) v = *reinterpret_cast<const uint4*>(lib + (size_t)(l0 + r) * d + k0 + c8);
      *reinterpret_cast<uint4*>(Bs + r * BKP + c8) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, As + (wr * 16) * BKP + kk, BKP);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, Bs + (wc * 64 + j * 16) * BKP + kk, BKP);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(Sc + (wr * 16) * SC_LD + wc * 64 + j * 16, acc[j], SC_LD,
                            wmma::mem_row_major);
}

// 64 x 128 score tile in float32 FMA: each thread owns 4 queries x 8 rows.
__device__ __forceinline__ void scores_f32(const float* __restrict__ src,
                                           const float* __restrict__ lib,
                                           int ls, int lr, int d, int q0, int l0,
                                           unsigned char* smem) {
  float* As = reinterpret_cast<float*>(smem);   // [BK32][QT + 4]
  float* Bs = As + BK32 * (QT + 4);             // [BK32][LT + 4]
  float* Sc = reinterpret_cast<float*>(smem);   // aliases As/Bs
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK32) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + 256 * q;
      const int r = e / BK32, kk = e % BK32;
      As[kk * (QT + 4) + r] = (q0 + r < ls) ? src[(size_t)(q0 + r) * d + k0 + kk] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = tid + 256 * q;
      const int c = e / BK32, kk = e % BK32;
      Bs[kk * (LT + 4) + c] = (l0 + c < lr) ? lib[(size_t)(l0 + c) * d + k0 + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK32; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(As + kk * (QT + 4) + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * (LT + 4) + tx * 8);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * (LT + 4) + tx * 8 + 4);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) Sc[(ty * 4 + i) * SC_LD + tx * 8 + j] = acc[i][j];
}

// The ranking key of the packed extraction (see the header).
__device__ __forceinline__ float packed_key(float s, int c) {
  const unsigned bits = __float_as_uint(s + 2.0f);
  return __uint_as_float((bits & ~127u) | (127u - (unsigned)c));
}

template <int K, bool BF16, bool PACKED>
__global__ void __launch_bounds__(256)
knn_tile_kernel(const void* __restrict__ src, const void* __restrict__ lib,
                const float* __restrict__ penalty, const int* __restrict__ valid_rows,
                float* __restrict__ cand_v, int* __restrict__ cand_i,
                int ls, int lr, int d, int rows_per_chunk) {
  __shared__ __align__(128) unsigned char smem[QT * SC_LD * sizeof(float)];
  const float* Sc = reinterpret_cast<const float*>(smem);
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const int row = threadIdx.x / 4, part = threadIdx.x % 4;

  float v[K];
  int id[K];
#pragma unroll
  for (int s = 0; s < K; ++s) { v[s] = -INFINITY; id[s] = 0x7fffffff; }

  // rows at index >= lv are excluded
  const int lv = valid_rows ? min(lr, max(0, *valid_rows)) : lr;
  const int l_begin = chunk * rows_per_chunk;
  const int l_end = min(lv, l_begin + rows_per_chunk);
  for (int l0 = l_begin; l0 < l_end; l0 += LT) {
    if (BF16)
      scores_bf16(static_cast<const __nv_bfloat16*>(src), static_cast<const __nv_bfloat16*>(lib),
                  ls, lv, d, q0, l0, smem);
    else
      scores_f32(static_cast<const float*>(src), static_cast<const float*>(lib),
                 ls, lv, d, q0, l0, smem);
    __syncthreads();
    const int n_valid = min(LT, l_end - l0);
    for (int c = part; c < n_valid; c += 4) {
      float sc = Sc[row * SC_LD + c];
      if (penalty) sc += penalty[l0 + c];
      if (PACKED) sc = packed_key(sc, c);
      insert<K>(v, id, sc, l0 + c);
    }
    __syncthreads();
  }

  // the four threads of a query hold disjoint candidates: merge them
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
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
  const int q = q0 + row;
  if (part == 0 && q < ls) {
    const size_t base = ((size_t)chunk * ls + q) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      // key - 2 is exact, so the merge keeps the packed order
      cand_v[base + s] = PACKED ? v[s] - 2.0f : v[s];
      cand_i[base + s] = id[s];
    }
  }
}

template <int K>
__global__ void __launch_bounds__(256)
knn_merge_kernel(const float* __restrict__ cand_v, const int* __restrict__ cand_i,
                 float* __restrict__ out_v, int* __restrict__ out_i, int ls, int n_chunks) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= ls) return;
  float v[K];
  int id[K];
#pragma unroll
  for (int s = 0; s < K; ++s) { v[s] = -INFINITY; id[s] = 0x7fffffff; }
  for (int c = 0; c < n_chunks; ++c) {
    const size_t base = ((size_t)c * ls + q) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) insert<K>(v, id, cand_v[base + s], cand_i[base + s]);
  }
#pragma unroll
  for (int s = 0; s < K; ++s) { out_v[(size_t)q * K + s] = v[s]; out_i[(size_t)q * K + s] = id[s]; }
}

template <int K>
int launch(const void* src, const void* lib, const float* penalty, const int* valid_rows,
           float* cand_v, int* cand_i, float* out_v, int* out_i, int ls, int lr, int d,
           int bf16, int packed, int rows_per_chunk, cudaStream_t stream) {
  const int n_chunks = (lr + rows_per_chunk - 1) / rows_per_chunk;
  dim3 grid(n_chunks, (ls + QT - 1) / QT);
  if (bf16 && packed)
    knn_tile_kernel<K, true, true><<<grid, 256, 0, stream>>>(src, lib, penalty, valid_rows, cand_v,
                                                             cand_i, ls, lr, d, rows_per_chunk);
  else if (bf16)
    knn_tile_kernel<K, true, false><<<grid, 256, 0, stream>>>(src, lib, penalty, valid_rows, cand_v,
                                                              cand_i, ls, lr, d, rows_per_chunk);
  else
    knn_tile_kernel<K, false, false><<<grid, 256, 0, stream>>>(src, lib, penalty, valid_rows, cand_v,
                                                               cand_i, ls, lr, d, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_merge_kernel<K><<<(ls + 255) / 256, 256, 0, stream>>>(cand_v, cand_i, out_v, out_i, ls,
                                                             n_chunks);
  RETURN_LAUNCH_STATUS();
}

}  // namespace

// src [ls, d], lib [lr, d]: bf16 when bf16 != 0, else float32; d a multiple
// of 32.  penalty: float32 [lr] or null.  valid_rows: one int32 on the
// device or null (rows >= min(lr, *valid_rows) are excluded).  packed != 0
// (bf16 only) selects the packed extraction.  cand_v/cand_i
// [ceil(lr / rows_per_chunk), ls, kk], out_v/out_i [ls, kk] with kk = 4 or
// 8 (the caller keeps the first k columns); rows_per_chunk a multiple of
// 128.
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
  if (packed && !bf16) return static_cast<int>(cudaErrorInvalidValue);
  if (kk == 4)
    return launch<4>(src, lib, pen, vr, cv, ci, ov, oi, ls, lr, d, bf16, packed, rows_per_chunk, s);
  if (kk == 8)
    return launch<8>(src, lib, pen, vr, cv, ci, ov, oi, ls, lr, d, bf16, packed, rows_per_chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
