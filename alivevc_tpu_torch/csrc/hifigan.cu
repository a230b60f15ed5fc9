// One dilated conv of a HiFi-GAN ResBlock1 stack, channels last, with the
// elementwise work around it: out = conv(leaky_relu(x)) + bias, and for the
// second conv of a pair + the residual (the pair's input), and for the
// second conv of a stack's last pair the stage's stack sum, in
// models/hifigan.py's order ((rb0 + rb1) + rb2) / stacks.
//
// Replaces: no TPU kernel (the JAX package has no kNN-VC vocoder).  It
// replaces cuDNN's float32 SIMT convolutions of the kNN-VC vocoder's
// ResBlocks (F.conv1d under device.float32_math, with two leaky_relu passes
// and a residual add a pair and the stack sum and divide a stage around
// them): 72 convs a call, 93 % of the vocoder's operations.
//
// What bounds it on an H100: the products are float32-exact, 3xTF32 on
// wgmma (lo.hi + hi.lo + hi.hi, float32 accumulation; kernels/filter.py:
// product_3xtf32 emulates the split), whose ceiling is 495 / 3 = 165
// TFLOP/s.  A conv does 2 k C^2 operations a row and moves 2-4 rows of C
// floats (x, out, the residual, the stack sum): ~2 k C / 4 operations a
// byte.  At C = 256 and 128 that is 180-1 400: operations bound it.  At
// C = 64 and 32 it is 23-350, around the 3xTF32 ridge of ~49 operations a
// byte (165 TFLOP/s over 3.35 TB/s): bytes bound the 3-tap convs there,
// operations the 7- and 11-tap ones.
//
// Design.  A block owns TM = 64 or 128 rows of one file (one or two
// warpgroups, 64 rows each) x TN = min(C, 128) output channels, and walks
// K as chunks of 32 input channels (128 bytes), every tap of a chunk
// before the next chunk.  Each (chunk, tap) is one step of 4 wgmma k-steps
// of 8 TF32 values:
//   - A (the activation) from registers.  The chunk's rows t0 - pad ..
//     t0 + TM + pad arrive whole by one 3-D TMA box (128-byte swizzle; rows
//     outside [0, L) of the file zero-filled, which is the conv's zero
//     padding of the activated input, since leaky(0) = 0), two chunks in
//     flight.  Tap j starts j * d rows down, which a swizzled descriptor
//     cannot start on, so ldmatrix loads each warp's m16 fragment at any
//     row, its lanes' 16-byte pieces un-swizzled by address; the leaky
//     ReLU and the TF32 hi/lo split happen in registers before the product.
//   - B (the weights, K-major [C_out][(tap, C_in)], split into TF32 hi and
//     lo planes once a vocoder by the wrapper) by 2-D TMA boxes of TN rows
//     x 128 bytes, 128-byte swizzle, into a ring of 2-4 stages read by
//     descriptor.  Two steps are in flight (two register sets of fragments);
//     the last warp done with a stage or an A buffer refills it (an integer
//     count each, no warp waits for another, no producer warp).
//   - Epilogue: after a block barrier each warp stages its 16 rows of the
//     accumulators + bias in the idle ring, 64 columns at a time, and reads
//     them back a row piece at a time with 16-byte accesses (whole 128-byte
//     lines) to add the residual and the stack sum (the first stack writes
//     it, the others add to it, the last divides), each float32 operation
//     in the plain version's order.
// The plan (kernels/hifigan.py:conv_plan) reads C, the taps and the length:
// TN from C, two warpgroups a block where the tiles of 128 rows fill the
// card, and the ring's depth from the steps a tile has.  The grid is one
// block a tile, column tile fastest, so blocks that share rows run together.

#include "common.cuh"

#include <algorithm>
#include <cstdint>

namespace {

constexpr int CHUNK = 32;                 // input channels a K chunk: 128 bytes of float32
constexpr int CHUNK_BYTES = CHUNK * 4;
constexpr int KSTEPS = CHUNK_BYTES / 32;  // 8-value TF32 k-steps a chunk
constexpr int HEAD = 1024;                // mbarriers and counters; the ring starts 1024-aligned (swizzle)
constexpr int MAX_STAGES = 4;
constexpr int MAX_ROWS = 256;             // rows a TMA box
constexpr int SMEM_MAX = 232448;          // dynamic shared memory a block may take
constexpr int PIECE = 64;                 // columns of the epilogue's staged rows at a time

struct ConvArgs {
  const float* bias;   // [C]
  const float* res;    // [n, L, C] or null
  float* out;          // [n, L, C]: the conv's output, or the stack sum
  float slope;
  int L, C, taps, d;
  int stack, stacks;   // -1: no stack sum; else this stack's index of `stacks`
  int tiles_w, col_tiles;
  int stages, a_buf;   // ring depth; bytes an A buffer (1024-aligned)
};

__device__ __forceinline__ float leaky(float v, float slope) { return v > 0.f ? v : v * slope; }

template <int TN>
__global__ void __launch_bounds__(256, 1)
hifigan_conv_kernel(const __grid_constant__ CUtensorMap m_x, const __grid_constant__ CUtensorMap w_hi,
                    const __grid_constant__ CUtensorMap w_lo, const ConvArgs p) {
  constexpr int SLAB = TN * CHUNK_BYTES;   // one weight box: TN output channels x 128 bytes
  constexpr int STAGE = 2 * SLAB;          // the TF32 hi box, then the lo box
  static_assert(TN == 32 || TN == 64 || TN == 128, "column tile");
  extern __shared__ unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = (int)blockDim.x / 32;
  const int tm = (int)blockDim.x / 2;      // 64 rows a warpgroup of 128 threads
  const unsigned raw_addr = smem_u32(smem_raw);
  const unsigned base = (raw_addr + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw_addr);
  const unsigned full = base, afull = base + 8 * MAX_STAGES;   // the ring's and the A buffers' mbarriers
  unsigned* released = reinterpret_cast<unsigned*>(smem + 256);   // warps done with each stage
  unsigned* a_released = released + MAX_STAGES;                    // ... with each A buffer
  const unsigned ring = base + HEAD;
  const unsigned abuf = ring + p.stages * STAGE;

  const int tile = (int)blockIdx.x;
  const int rt = tile / p.col_tiles, ct = tile - rt * p.col_tiles;
  const int n = rt / p.tiles_w, t0 = (rt - n * p.tiles_w) * tm, n0 = ct * TN;
  const int chunks = p.C / CHUNK, steps = chunks * p.taps;
  const int rows = tm + (p.taps - 1) * p.d, pad = (p.taps - 1) / 2 * p.d;

  // weight slab of step s (chunk s / taps, tap s % taps) -> its stage
  auto fetch = [&](int s) {
    const int slot = s % p.stages, c = s / p.taps;
    const int x = (s - c * p.taps) * p.C + c * CHUNK;
    const unsigned bar = full + 8 * slot, st = ring + slot * STAGE;
    mbar_expect_tx(bar, STAGE);
    tma_load(st, w_hi, x, n0, bar);
    tma_load(st + SLAB, w_lo, x, n0, bar);
  };
  // chunk c's input rows t0 - pad .. t0 + tm + pad -> A buffer c & 1
  auto fetch_a = [&](int c) {
    const unsigned bar = afull + 8 * (c & 1);
    mbar_expect_tx(bar, rows * CHUNK_BYTES);
    tma_load_3d(abuf + (c & 1) * p.a_buf, m_x, c * CHUNK, t0 - pad, n, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < MAX_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      released[s] = 0;
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(afull + 8 * b, 1);
      a_released[b] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // the barriers are initialised
  if (tid == 0) {
    fetch_a(0);
    if (chunks > 1) fetch_a(1);
    for (int s = 0; s < min(p.stages, steps); ++s) fetch(s);
  }

  // this thread's fragment rows: the warp's 16 rows of its warpgroup's 64
  const int wrow = (warp >> 2) * 64 + (warp & 3) * 16;
  const int g = lane >> 2, t4 = lane & 3;
  const int lrow = wrow + (lane & 15), lhalf = lane >> 4;   // the lane's ldmatrix row and 16-byte half
  // The first wgmma of the tile overwrites the accumulators (scale-d 0): no
  // other instruction writes them while products are in flight, which would
  // make ptxas serialise the wgmmas
  float acc[TN / 2];
#pragma unroll
  for (int e = 0; e < TN / 2; ++e) acc[e] = 0.f;

  // this warp is done reading A buffer c & 1; the last warp refills it with chunk c + 2
  auto release_a = [&](int c) {
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&a_released[c & 1], 1u) == (unsigned)(warps - 1)) {
        a_released[c & 1] = 0;
        __threadfence_block();
        if (c + 2 < chunks) {
          fence_async_shared();
          fetch_a(c + 2);
        }
      }
    }
    __syncwarp();
  };
  // this warp is done with weight step s; the last warp refills the stage
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) {
      const int slot = s % p.stages;
      __threadfence_block();
      if (atomicAdd(&released[slot], 1u) == (unsigned)(warps - 1)) {
        released[slot] = 0;
        __threadfence_block();
        if (s + p.stages < steps) {
          fence_async_shared();
          fetch(s + p.stages);
        }
      }
    }
    __syncwarp();   // the warp whole again before its ldmatrix and wgmma
  };
  // step s's A fragments: the rows of tap j, leaky, split into TF32 hi and lo
  auto load_step = [&](int s, uint32_t (&aa)[KSTEPS][4], uint32_t (&ll)[KSTEPS][4]) {
    const int c = s / p.taps, j = s - c * p.taps;
    if (j == 0) mbar_wait(afull + 8 * (c & 1), (unsigned)((c >> 1) & 1));
    mbar_wait(full + 8 * (s % p.stages), (unsigned)((s / p.stages) & 1));
    const int r = lrow + j * p.d;
    const unsigned row = abuf + (c & 1) * p.a_buf + r * CHUNK_BYTES;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      ldsm_x4(aa[ks], row + ((((2 * ks + lhalf) ^ (r & 7))) << 4));   // the 128-byte swizzle undone
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(leaky(__uint_as_float(aa[ks][e]), p.slope), aa[ks][e], ll[ks][e]);
    }
    if (j == p.taps - 1) release_a(c);
  };
  auto issue = [&](int s, uint32_t (&aa)[KSTEPS][4], uint32_t (&ll)[KSTEPS][4]) {
    const unsigned st = ring + (s % p.stages) * STAGE;
    const int sd = s != 0;   // 0: the tile's first k-step
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const uint64_t dh = desc_sw128(st + 32 * ks), dl = desc_sw128(st + SLAB + 32 * ks);
      wgmma_rs_tf32<TN>(acc, ll[ks], dh, ks ? 1 : sd);
      wgmma_rs_tf32<TN>(acc, aa[ks], dl);
      wgmma_rs_tf32<TN>(acc, aa[ks], dh);
    }
    wgmma_commit();
  };

  // Two steps in flight: step s + 1's fragments load into the other
  // register set while step s multiplies; a set is rewritten only after the
  // products that read it are done (wait_group 1)
  uint32_t a0[KSTEPS][4], lo0[KSTEPS][4], a1[KSTEPS][4], lo1[KSTEPS][4];
  load_step(0, a0, lo0);
#pragma unroll 1
  for (int s = 0; s < steps; s += 2) {
    issue(s, a0, lo0);
    if (s + 1 < steps) {
      if (s >= 1) {
        wgmma_wait<1>();   // step s - 1 is done: set 1 and its stage are free
        release(s - 1);
      }
      load_step(s + 1, a1, lo1);
      issue(s + 1, a1, lo1);
      if (s + 2 < steps) {
        wgmma_wait<1>();   // step s is done: set 0 and its stage are free
        release(s);
        load_step(s + 2, a0, lo0);
      }
    }
  }
  wgmma_wait<0>();   // the last two steps need no refill: the ring holds at least two

  __syncthreads();   // every warp's products are done: the ring and the A buffers hold nothing more

  // Epilogue through the warp's 16 rows staged in the ring, PW columns at a
  // time: the accumulators + bias (acc[4 jb + 2 h + e] is row g + 8 h,
  // column 8 jb + 2 t4 + e), then each row piece with 16 bytes a lane
  // (whole 128-byte lines): + the residual, the stack sum, each float32
  // operation in the plain version's order
  constexpr int PW = TN < PIECE ? TN : PIECE;   // columns staged at a time
  constexpr int LDS = PW + 4;                   // floats a staged row (16-byte aligned, banks spread)
  constexpr int VR = PW / 4, RPI = 32 / VR;     // 16-byte vectors a piece row; rows an instruction
  float* stg = reinterpret_cast<float*>(smem + HEAD) + warp * 16 * LDS;
  const bool last = p.stack >= 0 && p.stack == p.stacks - 1;
  const float stacks = (float)p.stacks;
  const int v = lane % VR;
#pragma unroll
  for (int c0 = 0; c0 < TN; c0 += PW) {
#pragma unroll
    for (int jb = c0 / 8; jb < (c0 + PW) / 8; ++jb) {
      const int c = 8 * jb + 2 * t4;
      const float2 b = __ldg(reinterpret_cast<const float2*>(p.bias + n0 + c));
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(stg + (g + 8 * h) * LDS + c - c0) =
            make_float2(acc[4 * jb + 2 * h] + b.x, acc[4 * jb + 2 * h + 1] + b.y);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 16 / RPI; ++i) {
      const int r = RPI * i + lane / VR, t = t0 + wrow + r;
      if (t >= p.L) continue;
      float4 y = *reinterpret_cast<const float4*>(stg + r * LDS + 4 * v);
      const size_t o = ((size_t)n * p.L + t) * p.C + n0 + c0 + 4 * v;
      if (p.res != nullptr) {   // x + conv(...)
        const float4 u = *reinterpret_cast<const float4*>(p.res + o);
        y = make_float4(u.x + y.x, u.y + y.y, u.z + y.z, u.w + y.w);
      }
      if (p.stack > 0) {        // xs + rb
        const float4 u = *reinterpret_cast<const float4*>(p.out + o);
        y = make_float4(u.x + y.x, u.y + y.y, u.z + y.z, u.w + y.w);
      }
      if (last)                 // xs / stacks, a division as the plain version's
        y = make_float4(y.x / stacks, y.y / stacks, y.z / stacks, y.w / stacks);
      *reinterpret_cast<float4*>(p.out + o) = y;
    }
    __syncwarp();   // the staged rows are read before they are written again
  }
}

int align_up(int b, int a) { return (b + a - 1) / a * a; }
bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

// bytes of dynamic shared memory a launch takes: alignment slack, the
// barriers, the ring and the A buffers, which the epilogue's staged rows
// reuse
int conv_smem(int tn, int wgs, int taps, int d, int stages, int chunks) {
  const int a_buf = align_up((64 * wgs + (taps - 1) * d) * CHUNK_BYTES, 1024);
  const int staged = 4 * wgs * 16 * (std::min(tn, PIECE) + 4) * 4;
  return 1024 + HEAD + std::max(stages * tn * CHUNK_BYTES * 2 + std::min(chunks, 2) * a_buf, staged);
}

template <int TN>
int launch_conv(const CUtensorMap (&maps)[3], const ConvArgs& p, int tiles, int wgs, int smem, cudaStream_t stream) {
  auto kernel = hifigan_conv_kernel<TN>;
  int dev = 0;
  cudaGetDevice(&dev);
  static int smem_set[64] = {};   // the limit raised once a card to the most a launch asks
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = smem;
  }
  kernel<<<tiles, 128 * wgs, smem, stream>>>(maps[0], maps[1], maps[2], p);
  RETURN_LAUNCH_STATUS();
}

}  // namespace

// out = conv(leaky_relu(x, slope)) + bias (+ res), or the stack sum: x, res
// and out [n, L, C] float32, channels last; w_hi and w_lo the weights
// K-major, [C][taps * C], as TF32 hi and lo planes; a 'same' conv of odd
// `taps` at dilation d (zero padding (taps - 1) / 2 * d on each side).
// stack < 0: out is written; stack = 0 of `stacks`: out (the stack sum) is
// written; 0 < stack: out += the value, and the last stack divides the sum
// by `stacks`.  The plan (kernels/hifigan.py:conv_plan): tn output columns
// a tile (32, 64, 128, dividing C), wgs warpgroups (64 rows each), stages
// of the weight ring (2-4; 1 only where the conv is one step).  C a
// multiple of 32, at most 256; every pointer 16-byte aligned.
extern "C" int hifigan_conv(const void* x, const void* w_hi, const void* w_lo, const void* bias, const void* res,
                            void* out, int n, int L, int C, int taps, int d, float slope, int stack, int stacks,
                            int tn, int wgs, int stages, void* stream) {
  const int chunks = C / CHUNK, steps = chunks * taps, rows = 64 * wgs + (taps - 1) * d;
  if (n < 1 || L < 1 || C < CHUNK || C % CHUNK || C > 256 || taps < 1 || taps % 2 == 0 || d < 1 ||
      rows > MAX_ROWS || (wgs != 1 && wgs != 2) || (tn != 32 && tn != 64 && tn != 128) || C % tn ||
      stages < 1 || stages > MAX_STAGES || stages > steps || (steps > 1 && stages < 2) || stacks < 1 ||
      stack < -1 || stack >= stacks || misaligned(x) || misaligned(w_hi) || misaligned(w_lo) ||
      misaligned(bias) || misaligned(res) || misaligned(out) || (long long)n * L * C > 0x7fffffffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = conv_smem(tn, wgs, taps, d, stages, chunks);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs p{};
  p.bias = static_cast<const float*>(bias);
  p.res = static_cast<const float*>(res);
  p.out = static_cast<float*>(out);
  p.slope = slope;
  p.L = L; p.C = C; p.taps = taps; p.d = d;
  p.stack = stack; p.stacks = stacks;
  p.tiles_w = (L + 64 * wgs - 1) / (64 * wgs);
  p.col_tiles = C / tn;
  p.stages = stages;
  p.a_buf = align_up(rows * CHUNK_BYTES, 1024);
  const long long tiles = (long long)n * p.tiles_w * p.col_tiles;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // maps: the input as [n][L][C] boxes of rows x 32 channels; the weight planes
  CUtensorMap maps[3];
  if (!make_map_3d(&maps[0], x, false, C, L, n, CHUNK, rows, 128) ||
      !make_map(&maps[1], w_hi, false, C, taps * C, tn) || !make_map(&maps[2], w_lo, false, C, taps * C, tn))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tn) {
    case 32: return launch_conv<32>(maps, p, (int)tiles, wgs, smem, s);
    case 64: return launch_conv<64>(maps, p, (int)tiles, wgs, smem, s);
    default: return launch_conv<128>(maps, p, (int)tiles, wgs, smem, s);
  }
}
