// Shared helpers of the port's kernels: storage-type conversion and the
// exact-erf GELU.  Every kernel keeps its arithmetic in float32 registers;
// tensors are stored as float or __nv_bfloat16.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// torch F.gelu default (approximate='none'): 0.5 x (1 + erf(x / sqrt 2))
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// The C entry points return the launch's error code (0 when the launch was
// accepted); the Python wrapper raises on anything else.
#define RETURN_LAUNCH_STATUS() return static_cast<int>(cudaGetLastError())
