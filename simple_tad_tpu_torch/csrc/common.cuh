// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel is reached through a plain C entry point (extern "C") that
// takes raw device pointers, sizes as int and the caller's CUDA stream, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.  No entry point allocates or synchronises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stt {

// dtype codes shared with simple_tad_tpu_torch/kernels/build.py
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

}  // namespace stt
