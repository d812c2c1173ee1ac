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

// Static symmetric int8 code of y: clip(round_half_even(y * inv), +-127),
// with inv = 127 / amax (jnp.round and torch.round round half to even, as
// __float2int_rn does; the product is rounded once, never fused).
__device__ __forceinline__ int8_t quant_i8(float y, float inv) {
  const int q = __float2int_rn(__fmul_rn(y, inv));
  return static_cast<int8_t>(q < -127 ? -127 : (q > 127 ? 127 : q));
}

// 127 / max(amax, 1e-12) from a device-side amax, as the plain versions
// compute it (IEEE division)
__device__ __forceinline__ float quant_inv(const float* amax) {
  return 127.f / fmaxf(*amax, 1e-12f);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (16x8, fp32) += A (16x16, bf16, row-major) * B (16x8, bf16, col-major)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy a (ROWS x DP) bf16 tile, rows starting at row0 of a strided source,
// into shared memory in 16-byte chunks, THREADS threads striding.  Rows >= n
// and columns >= d read as zero.  With TRANSPOSE, element (r, c) lands at
// dst[c * ld + r].  With SCALE every value is multiplied by qscale in fp32
// and rounded back.
template <int DP, int ROWS, bool TRANSPOSE, bool SCALE, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src, int row0,
                                          int n, int d, int row_stride,
                                          float qscale) {
  constexpr int kChunks = DP / 8;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += THREADS) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n && col < d) {
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * row_stride + col);
    }
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
    if (SCALE) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * qscale);
      }
    }
    if (TRANSPOSE) {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[(col + i) * ld + r] = e[i];
    } else {
      *reinterpret_cast<uint4*>(dst + r * ld + col) = val;
    }
  }
}

}  // namespace stt
