// Row LayerNorm over the last axis (kernel A2).
//
// Replaces the TPU kernel simple_tad_tpu/ops/ln.py:_ln_kernel (launched by
// fused_layernorm -> _fused_ln_impl).  Same numerics: fp32 mean, fp32
// biased variance of the centred values (mean(xc * xc), not E[x^2] - m^2),
// rsqrt(var + eps), fp32 affine, one cast to the output dtype.
//
// What bounds it on the H100: bytes.  A row of C values is read once and
// written once (rows * C * (in + out) bytes) against a handful of flops per
// element, far below the ~295 flop/byte at which the tensor cores would
// become the limit.  The design therefore reads x from device memory
// exactly once, in 16-byte loads: one thread block per row, each thread
// keeping one 8-value chunk of the row in registers (C % 8 == 0, the ViT
// widths), so the centred second pass and the affine pass touch no memory.
// Other widths take a fallback that stages the row in shared memory as
// fp32 (C <= 4096, at most 16 KB).  Block-wide sums go through warp
// shuffles.  Rows are many (32 * 1568 at ViT-B batch 32) and blocks small,
// so the 132 SMs stay full.
#include "common.cuh"

namespace {

constexpr int kMaxCols = 4096;

// Sum of v over the block; every thread gets the result.  blockDim.x must
// be a multiple of 32.  red holds 33 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nwarps ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

template <typename TIn, typename TOut>
__global__ void layernorm_kernel(const TIn* __restrict__ x,
                                 const float* __restrict__ w,
                                 const float* __restrict__ b,
                                 TOut* __restrict__ y, int cols, float eps) {
  extern __shared__ float row[];  // cols floats
  __shared__ float red[33];
  const size_t base = static_cast<size_t>(blockIdx.x) * cols;
  const TIn* xr = x + base;
  TOut* yr = y + base;

  float s = 0.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const float v = stt::to_float(xr[c]);
    row[c] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / static_cast<float>(cols);

  float ss = 0.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const float d = row[c] - mean;
    ss += d * d;
  }
  const float var = block_sum(ss, red) / static_cast<float>(cols);
  const float inv = rsqrtf(var + eps);

  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const float v = (row[c] - mean) * inv * w[c] + b[c];
    yr[c] = stt::from_float<TOut>(v);
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
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
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// cols % 8 == 0, 16-byte aligned: thread t owns columns [8t, 8t + 8)
template <typename TIn, typename TOut>
__global__ void layernorm_vec8_kernel(const TIn* __restrict__ x,
                                      const float* __restrict__ w,
                                      const float* __restrict__ b,
                                      TOut* __restrict__ y, int cols,
                                      float eps) {
  __shared__ float red[33];
  const size_t base = static_cast<size_t>(blockIdx.x) * cols;
  const int c0 = threadIdx.x * 8;
  const bool active = c0 < cols;
  float v[8];
  float s = 0.f;
  if (active) {
    load8(x + base + c0, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += v[i];
  }
  const float mean = block_sum(s, red) / static_cast<float>(cols);
  float ss = 0.f;
  if (active) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] -= mean;
      ss += v[i] * v[i];
    }
  }
  const float var = block_sum(ss, red) / static_cast<float>(cols);
  const float inv = rsqrtf(var + eps);
  if (active) {
    float wv[8], bv[8];
    load8(w + c0, wv);
    load8(b + c0, bv);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = v[i] * inv * wv[i] + bv[i];
    store8(y + base + c0, v);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename TIn, typename TOut>
void launch(const void* x, const void* w, const void* b, void* y, int rows,
            int cols, float eps, cudaStream_t stream) {
  const TIn* xt = static_cast<const TIn*>(x);
  const float* wt = static_cast<const float*>(w);
  const float* bt = static_cast<const float*>(b);
  TOut* yt = static_cast<TOut*>(y);
  if (cols % 8 == 0 && aligned16(x) && aligned16(w) && aligned16(b) &&
      aligned16(y)) {
    const int threads = (cols / 8 + 31) / 32 * 32;   // <= 512 for C <= 4096
    layernorm_vec8_kernel<TIn, TOut><<<rows, threads, 0, stream>>>(
        xt, wt, bt, yt, cols, eps);
    return;
  }
  // about four values per thread, whole warps, at most 1024 threads
  int threads = ((cols + 3) / 4 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t smem = static_cast<size_t>(cols) * sizeof(float);
  layernorm_kernel<TIn, TOut><<<rows, threads, smem, stream>>>(
      xt, wt, bt, yt, cols, eps);
}

}  // namespace

// x (rows, cols) in in_dtype, w and b (cols,) fp32 -> y (rows, cols) in
// out_dtype.  All contiguous.
extern "C" int stt_layernorm(const void* x, const void* w, const void* b,
                             void* y, int rows, int cols, float eps,
                             int in_dtype, int out_dtype, void* stream) {
  if (rows <= 0 || cols <= 0 || cols > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const bool in_bf = in_dtype == stt::kBFloat16;
  const bool out_bf = out_dtype == stt::kBFloat16;
  if ((!in_bf && in_dtype != stt::kFloat32) ||
      (!out_bf && out_dtype != stt::kFloat32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (in_bf && out_bf) {
    launch<bf16, bf16>(x, w, b, y, rows, cols, eps, s);
  } else if (in_bf) {
    launch<bf16, float>(x, w, b, y, rows, cols, eps, s);
  } else if (out_bf) {
    launch<float, bf16>(x, w, b, y, rows, cols, eps, s);
  } else {
    launch<float, float>(x, w, b, y, rows, cols, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}
