// Row LayerNorm over the last axis (kernel A2), the same LayerNorm with a
// static int8 output (kernel B1), B1 after a residual add (kernel E1), and
// RMSNorm with a static int8 output (kernel D3).
//
// A2 replaces the TPU kernel simple_tad_tpu/ops/ln.py:_ln_kernel (launched
// by fused_layernorm -> _fused_ln_impl).  B1 replaces
// simple_tad_tpu/ops/ln.py:_ln_quant_kernel (launched by
// fused_layernorm_quant): the int8 serving path's norm1/norm2, which hand
// the next GEMM its int8 activation directly.  Same numerics as there:
// fp32 mean, fp32 biased variance of the centred values (mean(xc * xc),
// not E[x^2] - m^2), rsqrt(var + eps), fp32 affine ((xc * r) * w + b, each
// product rounded, no fused multiply-add), then one cast to the output
// dtype, or for B1 clip(round_half_even(y * 127 / amax), +-127) as int8
// with amax the calibrated absmax read from device memory.
//
// What bounds both on the H100: bytes.  A row of C values is read once and
// written once (rows * C * (in + out) bytes; B1 at ViT-B batch 32 moves
// 3 bytes an element, 116 MB, >= 35 us at 3.35 TB/s) against a handful of
// flops per element, far below the ~295 flop/byte at which the tensor
// cores would become the limit.  The design therefore reads x from device
// memory exactly once, in 16-byte loads: one thread block per row, each
// thread keeping one 8-value chunk of the row in registers (C % 8 == 0,
// the ViT widths), so the centred second pass and the affine pass touch no
// memory; B1 stores its 8 codes as one 8-byte store.  Other widths take a
// fallback that stages the row in shared memory as fp32 (C <= 4096, at
// most 16 KB).  Block-wide sums go through warp shuffles.  Rows are many
// (32 * 1568 at ViT-B batch 32) and blocks small, so the 132 SMs stay
// full.
//
// E1 replaces simple_tad_tpu/ops/ln.py:_add_ln_quant_kernel (launched by
// fused_add_layernorm_quant): the static int8 ViT's deferred-residual carry
// (add_lnq), where each residual add runs inside the next norm's read.  It is
// B1 with a prologue: the branch and the residual are added in fp32, the sum
// is rounded to the input dtype and stored (the first output), and the
// statistics are taken on that stored value, as the unfused chain (add, then
// B1) takes them.  B1's kernels are instantiated with ADD = true, so the
// reductions run in B1's order and the codes equal B1's of the stored sum
// bit for bit.  Bounded by bytes: two rows read, the sum and the codes
// written (ViT-B batch 32 bf16: 270 MB, >= 81 us at 3.35 TB/s).
//
// D3 replaces simple_tad_tpu/ops/ln.py:_rms_quant_kernel (launched by
// fused_rmsnorm_quant): InternVideo2's static int8 serving with the fused
// RMSNorm->int8 option, where norm1/norm2 hand the next GEMM its int8 input
// and the q/k-norms hand the int8-storage attention its per-head codes.
// Numerics as there: fp32 mean(x * x) (no mean subtraction, no bias),
// rsqrt(var + eps), (x * r) * w with each product rounded, then
// clip(round_half_even(y * inv_c[c]), +-127) with inv_c a per-channel
// 127 / amax vector (one value repeated for a GEMM input, a per-head repeat
// for q and k).  It is B1's body without the mean and with that vector,
// bounded by bytes in the same way: IV2-S at batch 32 moves
// 32 * 2049 * 384 * 3 bytes (75.5 MB, >= 23 us at 3.35 TB/s).
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

// (xc * r) * w + b with every step rounded, as the plain version computes it
__device__ __forceinline__ float affine(float xc, float r, float w, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(xc, r), w), b);
}

// Output stores; qinv (127 / amax) is read only by the int8 ones.
__device__ __forceinline__ void store1(float* p, float v, float) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v, float) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store1(int8_t* p, float v, float qinv) {
  *p = stt::quant_i8(v, qinv);
}

// The value the statistics are taken on: x, or with ADD (kernel E1) the sum
// x + r rounded to TIn, which is also stored to s
template <typename TIn, bool ADD>
__device__ __forceinline__ float load1(const TIn* x, const TIn* r, TIn* s,
                                       size_t i) {
  const float v = stt::to_float(x[i]);
  if (!ADD) return v;
  const TIn sum = stt::from_float<TIn>(__fadd_rn(v, stt::to_float(r[i])));
  s[i] = sum;
  return stt::to_float(sum);
}

template <typename TIn, typename TOut, bool ADD>
__global__ void layernorm_kernel(const TIn* __restrict__ x,
                                 const TIn* __restrict__ r,
                                 TIn* __restrict__ sum,
                                 const float* __restrict__ w,
                                 const float* __restrict__ b,
                                 const float* __restrict__ amax,
                                 TOut* __restrict__ y, int cols, float eps) {
  extern __shared__ float row[];  // cols floats
  __shared__ float red[33];
  const size_t base = static_cast<size_t>(blockIdx.x) * cols;
  TOut* yr = y + base;

  float s = 0.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const float v = load1<TIn, ADD>(x, r, sum, base + c);
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
  const float qinv = amax != nullptr ? stt::quant_inv(amax) : 1.f;

  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    store1(yr + c, affine(row[c] - mean, inv, w[c], b[c]), qinv);
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

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8],
                                       float) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8], float) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(int8_t* p, const float (&v)[8],
                                       float qinv) {
  uint2 raw;
  int8_t* e = reinterpret_cast<int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = stt::quant_i8(v[i], qinv);
  *reinterpret_cast<uint2*>(p) = raw;
}

// load8, and with ADD (kernel E1) the sum with r's 8 values rounded to TIn,
// stored to s and read back as the stored values
template <typename TIn, bool ADD>
__device__ __forceinline__ void load8_sum(const TIn* x, const TIn* r, TIn* s,
                                          float (&v)[8]) {
  load8(x, v);
  if (!ADD) return;
  float rv[8];
  load8(r, rv);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = stt::to_float(stt::from_float<TIn>(__fadd_rn(v[i], rv[i])));
  }
  store8(s, v, 0.f);   // exact: each v[i] is a TIn value
}

// cols % 8 == 0, 16-byte aligned: thread t owns columns [8t, 8t + 8)
template <typename TIn, typename TOut, bool ADD>
__global__ void layernorm_vec8_kernel(const TIn* __restrict__ x,
                                      const TIn* __restrict__ r,
                                      TIn* __restrict__ sum,
                                      const float* __restrict__ w,
                                      const float* __restrict__ b,
                                      const float* __restrict__ amax,
                                      TOut* __restrict__ y, int cols,
                                      float eps) {
  __shared__ float red[33];
  const size_t base = static_cast<size_t>(blockIdx.x) * cols;
  const int c0 = threadIdx.x * 8;
  const bool active = c0 < cols;
  float v[8];
  float s = 0.f;
  if (active) {
    load8_sum<TIn, ADD>(x + base + c0, r + base + c0, sum + base + c0, v);
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
    const float qinv = amax != nullptr ? stt::quant_inv(amax) : 1.f;
    float wv[8], bv[8];
    load8(w + c0, wv);
    load8(b + c0, bv);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = affine(v[i], inv, wv[i], bv[i]);
    store8(y + base + c0, v, qinv);
  }
}

// D3, cols % 8 == 0, 16-byte aligned: thread t owns columns [8t, 8t + 8)
template <typename TIn>
__global__ void rmsnorm_quant_vec8_kernel(const TIn* __restrict__ x,
                                          const float* __restrict__ w,
                                          const float* __restrict__ inv_c,
                                          int8_t* __restrict__ y, int cols,
                                          float eps) {
  __shared__ float red[33];
  const size_t base = static_cast<size_t>(blockIdx.x) * cols;
  const int c0 = threadIdx.x * 8;
  const bool active = c0 < cols;
  float v[8];
  float ss = 0.f;
  if (active) {
    load8(x + base + c0, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) ss += v[i] * v[i];
  }
  const float var = block_sum(ss, red) / static_cast<float>(cols);
  const float r = rsqrtf(var + eps);
  if (active) {
    float wv[8], iv[8];
    load8(w + c0, wv);
    load8(inv_c + c0, iv);
    uint2 raw;
    int8_t* e = reinterpret_cast<int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      e[i] = stt::quant_i8(__fmul_rn(__fmul_rn(v[i], r), wv[i]), iv[i]);
    }
    *reinterpret_cast<uint2*>(y + base + c0) = raw;
  }
}

// D3 for any width up to kMaxCols: the row staged in shared memory as fp32
template <typename TIn>
__global__ void rmsnorm_quant_kernel(const TIn* __restrict__ x,
                                     const float* __restrict__ w,
                                     const float* __restrict__ inv_c,
                                     int8_t* __restrict__ y, int cols,
                                     float eps) {
  extern __shared__ float row[];  // cols floats
  __shared__ float red[33];
  const size_t base = static_cast<size_t>(blockIdx.x) * cols;
  float ss = 0.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const float v = stt::to_float(x[base + c]);
    row[c] = v;
    ss += v * v;
  }
  const float var = block_sum(ss, red) / static_cast<float>(cols);
  const float r = rsqrtf(var + eps);
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    y[base + c] = stt::quant_i8(__fmul_rn(__fmul_rn(row[c], r), w[c]),
                                inv_c[c]);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// With ADD (kernel E1), r is the residual and s receives the rounded sum;
// otherwise both are null.
template <typename TIn, typename TOut, bool ADD = false>
void launch(const void* x, const void* w, const void* b, const void* amax,
            void* y, int rows, int cols, float eps, cudaStream_t stream,
            const void* r = nullptr, void* s = nullptr) {
  const TIn* xt = static_cast<const TIn*>(x);
  const TIn* rt = static_cast<const TIn*>(r);
  TIn* st = static_cast<TIn*>(s);
  const float* wt = static_cast<const float*>(w);
  const float* bt = static_cast<const float*>(b);
  const float* at = static_cast<const float*>(amax);
  TOut* yt = static_cast<TOut*>(y);
  if (cols % 8 == 0 && aligned16(x) && aligned16(w) && aligned16(b) &&
      aligned16(y) && (!ADD || (aligned16(r) && aligned16(s)))) {
    const int threads = (cols / 8 + 31) / 32 * 32;   // <= 512 for C <= 4096
    layernorm_vec8_kernel<TIn, TOut, ADD><<<rows, threads, 0, stream>>>(
        xt, rt, st, wt, bt, at, yt, cols, eps);
    return;
  }
  // about four values per thread, whole warps, at most 1024 threads
  int threads = ((cols + 3) / 4 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t smem = static_cast<size_t>(cols) * sizeof(float);
  layernorm_kernel<TIn, TOut, ADD><<<rows, threads, smem, stream>>>(
      xt, rt, st, wt, bt, at, yt, cols, eps);
}

bool valid_shape(int rows, int cols) {
  return rows > 0 && cols > 0 && cols <= kMaxCols;
}

}  // namespace

// x (rows, cols) in in_dtype, w and b (cols,) fp32 -> y (rows, cols) in
// out_dtype.  All contiguous.
extern "C" int stt_layernorm(const void* x, const void* w, const void* b,
                             void* y, int rows, int cols, float eps,
                             int in_dtype, int out_dtype, void* stream) {
  if (!valid_shape(rows, cols)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const bool in_bf = in_dtype == stt::kBFloat16;
  const bool out_bf = out_dtype == stt::kBFloat16;
  if ((!in_bf && in_dtype != stt::kFloat32) ||
      (!out_bf && out_dtype != stt::kFloat32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (in_bf && out_bf) {
    launch<bf16, bf16>(x, w, b, nullptr, y, rows, cols, eps, s);
  } else if (in_bf) {
    launch<bf16, float>(x, w, b, nullptr, y, rows, cols, eps, s);
  } else if (out_bf) {
    launch<float, bf16>(x, w, b, nullptr, y, rows, cols, eps, s);
  } else {
    launch<float, float>(x, w, b, nullptr, y, rows, cols, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// As stt_layernorm, with y int8: the static codes against amax (one fp32
// value in device memory, the calibrated absmax of the LayerNorm output).
extern "C" int stt_layernorm_quant(const void* x, const void* w,
                                   const void* b, const void* amax, void* y,
                                   int rows, int cols, float eps,
                                   int in_dtype, void* stream) {
  if (!valid_shape(rows, cols) || amax == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == stt::kBFloat16) {
    launch<__nv_bfloat16, int8_t>(x, w, b, amax, y, rows, cols, eps, s);
  } else if (in_dtype == stt::kFloat32) {
    launch<float, int8_t>(x, w, b, amax, y, rows, cols, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel E1: branch and residual (rows, cols) in in_dtype, w and b (cols,)
// fp32, amax one fp32 value in device memory -> sum (rows, cols) in in_dtype,
// the residual add rounded to it, and y (rows, cols) int8, the static codes of
// the LayerNorm of that stored sum.  All contiguous.
extern "C" int stt_add_layernorm_quant(const void* branch,
                                       const void* residual, const void* w,
                                       const void* b, const void* amax,
                                       void* sum, void* y, int rows, int cols,
                                       float eps, int in_dtype,
                                       void* stream) {
  if (!valid_shape(rows, cols) || amax == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == stt::kBFloat16) {
    launch<__nv_bfloat16, int8_t, true>(branch, w, b, amax, y, rows, cols,
                                        eps, s, residual, sum);
  } else if (in_dtype == stt::kFloat32) {
    launch<float, int8_t, true>(branch, w, b, amax, y, rows, cols, eps, s,
                                residual, sum);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel D3: x (rows, cols) in in_dtype, w and inv_c (cols,) fp32 -> y
// (rows, cols) int8, the RMSNorm's static codes against the per-channel
// inverse scales inv_c (127 / amax).  All contiguous.
extern "C" int stt_rmsnorm_quant(const void* x, const void* w,
                                 const void* inv_c, void* y, int rows,
                                 int cols, float eps, int in_dtype,
                                 void* stream) {
  if (!valid_shape(rows, cols) ||
      (in_dtype != stt::kBFloat16 && in_dtype != stt::kFloat32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wt = static_cast<const float*>(w);
  const float* it = static_cast<const float*>(inv_c);
  int8_t* yt = static_cast<int8_t*>(y);
  const bool vec8 = cols % 8 == 0 && aligned16(x) && aligned16(w) &&
                    aligned16(inv_c) && reinterpret_cast<uintptr_t>(y) % 8 == 0;
  int threads = vec8 ? (cols / 8 + 31) / 32 * 32
                     : ((cols + 3) / 4 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t smem = vec8 ? 0 : static_cast<size_t>(cols) * sizeof(float);
  if (in_dtype == stt::kBFloat16) {
    const __nv_bfloat16* xt = static_cast<const __nv_bfloat16*>(x);
    if (vec8) {
      rmsnorm_quant_vec8_kernel<<<rows, threads, 0, s>>>(xt, wt, it, yt, cols, eps);
    } else {
      rmsnorm_quant_kernel<<<rows, threads, smem, s>>>(xt, wt, it, yt, cols, eps);
    }
  } else {
    const float* xt = static_cast<const float*>(x);
    if (vec8) {
      rmsnorm_quant_vec8_kernel<<<rows, threads, 0, s>>>(xt, wt, it, yt, cols, eps);
    } else {
      rmsnorm_quant_kernel<<<rows, threads, smem, s>>>(xt, wt, it, yt, cols, eps);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
