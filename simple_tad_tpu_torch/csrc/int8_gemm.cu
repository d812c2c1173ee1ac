// Static int8 GEMMs with the quantize, rescale, bias and GELU fused in
// (kernel B4): one product (w8a8_gemm) and the whole transformer MLP
// (w8a8_mlp).
//
// Replaces the TPU kernels simple_tad_tpu/ops/int8_gemm.py:_gemm_kernel
// (launched by w8a8_gemm) and _mlp_kernel (launched by w8a8_mlp), the
// JAX package's opt-in fused int8 GEMMs of the static int8 serving path.
//
// w8a8_gemm: y = act(float(q8(x) . W^T as an exact int32) * comb + bias) in
// the output dtype, with q8(x) = clip(round_half_even(x * inv), +-127),
// inv = 127 / max(amax, 1e-12), comb[n] = w_scale[n] * (amax / 127) made by
// the wrapper (the plain version's fp32 operations, so the bits are its
// bits), W (N, K) int8 row-major (the port's weight_q layout), x (M, K)
// int8 (already q8: LayerNorm->int8 or attention B2/B3 emitted it), bf16
// or fp32.  The product is rescaled and the bias added as two separate
// fp32 roundings (__fmul_rn, __fadd_rn: never one FMA), as the plain
// version computes them; act is none, tanh GELU or erf GELU, written as
// PyTorch's GELU is.
//
// w8a8_mlp: y = q8'(gelu(q8(x) . W1^T * c1 + b1)) . W2^T * c2 + b2, the
// (rows, hidden) activation never leaving the chip: q8' quantizes against
// fc2's calibrated absmax.  One block owns BM rows and walks hidden in
// 32-column chunks: fc1 for the chunk (K = dim), its epilogue and q8' into
// shared memory, then the chunk's fc2 product added into int32
// accumulators that stay in registers for the whole walk.  The int32 sum
// over hidden is exact, so fc2's scale applies once at the end, as in the
// plain version (one int32 GEMM).  The (BM x dim) accumulator sets BM:
// BM * dim / 256 threads <= 96 registers a thread (dim 384 -> 64 rows, dim
// 768 -> 32 rows); wider models (ViT-L's 1024, IV2-1B's 1408) take two
// w8a8_gemm launches instead (ops/int8_gemm.py:use_fused_mlp).
//
// What bounds them on the H100: at ViT-B batch 32 (M = 50176) the qkv
// product does 1.78e11 int8 operations against ~270 MB moved (0.090 vs
// 0.081 ms at the data-sheet rates), the MLP 4.74e11 operations against
// ~155 MB: both are bounded by the int8 tensor cores.  The kernels run the
// products on mma.sync m16n8k32 s8 x s8 -> s32 (exact), quantizing a float
// x on its way into shared memory.  w8a8_gemm: 128 x 128 output tiles, 8
// warps of 64 x 32, 64-deep k tiles double-buffered through registers (the
// next tile's loads are in flight while the current one multiplies).
// w8a8_mlp: the weight chunks double-buffered with cp.async.  No TMA,
// wgmma or warp specialisation yet.
#include <math.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using stt::mma_16832_s8;

enum Act : int { kActNone = 0, kActGeluTanh = 1, kActGeluErf = 2 };

constexpr int kThreads = 256;  // 8 warps

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// GELU as PyTorch writes it (aten/src/ATen/native/cuda/ActivationGeluKernel)
__device__ __forceinline__ float gelu(float x, int act) {
  if (act == kActGeluTanh) {
    const float kBeta = 0.7978845608028654f;  // sqrt(2) * 2 / sqrt(pi) / 2
    const float kKappa = 0.044715f;
    const float x_cube = x * x * x;
    const float inner = kBeta * (x + kKappa * x_cube);
    return 0.5f * x * (1.f + tanhf(inner));
  }
  if (act == kActGeluErf) {
    const float kAlpha = 0.70710678118654752f;  // 1 / sqrt(2)
    return x * 0.5f * (1.f + erff(x * kAlpha));
  }
  return x;
}

// float(acc) * comb, + bias, then act: two fp32 roundings, as the plain
// version's separate multiply and add
__device__ __forceinline__ float epilogue(int acc, float comb,
                                          const float* bias, int col,
                                          int act) {
  float y = __fmul_rn(static_cast<float>(acc), comb);
  if (bias != nullptr) y = __fadd_rn(y, bias[col]);
  return gelu(y, act);
}

__device__ __forceinline__ void store_pair(void* y, bool out_bf16, size_t idx,
                                           float a, float b) {
  if (out_bf16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(y) + idx) =
        __floats2bfloat162_rn(a, b);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(y) + idx) =
        make_float2(a, b);
  }
}

// 16 consecutive values of x (one 16-byte chunk of codes): raw loads, then
// the codes (q8 of a float input against inv).
template <typename TIn>
struct Chunk {
  static constexpr int kWords = sizeof(TIn);  // 16-byte words per chunk
  uint4 v[kWords];

  __device__ __forceinline__ void load(const TIn* src, bool valid) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      v[i] = valid ? reinterpret_cast<const uint4*>(src)[i]
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ uint4 codes(float inv) const {
    uint4 out;
    int8_t* c = reinterpret_cast<int8_t*>(&out);
    const TIn* e = reinterpret_cast<const TIn*>(v);
#pragma unroll
    for (int i = 0; i < 16; ++i) c[i] = stt::quant_i8(stt::to_float(e[i]), inv);
    return out;
  }
};

// int8 input: already codes
template <>
__device__ __forceinline__ uint4 Chunk<int8_t>::codes(float) const {
  return v[0];
}

// ------------------------------------------------------------------ GEMM ---

constexpr int kBM = 128;        // output rows per block
constexpr int kBN = 128;        // output columns per block
constexpr int kBK = 64;         // k bytes per tile
constexpr int kLd = kBK + 16;   // shared row stride (bytes): conflict-free
constexpr int kTileChunks = kBM * kBK / 16 / kThreads;  // 2 per thread

template <typename TIn>
__global__ void __launch_bounds__(kThreads)
    w8a8_gemm_kernel(const TIn* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ amax,
                     const float* __restrict__ comb,
                     const float* __restrict__ bias, void* __restrict__ y,
                     int m, int n, int k, int act, bool out_bf16) {
  __shared__ __align__(16) int8_t sA[2][kBM * kLd];
  __shared__ __align__(16) int8_t sB[2][kBN * kLd];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wm = warp >> 2;  // 64-row half of the block tile
  const int wn = warp & 3;   // 32-column quarter
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const float inv = sizeof(TIn) == 1 ? 0.f : stt::quant_inv(amax);

  Chunk<TIn> ra[kTileChunks];
  Chunk<int8_t> rb[kTileChunks];
  auto load = [&](int kt) {
#pragma unroll
    for (int i = 0; i < kTileChunks; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 2;
      const int col = kt * kBK + (c & 3) * 16;
      const bool kin = col < k;
      ra[i].load(x + (static_cast<size_t>(m0 + r) * k + col),
                 kin && m0 + r < m);
      rb[i].load(w + (static_cast<size_t>(n0 + r) * k + col),
                 kin && n0 + r < n);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kTileChunks; ++i) {
      const int c = tid + i * kThreads;
      const int off = (c >> 2) * kLd + (c & 3) * 16;
      *reinterpret_cast<uint4*>(&sA[buf][off]) = ra[i].codes(inv);
      *reinterpret_cast<uint4*>(&sB[buf][off]) = rb[i].v[0];
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] =
                                    acc[i][j][3] = 0;

  const int ktiles = (k + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < ktiles) load(kt + 1);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* ar = &sA[buf][(wm * 64 + i * 16 + g) * kLd + kk * 32 +
                                    t4 * 4];
        af[i][0] = ld32(ar);
        af[i][1] = ld32(ar + 8 * kLd);
        af[i][2] = ld32(ar + 16);
        af[i][3] = ld32(ar + 8 * kLd + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* br = &sB[buf][(wn * 32 + j * 8 + g) * kLd + kk * 32 +
                                    t4 * 4];
        bfr[j][0] = ld32(br);
        bfr[j][1] = ld32(br + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_16832_s8(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
    // the other buffer was last read before the previous barrier
    if (kt + 1 < ktiles) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row0 = m0 + wm * 64 + i * 16 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + t4 * 2;
      if (col >= n) continue;
      const float c0 = comb[col], c1 = comb[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + h * 8;
        if (row >= m) continue;
        store_pair(y, out_bf16, static_cast<size_t>(row) * n + col,
                   epilogue(acc[i][j][2 * h], c0, bias, col, act),
                   epilogue(acc[i][j][2 * h + 1], c1, bias, col + 1, act));
      }
    }
  }
}

template <typename TIn>
void launch_gemm(const void* x, const int8_t* w, const float* amax,
                 const float* comb, const float* bias, void* y, int m, int n,
                 int k, int act, bool out_bf16, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  w8a8_gemm_kernel<TIn><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(x), w, amax, comb, bias, y, m, n, k, act,
      out_bf16);
}

// ------------------------------------------------------------- fused MLP ---

constexpr int kBH = 32;         // hidden columns per chunk
constexpr int kLdH = kBH + 16;  // shared row stride of sW2 and sH (bytes)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int D>
struct MlpShape {
  static constexpr int BM = D * 64 <= 24576 ? 64 : 32;  // rows per block
  static constexpr int LdX = D + 16;  // shared row stride of sX and sW1
  static constexpr int X = BM * LdX;
  static constexpr int W1 = kBH * LdX;
  static constexpr int W2 = D * kLdH;
  static constexpr int H = BM * kLdH;
  static constexpr int kBytes = X + 2 * (W1 + W2) + H;
};

struct MlpArgs {
  const void* x;
  const int8_t* w1;   // (hidden, D) int8
  const float* c1;    // (hidden,) fc1 rescale
  const float* b1;    // (hidden,) or null
  const float* amax1; // fc1's input absmax
  const float* amax2; // fc2's input absmax (the hidden codes')
  const int8_t* w2;   // (D, hidden) int8
  const float* c2;    // (D,) fc2 rescale
  const float* b2;    // (D,) or null
  void* y;            // (M, D) bf16 or fp32
  int m, hidden, act;
  bool out_bf16;
};

template <int D, typename TIn>
__global__ void __launch_bounds__(kThreads) w8a8_mlp_kernel(MlpArgs a) {
  using S = MlpShape<D>;
  constexpr int BM = S::BM;
  constexpr int MT2 = BM / 16;   // fc2: m16 tiles a warp (all BM rows)
  constexpr int NT2 = D / 64;    // fc2: n8 tiles a warp (D / 8 columns)
  constexpr int MT1 = BM / 32;   // fc1: m16 tiles a warp
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* sX = smem;
  int8_t* sW1 = sX + S::X;            // two stages
  int8_t* sW2 = sW1 + 2 * S::W1;      // two stages
  int8_t* sH = sW2 + 2 * S::W2;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int m = a.m;
  const int hidden = a.hidden;

  // weight chunk c (hidden columns c*32 .. c*32+31) -> stage st
  auto prefetch = [&](int c, int st) {
    const int h0 = c * kBH;
    int8_t* w1s = sW1 + st * S::W1;
    int8_t* w2s = sW2 + st * S::W2;
    for (int i = tid; i < kBH * (D / 16); i += kThreads) {
      const int r = i / (D / 16);
      const int col = (i % (D / 16)) * 16;
      cp_async16(w1s + r * S::LdX + col,
                 a.w1 + (static_cast<size_t>(h0 + r) * D + col));
    }
    for (int i = tid; i < D * (kBH / 16); i += kThreads) {
      const int r = i / (kBH / 16);
      const int col = (i % (kBH / 16)) * 16;
      cp_async16(w2s + r * kLdH + col,
                 a.w2 + (static_cast<size_t>(r) * hidden + h0 + col));
    }
    cp_async_commit();
  };

  prefetch(0, 0);
  // the x tile -> codes in shared memory, once
  {
    const float inv = sizeof(TIn) == 1 ? 0.f : stt::quant_inv(a.amax1);
    const TIn* x = static_cast<const TIn*>(a.x);
    for (int i = tid; i < BM * (D / 16); i += kThreads) {
      const int r = i / (D / 16);
      const int col = (i % (D / 16)) * 16;
      Chunk<TIn> ch;
      ch.load(x + (static_cast<size_t>(m0 + r) * D + col), m0 + r < m);
      *reinterpret_cast<uint4*>(sX + r * S::LdX + col) = ch.codes(inv);
    }
  }
  const float inv2 = stt::quant_inv(a.amax2);

  int acc2[MT2][NT2][4];
#pragma unroll
  for (int i = 0; i < MT2; ++i)
#pragma unroll
    for (int j = 0; j < NT2; ++j)
      acc2[i][j][0] = acc2[i][j][1] = acc2[i][j][2] = acc2[i][j][3] = 0;

  // fc1 work of this warp: m16 tiles (warp / 4) * MT1 + i, n8 tile warp % 4
  const int n1 = (warp & 3) * 8;
  const int mb1 = (warp >> 2) * MT1;
  const int chunks = hidden / kBH;
  for (int c = 0; c < chunks; ++c) {
    const int st = c & 1;
    if (c + 1 < chunks) {
      prefetch(c + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c (and, at c = 0, the x tile) visible
    const int8_t* w1s = sW1 + st * S::W1;
    const int8_t* w2s = sW2 + st * S::W2;

    // fc1 for the chunk: (BM x 32) = x (BM x D) . W1[chunk]^T
    int acc1[MT1][4];
#pragma unroll
    for (int i = 0; i < MT1; ++i) acc1[i][0] = acc1[i][1] = acc1[i][2] =
                                      acc1[i][3] = 0;
    const int8_t* br = w1s + (n1 + g) * S::LdX + t4 * 4;
#pragma unroll 4
    for (int kk = 0; kk < D / 32; ++kk) {
      const uint32_t b0 = ld32(br + kk * 32), b1 = ld32(br + kk * 32 + 16);
#pragma unroll
      for (int i = 0; i < MT1; ++i) {
        const int8_t* ar = sX + ((mb1 + i) * 16 + g) * S::LdX + kk * 32 +
                           t4 * 4;
        const uint32_t af[4] = {ld32(ar), ld32(ar + 8 * S::LdX),
                                ld32(ar + 16), ld32(ar + 8 * S::LdX + 16)};
        mma_16832_s8(acc1[i], af, b0, b1);
      }
    }
    // epilogue: rescale, bias, GELU, then the codes against fc2's absmax
    {
      const int hc = c * kBH + n1 + t4 * 2;  // hidden column of acc1[.][0]
      const float c0 = a.c1[hc], c1 = a.c1[hc + 1];
#pragma unroll
      for (int i = 0; i < MT1; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (mb1 + i) * 16 + g + h * 8;
          *reinterpret_cast<char2*>(sH + r * kLdH + n1 + t4 * 2) = make_char2(
              stt::quant_i8(epilogue(acc1[i][2 * h], c0, a.b1, hc, a.act),
                            inv2),
              stt::quant_i8(epilogue(acc1[i][2 * h + 1], c1, a.b1, hc + 1,
                                     a.act),
                            inv2));
        }
      }
    }
    __syncthreads();  // sH complete

    // fc2: acc2 (BM x D) += h (BM x 32) . W2[:, chunk]^T, this warp's
    // D / 8 columns
    {
      uint32_t af[MT2][4];
#pragma unroll
      for (int i = 0; i < MT2; ++i) {
        const int8_t* ar = sH + (i * 16 + g) * kLdH + t4 * 4;
        af[i][0] = ld32(ar);
        af[i][1] = ld32(ar + 8 * kLdH);
        af[i][2] = ld32(ar + 16);
        af[i][3] = ld32(ar + 8 * kLdH + 16);
      }
#pragma unroll
      for (int j = 0; j < NT2; ++j) {
        const int8_t* b = w2s + (warp * (D / 8) + j * 8 + g) * kLdH + t4 * 4;
        const uint32_t b0 = ld32(b), b1 = ld32(b + 16);
#pragma unroll
        for (int i = 0; i < MT2; ++i) mma_16832_s8(acc2[i][j], af[i], b0, b1);
      }
    }
    __syncthreads();  // stage st and sH are rewritten next
  }

#pragma unroll
  for (int j = 0; j < NT2; ++j) {
    const int col = warp * (D / 8) + j * 8 + t4 * 2;
    const float c0 = a.c2[col], c1 = a.c2[col + 1];
#pragma unroll
    for (int i = 0; i < MT2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + i * 16 + g + h * 8;
        if (row >= m) continue;
        store_pair(a.y, a.out_bf16, static_cast<size_t>(row) * D + col,
                   epilogue(acc2[i][j][2 * h], c0, a.b2, col, kActNone),
                   epilogue(acc2[i][j][2 * h + 1], c1, a.b2, col + 1,
                            kActNone));
      }
    }
  }
}

template <int D, typename TIn>
int launch_mlp(const MlpArgs& a, cudaStream_t stream) {
  using S = MlpShape<D>;
  auto kernel = w8a8_mlp_kernel<D, TIn>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.m + S::BM - 1) / S::BM;
  kernel<<<blocks, kThreads, S::kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mlp_in(const MlpArgs& a, int x_dtype, cudaStream_t stream) {
  switch (x_dtype) {
    case stt::kInt8: return launch_mlp<D, int8_t>(a, stream);
    case stt::kBFloat16: return launch_mlp<D, bf16>(a, stream);
    default: return launch_mlp<D, float>(a, stream);
  }
}

}  // namespace

// x: (m, k) int8 codes, bf16 or fp32 (x_dtype 2, 1, 0), contiguous; w: (n, k)
// int8 row-major; amax: fc's input absmax (one fp32 value in device memory,
// read only for a float x); comb: (n,) fp32 rescale; bias: (n,) fp32 or
// null; y: (m, n) bf16 (out_bf16) or fp32, contiguous.  k % 32 == 0 and
// n % 8 == 0; x and w 16-byte aligned.
extern "C" int stt_w8a8_gemm(const void* x, int x_dtype, const void* w,
                             const float* amax, const float* comb,
                             const float* bias, void* y, int m, int n, int k,
                             int act, int out_bf16, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 32 != 0 || n % 8 != 0 ||
      (m + kBM - 1) / kBM > 65535 || act < kActNone || act > kActGeluErf ||
      (x_dtype != stt::kInt8 && amax == nullptr) || comb == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  switch (x_dtype) {
    case stt::kInt8:
      launch_gemm<int8_t>(x, wq, amax, comb, bias, y, m, n, k, act,
                          out_bf16 != 0, s);
      break;
    case stt::kBFloat16:
      launch_gemm<bf16>(x, wq, amax, comb, bias, y, m, n, k, act,
                        out_bf16 != 0, s);
      break;
    case stt::kFloat32:
      launch_gemm<float>(x, wq, amax, comb, bias, y, m, n, k, act,
                         out_bf16 != 0, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The whole MLP: x (m, dim) int8 codes, bf16 or fp32, contiguous; w1 (hidden,
// dim) and w2 (dim, hidden) int8 row-major; c1 (hidden,), c2 (dim,) fp32
// rescales; b1, b2 fp32 or null; amax1, amax2 the two inputs' absmax in
// device memory; y (m, dim) bf16 or fp32.  dim is 128, 256, 384, 512, 640
// or 768 and hidden % 32 == 0 (ops/int8_gemm.py:use_fused_mlp).
extern "C" int stt_w8a8_mlp(const void* x, int x_dtype, const void* w1,
                            const float* c1, const float* b1,
                            const float* amax1, const void* w2,
                            const float* c2, const float* b2,
                            const float* amax2, void* y, int m, int dim,
                            int hidden, int act, int out_bf16, void* stream) {
  if (m <= 0 || hidden <= 0 || hidden % kBH != 0 || act < kActNone ||
      act > kActGeluErf || amax2 == nullptr ||
      (x_dtype != stt::kInt8 && amax1 == nullptr) ||
      (x_dtype != stt::kInt8 && x_dtype != stt::kBFloat16 &&
       x_dtype != stt::kFloat32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MlpArgs a{x, static_cast<const int8_t*>(w1), c1, b1, amax1, amax2,
                  static_cast<const int8_t*>(w2), c2, b2, y, m, hidden, act,
                  out_bf16 != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 128: return launch_mlp_in<128>(a, x_dtype, s);
    case 256: return launch_mlp_in<256>(a, x_dtype, s);
    case 384: return launch_mlp_in<384>(a, x_dtype, s);
    case 512: return launch_mlp_in<512>(a, x_dtype, s);
    case 640: return launch_mlp_in<640>(a, x_dtype, s);
    case 768: return launch_mlp_in<768>(a, x_dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
