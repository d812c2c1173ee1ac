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
// PyTorch's GELU is.  The output is bf16 or fp32, or int8 codes q8 against
// a second absmax (the MLP's hidden activation).
//
// w8a8_mlp: y = q8'(gelu(q8(x) . W1^T * c1 + b1)) . W2^T * c2 + b2, with q8'
// against fc2's calibrated absmax: two launches of the GEMM kernel, fc1
// with the int8-output epilogue into an (M, hidden) scratch of codes that
// the wrapper allocates, then fc2 on those codes.  The int32 sums are exact
// and each epilogue is the plain version's fp32 arithmetic, so the result
// is the plain version's (fc1 to fp32, quantize_static, fc2) wherever
// CUDA's tanhf / erff round as PyTorch's GELU does.  Any dim and hidden
// that are multiples of 32 (ops/int8_gemm.py:use_fused_mlp).
//
// What bounds them on the H100: at ViT-B batch 32 (M = 50176) the qkv
// product does 1.78e11 int8 operations against ~270 MB moved (0.090 vs
// 0.081 ms at the data-sheet rates), the MLP 4.74e11 operations (0.239
// ms): the int8 tensor cores, which only wgmma drives at their full rate.
// The fc2-shape product on an fp32 x (50176, 3072) is bound by reading x
// (0.208 ms).  The design (Hopper's: a TMA ring feeding wgmma):
//   * a block computes a 128 x BN output tile with two consumer
//     warpgroups of 64 rows, each issuing wgmma m64n128k32 s8 x s8 -> s32
//     (BN = 128, or 256 as two n128 products for an fp32 x), operands
//     K-major in shared memory (SS form): x (M, K) and the (N, K) weight
//     codes are K-major already;
//   * x and W tiles stream by TMA (rows and columns past M, N, K read as
//     zero, which adds nothing to an int32 sum) through a ring of 3-6
//     stages on mbarriers, refilled by a producer warp as the consumers
//     release each stage: 128 k bytes a stage with a 128-byte swizzle for
//     an int8 x, 64 with a 64-byte swizzle for a float one;
//   * a float x lands by TMA as it is (64 bf16 or fp32 a row) and each
//     consumer warpgroup quantizes its 64 rows (round half to even) into a
//     64-byte-swizzled int8 tile, double buffered, while its previous
//     k-tile's products run;
//   * the epilogue runs on the accumulator fragments (the s32 layout is
//     the f32 one: the m16n8 fragment repeated), compiled once per output
//     type; the four threads of a quad exchange their words in two
//     butterfly stages so that each stores whole 8-column groups (16
//     bytes of bf16), masked at the M and N tails (its instruction count,
//     more than the products, set much of the kernels' time on an H100).
// A block of 128 columns holds ~97 KB of ring, so two blocks share an SM
// and one's prologue and epilogue can run under the other's products (one
// block an SM, persistent or not, ran slower on an H100).
// An fp32 x is read and quantized by N / 256 column blocks (3 at fc2's N =
// 768, where 128-column blocks would read it 6 times).  The MLP's hidden
// codes make one round trip through device memory (2 x 154 MB at ViT-B
// batch 32, ~0.09 ms at 3.35 TB/s), but each weight is read once per
// 128-row tile (an fc2 accumulator kept in registers would hold 32 rows
// at dim 768).  What still holds them back
// (on an H100): the L2-to-SM traffic of 128 x 128 tiles (each output
// tile reads its x rows and W rows once per k: ~1.35 GB at qkv's shape),
// the epilogue, which the two blocks of an SM reach at about the same
// time, and for a float x the quantize that every column block repeats.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace hw = stt::hopper;

enum Act : int { kActNone = 0, kActGeluTanh = 1, kActGeluErf = 2 };
enum Out : int { kOutF32 = 0, kOutBF16 = 1, kOutI8 = 2 };

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

// Across the four threads of a quad (lanes 4g .. 4g+3, t4 = lane & 3): word
// w[i] of thread s is its part of column group i; afterwards thread t4
// holds group t4's words of threads 0-3 in out[0..3], i.e. in column order.
// Two butterfly stages (lane bit 0, then bit 1), two exchanges each: no
// shared memory.
__device__ __forceinline__ void quad_transpose(const uint32_t (&w)[4],
                                               uint32_t (&out)[4], int t4) {
  const bool b0 = t4 & 1, b1 = t4 & 2;
  uint32_t u[4];  // u[2 j + b] = word 2 j + (t4 & 1) of thread (t4 & 2) | b
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint32_t got =
        __shfl_xor_sync(0xffffffffu, b0 ? w[2 * j] : w[2 * j + 1], 1);
    u[2 * j] = b0 ? got : w[2 * j];
    u[2 * j + 1] = b0 ? w[2 * j + 1] : got;
  }
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const uint32_t got =
        __shfl_xor_sync(0xffffffffu, b1 ? u[b] : u[2 + b], 2);
    out[b] = b1 ? got : u[b];
    out[2 + b] = b1 ? u[2 + b] : got;
  }
}

constexpr int kBM = 128;                 // output rows a block
constexpr int kSubN = 128;               // columns of one wgmma
constexpr int kWgRows = 64;              // rows of a consumer warpgroup
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kKStep = 32 >> 4;          // k32 step in the descriptor

// Tile and ring sizes by the input's type.  int8 x: stages of 128 k
// bytes, 128-byte swizzle; a float x lands as it is, 64 values a row (an
// fp32 row of 128 would take 64 KB a stage), into a 64-byte-swizzled int8
// tile.  A block of 128 columns keeps its ring under ~110 KB so that two
// blocks share an SM (each then gets 96 registers a thread: 18 warps on 4
// schedulers); an fp32 x takes 256 columns (half the re-reads of x) and
// the SM alone.
template <typename TIn>
struct GemmCfg {
  static constexpr bool kFloat = sizeof(TIn) > 1;
  static constexpr int kBK = kFloat ? 64 : 128;  // k (codes, bytes) a stage
  static constexpr int kNSub = sizeof(TIn) == 4 ? 2 : 1;
  static constexpr int kBN = kSubN * kNSub;
  static constexpr int kMinBlocks = kNSub == 1 ? 2 : 1;
  static constexpr int kABytes = kBM * kBK * static_cast<int>(sizeof(TIn));
  static constexpr int kBBytes = kBN * kBK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kA8Bytes = kFloat ? 2 * kBM * kBK : 0;  // two buffers
  static constexpr int kBudget = (kNSub == 1 ? 110 : 224) * 1024;
  static constexpr int kFit = (kBudget - 1024 - kA8Bytes - 256) / kStageBytes;
  static constexpr int kStages = kFit > 6 ? 6 : kFit;
  static constexpr int kSmem =
      1024 + kStages * kStageBytes + kA8Bytes + 2 * kStages * 8;
  static_assert(kStages >= 3, "the ring needs at least three stages");
};

// stt::quant_i8 of four values, packed little-endian
__device__ __forceinline__ uint32_t quant4(float a, float b, float c,
                                           float d, float inv) {
  auto q = [inv](float y) {
    return static_cast<uint32_t>(stt::quant_i8(y, inv));
  };
  return __byte_perm(__byte_perm(q(a), q(b), 0x0040),
                     __byte_perm(q(c), q(d), 0x0040), 0x5410);
}

// q8 of this warpgroup's 64 rows of a float x tile (row-major, 64 values a
// row, as TMA left it) into a 64-byte-swizzled int8 tile; t is the thread's
// index in the warpgroup.  16 bytes of x a step: consecutive threads read
// consecutive chunks and write consecutive codes.
template <typename TIn>
__device__ __forceinline__ void quantize_rows(const TIn* src, int8_t* dst,
                                              float inv, int t) {
  constexpr int kBK = 64;
  constexpr int kVec = 16 / static_cast<int>(sizeof(TIn));
  constexpr int kRowChunks = kBK / kVec;
  constexpr int kChunks = kWgRows * kRowChunks;
#pragma unroll 2
  for (int c = t; c < kChunks; c += 128) {
    const int row = c / kRowChunks;
    const int col = (c % kRowChunks) * kVec;
    const uint4 v = reinterpret_cast<const uint4*>(src)[c];
    const TIn* e = reinterpret_cast<const TIn*>(&v);
    uint32_t w[kVec / 4];
#pragma unroll
    for (int i = 0; i < kVec / 4; ++i) {
      w[i] = quant4(stt::to_float(e[4 * i]), stt::to_float(e[4 * i + 1]),
                    stt::to_float(e[4 * i + 2]), stt::to_float(e[4 * i + 3]),
                    inv);
    }
    int8_t* d = dst + hw::sw64_offset(row, col);
    if constexpr (kVec == 4) {
      *reinterpret_cast<uint32_t*>(d) = w[0];
    } else {
      *reinterpret_cast<uint2*>(d) = make_uint2(w[0], w[1]);
    }
  }
}

struct GemmArgs {
  const float* amax;      // x's absmax (a float x only)
  const float* comb;      // (n,) fp32 rescale
  const float* bias;      // (n,) fp32 or null
  const float* amax_out;  // int8 output: the codes' absmax
  void* y;                // (m, n) bf16, fp32 or int8
  int m, n, k, act, out;
};

// The epilogue, four column groups of 8 at a time: each thread computes
// its two columns of each group and row, the quad's words are exchanged
// so that thread t4 holds group t4 whole, and it stores that group's 8
// columns of the row (16 bytes of bf16, 32 of fp32, 8 of codes): full
// 32-byte sectors where the fragment's own pairs would write 4 bytes.
// Rows row0 and row0 + 8 of the output, the accumulator's columns from n0.
template <int kOut, int kNSub>
__device__ __forceinline__ void store_tile(const int (&acc)[kNSub][64],
                                           const GemmArgs& a, int row0,
                                           int n0, int t4) {
  const float inv_out = kOut == kOutI8 ? stt::quant_inv(a.amax_out) : 0.f;
#pragma unroll
  for (int sub = 0; sub < kNSub; ++sub) {
#pragma unroll
    for (int q = 0; q < kSubN / 32; ++q) {
      const int base = n0 + sub * kSubN + q * 32;  // the four groups' start
      float c0[4], c1[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = base + jj * 8 + t4 * 2;
        c0[jj] = col < a.n ? a.comb[col] : 0.f;
        c1[jj] = col < a.n ? a.comb[col + 1] : 0.f;
      }
      const int gcol = base + t4 * 8;  // this thread's group after the swap
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + h * 8;
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int col = base + jj * 8 + t4 * 2;
          const int j = q * 4 + jj;
          const bool in = col < a.n;
          const float v0 = in ? epilogue(acc[sub][4 * j + 2 * h], c0[jj],
                                         a.bias, col, a.act)
                              : 0.f;
          const float v1 = in ? epilogue(acc[sub][4 * j + 2 * h + 1],
                                         c1[jj], a.bias, col + 1, a.act)
                              : 0.f;
          if constexpr (kOut == kOutBF16) {
            lo[jj] = stt::as_u32(__floats2bfloat162_rn(v0, v1));
          } else if constexpr (kOut == kOutF32) {
            lo[jj] = __float_as_uint(v0);
            hi[jj] = __float_as_uint(v1);
          } else {
            lo[jj] = static_cast<uint8_t>(stt::quant_i8(v0, inv_out)) |
                     static_cast<uint32_t>(static_cast<uint8_t>(
                         stt::quant_i8(v1, inv_out)))
                         << 8;
          }
        }
        uint32_t L[4], H[4];
        quad_transpose(lo, L, t4);
        if constexpr (kOut == kOutF32) quad_transpose(hi, H, t4);
        if (row >= a.m || gcol >= a.n) continue;
        const size_t at = static_cast<size_t>(row) * a.n + gcol;
        if constexpr (kOut == kOutBF16) {
          *reinterpret_cast<uint4*>(static_cast<bf16*>(a.y) + at) =
              make_uint4(L[0], L[1], L[2], L[3]);
        } else if constexpr (kOut == kOutF32) {
          uint4* d = reinterpret_cast<uint4*>(static_cast<float*>(a.y) + at);
          d[0] = make_uint4(L[0], H[0], L[1], H[1]);
          d[1] = make_uint4(L[2], H[2], L[3], H[3]);
        } else {
          *reinterpret_cast<uint2*>(static_cast<int8_t*>(a.y) + at) =
              make_uint2(L[0] | (L[1] << 16), L[2] | (L[3] << 16));
        }
      }
    }
  }
}

// One 128 x BN output tile.  Warps 0-7: two consumer warpgroups (rows
// 0-63, 64-127); warp 8: the producer, whose lane 0 issues the TMA loads.
// full[s] completes when stage s has landed; empty[s] when the eight
// consumer warps are done with it (their products on it have completed).
// The grid runs n fastest, so the blocks in flight share x's rows and all
// of W in L2.
template <typename TIn>
__global__ void __launch_bounds__(kThreads, GemmCfg<TIn>::kMinBlocks)
    w8a8_gemm_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw, GemmArgs a) {
  using C = GemmCfg<TIn>;
  constexpr int kBK = C::kBK;
  constexpr int kS = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hw::align_1024(smem_raw);
  int8_t* a8 = reinterpret_cast<int8_t*>(ring + kS * C::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kS * C::kStageBytes +
                                               C::kA8Bytes);
  uint64_t* empty = full + kS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * C::kBN;
  const int ktiles = (a.k + kBK - 1) / kBK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], kConsumerWarps);
    }
    hw::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer
    if (lane == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kS;
        if (kt >= kS) hw::mbar_wait(&empty[s], ((kt / kS) + 1) & 1);
        unsigned char* st = ring + s * C::kStageBytes;
        hw::mbar_expect_tx(&full[s], C::kStageBytes);
        hw::tma_load_2d(st, &tx, &full[s], kt * kBK, m0);
        hw::tma_load_2d(st + C::kABytes, &tw, &full[s], kt * kBK, n0);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int t = tid & 127;
  const float inv = C::kFloat ? stt::quant_inv(a.amax) : 0.f;
  int acc[C::kNSub][64];
#pragma unroll
  for (int sub = 0; sub < C::kNSub; ++sub) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[sub][i] = 0;
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kS;
    const unsigned char* st = ring + s * C::kStageBytes;
    hw::mbar_wait(&full[s], (kt / kS) & 1);
    const void* a_tile;
    if constexpr (C::kFloat) {
      // this k-tile's codes go to the buffer whose products (two k-tiles
      // back) the wait below last completed
      int8_t* dst = a8 + (kt & 1) * kBM * kBK + wg * kWgRows * kBK;
      quantize_rows<TIn>(
          reinterpret_cast<const TIn*>(st) + wg * kWgRows * kBK, dst, inv,
          t);
      hw::fence_proxy_async();
      hw::named_bar_sync(1 + wg, 128);
      a_tile = dst;
    } else {
      a_tile = st + wg * kWgRows * kBK;
    }
    const uint64_t desc_a = kBK == 128 ? hw::desc_kmajor(a_tile)
                                       : hw::desc_kmajor_sw64(a_tile);
    const unsigned char* b_tile = st + C::kABytes;
    const uint64_t desc_b = kBK == 128 ? hw::desc_kmajor(b_tile)
                                       : hw::desc_kmajor_sw64(b_tile);
#pragma unroll
    for (int sub = 0; sub < C::kNSub; ++sub) hw::fence_regs(acc[sub]);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
#pragma unroll
      for (int sub = 0; sub < C::kNSub; ++sub) {
        hw::wgmma_s8_n128(acc[sub], desc_a + kk * kKStep,
                          desc_b + sub * ((kSubN * kBK) >> 4) + kk * kKStep);
      }
    }
    hw::wgmma_commit();
#pragma unroll
    for (int sub = 0; sub < C::kNSub; ++sub) hw::fence_regs(acc[sub]);
    hw::wgmma_wait<1>();  // the previous k-tile's products are done
    if (kt > 0 && lane == 0) hw::mbar_arrive(&empty[(kt - 1) % kS]);
  }
  hw::wgmma_wait<0>();
#pragma unroll
  for (int sub = 0; sub < C::kNSub; ++sub) hw::fence_regs(acc[sub]);

  const int row0 = m0 + wg * kWgRows + (warp & 3) * 16 + (lane >> 2);
  switch (a.out) {
    case kOutBF16: store_tile<kOutBF16>(acc, a, row0, n0, lane & 3); break;
    case kOutF32: store_tile<kOutF32>(acc, a, row0, n0, lane & 3); break;
    default: store_tile<kOutI8>(acc, a, row0, n0, lane & 3); break;
  }
}

template <typename TIn>
constexpr CUtensorMapDataType map_dtype() {
  return sizeof(TIn) == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
         : sizeof(TIn) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// Two tensor maps (x by 128-row tiles of BK k values, int8 swizzled for
// wgmma, a float x as it is; W by BN-row tiles of BK codes), then the
// kernel on the stream.
template <typename TIn>
int launch_gemm(const void* x, const int8_t* w, const GemmArgs& a,
                cudaStream_t stream) {
  using C = GemmCfg<TIn>;
  const CUtensorMapSwizzle sw = C::kBK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                              : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tx, tw;
  if (!hw::tile_map_2d(&tx, x, map_dtype<TIn>(), a.k, a.m,
                       static_cast<long long>(a.k) * sizeof(TIn), C::kBK,
                       kBM, C::kFloat ? CU_TENSOR_MAP_SWIZZLE_NONE : sw) ||
      !hw::tile_map_2d(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.k, a.n, a.k,
                       C::kBK, C::kBN, sw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = w8a8_gemm_kernel<TIn>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.n + C::kBN - 1) / C::kBN, (a.m + kBM - 1) / kBM);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(tx, tw, a);
  return static_cast<int>(cudaGetLastError());
}

int launch_gemm_in(const void* x, int x_dtype, const int8_t* w,
                   const GemmArgs& a, cudaStream_t stream) {
  switch (x_dtype) {
    case stt::kInt8: return launch_gemm<int8_t>(x, w, a, stream);
    case stt::kBFloat16: return launch_gemm<bf16>(x, w, a, stream);
    case stt::kFloat32: return launch_gemm<float>(x, w, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad_dims(int m, int n, int k, int act) {
  return m <= 0 || n <= 0 || k <= 0 || k % 32 != 0 || n % 8 != 0 ||
         (m + kBM - 1) / kBM > 65535 || act < kActNone || act > kActGeluErf;
}

}  // namespace

// x: (m, k) int8 codes, bf16 or fp32 (x_dtype 2, 1, 0), contiguous; w: (n, k)
// int8 row-major; amax: fc's input absmax (one fp32 value in device memory,
// read only for a float x); comb: (n,) fp32 rescale; bias: (n,) fp32 or
// null; y: (m, n) bf16 (out_bf16) or fp32, contiguous.  k % 32 == 0 and
// n % 8 == 0; x, w and y 16-byte aligned.
extern "C" int stt_w8a8_gemm(const void* x, int x_dtype, const void* w,
                             const float* amax, const float* comb,
                             const float* bias, void* y, int m, int n, int k,
                             int act, int out_bf16, void* stream) {
  if (bad_dims(m, n, k, act) || (x_dtype != stt::kInt8 && amax == nullptr) ||
      comb == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GemmArgs a{amax, comb, bias, nullptr, y, m, n, k, act,
                   out_bf16 != 0 ? kOutBF16 : kOutF32};
  return launch_gemm_in(x, x_dtype, static_cast<const int8_t*>(w), a,
                        static_cast<cudaStream_t>(stream));
}

// The whole MLP: x (m, dim) int8 codes, bf16 or fp32, contiguous; w1 (hidden,
// dim) and w2 (dim, hidden) int8 row-major; c1 (hidden,), c2 (dim,) fp32
// rescales; b1, b2 fp32 or null; amax1, amax2 the two inputs' absmax in
// device memory; y (m, dim) bf16 or fp32; h (m, hidden) int8 scratch for
// fc1's codes.  dim and hidden are multiples of 32
// (ops/int8_gemm.py:use_fused_mlp).  Two launches on the stream: fc1 with
// the int8-output epilogue into h, then fc2 on h.
extern "C" int stt_w8a8_mlp(const void* x, int x_dtype, const void* w1,
                            const float* c1, const float* b1,
                            const float* amax1, const void* w2,
                            const float* c2, const float* b2,
                            const float* amax2, void* y, int m, int dim,
                            int hidden, int act, int out_bf16, void* h,
                            void* stream) {
  if (bad_dims(m, hidden, dim, act) || bad_dims(m, dim, hidden, act) ||
      amax2 == nullptr || h == nullptr || c1 == nullptr || c2 == nullptr ||
      (x_dtype != stt::kInt8 && amax1 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GemmArgs fc1{amax1, c1, b1, amax2, h, m, hidden, dim, act, kOutI8};
  const int err =
      launch_gemm_in(x, x_dtype, static_cast<const int8_t*>(w1), fc1, s);
  if (err != 0) return err;
  const GemmArgs fc2{amax2, c2, b2, nullptr, y, m, dim, hidden, kActNone,
                     out_bf16 != 0 ? kOutBF16 : kOutF32};
  return launch_gemm<int8_t>(h, static_cast<const int8_t*>(w2), fc2, s);
}
