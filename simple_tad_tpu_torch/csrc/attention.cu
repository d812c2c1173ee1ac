// Non-causal inference attention read in place from the packed qkv tensor
// (kernel A1).
//
// Replaces the TPU kernel simple_tad_tpu/ops/flash_attention.py:
// _fwd_kernel_nomax_packed with _attend_rows_t, launched by
// flash_attention_qkv -> _flash_core_packed_qkv ->
// _flash_primal_packed_qkv_impl.  As there, q, k and v are read straight
// from the qkv projection's (B, N, 3C) output through its row stride and the
// column offsets 0, C and 2C plus h * Dh: no slice copies and no
// (B, H, N, Dh) relayout.  The caller passes three base pointers and the
// strides, so separate (B, N, C) q/k/v tensors can use the same kernel.
//
// Numerics held to the plain version (ops/flash_attention.py):
//   * q is pre-scaled by scale * log2(e) in fp32 and rounded to the input
//     dtype before QK;
//   * QK and PV accumulate in fp32;
//   * probabilities are exp2(s - m), rounded to the v dtype before PV, and
//     the denominator is the sum of those rounded values;
//   * keys >= N are masked inside the kernel (no padding copy).
// The TPU kernel is max-free.  Here the running max m is an online,
// per-row maximum rounded UP to an integer: every rescale factor
// exp2(m_old - m_new) is then an exact power of two, and rounding
// exp2(s - m) to bf16 gives the max-free value times 2^-m exactly, so the
// result is the max-free one while exp2 can never overflow.
//
// What bounds it on the H100: at N = 1568, Dh = 64 the two products do
// 4 * N^2 * Dh flops per (batch, head) against 4 * N * Dh * 2 bytes of
// q/k/v/out, ~400 flop/byte, so once tiled it is compute-bound.  The bf16
// kernel therefore runs both products on the tensor cores
// (mma.sync m16n8k16, fp32 accumulators) in the FlashAttention-2 shape:
// one block of 4 warps per (64-query tile, head, batch); each warp owns 16
// query rows whose Q fragments stay in registers; 64-key K and V tiles
// stream through shared memory (V stored transposed so each B fragment is
// one 32-bit load); the score accumulators are rounded to bf16 and reused
// directly as the A fragments of the PV product, so probabilities never
// leave registers.  No TMA, wgmma or warp specialisation yet.
//
// fp32 inputs (tests, small shapes) take a simple CUDA-core kernel: one
// thread per query row, 32-key tiles in shared memory, the same online
// integer-max softmax.
#include <math.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using stt::as_u32;
using stt::mma_16816;

constexpr int kBlockM = 64;     // query rows per block
constexpr int kBlockN = 64;     // keys per tile (bf16 kernel)
constexpr int kThreads = 128;   // 4 warps x 16 query rows
constexpr int kBlockNF32 = 32;  // keys per tile (fp32 kernel)

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy a (rows x DP) bf16 tile, rows starting at row0 of a strided source,
// into shared memory in 16-byte chunks.  Rows >= n and columns >= d read as
// zero.  With TRANSPOSE, element (r, c) lands at dst[c * ld + r].  With
// SCALE every value is multiplied by qscale in fp32 and rounded back.
template <int DP, int ROWS, bool TRANSPOSE, bool SCALE>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          int row0, int n, int d,
                                          int row_stride, float qscale) {
  constexpr int kChunks = DP / 8;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n && col < d) {
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * row_stride + col);
    }
    bf16* e = reinterpret_cast<bf16*>(&val);
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

template <int DP>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         int n, int d, int in_sb, int in_sn, int out_sb,
                         int out_sn, float qscale) {
  constexpr int KS = DP + 8;       // row stride of the Q/K tile (elements)
  constexpr int VS = kBlockN + 8;  // row stride of the transposed V tile
  constexpr int KSTEPS = DP / 16;  // k-steps of the QK product
  constexpr int NT = kBlockN / 8;  // 8-key column tiles of S
  constexpr int DT = DP / 8;       // 8-wide column tiles of O
  // sK stages the Q tile first, then each K tile
  __shared__ __align__(16) bf16 sK[kBlockN * KS];
  __shared__ __align__(16) bf16 sVt[DP * VS];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row within the 8-row group of a fragment
  const int t4 = lane & 3;  // thread within the group
  const int q0 = blockIdx.x * kBlockM;
  const size_t in_off = static_cast<size_t>(blockIdx.z) * in_sb +
                        static_cast<size_t>(blockIdx.y) * d;
  const bf16* qb = q + in_off;
  const bf16* kb = k + in_off;
  const bf16* vb = v + in_off;

  // 1. pre-scaled Q tile -> registers, as m16n8k16 A fragments
  load_tile<DP, kBlockM, false, true>(sK, KS, qb, q0, n, d, in_sn, qscale);
  __syncthreads();
  uint32_t qf[KSTEPS][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qf[kk][0] = ld32(&sK[r0 * KS + c]);
    qf[kk][1] = ld32(&sK[(r0 + 8) * KS + c]);
    qf[kk][2] = ld32(&sK[r0 * KS + c + 8]);
    qf[kk][3] = ld32(&sK[(r0 + 8) * KS + c + 8]);
  }
  __syncthreads();

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  // rows r0 and r0 + 8: running integer max and partial denominators
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBlockN) {
    load_tile<DP, kBlockN, false, false>(sK, KS, kb, k0, n, d, in_sn, 0.f);
    load_tile<DP, kBlockN, true, false>(sVt, VS, vb, k0, n, d, in_sn, 0.f);
    __syncthreads();

    // 2. S = (q * scale * log2e) K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* krow = &sK[(j * 8 + g) * KS + t4 * 2];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        mma_16816(s[j], qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
      }
    }
    if (k0 + kBlockN > n) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int key = k0 + j * 8 + t4 * 2;
        if (key >= n) s[j][0] = s[j][2] = -INFINITY;
        if (key + 1 >= n) s[j][1] = s[j][3] = -INFINITY;
      }
    }

    // 3. online softmax with an integer running max
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    float mn0 = fmaxf(m0, ceilf(mx0));
    float mn1 = fmaxf(m1, ceilf(mx1));
    if (mn0 == -INFINITY) mn0 = 0.f;  // only if every key so far is masked
    if (mn1 == -INFINITY) mn1 = 0.f;
    const float a0 = exp2f(m0 - mn0);  // exact powers of two; 0 on the first tile
    const float a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= a0;
      acc[j][1] *= a0;
      acc[j][2] *= a1;
      acc[j][3] *= a1;
    }

    // probabilities rounded to bf16; the S accumulator layout of key tiles
    // 2kk and 2kk+1 is exactly the A fragment layout of PV k-step kk
    uint32_t pf[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat162 p01 =
          __floats2bfloat162_rn(exp2f(s[j][0] - mn0), exp2f(s[j][1] - mn0));
      const __nv_bfloat162 p23 =
          __floats2bfloat162_rn(exp2f(s[j][2] - mn1), exp2f(s[j][3] - mn1));
      l0 += __low2float(p01) + __high2float(p01);
      l1 += __low2float(p23) + __high2float(p23);
      pf[j / 2][(j % 2) * 2] = as_u32(p01);
      pf[j / 2][(j % 2) * 2 + 1] = as_u32(p23);
    }

    // 4. O += P V
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const bf16* vrow = &sVt[(j * 8 + g) * VS + kk * 16 + t4 * 2];
        mma_16816(acc[j], pf[kk], ld32(vrow), ld32(vrow + 8));
      }
    }
    __syncthreads();  // the next tile overwrites sK and sVt
  }

  // 5. full row denominators, normalise, store
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int row0 = q0 + r0;
  const int row1 = row0 + 8;
  bf16* ob = o + static_cast<size_t>(blockIdx.z) * out_sb +
             static_cast<size_t>(blockIdx.y) * d;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + t4 * 2;
    if (col >= d) continue;
    if (row0 < n) {
      *reinterpret_cast<__nv_bfloat162*>(
          ob + static_cast<size_t>(row0) * out_sn + col) =
          __floats2bfloat162_rn(acc[j][0] / l0, acc[j][1] / l0);
    }
    if (row1 < n) {
      *reinterpret_cast<__nv_bfloat162*>(
          ob + static_cast<size_t>(row1) * out_sn + col) =
          __floats2bfloat162_rn(acc[j][2] / l1, acc[j][3] / l1);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kBlockM)
    attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        int n, int d, int in_sb, int in_sn, int out_sb,
                        int out_sn, float qscale) {
  __shared__ float sK[kBlockNF32][DP];
  __shared__ float sV[kBlockNF32][DP];
  const int row = blockIdx.x * kBlockM + threadIdx.x;
  const size_t in_off = static_cast<size_t>(blockIdx.z) * in_sb +
                        static_cast<size_t>(blockIdx.y) * d;
  const float* qb = q + in_off;
  const float* kb = k + in_off;
  const float* vb = v + in_off;

  float qr[DP], acc[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    qr[c] = (row < n && c < d)
                ? qb[static_cast<size_t>(row) * in_sn + c] * qscale
                : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < n; k0 += kBlockNF32) {
    for (int i = threadIdx.x; i < kBlockNF32 * DP; i += kBlockM) {
      const int r = i / DP;
      const int c = i % DP;
      const bool ok = k0 + r < n && c < d;
      const size_t at = static_cast<size_t>(k0 + r) * in_sn + c;
      sK[r][c] = ok ? kb[at] : 0.f;
      sV[r][c] = ok ? vb[at] : 0.f;
    }
    __syncthreads();
    const int nk = min(kBlockNF32, n - k0);
    for (int j = 0; j < nk; ++j) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) s = fmaf(qr[c], sK[j][c], s);
      if (s > m) {
        const float mn = ceilf(s);
        const float a = exp2f(m - mn);
        l *= a;
#pragma unroll
        for (int c = 0; c < DP; ++c) acc[c] *= a;
        m = mn;
      }
      const float p = exp2f(s - m);
      l += p;
#pragma unroll
      for (int c = 0; c < DP; ++c) acc[c] = fmaf(p, sV[j][c], acc[c]);
    }
    __syncthreads();
  }
  if (row < n) {
    float* orow = o + static_cast<size_t>(blockIdx.z) * out_sb +
                  static_cast<size_t>(blockIdx.y) * d +
                  static_cast<size_t>(row) * out_sn;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < d) orow[c] = acc[c] / l;
    }
  }
}

template <int DP>
void launch(const void* q, const void* k, const void* v, void* o, int b, int n,
            int h, int d, int in_sb, int in_sn, int out_sb, int out_sn,
            float qscale, int dtype, cudaStream_t stream) {
  const dim3 grid((n + kBlockM - 1) / kBlockM, h, b);
  if (dtype == stt::kBFloat16) {
    attn_fwd_bf16_kernel<DP><<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), n, d, in_sb,
        in_sn, out_sb, out_sn, qscale);
  } else {
    attn_fwd_f32_kernel<DP><<<grid, kBlockM, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), n, d, in_sb,
        in_sn, out_sb, out_sn, qscale);
  }
}

}  // namespace

// q, k, v: base pointers of head 0 (for packed qkv: qkv, qkv + C, qkv + 2C);
// element (batch, row, head h, dim c) of each is at
// base + batch * in_sb + row * in_sn + h * d + c.  o likewise with out_sb,
// out_sn.  d must be a multiple of 8 and at most 128; for bf16 every base
// pointer and stride must keep 16-byte alignment.
extern "C" int stt_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, int b, int n, int h, int d,
                                 int in_sb, int in_sn, int out_sb, int out_sn,
                                 float qscale, int dtype, void* stream) {
  if (b <= 0 || n <= 0 || h <= 0 || d <= 0 || d % 8 != 0 || d > 128 ||
      b > 65535 || h > 65535 ||
      (dtype != stt::kBFloat16 && dtype != stt::kFloat32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16 * 16) {
    case 16: launch<16>(q, k, v, o, b, n, h, d, in_sb, in_sn, out_sb, out_sn, qscale, dtype, s); break;
    case 32: launch<32>(q, k, v, o, b, n, h, d, in_sb, in_sn, out_sb, out_sn, qscale, dtype, s); break;
    case 48: launch<48>(q, k, v, o, b, n, h, d, in_sb, in_sn, out_sb, out_sn, qscale, dtype, s); break;
    case 64: launch<64>(q, k, v, o, b, n, h, d, in_sb, in_sn, out_sb, out_sn, qscale, dtype, s); break;
    case 80: launch<80>(q, k, v, o, b, n, h, d, in_sb, in_sn, out_sb, out_sn, qscale, dtype, s); break;
    case 96: launch<96>(q, k, v, o, b, n, h, d, in_sb, in_sn, out_sb, out_sn, qscale, dtype, s); break;
    case 112: launch<112>(q, k, v, o, b, n, h, d, in_sb, in_sn, out_sb, out_sn, qscale, dtype, s); break;
    default: launch<128>(q, k, v, o, b, n, h, d, in_sb, in_sn, out_sb, out_sn, qscale, dtype, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
