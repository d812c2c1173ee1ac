// Non-causal inference attention computed in int8 on the packed int8 qkv,
// with a bf16 output (kernel E2).
//
// Replaces the TPU kernel simple_tad_tpu/ops/flash_attention.py:
// _fwd_kernel_int8_packed, launched by flash_attention_qkv_int8: the static
// int8 ViT's int8-compute attention (int8_attn).  q, k and v are read in
// place from the (B, N, 3C) int8 qkv at columns 0, C and 2C plus h * Dh, as
// kernel B2 reads them.
//
// Numerics, per head h with sq, sk, sv = amax[0..2, h] * fp32(1 / 127) and
// c = ((sq * sk) * scale) * log2e in fp32, held to the plain version
// (ops/flash_attention.py:flash_attention_qkv_int8_plain):
//   * s = fl(float(q_i8 . k_i8 as an exact int32) * c), keys >= n excluded;
//   * m = the row maximum of s, before any probability is formed;
//   * p = round_half_even(exp2(s - m) * 127), a code in [0, 127];
//   * l = sum of p (an integer: exact in any order);
//   * o = sum of int8(p) * v_i8 as an exact int32;
//   * out = bf16((float(o) / l) * sv), each step rounded once.
// p depends on the exact m, so the online running maximum of A1/B2 does not
// compute this function: the kernel makes two passes over the keys.  Pass 1
// computes only the integer row maximum of q . k (c > 0 and rounding is
// monotone, so fl(float(max) * c) is the maximum of s bit for bit); pass 2
// recomputes QK, forms the codes and accumulates l and o.  The extra pass is
// one more QK at the int8 rate.
//
// QK and PV both run on mma.sync m16n8k32 s8 x s8 -> s32.  The s32 score
// fragment (a thread holds row g, keys {8j + 2t, 8j + 2t + 1} of each 8-key
// tile j) is not laid out as an int8 A fragment (keys 4t .. 4t + 3 of a
// 32-key group in one register).  The contraction order of PV is free, so
// the kernel keeps the codes in registers and permutes the keys of the V
// tile instead: within each 32-key group, logical key 4t + i of the A
// fragment is physical key 2t + i for i < 2 and 8 + 2t + (i - 2) for i >= 2,
// and 16 keys on the same again.  The transposed int8 V tile in shared memory
// stores physical key p at logical position ``perm_key(p)``, so the B
// fragment read at logical keys 4t .. 4t + 3 meets the A fragment's codes.
//
// What bounds it on the H100: at (32, 1568, 2304), H = 12 the two products
// are 2.4e11 int8 ops (0.122 ms at 1979 TOP/s) against 193 MB moved
// (0.058 ms): operations; the kernel also evaluates 9.4e8 exp2f on the
// special-function units, and its first pass repeats QK.  The design is
// B2's: one block of 4 warps per (64-query tile, head, batch), each warp 16
// query rows whose int8 Q fragments stay in registers, 64-key int8 K and
// transposed V tiles through shared memory.  Dh is zero-padded to a multiple
// of 32 (the QK depth) in shared memory.  No TMA, wgmma or warp
// specialisation yet.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

using stt::mma_16832_s8;

constexpr int kBlockM = 64;    // query rows per block
constexpr int kBlockN = 64;    // keys per tile
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy a (ROWS x DP) int8 tile, rows starting at row0 of the qkv (row
// stride ld_src bytes), into shared memory (row stride ld bytes) in 16-byte
// chunks.  Rows >= n and columns >= d read as zero (d % 16 == 0).
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(int8_t* dst, int ld,
                                          const int8_t* src, int row0, int n,
                                          int d, int ld_src) {
  constexpr int kChunks = DP / 16;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n && col < d) {
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * ld_src + col);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + col) = val;
  }
}

// The logical position of physical key p (0..63) of a tile in the PV
// contraction: within each 32-key group, physical keys 2t, 2t + 1, 8 + 2t,
// 9 + 2t go to logical 4t .. 4t + 3 (t = 0..3), and 16 keys on the same.
__device__ __forceinline__ int perm_key(int p) {
  const int q = p & 15;
  return (p & ~15) + 4 * ((q & 7) >> 1) + (q & 1) + 2 * (q >> 3);
}

// The int8 V tile, transposed with its keys permuted: element (physical key
// r, dim c) lands at dst[c * ld + perm_key(r)].  Keys >= n and dims >= d
// read as zero.
template <int DP>
__device__ __forceinline__ void load_v_t(int8_t* dst, int ld,
                                         const int8_t* src, int row0, int n,
                                         int d, int ld_src) {
  constexpr int kChunks = DP / 16;
  for (int c = threadIdx.x; c < kBlockN * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n && col < d) {
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * ld_src + col);
    }
    const int8_t* e = reinterpret_cast<const int8_t*>(&val);
    const int lr = perm_key(r);
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[(col + i) * ld + lr] = e[i];
  }
}

// Four codes in [0, 127] as one register, the first in the low byte
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 8) |
         (static_cast<uint32_t>(c) << 16) | (static_cast<uint32_t>(d) << 24);
}

// p = round_half_even(exp2(s - m) * 127) of the score fl(float(si) * c)
__device__ __forceinline__ int prob_code(int si, float c, float m) {
  const float s = __fmul_rn(static_cast<float>(si), c);
  return __float2int_rn(__fmul_rn(exp2f(__fsub_rn(s, m)), 127.f));
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    attn_int8_kernel(const int8_t* __restrict__ qkv,
                     const float* __restrict__ amax,
                     __nv_bfloat16* __restrict__ o, int n, int c3, int d,
                     float scale) {
  constexpr int KS = DP + 16;       // row stride of the Q/K tile (bytes)
  constexpr int VS = kBlockN + 16;  // row stride of the transposed V tile
  constexpr int KSTEPS = DP / 32;   // k-steps of the QK product
  constexpr int NT = kBlockN / 8;   // 8-key column tiles of S
  constexpr int DT = DP / 8;        // 8-wide column tiles of O
  // sK stages the Q tile first, then each K tile
  __shared__ __align__(16) int8_t sK[kBlockN * KS];
  __shared__ __align__(16) int8_t sVt[DP * VS];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row within the 8-row group of a fragment
  const int t4 = lane & 3;  // thread within the group
  const int head = blockIdx.y;
  const int heads = gridDim.y;
  const int q0 = blockIdx.x * kBlockM;
  const int C = c3 / 3;
  const int8_t* base = qkv + static_cast<size_t>(blockIdx.z) * n * c3 +
                       static_cast<size_t>(head) * d;
  const int8_t* qb = base;
  const int8_t* kb = base + C;
  const int8_t* vb = base + 2 * C;

  // per-head scales, in the plain version's order of fp32 operations
  const float sq = __fmul_rn(amax[head], 1.f / 127.f);
  const float sk = __fmul_rn(amax[heads + head], 1.f / 127.f);
  const float sv = __fmul_rn(amax[2 * heads + head], 1.f / 127.f);
  const float c = __fmul_rn(__fmul_rn(__fmul_rn(sq, sk), scale), kLog2e);

  // 1. int8 Q tile -> registers, as m16n8k32 A fragments
  load_tile<DP, kBlockM>(sK, KS, qb, q0, n, d, c3);
  __syncthreads();
  uint32_t qf[KSTEPS][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int col = kk * 32 + t4 * 4;
    qf[kk][0] = ld32(&sK[r0 * KS + col]);
    qf[kk][1] = ld32(&sK[(r0 + 8) * KS + col]);
    qf[kk][2] = ld32(&sK[r0 * KS + col + 16]);
    qf[kk][3] = ld32(&sK[(r0 + 8) * KS + col + 16]);
  }
  __syncthreads();

  // S tile j of the current K tile: rows r0 and r0 + 8, keys
  // k0 + 8j + 2t4 and + 1, as exact int32
  auto scores = [&](int (&si)[NT][4]) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      si[j][0] = si[j][1] = si[j][2] = si[j][3] = 0;
      const int8_t* krow = &sK[(j * 8 + g) * KS + t4 * 4];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        mma_16832_s8(si[j], qf[kk], ld32(krow + kk * 32),
                     ld32(krow + kk * 32 + 16));
      }
    }
  };

  // 2. pass 1: the integer row maximum of q . k over the valid keys
  int mx0 = INT_MIN, mx1 = INT_MIN;
  for (int k0 = 0; k0 < n; k0 += kBlockN) {
    load_tile<DP, kBlockN>(sK, KS, kb, k0, n, d, c3);
    __syncthreads();
    int si[NT][4];
    scores(si);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int key = k0 + j * 8 + t4 * 2;
      if (key < n) {
        mx0 = max(mx0, si[j][0]);
        mx1 = max(mx1, si[j][2]);
      }
      if (key + 1 < n) {
        mx0 = max(mx0, si[j][1]);
        mx1 = max(mx1, si[j][3]);
      }
    }
    __syncthreads();  // the next tile overwrites sK
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = max(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = max(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float m0 = __fmul_rn(static_cast<float>(mx0), c);
  const float m1 = __fmul_rn(static_cast<float>(mx1), c);

  // 3. pass 2: codes, their row sums and O = P V, all exact integers
  int acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  int l0 = 0, l1 = 0;
  for (int k0 = 0; k0 < n; k0 += kBlockN) {
    load_tile<DP, kBlockN>(sK, KS, kb, k0, n, d, c3);
    load_v_t<DP>(sVt, VS, vb, k0, n, d, c3);
    __syncthreads();
    int si[NT][4];
    scores(si);
    int p[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int key = k0 + j * 8 + t4 * 2;
      const bool v0 = key < n, v1 = key + 1 < n;
      p[j][0] = v0 ? prob_code(si[j][0], c, m0) : 0;
      p[j][1] = v1 ? prob_code(si[j][1], c, m0) : 0;
      p[j][2] = v0 ? prob_code(si[j][2], c, m1) : 0;
      p[j][3] = v1 ? prob_code(si[j][3], c, m1) : 0;
      l0 += p[j][0] + p[j][1];
      l1 += p[j][2] + p[j][3];
    }
    // the A fragments of PV: 32-key group kk takes tiles 4kk .. 4kk + 3;
    // register 0 holds tiles 4kk, 4kk + 1 of row r0 (logical keys 4t4 ..
    // 4t4 + 3), register 2 tiles 4kk + 2, 4kk + 3, registers 1 and 3 the
    // same for row r0 + 8
#pragma unroll
    for (int kk = 0; kk < NT / 4; ++kk) {
      const int j = 4 * kk;
      const uint32_t pa[4] = {
          pack4(p[j][0], p[j][1], p[j + 1][0], p[j + 1][1]),
          pack4(p[j][2], p[j][3], p[j + 1][2], p[j + 1][3]),
          pack4(p[j + 2][0], p[j + 2][1], p[j + 3][0], p[j + 3][1]),
          pack4(p[j + 2][2], p[j + 2][3], p[j + 3][2], p[j + 3][3])};
#pragma unroll
      for (int jd = 0; jd < DT; ++jd) {
        const int8_t* vrow = &sVt[(jd * 8 + g) * VS + kk * 32 + t4 * 4];
        mma_16832_s8(acc[jd], pa, ld32(vrow), ld32(vrow + 16));
      }
    }
    __syncthreads();  // the next tile overwrites sK and sVt
  }

  // 4. full row sums, out = bf16((float(o) / l) * sv)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float lf0 = static_cast<float>(l0);
  const float lf1 = static_cast<float>(l1);
  const int row0 = q0 + r0;
  const int row1 = row0 + 8;
  __nv_bfloat16* ob = o + static_cast<size_t>(blockIdx.z) * n * C +
                      static_cast<size_t>(head) * d;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + t4 * 2;
    if (col >= d) continue;
    if (row0 < n) {
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(row0) * C +
                                         col) =
          __floats2bfloat162_rn(
              __fmul_rn(__fdiv_rn(__int2float_rn(acc[j][0]), lf0), sv),
              __fmul_rn(__fdiv_rn(__int2float_rn(acc[j][1]), lf0), sv));
    }
    if (row1 < n) {
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(row1) * C +
                                         col) =
          __floats2bfloat162_rn(
              __fmul_rn(__fdiv_rn(__int2float_rn(acc[j][2]), lf1), sv),
              __fmul_rn(__fdiv_rn(__int2float_rn(acc[j][3]), lf1), sv));
    }
  }
}

template <int DP>
void launch(const void* qkv, const void* amax, void* o, int b, int n, int h,
            int d, float scale, cudaStream_t stream) {
  const dim3 grid((n + kBlockM - 1) / kBlockM, h, b);
  attn_int8_kernel<DP><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(qkv), static_cast<const float*>(amax),
      static_cast<__nv_bfloat16*>(o), n, 3 * h * d, d, scale);
}

}  // namespace

// Kernel E2.  qkv: (b, n, 3 h d) int8, contiguous, [q | k | v] columns each
// (h, d)-major, per-head codes against amax: (3, h) fp32 in device memory.
// o: (b, n, h d) bf16, contiguous.  d must be a multiple of 16 and at most
// 64 (the static ViT's int8_attn geometry: a head dim that divides 128 and
// is no multiple of it); qkv must be 16-byte aligned.
extern "C" int stt_attention_int8(const void* qkv, const void* amax, void* o,
                                  int b, int n, int h, int d, float scale,
                                  void* stream) {
  if (b <= 0 || n <= 0 || h <= 0 || d <= 0 || d % 16 != 0 || d > 64 ||
      b > 65535 || h > 65535 || amax == nullptr ||
      static_cast<long long>(n) * 3 * h * d >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32) {
    launch<32>(qkv, amax, o, b, n, h, d, scale, s);
  } else {
    launch<64>(qkv, amax, o, b, n, h, d, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}
