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
// QK and PV both run on s8 x s8 -> s32 products.  The s32 score
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
// (0.058 ms); its softmax evaluates 9.4e8 exp2 on the special-function
// units, 16 lanes an SM a clock: 0.226 ms at 1980 MHz, the bound; the
// first pass repeats QK.  Two routes by head dim (route() below,
// ops/flash_attention.py:attention_int8_route):
//   * head dim 64 (ViT-S/B/L), the wgmma kernel (namespace wg): one
//     warpgroup per (64-query tile, head, batch); the q tile and a ring of
//     tiles arrive by TMA (64-byte swizzle), pass 1 streaming k tiles and
//     pass 2 (k, vt) tiles; both S products are s8 wgmma m64n64k32 from
//     shared memory, and PV is s8 wgmma with the codes as its A operand in
//     registers (formed and packed where the scores lie).  8-bit wgmma
//     operands are K-major only and the codes' register layout is the
//     m16n8k32 one, so PV's B is V^T with its keys permuted as below: a
//     pre-pass writes it once a call, (B, H, 64, N rounded up to 16) int8
//     (38.5 MB at ViT-B batch 32), and TMA loads it as a K-major tile.  A
//     transpose by the threads in shared memory would repeat it in every
//     query tile of a head (25 at N = 1568) as byte shuffles in the loop.
//   * head dims 16, 32 and 48, the mma.sync kernel attn_int8_kernel, in
//     B2's FlashAttention-2 shape: one block of 4 warps per (64-query tile,
//     head, batch), each warp 16 query rows whose int8 Q fragments stay in
//     registers, 64-key int8 K and transposed V tiles through shared memory
//     by synchronous loads.  Dh is zero-padded to a multiple of 32 (the QK
//     depth) in shared memory.
// Both routes compute the integers exactly and the float steps as the
// plain version orders them: their outputs are the same bits.
#include <limits.h>
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

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

// p = round_half_even(exp2(s - m) * 127) of the score fl(float(si) * c).
// ex2.approx.ftz is exp2f wherever exp2(s - m) is a normal float; below
// 2^-126 it reads 0 where exp2f is subnormal, and either way the code is 0.
__device__ __forceinline__ int prob_code(int si, float c, float m) {
  const float s = __fmul_rn(static_cast<float>(si), c);
  return __float2int_rn(
      __fmul_rn(stt::hopper::exp2_approx(__fsub_rn(s, m)), 127.f));
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

// ---- the wgmma route: head dim 64 ----
namespace wg {

namespace hw = stt::hopper;

constexpr int kD = 64;                 // the route's head dim
constexpr int kRows = 64;              // queries a block, keys a tile
constexpr int kThreads = 128;          // one warpgroup a block
constexpr int kTile = kRows * kD;      // one int8 tile, 4 KB
constexpr int kKStep = 32 >> 4;        // k32 step of an s8 operand (desc)
constexpr int kStages = 2;             // the ring of k (pass 1), (k, vt) tiles

// 64-byte-swizzled int8 tiles, 512-byte aligned
struct Smem {
  int8_t q[kTile];              // A of S (K-major)
  int8_t k[kStages][kTile];     // B of S (K-major)
  int8_t vt[kStages][kTile];    // B of PV: 64 dims x 64 permuted keys
  uint64_t full[kStages], qbar;
};

// One block per (64-query tile, head, batch), one warpgroup.  The q tile
// and a ring of tiles arrive by TMA (64-byte swizzle; rows at or beyond n
// read as zero): pass 1 streams the k tiles alone, pass 2 the (k, vt)
// tiles, one sequence of 2 * tiles fills through the ring.  Both passes
// take S = Q K^T by s8 wgmma m64n64k32 from shared memory (two k-steps,
// exact int32).  Pass 1 keeps the integer row maximum over the valid keys;
// pass 2 forms the codes round_half_even(exp2(s - m) * 127) in registers
// (s = fl(float(si) * c)), packs
// them as the s8 A fragments of PV (the accumulator keys 8 j + 2 t4 + {0, 1}
// of tiles 4 kk .. 4 kk + 3 are logical keys 4 t4 .. 4 t4 + 3 and 16 +
// 4 t4 .. of k-step kk under perm_key, which the pre-pass wrote vt in) and
// runs O += P V^T by s8 wgmma with A from registers and vt K-major.  l sums
// the codes.  out = bf16((float(o) / l) * sv).
__global__ void __launch_bounds__(kThreads, 4)
    attn_int8_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tvt,
                           const float* __restrict__ amax,
                           __nv_bfloat16* __restrict__ o, int n,
                           float scale) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(hw::align_1024(smem_raw));
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kRows;
  const int head = blockIdx.y;
  const int heads = gridDim.y;
  const int col = head * kD;
  const int b = blockIdx.z;
  const int bh = b * heads + head;
  const int tiles = (n + kRows - 1) / kRows;
  // fill i of the sequence: k tile i (pass 1), or (k, vt) tile i - tiles
  auto fill = [&](int i) {
    const int s = i % kStages;
    const int t = i < tiles ? i : i - tiles;
    if (tid == 0) {
      hw::mbar_expect_tx(&sm.full[s], i < tiles ? kTile : 2 * kTile);
      hw::tma_load_3d(sm.k[s], &tk, &sm.full[s], col, t * kRows, b);
      if (i >= tiles) {
        hw::tma_load_3d(sm.vt[s], &tvt, &sm.full[s], t * kRows, 0, bh);
      }
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) hw::mbar_init(&sm.full[s], 1);
    hw::mbar_init(&sm.qbar, 1);
    hw::mbar_init_fence();
    hw::mbar_expect_tx(&sm.qbar, kTile);
    hw::tma_load_3d(sm.q, &tq, &sm.qbar, col, q0, b);
  }
  __syncthreads();
  for (int i = 0; i < kStages && i < 2 * tiles; ++i) fill(i);

  // per-head scales, in the plain version's order of fp32 operations
  const float sq = __fmul_rn(amax[head], 1.f / 127.f);
  const float sk = __fmul_rn(amax[heads + head], 1.f / 127.f);
  const float sv = __fmul_rn(amax[2 * heads + head], 1.f / 127.f);
  const float c = __fmul_rn(__fmul_rn(__fmul_rn(sq, sk), scale), kLog2e);

  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t4 = tid & 3;
  const uint64_t desc_q = hw::desc_kmajor_sw64(sm.q);
  hw::mbar_wait(&sm.qbar, 0);

  int si[32] = {};
  // S of fill i's k tile into si
  auto scores = [&](int i) {
    const int s = i % kStages;
    hw::mbar_wait(&sm.full[s], (i / kStages) & 1);
    const uint64_t desc_k = hw::desc_kmajor_sw64(sm.k[s]);
    hw::fence_regs(si);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 32; ++kk) {
      hw::wgmma_s8_n64(si, desc_q + kk * kKStep, desc_k + kk * kKStep, kk);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(si);
  };
  // every warp is done with fill i's stage: refill it
  auto release = [&](int i) {
    __syncthreads();
    if (i + kStages < 2 * tiles) fill(i + kStages);
  };

  // pass 1: the integer row maximum of q . k over the valid keys
  int mx[2] = {INT_MIN, INT_MIN};
  for (int i = 0; i < tiles; ++i) {
    scores(i);
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) {
      const int key = i * kRows + j8 * 8 + t4 * 2;
      if (key < n) {
        mx[0] = max(mx[0], si[j8 * 4]);
        mx[1] = max(mx[1], si[j8 * 4 + 2]);
      }
      if (key + 1 < n) {
        mx[0] = max(mx[0], si[j8 * 4 + 1]);
        mx[1] = max(mx[1], si[j8 * 4 + 3]);
      }
    }
    release(i);
  }
  float m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx[r] = max(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
    }
    m[r] = __fmul_rn(static_cast<float>(mx[r]), c);
  }

  // pass 2: codes, their row sums and O = P V, all exact integers
  int acc[32] = {};
  int l[2] = {0, 0};
  for (int i = tiles; i < 2 * tiles; ++i) {
    scores(i);
    const int k0 = (i - tiles) * kRows;
    int p[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int key = k0 + (e >> 2) * 8 + t4 * 2 + (e & 1);
      p[e] = key < n ? prob_code(si[e], c, m[(e >> 1) & 1]) : 0;
      l[(e >> 1) & 1] += p[e];
    }
    uint32_t pa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int e = kk * 16;  // tiles 4 kk .. 4 kk + 3
      pa[kk][0] = pack4(p[e], p[e + 1], p[e + 4], p[e + 5]);
      pa[kk][1] = pack4(p[e + 2], p[e + 3], p[e + 6], p[e + 7]);
      pa[kk][2] = pack4(p[e + 8], p[e + 9], p[e + 12], p[e + 13]);
      pa[kk][3] = pack4(p[e + 10], p[e + 11], p[e + 14], p[e + 15]);
    }
    const uint64_t desc_vt = hw::desc_kmajor_sw64(sm.vt[i % kStages]);
    hw::fence_regs(acc);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      hw::wgmma_s8_rs_n64(acc, pa[kk], desc_vt + kk * kKStep, 1);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(acc);
    hw::fence_regs(pa);
    release(i);
  }

  // full row sums, out = bf16((float(o) / l) * sv)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
    }
  }
  const float lf[2] = {static_cast<float>(l[0]), static_cast<float>(l[1])};
  const int cols = heads * kD;
  __nv_bfloat16* ob = o + static_cast<size_t>(b) * n * cols + col;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* orow = ob + static_cast<size_t>(row) * cols;
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) {
      const int i = j8 * 4 + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(orow + j8 * 8 + t4 * 2) =
          __floats2bfloat162_rn(
              __fmul_rn(__fdiv_rn(__int2float_rn(acc[i]), lf[r]), sv),
              __fmul_rn(__fdiv_rn(__int2float_rn(acc[i + 1]), lf[r]), sv));
    }
  }
}

// The pre-pass: vt (b, h, 64 dims, npad keys) int8, npad = n rounded up
// to 16, holding v^T with each 16-key group's keys at perm_key of their
// position and zero for keys at or beyond n; one block per (64-key tile,
// head, batch) through a shared tile (load_v_t's layout, then coalesced
// 16-byte stores).  v: the qkv's v columns, row stride c3 bytes.
__global__ void __launch_bounds__(kThreads)
    transpose_v_kernel(const int8_t* __restrict__ v, int8_t* __restrict__ vt,
                       int n, int npad, int c3) {
  constexpr int kLd = kRows + 16;  // row stride of the shared tile (bytes)
  __shared__ __align__(16) int8_t tile[kD * kLd];
  const int k0 = blockIdx.x * kRows;
  const int head = blockIdx.y;
  const size_t b = blockIdx.z;
  load_v_t<kD>(tile, kLd, v + b * n * static_cast<size_t>(c3) + head * kD,
               k0, n, kD, c3);
  __syncthreads();
  int8_t* out = vt + (b * gridDim.y + head) * kD * static_cast<size_t>(npad);
#pragma unroll
  for (int i = 0; i < kTile / 16 / kThreads; ++i) {
    const int task = i * kThreads + threadIdx.x;
    const int dim = task >> 2;
    const int k16 = (task & 3) * 16;
    if (k0 + k16 < npad) {
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(dim) * npad + k0 +
                                k16) =
          *reinterpret_cast<const uint4*>(&tile[dim * kLd + k16]);
    }
  }
}

}  // namespace wg

// Which kernel a call takes (shared with ops/flash_attention.py:
// attention_int8_route): head dim 64 the wgmma kernel, 16, 32 and 48 the
// mma.sync kernel.  The codes are attention.cu's.
enum Route : int { kRouteMma = 1, kRouteWgmma = 2 };

constexpr int route(int d) { return d == wg::kD ? kRouteWgmma : kRouteMma; }

// The wgmma route: the pre-pass into vt, then the kernel on rank-3 maps of
// q and k (the qkv's column blocks at the head's offset) and of vt.  A map
// that does not encode fails the call: nothing falls back.
int launch_wgmma(const void* qkv, const void* amax, void* o, void* vt, int b,
                 int n, int h, float scale, cudaStream_t stream) {
  namespace hw = stt::hopper;
  const int c = h * wg::kD;
  const long long c3 = 3LL * c;
  const int npad = (n + 15) / 16 * 16;
  const int8_t* base = static_cast<const int8_t*>(qkv);
  CUtensorMap tq, tk, tvt;
  if (!hw::tile_map_i8(&tq, base, c, n, b, c3, c3 * n,
                       CU_TENSOR_MAP_SWIZZLE_64B) ||
      !hw::tile_map_i8(&tk, base + c, c, n, b, c3, c3 * n,
                       CU_TENSOR_MAP_SWIZZLE_64B) ||
      !hw::tile_map_i8(&tvt, vt, npad, wg::kD, b * h, npad,
                       static_cast<long long>(wg::kD) * npad,
                       CU_TENSOR_MAP_SWIZZLE_64B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + wg::kRows - 1) / wg::kRows, h, b);
  wg::transpose_v_kernel<<<grid, wg::kThreads, 0, stream>>>(
      base + 2 * c, static_cast<int8_t*>(vt), n, npad, static_cast<int>(c3));
  constexpr int smem = static_cast<int>(sizeof(wg::Smem)) + 1024;
  const cudaError_t err = cudaFuncSetAttribute(
      wg::attn_int8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wg::attn_int8_wgmma_kernel<<<grid, wg::kThreads, smem, stream>>>(
      tq, tk, tvt, static_cast<const float*>(amax),
      static_cast<__nv_bfloat16*>(o), n, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel E2.  qkv: (b, n, 3 h d) int8, contiguous, [q | k | v] columns each
// (h, d)-major, per-head codes against amax: (3, h) fp32 in device memory.
// o: (b, n, h d) bf16, contiguous.  d must be a multiple of 16 and at most
// 64 (the static ViT's int8_attn geometry: a head dim that divides 128 and
// is no multiple of it); qkv must be 16-byte aligned.  vt: on the wgmma
// route (route(), d = 64), scratch of b * h * 64 * npad bytes, npad = n
// rounded up to a multiple of 16, for the pre-pass's v^T; unused on the
// mma.sync route.
extern "C" int stt_attention_int8(const void* qkv, const void* amax, void* o,
                                  void* vt, int b, int n, int h, int d,
                                  float scale, void* stream) {
  if (b <= 0 || n <= 0 || h <= 0 || d <= 0 || d % 16 != 0 || d > 64 ||
      b > 65535 || h > 65535 || amax == nullptr ||
      static_cast<long long>(n) * 3 * h * d >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route(d) == kRouteWgmma) {
    if (vt == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma(qkv, amax, o, vt, b, n, h, scale, s);
  }
  if (d <= 32) {
    launch<32>(qkv, amax, o, b, n, h, d, scale, s);
  } else {
    launch<64>(qkv, amax, o, b, n, h, d, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The route an E2 call at head dim d (as the kernel takes it: a multiple of
// 16 up to 64) takes: 1 the mma.sync kernel, 2 the wgmma kernel; -1 for what
// the entry point refuses.
extern "C" int stt_attention_int8_route(int d) {
  if (d <= 0 || d % 16 != 0 || d > 64) return -1;
  return route(d);
}
