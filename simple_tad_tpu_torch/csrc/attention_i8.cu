// Non-causal inference attention on int8-stored packed qkv with an int8
// output (kernel B2).
//
// Replaces the TPU kernel simple_tad_tpu/ops/flash_attention.py:
// _fwd_kernel_nomax_packed_q8io with _attend_rows_t(qk_scale_i8=...),
// launched by flash_attention_qkv_i8d with out_amax: the attention of the
// int8 static serving path.  q, k and v are read in place from the
// (B, N, 3C) int8 qkv through base pointers at columns 0, C and 2C plus
// h * Dh and the row stride, as kernel A1 reads the bf16 one.
//
// With a (batch, row) stride pair per operand and a key count of its own
// (n_kv <= N), the same kernel is D2: it replaces
// _fwd_kernel_nomax_packed_kv_q8io (the key-grid kernel flash_attention_i8d
// launches for InternVideo2's N = 2049) and _fwd_kernel_nomax_packed_q8io on
// separate operands (its single-pass branch), both with int8 out.  q, k and
// v are separate (B, N, C) int8 tensors there (q and k quantized after the
// RMS q/k-norm, v from the qkv projection); keys at or beyond n_kv are
// masked by index, as the TPU kernels' mask_keys masks a model-level
// sequence pad.  The key grid is a TPU VMEM plan whose partial sums add up
// to the result this kernel's loop over key tiles computes.
//
// Numerics held to the plain version (ops/flash_attention.py), per head h
// with sq, sk, sv = amax[0..2, h] / 127:
//   * s = float(q_i8 . k_i8 as an exact int32) * (sq * sk * scale * log2e);
//   * v = bf16(float(v_i8) * sv) (the TPU kernel computes in bf16 whatever
//     the model dtype);
//   * p = exp2(s - m) rounded to bf16, the denominator sums the rounded p,
//     o = (p v) / denominator in fp32;
//   * out = clip(round_half_even(o * 127 / out_amax), +-127) as int8;
//   * keys >= n_kv are masked in registers (no padding copy).
// m is A1's online row maximum rounded up to an integer: every rescale is
// an exact power of two, so the rounded probabilities are the TPU kernel's
// max-free ones times 2^-m and the result is the max-free one.
//
// What bounds it on the H100: at (32, 1568, 2304), H = 12, it does 1.2e11
// int8 ops (QK) and 1.2e11 bf16 flops (PV) against 154 MB moved (0.06 ms
// of tensor cores, 0.05 ms of memory), and its softmax evaluates
// B H N^2 = 9.4e8 exp2 on the special-function units, 16 lanes an SM a
// clock: 0.226 ms at 1980 MHz, the bound.  Two routes by head dim (route()
// below, ops/flash_attention.py:attention_i8_route):
//   * head dims 64 to 128 (every int8 trunk the jobs run at 64: ViT-S/B/L,
//     IV2-S/B; IV2-1B's 88 and IV2-6B's 128 on the static int8
//     InternVideo2's D2, ViT-H's 80), the wgmma kernel (namespace wg),
//     attention.cu's bf16 wgmma forward with an s8 QK, a template on the
//     tile width DP = 64 or 128 (route_tile: 64 at 64, 128 at 72-128,
//     where a 96-column tile read slower): one warpgroup per (64-query
//     tile, head,
//     batch); the q tile and a ring of (k, v) tiles arrive by TMA (rank-3
//     maps over (batch, row, column), the packed qkv's row stride 3C or
//     D2's own stride pairs; int8 q and k in one column atom of 64 or 128
//     codes with the swizzle of that span; rows at or beyond n or n_kv read
//     as zero), starting at the head's first column rounded down to a
//     multiple of 16 (an odd head at d = 8 (mod 16) starts 8 columns
//     early: IV2-1B's 88 is read in place, with no padding copy), the
//     columns that are not the head's zeroed in q so that the neighbours'
//     codes add exactly 0 to S; S = Q K^T by s8 wgmma m64n64k32 (DP / 32
//     k-steps, exact int32); the online softmax and the bf16 pack of P are
//     attention.cu's (attention_wg.cuh); O += bf16(P) V by bf16 wgmma
//     m64nDPk16 with P from registers and V read MN-major through the
//     descriptor's transpose bit (s8 wgmma takes K-major operands only, so
//     V cannot be an int8 B operand).  V = bf16(float(v) * sv) comes from a
//     pre-pass that dequantizes it once a call into a (B, N, C) bf16
//     scratch (0.12 GB of traffic at ViT-B batch 32) and reaches the ring by
//     TMA as attention.cu's bf16 v does; every query tile of a head would
//     otherwise convert the head's whole V again (9.6e8 conversions a call;
//     that in-kernel form, staged, read 1.21x slower, PERF.md).  The
//     epilogue stores the head's d columns of O only.
//   * the padded head dims 16 to 48 (no trunk of the jobs; the wrappers pad
//     8, 24 and 40 to 16, 32 and 48, and 56 to 64, the wgmma route's), the
//     mma.sync kernel attn_fwd_i8_kernel in A1's FlashAttention-2
//     shape: one block of 4 warps per (64-query tile, head, batch); each
//     warp owns 16 query rows whose int8 Q fragments stay in registers;
//     64-key int8 K tiles and dequantized, transposed bf16 V tiles stream
//     through shared memory by synchronous 16-byte loads.  QK runs on
//     mma.sync m16n8k32 s8 x s8 -> s32 (exact), PV on bf16 m16n8k16 with
//     fp32 accumulators.  The s32 accumulator fragment of m16n8k32 has the
//     (16x8, 4 values a thread) layout of the fp32 one of m16n8k16, and an
//     int8 A/B fragment holds in each 32-bit register the 4 bytes a bf16
//     one holds at the same byte offsets, so the tile addressing is A1's in
//     bytes and the scores become the PV A fragments in registers exactly
//     as in A1.  Dh is zero-padded to a multiple of 32 (the QK depth) in
//     shared memory: Dh = 48 runs as 64.
// The two routes hold the same numerics; their fp32 PV sums run in another
// order, so their codes may differ where a value sits at a rounding edge
// (so may the wgmma route's at d = 8 (mod 16), whose odd heads' PV sums run
// over other columns of the tile than its even heads').
#include <math.h>

#include "attention_wg.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using stt::as_u32;
using stt::mma_16816;
using stt::mma_16832_s8;

constexpr int kBlockM = 64;    // query rows per block
constexpr int kBlockN = 64;    // keys per tile
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr float kLog2e = 1.4426950408889634f;

// (batch, row) strides in elements of q, k, v and the output
struct Strides {
  int q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn;
};

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy a (ROWS x DP) int8 tile, rows starting at row0 of a strided source,
// into shared memory (row stride ld bytes) in 16-byte chunks.  Rows >= n
// and columns >= d read as zero (d % 16 == 0).
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile_i8(int8_t* dst, int ld,
                                             const int8_t* src, int row0,
                                             int n, int d, int row_stride) {
  constexpr int kChunks = DP / 16;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n && col < d) {
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * row_stride + col);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + col) = val;
  }
}

// The V tile, dequantized to bf16(float(v) * sv) and stored transposed:
// element (key r, dim c) lands at dst[c * ld + r].
template <int DP>
__device__ __forceinline__ void load_v_t(bf16* dst, int ld, const int8_t* src,
                                         int row0, int n, int d,
                                         int row_stride, float sv) {
  constexpr int kChunks = DP / 16;
  for (int c = threadIdx.x; c < kBlockN * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n && col < d) {
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * row_stride + col);
    }
    const int8_t* e = reinterpret_cast<const int8_t*>(&val);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      dst[(col + i) * ld + r] =
          __float2bfloat16_rn(__fmul_rn(static_cast<float>(e[i]), sv));
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_i8_kernel(const int8_t* __restrict__ q,
                       const int8_t* __restrict__ k,
                       const int8_t* __restrict__ v,
                       const float* __restrict__ amax,
                       const float* __restrict__ out_amax,
                       int8_t* __restrict__ o, int n, int n_kv, int d,
                       Strides st, float scale) {
  constexpr int KS = DP + 16;       // row stride of the Q/K tile (bytes)
  constexpr int VS = kBlockN + 8;   // row stride of the transposed V tile
  constexpr int KSTEPS = DP / 32;   // k-steps of the QK product
  constexpr int NT = kBlockN / 8;   // 8-key column tiles of S
  constexpr int DT = DP / 8;        // 8-wide column tiles of O
  // sK stages the Q tile first, then each K tile
  __shared__ __align__(16) int8_t sK[kBlockN * KS];
  __shared__ __align__(16) bf16 sVt[DP * VS];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row within the 8-row group of a fragment
  const int t4 = lane & 3;  // thread within the group
  const int head = blockIdx.y;
  const int heads = gridDim.y;
  const int q0 = blockIdx.x * kBlockM;
  const size_t batch = blockIdx.z;
  const size_t hoff = static_cast<size_t>(head) * d;
  const int8_t* qb = q + batch * st.q_sb + hoff;
  const int8_t* kb = k + batch * st.k_sb + hoff;
  const int8_t* vb = v + batch * st.v_sb + hoff;

  // per-head scales, in the plain version's order of fp32 operations
  const float sq = amax[head] * (1.f / 127.f);
  const float sk = amax[heads + head] * (1.f / 127.f);
  const float sv = amax[2 * heads + head] * (1.f / 127.f);
  const float sscale = sq * sk * scale * kLog2e;

  // 1. int8 Q tile -> registers, as m16n8k32 A fragments
  load_tile_i8<DP, kBlockM>(sK, KS, qb, q0, n, d, st.q_sn);
  __syncthreads();
  uint32_t qf[KSTEPS][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 32 + t4 * 4;
    qf[kk][0] = ld32(&sK[r0 * KS + c]);
    qf[kk][1] = ld32(&sK[(r0 + 8) * KS + c]);
    qf[kk][2] = ld32(&sK[r0 * KS + c + 16]);
    qf[kk][3] = ld32(&sK[(r0 + 8) * KS + c + 16]);
  }
  __syncthreads();

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  // rows r0 and r0 + 8: running integer max and partial denominators
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < n_kv; k0 += kBlockN) {
    load_tile_i8<DP, kBlockN>(sK, KS, kb, k0, n_kv, d, st.k_sn);
    load_v_t<DP>(sVt, VS, vb, k0, n_kv, d, st.v_sn, sv);
    __syncthreads();

    // 2. S = float(q_i8 k_i8^T) * sq sk scale log2e, 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      int si[4] = {0, 0, 0, 0};
      const int8_t* krow = &sK[(j * 8 + g) * KS + t4 * 4];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        mma_16832_s8(si, qf[kk], ld32(krow + kk * 32), ld32(krow + kk * 32 + 16));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = __fmul_rn(static_cast<float>(si[i]), sscale);
      }
    }
    if (k0 + kBlockN > n_kv) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int key = k0 + j * 8 + t4 * 2;
        if (key >= n_kv) s[j][0] = s[j][2] = -INFINITY;
        if (key + 1 >= n_kv) s[j][1] = s[j][3] = -INFINITY;
      }
    }

    // 3. online softmax with an integer running max (as A1)
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

  // 5. full row denominators, normalise, int8 codes against out_amax
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float oinv = stt::quant_inv(out_amax);
  const int row0 = q0 + r0;
  const int row1 = row0 + 8;
  int8_t* ob = o + batch * st.o_sb + hoff;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + t4 * 2;
    if (col >= d) continue;
    if (row0 < n) {
      *reinterpret_cast<char2*>(ob + static_cast<size_t>(row0) * st.o_sn + col) =
          make_char2(stt::quant_i8(__fdiv_rn(acc[j][0], l0), oinv),
                     stt::quant_i8(__fdiv_rn(acc[j][1], l0), oinv));
    }
    if (row1 < n) {
      *reinterpret_cast<char2*>(ob + static_cast<size_t>(row1) * st.o_sn + col) =
          make_char2(stt::quant_i8(__fdiv_rn(acc[j][2], l1), oinv),
                     stt::quant_i8(__fdiv_rn(acc[j][3], l1), oinv));
    }
  }
}

template <int DP>
void launch(const void* q, const void* k, const void* v, const void* amax,
            const void* out_amax, void* o, int b, int n, int n_kv, int h,
            int d, const Strides& st, float scale, cudaStream_t stream) {
  const dim3 grid((n + kBlockM - 1) / kBlockM, h, b);
  attn_fwd_i8_kernel<DP><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(amax),
      static_cast<const float*>(out_amax), static_cast<int8_t*>(o), n, n_kv,
      d, st, scale);
}

// ---- the wgmma route: head dims 64 to 128 ----
namespace wg {

namespace hw = stt::hopper;
namespace aw = stt::attn_wg;

constexpr int kMinD = 64;                     // the route's least head dim
constexpr int kRows = aw::kTile;              // queries a block, keys a tile
constexpr int kThreads = 128;                 // one warpgroup a block
constexpr int kStages = 2;                    // the ring of (k, v) tiles

// the bf16 V tile's column atoms and where a head's columns sit in its
// tiles (attention_wg.cuh, as the bf16 kernels)
using aw::head_cols;
using aw::Tile;

// A (64-row, DP-column) tile of int8 q or k codes: one TMA box swizzled by
// its row of DP bytes (64-byte at DP = 64, 128-byte at 128).  As a K-major
// s8 operand (rows along M or N) its 8-row groups are 8 * DP bytes apart
// (SBO) and k32 step kk starts 32 bytes on.
template <int DP>
struct I8Tile {
  static_assert(DP == 64 || DP == 128, "a route_tile");
  static constexpr int kBytes = kRows * DP;
  static constexpr uint32_t kLayout = DP == 128 ? 1 : 2;
  static constexpr CUtensorMapSwizzle kSwizzle =
      DP == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  __host__ __device__ static constexpr int kk_offset(int kk) {
    return (kk * 32) >> 4;
  }
  __device__ static uint64_t kmajor(const int8_t* t) {
    return hw::desc_sw(t, 16, 8 * DP, kLayout);
  }
};

// Shared memory of one block: the ring's bf16 V tiles first (the
// dequantize pre-pass's output, by TMA in Tile<DP>'s atoms), then the
// swizzled int8 q and k tiles; every member starts on a multiple of 1024
// bytes (each tile's size is one), as the 128-byte swizzle needs.
template <int DP>
struct Smem {
  bf16 v[kStages][kRows * DP];    // B of PV (MN-major)
  int8_t q[kRows * DP];           // A of S (K-major)
  int8_t k[kStages][kRows * DP];  // B of S (K-major)
  uint64_t full[kStages], qbar;
};

// blocks an SM the registers are budgeted for: four at DP = 64, two at
// 128 (64 fp32 O accumulators beside S's 32 s32 and 32 fp32, as the bf16
// kernel); ptxas's registers and the blocks an SM
// (stt_attention_i8_occupancy) are printed by chip_smoke.py (PERF.md).
template <int DP>
constexpr int kMinBlocks = DP == 64 ? 4 : 2;

// The route's tile width at head dim d: 64 at 64, 128 at 72 to 128.  A
// 96-column tile (32-byte-swizzled int8 atoms) ran 1.11-1.19x slower than
// the 128-column one at head dim 88 on the H100, its products a quarter
// smaller (PERF.md), and is not instantiated.
constexpr int route_tile(int d) { return d <= 64 ? 64 : 128; }

// One block per (64-query tile, head, batch), one warpgroup.  The q tile
// and a ring of (k, v) tiles arrive by TMA (rank-3 maps; q and k int8 in
// I8Tile<DP>'s box, v bf16 in Tile<DP>'s atoms; rows at or beyond n or n_kv,
// and columns beyond the operand's, read as zero); thread 0 refills a stage
// once the block's barrier at the end of its tile shows every warp done
// with it.  A tile is DP columns that hold the head's d, starting at the
// head's first column rounded down to a multiple of 16 (head_cols: at
// d = 8 (mod 16) an odd head's tiles start with the previous head's last 8
// columns, and any tile may end in the next head's first columns).  Those
// columns of q are zeroed once, so the neighbours' k codes add exactly 0
// to S: int8 codes have no NaN or infinity, so unlike the bf16 kernels this
// route has no precondition on k or v.  S = Q K^T by s8 wgmma m64n64k32
// from shared memory (DP / 32 k-steps across the atoms, exact int32), the
// scores s = fl(float(si) * sscale), the online softmax and the pack of
// bf16(P) (attention_wg.cuh, as the bf16 kernel), O += bf16(P) V by bf16
// wgmma m64nDPk16 with P from registers and V MN-major; V is
// bf16(float(v) * sv), made by the pre-pass.  The epilogue stores the
// head's d columns of O as int8 codes against out_amax (round half to
// even); the neighbours' columns are computed and not stored.
template <int DP>
__global__ void __launch_bounds__(kThreads, kMinBlocks<DP>)
    attn_fwd_i8_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const float* __restrict__ amax,
                             const float* __restrict__ out_amax,
                             int8_t* __restrict__ o, int n, int n_kv, int d,
                             int o_sb, int o_sn, float scale) {
  using QT = I8Tile<DP>;
  using VT = Tile<DP>;
  extern __shared__ unsigned char smem_raw[];
  Smem<DP>& sm = *reinterpret_cast<Smem<DP>*>(hw::align_1024(smem_raw));
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kRows;
  const int head = blockIdx.y;
  const int heads = gridDim.y;
  const int b = blockIdx.z;
  const int tiles = (n_kv + kRows - 1) / kRows;
  // the head dim, and the head's columns [shift, shift + dh) of the tiles,
  // which start at column col0 of the operands (a multiple of 16)
  const aw::HeadCols hc = head_cols<DP>(head, d);
  const int dh = hc.d, col0 = hc.col0, shift = hc.shift;
  auto fill = [&](int j) {
    const int s = j % kStages;
    if (tid == 0) {
      hw::mbar_expect_tx(&sm.full[s], QT::kBytes + VT::kBytes);
      hw::tma_load_3d(sm.k[s], &tk, &sm.full[s], col0, j * kRows, b);
      VT::load(sm.v[s], &tv, &sm.full[s], col0, j * kRows, b);
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) hw::mbar_init(&sm.full[s], 1);
    hw::mbar_init(&sm.qbar, 1);
    hw::mbar_init_fence();
    hw::mbar_expect_tx(&sm.qbar, QT::kBytes);
    hw::tma_load_3d(sm.q, &tq, &sm.qbar, col0, q0, b);
  }
  __syncthreads();
  for (int j = 0; j < kStages && j < tiles; ++j) fill(j);

  // per-head scales, in the plain version's order of fp32 operations
  const float sq = amax[head] * (1.f / 127.f);
  const float sk = amax[heads + head] * (1.f / 127.f);
  const float sscale = sq * sk * scale * kLog2e;

  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t4 = tid & 3;
  const uint64_t desc_q = QT::kmajor(sm.q);
  hw::mbar_wait(&sm.qbar, 0);
  if constexpr (DP != 64) {  // at 64 the whole tile is the head's
    hw::zero_i8_window<DP>(sm.q, shift, shift + dh);
    __syncthreads();
  }

  float acc[DP / 2], sc[32], m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f}, a[2];
  int si[32] = {};
  uint32_t pf[4][4];
  hw::zero(acc);
  for (int j = 0; j < tiles; ++j) {
    const int s = j % kStages;
    hw::mbar_wait(&sm.full[s], (j / kStages) & 1);
    // S = q_i8 k_i8^T: 64 queries x 64 keys, exact int32
    const uint64_t desc_k = QT::kmajor(sm.k[s]);
    hw::fence_regs(si);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 32; ++kk) {
      hw::wgmma_s8_n64(si, desc_q + QT::kk_offset(kk),
                       desc_k + QT::kk_offset(kk), kk);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(si);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = __fmul_rn(static_cast<float>(si[i]), sscale);
    }
    aw::tile_softmax(sc, j * kRows, n_kv, t4, m, a);
    aw::rescale_and_pack(acc, sc, a, l, pf);

    // O += bf16(P) V  (64 queries x DP dims)
    const uint64_t desc_v = VT::mnmajor(sm.v[s]);
    hw::fence_regs(acc);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      hw::wgmma_rs_mn(acc, pf[kk], desc_v + kk * VT::kMnStep, 1);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(acc);
    hw::fence_regs(pf);
    __syncthreads();  // every warp is done with stage s: refill it
    if (j + kStages < tiles) fill(j + kStages);
  }

  // full row denominators, normalise, int8 codes of the head's d columns
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
    }
  }
  aw::store_rows_q8(o + static_cast<size_t>(b) * o_sb +
                        static_cast<size_t>(head) * dh,
                    acc, l, out_amax, q0 + warp * 16 + g, n, o_sn, t4, dh,
                    shift);
}

// The dequantize pre-pass: vbf (b, n, c) bf16, contiguous, rows below n_kv
// = bf16(float(v) * sv) of the column's head, 16 codes a thread (d is a
// multiple of 8, so each 8-code half of a chunk is one head's)
__global__ void dequantize_v_kernel(const int8_t* __restrict__ v,
                                    const float* __restrict__ amax,
                                    bf16* __restrict__ vbf, int n, int n_kv,
                                    int c, int d, int heads, int v_sb,
                                    int v_sn) {
  const int chunks = c / 16;
  const size_t batch = blockIdx.y;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < static_cast<long long>(n_kv) * chunks;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(i / chunks);
    const int c16 = static_cast<int>(i % chunks) * 16;
    const float sv[2] = {amax[2 * heads + c16 / d] * (1.f / 127.f),
                         amax[2 * heads + (c16 + 8) / d] * (1.f / 127.f)};
    const uint4 w = *reinterpret_cast<const uint4*>(
        v + batch * v_sb + static_cast<size_t>(row) * v_sn + c16);
    const int8_t* e = reinterpret_cast<const int8_t*>(&w);
    uint32_t out[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      out[t] = stt::as_u32(__floats2bfloat162_rn(
          __fmul_rn(static_cast<float>(e[2 * t]), sv[t / 4]),
          __fmul_rn(static_cast<float>(e[2 * t + 1]), sv[t / 4])));
    }
    uint4* dst = reinterpret_cast<uint4*>(
        vbf + (batch * n + row) * static_cast<size_t>(c) + c16);
    dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
    dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
  }
}

}  // namespace wg

// Which kernel a call takes (shared with ops/flash_attention.py:
// attention_i8_route): head dims 64 to 128 the wgmma kernel (tiles 64 or
// 128 columns wide: route_tile), the padded head dims 16 to 48 the
// mma.sync kernel.  The codes are attention.cu's.
enum Route : int { kRouteMma = 1, kRouteWgmma = 2 };

constexpr int route(int d) { return d >= wg::kMinD ? kRouteWgmma : kRouteMma; }

// The head dims the entry point takes: multiples of 16 up to 64 (the
// wrappers pad 8, 24, 40 and 56 to them), multiples of 8 from 64 to 128
// (read in place)
constexpr bool head_dim_ok(int d) {
  return d > 0 && d <= 128 && d % (d < wg::kMinD ? 16 : 8) == 0;
}

// The wgmma route at tile width DP: q and k by rank-3 int8 maps at the
// head's column offset (k ends at n_kv, q at n), v by a bf16 map over the
// pre-pass's output vbf; then the two launches on the stream.  A map that
// does not encode (a base or stride off 16 bytes) fails the call: nothing
// falls back to the mma.sync kernel.
template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* amax, const void* out_amax, void* o, void* vbf,
                 int b, int n, int n_kv, int h, int d, const Strides& st,
                 float scale, cudaStream_t stream) {
  namespace hw = stt::hopper;
  using QT = wg::I8Tile<DP>;
  const int c = h * d;
  CUtensorMap tq, tk, tv;
  const bool maps =
      hw::tile_map_i8(&tq, q, c, n, b, st.q_sn, st.q_sb, QT::kSwizzle,
                      DP) &&
      hw::tile_map_i8(&tk, k, c, n_kv, b, st.k_sn, st.k_sb, QT::kSwizzle,
                      DP) &&
      hw::tile_map_bf16(&tv, vbf, c, n_kv, b, c,
                        static_cast<long long>(n) * c, wg::Tile<DP>::kAtom);
  if (!maps) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = static_cast<long long>(n_kv) * (c / 16);
  const int blocks = static_cast<int>(
      chunks / 256 + 1 < 4096 ? chunks / 256 + 1 : 4096);
  wg::dequantize_v_kernel<<<dim3(blocks, b), 256, 0, stream>>>(
      static_cast<const int8_t*>(v), static_cast<const float*>(amax),
      static_cast<bf16*>(vbf), n, n_kv, c, d, h, st.v_sb, st.v_sn);
  constexpr int smem = static_cast<int>(sizeof(wg::Smem<DP>)) + 1024;
  const cudaError_t err = cudaFuncSetAttribute(
      wg::attn_fwd_i8_wgmma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + wg::kRows - 1) / wg::kRows, h, b);
  wg::attn_fwd_i8_wgmma_kernel<DP><<<grid, wg::kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<const float*>(amax),
      static_cast<const float*>(out_amax), static_cast<int8_t*>(o), n, n_kv,
      d, st.o_sb, st.o_sn, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: int8 base pointers of head 0 (for packed qkv: qkv, qkv + C,
// qkv + 2C); element (batch, row, head h, dim c) of q is at
// q + batch * q_sb + row * q_sn + h * d + c, and likewise for k, v and o
// (int8) with their own stride pairs.  Queries are rows 0..n-1; keys rows
// 0..n_kv-1 (1 <= n_kv <= n; the rest are masked).  amax: (3, h) fp32
// absmax of q, k and v per head; out_amax: one fp32 absmax of the output;
// both in device memory.  d: a multiple of 16 up to 64, or of 8 from 64 to
// 128 (head_dim_ok); every base pointer and stride must keep 16-byte
// alignment, and h * d be a multiple of 16 on the wgmma route (its tensor
// maps refuse any other, and the call fails).  vbf: on the wgmma route
// (route()), a (b, n, h d) bf16 scratch for the dequantize pre-pass (the
// call fails without it); unused on the mma.sync route.
extern "C" int stt_attention_i8(const void* q, const void* k, const void* v,
                                const void* amax, const void* out_amax,
                                void* o, void* vbf, int b, int n, int n_kv,
                                int h, int d, int q_sb, int q_sn, int k_sb,
                                int k_sn, int v_sb, int v_sn, int o_sb,
                                int o_sn, float scale, void* stream) {
  if (b <= 0 || n <= 0 || n_kv <= 0 || n_kv > n || h <= 0 ||
      !head_dim_ok(d) || b > 65535 || h > 65535 || amax == nullptr ||
      out_amax == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides st{q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route(d) == kRouteWgmma) {
    if (vbf == nullptr || h * d % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return wg::route_tile(d) == 64
               ? launch_wgmma<64>(q, k, v, amax, out_amax, o, vbf, b, n,
                                  n_kv, h, d, st, scale, s)
               : launch_wgmma<128>(q, k, v, amax, out_amax, o, vbf, b, n,
                                   n_kv, h, d, st, scale, s);
  }
  if (d <= 32) {
    launch<32>(q, k, v, amax, out_amax, o, b, n, n_kv, h, d, st, scale, s);
  } else {
    launch<64>(q, k, v, amax, out_amax, o, b, n, n_kv, h, d, st, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The route a B2 or D2 call at head dim d (as the kernel takes it:
// head_dim_ok) takes: 1 the mma.sync kernel, 2 the wgmma kernel; -1 for
// what the entry point refuses.
extern "C" int stt_attention_i8_route(int d) {
  if (!head_dim_ok(d)) return -1;
  return route(d);
}

// The wgmma kernel's blocks an SM at tile width `tile` (64 or 128), by
// the runtime's occupancy calculator at the shared memory its launch asks
// for (printed by chip_smoke.py's phase 2 beside the ptxas report).
extern "C" int stt_attention_i8_occupancy(int tile, int* blocks) {
#define STT_OCC(DP)                                                        \
  {                                                                        \
    constexpr int smem = static_cast<int>(sizeof(wg::Smem<DP>)) + 1024;    \
    cudaError_t err = cudaFuncSetAttribute(                                \
        wg::attn_fwd_i8_wgmma_kernel<DP>,                                  \
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);                \
    if (err == cudaSuccess) {                                              \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                 \
          blocks, wg::attn_fwd_i8_wgmma_kernel<DP>, wg::kThreads, smem);   \
    }                                                                      \
    return static_cast<int>(err);                                          \
  }
  switch (tile) {
    case 64: STT_OCC(64)
    case 128: STT_OCC(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef STT_OCC
}
