// Backward of the training attention: kernel C2 on the packed qkv, and
// kernel C3-bwd on separate q, k and v.
//
// C2 replaces the TPU kernel simple_tad_tpu/ops/flash_attention.py:
// _bwd_merged_kernel_packed, launched by _flash_bwd_packed_qkv_impl from the
// packed custom VJP's backward.  As there, q, k, v and the gradient are read
// and written in place on the (B, N, 3C) layout through its row stride and
// the column offsets 0, C and 2C plus h * Dh: dq, dk and dv land in the
// [dq | dk | dv] columns of one gradient tensor, with no relayout and no
// concatenation.
//
// C3-bwd is the same kernels given a (batch, row) stride pair for each of q,
// k and v (InternVideo2's training attention: q and k the q/k-norms' fresh
// outputs, v read in place as the column block of the qkv output, row
// stride 3C); dq, dk and dv are three contiguous (B, N, C) tensors, which one
// gradient stride pair and three base pointers address.  It replaces
// _flash_bwd_impl's TPU kernels on the (B*H, N, Dh) layout:
// _bwd_merged_kernel_dt (the default) and the forms its environment knobs
// select, _bwd_merged_kernel and _bwd_dq_kernel with _bwd_dkv_kernel, which
// compute the same function in other TPU orientations.  The packed entry
// point passes one stride pair three times.
//
// The inputs are q, k, v, the output gradient dout (B, N, C), the
// forward's base-2 lse (B, H, N) and delta = rowsum(dout * out) (B, H, N),
// both fp32.  delta is an input, as the JAX package computes it outside its
// kernels; the wrappers compute it with attn_delta_kernel below
// (stt_attention_delta), a pre-pass bound by its two reads of (B, N, C).
//
// Numerics held to the plain version (ops/flash_attention.py) and the TPU
// kernels: s = bf16(q * scale * log2 e) . k in fp32; p = exp2(s - lse) in
// fp32, 0 for keys and queries at or beyond N; dv = dout^T bf16(p);
// dp = dout v^T; ds = p (dp - delta); dk = q^T bf16(ds) * scale and
// dq = bf16(ds) k * scale with the raw (unscaled) q.  Rows of a pad query
// never read their lse, so a pad row cannot put a NaN into dk or dv.  The
// ragged tail (N = 2049 for InternVideo2) is masked by index: nothing is
// padded to the TPU's row multiple.
//
// What bounds it on the H100: per (batch, head) the backward does five
// N x N x Dh products (s, dp, dv, dk, dq; the dq kernel recomputes s and
// dp, so seven are executed) against ~7 N Dh 2-byte reads and writes: far
// above the card's ~295 flop/byte, so it is bound by tensor-core
// throughput.  The TPU kernel carries dq across a sequential key grid in
// VMEM; on the H100 blocks run in parallel in no order, so the work is
// split in two deterministic kernels without atomics (dk/dv per key tile,
// dq per query tile), each pair launched by one call.  Three routes, by
// dtype and head dim (route() below, ops/flash_attention.py:
// attention_bwd_route):
//   * bf16 at head dims 64 to 128 (every trunk the fine-tuning jobs run:
//     ViT-S/B/L, IV2-S/B/L at 64; ViT-H's 80, IV2-1B's 88 and IV2-6B's 128;
//     C2, C3-bwd and, with dropout, C4-bwd in either keep form), the wgmma
//     kernels (namespace wg), a template on the tile width DP = 64, 96 or
//     128 (attention_wg.cuh: tile_width, Tile, head_cols, the forward's
//     column scheme): one warpgroup per 64-row tile (keys in dk/dv, queries
//     in dq).  The streamed tiles (q and dout, or k and v) arrive by TMA
//     (rank-3 tensor maps over (batch, row, column), rows beyond N read as
//     zero) as DP / A column atoms of A = 64 or 32 columns (128- or 64-byte
//     swizzle) that start at the head's first column rounded down to 16,
//     into a two-stage ring on mbarriers, thread 0 refilling a stage after
//     the block's barrier at the end of its tile.  S^T = K Qs^T and
//     dP^T = V dout^T (dq: S = Qs K^T, dP = dout V^T) are wgmma m64n64k16
//     over DP / 16 k-steps with both operands K-major in shared memory;
//     dV += bf16(P^T) dout and dK += bf16(dS^T) q (dq: dQ += bf16(dS) K)
//     are wgmma m64nDPk16 with A from registers (the rounded fp32
//     accumulators, whose layout is the A-fragment layout) and B read
//     MN-major through the descriptor's transpose bit (its LBO stepping
//     from one column atom to the next): no transposed copy is staged, and
//     the swizzle leaves no bank conflicts.  The scaled copy of q is made in
//     shared memory from the raw tile as it lands, so s keeps its rounding;
//     where a tile is wider than the head, the neighbouring heads' columns
//     are zeroed in that copy and in dout (k and v must be finite there:
//     ops/flash_attention.py:attention_bwd_route) and not stored from dK,
//     dV or dQ.  p's exp2 runs on the special-function unit
//     (ex2.approx.ftz: exp2f's value wherever p is a normal float).  lse
//     and delta are read by the threads a tile ahead: a head's (B, H, N)
//     slice starts at any 4-byte offset (N = 2049), below TMA's 16-byte
//     alignment.  No producer warp: at DP = 64, 168 registers a 128-thread
//     block fit three times an SM and a 160-thread one twice; at 128 the
//     dk/dv kernel's dK and dV accumulators are 64 + 64 a thread (up to
//     255 registers), two blocks an SM, its shared memory request cut to
//     fit them (dkdv_smem_request);
//   * bf16 at head dims 8 to 56 (no trunk the jobs run), C4-bwd there too,
//     the mma.sync kernels:
//     one block of 4 warps per (64-key tile, head, batch); each warp owns 16
//     keys, whose K and V fragments stay in registers, and the block loops
//     over 64-query tiles (scaled Q and dout row-major for S^T = K Q^T and
//     dP^T = V dout^T, raw Q and dout transposed for dK += dS^T Q and
//     dV += P^T dout, all through shared memory, synchronous loads); P^T
//     and dS^T go from the fp32 accumulators straight into the A fragments
//     of the next products, as A1 does with P; dq: one block per (64-query
//     tile, head, batch), each warp keeping its 16 rows of scaled Q and
//     dout as fragments over 64-key tiles (K and V row-major, K
//     transposed), dQ += dS K;
//   * fp32 (tests, small shapes): two simple CUDA-core kernels with the
//     same split, one thread per key (dk/dv) or per query (dq), 16-row
//     tiles in shared memory.
// Row offsets inside a (batch, head) stay 32-bit, as in common.cuh's tile
// loader.
//
// With a keep source (kernel C4-bwd, stt_attention_bwd_drop) the kernels
// take DROP (philox.cuh): in the wgmma kernels a tile's 32 keep bits a
// thread are drawn (Philox) or read from shared memory (the mask form's
// 64 x 64 int8 tile, staged with the streamed operands by copy_mask_tile)
// before the tile's first products, so only those bits stay live across
// them.
#include <math.h>

#include "attention_wg.cuh"
#include "common.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace {

using bf16 = __nv_bfloat16;
using stt::Drop;
using stt::Keep;
using stt::as_u32;
using stt::ld32;
using stt::mma_16816;

constexpr int kTile = 64;      // keys per dk/dv block, queries per dq block,
                               // and rows per streamed tile
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kTileF32 = 16;   // streamed rows per tile (fp32 kernels)
constexpr int kThreadsF32 = 64;

// (batch, row) strides in elements of q, k, v, dout and the gradients
struct Strides {
  int q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, do_sb, do_sn, g_sb, g_sn;
};

// offset of (batch, head) in an operand with batch stride sb
__device__ __forceinline__ size_t head_off(int sb, int d) {
  return static_cast<size_t>(blockIdx.z) * sb +
         static_cast<size_t>(blockIdx.y) * d;
}

template <int DP, int ROWS, bool TRANSPOSE, bool SCALE>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          int row0, int n, int d,
                                          int row_stride, float qscale) {
  stt::load_tile<DP, ROWS, TRANSPOSE, SCALE, kThreads>(
      dst, ld, src, row0, n, d, row_stride, qscale);
}

// A fragments (m16n8k16) of this warp's 16 rows of a row-major tile
template <int KSTEPS>
__device__ __forceinline__ void load_frags(uint32_t (&f)[KSTEPS][4],
                                           const bf16* tile, int ld, int r0,
                                           int t4) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + t4 * 2;
    f[kk][0] = ld32(&tile[r0 * ld + c]);
    f[kk][1] = ld32(&tile[(r0 + 8) * ld + c]);
    f[kk][2] = ld32(&tile[r0 * ld + c + 8]);
    f[kk][3] = ld32(&tile[(r0 + 8) * ld + c + 8]);
  }
}

template <int DP>
constexpr int dkdv_smem_bytes() {
  return (2 * kTile * (DP + 8) + 2 * DP * (kTile + 8)) * 2 + 2 * kTile * 4;
}

template <int DP>
constexpr int dq_smem_bytes() {
  return (2 * kTile * (DP + 8) + DP * (kTile + 8)) * 2;
}

// With DROP (kernel C4-bwd) dV takes bf16(P^T keep / keep_prob) and dP^T
// is scaled by keep / keep_prob before dS^T = P^T (dP^T - delta), as the
// JAX drop backward (_bwd_dkv_kernel_drop, _bwd_merged_kernel_drop_rng);
// the keep bits are read transposed (rows are keys here; philox.cuh).
template <int DP, Drop DROP = Drop::kNone>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int n, int d, Strides st, float qscale,
                              float scale, Keep kp) {
  constexpr int KS = DP + 8;       // row stride of row-major tiles
  constexpr int TS = kTile + 8;    // row stride of transposed tiles
  constexpr int KSTEPS = DP / 16;
  constexpr int NT = kTile / 8;    // 8-query column tiles of S^T
  constexpr int DT = DP / 8;       // 8-wide column tiles of dK, dV
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);   // scaled q, row-major
  bf16* sO = sQ + kTile * KS;                 // dout, row-major
  bf16* sQt = sO + kTile * KS;                // raw q, transposed
  bf16* sOt = sQt + DP * TS;                  // dout, transposed
  float* sL = reinterpret_cast<float*>(sOt + DP * TS);
  float* sD = sL + kTile;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int k0 = blockIdx.x * kTile;
  const int r0 = warp * 16 + g;
  const size_t row_off =
      (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * n;
  const bf16* qb = q + head_off(st.q_sb, d);
  const bf16* ob = dout + head_off(st.do_sb, d);

  // this warp's 16 keys of K and V -> registers
  load_tile<DP, kTile, false, false>(sQ, KS, k + head_off(st.k_sb, d), k0, n,
                                     d, st.k_sn, 0.f);
  load_tile<DP, kTile, false, false>(sO, KS, v + head_off(st.v_sb, d), k0, n,
                                     d, st.v_sn, 0.f);
  __syncthreads();
  uint32_t kf[KSTEPS][4], vf[KSTEPS][4];
  load_frags<KSTEPS>(kf, sQ, KS, r0, t4);
  load_frags<KSTEPS>(vf, sO, KS, r0, t4);
  __syncthreads();

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  }

  const int bh = stt::rng_head(kp, blockIdx.z, blockIdx.y);
  const int8_t* mh = DROP == Drop::kMask ? stt::mask_head(kp) : nullptr;

  for (int q0 = 0; q0 < n; q0 += kTile) {
    load_tile<DP, kTile, false, true>(sQ, KS, qb, q0, n, d, st.q_sn, qscale);
    load_tile<DP, kTile, true, false>(sQt, TS, qb, q0, n, d, st.q_sn, 0.f);
    load_tile<DP, kTile, false, false>(sO, KS, ob, q0, n, d, st.do_sn, 0.f);
    load_tile<DP, kTile, true, false>(sOt, TS, ob, q0, n, d, st.do_sn, 0.f);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool ok = q0 + i < n;
      sL[i] = ok ? lse[row_off + q0 + i] : 0.f;
      sD[i] = ok ? delta[row_off + q0 + i] : 0.f;
    }
    uint32_t keep = 0;
    if constexpr (DROP != Drop::kNone) {
      keep = stt::keep_bits<DROP, true, NT>(kp, mh, bh, k0 + r0, q0, t4, n);
    }
    __syncthreads();

    // S^T = K (q * scale * log2e)^T and dP^T = V dout^T: 16 keys x 64 queries
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      const bf16* qrow = &sQ[(j * 8 + g) * KS + t4 * 2];
      const bf16* orow = &sO[(j * 8 + g) * KS + t4 * 2];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        mma_16816(st[j], kf[kk], ld32(qrow + kk * 16), ld32(qrow + kk * 16 + 8));
        mma_16816(dpt[j], vf[kk], ld32(orow + kk * 16),
                  ld32(orow + kk * 16 + 8));
      }
    }

    // P^T = exp2(S^T - lse), dS^T = P^T (dP^T - delta); queries >= n are 0.
    // The accumulator layout of query tiles 2kk and 2kk+1 is the A fragment
    // layout of k-step kk of the next two products.
    uint32_t pf[NT / 2][4], dsf[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + t4 * 2;
      const bool ok0 = q0 + c < n;
      const bool ok1 = q0 + c + 1 < n;
      const float p00 = ok0 ? exp2f(st[j][0] - sL[c]) : 0.f;
      const float p01 = ok1 ? exp2f(st[j][1] - sL[c + 1]) : 0.f;
      const float p10 = ok0 ? exp2f(st[j][2] - sL[c]) : 0.f;
      const float p11 = ok1 ? exp2f(st[j][3] - sL[c + 1]) : 0.f;
      if constexpr (DROP == Drop::kNone) {
        pf[j / 2][(j % 2) * 2] = as_u32(__floats2bfloat162_rn(p00, p01));
        pf[j / 2][(j % 2) * 2 + 1] = as_u32(__floats2bfloat162_rn(p10, p11));
      } else {
        const float f = kp.inv_keep;
        const float f00 = stt::keep_factor(keep, j, 0, f);
        const float f01 = stt::keep_factor(keep, j, 1, f);
        const float f10 = stt::keep_factor(keep, j, 2, f);
        const float f11 = stt::keep_factor(keep, j, 3, f);
        pf[j / 2][(j % 2) * 2] =
            as_u32(__floats2bfloat162_rn(p00 * f00, p01 * f01));
        pf[j / 2][(j % 2) * 2 + 1] =
            as_u32(__floats2bfloat162_rn(p10 * f10, p11 * f11));
        dpt[j][0] *= f00;
        dpt[j][1] *= f01;
        dpt[j][2] *= f10;
        dpt[j][3] *= f11;
      }
      const float ds00 = p00 * (dpt[j][0] - sD[c]);
      const float ds01 = p01 * (dpt[j][1] - sD[c + 1]);
      const float ds10 = p10 * (dpt[j][2] - sD[c]);
      const float ds11 = p11 * (dpt[j][3] - sD[c + 1]);
      dsf[j / 2][(j % 2) * 2] = as_u32(__floats2bfloat162_rn(ds00, ds01));
      dsf[j / 2][(j % 2) * 2 + 1] = as_u32(__floats2bfloat162_rn(ds10, ds11));
    }

    // dV += bf16(P^T) dout;  dK += bf16(dS^T) q
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const bf16* orow = &sOt[(j * 8 + g) * TS + kk * 16 + t4 * 2];
        mma_16816(dva[j], pf[kk], ld32(orow), ld32(orow + 8));
        const bf16* qrow = &sQt[(j * 8 + g) * TS + kk * 16 + t4 * 2];
        mma_16816(dka[j], dsf[kk], ld32(qrow), ld32(qrow + 8));
      }
    }
    __syncthreads();  // the next query tile overwrites the tiles
  }

  const int key0 = k0 + r0;
  const int key1 = key0 + 8;
  const size_t g_off = head_off(st.g_sb, d);
  bf16* dkb = dk + g_off;
  bf16* dvb = dv + g_off;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + t4 * 2;
    if (col >= d) continue;
    if (key0 < n) {
      const size_t at = static_cast<size_t>(key0) * st.g_sn + col;
      *reinterpret_cast<__nv_bfloat162*>(dkb + at) =
          __floats2bfloat162_rn(dka[j][0] * scale, dka[j][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + at) =
          __floats2bfloat162_rn(dva[j][0], dva[j][1]);
    }
    if (key1 < n) {
      const size_t at = static_cast<size_t>(key1) * st.g_sn + col;
      *reinterpret_cast<__nv_bfloat162*>(dkb + at) =
          __floats2bfloat162_rn(dka[j][2] * scale, dka[j][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + at) =
          __floats2bfloat162_rn(dva[j][2], dva[j][3]);
    }
  }
}

// With DROP (kernel C4-bwd) dP is scaled by keep / keep_prob before
// dS = P (dP - delta), as _bwd_dq_kernel_drop (rows are queries).
template <int DP, Drop DROP = Drop::kNone>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dq, int n, int d, Strides st,
                            float qscale, float scale, Keep kp) {
  constexpr int KS = DP + 8;
  constexpr int TS = kTile + 8;
  constexpr int KSTEPS = DP / 16;
  constexpr int NT = kTile / 8;    // 8-key column tiles of S
  constexpr int DT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);   // k, row-major
  bf16* sV = sK + kTile * KS;                 // v, row-major
  bf16* sKt = sV + kTile * KS;                // k, transposed

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int r0 = warp * 16 + g;
  const size_t row_off =
      (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * n;
  const bf16* kb = k + head_off(st.k_sb, d);
  const bf16* vb = v + head_off(st.v_sb, d);

  // this warp's 16 rows of scaled q and dout -> registers
  load_tile<DP, kTile, false, true>(sK, KS, q + head_off(st.q_sb, d), q0, n,
                                    d, st.q_sn, qscale);
  load_tile<DP, kTile, false, false>(sV, KS, dout + head_off(st.do_sb, d), q0,
                                     n, d, st.do_sn, 0.f);
  __syncthreads();
  uint32_t qf[KSTEPS][4], of[KSTEPS][4];
  load_frags<KSTEPS>(qf, sK, KS, r0, t4);
  load_frags<KSTEPS>(of, sV, KS, r0, t4);
  __syncthreads();
  const int row0 = q0 + r0;
  const int row1 = row0 + 8;
  // pad rows read no lse: their q and dout rows are zero, so ds = 0
  const float l0 = row0 < n ? lse[row_off + row0] : 0.f;
  const float l1 = row1 < n ? lse[row_off + row1] : 0.f;
  const float e0 = row0 < n ? delta[row_off + row0] : 0.f;
  const float e1 = row1 < n ? delta[row_off + row1] : 0.f;

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  const int bh = stt::rng_head(kp, blockIdx.z, blockIdx.y);
  const int8_t* mh = DROP == Drop::kMask ? stt::mask_head(kp) : nullptr;

  for (int k0 = 0; k0 < n; k0 += kTile) {
    load_tile<DP, kTile, false, false>(sK, KS, kb, k0, n, d, st.k_sn, 0.f);
    load_tile<DP, kTile, false, false>(sV, KS, vb, k0, n, d, st.v_sn, 0.f);
    load_tile<DP, kTile, true, false>(sKt, TS, kb, k0, n, d, st.k_sn, 0.f);
    uint32_t keep = 0;
    if constexpr (DROP != Drop::kNone) {
      keep = stt::keep_bits<DROP, false, NT>(kp, mh, bh, row0, k0, t4, n);
    }
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      const bf16* krow = &sK[(j * 8 + g) * KS + t4 * 2];
      const bf16* vrow = &sV[(j * 8 + g) * KS + t4 * 2];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        mma_16816(s[j], qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
        mma_16816(dp[j], of[kk], ld32(vrow + kk * 16), ld32(vrow + kk * 16 + 8));
      }
    }

    uint32_t dsf[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int key = k0 + j * 8 + t4 * 2;
      const bool ok0 = key < n;
      const bool ok1 = key + 1 < n;
      const float p00 = ok0 ? exp2f(s[j][0] - l0) : 0.f;
      const float p01 = ok1 ? exp2f(s[j][1] - l0) : 0.f;
      const float p10 = ok0 ? exp2f(s[j][2] - l1) : 0.f;
      const float p11 = ok1 ? exp2f(s[j][3] - l1) : 0.f;
      if constexpr (DROP != Drop::kNone) {
        const float f = kp.inv_keep;
        dp[j][0] *= stt::keep_factor(keep, j, 0, f);
        dp[j][1] *= stt::keep_factor(keep, j, 1, f);
        dp[j][2] *= stt::keep_factor(keep, j, 2, f);
        dp[j][3] *= stt::keep_factor(keep, j, 3, f);
      }
      dsf[j / 2][(j % 2) * 2] = as_u32(__floats2bfloat162_rn(
          p00 * (dp[j][0] - e0), p01 * (dp[j][1] - e0)));
      dsf[j / 2][(j % 2) * 2 + 1] = as_u32(__floats2bfloat162_rn(
          p10 * (dp[j][2] - e1), p11 * (dp[j][3] - e1)));
    }

    // dQ += bf16(dS) K
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const bf16* krow = &sKt[(j * 8 + g) * TS + kk * 16 + t4 * 2];
        mma_16816(acc[j], dsf[kk], ld32(krow), ld32(krow + 8));
      }
    }
    __syncthreads();
  }

  bf16* dqb = dq + head_off(st.g_sb, d);
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + t4 * 2;
    if (col >= d) continue;
    if (row0 < n) {
      *reinterpret_cast<__nv_bfloat162*>(
          dqb + static_cast<size_t>(row0) * st.g_sn + col) =
          __floats2bfloat162_rn(acc[j][0] * scale, acc[j][1] * scale);
    }
    if (row1 < n) {
      *reinterpret_cast<__nv_bfloat162*>(
          dqb + static_cast<size_t>(row1) * st.g_sn + col) =
          __floats2bfloat162_rn(acc[j][2] * scale, acc[j][3] * scale);
    }
  }
}

// fp32: one thread per key; 16-query tiles in shared memory
template <int DP, Drop DROP = Drop::kNone>
__global__ void __launch_bounds__(kThreadsF32)
    attn_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int n, int d, Strides st, float qscale,
                             float scale, Keep kp) {
  __shared__ float sQ[kTileF32][DP];
  __shared__ float sQr[kTileF32][DP];
  __shared__ float sO[kTileF32][DP];
  __shared__ float sL[kTileF32];
  __shared__ float sD[kTileF32];
  const int key = blockIdx.x * kThreadsF32 + threadIdx.x;
  const float* qb = q + head_off(st.q_sb, d);
  const float* ob = dout + head_off(st.do_sb, d);
  const float* kb = k + head_off(st.k_sb, d) + static_cast<size_t>(key) * st.k_sn;
  const float* vb = v + head_off(st.v_sb, d) + static_cast<size_t>(key) * st.v_sn;
  const size_t row_off =
      (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * n;
  const int bh = stt::rng_head(kp, blockIdx.z, blockIdx.y);
  const int8_t* mh = DROP == Drop::kMask ? stt::mask_head(kp) : nullptr;
  float kr[DP], vr[DP], dka[DP], dva[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    const bool ok = key < n && c < d;
    kr[c] = ok ? kb[c] : 0.f;
    vr[c] = ok ? vb[c] : 0.f;
    dka[c] = dva[c] = 0.f;
  }
  for (int q0 = 0; q0 < n; q0 += kTileF32) {
    for (int i = threadIdx.x; i < kTileF32 * DP; i += kThreadsF32) {
      const int r = i / DP;
      const int c = i % DP;
      const bool ok = q0 + r < n && c < d;
      const float x = ok ? qb[static_cast<size_t>(q0 + r) * st.q_sn + c] : 0.f;
      sQ[r][c] = x * qscale;
      sQr[r][c] = x;
      sO[r][c] = ok ? ob[static_cast<size_t>(q0 + r) * st.do_sn + c] : 0.f;
    }
    for (int i = threadIdx.x; i < kTileF32; i += kThreadsF32) {
      const bool ok = q0 + i < n;
      sL[i] = ok ? lse[row_off + q0 + i] : 0.f;
      sD[i] = ok ? delta[row_off + q0 + i] : 0.f;
    }
    __syncthreads();
    const int nq = min(kTileF32, n - q0);
    for (int j = 0; j < nq; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        s = fmaf(sQ[j][c], kr[c], s);
        dp = fmaf(sO[j][c], vr[c], dp);
      }
      const float p = exp2f(s - sL[j]);
      float pd = p;
      if constexpr (DROP != Drop::kNone) {
        const float f =
            key < n && stt::keep_one<DROP>(kp, mh, bh, q0 + j, key, n)
                ? kp.inv_keep
                : 0.f;
        pd = p * f;
        dp *= f;
      }
      const float ds = p * (dp - sD[j]);
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        dva[c] = fmaf(pd, sO[j][c], dva[c]);
        dka[c] = fmaf(ds, sQr[j][c], dka[c]);
      }
    }
    __syncthreads();
  }
  if (key < n) {
    const size_t at = head_off(st.g_sb, d) + static_cast<size_t>(key) * st.g_sn;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < d) {
        dk[at + c] = dka[c] * scale;
        dv[at + c] = dva[c];
      }
    }
  }
}

// fp32: one thread per query; 16-key tiles in shared memory
template <int DP, Drop DROP = Drop::kNone>
__global__ void __launch_bounds__(kThreadsF32)
    attn_bwd_dq_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int n, int d, Strides st,
                           float qscale, float scale, Keep kp) {
  __shared__ float sK[kTileF32][DP];
  __shared__ float sV[kTileF32][DP];
  const int row = blockIdx.x * kThreadsF32 + threadIdx.x;
  const float* qb = q + head_off(st.q_sb, d) + static_cast<size_t>(row) * st.q_sn;
  const float* ob =
      dout + head_off(st.do_sb, d) + static_cast<size_t>(row) * st.do_sn;
  const float* kb = k + head_off(st.k_sb, d);
  const float* vb = v + head_off(st.v_sb, d);
  const size_t row_off =
      (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * n;
  const int bh = stt::rng_head(kp, blockIdx.z, blockIdx.y);
  const int8_t* mh = DROP == Drop::kMask ? stt::mask_head(kp) : nullptr;
  float qr[DP], orr[DP], acc[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    const bool ok = row < n && c < d;
    qr[c] = ok ? qb[c] * qscale : 0.f;
    orr[c] = ok ? ob[c] : 0.f;
    acc[c] = 0.f;
  }
  const float l = row < n ? lse[row_off + row] : 0.f;
  const float e = row < n ? delta[row_off + row] : 0.f;
  for (int k0 = 0; k0 < n; k0 += kTileF32) {
    for (int i = threadIdx.x; i < kTileF32 * DP; i += kThreadsF32) {
      const int r = i / DP;
      const int c = i % DP;
      const bool ok = k0 + r < n && c < d;
      sK[r][c] = ok ? kb[static_cast<size_t>(k0 + r) * st.k_sn + c] : 0.f;
      sV[r][c] = ok ? vb[static_cast<size_t>(k0 + r) * st.v_sn + c] : 0.f;
    }
    __syncthreads();
    const int nk = min(kTileF32, n - k0);
    for (int j = 0; j < nk; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        s = fmaf(qr[c], sK[j][c], s);
        dp = fmaf(orr[c], sV[j][c], dp);
      }
      if constexpr (DROP != Drop::kNone) {
        if (!(row < n && stt::keep_one<DROP>(kp, mh, bh, row, k0 + j, n))) {
          dp = 0.f;
        } else {
          dp *= kp.inv_keep;
        }
      }
      const float ds = exp2f(s - l) * (dp - e);
#pragma unroll
      for (int c = 0; c < DP; ++c) acc[c] = fmaf(ds, sK[j][c], acc[c]);
    }
    __syncthreads();
  }
  if (row < n) {
    float* out = dq + head_off(st.g_sb, d) + static_cast<size_t>(row) * st.g_sn;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < d) out[c] = acc[c] * scale;
    }
  }
}

// ---- the wgmma route: bf16, head dims 64 to 128 ----
namespace wg {

namespace hw = stt::hopper;

constexpr int kMinD = 64;                     // the route's least head dim
constexpr int kRows = 64;                     // rows of a tile (wgmma's M)
constexpr int kThreads = 128;                 // one warpgroup a block
constexpr int kStages = 2;                    // the ring of streamed tiles

// the tile width of a head dim, a tile's column atoms and where a head's
// columns sit in its tiles (attention_wg.cuh, shared with the forward of
// attention.cu)
using stt::attn_wg::head_cols;
using stt::attn_wg::Tile;
using stt::attn_wg::tile_width;
static_assert(stt::attn_wg::kTile == kRows, "one tile size");

template <int DP>
struct DkdvSmem {
  bf16 k[kRows * DP];             // the block's keys, K-major A of S^T
  bf16 v[kRows * DP];             // ... and of dP^T
  bf16 qs[kRows * DP];            // bf16(q * scale * log2 e), B of S^T
  bf16 q[kStages][kRows * DP];    // raw q: MN-major B of dK
  bf16 o[kStages][kRows * DP];    // dout: B of dP^T, MN-major B of dV
  float ld[2][kRows];             // the tile's lse and delta (queries)
  uint64_t full[kStages], kv;
};

template <int DP>
struct DqSmem {
  bf16 qs[kRows * DP];            // the block's scaled q, A of S
  bf16 o[kRows * DP];             // ... and dout, A of dP
  bf16 k[kStages][kRows * DP];    // B of S; MN-major B of dQ
  bf16 v[kStages][kRows * DP];    // B of dP
  uint64_t full[kStages], qo;
};

// Blocks an SM the registers are budgeted for.  dk/dv: at DP = 64, 168
// registers a thread fit three 128-thread blocks (two with dropout: at
// three they spilled and ran slower, PERF.md); at 96 the dK and dV
// accumulators are 48 + 48 a thread, two blocks; at 128, 64 + 64 beside
// S^T's and dP^T's 32 + 32, two blocks at up to 255 registers where their
// shared memory fits (dkdv_smem_request), one with the mask ring.  dq:
// four blocks at 64 (three with dropout: at four, 128 registers, both
// forms spilled), three at 96 (two with dropout), two at 128 (96 KB of
// shared memory a block).
template <int DP, Drop DROP>
constexpr int kDkdvBlocks = DP == 64 ? (DROP == Drop::kNone ? 3 : 2)
                            : DP == 96 || DROP != Drop::kMask ? 2
                                                              : 1;
template <int DP, Drop DROP>
constexpr int kDqBlocks = DP == 64   ? (DROP == Drop::kNone ? 4 : 3)
                          : DP == 96 ? (DROP == Drop::kNone ? 3 : 2)
                                     : 2;

// The shared memory an SM holds for blocks, 228 KB, and what the runtime
// reserves of it a block (the H100's
// cudaDevAttrMaxSharedMemoryPerMultiprocessor and
// cudaDevAttrReservedSharedMemoryPerBlock)
constexpr int kSmemSm = 233472;
constexpr int kSmemReserved = 1024;

// The bytes a dk/dv launch asks for: stt::smem_bytes' (the struct, the
// mask ring, and 1024 bytes of slack to align the struct), except at
// DP = 128 without the mask ring, where 115224 bytes of struct and that
// slack would leave room for one block an SM: there the request is what
// two blocks may each ask for, 115712 bytes, the struct and 488 bytes of
// slack.  That is enough where the dynamic shared memory starts on a
// 1024-byte boundary (no slack used) or at most 488 bytes before one; the
// kernel traps where its aligned struct would end past its request.
template <int DP>
constexpr int dkdv_smem_request(Drop drop) {
  return DP == 128 && drop != Drop::kMask
             ? kSmemSm / 2 - kSmemReserved
             : stt::smem_bytes<DkdvSmem<DP>, kStages>(drop);
}
static_assert(sizeof(DkdvSmem<128>) <= kSmemSm / 2 - kSmemReserved,
              "the dk/dv struct at DP = 128 fits two blocks an SM");

// The operands of a tile that meet K and V in S (S^T) and dP (dP^T), made
// ready in shared memory: bf16(q * qscale) from q into qs (in place where
// they are one tile) and, in a tile wider than the head, the columns
// outside [shift, shift + d) zeroed in qs and in dout; visible to wgmma once
// every thread has passed the block's next barrier.
template <int DP>
__device__ __forceinline__ void ready_q_dout(bf16* qs, const bf16* q,
                                             bf16* o, float qscale,
                                             int shift, int d) {
  using T = Tile<DP>;
  if constexpr (DP == 64) {
    hw::scale_tile(qs, q, qscale);  // the whole tile is the head's
  } else {
    hw::scale_tile_window<DP, T::kAtom>(qs, q, qscale, shift, shift + d);
    if (shift != 0 || d != DP) {
      hw::zero_tile_window<DP, T::kAtom>(o, shift, shift + d);
    }
  }
}

// The stored columns of a thread's DP / 2 accumulators (rows row0 and
// row0 + 8, columns j8 * 8 + 2 t4 + {0, 1} of the tile) times `mul`, bf16,
// at gb + row * g_sn + (column - shift): the head's d columns only, and
// rows below n.  The columns of the tile beyond the head's belong to the
// neighbouring heads (in C2 to their [dq | dk | dv] columns), which
// another block writes.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* gb, const float (&acc)[DP / 2],
                                           float mul, int row0, int n,
                                           int g_sn, int t4, int d,
                                           int shift) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int j8 = 0; j8 < DP / 8; ++j8) {
    const int c = j8 * 8 + t4 * 2 - shift;
    const int i = j8 * 4;
    if (c < 0 || c >= d) continue;
    if (row0 < n) {
      *reinterpret_cast<__nv_bfloat162*>(
          gb + static_cast<size_t>(row0) * g_sn + c) =
          __floats2bfloat162_rn(acc[i] * mul, acc[i + 1] * mul);
    }
    if (row1 < n) {
      *reinterpret_cast<__nv_bfloat162*>(
          gb + static_cast<size_t>(row1) * g_sn + c) =
          __floats2bfloat162_rn(acc[i + 2] * mul, acc[i + 3] * mul);
    }
  }
}

// dK and dV of one 64-key tile at tile width DP (tile_width of the head
// dim).  (q, dout) tiles stream by TMA through a kStages ring: thread 0
// refills a stage once the block's barrier at the end of its tile shows
// every warp done with it, so the next tile's copy runs under this tile's
// products.  S^T = K Qs^T and dP^T = V dout^T (both operands K-major from
// shared memory, DP / 16 k-steps across the column atoms), P^T and dS^T in
// registers (the accumulator layout is the A-fragment layout of the next
// products), then dV += bf16(P^T) dout and dK += bf16(dS^T) q, m64nDPk16
// with dout and q read MN-major (the descriptor's LBO stepping from one
// column atom to the next): no transposed copy.  A tile wider than the
// head (DP > d, or an odd head's tile that starts 8 columns early) holds
// columns of the neighbouring heads: they are zeroed in the scaled copy
// of q and in dout as each tile lands, so K's and V's add 0 to S^T and
// dP^T as long as they are finite (the route's precondition:
// attention_bwd_route), and those of dK and dV are not stored.  With DROP
// (kernel C4-bwd) dV takes bf16(P^T keep / keep_prob) and dP^T is scaled
// by keep / keep_prob before dS^T, as attn_bwd_dkdv_bf16_kernel's DROP
// branch; the keep bits are read transposed (rows are keys), the mask tile
// (q0.., k0..) staged with the (q, dout) tile.
template <int DP, Drop DROP = Drop::kNone>
__global__ void __launch_bounds__(kThreads, kDkdvBlocks<DP, DROP>)
    attn_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int n, int d, int g_sb, int g_sn, float qscale,
                               float scale, Keep kp) {
  using T = Tile<DP>;
  using Smem = DkdvSmem<DP>;
  constexpr bool kMask = DROP == Drop::kMask;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(hw::align_1024(smem_raw));
  if (hw::smem_u32(&sm) - hw::smem_u32(smem_raw) +
          (kMask ? stt::mask_off<Smem>() + kStages * stt::kMaskTile
                 : sizeof(Smem)) >
      hw::dynamic_smem_size()) {
    __trap();  // the request's slack did not cover the alignment
  }
  int8_t* mtile = reinterpret_cast<int8_t*>(&sm) + stt::mask_off<Smem>();
  const int8_t* mh = kMask ? stt::mask_head(kp) : nullptr;
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kRows;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (n + kRows - 1) / kRows;
  const stt::attn_wg::HeadCols hc = head_cols<DP>(head, d);
  const int dh = hc.d, col0 = hc.col0, shift = hc.shift;
  // stage j % kStages: thread 0's TMA loads of (q, dout) tile j and, in
  // the mask form, every thread's share of its mask tile
  auto fill = [&](int j) {
    const int s = j % kStages;
    if (tid == 0) {
      hw::mbar_expect_tx(&sm.full[s], 2 * T::kBytes);
      T::load(sm.q[s], &tq, &sm.full[s], col0, j * kRows, b);
      T::load(sm.o[s], &tdo, &sm.full[s], col0, j * kRows, b);
    }
    if constexpr (kMask) {
      stt::copy_mask_tile(mtile + s * stt::kMaskTile, mh, j * kRows, k0, n,
                          kp.mask_vec, &sm.full[s]);
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hw::mbar_init(&sm.full[s], kMask ? 1 + kThreads : 1);
    }
    hw::mbar_init(&sm.kv, 1);
    hw::mbar_init_fence();
    hw::mbar_expect_tx(&sm.kv, 2 * T::kBytes);
    T::load(sm.k, &tk, &sm.kv, col0, k0, b);
    T::load(sm.v, &tv, &sm.kv, col0, k0, b);
  }
  __syncthreads();
  for (int j = 0; j < kStages && j < tiles; ++j) fill(j);
  uint32_t s0 = 0, s1 = 0;  // Philox: the seed words, once
  if constexpr (DROP == Drop::kPhilox) {
    s0 = static_cast<uint32_t>(kp.seed[0]);
    s1 = static_cast<uint32_t>(kp.seed[1]);
  }
  const int bh = stt::rng_head(kp, b, head);

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // lse (threads 0-63) and delta (64-127) of a tile's queries, one value a
  // thread, loaded a tile ahead (a head's (B, H, N) slice starts at any
  // 4-byte offset, below TMA's 16-byte alignment); pad queries read none
  const int half = tid / kRows;
  const int r = tid % kRows;
  const float* lsd = (half == 0 ? lse : delta) +
                     (static_cast<size_t>(b) * gridDim.y + head) *
                         static_cast<size_t>(n);
  float next = r < n ? lsd[r] : 0.f;
  float dka[DP / 2], dva[DP / 2];
  hw::zero(dka);
  hw::zero(dva);
  const uint64_t desc_k = T::kmajor(sm.k);
  const uint64_t desc_v = T::kmajor(sm.v);
  const uint64_t desc_qs = T::kmajor(sm.qs);
  hw::mbar_wait(&sm.kv, 0);

  for (int j = 0; j < tiles; ++j) {
    const int s = j % kStages;
    const int q0 = j * kRows;
    sm.ld[half][r] = next;
    next = q0 + kRows + r < n ? lsd[q0 + kRows + r] : 0.f;
    uint32_t keep = 0;  // this tile's keep bits (rows keys, columns queries)
    if constexpr (DROP == Drop::kPhilox) {
      keep = stt::philox_bits<true, 8>(s0, s1, kp.thresh, bh,
                                       k0 + warp * 16 + g, q0, t4);
    }
    hw::mbar_wait(&sm.full[s], (j / kStages) & 1);
    if constexpr (kMask) {
      keep = stt::keep_bits_smem<true>(mtile + s * stt::kMaskTile,
                                       warp * 16 + g, t4);
    }
    ready_q_dout<DP>(sm.qs, sm.q[s], sm.o[s], qscale, shift, dh);
    __syncthreads();  // the scaled copy, dout's zeros, lse and delta

    // S^T = K (q * scale * log2e)^T and dP^T = V dout^T: 64 keys x 64
    // queries, fp32 accumulators
    float st[32], dpt[32];
    hw::zero(st);
    hw::zero(dpt);
    const uint64_t desc_o = T::kmajor(sm.o[s]);
    hw::fence_regs(st);
    hw::fence_regs(dpt);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      hw::wgmma_ss(st, desc_k + T::kk_offset(kk), desc_qs + T::kk_offset(kk),
                   kk);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      hw::wgmma_ss(dpt, desc_v + T::kk_offset(kk), desc_o + T::kk_offset(kk),
                   kk);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(st);
    hw::fence_regs(dpt);

    // P^T = exp2(S^T - lse), dS^T = P^T (dP^T - delta); queries >= n are
    // 0 (selected, so their lse and delta are never used).  Accumulator
    // column tiles 2kk and 2kk+1 are the A fragments of k-step kk.
    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) {
      const int c = j8 * 8 + t4 * 2;
      const int i = j8 * 4;
      const bool ok0 = q0 + c < n;
      const bool ok1 = q0 + c + 1 < n;
      const float l0 = sm.ld[0][c], l1 = sm.ld[0][c + 1];
      const float e0 = sm.ld[1][c], e1 = sm.ld[1][c + 1];
      const float p00 = ok0 ? hw::exp2_approx(st[i] - l0) : 0.f;
      const float p01 = ok1 ? hw::exp2_approx(st[i + 1] - l1) : 0.f;
      const float p10 = ok0 ? hw::exp2_approx(st[i + 2] - l0) : 0.f;
      const float p11 = ok1 ? hw::exp2_approx(st[i + 3] - l1) : 0.f;
      if constexpr (DROP == Drop::kNone) {
        pf[j8 / 2][(j8 % 2) * 2] = as_u32(__floats2bfloat162_rn(p00, p01));
        pf[j8 / 2][(j8 % 2) * 2 + 1] =
            as_u32(__floats2bfloat162_rn(p10, p11));
      } else {
        const float f = kp.inv_keep;
        const float f00 = stt::keep_factor(keep, j8, 0, f);
        const float f01 = stt::keep_factor(keep, j8, 1, f);
        const float f10 = stt::keep_factor(keep, j8, 2, f);
        const float f11 = stt::keep_factor(keep, j8, 3, f);
        pf[j8 / 2][(j8 % 2) * 2] =
            as_u32(__floats2bfloat162_rn(p00 * f00, p01 * f01));
        pf[j8 / 2][(j8 % 2) * 2 + 1] =
            as_u32(__floats2bfloat162_rn(p10 * f10, p11 * f11));
        dpt[i] *= f00;
        dpt[i + 1] *= f01;
        dpt[i + 2] *= f10;
        dpt[i + 3] *= f11;
      }
      const float ds00 = ok0 ? p00 * (dpt[i] - e0) : 0.f;
      const float ds01 = ok1 ? p01 * (dpt[i + 1] - e1) : 0.f;
      const float ds10 = ok0 ? p10 * (dpt[i + 2] - e0) : 0.f;
      const float ds11 = ok1 ? p11 * (dpt[i + 3] - e1) : 0.f;
      dsf[j8 / 2][(j8 % 2) * 2] = as_u32(__floats2bfloat162_rn(ds00, ds01));
      dsf[j8 / 2][(j8 % 2) * 2 + 1] =
          as_u32(__floats2bfloat162_rn(ds10, ds11));
    }

    // dV += bf16(P^T) dout;  dK += bf16(dS^T) q  (64 keys x DP columns)
    const uint64_t desc_om = T::mnmajor(sm.o[s]);
    const uint64_t desc_qm = T::mnmajor(sm.q[s]);
    hw::fence_regs(dva);
    hw::fence_regs(dka);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      hw::wgmma_rs_mn(dva, pf[kk], desc_om + kk * T::kMnStep, 1);
    }
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      hw::wgmma_rs_mn(dka, dsf[kk], desc_qm + kk * T::kMnStep, 1);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(dva);
    hw::fence_regs(dka);
    hw::fence_regs(pf);
    hw::fence_regs(dsf);
    __syncthreads();  // every warp is done with stage s, qs and ld
    if (j + kStages < tiles) fill(j + kStages);
  }

  const size_t g_off = static_cast<size_t>(b) * g_sb +
                       static_cast<size_t>(head) * dh;
  const int key0 = k0 + warp * 16 + g;
  store_rows<DP>(dk + g_off, dka, scale, key0, n, g_sn, t4, dh, shift);
  store_rows<DP>(dv + g_off, dva, 1.f, key0, n, g_sn, t4, dh, shift);
}

// dQ of one 64-query tile at tile width DP: q (scaled in place) and dout
// are loaded once, their columns outside the head zeroed there; (k, v)
// tiles stream through the ring as in the dk/dv kernel; S = Qs K^T and
// dP = dout V^T (K-major), dS in registers, dQ += bf16(dS) K (m64nDPk16)
// with K read MN-major, and only the head's columns of dQ stored.  Pad
// query rows read no lse: their q and dout rows are zero, so ds = 0.  With
// DROP (kernel C4-bwd) dP is scaled by keep / keep_prob before dS, as
// attn_bwd_dq_bf16_kernel's; the mask tile (q0.., k0..) is staged with the
// (k, v) tile.
template <int DP, Drop DROP = Drop::kNone>
__global__ void __launch_bounds__(kThreads, kDqBlocks<DP, DROP>)
    attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dq, int n, int d, int g_sb,
                             int g_sn, float qscale, float scale, Keep kp) {
  using T = Tile<DP>;
  using Smem = DqSmem<DP>;
  constexpr bool kMask = DROP == Drop::kMask;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(hw::align_1024(smem_raw));
  int8_t* mtile = reinterpret_cast<int8_t*>(&sm) + stt::mask_off<Smem>();
  const int8_t* mh = kMask ? stt::mask_head(kp) : nullptr;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kRows;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (n + kRows - 1) / kRows;
  const stt::attn_wg::HeadCols hc = head_cols<DP>(head, d);
  const int dh = hc.d, col0 = hc.col0, shift = hc.shift;
  // stage j % kStages: thread 0's TMA loads of (k, v) tile j and, in the
  // mask form, every thread's share of its mask tile
  auto fill = [&](int j) {
    const int s = j % kStages;
    if (tid == 0) {
      hw::mbar_expect_tx(&sm.full[s], 2 * T::kBytes);
      T::load(sm.k[s], &tk, &sm.full[s], col0, j * kRows, b);
      T::load(sm.v[s], &tv, &sm.full[s], col0, j * kRows, b);
    }
    if constexpr (kMask) {
      stt::copy_mask_tile(mtile + s * stt::kMaskTile, mh, q0, j * kRows, n,
                          kp.mask_vec, &sm.full[s]);
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hw::mbar_init(&sm.full[s], kMask ? 1 + kThreads : 1);
    }
    hw::mbar_init(&sm.qo, 1);
    hw::mbar_init_fence();
    hw::mbar_expect_tx(&sm.qo, 2 * T::kBytes);
    T::load(sm.qs, &tq, &sm.qo, col0, q0, b);
    T::load(sm.o, &tdo, &sm.qo, col0, q0, b);
  }
  __syncthreads();
  for (int j = 0; j < kStages && j < tiles; ++j) fill(j);
  uint32_t s0 = 0, s1 = 0;  // Philox: the seed words, once
  if constexpr (DROP == Drop::kPhilox) {
    s0 = static_cast<uint32_t>(kp.seed[0]);
    s1 = static_cast<uint32_t>(kp.seed[1]);
  }
  const int bh = stt::rng_head(kp, b, head);

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const size_t row_off = (static_cast<size_t>(b) * gridDim.y + head) *
                         static_cast<size_t>(n);
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const float l0 = row0 < n ? lse[row_off + row0] : 0.f;
  const float l1 = row1 < n ? lse[row_off + row1] : 0.f;
  const float e0 = row0 < n ? delta[row_off + row0] : 0.f;
  const float e1 = row1 < n ? delta[row_off + row1] : 0.f;
  float acc[DP / 2];
  hw::zero(acc);
  const uint64_t desc_qs = T::kmajor(sm.qs);
  const uint64_t desc_o = T::kmajor(sm.o);
  hw::mbar_wait(&sm.qo, 0);
  ready_q_dout<DP>(sm.qs, sm.qs, sm.o, qscale, shift, dh);  // raw q unused
  __syncthreads();

  for (int j = 0; j < tiles; ++j) {
    const int s = j % kStages;
    const int k0 = j * kRows;
    uint32_t keep = 0;  // this tile's keep bits (rows queries)
    if constexpr (DROP == Drop::kPhilox) {
      keep = stt::philox_bits<false, 8>(s0, s1, kp.thresh, bh, row0, k0, t4);
    }
    hw::mbar_wait(&sm.full[s], (j / kStages) & 1);
    if constexpr (kMask) {
      keep = stt::keep_bits_smem<false>(mtile + s * stt::kMaskTile,
                                        warp * 16 + g, t4);
    }
    float sc[32], dp[32];
    hw::zero(sc);
    hw::zero(dp);
    const uint64_t desc_k = T::kmajor(sm.k[s]);
    const uint64_t desc_v = T::kmajor(sm.v[s]);
    hw::fence_regs(sc);
    hw::fence_regs(dp);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      hw::wgmma_ss(sc, desc_qs + T::kk_offset(kk), desc_k + T::kk_offset(kk),
                   kk);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      hw::wgmma_ss(dp, desc_o + T::kk_offset(kk), desc_v + T::kk_offset(kk),
                   kk);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(sc);
    hw::fence_regs(dp);

    uint32_t dsf[4][4];
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) {
      const int key = k0 + j8 * 8 + t4 * 2;
      const int i = j8 * 4;
      const bool ok0 = key < n;
      const bool ok1 = key + 1 < n;
      const float p00 = ok0 ? hw::exp2_approx(sc[i] - l0) : 0.f;
      const float p01 = ok1 ? hw::exp2_approx(sc[i + 1] - l0) : 0.f;
      const float p10 = ok0 ? hw::exp2_approx(sc[i + 2] - l1) : 0.f;
      const float p11 = ok1 ? hw::exp2_approx(sc[i + 3] - l1) : 0.f;
      if constexpr (DROP != Drop::kNone) {
        const float f = kp.inv_keep;
        dp[i] *= stt::keep_factor(keep, j8, 0, f);
        dp[i + 1] *= stt::keep_factor(keep, j8, 1, f);
        dp[i + 2] *= stt::keep_factor(keep, j8, 2, f);
        dp[i + 3] *= stt::keep_factor(keep, j8, 3, f);
      }
      dsf[j8 / 2][(j8 % 2) * 2] = as_u32(__floats2bfloat162_rn(
          p00 * (dp[i] - e0), p01 * (dp[i + 1] - e0)));
      dsf[j8 / 2][(j8 % 2) * 2 + 1] = as_u32(__floats2bfloat162_rn(
          p10 * (dp[i + 2] - e1), p11 * (dp[i + 3] - e1)));
    }

    // dQ += bf16(dS) K  (64 queries x DP columns)
    const uint64_t desc_km = T::mnmajor(sm.k[s]);
    hw::fence_regs(acc);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      hw::wgmma_rs_mn(acc, dsf[kk], desc_km + kk * T::kMnStep, 1);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(acc);
    hw::fence_regs(dsf);
    __syncthreads();  // every warp is done with stage s: refill it
    if (j + kStages < tiles) fill(j + kStages);
  }

  store_rows<DP>(dq + static_cast<size_t>(b) * g_sb +
                     static_cast<size_t>(head) * dh,
                 acc, scale, row0, n, g_sn, t4, dh, shift);
}

}  // namespace wg

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// delta = rowsum(dout * out) per head in fp32, (B, N, C) x2 -> (B, H, N):
// the pre-pass of C2, C3-bwd and C4-bwd (the JAX package computes it with
// XLA beside its kernels, flash_attention.py:1020 and :2299).  kDeltaRows rows
// of the (B*N, C) operands per block, one 16-byte chunk of both at a time
// (the products are exact in fp32, summed in chunk order), chunk sums in
// shared memory, then one thread per (row, head) adds its head's chunks in
// order: a fixed order, no atomics.  Bound by bytes (2 reads of B N C).
constexpr int kDeltaRows = 16;
constexpr int kDeltaThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
    attn_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                      float* __restrict__ delta, int rows, int n, int h,
                      int d) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float part[];  // [kDeltaRows][C / kVec]
  const int per_row = h * d / kVec;
  const int per_head = d / kVec;
  const int row0 = blockIdx.x * kDeltaRows;
  for (int i = threadIdx.x; i < kDeltaRows * per_row; i += kDeltaThreads) {
    const int row = row0 + i / per_row;
    float acc = 0.f;
    if (row < rows) {
      const size_t at =
          static_cast<size_t>(row) * h * d + (i % per_row) * kVec;
      uint4 a = *reinterpret_cast<const uint4*>(out + at);
      uint4 g = *reinterpret_cast<const uint4*>(dout + at);
      const T* ea = reinterpret_cast<const T*>(&a);
      const T* eg = reinterpret_cast<const T*>(&g);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        acc = fmaf(stt::to_float(eg[e]), stt::to_float(ea[e]), acc);
      }
    }
    part[i] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kDeltaRows * h; i += kDeltaThreads) {
    const int row = row0 + i / h;
    const int head = i % h;
    if (row >= rows) continue;
    const float* p = part + (i / h) * per_row + head * per_head;
    float sum = 0.f;
    for (int c = 0; c < per_head; ++c) sum += p[c];
    delta[(static_cast<size_t>(row / n) * h + head) * n + row % n] = sum;
  }
}

// The wgmma route at tile width DP: four tensor maps (q, k, v and dout by
// (batch, row, column) tiles of Tile<DP>'s atom width over the operand's
// h * d columns), encoded per call, then the dk/dv and dq kernels on the
// stream.  A map that does not encode fails the call: nothing falls back
// to the mma.sync kernels.
template <int DP, Drop DROP>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, void* dk, void* dv, int b, int n, int h, int d,
                 const Strides& st, float qscale, float scale, const Keep& kp,
                 cudaStream_t stream) {
  namespace hw = stt::hopper;
  constexpr int box = wg::Tile<DP>::kAtom;
  const int cols = h * d;
  CUtensorMap tq, tk, tv, tdo;
  if (!hw::tile_map_bf16(&tq, q, cols, n, b, st.q_sn, st.q_sb, box) ||
      !hw::tile_map_bf16(&tk, k, cols, n, b, st.k_sn, st.k_sb, box) ||
      !hw::tile_map_bf16(&tv, v, cols, n, b, st.v_sn, st.v_sb, box) ||
      !hw::tile_map_bf16(&tdo, dout, cols, n, b, st.do_sn, st.do_sb, box)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int dkdv_smem = wg::dkdv_smem_request<DP>(DROP);
  constexpr int dq_smem = stt::smem_bytes<wg::DqSmem<DP>, wg::kStages>(DROP);
  cudaError_t err =
      allow_smem(wg::attn_bwd_dkdv_wgmma_kernel<DP, DROP>, dkdv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(wg::attn_bwd_dq_wgmma_kernel<DP, DROP>, dq_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + wg::kRows - 1) / wg::kRows, h, b);
  wg::attn_bwd_dkdv_wgmma_kernel<DP, DROP><<<grid, wg::kThreads, dkdv_smem,
                                             stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n, d, st.g_sb, st.g_sn, qscale, scale, kp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wg::attn_bwd_dq_wgmma_kernel<DP, DROP><<<grid, wg::kThreads, dq_smem,
                                           stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), n, d, st.g_sb,
      st.g_sn, qscale, scale, kp);
  return static_cast<int>(cudaGetLastError());
}

// Which kernels a call takes (shared with ops/flash_attention.py:
// attention_bwd_route): fp32 the CUDA-core kernels; bf16 at head dims 64
// to 128 the wgmma kernels, with or without dropout (C4-bwd in either keep
// form); bf16 at head dims 8 to 56 the mma.sync kernels.
enum Route : int { kRouteF32 = 0, kRouteMma = 1, kRouteWgmma = 2 };

constexpr int route(int dtype, int d) {
  return dtype == stt::kFloat32 ? kRouteF32
         : d >= wg::kMinD       ? kRouteWgmma
                                : kRouteMma;
}

// The mma.sync (bf16, DP <= 64: head dims 8 to 56) and CUDA-core (fp32)
// kernels
template <int DP, Drop DROP>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int b, int n, int h, int d, const Strides& st, float qscale,
           float scale, const Keep& kp, int dtype, cudaStream_t stream) {
  if (dtype == stt::kBFloat16) {
    if constexpr (DP <= wg::kMinD) {
      const dim3 grid((n + kTile - 1) / kTile, h, b);
      const bf16* qp = static_cast<const bf16*>(q);
      const bf16* kp_ = static_cast<const bf16*>(k);
      const bf16* vp = static_cast<const bf16*>(v);
      const bf16* op = static_cast<const bf16*>(dout);
      constexpr int kv_bytes = dkdv_smem_bytes<DP>();
      constexpr int q_bytes = dq_smem_bytes<DP>();
      cudaError_t err =
          allow_smem(attn_bwd_dkdv_bf16_kernel<DP, DROP>, kv_bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = allow_smem(attn_bwd_dq_bf16_kernel<DP, DROP>, q_bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      attn_bwd_dkdv_bf16_kernel<DP, DROP>
          <<<grid, kThreads, kv_bytes, stream>>>(
              qp, kp_, vp, op, lse, delta, static_cast<bf16*>(dk),
              static_cast<bf16*>(dv), n, d, st, qscale, scale, kp);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      attn_bwd_dq_bf16_kernel<DP, DROP>
          <<<grid, kThreads, q_bytes, stream>>>(
              qp, kp_, vp, op, lse, delta, static_cast<bf16*>(dq), n, d, st,
              qscale, scale, kp);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);  // the wgmma route's
    }
  } else {
    const dim3 grid((n + kThreadsF32 - 1) / kThreadsF32, h, b);
    const float* qp = static_cast<const float*>(q);
    const float* kp_ = static_cast<const float*>(k);
    const float* vp = static_cast<const float*>(v);
    const float* op = static_cast<const float*>(dout);
    attn_bwd_dkdv_f32_kernel<DP, DROP><<<grid, kThreadsF32, 0, stream>>>(
        qp, kp_, vp, op, lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), n, d, st, qscale, scale, kp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dq_f32_kernel<DP, DROP><<<grid, kThreadsF32, 0, stream>>>(
        qp, kp_, vp, op, lse, delta, static_cast<float*>(dq), n, d, st,
        qscale, scale, kp);
  }
  return static_cast<int>(cudaGetLastError());
}

template <Drop DROP = Drop::kNone>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dq, void* dk,
             void* dv, int b, int n, int h, int d, const Strides& st,
             float qscale, float scale, int dtype, void* stream,
             const Keep& kp = Keep{}) {
  if (b <= 0 || n <= 0 || h <= 0 || d <= 0 || d % 8 != 0 || d > 128 ||
      b > 65535 || h > 65535 ||
      (dtype != stt::kBFloat16 && dtype != stt::kFloat32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route(dtype, d) == kRouteWgmma) {
#define STT_WG(DP)                                                        \
  launch_wgmma<DP, DROP>(q, k, v, dout, lse, delta, dq, dk, dv, b, n, h, d, \
                         st, qscale, scale, kp, s)
    switch (wg::tile_width(d)) {
      case 64: return STT_WG(64);
      case 96: return STT_WG(96);
      default: return STT_WG(128);
    }
#undef STT_WG
  }
#define STT_BWD(DP)                                                     \
  return launch<DP, DROP>(q, k, v, dout, lse, delta, dq, dk, dv, b, n, h, \
                          d, st, qscale, scale, kp, dtype, s)
  switch ((d + 15) / 16 * 16) {
    case 16: STT_BWD(16);
    case 32: STT_BWD(32);
    case 48: STT_BWD(48);
    case 64: STT_BWD(64);
    case 80: STT_BWD(80);
    case 96: STT_BWD(96);
    case 112: STT_BWD(112);
    default: STT_BWD(128);
  }
#undef STT_BWD
  return static_cast<int>(cudaErrorInvalidValue);  // not reached
}

}  // namespace

// Kernel C2.  q, k, v: base pointers of head 0 of the packed qkv (qkv,
// qkv + C, qkv + 2C); element (batch, row, head h, dim c) at base +
// batch * in_sb + row * in_sn + h * d + c.  dout likewise with do_sb,
// do_sn; dq, dk, dv (the [dq | dk | dv] column blocks of one gradient
// tensor) with g_sb, g_sn.  lse and delta: (B, H, N) fp32, contiguous.
// qscale = scale * log2(e).  Launches two kernels (dk/dv, then dq) on the
// stream.  d must be a multiple of 8 and at most 128; for bf16 every base
// pointer and stride must keep 16-byte alignment.
extern "C" int stt_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dq, void* dk,
                                 void* dv, int b, int n, int h, int d,
                                 int in_sb, int in_sn, int do_sb, int do_sn,
                                 int g_sb, int g_sn, float qscale,
                                 float scale, int dtype, void* stream) {
  const Strides st{in_sb, in_sn, in_sb, in_sn, in_sb, in_sn,
                   do_sb, do_sn, g_sb, g_sn};
  return dispatch(q, k, v, dout, lse, delta, dq, dk, dv, b, n, h, d, st,
                  qscale, scale, dtype, stream);
}

// Blocks an SM of the wgmma route's dk/dv and dq kernels at tile width DP
// and keep form DROP, by the runtime's occupancy calculator at the shared
// memory their launches ask for.
template <int DP, Drop DROP>
int wgmma_occupancy(int* dkdv, int* dq) {
  constexpr int dkdv_smem = wg::dkdv_smem_request<DP>(DROP);
  constexpr int dq_smem = stt::smem_bytes<wg::DqSmem<DP>, wg::kStages>(DROP);
  cudaError_t err =
      allow_smem(wg::attn_bwd_dkdv_wgmma_kernel<DP, DROP>, dkdv_smem);
  if (err == cudaSuccess) {
    err = allow_smem(wg::attn_bwd_dq_wgmma_kernel<DP, DROP>, dq_smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        dkdv, wg::attn_bwd_dkdv_wgmma_kernel<DP, DROP>, wg::kThreads,
        dkdv_smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        dq, wg::attn_bwd_dq_wgmma_kernel<DP, DROP>, wg::kThreads, dq_smem);
  }
  return static_cast<int>(err);
}

template <int DP>
int wgmma_occupancy(int drop, int* dkdv, int* dq) {
  switch (drop) {
    case 0: return wgmma_occupancy<DP, Drop::kNone>(dkdv, dq);
    case 1: return wgmma_occupancy<DP, Drop::kMask>(dkdv, dq);
    default: return wgmma_occupancy<DP, Drop::kPhilox>(dkdv, dq);
  }
}

// The route a C2, C3-bwd or C4-bwd call (either keep form) of this dtype
// code and head dim takes: 0 the fp32 CUDA-core kernels, 1 the mma.sync
// kernels, 2 the wgmma kernels; -1 for what the entry points refuse.
extern "C" int stt_attention_bwd_route(int dtype, int d) {
  if (d <= 0 || d % 8 != 0 || d > 128 ||
      (dtype != stt::kBFloat16 && dtype != stt::kFloat32)) {
    return -1;
  }
  return route(dtype, d);
}

// Blocks an SM of the wgmma route's two kernels at head dim d (a multiple
// of 8 from 64 to 128) and keep form drop (0 none, 1 the mask, 2 Philox)
// -> *dkdv, *dq; a CUDA error code, or cudaErrorInvalidValue off the route.
extern "C" int stt_attention_bwd_occupancy(int d, int drop, int* dkdv,
                                           int* dq) {
  if (d % 8 != 0 || route(stt::kBFloat16, d) != kRouteWgmma || d > 128 ||
      drop < 0 || drop > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (wg::tile_width(d)) {
    case 64: return wgmma_occupancy<64>(drop, dkdv, dq);
    case 96: return wgmma_occupancy<96>(drop, dkdv, dq);
    default: return wgmma_occupancy<128>(drop, dkdv, dq);
  }
}

// The delta pre-pass of C2, C3-bwd and C4-bwd: out and dout (B, N, C)
// contiguous, 16-byte aligned, in the dtype code's type, C = h * d with d a
// multiple of 8 -> delta (B, H, N) fp32 contiguous.
extern "C" int stt_attention_delta(const void* out, const void* dout,
                                   float* delta, int b, int n, int h, int d,
                                   int dtype, void* stream) {
  if (b <= 0 || n <= 0 || h <= 0 || d <= 0 || d % 8 != 0 ||
      static_cast<long long>(b) * n >= (1ll << 31) ||
      (dtype != stt::kBFloat16 && dtype != stt::kFloat32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = b * n;
  const int grid = (rows + kDeltaRows - 1) / kDeltaRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == stt::kBFloat16) {
    const int bytes = kDeltaRows * h * d / 8 * 4;
    const cudaError_t err = allow_smem(attn_delta_kernel<bf16>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_delta_kernel<bf16><<<grid, kDeltaThreads, bytes, s>>>(
        static_cast<const bf16*>(out), static_cast<const bf16*>(dout), delta,
        rows, n, h, d);
  } else {
    const int bytes = kDeltaRows * h * d / 4 * 4;
    const cudaError_t err = allow_smem(attn_delta_kernel<float>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_delta_kernel<float><<<grid, kDeltaThreads, bytes, s>>>(
        static_cast<const float*>(out), static_cast<const float*>(dout),
        delta, rows, n, h, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel C3-bwd: stt_attention_bwd with a (batch, row) stride pair for each
// of q (q_sb, q_sn), k and v; dq, dk and dv share g_sb, g_sn.
extern "C" int stt_attention_bwd_sep(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dq, void* dk, void* dv, int b,
                                     int n, int h, int d, int q_sb, int q_sn,
                                     int k_sb, int k_sn, int v_sb, int v_sn,
                                     int do_sb, int do_sn, int g_sb, int g_sn,
                                     float qscale, float scale, int dtype,
                                     void* stream) {
  const Strides st{q_sb, q_sn, k_sb, k_sn, v_sb, v_sn,
                   do_sb, do_sn, g_sb, g_sn};
  return dispatch(q, k, v, dout, lse, delta, dq, dk, dv, b, n, h, d, st,
                  qscale, scale, dtype, stream);
}

// Kernel C4-bwd: C3-bwd with attention dropout (replaces the TPU kernels
// _bwd_dq_kernel_drop and _bwd_dkv_kernel_drop, launched by
// _flash_drop_bwd_impl, and _bwd_merged_kernel_drop_rng,
// _bwd_dq_kernel_drop_rng and _bwd_dkv_kernel_drop_rng, launched by
// _flash_drop_rng_bwd_impl: one function in three TPU orientations).  The
// arguments of stt_attention_bwd_sep, lse from the dropout forward and
// delta = rowsum(dout * out) of its output, and the keep source of
// stt_attention_fwd_lse_drop (exactly one of mask and seed, and the Philox
// counter's first head and head count).  The dk/dv
// kernel reads the mask transposed by index (mask[b, h, query, key] from
// its key-major tile; no transposed copy) and draws the Philox words in
// its own orientation (philox.cuh): two launches, as C2.  At head dims 64
// to 128 in bf16 they are the wgmma kernels (route()), which stage the
// mask's tiles in shared memory and read them there in either orientation.
extern "C" int stt_attention_bwd_drop(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    int b, int n, int h, int d, int q_sb, int q_sn, int k_sb, int k_sn,
    int v_sb, int v_sn, int do_sb, int do_sn, int g_sb, int g_sn,
    float qscale, float scale, const int8_t* mask, long long m_sb,
    long long m_sh, const int32_t* seed, unsigned thresh, float inv_keep,
    int rng_h0, int rng_heads, int dtype, void* stream) {
  if ((mask == nullptr) == (seed == nullptr) || !(inv_keep >= 1.f) ||
      rng_h0 < 0 || rng_heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides st{q_sb, q_sn, k_sb, k_sn, v_sb, v_sn,
                   do_sb, do_sn, g_sb, g_sn};
  const Keep kp{mask, m_sb, m_sh, seed, thresh, inv_keep,
                stt::mask_vec(mask, m_sb, m_sh, n), rng_h0, rng_heads};
  return mask != nullptr
             ? dispatch<Drop::kMask>(q, k, v, dout, lse, delta, dq, dk, dv, b,
                                     n, h, d, st, qscale, scale, dtype,
                                     stream, kp)
             : dispatch<Drop::kPhilox>(q, k, v, dout, lse, delta, dq, dk, dv,
                                       b, n, h, d, st, qscale, scale, dtype,
                                       stream, kp);
}

// Philox4x32-10 alone, for the dropout bound's integer floor
// (chip_smoke.py:philox_call_cost): CALLS calls a thread under one seed,
// each on a counter read from memory, each call's words stored.  ROUNDS =
// 0 is the same kernel without the rounds.  The round keys depend on the
// seed alone, so a thread computes them once however many calls it makes;
// the instructions of one call besides them are (<10, 2> - <0, 2>) -
// (<10, 1> - <0, 1>) in cuobjdump -sass of the built library.  Never
// launched.
template <int ROUNDS, int CALLS>
__global__ void philox_cost_kernel(const int32_t* __restrict__ seed,
                                   const uint4* __restrict__ ctr,
                                   uint4* __restrict__ out) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t s0 = static_cast<uint32_t>(seed[0]);
  const uint32_t s1 = static_cast<uint32_t>(seed[1]);
#pragma unroll
  for (int c = 0; c < CALLS; ++c) {
    out[CALLS * i + c] = stt::philox4x32<ROUNDS>(ctr[CALLS * i + c], s0, s1);
  }
}

template __global__ void philox_cost_kernel<0, 1>(const int32_t*,
                                                  const uint4*, uint4*);
template __global__ void philox_cost_kernel<0, 2>(const int32_t*,
                                                  const uint4*, uint4*);
template __global__ void philox_cost_kernel<10, 1>(const int32_t*,
                                                   const uint4*, uint4*);
template __global__ void philox_cost_kernel<10, 2>(const int32_t*,
                                                   const uint4*, uint4*);
