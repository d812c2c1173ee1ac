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
// both fp32 (delta is computed by the caller, as the JAX package computes
// it outside its kernel).
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
// split in two deterministic kernels without atomics:
//   * dk/dv: one block of 4 warps per (64-key tile, head, batch); each
//     warp owns 16 keys, whose K and V fragments stay in registers, and
//     the block loops over 64-query tiles (scaled Q and dout row-major for
//     S^T = K Q^T and dP^T = V dout^T, raw Q and dout transposed for
//     dK += dS^T Q and dV += P^T dout, all through shared memory); P^T and
//     dS^T go from the fp32 accumulators straight into the A fragments of
//     the next products, as A1 does with P;
//   * dq: one block per (64-query tile, head, batch); each warp keeps its
//     16 rows of scaled Q and dout as fragments and loops over 64-key
//     tiles (K and V row-major, K transposed), dQ += dS K.
// mma.sync m16n8k16 bf16 with fp32 accumulators; no TMA, wgmma or warp
// specialisation yet.  Row offsets inside a (batch, head) stay 32-bit, as
// in common.cuh's tile loader.  fp32 inputs (tests, small shapes) take two
// simple CUDA-core kernels with the same split: one thread per key (dk/dv)
// or per query (dq), 16-row tiles in shared memory.
#include <math.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
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

template <int DP>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int n, int d, Strides st, float qscale,
                              float scale) {
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
      const float ds00 = p00 * (dpt[j][0] - sD[c]);
      const float ds01 = p01 * (dpt[j][1] - sD[c + 1]);
      const float ds10 = p10 * (dpt[j][2] - sD[c]);
      const float ds11 = p11 * (dpt[j][3] - sD[c + 1]);
      pf[j / 2][(j % 2) * 2] = as_u32(__floats2bfloat162_rn(p00, p01));
      pf[j / 2][(j % 2) * 2 + 1] = as_u32(__floats2bfloat162_rn(p10, p11));
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

template <int DP>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dq, int n, int d, Strides st,
                            float qscale, float scale) {
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

  for (int k0 = 0; k0 < n; k0 += kTile) {
    load_tile<DP, kTile, false, false>(sK, KS, kb, k0, n, d, st.k_sn, 0.f);
    load_tile<DP, kTile, false, false>(sV, KS, vb, k0, n, d, st.v_sn, 0.f);
    load_tile<DP, kTile, true, false>(sKt, TS, kb, k0, n, d, st.k_sn, 0.f);
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
template <int DP>
__global__ void __launch_bounds__(kThreadsF32)
    attn_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int n, int d, Strides st, float qscale,
                             float scale) {
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
      const float ds = p * (dp - sD[j]);
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        dva[c] = fmaf(p, sO[j][c], dva[c]);
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
template <int DP>
__global__ void __launch_bounds__(kThreadsF32)
    attn_bwd_dq_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int n, int d, Strides st,
                           float qscale, float scale) {
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           int b, int n, int h, int d, const Strides& st, float qscale,
           float scale, int dtype, cudaStream_t stream) {
  if (dtype == stt::kBFloat16) {
    const dim3 grid((n + kTile - 1) / kTile, h, b);
    const bf16* qp = static_cast<const bf16*>(q);
    const bf16* kp = static_cast<const bf16*>(k);
    const bf16* vp = static_cast<const bf16*>(v);
    const bf16* op = static_cast<const bf16*>(dout);
    constexpr int kv_bytes = dkdv_smem_bytes<DP>();
    constexpr int q_bytes = dq_smem_bytes<DP>();
    cudaError_t err = allow_smem(attn_bwd_dkdv_bf16_kernel<DP>, kv_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = allow_smem(attn_bwd_dq_bf16_kernel<DP>, q_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dkdv_bf16_kernel<DP><<<grid, kThreads, kv_bytes, stream>>>(
        qp, kp, vp, op, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), n, d, st, qscale, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dq_bf16_kernel<DP><<<grid, kThreads, q_bytes, stream>>>(
        qp, kp, vp, op, lse, delta, static_cast<bf16*>(dq), n, d, st, qscale,
        scale);
  } else {
    const dim3 grid((n + kThreadsF32 - 1) / kThreadsF32, h, b);
    const float* qp = static_cast<const float*>(q);
    const float* kp = static_cast<const float*>(k);
    const float* vp = static_cast<const float*>(v);
    const float* op = static_cast<const float*>(dout);
    attn_bwd_dkdv_f32_kernel<DP><<<grid, kThreadsF32, 0, stream>>>(
        qp, kp, vp, op, lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), n, d, st, qscale, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dq_f32_kernel<DP><<<grid, kThreadsF32, 0, stream>>>(
        qp, kp, vp, op, lse, delta, static_cast<float*>(dq), n, d, st, qscale,
        scale);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dq, void* dk,
             void* dv, int b, int n, int h, int d, const Strides& st,
             float qscale, float scale, int dtype, void* stream) {
  if (b <= 0 || n <= 0 || h <= 0 || d <= 0 || d % 8 != 0 || d > 128 ||
      b > 65535 || h > 65535 ||
      (dtype != stt::kBFloat16 && dtype != stt::kFloat32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STT_BWD(DP)                                                        \
  return launch<DP>(q, k, v, dout, lse, delta, dq, dk, dv, b, n, h, d, st, \
                    qscale, scale, dtype, s)
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
