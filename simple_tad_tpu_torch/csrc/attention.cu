// Non-causal inference attention read in place from the packed qkv tensor
// (kernel A1), and the same kernels with an lse store (kernel C1, the
// training forward; kernel C3-fwd, the same on separate q, k and v).
//
// C1 replaces the TPU kernel simple_tad_tpu/ops/flash_attention.py:
// _fwd_kernel_nomax_packed_lse, launched by _flash_fwd_packed_qkv_impl from
// the packed custom VJP's forward.  It is A1 instantiated with LSE = true:
// the only added work is one log2 and one 4-byte store per (row, head), so
// it is bounded like A1; A1's own instantiation (LSE = false) is unchanged.
//
// Replaces the TPU kernel simple_tad_tpu/ops/flash_attention.py:
// _fwd_kernel_nomax_packed with _attend_rows_t, launched by
// flash_attention_qkv -> _flash_core_packed_qkv ->
// _flash_primal_packed_qkv_impl.  As there, q, k and v are read straight
// from the qkv projection's (B, N, 3C) output through its row stride and the
// column offsets 0, C and 2C plus h * Dh: no slice copies and no
// (B, H, N, Dh) relayout.  The caller passes three base pointers and a
// (batch, row) stride pair for each operand.
//
// The same kernel serves separate (B, N, C) q, k and v (InternVideo2, whose
// q and k are RMS-normalised between the qkv projection and attention).  It
// replaces the TPU kernels _fwd_kernel_nomax_packed on separate operands
// (launched by _flash_primal_packed_impl, N <= ~1620) and
// _fwd_kernel_nomax_packed_kv (D1, the key-grid kernel _kv_grid_call
// launches for N = 2049): the key grid is a TPU VMEM plan whose partial
// numerators and denominators add up to the same max-free result, which
// this kernel's loop over key tiles computes directly.  q and k are the
// norms' fresh (B, N, C) outputs; v is read in place from the qkv output
// through its row stride 3C, with no copy.
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
// q/k/v/out, ~400 flop/byte, so once tiled it is compute-bound; and at
// Dh = 64 the special-function unit's N^2 exp2 per (batch, head) take about
// as long as the two products.  Three routes, by dtype and head dim
// (route() below, ops/flash_attention.py:attention_fwd_route):
//   * bf16 at head dims 64 to 128 (every trunk the jobs run: ViT-S/B/L,
//     IV2-S/B/L at 64, IV2-1B at 88, IV2-6B at 128, and ViT-H's 80; A1,
//     C1, C3-fwd, B3 and, with dropout, C4-fwd), the wgmma kernel
//     (namespace wg), a template on the tile width DP = 64, 96 or 128
//     (64 at 64, 96 at 72-96, 128 at 104-128): one warpgroup per (64-query
//     tile, head, batch); the q tile and a ring of (k, v) tiles arrive by
//     TMA (rank-3 tensor maps over (batch, row, column), rows beyond N and
//     keys beyond n_kv reading as zero) as DP / A column atoms of A = 64
//     or 32 columns (128- or 64-byte swizzle), starting at the head's first
//     column rounded down to a multiple of 16 (a TMA row that starts off a
//     32-byte sector ran slower), the columns that are not the head's
//     zeroed in q (k must be finite there) and not stored from O; q is
//     scaled in place in shared memory;
//     S = Qs K^T is wgmma m64n64k16 over DP / 16 k-steps with both
//     operands K-major in shared memory, O += bf16(P) V is wgmma m64nDPk16
//     taking P from registers (the rounded accumulators, whose layout is
//     the A-fragment layout) and V MN-major through the descriptor's
//     transpose bit (its LBO stepping from one column atom to the next), so
//     no transposed copy is staged.  A tile's S, softmax and PV run in
//     turn, and the blocks of an SM overlap one another's products and
//     softmax (five fit at DP = 64: 92 registers a thread, 42 KB of shared
//     memory; three at 96, two at 128: 80 KB, DP / 2 = 64 O accumulators a
//     thread);
//   * bf16 at head dims 8 to 56, the mma.sync kernel attn_fwd_bf16_kernel
//     (m16n8k16, fp32 accumulators) in the FlashAttention-2 shape: one
//     block of 4 warps per (64-query tile, head, batch); each warp owns 16
//     query rows whose Q fragments stay in registers; 64-key K and V tiles
//     are loaded synchronously through shared memory (V stored transposed
//     so each B fragment is one 32-bit load); the score accumulators are
//     rounded to bf16 and reused directly as the A fragments of the PV
//     product;
//   * fp32 inputs (tests, small shapes), a simple CUDA-core kernel: one
//     thread per query row, 32-key tiles in shared memory, the same online
//     integer-max softmax.
// The two bf16 kernels hold the same numerics; their fp32 products sum in
// another order, so their outputs may differ in the last bits.
//
// With a keep source (kernel C4-fwd, stt_attention_fwd_lse_drop) the same
// kernels are C3-fwd with attention dropout: see attn_fwd_bf16_kernel's
// and attn_fwd_wgmma_kernel's DROP, and philox.cuh.  In the wgmma kernel the
// Philox words are drawn under the tile's S product, and the mask form's
// 64 x 64 int8 tile rides the (k, v) ring: copied by the threads
// (cp.async, or byte loads where mask rows are off 4 bytes) into a
// swizzled shared tile whose arrivals complete the stage's barrier.
//
// With Q8 the same kernels are B3, the int8-output epilogue of the static
// int8 model's bf16 attention: they replace the TPU kernels
// _fwd_kernel_nomax_packed_q8 (launched by _flash_primal_packed_qkv_q8_impl
// on the packed qkv and by _flash_primal_packed_q8_impl on separate
// operands) and _fwd_kernel_nomax_packed_kv_q8 (the key-grid form
// _kv_grid_call launches at N = 2049).  Nothing changes before the store:
// the normalised fp32 result (not a bf16 copy of it) is written as
// clip(round_half_even(o * 127 / out_amax), +-127) int8 codes, out_amax read
// from device memory.  The store moves half the bytes of A1's; the kernel
// is bounded like A1.  Keys at or beyond n_kv (<= n) are masked by index.
#include <math.h>

#include "common.cuh"
#include "attention_wg.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace {

using bf16 = __nv_bfloat16;
using stt::Drop;
using stt::Keep;
using stt::as_u32;
using stt::ld32;
using stt::mma_16816;

constexpr int kBlockM = 64;     // query rows per block
constexpr int kBlockN = 64;     // keys per tile (bf16 kernel)
constexpr int kThreads = 128;   // 4 warps x 16 query rows
constexpr int kBlockNF32 = 32;  // keys per tile (fp32 kernel)

// (batch, row) strides in elements of q, k, v and the output
struct Strides {
  int q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn;
};

template <int DP, int ROWS, bool TRANSPOSE, bool SCALE>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          int row0, int n, int d,
                                          int row_stride, float qscale) {
  stt::load_tile<DP, ROWS, TRANSPOSE, SCALE, kThreads>(
      dst, ld, src, row0, n, d, row_stride, qscale);
}

// With LSE (kernel C1, the training forward) the kernel also stores, per
// (batch, head, row), lse = log2 of the softmax denominator of the max-free
// form: the running max is an integer and every rescale exact, so that is
// m + log2(l) with l the sum of the rounded probabilities.  lse is (B, H, N)
// fp32, contiguous.
// With Q8 (kernel B3) o is int8 and out_amax the absmax its codes are made
// against.
// With DROP (kernel C4-fwd, LSE only) the probabilities are those of the
// JAX drop forward (simple_tad_tpu/ops/flash_attention.py:_fwd_kernel_drop,
// _fwd_kernel_drop_rng): l sums the unrounded fp32 p = exp2(s - m) before
// dropout, the PV operand is bf16(p * keep / keep_prob) (the factor applied
// in fp32, then one rounding), and lse = m + log2(l); the keep bits come
// from kp (philox.cuh).  Rescaling by exact powers of two commutes with
// both roundings, so the integer running maximum still gives the same
// result as one final maximum.
template <int DP, bool LSE, bool Q8, Drop DROP = Drop::kNone>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, void* __restrict__ o,
                         float* __restrict__ lse,
                         const float* __restrict__ out_amax, int n, int n_kv,
                         int d, Strides st, float qscale, Keep kp) {
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
  const size_t batch = blockIdx.z;
  const size_t hoff = static_cast<size_t>(blockIdx.y) * d;
  const bf16* qb = q + batch * st.q_sb + hoff;
  const bf16* kb = k + batch * st.k_sb + hoff;
  const bf16* vb = v + batch * st.v_sb + hoff;

  // 1. pre-scaled Q tile -> registers, as m16n8k16 A fragments
  load_tile<DP, kBlockM, false, true>(sK, KS, qb, q0, n, d, st.q_sn, qscale);
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
  const int bh = stt::rng_head(kp, blockIdx.z, blockIdx.y);
  const int8_t* mh = DROP == Drop::kMask ? stt::mask_head(kp) : nullptr;

  for (int k0 = 0; k0 < n_kv; k0 += kBlockN) {
    load_tile<DP, kBlockN, false, false>(sK, KS, kb, k0, n_kv, d, st.k_sn,
                                         0.f);
    load_tile<DP, kBlockN, true, false>(sVt, VS, vb, k0, n_kv, d, st.v_sn,
                                        0.f);
    uint32_t keep = 0;
    if constexpr (DROP != Drop::kNone) {
      keep = stt::keep_bits<DROP, false, NT>(kp, mh, bh, q0 + r0, k0, t4, n);
    }
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
    if (k0 + kBlockN > n_kv) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int key = k0 + j * 8 + t4 * 2;
        if (key >= n_kv) s[j][0] = s[j][2] = -INFINITY;
        if (key + 1 >= n_kv) s[j][1] = s[j][3] = -INFINITY;
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
      if constexpr (DROP == Drop::kNone) {
        const __nv_bfloat162 p01 = __floats2bfloat162_rn(
            exp2f(s[j][0] - mn0), exp2f(s[j][1] - mn0));
        const __nv_bfloat162 p23 = __floats2bfloat162_rn(
            exp2f(s[j][2] - mn1), exp2f(s[j][3] - mn1));
        l0 += __low2float(p01) + __high2float(p01);
        l1 += __low2float(p23) + __high2float(p23);
        pf[j / 2][(j % 2) * 2] = as_u32(p01);
        pf[j / 2][(j % 2) * 2 + 1] = as_u32(p23);
      } else {
        const float p0 = exp2f(s[j][0] - mn0), p1 = exp2f(s[j][1] - mn0);
        const float p2 = exp2f(s[j][2] - mn1), p3 = exp2f(s[j][3] - mn1);
        l0 += p0 + p1;  // before dropout, unrounded
        l1 += p2 + p3;
        const float f = kp.inv_keep;
        pf[j / 2][(j % 2) * 2] = as_u32(__floats2bfloat162_rn(
            p0 * stt::keep_factor(keep, j, 0, f),
            p1 * stt::keep_factor(keep, j, 1, f)));
        pf[j / 2][(j % 2) * 2 + 1] = as_u32(__floats2bfloat162_rn(
            p2 * stt::keep_factor(keep, j, 2, f),
            p3 * stt::keep_factor(keep, j, 3, f)));
      }
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
  if (LSE && t4 == 0) {
    float* lrow = lse + (static_cast<size_t>(blockIdx.z) * gridDim.y +
                         blockIdx.y) * n;
    if (row0 < n) lrow[row0] = m0 + log2f(l0);
    if (row1 < n) lrow[row1] = m1 + log2f(l1);
  }
  if (Q8) {
    const float oinv = stt::quant_inv(out_amax);
    int8_t* ob = static_cast<int8_t*>(o) + batch * st.o_sb + hoff;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int col = j * 8 + t4 * 2;
      if (col >= d) continue;
      if (row0 < n) {
        *reinterpret_cast<char2*>(ob + static_cast<size_t>(row0) * st.o_sn +
                                  col) =
            make_char2(stt::quant_i8(__fdiv_rn(acc[j][0], l0), oinv),
                       stt::quant_i8(__fdiv_rn(acc[j][1], l0), oinv));
      }
      if (row1 < n) {
        *reinterpret_cast<char2*>(ob + static_cast<size_t>(row1) * st.o_sn +
                                  col) =
            make_char2(stt::quant_i8(__fdiv_rn(acc[j][2], l1), oinv),
                       stt::quant_i8(__fdiv_rn(acc[j][3], l1), oinv));
      }
    }
    return;
  }
  bf16* ob = static_cast<bf16*>(o) + batch * st.o_sb + hoff;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + t4 * 2;
    if (col >= d) continue;
    if (row0 < n) {
      *reinterpret_cast<__nv_bfloat162*>(
          ob + static_cast<size_t>(row0) * st.o_sn + col) =
          __floats2bfloat162_rn(acc[j][0] / l0, acc[j][1] / l0);
    }
    if (row1 < n) {
      *reinterpret_cast<__nv_bfloat162*>(
          ob + static_cast<size_t>(row1) * st.o_sn + col) =
          __floats2bfloat162_rn(acc[j][2] / l1, acc[j][3] / l1);
    }
  }
}

template <int DP, bool LSE, bool Q8, Drop DROP = Drop::kNone>
__global__ void __launch_bounds__(kBlockM)
    attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, void* __restrict__ o,
                        float* __restrict__ lse,
                        const float* __restrict__ out_amax, int n, int n_kv,
                        int d, Strides st, float qscale, Keep kp) {
  __shared__ float sK[kBlockNF32][DP];
  __shared__ float sV[kBlockNF32][DP];
  const int row = blockIdx.x * kBlockM + threadIdx.x;
  const size_t batch = blockIdx.z;
  const size_t hoff = static_cast<size_t>(blockIdx.y) * d;
  const float* qb = q + batch * st.q_sb + hoff;
  const float* kb = k + batch * st.k_sb + hoff;
  const float* vb = v + batch * st.v_sb + hoff;

  float qr[DP], acc[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    qr[c] = (row < n && c < d)
                ? qb[static_cast<size_t>(row) * st.q_sn + c] * qscale
                : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const int bh = stt::rng_head(kp, blockIdx.z, blockIdx.y);
  const int8_t* mh = DROP == Drop::kMask ? stt::mask_head(kp) : nullptr;
  for (int k0 = 0; k0 < n_kv; k0 += kBlockNF32) {
    for (int i = threadIdx.x; i < kBlockNF32 * DP; i += kBlockM) {
      const int r = i / DP;
      const int c = i % DP;
      const bool ok = k0 + r < n_kv && c < d;
      const size_t key = k0 + r;
      sK[r][c] = ok ? kb[key * st.k_sn + c] : 0.f;
      sV[r][c] = ok ? vb[key * st.v_sn + c] : 0.f;
    }
    __syncthreads();
    const int nk = min(kBlockNF32, n_kv - k0);
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
      float p = exp2f(s - m);
      l += p;  // before dropout
      if constexpr (DROP != Drop::kNone) {
        p = row < n && stt::keep_one<DROP>(kp, mh, bh, row, k0 + j, n)
                ? p * kp.inv_keep
                : 0.f;
      }
#pragma unroll
      for (int c = 0; c < DP; ++c) acc[c] = fmaf(p, sV[j][c], acc[c]);
    }
    __syncthreads();
  }
  if (row < n && Q8) {
    const float oinv = stt::quant_inv(out_amax);
    int8_t* orow = static_cast<int8_t*>(o) + batch * st.o_sb + hoff +
                   static_cast<size_t>(row) * st.o_sn;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < d) orow[c] = stt::quant_i8(__fdiv_rn(acc[c], l), oinv);
    }
  } else if (row < n) {
    float* orow = static_cast<float*>(o) + batch * st.o_sb + hoff +
                  static_cast<size_t>(row) * st.o_sn;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < d) orow[c] = acc[c] / l;
    }
    if (LSE) {
      lse[(static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * n +
          row] = m + log2f(l);
    }
  }
}

// ---- the wgmma route: bf16, head dims 64 to 128 ----
namespace wg {

namespace hw = stt::hopper;

constexpr int kMinD = 64;                     // the route's least head dim
constexpr int kRows = 64;                     // queries a block, keys a tile
constexpr int kThreads = 128;                 // one warpgroup a block
constexpr int kStages = 2;                    // the ring of (k, v) tiles

// the tile width of a head dim, a tile's column atoms and where a head's
// columns sit in its tiles (attention_wg.cuh, shared with the backward of
// attention_train.cu)
using stt::attn_wg::head_cols;
using stt::attn_wg::Tile;
using stt::attn_wg::tile_width;

template <int DP>
struct Smem {
  bf16 q[kRows * DP];             // the block's q, scaled in place: A of S
  bf16 k[kStages][kRows * DP];    // B of S (K-major)
  bf16 v[kStages][kRows * DP];    // B of PV (MN-major)
  uint64_t full[kStages], qbar;
};

// blocks an SM the registers are budgeted for: 92 registers a thread at
// DP = 64 (five blocks fit its 42 KB of shared memory), DP / 2 fp32 O
// accumulators beside S's 32 at the others (three blocks fit 60 KB at 96,
// two 80 KB at 128)
template <int DP>
constexpr int kMinBlocks = DP == 64 ? 4 : DP == 96 ? 3 : 2;

// the online softmax and the pack of P (attention_wg.cuh, shared with the
// int8-storage kernel of attention_i8.cu)
using stt::attn_wg::rescale_and_pack;
using stt::attn_wg::tile_softmax;
static_assert(stt::attn_wg::kTile == kRows, "one tile size");

// One block per (64-query tile, head, batch), one warpgroup.  The raw q
// tile arrives by TMA and is scaled in place (bf16(q * qscale), the
// numerics of the mma.sync kernel); (k, v) tiles stream by TMA through a
// ring of kStages, thread 0 refilling a stage once the block's barrier at
// the end of its tile shows every warp done with it, so the next tile's
// copy runs under this tile's work.  A tile is DP columns that hold the
// head's d (Tile<DP>'s atoms, one TMA box each, rows at or beyond n or
// n_kv reading as zero): they start at the head's first column rounded
// down to a multiple of 16, since a TMA row that starts off a 32-byte
// sector ran much slower on the H100 (untimed), so at d = 8 (mod 16)
// an odd head's tile starts with the previous head's last 8 columns, and
// any tile may end in the next head's first columns (or beyond the last
// head, zero).  Those columns of q are zeroed in the scale pass, so K's
// add 0 to S as long as they are finite (the route's precondition on k:
// see attention_fwd_route), and those of O are not stored.  S = Qs K^T by
// wgmma m64n64k16 from shared memory (both K-major, DP / 16 k-steps across
// the atoms), the online softmax in registers, O += bf16(P) V by wgmma
// m64nDPk16 with P from registers and V read MN-major (no transposed
// copy).  A tile's S, softmax and PV run in turn;
// the SM's blocks overlap one another's products and softmax (an
// in-warpgroup pipeline, S of the next tile issued with this tile's PV,
// measured slower on the H100 at DP = 64: PERF.md).  Query rows at or
// beyond n and O's columns outside the head are not stored; the lse (LSE)
// is stored from the threads.
// With DROP (kernel C4-fwd, LSE only) a tile's keep bits come from kp: the
// Philox words drawn while its S product runs, or the mask tile staged with
// its (k, v) (copy_mask_tile; every thread then arrives on the stage's
// barrier too) and read under the S product; rescale_and_pack<DROP> applies
// them.
template <int DP, bool LSE, bool Q8, Drop DROP = Drop::kNone>
__global__ void __launch_bounds__(kThreads, kMinBlocks<DP>)
    attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          void* __restrict__ o, float* __restrict__ lse,
                          const float* __restrict__ out_amax, int n,
                          int n_kv, int d, int o_sb, int o_sn, float qscale,
                          Keep kp) {
  using T = Tile<DP>;
  constexpr bool kMask = DROP == Drop::kMask;
  extern __shared__ unsigned char smem_raw[];
  Smem<DP>& sm = *reinterpret_cast<Smem<DP>*>(hw::align_1024(smem_raw));
  int8_t* mtile = reinterpret_cast<int8_t*>(&sm) + stt::mask_off<Smem<DP>>();
  const int8_t* mh = kMask ? stt::mask_head(kp) : nullptr;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kRows;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (n_kv + kRows - 1) / kRows;
  // the head dim, and the head's columns [shift, shift + dh) of the tiles,
  // which start at column col0 of the operands (a multiple of 16)
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
    hw::mbar_init(&sm.qbar, 1);
    hw::mbar_init_fence();
    hw::mbar_expect_tx(&sm.qbar, T::kBytes);
    T::load(sm.q, &tq, &sm.qbar, col0, q0, b);
  }
  __syncthreads();
  for (int j = 0; j < kStages && j < tiles; ++j) fill(j);
  // Philox: the seed words, once
  uint32_t s0 = 0, s1 = 0;
  if constexpr (DROP == Drop::kPhilox) {
    s0 = static_cast<uint32_t>(kp.seed[0]);
    s1 = static_cast<uint32_t>(kp.seed[1]);
  }
  const int bh = stt::rng_head(kp, b, head);

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const uint64_t desc_q = T::kmajor(sm.q);
  hw::mbar_wait(&sm.qbar, 0);
  if constexpr (DP == 64) {
    hw::scale_tile(sm.q, sm.q, qscale);  // the whole tile is the head's
  } else {
    hw::scale_tile_window<DP, T::kAtom>(sm.q, sm.q, qscale, shift,
                                        shift + dh);
  }
  __syncthreads();

  float acc[DP / 2], sc[32], m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f}, a[2];
  uint32_t pf[4][4];
  hw::zero(acc);
  hw::zero(sc);
  for (int j = 0; j < tiles; ++j) {
    const int s = j % kStages;
    hw::mbar_wait(&sm.full[s], (j / kStages) & 1);
    // S = (q * scale * log2e) K^T: 64 queries x 64 keys, fp32
    const uint64_t desc_k = T::kmajor(sm.k[s]);
    hw::fence_regs(sc);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      hw::wgmma_ss(sc, desc_q + T::kk_offset(kk), desc_k + T::kk_offset(kk),
                   kk);
    }
    hw::wgmma_commit();
    uint32_t keep = 0;  // this tile's keep bits, drawn under the product
    if constexpr (DROP == Drop::kPhilox) {
      keep = stt::philox_bits<false, 8>(s0, s1, kp.thresh, bh,
                                        q0 + warp * 16 + g, j * kRows, t4);
    } else if constexpr (kMask) {
      keep = stt::keep_bits_smem<false>(mtile + s * stt::kMaskTile,
                                        warp * 16 + g, t4);
    }
    hw::wgmma_wait<0>();
    hw::fence_regs(sc);

    tile_softmax(sc, j * kRows, n_kv, t4, m, a);
    rescale_and_pack<DROP>(acc, sc, a, l, pf, keep, kp.inv_keep);

    // O += bf16(P) V  (64 queries x DP dims)
    const uint64_t desc_v = T::mnmajor(sm.v[s]);
    hw::fence_regs(acc);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      hw::wgmma_rs_mn(acc, pf[kk], desc_v + kk * T::kMnStep, 1);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(acc);
    hw::fence_regs(pf);
    __syncthreads();  // every warp is done with stage s: refill it
    if (j + kStages < tiles) fill(j + kStages);
  }

  // full row denominators, normalise, store the d columns of the head
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
    }
  }
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  if (LSE && t4 == 0) {
    float* lrow = lse + (static_cast<size_t>(b) * gridDim.y + head) *
                            static_cast<size_t>(n);
    if (row0 < n) lrow[row0] = m[0] + log2f(l[0]);
    if (row1 < n) lrow[row1] = m[1] + log2f(l[1]);
  }
  const size_t ooff = static_cast<size_t>(b) * o_sb +
                      static_cast<size_t>(head) * dh;
  if constexpr (Q8) {
    stt::attn_wg::store_rows_q8(static_cast<int8_t*>(o) + ooff, acc, l,
                                out_amax, row0, n, o_sn, t4, dh, shift);
  } else {
    bf16* ob = static_cast<bf16*>(o) + ooff;
    const size_t at0 = static_cast<size_t>(row0) * o_sn;
    const size_t at1 = static_cast<size_t>(row1) * o_sn;
#pragma unroll
    for (int j8 = 0; j8 < DP / 8; ++j8) {
      const int c = j8 * 8 + t4 * 2 - shift;
      const int i = j8 * 4;
      if (c < 0 || c >= dh) continue;
      if (row0 < n) {
        *reinterpret_cast<__nv_bfloat162*>(ob + at0 + c) =
            __floats2bfloat162_rn(acc[i] / l[0], acc[i + 1] / l[0]);
      }
      if (row1 < n) {
        *reinterpret_cast<__nv_bfloat162*>(ob + at1 + c) =
            __floats2bfloat162_rn(acc[i + 2] / l[1], acc[i + 3] / l[1]);
      }
    }
  }
}

}  // namespace wg

// Output and scratch of one launch: o (and, with Q8, the absmax its int8
// codes are made against), lse (LSE only), and the keep source (DROP only).
struct Out {
  void* o;
  float* lse;
  const float* out_amax;
  Keep keep;
};

// Which kernel a call takes (shared with ops/flash_attention.py:
// attention_fwd_route): fp32 the CUDA-core kernel; bf16 at head dims 64 to
// 128 the wgmma kernel, with or without dropout (C4-fwd in either keep
// form); bf16 at head dims 8 to 56 the mma.sync kernel.
enum Route : int { kRouteF32 = 0, kRouteMma = 1, kRouteWgmma = 2 };

constexpr int route(int dtype, int d) {
  return dtype == stt::kFloat32 ? kRouteF32
         : d >= wg::kMinD       ? kRouteWgmma
                                : kRouteMma;
}

// The wgmma route at tile width DP: three tensor maps (q, k and v by
// (batch, row, column) tiles of Tile<DP>'s atom width over the operand's
// h * d columns; k and v end at n_kv, q at n), encoded per call, then one
// launch on the stream.  A map that does not encode fails the call:
// nothing falls back to the mma.sync kernel.
template <int DP, bool LSE, bool Q8, Drop DROP>
int launch_wgmma(const void* q, const void* k, const void* v, const Out& out,
                 int b, int n, int n_kv, int h, int d, const Strides& st,
                 float qscale, cudaStream_t stream) {
  namespace hw = stt::hopper;
  constexpr int box = wg::Tile<DP>::kAtom;
  const int cols = h * d;
  CUtensorMap tq, tk, tv;
  if (!hw::tile_map_bf16(&tq, q, cols, n, b, st.q_sn, st.q_sb, box) ||
      !hw::tile_map_bf16(&tk, k, cols, n_kv, b, st.k_sn, st.k_sb, box) ||
      !hw::tile_map_bf16(&tv, v, cols, n_kv, b, st.v_sn, st.v_sb, box)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = stt::smem_bytes<wg::Smem<DP>, wg::kStages>(DROP);
  const cudaError_t err = cudaFuncSetAttribute(
      wg::attn_fwd_wgmma_kernel<DP, LSE, Q8, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + wg::kRows - 1) / wg::kRows, h, b);
  wg::attn_fwd_wgmma_kernel<DP, LSE, Q8, DROP><<<grid, wg::kThreads, smem,
                                                 stream>>>(
      tq, tk, tv, out.o, out.lse, out.out_amax, n, n_kv, d, st.o_sb,
      st.o_sn, qscale, out.keep);
  return static_cast<int>(cudaGetLastError());
}

// The mma.sync (bf16, DP <= 64: head dims 8 to 56) and CUDA-core (fp32)
// kernels
template <int DP, bool LSE, bool Q8, Drop DROP>
int launch(const void* q, const void* k, const void* v, const Out& out,
           int b, int n, int n_kv, int h, int d, const Strides& st,
           float qscale, int dtype, cudaStream_t stream) {
  const dim3 grid((n + kBlockM - 1) / kBlockM, h, b);
  if (dtype == stt::kBFloat16) {
    if constexpr (DP <= wg::kMinD) {
      attn_fwd_bf16_kernel<DP, LSE, Q8, DROP><<<grid, kThreads, 0, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), out.o, out.lse, out.out_amax, n, n_kv,
          d, st, qscale, out.keep);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);  // the wgmma route's
    }
  } else {
    attn_fwd_f32_kernel<DP, LSE, Q8, DROP><<<grid, kBlockM, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), out.o, out.lse, out.out_amax, n, n_kv,
        d, st, qscale, out.keep);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool LSE, bool Q8 = false, Drop DROP = Drop::kNone>
int dispatch(const void* q, const void* k, const void* v, const Out& out,
             int b, int n, int n_kv, int h, int d, const Strides& st,
             float qscale, int dtype, void* stream) {
  if (b <= 0 || n <= 0 || n_kv <= 0 || n_kv > n || h <= 0 || d <= 0 ||
      d % 8 != 0 || d > 128 || b > 65535 || h > 65535 ||
      (Q8 && out.out_amax == nullptr) ||
      (dtype != stt::kBFloat16 && dtype != stt::kFloat32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route(dtype, d) == kRouteWgmma) {
#define STT_WG(DP)                                                      \
  launch_wgmma<DP, LSE, Q8, DROP>(q, k, v, out, b, n, n_kv, h, d, st, \
                                  qscale, s)
    switch (wg::tile_width(d)) {
      case 64: return STT_WG(64);
      case 96: return STT_WG(96);
      default: return STT_WG(128);
    }
#undef STT_WG
  }
#define STT_FWD(DP) \
  launch<DP, LSE, Q8, DROP>(q, k, v, out, b, n, n_kv, h, d, st, qscale, dtype, s)
  switch ((d + 15) / 16 * 16) {
    case 16: return STT_FWD(16);
    case 32: return STT_FWD(32);
    case 48: return STT_FWD(48);
    case 64: return STT_FWD(64);
    case 80: return STT_FWD(80);
    case 96: return STT_FWD(96);
    case 112: return STT_FWD(112);
    default: return STT_FWD(128);
  }
#undef STT_FWD
}

}  // namespace

// q, k, v: base pointers of head 0 (for packed qkv: qkv, qkv + C, qkv + 2C);
// element (batch, row, head h, dim c) of q is at
// q + batch * q_sb + row * q_sn + h * d + c, and likewise for k (k_sb,
// k_sn), v (v_sb, v_sn) and o (o_sb, o_sn).  d must be a multiple of 8 and
// at most 128; for bf16 every base pointer and stride must keep 16-byte
// alignment.
extern "C" int stt_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, int b, int n, int h, int d,
                                 int q_sb, int q_sn, int k_sb, int k_sn,
                                 int v_sb, int v_sn, int o_sb, int o_sn,
                                 float qscale, int dtype, void* stream) {
  const Strides st{q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn};
  return dispatch<false>(q, k, v, Out{o, nullptr, nullptr}, b, n, n, h, d, st,
                         qscale, dtype, stream);
}

// The route an A1, C1, C3-fwd, B3 or C4-fwd call (either keep form) of
// this dtype code and head dim takes: 0 the fp32 CUDA-core kernel, 1 the
// mma.sync kernel, 2 the wgmma kernel; -1 for what the entry points refuse.
extern "C" int stt_attention_fwd_route(int dtype, int d) {
  if (d <= 0 || d % 8 != 0 || d > 128 ||
      (dtype != stt::kBFloat16 && dtype != stt::kFloat32)) {
    return -1;
  }
  return route(dtype, d);
}

// Kernel C1: A1 on the packed qkv (one stride pair for q, k and v) that
// also writes lse (B, H, N) fp32, contiguous, base 2 (replaces the TPU
// kernel _fwd_kernel_nomax_packed_lse, launched by
// _flash_fwd_packed_qkv_impl).
extern "C" int stt_attention_fwd_lse(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     int b, int n, int h, int d, int in_sb,
                                     int in_sn, int out_sb, int out_sn,
                                     float qscale, int dtype, void* stream) {
  const Strides st{in_sb, in_sn, in_sb, in_sn, in_sb, in_sn, out_sb, out_sn};
  return dispatch<true>(q, k, v, Out{o, lse, nullptr}, b, n, n, h, d, st,
                        qscale, dtype, stream);
}

// Kernel C3-fwd: C1 on separate q, k and v, each read through its own
// (batch, row) stride pair, as stt_attention_fwd takes them (InternVideo2's
// training forward: q and k the q/k-norms' outputs, v the column block of
// the qkv output).  Replaces the TPU kernel _fwd_kernel, launched by
// _flash_fwd_impl from the custom VJPs _flash_core_packed and _flash_core.
// That kernel subtracts the true row maximum; this one the integer running
// maximum above, which gives the same softmax and lse up to the bf16
// rounding of p (ops/flash_attention.py:flash_attention_fwd_lse_plain).
// Bounded like A1 (tensor-core throughput at N = 2049, Dh = 64).
extern "C" int stt_attention_fwd_lse_sep(const void* q, const void* k,
                                         const void* v, void* o, float* lse,
                                         int b, int n, int h, int d, int q_sb,
                                         int q_sn, int k_sb, int k_sn,
                                         int v_sb, int v_sn, int o_sb,
                                         int o_sn, float qscale, int dtype,
                                         void* stream) {
  const Strides st{q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn};
  return dispatch<true>(q, k, v, Out{o, lse, nullptr}, b, n, n, h, d, st,
                        qscale, dtype, stream);
}

// Kernel C4-fwd: C3-fwd with attention dropout (replaces the TPU kernels
// _fwd_kernel_drop, launched by _flash_drop_fwd_impl, and
// _fwd_kernel_drop_rng with _unit_keep, launched by
// _flash_drop_rng_fwd_impl).  The keep source is exactly one of ``mask``
// (int8 (B, H, N, N), 1 = keep, (batch, head) strides m_sb, m_sh in bytes,
// rows of N contiguous bytes) and ``seed`` (2 int32 words in device memory:
// Philox4x32-10 with the map of philox.cuh; nothing is read to the host);
// kept probabilities are scaled by inv_keep = 1 / (1 - rate) and the
// Philox bits kept where they are at least thresh.  Bounded like C1 (the
// two tensor-core products); the mask form adds N^2 bytes per (batch,
// head) read, the Philox form ~20 integer operations per score element.
// The Philox counter keys head h of batch b as b * rng_heads + rng_h0 + h
// (philox.cuh): rng_h0 = 0 and rng_heads = h outside tensor parallelism.
// At head dims 64 to 128 in bf16 it is the wgmma kernel (route()).
extern "C" int stt_attention_fwd_lse_drop(
    const void* q, const void* k, const void* v, void* o, float* lse, int b,
    int n, int h, int d, int q_sb, int q_sn, int k_sb, int k_sn, int v_sb,
    int v_sn, int o_sb, int o_sn, float qscale, const int8_t* mask,
    long long m_sb, long long m_sh, const int32_t* seed, unsigned thresh,
    float inv_keep, int rng_h0, int rng_heads, int dtype, void* stream) {
  if ((mask == nullptr) == (seed == nullptr) || !(inv_keep >= 1.f) ||
      rng_h0 < 0 || rng_heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides st{q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn};
  const Out out{o, lse, nullptr,
                Keep{mask, m_sb, m_sh, seed, thresh, inv_keep,
                     stt::mask_vec(mask, m_sb, m_sh, n), rng_h0, rng_heads}};
  return mask != nullptr
             ? dispatch<true, false, Drop::kMask>(q, k, v, out, b, n, n, h,
                                                  d, st, qscale, dtype,
                                                  stream)
             : dispatch<true, false, Drop::kPhilox>(q, k, v, out, b, n, n, h,
                                                    d, st, qscale, dtype,
                                                    stream);
}

// Kernel B3: A1 with the int8 output epilogue, on the packed qkv (three base
// pointers, one stride pair passed three times) or on separate q, k and v
// (InternVideo2, v the strided column block of the qkv output).  o is int8
// with its own (batch, row) strides; out_amax one fp32 value in device
// memory; keys at or beyond n_kv (1 <= n_kv <= n) are masked.  Replaces
// _fwd_kernel_nomax_packed_q8 and _fwd_kernel_nomax_packed_kv_q8.
extern "C" int stt_attention_q8(const void* q, const void* k, const void* v,
                                const float* out_amax, void* o, int b, int n,
                                int n_kv, int h, int d, int q_sb, int q_sn,
                                int k_sb, int k_sn, int v_sb, int v_sn,
                                int o_sb, int o_sn, float qscale, int dtype,
                                void* stream) {
  const Strides st{q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn};
  return dispatch<false, true>(q, k, v, Out{o, nullptr, out_amax}, b, n,
                               n_kv, h, d, st, qscale, dtype, stream);
}
