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
template <int DP, bool LSE>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int n, int d, Strides st,
                         float qscale) {
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

  for (int k0 = 0; k0 < n; k0 += kBlockN) {
    load_tile<DP, kBlockN, false, false>(sK, KS, kb, k0, n, d, st.k_sn, 0.f);
    load_tile<DP, kBlockN, true, false>(sVt, VS, vb, k0, n, d, st.v_sn, 0.f);
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
  if (LSE && t4 == 0) {
    float* lrow = lse + (static_cast<size_t>(blockIdx.z) * gridDim.y +
                         blockIdx.y) * n;
    if (row0 < n) lrow[row0] = m0 + log2f(l0);
    if (row1 < n) lrow[row1] = m1 + log2f(l1);
  }
  bf16* ob = o + batch * st.o_sb + hoff;
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

template <int DP, bool LSE>
__global__ void __launch_bounds__(kBlockM)
    attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int n, int d, Strides st,
                        float qscale) {
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
  for (int k0 = 0; k0 < n; k0 += kBlockNF32) {
    for (int i = threadIdx.x; i < kBlockNF32 * DP; i += kBlockM) {
      const int r = i / DP;
      const int c = i % DP;
      const bool ok = k0 + r < n && c < d;
      const size_t key = k0 + r;
      sK[r][c] = ok ? kb[key * st.k_sn + c] : 0.f;
      sV[r][c] = ok ? vb[key * st.v_sn + c] : 0.f;
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
    float* orow = o + batch * st.o_sb + hoff +
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

template <int DP, bool LSE>
void launch(const void* q, const void* k, const void* v, void* o, float* lse,
            int b, int n, int h, int d, const Strides& st, float qscale,
            int dtype, cudaStream_t stream) {
  const dim3 grid((n + kBlockM - 1) / kBlockM, h, b);
  if (dtype == stt::kBFloat16) {
    attn_fwd_bf16_kernel<DP, LSE><<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, n, d, st,
        qscale);
  } else {
    attn_fwd_f32_kernel<DP, LSE><<<grid, kBlockM, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, n, d, st,
        qscale);
  }
}

template <bool LSE>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int b, int n, int h, int d, const Strides& st,
             float qscale, int dtype, void* stream) {
  if (b <= 0 || n <= 0 || h <= 0 || d <= 0 || d % 8 != 0 || d > 128 ||
      b > 65535 || h > 65535 ||
      (dtype != stt::kBFloat16 && dtype != stt::kFloat32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16 * 16) {
    case 16: launch<16, LSE>(q, k, v, o, lse, b, n, h, d, st, qscale, dtype, s); break;
    case 32: launch<32, LSE>(q, k, v, o, lse, b, n, h, d, st, qscale, dtype, s); break;
    case 48: launch<48, LSE>(q, k, v, o, lse, b, n, h, d, st, qscale, dtype, s); break;
    case 64: launch<64, LSE>(q, k, v, o, lse, b, n, h, d, st, qscale, dtype, s); break;
    case 80: launch<80, LSE>(q, k, v, o, lse, b, n, h, d, st, qscale, dtype, s); break;
    case 96: launch<96, LSE>(q, k, v, o, lse, b, n, h, d, st, qscale, dtype, s); break;
    case 112: launch<112, LSE>(q, k, v, o, lse, b, n, h, d, st, qscale, dtype, s); break;
    default: launch<128, LSE>(q, k, v, o, lse, b, n, h, d, st, qscale, dtype, s); break;
  }
  return static_cast<int>(cudaGetLastError());
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
  return dispatch<false>(q, k, v, o, nullptr, b, n, h, d, st, qscale, dtype,
                         stream);
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
  return dispatch<true>(q, k, v, o, lse, b, n, h, d, st, qscale, dtype,
                        stream);
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
  return dispatch<true>(q, k, v, o, lse, b, n, h, d, st, qscale, dtype,
                        stream);
}
