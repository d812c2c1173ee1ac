// The keep sources of the attention dropout kernels (C4): an int8 keep mask
// in device memory, or Philox4x32-10 drawn inside the kernel from a 2-word
// seed.  The TPU kernels draw their bits from the TPU's hardware PRNG
// (simple_tad_tpu/ops/flash_attention.py:_unit_keep), whose bits no other
// device reproduces; the port's generator is Philox (Salmon et al., SC
// 2011), written out here with __umulhi, and the plain version
// (ops/flash_attention.py:philox4x32_plain, dropout_keep_plain) computes
// the same words in PyTorch integer arithmetic.
//
// The map from a score element to its bits, a pure function of
// (b * H + h, query q, key k) and kept in this one place (copied exactly
// into dropout_keep_plain):
//   counter = (k & ~8, q & ~8, b * H + h, 0), key = (seed[0], seed[1]);
//   word    = 2 * ((q >> 3) & 1) + ((k >> 3) & 1) of the four outputs;
//   kept iff word >= thresh, thresh = min(int(rate * 2^32), 2^32 - 1).
// One call covers queries {q, q + 8} x keys {k, k + 8}.  An m16n8k16
// accumulator fragment holds rows {r, r + 8} and two adjacent columns of
// an 8-column tile, and the forward and dq kernels (rows are queries) and
// the dk/dv kernel (rows are keys) each walk two adjacent column tiles
// together, so in either orientation a thread's two calls per tile pair
// give exactly its 16 elements: no word is drawn twice in a kernel.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

namespace stt {

enum class Drop : int { kNone = 0, kMask = 1, kPhilox = 2 };

// The keep source of one launch: ``mask`` (int8 (B, H, N, N), 1 = keep,
// (batch, head) strides m_sb, m_sh in bytes, rows of N contiguous bytes)
// or ``seed`` (2 int32 words in device memory), and the factor kept
// probabilities are scaled by.
struct Keep {
  const int8_t* mask;
  long long m_sb, m_sh;
  const int32_t* seed;
  uint32_t thresh;
  float inv_keep;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// the four words of the group at (query q & ~8, key k & ~8) of head bh
__device__ __forceinline__ uint4 keep_words(const Keep& kp, int bh, int q,
                                            int k) {
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(k & ~8), static_cast<uint32_t>(q & ~8),
                 static_cast<uint32_t>(bh), 0u),
      static_cast<uint32_t>(kp.seed[0]), static_cast<uint32_t>(kp.seed[1]));
}

// this block's (batch blockIdx.z, head blockIdx.y) slice of the mask
__device__ __forceinline__ const int8_t* mask_head(const Keep& kp) {
  return kp.mask + blockIdx.z * kp.m_sb + blockIdx.y * kp.m_sh;
}

// Is element (query q, key k) of head bh kept?  One element at a time (the
// fp32 CUDA-core kernels); q and k below n.
template <Drop DROP>
__device__ __forceinline__ bool keep_one(const Keep& kp, const int8_t* mh,
                                         int bh, int q, int k, int n) {
  if constexpr (DROP == Drop::kMask) {
    return mh[static_cast<size_t>(q) * n + k] != 0;
  } else {
    const uint4 w = keep_words(kp, bh, q, k);
    const int i = 2 * ((q >> 3) & 1) + ((k >> 3) & 1);
    const uint32_t word = i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
    return word >= kp.thresh;
  }
}

// Keep bits of one thread's part of a warp's 16 x (8 NT) score slice, as an
// m16n8k16 accumulator holds it: bit 4 j + e is element e of column tile j,
// e = 0: (row r, column c), 1: (r, c + 1), 2: (r + 8, c), 3: (r + 8, c + 1)
// with c = c0 + 8 j + 2 t4.  r and c0 have bit 3 clear (r = 16-row group
// base + g, c0 a multiple of 16).  Rows are queries and columns keys, or
// with TRANS (the dk/dv kernel) rows are keys and columns queries.
// Elements at or beyond n are never kept.
template <Drop DROP, bool TRANS, int NT>
__device__ __forceinline__ uint32_t keep_bits(const Keep& kp,
                                              const int8_t* mh, int bh, int r,
                                              int c0, int t4, int n) {
  static_assert(NT % 2 == 0 && NT <= 8, "tile pairs, 32 bits");
  uint32_t bits = 0;
  if constexpr (DROP == Drop::kPhilox) {
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
#pragma unroll
      for (int dc = 0; dc < 2; ++dc) {
        const int c = c0 + 16 * jp + 2 * t4 + dc;
        const uint4 w = TRANS ? keep_words(kp, bh, c, r)
                              : keep_words(kp, bh, r, c);
        // element (row r + 8 a, column c + 8 b) is word 2a + b, or 2b + a
        // with TRANS; it sits in tile 2 jp + b as e = 2a + dc
        const uint32_t w01 = TRANS ? w.z : w.y;  // a = 0, b = 1
        const uint32_t w10 = TRANS ? w.y : w.z;  // a = 1, b = 0
        const int j0 = 4 * (2 * jp) + dc, j1 = j0 + 4;
        bits |= static_cast<uint32_t>(w.x >= kp.thresh) << j0;
        bits |= static_cast<uint32_t>(w10 >= kp.thresh) << (j0 + 2);
        bits |= static_cast<uint32_t>(w01 >= kp.thresh) << j1;
        bits |= static_cast<uint32_t>(w.w >= kp.thresh) << (j1 + 2);
      }
    }
    // groups past the edge draw words too; p is 0 there, so they are inert
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r + 8 * (e >> 1);
        const int col = c0 + 8 * j + 2 * t4 + (e & 1);
        const int q = TRANS ? col : row;
        const int k = TRANS ? row : col;
        if (q < n && k < n && mh[static_cast<size_t>(q) * n + k] != 0) {
          bits |= 1u << (4 * j + e);
        }
      }
    }
  }
  return bits;
}

// the factor of element (tile j, e): 1 / keep or 0
__device__ __forceinline__ float keep_factor(uint32_t bits, int j, int e,
                                             float inv_keep) {
  return (bits >> (4 * j + e)) & 1u ? inv_keep : 0.f;
}

}  // namespace stt
