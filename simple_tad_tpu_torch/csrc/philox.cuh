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
// H and h are the model's head count and the global head index: a launch
// over a tensor-parallel rank's heads (parallel/tp.py) passes its first
// head h0 and the model's head count (Keep::h0, Keep::heads), and its
// local head hl draws at h = h0 + hl (rng_head), so every rank draws the
// bits one launch over all the heads would.
//   word    = 2 * ((q >> 3) & 1) + ((k >> 3) & 1) of the four outputs;
//   kept iff word >= thresh, thresh = min(int(rate * 2^32), 2^32 - 1).
// One call covers queries {q, q + 8} x keys {k, k + 8}.  An m16n8k16
// accumulator fragment holds rows {r, r + 8} and two adjacent columns of
// an 8-column tile, and the forward and dq kernels (rows are queries) and
// the dk/dv kernel (rows are keys) each walk two adjacent column tiles
// together, so in either orientation a thread's two calls per tile pair
// give exactly its 16 elements: no word is drawn twice in a kernel.  The
// wgmma kernels' accumulators (m64nNk16: warp w holds rows 16 w + g and
// 16 w + g + 8, columns 8 j + 2 t4 + {0, 1}) are that fragment repeated, so
// keep_bits serves them unchanged.
//
// The wgmma kernels stage the mask form's 64 x 64 int8 tiles through their
// ring of streamed operands (copy_mask_tile) and read the bits from shared
// memory (keep_bits_smem) in either orientation.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace stt {

enum class Drop : int { kNone = 0, kMask = 1, kPhilox = 2 };

// The keep source of one launch: ``mask`` (int8 (B, H, N, N), 1 = keep,
// (batch, head) strides m_sb, m_sh in bytes, rows of N contiguous bytes)
// or ``seed`` (2 int32 words in device memory), and the factor kept
// probabilities are scaled by.
// ``mask_vec`` is the widest of 16, 8 and 4 bytes that divides the mask's
// base address, its strides and N, else 1 (mask_vec below): the width the
// wgmma kernels copy a mask tile by.  ``h0`` and ``heads``: the Philox
// counter's first head and head count (the launch's own H and 0 unless it
// covers a tensor-parallel rank's heads).
struct Keep {
  const int8_t* mask;
  long long m_sb, m_sh;
  const int32_t* seed;
  uint32_t thresh;
  float inv_keep;
  int mask_vec;
  int h0, heads;
};

// The Philox counter's head word of (batch b, the launch's head h)
__device__ __forceinline__ int rng_head(const Keep& kp, int b, int h) {
  return b * kp.heads + kp.h0 + h;
}

inline int mask_vec(const int8_t* mask, long long m_sb, long long m_sh,
                    int n) {
  const unsigned long long bits =
      static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(mask)) |
      static_cast<unsigned long long>(m_sb) |
      static_cast<unsigned long long>(m_sh) |
      static_cast<unsigned long long>(n);
  return bits % 16 == 0 ? 16 : bits % 8 == 0 ? 8 : bits % 4 == 0 ? 4 : 1;
}

// ROUNDS = 10 is Philox4x32-10; philox_cost_kernel (attention_train.cu)
// also builds ROUNDS = 0, the same code without the rounds
template <int ROUNDS = 10>
__device__ __forceinline__ uint4 philox4x32(uint4 c, uint32_t k0,
                                            uint32_t k1) {
#pragma unroll
  for (int i = 0; i < ROUNDS; ++i) {
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
// under the seed words (s0, s1)
__device__ __forceinline__ uint4 group_words(uint32_t s0, uint32_t s1, int bh,
                                             int q, int k) {
  return philox4x32(
      make_uint4(static_cast<uint32_t>(k & ~8), static_cast<uint32_t>(q & ~8),
                 static_cast<uint32_t>(bh), 0u),
      s0, s1);
}

__device__ __forceinline__ uint4 keep_words(const Keep& kp, int bh, int q,
                                            int k) {
  return group_words(static_cast<uint32_t>(kp.seed[0]),
                     static_cast<uint32_t>(kp.seed[1]), bh, q, k);
}

// Philox keep bits of one thread's part of a warp's 16 x (8 NT) score
// slice (the layout of keep_bits below), from the seed words (s0, s1):
// NT / 2 pairs of calls.
template <bool TRANS, int NT>
__device__ __forceinline__ uint32_t philox_bits(uint32_t s0, uint32_t s1,
                                                uint32_t thresh, int bh,
                                                int r, int c0, int t4) {
  static_assert(NT % 2 == 0 && NT <= 8, "tile pairs, 32 bits");
  uint32_t bits = 0;
#pragma unroll
  for (int jp = 0; jp < NT / 2; ++jp) {
#pragma unroll
    for (int dc = 0; dc < 2; ++dc) {
      const int c = c0 + 16 * jp + 2 * t4 + dc;
      const uint4 w = TRANS ? group_words(s0, s1, bh, c, r)
                            : group_words(s0, s1, bh, r, c);
      // element (row r + 8 a, column c + 8 b) is word 2a + b, or 2b + a
      // with TRANS; it sits in tile 2 jp + b as e = 2a + dc
      const uint32_t w01 = TRANS ? w.z : w.y;  // a = 0, b = 1
      const uint32_t w10 = TRANS ? w.y : w.z;  // a = 1, b = 0
      const int j0 = 4 * (2 * jp) + dc, j1 = j0 + 4;
      bits |= static_cast<uint32_t>(w.x >= thresh) << j0;
      bits |= static_cast<uint32_t>(w10 >= thresh) << (j0 + 2);
      bits |= static_cast<uint32_t>(w01 >= thresh) << j1;
      bits |= static_cast<uint32_t>(w.w >= thresh) << (j1 + 2);
    }
  }
  // groups past the edge draw words too; p is 0 there, so they are inert
  return bits;
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
    bits = philox_bits<TRANS, NT>(static_cast<uint32_t>(kp.seed[0]),
                                  static_cast<uint32_t>(kp.seed[1]),
                                  kp.thresh, bh, r, c0, t4);
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

// The mask form's ring in a wgmma kernel's dynamic shared memory: STAGES
// 64 x 64 int8 tiles (copy_mask_tile), one a stage of the streamed
// operands, after the kernel's struct S, 128-byte aligned.  smem_bytes is
// what the launch asks for, 1024 bytes of it for aligning S.
constexpr int kMaskTile = 64 * 64;

template <typename S>
__host__ __device__ constexpr int mask_off() {
  return (static_cast<int>(sizeof(S)) + 127) / 128 * 128;
}

template <typename S, int STAGES>
__host__ __device__ constexpr int smem_bytes(Drop drop) {
  return drop == Drop::kMask ? mask_off<S>() + STAGES * kMaskTile + 1024
                             : static_cast<int>(sizeof(S)) + 1024;
}

// The mask tile mask[q0 .. q0 + 63][k0 .. k0 + 63] of a head's slice mh
// (rows of n bytes) -> 4 KB of shared memory at dst (128-byte aligned), in
// the 64-byte-swizzled layout of hopper::sw64_offset: the 16-byte chunk of
// column c in row r sits at chunk (c / 16) ^ ((r / 2) % 4), so the reads
// of keep_bits_smem fall on distinct banks in either orientation.  Entries
// at or beyond n read 0.  Every thread of the warpgroup copies its share
// and arrives once on bar (whose phase then expects 1 + 128 arrivals): at
// vec 16, 8 or 4 (Keep::mask_vec) by cp.async, whose arrival comes when
// the copies have landed, so the copy runs under the block's work as the
// TMA loads of the stage do; at vec 1 (rows off 4 bytes: N = 2049, 97) by
// byte loads and shared stores from the thread, then an arrival (release).
__device__ __forceinline__ void copy_mask_tile(int8_t* dst, const int8_t* mh,
                                               int q0, int k0, int n, int vec,
                                               uint64_t* bar) {
  namespace hw = hopper;
  const int tid = threadIdx.x;
  if (vec >= 4) {
    const int per_row = 64 / vec;
    for (int i = tid; i < 64 * per_row; i += 128) {
      const int row = i / per_row;
      const int col = (i % per_row) * vec;
      const int q = q0 + row, k = k0 + col;
      // n % vec == 0: a chunk lies wholly inside or wholly past the edge
      const bool ok = q < n && k < n;
      const int8_t* src = ok ? mh + static_cast<size_t>(q) * n + k : mh;
      const uint32_t to = hw::smem_u32(dst + hw::sw64_offset(row, col));
      const int bytes = ok ? vec : 0;  // 0: the chunk is filled with zeros
      if (vec == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         to),
                     "l"(src), "r"(bytes)
                     : "memory");
      } else if (vec == 8) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                         to),
                     "l"(src), "r"(bytes)
                     : "memory");
      } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                         to),
                     "l"(src), "r"(bytes)
                     : "memory");
      }
    }
    asm volatile(
        "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
            hw::smem_u32(bar))
        : "memory");
    return;
  }
  // 32 bytes a thread: half a row, packed four at a time
  const int row = tid >> 1, col0 = (tid & 1) * 32;
  const int q = q0 + row;
  const int8_t* src = mh + static_cast<size_t>(q < n ? q : 0) * n;
#pragma unroll
  for (int c4 = 0; c4 < 8; ++c4) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int k = k0 + col0 + 4 * c4 + b;
      const uint32_t byte =
          q < n && k < n ? static_cast<uint8_t>(src[k]) : 0u;
      word |= byte << (8 * b);
    }
    *reinterpret_cast<uint32_t*>(dst + hw::sw64_offset(row, col0 + 4 * c4)) =
        word;
  }
  hw::mbar_arrive(bar);
}

// keep_bits' mask form read from a tile of copy_mask_tile: the same 32 bits
// (bit 4 j + e of element e of column tile j), r the tile-local row of the
// warp's 16-row group (bit 3 clear) and columns 8 j + 2 t4 + {0, 1}.  The
// tile's rows are queries and its columns keys; rows are queries here, or
// with TRANS (the dk/dv kernel) keys, whose bytes are read across the
// tile's rows.
template <bool TRANS>
__device__ __forceinline__ uint32_t keep_bits_smem(const int8_t* tile, int r,
                                                   int t4) {
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if constexpr (TRANS) {
        // element (key r + 8 a, query 8 j + 2 t4 + b) is e = 2 a + b
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int8_t x =
              tile[hopper::sw64_offset(8 * j + 2 * t4 + b, r + 8 * a)];
          bits |= static_cast<uint32_t>(x != 0) << (4 * j + 2 * a + b);
        }
      } else {
        // (query r + 8 a, keys 8 j + 2 t4 and + 1): one 2-byte load
        const uint16_t x = *reinterpret_cast<const uint16_t*>(
            tile + hopper::sw64_offset(r + 8 * a, 8 * j + 2 * t4));
        bits |= static_cast<uint32_t>((x & 0xFFu) != 0) << (4 * j + 2 * a);
        bits |= static_cast<uint32_t>((x >> 8) != 0) << (4 * j + 2 * a + 1);
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
