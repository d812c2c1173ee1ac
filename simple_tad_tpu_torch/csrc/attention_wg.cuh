// The register-side steps of the wgmma attention forwards, shared by the
// bf16 kernel of attention.cu (A1, B3, C1, C3-fwd, C4-fwd) and the
// int8-storage kernel of attention_i8.cu (B2, D2): the online softmax of
// one 64-key tile on a warpgroup's S accumulators, the rescale of O and l
// with p packed into the bf16 A fragments of PV, and the int8 store of the
// normalised rows.  And the column scheme of the bf16 wgmma kernels at head
// dims 64 to 128, shared by the forward (attention.cu) and the backward
// (attention_train.cu): the tile width of a head dim, a tile's column
// atoms and their descriptors, and where a head's columns sit in its tiles.
//
// A thread of the warpgroup holds, of an m64nN accumulator (fp32 or s32;
// S is n64, O n64 to n128 in the bf16 kernel), rows g and g + 8 of its
// warp's 16 (g = lane / 4) and columns j8 * 8 + 2 t4 + {0, 1} (t4 =
// lane % 4) of each 8-column group j8: the m16n8 fragment repeated,
// element j8 * 4 + {0, 1} on row g, + {2, 3} on row g + 8; N / 2 values.
#pragma once

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace stt {
namespace attn_wg {

constexpr int kTile = 64;  // queries a block, keys a tile

namespace hw = hopper;

// The tile width DP of head dim d: 64 at 64, 96 at 72 to 96, 128 at 104
// to 128; a head dim d = 8 (mod 16) needs d + 8 columns on its odd heads
// (head_cols).  Tiles of 80 or 112 columns (32-byte-swizzled atoms) are
// not instantiated: they ran slower than 96 or 128 in the forward on the
// H100 in trials whose times were not recorded (an open question of
// PERF.md).  Their cost: products over the tile's columns span DP / d of
// the head (1.2 at d = 80).
__host__ __device__ constexpr int tile_width(int d) {
  return d <= 64 ? 64 : d <= 96 ? 96 : 128;
}

// A (64-row, DP-column) bf16 tile: DP / kAtom column atoms of kAtom = 64
// or 32 columns, the widest that divides DP, each one TMA box swizzled by
// its row of 128 or 64 bytes (layout type 1 or 2 of a wgmma descriptor),
// back to back.  At DP = 64 that is the one 128-byte-swizzled 8 KB tile.
template <int DP>
struct Tile {
  static_assert(DP == 64 || DP == 96 || DP == 128, "a tile_width");
  static constexpr int kAtom = DP % 64 == 0 ? 64 : 32;
  static constexpr int kRowBytes = 2 * kAtom;
  static constexpr int kAtomBytes = kTile * kRowBytes;
  static constexpr int kBytes = kTile * DP * 2;
  static constexpr uint32_t kLayout = kAtom == 64 ? 1 : 2;
  // a K-major operand (rows along M or N, the contraction along the row):
  // 8-row atoms kRowBytes * 8 apart; k16 step kk starts 32 bytes into its
  // column atom per step within it
  __host__ __device__ static constexpr int kk_offset(int kk) {
    return ((kk * 16 / kAtom) * kAtomBytes + (kk * 16 % kAtom) * 2) >> 4;
  }
  __device__ static uint64_t kmajor(const __nv_bfloat16* t) {
    return hw::desc_sw(t, 16, 8 * kRowBytes, kLayout);
  }
  // an MN-major operand (rows along the contraction, the tile's columns
  // along N): k16 step +16 rows, the next column atom LBO = kAtomBytes on
  // (unused with one atom: set as desc_mnmajor's)
  static constexpr int kMnStep = (16 * kRowBytes) >> 4;
  __device__ static uint64_t mnmajor(const __nv_bfloat16* t) {
    return hw::desc_sw(t, DP == kAtom ? 8 * kRowBytes : kAtomBytes,
                       8 * kRowBytes, kLayout);
  }
  // thread 0's TMA loads of the tile at (col0, row, batch) of `map` (its
  // box kAtom columns wide), one box an atom, completing on `bar`
  __device__ static void load(__nv_bfloat16* dst, const CUtensorMap* map,
                              uint64_t* bar, int col0, int row, int b) {
#pragma unroll
    for (int c = 0; c < DP; c += kAtom) {
      hw::tma_load_3d(dst + c * kTile, map, bar, col0 + c, row, b);
    }
  }
};

// Where head `head` sits in its tiles at tile width DP: the head dim d (64
// whenever the tile is: tile_width), the tiles' first column col0 in the
// operand, the head's first column rounded down to a multiple of 16 (a TMA
// row that starts off a 32-byte sector ran much slower on the H100,
// untimed), and the head's columns [shift, shift + d) of the tiles.  At
// d = 8 (mod 16) an odd head's tiles start with the previous head's last
// 8 columns, and any tile may end in the next head's first columns (or
// beyond the last head, where TMA reads zero).
struct HeadCols {
  int d, col0, shift;
};

template <int DP>
__device__ __forceinline__ HeadCols head_cols(int head, int d) {
  const int dh = DP == 64 ? 64 : d;
  const int shift = head * dh % 16;
  return {dh, head * dh - shift, shift};
}

// The online softmax of one 64-key tile on this thread's S accumulators
// (rows g and g + 8 of its warp's 16 queries, keys j8 * 8 + 2 t4 + {0, 1}):
// keys at or beyond n_kv masked by index, the running maxima m rounded up
// to an integer, a the rescale factors of O and l (exact powers of two, 0
// on the first tile), and p = exp2(s - m) left in s.  ex2.approx.ftz gives
// exp2f's value wherever p is a normal float; a p below 2^-126 reads 0
// where exp2f gives a subnormal, at most 2^-125 of the row's largest p
// (which is at least 1/2 once m is final).
__device__ __forceinline__ void tile_softmax(float (&s)[32], int k0, int n_kv,
                                             int t4, float (&m)[2],
                                             float (&a)[2]) {
  if (k0 + kTile > n_kv) {
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) {
      const int key = k0 + j8 * 8 + t4 * 2;
      if (key >= n_kv) s[j8 * 4] = s[j8 * 4 + 2] = -INFINITY;
      if (key + 1 >= n_kv) s[j8 * 4 + 1] = s[j8 * 4 + 3] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j8 = 0; j8 < 8; ++j8) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j8 * 4], s[j8 * 4 + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j8 * 4 + 2], s[j8 * 4 + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
    }
    float mn = fmaxf(m[r], ceilf(mx[r]));
    if (mn == -INFINITY) mn = 0.f;  // only if every key so far is masked
    a[r] = exp2f(m[r] - mn);
    m[r] = mn;
  }
#pragma unroll
  for (int j8 = 0; j8 < 8; ++j8) {
    s[j8 * 4] = hopper::exp2_approx(s[j8 * 4] - m[0]);
    s[j8 * 4 + 1] = hopper::exp2_approx(s[j8 * 4 + 1] - m[0]);
    s[j8 * 4 + 2] = hopper::exp2_approx(s[j8 * 4 + 2] - m[1]);
    s[j8 * 4 + 3] = hopper::exp2_approx(s[j8 * 4 + 3] - m[1]);
  }
}

// O (NO accumulators a thread: 32 to 64) and l rescaled by a, then p
// rounded to bf16 into the A fragments of PV (accumulator key columns
// 16 kk to 16 kk + 15 are k-step kk, as for the mma.sync kernel's pf) and
// the rounded values added to l.  With dropout (DROP) l sums the unrounded p
// before dropout and the A fragments are bf16(p * keep / keep_prob), as
// attn_fwd_bf16_kernel's DROP branch.
template <Drop DROP = Drop::kNone, int NO>
__device__ __forceinline__ void rescale_and_pack(float (&o)[NO],
                                                 const float (&p)[32],
                                                 const float (&a)[2],
                                                 float (&l)[2],
                                                 uint32_t (&pf)[4][4],
                                                 uint32_t keep = 0,
                                                 float inv_keep = 0.f) {
  l[0] *= a[0];
  l[1] *= a[1];
#pragma unroll
  for (int i = 0; i < NO; i += 4) {
    o[i] *= a[0];
    o[i + 1] *= a[0];
    o[i + 2] *= a[1];
    o[i + 3] *= a[1];
  }
#pragma unroll
  for (int j8 = 0; j8 < 8; ++j8) {
    const int i = j8 * 4;
    if constexpr (DROP == Drop::kNone) {
      const __nv_bfloat162 p0 = __floats2bfloat162_rn(p[i], p[i + 1]);
      const __nv_bfloat162 p1 = __floats2bfloat162_rn(p[i + 2], p[i + 3]);
      l[0] += __low2float(p0) + __high2float(p0);
      l[1] += __low2float(p1) + __high2float(p1);
      pf[j8 / 2][(j8 % 2) * 2] = as_u32(p0);
      pf[j8 / 2][(j8 % 2) * 2 + 1] = as_u32(p1);
    } else {
      l[0] += p[i] + p[i + 1];  // before dropout, unrounded
      l[1] += p[i + 2] + p[i + 3];
      pf[j8 / 2][(j8 % 2) * 2] = as_u32(__floats2bfloat162_rn(
          p[i] * keep_factor(keep, j8, 0, inv_keep),
          p[i + 1] * keep_factor(keep, j8, 1, inv_keep)));
      pf[j8 / 2][(j8 % 2) * 2 + 1] = as_u32(__floats2bfloat162_rn(
          p[i + 2] * keep_factor(keep, j8, 2, inv_keep),
          p[i + 3] * keep_factor(keep, j8, 3, inv_keep)));
    }
  }
}

// The normalised rows row0 and row1 (= row0 + 8) of O (2 NO columns) as
// int8 codes against out_amax (quant_i8: round half to even, clipped to
// +-127), two codes a store, at ob + row * o_sn; rows at or beyond n are
// not stored, and of the columns only [shift, shift + d) (the head's, in
// a tile that is wider than the head), as columns 0 to d - 1.
template <int NO>
__device__ __forceinline__ void store_rows_q8(int8_t* ob,
                                              const float (&acc)[NO],
                                              const float (&l)[2],
                                              const float* out_amax, int row0,
                                              int n, int o_sn, int t4,
                                              int d = 2 * NO, int shift = 0) {
  const float oinv = quant_inv(out_amax);
  const int row1 = row0 + 8;
  const size_t at0 = static_cast<size_t>(row0) * o_sn;
  const size_t at1 = static_cast<size_t>(row1) * o_sn;
#pragma unroll
  for (int j8 = 0; j8 < NO / 4; ++j8) {
    const int c = j8 * 8 + t4 * 2 - shift;
    const int i = j8 * 4;
    if (c < 0 || c >= d) continue;
    if (row0 < n) {
      *reinterpret_cast<char2*>(ob + at0 + c) =
          make_char2(quant_i8(__fdiv_rn(acc[i], l[0]), oinv),
                     quant_i8(__fdiv_rn(acc[i + 1], l[0]), oinv));
    }
    if (row1 < n) {
      *reinterpret_cast<char2*>(ob + at1 + c) =
          make_char2(quant_i8(__fdiv_rn(acc[i + 2], l[1]), oinv),
                     quant_i8(__fdiv_rn(acc[i + 3], l[1]), oinv));
    }
  }
}

}  // namespace attn_wg
}  // namespace stt
