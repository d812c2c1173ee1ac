// Hopper (sm_90a) building blocks of the port's wgmma kernels: mbarriers,
// TMA tile loads, wgmma products and their shared-memory descriptors, and
// the host-side encoding of TMA tensor maps.  The bf16 attention forward
// (attention.cu) takes the m64n64k16 bf16 product of S and the m64nDPk16
// one of PV (DP = 64, 96 or 128) on tiles of 128- or 64-byte-swizzled
// column atoms (desc_sw, tile_map_bf16's box widths, scale_tile_window,
// scale_tile at 64); the training-attention backward (attention_train.cu)
// the same products on the same tiles (S^T, dP^T and their dq-kernel
// counterparts m64n64k16, dV, dK and dQ m64nDPk16), scale_tile_window and
// zero_tile_window;
// the static int8 GEMMs (int8_gemm.cu) the m64n128k32 s8 products on 128-
// or 64-byte-swizzled tiles; the int8 attentions (attention_i8.cu,
// attention_int8.cu) the m64n64k32 s8 products (E2's on 64-byte-swizzled
// tiles, with its PV codes in registers; B2's on 64- or 128-byte-swizzled
// tiles, zero_i8_window, and its PV the bf16 one).  The
// other kernels keep common.cuh's mma.sync helpers.
//
// The tensor-map encoder is the driver's cuTensorMapEncodeTiled, reached
// through the runtime's driver entry point, so the library links no -lcuda
// (cuda.h is read for its types only).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stt {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// p rounded up to the next 1024-byte boundary of shared memory (a
// 128-byte-swizzled TMA tile, and wgmma's view of it, repeat every 1024
// bytes; the kernel allocates 1024 bytes of slack)
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// the bytes of dynamic shared memory this block's launch asked for
__device__ __forceinline__ uint32_t dynamic_smem_size() {
  uint32_t bytes;
  asm("mov.u32 %0, %%dynamic_smem_size;\n" : "=r"(bytes));
  return bytes;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the barrier's phase of this parity has completed (the spin
// stays inside one asm block, so the warp reaches the next .aligned
// instruction converged)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// 2^x on the special-function unit (ex2.approx.ftz): exp2f's value where
// the result is a normal float; a result below 2^-126 is 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// TMA load of one tile, completing on `bar` (coordinates innermost first)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// one arrival (no transactions) on `bar`
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// barrier `id` (1-15; 0 is __syncthreads) among `threads` threads
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// TMA load of one rank-2 tile, completing on `bar` (coordinates innermost
// first)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// shared-memory writes of this thread -> visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most `Pending` committed groups of this warpgroup's
// products are still running (groups complete in commit order)
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending)
               : "memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// bf16(x * qscale) of a 64 x 64 bf16 tile written by a 128-byte-swizzle TMA
// load, by the 128 threads of one warpgroup, position for position (the
// swizzle moves 16-byte chunks only, so the copy keeps the layout); visible
// to wgmma once every thread has passed the block's next barrier
__device__ __forceinline__ void scale_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           float qscale) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < 64 * 64 / 8 / 128; ++i) {
    const int c = i * 128 + threadIdx.x;
    uint4 val = s[c];
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      e[t] = __float2bfloat16_rn(__bfloat162float(e[t]) * qscale);
    }
    d[c] = val;
  }
  fence_proxy_async();
}

// The byte column of 16-byte chunk c of a (64-row, COLS) tile of ROW-byte
// column atoms (ROW = 128 or 64: a TMA load swizzled by the same span,
// each atom 64 rows, back to back): its position in the row with the
// swizzle undone, the chunk index within the row XOR the byte offset's
// bits 7 and up, i.e. row % 8 or (row / 2) % 4.
template <int ROW>
__device__ __forceinline__ int tile_chunk_byte(int c) {
  static_assert(ROW == 128 || ROW == 64, "a 128- or 64-byte swizzle");
  constexpr int kChunksRow = ROW / 16;
  constexpr int kRowShift = ROW == 128 ? 0 : 1;
  const int atom = c / (64 * kChunksRow);
  const int row = c / kChunksRow % 64;
  const int chunk = (c % kChunksRow) ^ ((row >> kRowShift) % kChunksRow);
  return atom * ROW + chunk * 16;
}

// ... and the bf16 column of such a tile of ATOM-value atoms (ATOM = 64 or
// 32 values: 128- or 64-byte swizzle)
template <int ATOM>
__device__ __forceinline__ int tile_chunk_col(int c) {
  static_assert(ATOM == 64 || ATOM == 32, "a 128- or 64-byte swizzle");
  return tile_chunk_byte<2 * ATOM>(c) / 2;
}

// scale_tile over a (64-row, COLS) tile of COLS / ATOM column atoms
// (tile_chunk_col), from src to dst (the same tile, or another of its
// layout), keeping the columns [lo, hi) and writing zero to the others; lo
// and hi are multiples of 8, so a 16-byte chunk is kept or zeroed whole
template <int COLS, int ATOM>
__device__ __forceinline__ void scale_tile_window(__nv_bfloat16* dst,
                                                  const __nv_bfloat16* src,
                                                  float qscale, int lo,
                                                  int hi) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < 64 * COLS / 8 / 128; ++i) {
    const int c = i * 128 + threadIdx.x;
    const int col = tile_chunk_col<ATOM>(c);
    uint4 val = s[c];
    if (col < lo || col >= hi) {
      val = make_uint4(0u, 0u, 0u, 0u);
    } else {
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        e[t] = __float2bfloat16_rn(__bfloat162float(e[t]) * qscale);
      }
    }
    d[c] = val;
  }
  fence_proxy_async();
}

// zero, in place, the columns of such a tile outside [lo, hi) (multiples
// of 8): stores only, to the chunks outside the window
template <int COLS, int ATOM>
__device__ __forceinline__ void zero_tile_window(__nv_bfloat16* tile, int lo,
                                                 int hi) {
  uint4* d = reinterpret_cast<uint4*>(tile);
#pragma unroll
  for (int i = 0; i < 64 * COLS / 8 / 128; ++i) {
    const int c = i * 128 + threadIdx.x;
    const int col = tile_chunk_col<ATOM>(c);
    if (col < lo || col >= hi) d[c] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
}

// zero, in place, the codes of a (64-row, COLS) int8 tile swizzled by its
// row of COLS bytes (tile_chunk_byte) outside the columns [lo, hi)
// (multiples of 8), by the 128 threads of one warpgroup: 8-byte stores to
// the halves of 16-byte chunks outside the window; visible to wgmma once
// every thread has passed the block's next barrier
template <int COLS>
__device__ __forceinline__ void zero_i8_window(int8_t* tile, int lo, int hi) {
  uint2* d = reinterpret_cast<uint2*>(tile);
#pragma unroll
  for (int i = 0; i < 64 * COLS / 16 / 128; ++i) {
    const int c = i * 128 + threadIdx.x;
    const int col = tile_chunk_byte<COLS>(c);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int at = col + 8 * half;
      if (at < lo || at >= hi) d[2 * c + half] = make_uint2(0u, 0u);
    }
  }
  fence_proxy_async();
}

// pin accumulator registers in place around asynchronous products, so the
// compiler neither reads nor moves them while a wgmma may write them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ... and an A operand's bf16 fragments in registers, which an in-flight
// wgmma still reads
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

// Descriptor of a bf16 tile in shared memory written by a 128-byte-swizzle
// TMA load: rows of 64 values (128 bytes), 8-row swizzle atoms of 1024
// bytes, base 1024-byte aligned.  As a K-major operand (rows along M or N,
// the contraction along the row) a k16 step is +32 bytes and the 8-row
// groups are 1024 bytes apart (SBO); as an MN-major operand (rows along
// the contraction) a k16 step is +2048 bytes, the two 8-row groups of the
// step again 1024 bytes apart, and the 64-value row is the one MN atom
// (LBO would step to the next; set to the same 1024 bytes, unused at 64).
// The descriptor of any such operand: start address, LBO and SBO (bytes),
// and the layout type (1 128-byte swizzle, 2 64-byte).  A 64-byte-swizzled
// tile has rows of 64 bytes and 8-row atoms of 512 bytes; as a K-major
// operand its SBO is that atom, as an MN-major one (its rows along the
// contraction) SBO is the atom too and LBO the distance from one column
// atom (32 values along MN) to the next; at either swizzle.
__device__ __forceinline__ uint64_t desc_sw(const void* p, uint32_t lbo,
                                            uint32_t sbo, uint32_t layout) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFFull) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return desc_sw(p, lbo, sbo, 1);
}

// (a K-major tile of int8 codes, 128 a row, has the same layout; its k32
// step is the same +32 bytes)
__device__ __forceinline__ uint64_t desc_kmajor(const void* p) {
  return desc_sw128(p, 16, 1024);
}

__device__ __forceinline__ uint64_t desc_mnmajor(const void* p) {
  return desc_sw128(p, 1024, 1024);
}

// Descriptor of an 8-bit K-major tile written by a 64-byte-swizzle TMA load
// (or laid out as one): rows of 64 codes (64 bytes), 8-row swizzle atoms of
// 512 bytes (SBO), base 512-byte aligned.  A k32 step is +32 bytes, +2 in
// the descriptor's address field.
__device__ __forceinline__ uint64_t desc_kmajor_sw64(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFFull) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// byte offset of code (row, col) in such a tile: the 16-byte chunk index
// (col / 16, 2 bits) XOR address bits 7-8, i.e. (row / 2) % 4
__device__ __forceinline__ int sw64_offset(int row, int col) {
  return row * 64 + ((((col >> 4) ^ (row >> 1)) & 3) << 4) + (col & 15);
}

#define STT_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define STT_D32_OPS(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// D (64x64 fp32, this warpgroup) (+)= A (64x16) B (16x64), A and B K-major
// in shared memory; `accumulate` 0 overwrites D
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " STT_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : STT_D32_OPS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64x64 fp32) (+)= A (64x16, bf16 fragments in registers: the m16n8k16
// A layout, warp w holding rows 16w..16w+15) B (16x64), B MN-major in
// shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " STT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : STT_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

#undef STT_D32
#undef STT_D32_OPS

// The same at n = 96 and 128 (the wgmma attention forward's PV at tile
// width DP: DP / 2 accumulators a thread, element j8 * 4 +
// {0, 1, 2, 3} of 8-column group j8 as at n = 64); B spans DP / A column
// atoms of A values, LBO apart
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[48],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_mn(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}


#define STT_R64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63}"

#define STT_R64_OPS(d) \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), \
  "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
  "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), \
  "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
  "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), \
  "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
  "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), \
  "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), \
  "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), \
  "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
  "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), \
  "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
  "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), \
  "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), \
  "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), \
  "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])

// D (64x128 s32, this warpgroup) += A (64x32 s8) B (32x128 s8), both K-major
// in shared memory (desc_kmajor_sw64); the int32 sum is exact.  Integer
// wgmma takes no scale or transpose immediates: 8-bit operands are K-major
// only, as x (M, K) and the (N, K) weight codes already are.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " STT_R64
      ", %64, %65, p;\n"
      "}\n"
      : STT_R64_OPS(d)
      : "l"(a), "l"(b), "r"(1));
}

// pin an s32 accumulator in place around asynchronous products
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#undef STT_R64
#undef STT_R64_OPS

#define STT_R32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define STT_R32_OPS(d)                                                       \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),   \
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),          \
      "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),      \
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),      \
      "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),      \
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),      \
      "+r"(d[31])

// D (64x64 s32, this warpgroup) (+)= A (64x32 s8) B (32x64 s8), both
// K-major in shared memory (desc_kmajor_sw64); `accumulate` 0 overwrites
// D.  The int32 sum is exact.
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " STT_R32
      ", %32, %33, p;\n"
      "}\n"
      : STT_R32_OPS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64x64 s32) (+)= A (64x32 s8, four 32-bit registers of codes a thread:
// the m16n8k32 A layout, warp w holding rows 16w..16w+15) B (32x64 s8),
// B K-major in shared memory
__device__ __forceinline__ void wgmma_s8_rs_n64(int (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " STT_R32
      ", {%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : STT_R32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

__device__ __forceinline__ void fence_regs(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

#undef STT_R32
#undef STT_R32_OPS

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, or nullptr if the driver lacks it
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// 64-row tiles of `box_cols` columns (64 by default, or 32: 128- or
// 64-byte rows, swizzled by the same span) of a bf16 operand addressed as
// (batch, row, column): `cols` contiguous columns (a head's are chosen by
// the column coordinate), `rows` rows `row_stride` apart and `batches`
// batches `batch_stride` apart (elements).  Columns, rows and batches
// beyond the extents read as zero.
inline bool tile_map_bf16(CUtensorMap* map, const void* base, int cols,
                          int rows, int batches, long long row_stride,
                          long long batch_stride, int box_cols = 64) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batches)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_stride) * 2,
                                 static_cast<cuuint64_t>(batch_stride) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 64-row tiles of `box_cols` codes (64 by default, or 128) of an int8
// operand addressed as (batch, row, column), as tile_map_bf16 but with
// strides in bytes, with the given swizzle (of the box's row span: the
// wgmma K-major layouts of desc_sw; 64-byte at 64 codes is
// desc_kmajor_sw64's).  Columns, rows and batches beyond the extents read
// as zero.
inline bool tile_map_i8(CUtensorMap* map, const void* base, int cols,
                        int rows, int batches, long long row_bytes,
                        long long batch_bytes, CUtensorMapSwizzle swizzle,
                        int box_cols = 64) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batches)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_bytes),
                                 static_cast<cuuint64_t>(batch_bytes)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tiles of `box_cols` x `box_rows` of a rank-2 row-major operand of
// `cols` contiguous elements by `rows` rows, `row_bytes` apart: int8 codes
// (CU_TENSOR_MAP_DATA_TYPE_UINT8: the bytes as they are), bf16 or fp32.
// Rows and columns beyond the extents read as zero.
inline bool tile_map_2d(CUtensorMap* map, const void* base,
                        CUtensorMapDataType dtype, int cols, int rows,
                        long long row_bytes, int box_cols, int box_rows,
                        CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, dtype, 2, const_cast<void*>(base), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
}  // namespace stt
