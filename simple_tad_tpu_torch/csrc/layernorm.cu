// Row LayerNorm over the last axis (kernel A2), the same LayerNorm with a
// static int8 output (kernel B1), B1 after a residual add (kernel E1), and
// RMSNorm with a static int8 output (kernel D3).
//
// A2 replaces the TPU kernel simple_tad_tpu/ops/ln.py:_ln_kernel (launched
// by fused_layernorm -> _fused_ln_impl).  B1 replaces
// simple_tad_tpu/ops/ln.py:_ln_quant_kernel (launched by
// fused_layernorm_quant): the int8 serving path's norm1/norm2, which hand
// the next GEMM its int8 activation directly.  Same numerics as there:
// fp32 mean, fp32 biased variance of the centred values (mean(xc * xc),
// not E[x^2] - m^2), rsqrt(var + eps), fp32 affine ((xc * r) * w + b, each
// product rounded, no fused multiply-add), then one cast to the output
// dtype, or for B1 clip(round_half_even(y * 127 / amax), +-127) as int8
// with amax the calibrated absmax read from device memory.
//
// E1 replaces simple_tad_tpu/ops/ln.py:_add_ln_quant_kernel (launched by
// fused_add_layernorm_quant): the static int8 ViT's deferred-residual carry
// (add_lnq), where each residual add runs inside the next norm's read.  It is
// B1 with a prologue: the branch and the residual are added in fp32, the sum
// is rounded to the input dtype and stored (the first output), and the
// statistics are taken on that stored value, as the unfused chain (add, then
// B1) takes them.  B1's kernel is instantiated with ADD = true, so the
// reductions run in B1's order and the codes equal B1's of the stored sum
// bit for bit.
//
// D3 replaces simple_tad_tpu/ops/ln.py:_rms_quant_kernel (launched by
// fused_rmsnorm_quant): InternVideo2's static int8 serving with the fused
// RMSNorm->int8 option, where norm1/norm2 hand the next GEMM its int8 input
// and the q/k-norms hand the int8-storage attention its per-head codes.
// Numerics as there: fp32 mean(x * x) (no mean subtraction, no bias),
// rsqrt(var + eps), (x * r) * w with each product rounded, then
// clip(round_half_even(y * inv_c[c]), +-127) with inv_c a per-channel
// 127 / amax vector (one value repeated for a GEMM input, a per-head repeat
// for q and k).
//
// What bounds all four on the H100: bytes.  A row of C values is read once
// and written once against a handful of fp32 operations per element, far
// below the ~295 operations a byte at which the tensor cores would be the
// limit: B1 at ViT-B batch 32 bf16 moves 3 bytes an element (116 MB, >= 35
// us at 3.35 TB/s), A2 4 (154 MB, >= 46 us), E1 7 (270 MB, >= 81 us), D3 at
// IV2-S batch 32 3 (75.5 MB, >= 23 us).  Reaching the memory rate takes
// about 25 KB in flight on each SM at all times (3.35 TB/s x ~1 us / 132
// SMs), so the design is about keeping loads in flight:
//
// - One warp a row, on a persistent grid.  The grid holds as many blocks of
//   kWarps warps as the SMs run at once (the occupancy API, the SM count
//   read once); block b of G takes the row groups b, b + G, ..., warp w row
//   w of each.  A row's sums are warp shuffles: no __syncthreads and no
//   shared-memory reduction a row, no short block launched per row.
// - A row in flight beside the one being reduced.  Lane l owns the
//   8-column chunks l, l + 32, l + 64, ... (CPL a lane, a template
//   argument).  Up to C = 1024 (CPL <= 4: ViT-S/B/L, IV2-S/B/L) a lane
//   holds its chunks of the row in registers and issues the 16-byte loads
//   of the warp's next row before it reduces and stores the current one;
//   the loads are evict-first (ld.global.cs: each row is read once).  At
//   9 (D3), 7 (A2, B1) and 6 (E1) blocks an SM that is 40-70 KB an SM in
//   flight.  Staged on the card, two to four rows ahead read slower, the
//   more the slower (their registers cost warps), and so did parameters
//   held in registers (B1 at 124-140 registers, 3 blocks an SM).  Wider
//   rows (up to 4096) are read again at each pass, from the L1 and L2.
// - Parameters once a block.  w and b (or w and inv_c) are staged in
//   shared memory as the first row's loads are in flight; 127 / amax is
//   read once a thread.
// - Registers by launch bounds.  row_blocks sets the blocks an SM of each
//   instantiation from what it holds, so that ptxas neither spills nor
//   trades a few bytes of spill for a step of occupancy (left to itself it
//   did both).
// - Stores: B1, E1's and D3's codes 8 bytes a lane, A2's output 16 bytes a
//   chunk (bf16) and E1's sum likewise, neighbouring lanes on neighbouring
//   addresses.
//
// Bit for bit what the one-block-a-row kernels before this design gave.
// Lane l's chunk l + 32 j is what thread 32 j + l of that block held, so
// each chunk is summed in the same order from 0.f; RowSum then runs the
// reduction tree of the block kernel's block_sum: each group of 32 chunks
// (one of its warps) by the xor butterfly 16...1, then the group sums, lane
// i taking group i's (0.f past the last group), by the butterfly again.
// The division by C, rsqrtf, affine and the int8 code follow unchanged.
//
// Widths that are not a multiple of 8, and operands not 16-byte aligned,
// take the fallback kernels, which stage a row in shared memory as fp32
// (C <= 4096, at most 16 KB): one block a row, block_sum's reductions.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxCols = 4096;
// the row kernels' warps a block
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// Sum of v over the block; every thread gets the result.  blockDim.x must
// be a multiple of 32.  red holds 33 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nwarps ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// (xc * r) * w + b with every step rounded, as the plain version computes it
__device__ __forceinline__ float affine(float xc, float r, float w, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(xc, r), w), b);
}

// Output stores; qinv (127 / amax) is read only by the int8 ones.
__device__ __forceinline__ void store1(float* p, float v, float) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v, float) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store1(int8_t* p, float v, float qinv) {
  *p = stt::quant_i8(v, qinv);
}

// The value the statistics are taken on: x, or with ADD (kernel E1) the sum
// x + r rounded to TIn, which is also stored to s
template <typename TIn, bool ADD>
__device__ __forceinline__ float load1(const TIn* x, const TIn* r, TIn* s,
                                       size_t i) {
  const float v = stt::to_float(x[i]);
  if (!ADD) return v;
  const TIn sum = stt::from_float<TIn>(__fadd_rn(v, stt::to_float(r[i])));
  s[i] = sum;
  return stt::to_float(sum);
}

// Any width up to kMaxCols, any alignment: the row staged in shared memory
template <typename TIn, typename TOut, bool ADD>
__global__ void layernorm_kernel(const TIn* __restrict__ x,
                                 const TIn* __restrict__ r,
                                 TIn* __restrict__ sum,
                                 const float* __restrict__ w,
                                 const float* __restrict__ b,
                                 const float* __restrict__ amax,
                                 TOut* __restrict__ y, int cols, float eps) {
  extern __shared__ float row[];  // cols floats
  __shared__ float red[33];
  const size_t base = static_cast<size_t>(blockIdx.x) * cols;
  TOut* yr = y + base;

  float s = 0.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const float v = load1<TIn, ADD>(x, r, sum, base + c);
    row[c] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / static_cast<float>(cols);

  float ss = 0.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const float d = row[c] - mean;
    ss += d * d;
  }
  const float var = block_sum(ss, red) / static_cast<float>(cols);
  const float inv = rsqrtf(var + eps);
  const float qinv = amax != nullptr ? stt::quant_inv(amax) : 1.f;

  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    store1(yr + c, affine(row[c] - mean, inv, w[c], b[c]), qinv);
  }
}

// 8 values of T as loaded: one 16-byte word of bf16, two of fp32
template <typename T>
struct Raw8 {
  uint4 u[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ void load_raw(const T* p, Raw8<T>& c) {
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(T) / 2); ++k) {
    c.u[k] = reinterpret_cast<const uint4*>(p)[k];
  }
}

// load_raw of a row input, which is read once: evict first (ld.global.cs)
template <typename T>
__device__ __forceinline__ void load_row(const T* p, Raw8<T>& c) {
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(T) / 2); ++k) {
    c.u[k] = __ldcs(reinterpret_cast<const uint4*>(p) + k);
  }
}

__device__ __forceinline__ void unpack(const Raw8<__nv_bfloat16>& c,
                                       float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(c.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const Raw8<float>& c, float (&v)[8]) {
  const float* f = reinterpret_cast<const float*>(c.u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = f[i];
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[8]) {
  Raw8<T> c;
  load_raw(p, c);
  unpack(c, v);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8],
                                       float) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8], float) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(int8_t* p, const float (&v)[8],
                                       float qinv) {
  uint2 raw;
  int8_t* e = reinterpret_cast<int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = stt::quant_i8(v[i], qinv);
  *reinterpret_cast<uint2*>(p) = raw;
}

// The values the statistics are taken on: x's 8, or with ADD (kernel E1)
// those of x + r rounded to TIn
template <typename TIn, bool ADD>
__device__ __forceinline__ void row_values(const Raw8<TIn>& x,
                                           const Raw8<TIn>& r, float (&v)[8]) {
  unpack(x, v);
  if (!ADD) return;
  float rv[8];
  unpack(r, rv);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = stt::to_float(stt::from_float<TIn>(__fadd_rn(v[i], rv[i])));
  }
}

// First column of a lane's chunk j
__device__ __forceinline__ int chunk_col(int lane, int j) {
  return (lane + 32 * j) * 8;
}

// block_sum's tree on one warp: add(j, part) takes group j's partial sum
// (this lane's sum of its chunk j, 0.f past the row's end), reduces it by
// the xor butterfly and keeps it in lane j; total() runs the butterfly over
// the kept sums (0.f in the lanes past the last group).  Every lane gets
// the row sum.
struct RowSum {
  float t = 0.f;
  __device__ __forceinline__ void add(int j, float part) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, o);
    }
    if (static_cast<int>(threadIdx.x & 31) == j) t = part;
  }
  __device__ __forceinline__ float total() {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    return t;
  }
};

// Stage the block's two parameter vectors (cols fp32 values each, 16-byte
// aligned) in shared memory: p0 at sp, p1 at sp + cols
__device__ __forceinline__ void stage_params(float* sp, const float* p0,
                                             const float* p1, int cols) {
  for (int c = threadIdx.x * 4; c < cols; c += kThreads * 4) {
    *reinterpret_cast<float4*>(sp + c) =
        *reinterpret_cast<const float4*>(p0 + c);
    *reinterpret_cast<float4*>(sp + cols + c) =
        *reinterpret_cast<const float4*>(p1 + c);
  }
  __syncthreads();
}

// The loads of one row's chunks of this lane (x, and with ADD the
// residual r)
template <typename TIn, int CPL>
struct RowLoads {
  Raw8<TIn> x[CPL];
  Raw8<TIn> r[CPL];
};

template <typename TIn, bool ADD, int CPL>
__device__ __forceinline__ void fetch(RowLoads<TIn, CPL>& in, const TIn* x,
                                      const TIn* r, int row, int rows,
                                      int cols, int lane) {
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * cols;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = chunk_col(lane, j);
    if (c < cols) {
      load_row(x + base + c, in.x[j]);
      if (ADD) load_row(r + base + c, in.r[j]);
    }
  }
}

// The persistent walk of the row kernels.  Block b of the grid's G takes
// the row groups b, b + G, b + 2G, ... of kWarps rows, warp w of it row w
// of each; the count of steps is the block's, so no branch around the warp
// shuffles depends on the warp (a warp past the last row computes on
// nothing and stores nothing).  start() runs once, after the first loads
// are issued.  row_fn(base, get) runs for each row, base its first element
// and get(j, v, pass) the accessor of this lane's chunk j (the row values;
// false past the row's end or the last row; pass 0, 1, ... numbers the
// reads).  With ADD (kernel E1) the rounded sum is stored to sum as the row
// is first read.  With CPL chunks a lane (CPL <= 4, C <= 1024) the row is
// held in registers and the loads of the warp's next row are in flight
// while row_fn runs; with CPL = 0 (wider rows) it is loaded again at each
// pass.
template <typename TIn, bool ADD, int CPL, typename Start, typename RowFn>
__device__ __forceinline__ void walk_rows(const TIn* __restrict__ x,
                                          const TIn* __restrict__ r,
                                          TIn* __restrict__ sum, int rows,
                                          int cols, Start start,
                                          RowFn row_fn) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = (rows + kWarps - 1) / kWarps;
  const int steps = (groups - static_cast<int>(blockIdx.x) + gridDim.x - 1) /
                    gridDim.x;
  const auto row_at = [&](int k) {
    return (static_cast<int>(blockIdx.x) + k * static_cast<int>(gridDim.x)) *
               kWarps + warp;
  };
  if constexpr (CPL == 0) {
    start();
    for (int k = 0; k < steps; ++k) {
      const int row = row_at(k);
      const size_t base = static_cast<size_t>(row) * cols;
      row_fn(base, [&](int j, float (&v)[8], int pass) {
        const int c = chunk_col(lane, j);
        if (row >= rows || c >= cols) return false;
        Raw8<TIn> xr, rr;
        load_row(x + base + c, xr);
        if (ADD) load_row(r + base + c, rr);
        row_values<TIn, ADD>(xr, rr, v);
        if (ADD && pass == 0) store8(sum + base + c, v, 0.f);
        return true;
      });
    }
  } else {
    RowLoads<TIn, CPL> next;
    fetch<TIn, ADD>(next, x, r, row_at(0), rows, cols, lane);
    start();
    for (int k = 0; k < steps; ++k) {
      const int row = row_at(k);
      const size_t base = static_cast<size_t>(row) * cols;
      float v[CPL][8];
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = chunk_col(lane, j);
        if (row < rows && c < cols) {
          row_values<TIn, ADD>(next.x[j], next.r[j], v[j]);
          if (ADD) store8(sum + base + c, v[j], 0.f);   // exact
        }
      }
      fetch<TIn, ADD>(next, x, r, row_at(k + 1), rows, cols, lane);
      row_fn(base, [&](int j, float (&o)[8], int) {
        if (row >= rows || chunk_col(lane, j) >= cols) return false;
#pragma unroll
        for (int i = 0; i < 8; ++i) o[i] = v[j][i];
        return true;
      });
    }
  }
}

// Blocks an SM the row kernels are built for (__launch_bounds__): as many
// as leave each thread the registers an instantiation needs (32, 8 a held
// chunk and 4 a 16-byte word of the next row's loads, at least 56), so
// that ptxas neither spills nor trades a spill for occupancy
template <typename TIn, bool ADD, int CPL>
constexpr int row_blocks() {
  constexpr int held = CPL > 0 ? CPL : 3;
  constexpr int need = 32 + 8 * held +
                       4 * held * static_cast<int>(sizeof(TIn) / 2) *
                           (ADD ? 2 : 1);
  constexpr int regs = need < 56 ? 56 : (need + 7) / 8 * 8;
  return 65536 / (kThreads * regs);
}

// Kernels A2, B1 and E1 for cols % 8 == 0 and 16-byte aligned operands:
// CPL chunks a lane, or 0 for rows wider than 4 (see walk_rows)
template <typename TIn, typename TOut, bool ADD, int CPL>
__global__ void __launch_bounds__(kThreads, (row_blocks<TIn, ADD, CPL>()))
    layernorm_rows_kernel(const TIn* __restrict__ x,
                          const TIn* __restrict__ r, TIn* __restrict__ sum,
                          const float* __restrict__ w,
                          const float* __restrict__ b,
                          const float* __restrict__ amax,
                          TOut* __restrict__ y, int rows, int cols,
                          float eps) {
  extern __shared__ float4 params4[];   // w, then b: 2 * cols floats
  float* params = reinterpret_cast<float*>(params4);
  const int lane = threadIdx.x & 31;
  const int groups = CPL > 0 ? CPL : (cols / 8 + 31) / 32;
  const float qinv = amax != nullptr ? stt::quant_inv(amax) : 1.f;
  walk_rows<TIn, ADD, CPL>(
      x, r, sum, rows, cols, [&] { stage_params(params, w, b, cols); },
      [&](size_t base, auto get) {
    RowSum s1;
#pragma unroll 4
    for (int j = 0; j < groups; ++j) {
      float v[8];
      float part = 0.f;
      if (get(j, v, 0)) {
#pragma unroll
        for (int i = 0; i < 8; ++i) part += v[i];
      }
      s1.add(j, part);
    }
    const float mean = s1.total() / static_cast<float>(cols);
    RowSum s2;
#pragma unroll 4
    for (int j = 0; j < groups; ++j) {
      float v[8];
      float part = 0.f;
      if (get(j, v, 1)) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          v[i] -= mean;
          part += v[i] * v[i];
        }
      }
      s2.add(j, part);
    }
    const float var = s2.total() / static_cast<float>(cols);
    const float inv = rsqrtf(var + eps);
#pragma unroll 4
    for (int j = 0; j < groups; ++j) {
      float v[8];
      if (get(j, v, 2)) {
        float wv[8], bv[8];
        load8(params + chunk_col(lane, j), wv);
        load8(params + cols + chunk_col(lane, j), bv);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = affine(v[i] - mean, inv, wv[i], bv[i]);
        store8(y + base + chunk_col(lane, j), v, qinv);
      }
    }
  });
}

// Kernel D3 for cols % 8 == 0 and 16-byte aligned operands (y 8-byte):
// CPL chunks a lane, or 0 for rows wider than 4 (see walk_rows)
template <typename TIn, int CPL>
__global__ void __launch_bounds__(kThreads, (row_blocks<TIn, false, CPL>()))
    rmsnorm_quant_rows_kernel(const TIn* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ inv_c,
                              int8_t* __restrict__ y, int rows, int cols,
                              float eps) {
  extern __shared__ float4 params4[];   // w, then inv_c: 2 * cols floats
  float* params = reinterpret_cast<float*>(params4);
  const int lane = threadIdx.x & 31;
  const int groups = CPL > 0 ? CPL : (cols / 8 + 31) / 32;
  walk_rows<TIn, false, CPL>(
      x, nullptr, nullptr, rows, cols,
      [&] { stage_params(params, w, inv_c, cols); },
      [&](size_t base, auto get) {
    RowSum ss;
#pragma unroll 4
    for (int j = 0; j < groups; ++j) {
      float v[8];
      float part = 0.f;
      if (get(j, v, 0)) {
#pragma unroll
        for (int i = 0; i < 8; ++i) part += v[i] * v[i];
      }
      ss.add(j, part);
    }
    const float var = ss.total() / static_cast<float>(cols);
    const float rs = rsqrtf(var + eps);
#pragma unroll 4
    for (int j = 0; j < groups; ++j) {
      float v[8];
      if (get(j, v, 1)) {
        float wv[8], iv[8];
        load8(params + chunk_col(lane, j), wv);
        load8(params + cols + chunk_col(lane, j), iv);
        uint2 raw;
        int8_t* e = reinterpret_cast<int8_t*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          e[i] = stt::quant_i8(__fmul_rn(__fmul_rn(v[i], rs), wv[i]), iv[i]);
        }
        *reinterpret_cast<uint2*>(y + base + chunk_col(lane, j)) = raw;
      }
    }
  });
}

// D3 for any width up to kMaxCols: the row staged in shared memory as fp32
template <typename TIn>
__global__ void rmsnorm_quant_kernel(const TIn* __restrict__ x,
                                     const float* __restrict__ w,
                                     const float* __restrict__ inv_c,
                                     int8_t* __restrict__ y, int cols,
                                     float eps) {
  extern __shared__ float row[];  // cols floats
  __shared__ float red[33];
  const size_t base = static_cast<size_t>(blockIdx.x) * cols;
  float ss = 0.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const float v = stt::to_float(x[base + c]);
    row[c] = v;
    ss += v * v;
  }
  const float var = block_sum(ss, red) / static_cast<float>(cols);
  const float r = rsqrtf(var + eps);
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    y[base + c] = stt::quant_i8(__fmul_rn(__fmul_rn(row[c], r), w[c]),
                                inv_c[c]);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return n;
}

// Blocks of a row kernel's persistent grid: as many as the SMs hold at once
// (blocks_per_sm, read once for each kernel), no more than the rows need
template <typename Kernel>
int row_grid(Kernel kernel, size_t smem, int rows) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  const int need = (rows + kWarps - 1) / kWarps;
  const int full = (per_sm > 0 ? per_sm : 1) * sm_count();
  return need < full ? need : full;
}

// f(std::integral_constant<int, CPL>) with the chunks a lane the row
// kernels hold for cols (cols % 8 == 0, <= kMaxCols): exact up to
// 4, 0 (rows read again at each pass) above
template <typename F>
void with_chunks(int cols, F f) {
  const int groups = (cols / 8 + 31) / 32;
  if (groups == 1) {
    f(std::integral_constant<int, 1>());
  } else if (groups == 2) {
    f(std::integral_constant<int, 2>());
  } else if (groups == 3) {
    f(std::integral_constant<int, 3>());
  } else if (groups == 4) {
    f(std::integral_constant<int, 4>());
  } else {
    f(std::integral_constant<int, 0>());
  }
}

// With ADD (kernel E1), r is the residual and s receives the rounded sum;
// otherwise both are null.
template <typename TIn, typename TOut, bool ADD = false>
void launch(const void* x, const void* w, const void* b, const void* amax,
            void* y, int rows, int cols, float eps, cudaStream_t stream,
            const void* r = nullptr, void* s = nullptr) {
  const TIn* xt = static_cast<const TIn*>(x);
  const TIn* rt = static_cast<const TIn*>(r);
  TIn* st = static_cast<TIn*>(s);
  const float* wt = static_cast<const float*>(w);
  const float* bt = static_cast<const float*>(b);
  const float* at = static_cast<const float*>(amax);
  TOut* yt = static_cast<TOut*>(y);
  if (cols % 8 == 0 && aligned16(x) && aligned16(w) && aligned16(b) &&
      aligned16(y) && (!ADD || (aligned16(r) && aligned16(s)))) {
    with_chunks(cols, [&](auto cpl) {
      const auto kernel =
          layernorm_rows_kernel<TIn, TOut, ADD, decltype(cpl)::value>;
      const size_t smem = 2 * static_cast<size_t>(cols) * sizeof(float);
      kernel<<<row_grid(kernel, smem, rows), kThreads, smem, stream>>>(
          xt, rt, st, wt, bt, at, yt, rows, cols, eps);
    });
    return;
  }
  // about four values per thread, whole warps, at most 1024 threads
  int threads = ((cols + 3) / 4 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t smem = static_cast<size_t>(cols) * sizeof(float);
  layernorm_kernel<TIn, TOut, ADD><<<rows, threads, smem, stream>>>(
      xt, rt, st, wt, bt, at, yt, cols, eps);
}

template <typename TIn>
void launch_rmsnorm_quant(const void* x, const float* w, const float* inv_c,
                          int8_t* y, int rows, int cols, float eps,
                          cudaStream_t stream) {
  const TIn* xt = static_cast<const TIn*>(x);
  if (cols % 8 == 0 && aligned16(x) && aligned16(w) && aligned16(inv_c) &&
      reinterpret_cast<uintptr_t>(y) % 8 == 0) {
    with_chunks(cols, [&](auto cpl) {
      const auto kernel =
          rmsnorm_quant_rows_kernel<TIn, decltype(cpl)::value>;
      const size_t smem = 2 * static_cast<size_t>(cols) * sizeof(float);
      kernel<<<row_grid(kernel, smem, rows), kThreads, smem, stream>>>(
          xt, w, inv_c, y, rows, cols, eps);
    });
    return;
  }
  int threads = ((cols + 3) / 4 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t smem = static_cast<size_t>(cols) * sizeof(float);
  rmsnorm_quant_kernel<<<rows, threads, smem, stream>>>(xt, w, inv_c, y,
                                                         cols, eps);
}

bool valid_shape(int rows, int cols) {
  return rows > 0 && cols > 0 && cols <= kMaxCols;
}

}  // namespace

// x (rows, cols) in in_dtype, w and b (cols,) fp32 -> y (rows, cols) in
// out_dtype.  All contiguous.
extern "C" int stt_layernorm(const void* x, const void* w, const void* b,
                             void* y, int rows, int cols, float eps,
                             int in_dtype, int out_dtype, void* stream) {
  if (!valid_shape(rows, cols)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const bool in_bf = in_dtype == stt::kBFloat16;
  const bool out_bf = out_dtype == stt::kBFloat16;
  if ((!in_bf && in_dtype != stt::kFloat32) ||
      (!out_bf && out_dtype != stt::kFloat32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (in_bf && out_bf) {
    launch<bf16, bf16>(x, w, b, nullptr, y, rows, cols, eps, s);
  } else if (in_bf) {
    launch<bf16, float>(x, w, b, nullptr, y, rows, cols, eps, s);
  } else if (out_bf) {
    launch<float, bf16>(x, w, b, nullptr, y, rows, cols, eps, s);
  } else {
    launch<float, float>(x, w, b, nullptr, y, rows, cols, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// As stt_layernorm, with y int8: the static codes against amax (one fp32
// value in device memory, the calibrated absmax of the LayerNorm output).
extern "C" int stt_layernorm_quant(const void* x, const void* w,
                                   const void* b, const void* amax, void* y,
                                   int rows, int cols, float eps,
                                   int in_dtype, void* stream) {
  if (!valid_shape(rows, cols) || amax == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == stt::kBFloat16) {
    launch<__nv_bfloat16, int8_t>(x, w, b, amax, y, rows, cols, eps, s);
  } else if (in_dtype == stt::kFloat32) {
    launch<float, int8_t>(x, w, b, amax, y, rows, cols, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel E1: branch and residual (rows, cols) in in_dtype, w and b (cols,)
// fp32, amax one fp32 value in device memory -> sum (rows, cols) in in_dtype,
// the residual add rounded to it, and y (rows, cols) int8, the static codes of
// the LayerNorm of that stored sum.  All contiguous.
extern "C" int stt_add_layernorm_quant(const void* branch,
                                       const void* residual, const void* w,
                                       const void* b, const void* amax,
                                       void* sum, void* y, int rows, int cols,
                                       float eps, int in_dtype,
                                       void* stream) {
  if (!valid_shape(rows, cols) || amax == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == stt::kBFloat16) {
    launch<__nv_bfloat16, int8_t, true>(branch, w, b, amax, y, rows, cols,
                                        eps, s, residual, sum);
  } else if (in_dtype == stt::kFloat32) {
    launch<float, int8_t, true>(branch, w, b, amax, y, rows, cols, eps, s,
                                residual, sum);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel D3: x (rows, cols) in in_dtype, w and inv_c (cols,) fp32 -> y
// (rows, cols) int8, the RMSNorm's static codes against the per-channel
// inverse scales inv_c (127 / amax).  All contiguous.
extern "C" int stt_rmsnorm_quant(const void* x, const void* w,
                                 const void* inv_c, void* y, int rows,
                                 int cols, float eps, int in_dtype,
                                 void* stream) {
  if (!valid_shape(rows, cols) ||
      (in_dtype != stt::kBFloat16 && in_dtype != stt::kFloat32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wt = static_cast<const float*>(w);
  const float* it = static_cast<const float*>(inv_c);
  int8_t* yt = static_cast<int8_t*>(y);
  if (in_dtype == stt::kBFloat16) {
    launch_rmsnorm_quant<__nv_bfloat16>(x, wt, it, yt, rows, cols, eps, s);
  } else {
    launch_rmsnorm_quant<float>(x, wt, it, yt, rows, cols, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}
