// The row-ordered live-slot walk that the two slot SpMM kernels share
// (wcoo_spmm.cu, wcoo_bands.cu), each in f32 and bf16.
//
// The stream (ops/kernels/slot_rows.py, built on the host with the layout):
// the live slots of the layout's padded chunks or groups (value not 0, X row
// inside X), sorted by output row and, within a row, in the layout's slot
// order. Per slot an f32 value and its whole X row (int32); row_slot (m + 1)
// points at each row's slots. Pad slots, coverage chunks, pad groups and the
// sacrificial row block take no room: 8 bytes a live slot, read once by the
// one warp that owns the row.
//
// Work split: CTA (bx, by) of WARPS warps takes the rows [bx WARPS,
// (bx + 1) WARPS) and the column slab [128 C by, 128 C (by + 1)), with C the
// float4 a lane (1, 2 or 4, chosen from n by launch); warp w takes the row
// bx WARPS + w. Consecutive rows of a band read neighbouring X rows, which
// the CTAs in flight share in L2.
//
// A warp owns one row at a time and holds its part of the row in registers:
// lane l owns the columns 128 c + 4 l .. 128 c + 4 l + 3 for c < C (the
// float4 form, when n % 4 == 0 and X and Y are 16-byte aligned) or 32 j + l
// for j < 4 C (the scalar form). It loads the row's slots 32 at a time, one
// (value, X row) a lane by a coalesced load, and hands them out with
// __shfl_sync, U = 4 / C slots at a time: U C 16-byte X loads in flight a
// lane, none of them waiting on a load of its own address. Each slot's X
// slab is one coalesced read of 512 C bytes. 256 threads of at most 64
// registers (__launch_bounds__(256, 4)) put 32 warps on an SM; on the H100
// more loads a lane spilled under that cap or, uncapped, cost occupancy,
// and both ran slower. f32 FMA on the CUDA cores, in slot order, so the
// order of each sum is fixed and the result is deterministic (TF32 would
// miss the 1e-4 gate). The row is written once, with streaming stores (Y
// is not read again and should not push X's rows out of L2); an empty row
// is written as zeros. The walk uses no shared memory, no barrier and no
// atomics: its occupancy is set by registers alone.
//
// The bf16 forms (BF: bf16 storage): bf16 values and X, the sum in f32,
// each element of Y rounded once to bf16. Lane l's part of an X row is the
// same columns, 8 bytes a float4's place (n % 4 == 0, X and Y on 8 B), else
// 2-byte loads; the stream's values are bf16 too (6 bytes a live slot). RP
// (the product rounded): each product rounded to bf16 (to nearest, ties to
// even) before it is added into the f32 sum, as wcoo_bands and wcoo_pallas
// multiply at dtype bf16 (RP = BF, the default); without it the product,
// exact in f32, is added by one fmaf (bsr_spmm.cu's entry route, the BSR
// body's f32 dot).
//
// The 16-byte bf16 walk (walk16; wcoo_bands' bf16 form only, RP, where n
// % 8 == 0 and X and Y lie on 16 bytes; wcoo_bands.cu selects it): a group
// of L lanes a row, each lane 8 bf16 (one uint4) of the X row a vector,
// L = the slab's vectors rounded up to a power of two, at most 32 (E
// vectors a lane past 32), so 32 / L rows share a warp; each row's slots
// are still added in slot order by its own lanes, so the bits do not
// change. The raw uint4 of U slots are held until their products
// (v16_gathers: U = 8 at one vector a lane, 2 at two), the products
// formed two at a time by mul.rn.bf16x2 (mul_add8), widened and added in
// f32. A warp walks V16_SETS sets of rows in turn, loading the next set's
// slot pointers and first (value, X row) while this set's gathers are in
// flight. The grid runs every row of slab 0 before slab 1 (grid.y), and
// the long-row walk takes the same slabs. Every launch of the walk and the
// long-row walk in slabs gets its slab as an argument; the other walks'
// is 128 C.
//
// Listed rows: where `rows` is given, the walk takes the rows rows[0 ..
// m - 1] (row_slot still indexed by the row itself), and leaves every
// other row of Y alone (bsr_spmm.cu's entry route: the rows of its
// entry-route slices).
//
// Long rows: a warp walks its row's slots in turn, U at a time, so one row
// of many slots sets the pace of the whole launch (on the H100 the edge
// matrix's one 250-slot row set its whole time). The walk leaves rows of
// more than long_row slots alone; a second kernel, long_walk, gives each
// of them (the layout's long_rows, listed on the host) a CTA of LONG_WARPS
// warps, each summing an equal run of the row's slots, and adds the runs'
// sums in warp order through shared memory: no atomics, a fixed order.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "bf16_bits.cuh"

namespace spgrid {
namespace slot_rows {
namespace {  // each kernel source gets its own copy of the kernels

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int SLAB = 128;   // columns of a warp's slab for each C
constexpr int LOADS = 4;    // U C: X loads in flight a lane
constexpr int LONG_WARPS = 16;  // warps that share one long row
constexpr int LONG_THREADS = 32 * LONG_WARPS;
constexpr unsigned FULL = 0xffffffffu;

using bf16::Elem;
using bf16::round_bf16;
using bf16::widen;

// Lane `lane`'s part of one X row's slab, xr pointing at the slab's first
// column, `left` columns of the slab inside X: 4 C values, 0 past them.
template <int C, bool VEC, bool BF>
__device__ __forceinline__ void load_slab(const Elem<BF>* __restrict__ xr,
                                          int lane, int left,
                                          float (&v)[4 * C]) {
  if constexpr (VEC) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = SLAB * c + 4 * lane;
      if constexpr (BF) {
        const uint2 t = col < left
                            ? __ldg(reinterpret_cast<const uint2*>(xr + col))
                            : make_uint2(0u, 0u);
        v[4 * c] = __uint_as_float(t.x << 16);
        v[4 * c + 1] = __uint_as_float(t.x & 0xFFFF0000u);
        v[4 * c + 2] = __uint_as_float(t.y << 16);
        v[4 * c + 3] = __uint_as_float(t.y & 0xFFFF0000u);
      } else {
        const float4 t = col < left
                             ? __ldg(reinterpret_cast<const float4*>(xr + col))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        v[4 * c] = t.x;
        v[4 * c + 1] = t.y;
        v[4 * c + 2] = t.z;
        v[4 * c + 3] = t.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4 * C; ++j) {
      const int col = 32 * j + lane;
      v[j] = col < left ? widen(__ldg(xr + col)) : 0.0f;
    }
  }
}

// Lane `lane`'s part of one Y row's slab, the columns inside Y only (bf16:
// each rounded once).
template <int C, bool VEC, bool BF>
__device__ __forceinline__ void store_slab(Elem<BF>* __restrict__ yr,
                                           int lane, int left,
                                           const float (&v)[4 * C]) {
  if constexpr (VEC) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = SLAB * c + 4 * lane;
      if (col >= left) continue;
      if constexpr (BF) {
        *reinterpret_cast<uint2*>(yr + col) = make_uint2(
            static_cast<uint32_t>(round_bf16(v[4 * c])) |
                static_cast<uint32_t>(round_bf16(v[4 * c + 1])) << 16,
            static_cast<uint32_t>(round_bf16(v[4 * c + 2])) |
                static_cast<uint32_t>(round_bf16(v[4 * c + 3])) << 16);
      } else {
        __stcs(reinterpret_cast<float4*>(yr + col),
               make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2],
                           v[4 * c + 3]));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4 * C; ++j) {
      const int col = 32 * j + lane;
      if (col >= left) continue;
      if constexpr (BF) {
        yr[col] = round_bf16(v[j]);
      } else {
        __stcs(yr + col, v[j]);
      }
    }
  }
}

// acc += value * X[X row] over the slots [beg, end) of one row, in slot
// order, by one warp, `left` columns of the slab from n0 inside it: the
// slots' (value, X row) 32 at a time, one a lane, handed out by shuffles U
// at a time. Warp-collective: beg and end are the same in every lane. RP:
// each product rounded to bf16 before the add.
template <int C, bool VEC, bool BF, bool RP>
__device__ __forceinline__ void add_slots(float (&acc)[4 * C], int beg,
                                          int end,
                                          const Elem<BF>* __restrict__ vals,
                                          const int* __restrict__ xrows,
                                          const Elem<BF>* __restrict__ x,
                                          int n, int n0, int left, int lane) {
  constexpr int U = LOADS / C;
  for (int base = beg; base < end; base += 32) {
    const int count = min(32, end - base);
    float v = 0.0f;
    int xrow = 0;
    if (lane < count) {
      v = widen(__ldg(vals + base + lane));
      xrow = __ldg(xrows + base + lane);
    }
    for (int j = 0; j < count; j += U) {
      float xv[U][4 * C];
      float vv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        vv[u] = __shfl_sync(FULL, v, (j + u) & 31);
        const int r = __shfl_sync(FULL, xrow, (j + u) & 31);
        if (j + u < count)
          load_slab<C, VEC, BF>(x + static_cast<size_t>(r) * n + n0, lane,
                                left, xv[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j + u < count) {
#pragma unroll
          for (int e = 0; e < 4 * C; ++e) {
            if constexpr (RP) {
              acc[e] += widen(round_bf16(vv[u] * xv[u][e]));
            } else {
              acc[e] = fmaf(vv[u], xv[u][e], acc[e]);
            }
          }
        }
      }
    }
  }
}

// The row walk: a warp a row (the i-th of m, or rows[i] where rows is
// given), every row but the long ones (more than long_row slots), which
// long_walk writes.
template <int C, bool VEC, bool BF, bool RP>
__global__ void __launch_bounds__(THREADS, 4)
walk(const int* __restrict__ row_slot, const Elem<BF>* __restrict__ vals,
     const int* __restrict__ xrows, const Elem<BF>* __restrict__ x,
     Elem<BF>* __restrict__ y, int m, int n, int slab, int long_row,
     const int* __restrict__ rows) {
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.y * slab;
  const int left = min(slab, n - n0);
  const long long i =
      static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (i >= m) return;
  const long long row = rows != nullptr ? __ldg(rows + i) : i;
  const int beg = __ldg(row_slot + row);
  const int end = __ldg(row_slot + row + 1);
  if (end - beg > long_row) return;
  float acc[4 * C];
#pragma unroll
  for (int e = 0; e < 4 * C; ++e) acc[e] = 0.0f;
  add_slots<C, VEC, BF, RP>(acc, beg, end, vals, xrows, x, n, n0, left,
                            lane);
  store_slab<C, VEC, BF>(y + static_cast<size_t>(row) * n + n0, lane, left,
                         acc);
}

// A long row a CTA (blockIdx.x indexes long_rows): warp w sums the w-th of
// LONG_WARPS equal runs of the row's slots, then warp 0 adds the runs'
// sums in warp order and writes the row. No atomics; a fixed order.
template <int C, bool VEC, bool BF, bool RP>
__global__ void __launch_bounds__(LONG_THREADS)
long_walk(const int* __restrict__ long_rows, const int* __restrict__ row_slot,
          const Elem<BF>* __restrict__ vals, const int* __restrict__ xrows,
          const Elem<BF>* __restrict__ x, Elem<BF>* __restrict__ y, int n,
          int slab) {
  __shared__ float part[LONG_WARPS][4 * C][32];
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  const int n0 = blockIdx.y * slab;
  const int left = min(slab, n - n0);
  const int row = __ldg(long_rows + blockIdx.x);
  const int beg = __ldg(row_slot + row);
  const int end = __ldg(row_slot + row + 1);
  const int run = (end - beg + LONG_WARPS - 1) / LONG_WARPS;
  const int lo = min(end, beg + w * run);
  float acc[4 * C];
#pragma unroll
  for (int e = 0; e < 4 * C; ++e) acc[e] = 0.0f;
  add_slots<C, VEC, BF, RP>(acc, lo, min(end, lo + run), vals, xrows, x, n,
                            n0, left, lane);
#pragma unroll
  for (int e = 0; e < 4 * C; ++e) part[w][e][lane] = acc[e];
  __syncthreads();
  if (w != 0) return;
#pragma unroll
  for (int e = 0; e < 4 * C; ++e) {
    float sum = part[0][e][lane];
    for (int v = 1; v < LONG_WARPS; ++v) sum += part[v][e][lane];
    acc[e] = sum;
  }
  store_slab<C, VEC, BF>(y + static_cast<size_t>(row) * n + n0, lane, left,
                         acc);
}

// The long-row walk of the rows long_rows[0 .. num_long - 1], slabs of
// `slab` <= 128 C columns.
template <int C, bool VEC, bool BF, bool RP>
int launch_long(cudaStream_t s, const void* row_slot, const void* vals,
                const void* xrows, const void* long_rows, const void* x,
                void* y, int n, int slab, int num_long) {
  using T = Elem<BF>;
  if (num_long == 0) return 0;
  long_walk<C, VEC, BF, RP>
      <<<dim3(num_long, (n + slab - 1) / slab), LONG_THREADS, 0, s>>>(
          static_cast<const int*>(long_rows),
          static_cast<const int*>(row_slot), static_cast<const T*>(vals),
          static_cast<const int*>(xrows), static_cast<const T*>(x),
          static_cast<T*>(y), n, slab);
  return static_cast<int>(cudaGetLastError());
}

// The walk and the long-row walk in column slabs of `slab` <= 128 C
// columns (slab 0 of them before slab 1: the grid's slow index).
template <int C, bool VEC, bool BF, bool RP>
int launch_form(cudaStream_t s, const void* row_slot, const void* vals,
                const void* xrows, const void* long_rows, const void* x,
                void* y, int m, int n, int slab, int long_row, int num_long,
                const int* rows) {
  using T = Elem<BF>;
  const dim3 grid(m / WARPS + (m % WARPS != 0), (n + slab - 1) / slab);
  walk<C, VEC, BF, RP><<<grid, THREADS, 0, s>>>(
      static_cast<const int*>(row_slot), static_cast<const T*>(vals),
      static_cast<const int*>(xrows), static_cast<const T*>(x),
      static_cast<T*>(y), m, n, slab, long_row, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_long<C, VEC, BF, RP>(s, row_slot, vals, xrows, long_rows, x,
                                     y, n, slab, num_long);
}

template <int C, bool BF, bool RP>
int launch_cols(bool vec, cudaStream_t s, const void* row_slot,
                const void* vals, const void* xrows, const void* long_rows,
                const void* x, void* y, int m, int n, int slab, int long_row,
                int num_long, const int* rows) {
  return vec ? launch_form<C, true, BF, RP>(s, row_slot, vals, xrows,
                                            long_rows, x, y, m, n, slab,
                                            long_row, num_long, rows)
             : launch_form<C, false, BF, RP>(s, row_slot, vals, xrows,
                                             long_rows, x, y, m, n, slab,
                                             long_row, num_long, rows);
}

// The walk and, where there are long rows, the long-row walk on `stream`;
// 0 or the CUDA error. C is 1, 2 or 4 by n (a warp covers 128, 256 or 512
// columns); the vector form when n % 4 == 0 and X and Y are aligned to four
// elements (16 B in f32, 8 B in bf16), else the scalar form. long_rows
// holds the num_long rows with more than long_row slots. BF: the bf16
// storage; RP: each product rounded to bf16. rows: the m rows to walk (null:
// rows 0 .. m - 1).
template <bool BF = false, bool RP = BF>
int launch(const void* row_slot, const void* vals, const void* xrows,
           const void* long_rows, const void* x, void* y, int m, int n,
           int long_row, int num_long, void* stream,
           const int* rows = nullptr) {
  if (m < 0 || n < 0 || long_row < 0 || num_long < 0 || num_long > m)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  const std::uintptr_t addr = reinterpret_cast<std::uintptr_t>(x) |
                              reinterpret_cast<std::uintptr_t>(y);
  const bool vec = n % 4 == 0 && addr % (4 * sizeof(Elem<BF>)) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= SLAB)
    return launch_cols<1, BF, RP>(vec, s, row_slot, vals, xrows, long_rows,
                                  x, y, m, n, SLAB, long_row, num_long, rows);
  if (n <= 2 * SLAB)
    return launch_cols<2, BF, RP>(vec, s, row_slot, vals, xrows, long_rows,
                                  x, y, m, n, 2 * SLAB, long_row, num_long,
                                  rows);
  return launch_cols<4, BF, RP>(vec, s, row_slot, vals, xrows, long_rows, x,
                                y, m, n, 4 * SLAB, long_row, num_long, rows);
}

// ---- The 16-byte bf16 walk (wcoo_bands' bf16 form, RP; see the top of
// this file).

constexpr int V16_MIN_SLAB = 64;    // columns of the narrowest slab
constexpr int V16_MAX_SLAB = 512;   // ... of the widest
constexpr int V16_BUDGET = 32;      // raw registers of X held a lane
constexpr int V16_MAX_U = 8;        // slots in flight a lane, at most
constexpr int V16_SETS = 2;         // sets of rows a warp walks in turn

// U, the slots a group of L lanes has in flight, E uint4 (4 E registers)
// each held raw until its products: at most V16_MAX_U, their registers at
// most V16_BUDGET, and with the 8 E accumulators at most V16_BUDGET + 8
// (at 64 registers a thread, U = 4 at E = 2 spilled); a power of two, so
// that it divides L.
__host__ __device__ constexpr int v16_gathers(int L, int E) {
  int u = V16_MAX_U;
  while (u > 1 && (u > L || 4 * E * u > V16_BUDGET ||
                   4 * E * u + 8 * E > V16_BUDGET + 8))
    u /= 2;
  return u;
}

// acc[i] += round_bf16(v x_i) for the 8 bf16 x_i of t, v2 = v in both
// halves: the products by sm_90's mul.rn.bf16x2, two a time. The product
// of two bf16 is exact in f32 and rounded once here, as round_bf16 rounds
// the f32 product wherever that product lies in f32's normal range; below
// it (|v x| < 2^-126) the f32 product is itself rounded to f32's subnormal
// grid before round_bf16, and the two may then differ by an ulp of the
// subnormal result (the plain version computes in f32).
__device__ __forceinline__ void mul_add8(float* acc, uint32_t v2,
                                         const uint4& t) {
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t p;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(p) : "r"(v2), "r"(w[i]));
    acc[2 * i] += __uint_as_float(p << 16);
    acc[2 * i + 1] += __uint_as_float(p & 0xFFFF0000u);
  }
}

// Lane j's 16-byte vectors j + L e (e < E) of one bf16 X row's slab, xr
// pointing at the slab's first column, `left` columns of it inside X: 8
// bf16 a uint4, raw; zeros past them.
template <int L, int E>
__device__ __forceinline__ void raw16(const unsigned short* __restrict__ xr,
                                      int j, int left, uint4 (&v)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int col = (j + L * e) * 8;
    v[e] = col < left ? __ldg(reinterpret_cast<const uint4*>(xr + col))
                      : make_uint4(0u, 0u, 0u, 0u);
  }
}

// acc += round(value X[X row]) over the `count` slots of one row from
// beg, in slot order, by a group of L lanes (j the lane's place in it):
// the slots' (value, X row) L at a time, one a lane (the first L, v and r,
// loaded by the caller; each next L loaded ahead), handed out by shuffles
// U at a time, each slot's U E 16-byte X loads in flight before the
// products use them. `most` is the largest count of the warp's groups:
// every lane runs the same rounds, as the shuffles need.
template <int L, int E>
__device__ __forceinline__ void add_slots16(
    float (&acc)[8 * E], int beg, int count, int most, uint32_t v, int r,
    const unsigned short* __restrict__ vals, const int* __restrict__ xrows,
    const unsigned short* __restrict__ x, int n, int n0, int left, int j) {
  constexpr int U = v16_gathers(L, E);
  for (int base = 0; base < most; base += L) {
    uint32_t v_next = 0;
    int r_next = 0;
    if (base + L + j < count) {
      v_next = __ldg(vals + beg + base + L + j);
      r_next = __ldg(xrows + beg + base + L + j);
    }
#pragma unroll
    for (int u0 = 0; u0 < L; u0 += U) {
      if (base + u0 >= most) break;  // the same in every lane
      uint4 xr[U][E];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int ru = __shfl_sync(FULL, r, u0 + u, L);
        if (base + u0 + u < count)
          raw16<L, E>(x + static_cast<size_t>(ru) * n + n0, j, left, xr[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint32_t vu = __shfl_sync(FULL, v, u0 + u, L);
        if (base + u0 + u < count) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            mul_add8(acc + 8 * e, vu | vu << 16, xr[u][e]);
        }
      }
    }
    v = v_next;
    r = r_next;
  }
}

// A row set's place in the 16-byte walk: this lane's row's first slot and
// slot count (0 for a row past m or a long row, which long_walk writes).
struct Rows16 {
  int beg, count;
  bool writes;
};

// The 16-byte walk: CTA (bx, by) takes V16_SETS sets of rows a warp, a
// set R = 32 / L rows, a group of L lanes a row, and the slab of columns
// [by slab, (by + 1) slab). Each warp walks its sets in turn, the next
// set's slot pointers and the one after's first (value, X row) loaded
// while this set's gathers are in flight. Y's slab of a row is written
// once, 8 rounded values a 16-byte streaming store.
template <int L, int E>
__global__ void __launch_bounds__(THREADS, 4)
walk16(const int* __restrict__ row_slot,
       const unsigned short* __restrict__ vals,
       const int* __restrict__ xrows, const unsigned short* __restrict__ x,
       unsigned short* __restrict__ y, int m, int n, int slab, int long_row) {
  constexpr int ROWS_A_WARP = 32 / L;
  const int lane = threadIdx.x % 32;
  const int j = lane % L;
  const long long set0 =
      (static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32) *
      V16_SETS;
  if (set0 * ROWS_A_WARP >= m) return;  // the whole warp leaves together
  const int n0 = blockIdx.y * slab;
  const int left = min(slab, n - n0);
  auto rows_of = [&](int i) {
    Rows16 s{0, 0, false};
    const long long row = (set0 + i) * ROWS_A_WARP + lane / L;
    if (i < V16_SETS && row < m) {
      s.beg = __ldg(row_slot + row);
      s.count = __ldg(row_slot + row + 1) - s.beg;
      s.writes = s.count <= long_row;
      if (!s.writes) s.count = 0;
    }
    return s;
  };
  Rows16 cur = rows_of(0);
  Rows16 next = rows_of(1);
  uint32_t v = 0;
  int r = 0;
  if (j < cur.count) {
    v = __ldg(vals + cur.beg + j);
    r = __ldg(xrows + cur.beg + j);
  }
#pragma unroll
  for (int i = 0; i < V16_SETS; ++i) {
    const Rows16 after = rows_of(i + 2);
    uint32_t v_next = 0;
    int r_next = 0;
    if (j < next.count) {
      v_next = __ldg(vals + next.beg + j);
      r_next = __ldg(xrows + next.beg + j);
    }
    const int most = __reduce_max_sync(FULL, cur.count);
    float acc[8 * E];
#pragma unroll
    for (int e = 0; e < 8 * E; ++e) acc[e] = 0.0f;
    add_slots16<L, E>(acc, cur.beg, cur.count, most, v, r, vals, xrows, x, n,
                      n0, left, j);
    const long long row = (set0 + i) * ROWS_A_WARP + lane / L;
    if (cur.writes) {
      unsigned short* yr = y + static_cast<size_t>(row) * n + n0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int col = (j + L * e) * 8;
        if (col >= left) continue;
        const float* u = acc + 8 * e;
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          w[k] = static_cast<uint32_t>(round_bf16(u[2 * k])) |
                 static_cast<uint32_t>(round_bf16(u[2 * k + 1])) << 16;
        }
        __stcs(reinterpret_cast<uint4*>(yr + col),
               make_uint4(w[0], w[1], w[2], w[3]));
      }
    }
    cur = next;
    next = after;
    v = v_next;
    r = r_next;
  }
}

template <int L, int E>
int launch16(cudaStream_t s, const void* row_slot, const void* vals,
             const void* xrows, const void* x, void* y, int m, int n,
             int slab, int long_row) {
  constexpr int rows = WARPS * V16_SETS * 32 / L;  // rows a CTA
  const dim3 grid((m + rows - 1) / rows, (n + slab - 1) / slab);
  walk16<L, E><<<grid, THREADS, 0, s>>>(
      static_cast<const int*>(row_slot),
      static_cast<const unsigned short*>(vals),
      static_cast<const int*>(xrows), static_cast<const unsigned short*>(x),
      static_cast<unsigned short*>(y), m, n, slab, long_row);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace slot_rows
}  // namespace spgrid
