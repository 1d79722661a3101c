// Gather-ELL SpMM, Y = A @ X with A in DeviceDGELL layout: the ELL slots and
// the COO tail in one launch.
//
// Replaces: spgrid/ops/pallas/dgell.py, _kernel / _dgell_call (the Pallas
// TPU kernel behind `dgell`, which fetches each nnz's X row with its own
// HBM-to-VMEM copy; it never compiled on a TPU, so this is its first run
// on hardware), and the tail that the JAX package adds outside it in XLA.
//
// Bound on the H100: device-memory bytes. At the main path's 100000^2
// scattered matrix (2.1M nnz, n = 512) the product needs X and Y once
// (205 MB each) and the nnz (17 MB): ~127 us at 3.35 TB/s. A row gather
// reads one X row slab per live slot, 4.3 GB of X elements in all, from
// ~90,000 distinct X rows (184 MB, past the 50 MB L2): read straight from
// device memory, those reads set the time (1.6 ms for a kernel that read
// every X row from there).
//
// Design: X in column slabs that stay in L2. The grid takes the slab as its
// slow index (blockIdx.y): every row tile of slab 0 runs before slab 1, so
// the k x C floats of one slab are read from device memory about once and
// every gather of that slab then hits L2. C comes from k, n and the card's
// L2 size (`slab_width`: the widest power of two >= 8 whose slab fits in
// half of L2, the rest of L2 being left to the ELL stream and Y; one slab
// of n columns where that is at least n); the ELL arrays are read once a
// slab, with streaming loads, as Y is written with streaming stores, so
// that neither pushes the slab out of L2. At the main path C = 64: a 25.6 MB
// slab, 8 slabs, ~0.59 GB from device memory in all. (On the H100, C = 16,
// 32, 64, 128 and 512 took 1.10, 0.69, 0.67, 0.75 and 1.26 ms there.)
//
// A row's slab is held by a group of L lanes (L = the slab's float4, or
// floats, rounded up to a power of two, at most 32; E vectors a lane past
// 32), so a warp holds 32 / L rows: at C = 32, 8 lanes x one float4 a row,
// 4 rows a warp. A group loads its row's slots L at a time, one (value,
// column) a lane with the next L loaded ahead, and hands them out by
// shuffles, U at a time: U independent gathers of E vectors in flight a
// lane before the FMAs use them (`gathers`: U <= 8, at most 32 floats in
// the float4 form, 16 in the scalar one). Slots whose value is 0 (the
// empty slots, column 0) read no X.
// After the row's slots the group walks its tail nnz (tail_ptr, sorted by
// row) the same way into the same registers, and writes the row's slab of
// Y once. f32 FMA in slot order, then tail order: no atomics, one launch,
// the same bits on every call. A long tail is walked by its one group
// while the warp's other rows wait (a warp runs to its longest tail).
//
// The bf16 form (dgell at dtype bf16: the JAX layout holds its values in
// f32, dgell.py:101, widens X to f32, :212, adds the tail in f32, :217-220,
// and rounds Y once, :221): the same walk on bf16 X, the values f32, the
// slots' and then the tail's FMAs in f32, each X element widened to f32 at
// its FMA, and each element of Y rounded to bf16 once, after the tail.
// Bound on the H100: the bytes of X (bf16) and Y (bf16) once and of the nnz
// (f32 values, int32 columns); what holds it is the gathers' latency, as
// in the f32 form: a lane waits on each round of U gathers before its FMAs.
// Its first form gathered 8 bytes a lane (4 bf16), so at a slab
// that stays in L2 a row took twice the lanes and shuffles of the f32 form
// for its bytes, and it ran fastest at the widest slab (0.625249 ms on
// LINE_S, n = 512, NVIDIA H100 80GB HBM3, 700 W). The design now:
// - A 16-byte vector (W = 8: one uint4 load a lane, 8 bf16) where n % 8 ==
//   0 and X and Y lie on 16 bytes; the 8-byte vector (W = 4) where n % 4 ==
//   0 and they lie on 8, else one element. Y is written as one 16-byte
//   streaming store of 8 rounded values.
// - Its gathers are held raw until their FMAs (4 registers for 8 elements,
//   widened there by `fma8`), so that U = 8 gathers of 16 bytes stay in
//   flight a lane within the budget; the values are shuffled out again at
//   the FMAs rather than held (ptxas: 40 to 64 registers and no spill in
//   each of its instantiations, 63 at L = 8; holding them spilled at L =
//   16, and 3 CTAs an SM without the spill ran slower than 4 with it).
// - The slab rule is the f32 rule's columns (bf16 X then fills a quarter
//   of L2), measured on the H100 (NVIDIA H100 80GB HBM3, 700 W;
//   chip_smoke.py phase 11a, LINE_S, n = 512, device ms): the 16-byte form
//   at slabs of 64, 128, 256 and 512 columns 0.417055, 0.448614, 0.534180
//   and 0.603258; the 8-byte form there 1.140675, 1.061917, 0.758107 and
//   0.670847. At C = 64, L = 8 lanes a row, 4 rows a warp.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "bf16_bits.cuh"

namespace {

using spgrid::bf16::Elem;
using spgrid::bf16::round_bf16;
using spgrid::bf16::widen;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_SLAB = 8;      // columns of the narrowest slab
constexpr int MAX_SLAB = 512;    // columns of the widest slab
constexpr int MAX_U = 8;         // gathers a lane has in flight, at most
constexpr unsigned FULL = 0xffffffffu;

// W elements a vector; BUDGET registers of X a lane holds ahead of its
// FMAs (widened floats; a scalar load costs more registers than its float:
// half the budget).
template <int W>
struct Form;
template <>
struct Form<4> {  // a float4 (f32) or 4 bf16 (8 bytes) a vector
  static constexpr int BUDGET = 32;
};
template <>
struct Form<1> {  // an element a vector
  static constexpr int BUDGET = 16;
};
template <>
struct Form<8> {  // 8 bf16 (16 bytes) a vector: the bf16 form only, whose
  static constexpr int BUDGET = 32;  // budget counts raw registers
};

// U, the gathers a lane of a group of L lanes has in flight, each held in
// `held` registers until its FMAs: at most MAX_U, the loads at most the
// budget, and the accumulators (NE) plus the loads at most the budget plus
// 8 (under the cap of 64 registers a wider form spilled); a power of two,
// so that it divides L.
__host__ __device__ constexpr int gathers(int L, int held, int NE,
                                          int budget) {
  int u = MAX_U;
  while (u > 1 && (u > L || u * held > budget || u * held + NE > budget + 8))
    u /= 2;
  return u;
}

// Lane j's 16-byte vectors j + L e (e < E) of one bf16 X row's slab, as
// load_slab, raw: 8 bf16 a uint4, widened at the FMAs (fma8).
template <int L, int E>
__device__ __forceinline__ void raw8(const unsigned short* __restrict__ xr,
                                     int j, int left, uint4 (&v)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int col = (j + L * e) * 8;
    v[e] = col < left ? __ldg(reinterpret_cast<const uint4*>(xr + col))
                      : make_uint4(0u, 0u, 0u, 0u);
  }
}

// acc[i] += s * (the i-th bf16 of t, widened), i < 8.
__device__ __forceinline__ void fma8(float* acc, float s, const uint4& t) {
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] = fmaf(s, __uint_as_float(w[i] << 16), acc[2 * i]);
    acc[2 * i + 1] =
        fmaf(s, __uint_as_float(w[i] & 0xFFFF0000u), acc[2 * i + 1]);
  }
}

// Lane j's vectors j + L e (e < E) of one X row's slab, xr pointing at the
// slab's first column, `left` columns of the slab inside X: 0 past them
// (bf16: widened to f32). The 16-byte form loads its vectors raw (raw8).
template <int L, int E, int W, bool BF>
__device__ __forceinline__ void load_slab(const Elem<BF>* __restrict__ xr,
                                          int j, int left,
                                          float (&v)[E * W]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int col = (j + L * e) * W;
    if constexpr (W == 4 && BF) {
      const uint2 t = col < left
                          ? __ldg(reinterpret_cast<const uint2*>(xr + col))
                          : make_uint2(0u, 0u);
      v[4 * e] = __uint_as_float(t.x << 16);
      v[4 * e + 1] = __uint_as_float(t.x & 0xFFFF0000u);
      v[4 * e + 2] = __uint_as_float(t.y << 16);
      v[4 * e + 3] = __uint_as_float(t.y & 0xFFFF0000u);
    } else if constexpr (W == 4) {
      const float4 t = col < left
                           ? __ldg(reinterpret_cast<const float4*>(xr + col))
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[4 * e] = t.x;
      v[4 * e + 1] = t.y;
      v[4 * e + 2] = t.z;
      v[4 * e + 3] = t.w;
    } else {
      v[e] = col < left ? widen(__ldg(xr + col)) : 0.0f;
    }
  }
}

// Lane j's vectors of one Y row's slab, the columns inside Y only (bf16:
// each rounded once).
template <int L, int E, int W, bool BF>
__device__ __forceinline__ void store_slab(Elem<BF>* __restrict__ yr, int j,
                                           int left, const float (&v)[E * W]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int col = (j + L * e) * W;
    if (col >= left) continue;
    if constexpr (W == 8) {
      const float* u = v + 8 * e;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = static_cast<uint32_t>(round_bf16(u[2 * i])) |
               static_cast<uint32_t>(round_bf16(u[2 * i + 1])) << 16;
      }
      __stcs(reinterpret_cast<uint4*>(yr + col),
             make_uint4(w[0], w[1], w[2], w[3]));
    } else if constexpr (W == 4 && BF) {
      __stcs(reinterpret_cast<uint2*>(yr + col),
             make_uint2(static_cast<uint32_t>(round_bf16(v[4 * e])) |
                            static_cast<uint32_t>(round_bf16(v[4 * e + 1]))
                                << 16,
                        static_cast<uint32_t>(round_bf16(v[4 * e + 2])) |
                            static_cast<uint32_t>(round_bf16(v[4 * e + 3]))
                                << 16));
    } else if constexpr (W == 4) {
      __stcs(reinterpret_cast<float4*>(yr + col),
             make_float4(v[4 * e], v[4 * e + 1], v[4 * e + 2], v[4 * e + 3]));
    } else if constexpr (BF) {
      yr[col] = round_bf16(v[e]);
    } else {
      __stcs(yr + col, v[e]);
    }
  }
}

// acc += value * X[column] over a run of `count` (value, column) pairs, in
// order, by a group of L lanes (j = the lane's place in its group). `most`
// is the largest count of the warp's groups: every lane runs the same
// number of rounds, as the shuffles need.
template <int L, int E, int W, bool BF>
__device__ __forceinline__ void add_run(float (&acc)[E * W],
                                        const int* __restrict__ cols,
                                        const float* __restrict__ vals,
                                        int count, int most,
                                        const Elem<BF>* __restrict__ x, int n,
                                        int n0, int left, int j) {
  constexpr int NE = E * W;
  // the registers a gather holds in flight: its widened floats, but the
  // 16-byte form's raw bf16 pairs (4 registers for 8 elements)
  constexpr int U = gathers(L, W == 8 ? NE / 2 : NE, NE, Form<W>::BUDGET);
  float v = 0.0f;
  int c = 0;
  if (j < count) {
    v = __ldcs(vals + j);
    c = __ldcs(cols + j);
  }
  for (int base = 0; base < most; base += L) {
    float v_next = 0.0f;
    int c_next = 0;
    if (base + L + j < count) {  // the next round's pair, loaded ahead
      v_next = __ldcs(vals + base + L + j);
      c_next = __ldcs(cols + base + L + j);
    }
#pragma unroll
    for (int u0 = 0; u0 < L; u0 += U) {
      if constexpr (W == 8) {
        // the values are shuffled out again for the FMAs rather than held
        // across the loads: 8 registers fewer, no spill under the cap
        uint4 xr[U][E];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float vu = __shfl_sync(FULL, v, u0 + u, L);
          const int cu = __shfl_sync(FULL, c, u0 + u, L);
          if (vu != 0.0f)
            raw8<L, E>(x + static_cast<size_t>(cu) * n + n0, j, left, xr[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float vu = __shfl_sync(FULL, v, u0 + u, L);
          if (vu != 0.0f) {
#pragma unroll
            for (int e = 0; e < E; ++e) fma8(acc + 8 * e, vu, xr[u][e]);
          }
        }
      } else {
        float vv[U];
        float xv[U][NE];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          vv[u] = __shfl_sync(FULL, v, u0 + u, L);
          const int cu = __shfl_sync(FULL, c, u0 + u, L);
          if (vv[u] != 0.0f)
            load_slab<L, E, W, BF>(x + static_cast<size_t>(cu) * n + n0, j,
                                   left, xv[u]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (vv[u] != 0.0f) {
#pragma unroll
            for (int e = 0; e < NE; ++e)
              acc[e] = fmaf(vv[u], xv[u][e], acc[e]);
          }
        }
      }
    }
    v = v_next;
    c = c_next;
  }
}

// CTA (bx, by): the rows [bx R, (bx + 1) R), R = WARPS 32 / L, and the slab
// of columns [by C, by C + C) (C a multiple of W in the vector forms).
template <int L, int E, int W, bool BF>
__global__ void __launch_bounds__(THREADS, 4)
dgell_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
             const int* __restrict__ tail_ptr,
             const int* __restrict__ tail_cols,
             const float* __restrict__ tail_vals,
             const Elem<BF>* __restrict__ x, Elem<BF>* __restrict__ y, int m,
             int slots, int n, int slab) {
  constexpr int ROWS_A_WARP = 32 / L;
  constexpr int NE = E * W;
  const int lane = threadIdx.x % 32;
  const int j = lane % L;
  const long long first =
      (static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32) *
      ROWS_A_WARP;
  if (first >= m) return;  // the whole warp: every lane leaves together
  const long long row = first + lane / L;
  const bool inside = row < m;
  const int n0 = blockIdx.y * slab;
  const int left = min(slab, n - n0);
  float acc[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) acc[e] = 0.0f;
  const size_t at = static_cast<size_t>(inside ? row : first) * slots;
  add_run<L, E, W, BF>(acc, cols + at, vals + at, inside ? slots : 0, slots,
                       x, n, n0, left, j);
  int t0 = 0;
  int t_count = 0;
  if (inside) {
    t0 = __ldg(tail_ptr + row);
    t_count = __ldg(tail_ptr + row + 1) - t0;
  }
  const int t_most = __reduce_max_sync(FULL, t_count);
  if (t_most > 0)
    add_run<L, E, W, BF>(acc, tail_cols + t0, tail_vals + t0, t_count,
                         t_most, x, n, n0, left, j);
  if (inside)
    store_slab<L, E, W, BF>(y + static_cast<size_t>(row) * n + n0, j, left,
                            acc);
}

// The slab width C that a launch of k x n takes when asked for `slab`: 0
// asks for the rule (the widest power of two from MIN_SLAB to MAX_SLAB
// whose k x C floats fit in half of the current card's L2; bf16 X takes
// the same C, so its slab fills a quarter of L2, see the bf16 form above);
// a power of two from MIN_SLAB to MAX_SLAB, or n itself up to MAX_SLAB, is
// taken as it is. Either way, one slab of n columns where C >= n and n <=
// MAX_SLAB. -1 for a request it refuses.
int slab_width(int k, int n, int slab) {
  if (slab == n && n <= MAX_SLAB) return n;
  if (slab == 0) {
    int device = 0;
    int l2 = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, device);
    const long long budget = l2 / 2;
    slab = MIN_SLAB;
    while (slab < MAX_SLAB && 4LL * k * (2 * slab) <= budget) slab *= 2;
  } else if (slab < MIN_SLAB || slab > MAX_SLAB || (slab & (slab - 1)) != 0) {
    return -1;
  }
  return slab >= n && n <= MAX_SLAB ? n : slab;
}

// L lanes a row and E vectors a lane for a slab of `slab` columns in
// vectors of w elements: the slab's vectors rounded up to a power of two
// P, L = min(P, 32).
void lanes_for(int slab, int w, int* lanes, int* per_lane) {
  const int vectors = (slab + w - 1) / w;
  int p = 1;
  while (p < vectors) p *= 2;
  *lanes = p < 32 ? p : 32;
  *per_lane = p / *lanes;
}

struct Args {
  const int* cols;
  const float* vals;
  const int* tail_ptr;
  const int* tail_cols;
  const float* tail_vals;
  const void* x;
  void* y;
  int m;
  int slots;
  int n;
  int slab;
};

template <int L, int E, int W, bool BF>
int launch(const Args& a, cudaStream_t s) {
  constexpr int rows = WARPS * 32 / L;
  const long long tiles = (static_cast<long long>(a.m) + rows - 1) / rows;
  const int slabs = (a.n + a.slab - 1) / a.slab;
  if (tiles > INT_MAX || slabs > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dgell_kernel<L, E, W, BF>
      <<<dim3(static_cast<unsigned>(tiles), slabs), THREADS, 0, s>>>(
          a.cols, a.vals, a.tail_ptr, a.tail_cols, a.tail_vals,
          static_cast<const Elem<BF>*>(a.x), static_cast<Elem<BF>*>(a.y), a.m,
          a.slots, a.n, a.slab);
  return static_cast<int>(cudaGetLastError());
}

template <int W, bool BF>
int launch_form(const Args& a, int lanes, int per_lane, cudaStream_t s) {
  if (per_lane == 1) {
    switch (lanes) {
      case 1: return launch<1, 1, W, BF>(a, s);
      case 2: return launch<2, 1, W, BF>(a, s);
      case 4: return launch<4, 1, W, BF>(a, s);
      case 8: return launch<8, 1, W, BF>(a, s);
      case 16: return launch<16, 1, W, BF>(a, s);
      default: return launch<32, 1, W, BF>(a, s);
    }
  }
  switch (per_lane) {
    case 2: return launch<32, 2, W, BF>(a, s);
    default:
      if constexpr (W < 8) {
        if (per_lane == 4) return launch<32, 4, W, BF>(a, s);
      }
      if constexpr (W == 1) {
        if (per_lane == 8) return launch<32, 8, 1, BF>(a, s);
        if (per_lane == 16) return launch<32, 16, 1, BF>(a, s);
      }
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The elements a vector of the form a launch takes: 8 bf16 (16 bytes)
// where BF, n % 8 == 0 and X and Y lie on 16 bytes; else 4 (16 bytes f32,
// 8 bytes bf16) where n % 4 == 0 and X and Y lie on that; else 1.
template <bool BF>
int vector_width(int n, const void* x, const void* y) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(y);
  if (BF && n % 8 == 0 && at % 16 == 0) return 8;
  if (n % 4 == 0 && at % (4 * sizeof(Elem<BF>)) == 0) return 4;
  return 1;
}

// spgrid_dgell and its bf16 form (BF: x and y as bf16 bit patterns).
template <bool BF>
int run(const void* cols, const void* vals, const void* tail_ptr,
        const void* tail_cols, const void* tail_vals, const void* x, void* y,
        int m, int k, int slots, int n, int slab, void* stream) {
  if (m < 0 || k < 0 || slots < 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  const int width = slab_width(k, n, slab);
  if (width < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int w = vector_width<BF>(n, x, y);
  int lanes = 0;
  int per_lane = 0;
  lanes_for(width, w, &lanes, &per_lane);
  const Args a{static_cast<const int*>(cols),
               static_cast<const float*>(vals),
               static_cast<const int*>(tail_ptr),
               static_cast<const int*>(tail_cols),
               static_cast<const float*>(tail_vals),
               x,
               y,
               m,
               slots,
               n,
               width};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (BF) {
    if (w == 8) return launch_form<8, true>(a, lanes, per_lane, s);
  }
  return w == 4 ? launch_form<4, BF>(a, lanes, per_lane, s)
                : launch_form<1, BF>(a, lanes, per_lane, s);
}

// out (int[4]) = {C, slabs, rows a CTA, lanes a row} of the launch for k x
// n at `slab` in the vector form `vec` (0 scalar, 1 four elements a
// vector, 2 eight: the bf16 form's 16-byte vector), of the f32 or the bf16
// form.
int shape_of(int k, int n, int slab, int vec, bool bf16, void* out) {
  const int width = n > 0 && k >= 0 ? slab_width(k, n, slab) : -1;
  if (width < 1 || vec < 0 || vec > (bf16 ? 2 : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int lanes = 0;
  int per_lane = 0;
  lanes_for(width, vec == 2 ? 8 : vec == 1 ? 4 : 1, &lanes, &per_lane);
  int* shape = static_cast<int*>(out);
  shape[0] = width;
  shape[1] = (n + width - 1) / width;
  shape[2] = WARPS * 32 / lanes;
  shape[3] = lanes;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cols, vals (m x slots), tail_ptr (m + 1), tail_cols, tail_vals, x (k x n),
// y (m x n), m, k, slots, n, slab (0: slab_width's rule; else a power of two
// from 8 to 512 or n, for sweeps and tests), stream. 0 or the CUDA error.
extern "C" int spgrid_dgell(const void* cols, const void* vals,
                            const void* tail_ptr, const void* tail_cols,
                            const void* tail_vals, const void* x, void* y,
                            int m, int k, int slots, int n, int slab,
                            void* stream) {
  return run<false>(cols, vals, tail_ptr, tail_cols, tail_vals, x, y, m, k,
                    slots, n, slab, stream);
}

// The bf16 form: x and y as bf16 bit patterns, the values f32; the same
// arguments.
extern "C" int spgrid_dgell_bf16(const void* cols, const void* vals,
                                 const void* tail_ptr, const void* tail_cols,
                                 const void* tail_vals, const void* x,
                                 void* y, int m, int k, int slots, int n,
                                 int slab, void* stream) {
  return run<true>(cols, vals, tail_ptr, tail_cols, tail_vals, x, y, m, k,
                   slots, n, slab, stream);
}

// out (int[4]) = {C, slabs, rows a CTA, lanes a row} of spgrid_dgell's
// launch for k x n at `slab` in the float4 form (vec 1) or the scalar form
// (vec 0).
extern "C" int spgrid_dgell_shape(int k, int n, int slab, int vec, void* out) {
  return shape_of(k, n, slab, vec, false, out);
}

// The same for spgrid_dgell_bf16's launch (vec 2: the 16-byte vector form,
// 1: the 8-byte one, 0: the scalar one).
extern "C" int spgrid_dgell_bf16_shape(int k, int n, int slab, int vec,
                                       void* out) {
  return shape_of(k, n, slab, vec, true, out);
}
