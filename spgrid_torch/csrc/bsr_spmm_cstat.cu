// C-stationary block-sparse SpMM, Y = A @ X with A in DeviceBSRCol layout.
//
// Replaces: spgrid/ops/pallas/bsr_spmm_cstat.py:127, _kernel (called by
// _bsr_spmm_cstat; the Pallas TPU kernel behind `bsrc_pallas`). What the TPU
// kernel keeps out of device memory: each band's output slab is accumulated
// on chip and written once, and a band's blocks are sorted by (block column,
// block row), so blocks of one column share their X tile.
//
// Bound on the H100: at the main path's 8192^2 matrix (316 blocks of 128^2,
// n = 512) the product needs its 413,698 nnz, X and Y once: ~37 MB, 11 us at
// 3.35 TB/s. A dense-block kernel does the blocks' full work, 316 x 128^2 x
// 512 x 2 = 5.30 GFLOP: 79 us on the f32 CUDA cores at 67 TFLOP/s, so it
// goes to the tensor cores. Plain TF32 keeps ~3 digits; the 3xTF32 split
// keeps f32's accuracy for 3 x 5.30 = 15.9 GFLOP, 32 us at 495 TFLOP/s. The
// blocks and X slices it stages come through L2: each block once for each
// column tile (83 MB at n = 512 in 128-column tiles) and an X slice for
// each block and tile (83 MB).
//
// Design:
// - Tensor cores, 3xTF32, by wgmma. v = hi + lo with hi = tf32(v) and lo =
//   tf32(v - hi), both rounded by cvt.rna.tf32.f32; for each 8 columns of a
//   block the products A_lo X_hi, then A_hi X_lo, then A_hi X_hi go into f32
//   accumulators (the dropped A_lo X_lo term is ~2^-22 of the product). Each
//   warpgroup issues wgmma.mma_async m64nNTk8 (tf32 in, f32 out) with A in
//   registers: its fragments are loaded from the staged block and split in
//   registers, each element by one thread. B must be K-major in shared
//   memory for tf32, so each step's X slice is split once, by all threads,
//   into X_hi and X_lo tiles of 8 x 16-byte core matrices (no swizzle): the
//   X slice transposed. With mma.sync m16n8k8 each warp splits its own copy
//   of the fragments (the X fragments four times over), and that split,
//   more than the tensor cores, limits the kernel (PERF.md, section 6).
// - The slab split across CTAs. One CTA per (band, row slice, NT output
//   columns): a row slice is P = 128 / bm whole block rows (R_s = P bm <=
//   128 rows; one block row at bm = 128). NT = 128 where that grid fills the
//   card at one CTA an SM (each block is then read n / 128 times); else NT =
//   64, two CTAs an SM, so that a small grid spreads over more SMs. At the
//   main path: 4 bands x 16 slices x 4 column tiles = 256 CTAs at NT = 128.
//   A CTA walks its band's counts[band] real slots, 32 local rows at a time
//   with a warp ballot, and takes those of its slice, in the layout's
//   (column, row) order. Two warpgroups cover a 128 x NT tile of a block's
//   product, 64 rows each (NT / 2 accumulators a thread). A thread keeps the
//   same (row, column) positions of every block, so the accumulators carry
//   over the blocks of one block row in registers, and when the slice's
//   block row changes (P > 1) they are added into the R_s x NT slab in
//   shared memory at the block's window, which no other thread touches: no
//   barrier, no atomics, an order fixed by the layout. At P = 1 there is no
//   slab: the accumulators are written once at the end. Every output
//   element of the slice is written once, zeros included (an empty band or
//   slice writes zeros); rows >= m and columns >= n are never written, and X
//   rows >= k read as zero. The tensor cores' f32 accumulate truncates, so
//   a step's products go to fresh accumulators (see `multiply` in
//   tf32x3.cuh, the step that block_mma.cuh's tile runs at NT = 64; the X
//   slice's split is its `split_nmajor`).
// - Asynchronous staging. A step is TK = 32 columns of one block and the
//   matching 32 x NT X slice; a ring of 4 steps at NT = 128 (175 KB with the
//   split X slice, one CTA an SM) or 3 at NT = 64 (99 KB, two CTAs an SM),
//   2 when the slab takes its room, keeps the next steps in flight with
//   cp.async while one is split and multiplied. Blocks are contiguous (bm,
//   bk) f32, staged 16 B a thread with neighbouring threads on neighbouring
//   addresses (cp.async.cg, through L2 only). X is staged the same way when
//   n % 4 == 0 and X starts on 16 B; otherwise (a ragged n, an operand at
//   an odd float) by 4-byte cp.async copies in the same kernel, as blocks
//   are when bk % 4 != 0. What a step does not copy (block rows >= bm that
//   the warpgroups read, columns past bk, X rows past the block or >= k,
//   columns >= n) is stored as zeros, so no step reads past a block and a bm
//   or bk off the wgmma shape multiplies by zero. Row strides of TK + 4 and
//   NT + 8 floats keep the fragment loads and the split's reads on distinct
//   banks.
#include "tf32x3.cuh"

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BM_MAX = 128;    // rows of a block (and of a row slice)
constexpr int A_FLOATS = BM_MAX * A_LD;

// What depends on the column tile NT (64 or 128, see spgrid_bsr_spmm_cstat).
template <int NT>
struct Tile {
  static constexpr int X_LD = n_major_ld<NT>;  // row stride of an X slice
  static constexpr int S_LD = NT + 8;  // row stride of the slab
  static constexpr int STAGE_FLOATS = A_FLOATS + TK * X_LD;
  // A step's split X slice, X_hi then X_lo, K-major in 8 x 16-byte core
  // matrices: [8 columns of X][TK / 4][8][4 rows of X].
  static constexpr int SB_FLOATS = NT * TK;
  static constexpr int ACC = NT / 2;          // accumulators a thread
  static constexpr int CTAS = 128 / NT;       // CTAs an SM
  static constexpr int STAGES = NT == 128 ? 4 : 3;  // 2 when there is a slab
};

// The first slot in [s, end) whose local block row lies in [r0, r0 + per);
// end if none. Warp-collective: every lane gets the same answer.
__device__ __forceinline__ int next_slot(const int* __restrict__ lrows, int s,
                                         int end, int r0, int per) {
  const int lane = threadIdx.x % 32;
  for (; s < end; s += 32) {
    const bool hit = s + lane < end &&
                     static_cast<unsigned>(lrows[s + lane] - r0) <
                         static_cast<unsigned>(per);
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (mask != 0) return s + __ffs(mask) - 1;
  }
  return end;
}

// slab rows window * bm + r (r < bm) get the accumulators (added, or stored
// when `add` is false); the accumulators restart at zero.
template <int NT>
__device__ __forceinline__ void flush(float (&acc)[Tile<NT>::ACC],
                                      float* slab, int window, int bm,
                                      bool add, const Frag& f) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * f.wg + 16 * f.w + 8 * h + f.g;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      acc[4 * j + 2 * h] = acc[4 * j + 2 * h + 1] = 0.0f;
      if (r >= bm) continue;
      float2* p = reinterpret_cast<float2*>(
          slab + (window * bm + r) * Tile<NT>::S_LD + 8 * j + 2 * f.q);
      if (add) {
        v.x += p->x;
        v.y += p->y;
      }
      *p = v;
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(THREADS, Tile<NT>::CTAS)
bsr_spmm_cstat_kernel(const int* __restrict__ counts,
                      const int* __restrict__ lrows,
                      const int* __restrict__ cols,
                      const float* __restrict__ blocks,
                      const float* __restrict__ x, float* __restrict__ y,
                      int max_nb, int band_rows, int bm, int bk, int m, int k,
                      int n, int per, int slices, bool a16, bool x16,
                      bool y16) {
  using T = Tile<NT>;
  extern __shared__ float4 smem4[];
  float* sb = reinterpret_cast<float*>(smem4);  // split X slice
  float* ring = sb + 2 * T::SB_FLOATS;
  __shared__ int meta[Tile<128>::STAGES];  // window of each step's block; -1: none
  const int stages = per > 1 ? 2 : T::STAGES;
  const int band = blockIdx.x / slices;
  const int r0 = (blockIdx.x % slices) * per;  // first block row of the slice
  const int n0 = blockIdx.y * NT;
  const int ncols = min(NT, n - n0);
  const int t = threadIdx.x;
  const Frag f = frag();
  const int rows_used = min(BM_MAX, (bm + 63) / 64 * 64);  // rows wgmma reads
  const int nq = (bk + TK - 1) / TK;                        // steps a block
  const int end = band * max_nb + counts[band];
  float* slab = per > 1 ? ring + stages * T::STAGE_FLOATS : ring;
  if (per > 1) {
    for (int e = t; e < per * bm * T::S_LD; e += THREADS) slab[e] = 0.0f;
  }

  // The loads' cursor: slot ls, its step lq. Every thread keeps the same.
  int ls = next_slot(lrows, band * max_nb, end, r0, per);
  int lq = 0;
  auto issue = [&](int stage) {
    float* as = ring + stage * T::STAGE_FLOATS;
    float* xs = as + A_FLOATS;
    if (ls >= end) {
      if (t == 0) meta[stage] = -1;
      return;
    }
    const int k0 = lq * TK;
    const int depth = min(TK, bk - k0);
    const float* blk = blocks + static_cast<size_t>(ls) * bm * bk + k0;
    const long long xr0 = static_cast<long long>(cols[ls]) * bk + k0;
    if (a16) {
      for (int e = t; e < rows_used * (TK / 4); e += THREADS) {
        const int i = e / (TK / 4);
        const int c = e % (TK / 4) * 4;
        float* dst = as + i * A_LD + c;
        if (i < bm && c < depth) {
          cp_async16(dst, blk + static_cast<size_t>(i) * bk + c);
        } else {
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    } else {
      for (int e = t; e < rows_used * TK; e += THREADS) {
        const int i = e / TK;
        const int c = e % TK;
        float* dst = as + i * A_LD + c;
        if (i < bm && c < depth) {
          cp_async4(dst, blk + static_cast<size_t>(i) * bk + c);
        } else {
          *dst = 0.0f;
        }
      }
    }
    if (x16) {
      for (int e = t; e < TK * (NT / 4); e += THREADS) {
        const int kk = e / (NT / 4);
        const int j = e % (NT / 4) * 4;
        float* dst = xs + kk * T::X_LD + j;
        if (kk < depth && xr0 + kk < k && j < ncols) {
          cp_async16(dst, x + static_cast<size_t>(xr0 + kk) * n + n0 + j);
        } else {
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    } else {
      for (int e = t; e < TK * NT; e += THREADS) {
        const int kk = e / NT;
        const int j = e % NT;
        float* dst = xs + kk * T::X_LD + j;
        if (kk < depth && xr0 + kk < k && j < ncols) {
          cp_async4(dst, x + static_cast<size_t>(xr0 + kk) * n + n0 + j);
        } else {
          *dst = 0.0f;
        }
      }
    }
    if (t == 0) meta[stage] = lrows[ls] - r0;
    if (++lq == nq) {
      lq = 0;
      ls = next_slot(lrows, ls + 1, end, r0, per);
    }
  };

  for (int s = 0; s < stages - 1; ++s) {
    issue(s);
    cp_async_commit();
  }
  float acc[T::ACC] = {};
  int window = -1;  // the block row the accumulators belong to
  for (int it = 0;; ++it) {
    if (stages == 4) {
      cp_async_wait<2>();
    } else if (stages == 3) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step it has landed; step it - 1 is consumed
    const int stage = it % stages;
    const int w = meta[stage];
    if (w < 0) break;  // the same for every thread of the CTA
    issue((it + stages - 1) % stages);
    cp_async_commit();
    if (w != window) {
      if (window >= 0) flush<NT>(acc, slab, window, bm, true, f);
      window = w;
    }
    const float* as = ring + stage * T::STAGE_FLOATS;
    split_nmajor<NT>(as + A_FLOATS, sb);
    fence_proxy_async();
    __syncthreads();  // the split X slice is in place
    if (64 * f.wg < bm) multiply<NT>(acc, as, sb, f);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free (at per == 1 it becomes the slab)
  if (per == 1) {
    flush<NT>(acc, slab, 0, bm, false, f);
  } else if (window >= 0) {
    flush<NT>(acc, slab, window, bm, true, f);
  }
  __syncthreads();

  const long long row0 = static_cast<long long>(band) * band_rows +
                         static_cast<long long>(r0) * bm;
  const long long left = static_cast<long long>(m) - row0;
  const int slice_rows = min(per, band_rows / bm - r0) * bm;
  const int rows = left < slice_rows ? static_cast<int>(left) : slice_rows;
  if (y16) {  // ncols % 4 == 0
    for (int e = t; e < rows * (NT / 4); e += THREADS) {
      const int i = e / (NT / 4);
      const int j = e % (NT / 4) * 4;
      if (j < ncols) {
        *reinterpret_cast<float4*>(y + static_cast<size_t>(row0 + i) * n +
                                   n0 + j) =
            *reinterpret_cast<const float4*>(slab + i * T::S_LD + j);
      }
    }
  } else {
    for (int e = t; e < rows * NT; e += THREADS) {
      const int i = e / NT;
      const int j = e % NT;
      if (j < ncols) {
        y[static_cast<size_t>(row0 + i) * n + n0 + j] = slab[i * T::S_LD + j];
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The launch's shape: {CTAs, NT, rows of a slice}. NT = 128 where its grid
// fills the card at one CTA an SM: each block is then read half as often.
// Else NT = 64, two CTAs an SM, so a small grid spreads over more SMs.
void launch_shape(int bands, int band_rows, int bm, int n, int (&shape)[3]) {
  int device = 0;
  int sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int per = BM_MAX / bm;  // block rows a slice
  const int ctas = bands * ((band_rows / bm + per - 1) / per);
  const int nt = ctas * ((n + 127) / 128) >= sms ? 128 : 64;
  shape[0] = ctas * ((n + nt - 1) / nt);
  shape[1] = nt;
  shape[2] = per * bm;
}

template <int NT>
int launch(const void* counts, const void* lrows, const void* cols,
           const void* blocks, const void* x, void* y, int bands, int max_nb,
           int band_rows, int bm, int bk, int m, int k, int n, void* stream) {
  using T = Tile<NT>;
  const int per = BM_MAX / bm;
  const int slices = (band_rows / bm + per - 1) / per;
  const int stages = per > 1 ? 2 : T::STAGES;  // as the kernel sets it
  const size_t smem =
      sizeof(float) *
      (2 * T::SB_FLOATS + stages * static_cast<size_t>(T::STAGE_FLOATS) +
       (per > 1 ? static_cast<size_t>(per) * bm * T::S_LD : 0));
  const cudaError_t attr = cudaFuncSetAttribute(
      bsr_spmm_cstat_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) {
    cudaGetLastError();  // clear it, so that the next launch's check is clean
    return static_cast<int>(attr);
  }
  const dim3 grid(bands * slices, (n + NT - 1) / NT);
  bsr_spmm_cstat_kernel<NT><<<grid, THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), static_cast<const int*>(lrows),
      static_cast<const int*>(cols), static_cast<const float*>(blocks),
      static_cast<const float*>(x), static_cast<float*>(y), max_nb, band_rows,
      bm, bk, m, k, n, per, slices, bk % 4 == 0 && aligned16(blocks),
      n % 4 == 0 && aligned16(x), n % 4 == 0 && aligned16(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (int[3]) = {CTAs, output columns a CTA, rows a CTA's slice} of the
// launch spgrid_bsr_spmm_cstat makes for these sizes.
extern "C" int spgrid_bsr_spmm_cstat_shape(int bands, int band_rows, int bm,
                                           int n, void* out) {
  if (bm > BM_MAX || bm <= 0 || band_rows % bm != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  launch_shape(bands, band_rows, bm, n, *static_cast<int(*)[3]>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spgrid_bsr_spmm_cstat(const void* counts, const void* lrows,
                                     const void* cols, const void* blocks,
                                     const void* x, void* y, int bands,
                                     int max_nb, int band_rows, int bm,
                                     int bk, int m, int k, int n,
                                     void* stream) {
  if (bm > BM_MAX || bm <= 0 || bk <= 0 || band_rows % bm != 0 ||
      (n + 63) / 64 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int shape[3];
  launch_shape(bands, band_rows, bm, n, shape);
  return shape[1] == 128
             ? launch<128>(counts, lrows, cols, blocks, x, y, bands, max_nb,
                           band_rows, bm, bk, m, k, n, stream)
             : launch<64>(counts, lrows, cols, blocks, x, y, bands, max_nb,
                          band_rows, bm, bk, m, k, n, stream);
}
