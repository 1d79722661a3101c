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
//
// The bf16 form (the Pallas kernel at dtype bf16, bsr_spmm_cstat.py:127-139:
// a bf16 block times the bf16 X tile, one dot into f32 a block, added to the
// band's f32 slab in block order; Y rounded once, :190): the same CTAs and
// slot walk at NT = 64 on the bf16 step of bf16_mma.cuh, as bsr_spmm.cu's
// bf16 form runs it: a step is BF_TK = 64 columns of one block, the block's
// slice staged swizzled (K-major, as it lies) and X's (64 x 64) slice
// N-major through a cp.async ring of BF_STAGES, and the product runs
// transposed (Y^T = X^T A^T: X^T from registers, the block from shared
// memory), each warpgroup 64 rows of the block by the tile's 64 columns.
// Each block's product goes to its own f32 sum (its steps from fresh
// accumulators, added in f32), and that sum is added into the slice's f32
// slab in shared memory at the block's window once the block ends: the
// slab's every element gets its blocks' sums in the layout's order, as the
// Pallas kernel's out_ref[win] += acc does. Each element of Y is rounded to
// bf16 once, from the slab. Bound on the H100: the bytes of the bf16 blocks,
// X and Y once, or the blocks' dense work at 989 TFLOP/s, whichever is
// larger.
//
// The 3-pass form, 4c (the Pallas body's dot, bsr_spmm_cstat.py:136, at
// matmul precision 'high': each f32 block times its X tile as A_hi X_hi +
// A_hi X_lo + A_lo X_hi, added into the band's f32 slab in block order).
// Bound on the H100: the bytes of the function (the f32 blocks and X read
// once, Y written once) at 3.35 TB/s, or three times the blocks' dense
// work at 989 TFLOP/s, whichever is larger; the split planes are scratch
// of this design, written and read on top of that. Design: a split pass
// (bf16x3.cuh's `split_pair`) writes the blocks and X once as bf16 hi and
// lo planes, zero past bk and n; then 4b's walk (`slab_walk`: its CTAs,
// slot walk by the slots' band-local block rows, ring and slab), each
// stage holding the block's hi and lo slices and X's hi and lo slices. A step
// runs the transposed product three times (`mma_step_x3`): X_hi^T A_hi^T
// into fresh accumulators added to the block's hi sum, X_hi^T A_lo^T and
// X_lo^T A_hi^T straight into its cross sum (as 3c's cross sum); at the
// block's end cross + hi goes into the slab at its window. Y in f32 from
// the slab, each element once. One CTA an SM (the ring of 50 KB stages and
// the slab: 189,440 bytes).
#include "bf16x3.cuh"

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BM_MAX = 128;    // rows of a block (and of a row slice)

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

// The bf16 form's slab: the slice's per * bm rows of NT (= 64) f32 sums, in
// shared memory after the ring; a row stride of NT + 4 floats puts the
// flushes of a warp's 32 lanes on 32 banks.
constexpr int BF_S_LD = NT + 4;
constexpr size_t BF_SMEM_BYTES = BF_STAGES * RowStage<true>::BYTES +
                                 SWIZZLE_BYTES +
                                 sizeof(float) * BM_MAX * BF_S_LD;

// slab rows window * bm + r (r < bm) += the block sums v, laid out as the
// transposed product's accumulators (4 j + 2 h + c: row 64 wg + 8 j + 2 q +
// c of the block, column 16 w + 8 h + g of the tile); v restarts at zero.
// Each element of a window belongs to one thread: no barrier, no atomics.
__device__ __forceinline__ void add_block(float (&v)[NT / 2], float* slab,
                                          int window, int bm, const Frag& f) {
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = 64 * f.wg + 8 * j + 2 * f.q + c;
        float& e = v[4 * j + 2 * h + c];
        if (r < bm) {
          slab[(window * bm + r) * BF_S_LD + 16 * f.w + 8 * h + f.g] += e;
        }
        e = 0.0f;
      }
}

// A CTA of the bf16 forms' launch: band `band`, its block rows r0 .. r0 +
// per - 1 (a slice), Y's columns n0 .. n0 + ncols - 1.
struct SlabCta {
  int band, r0, n0, ncols;
};

__device__ __forceinline__ SlabCta slab_cta(int n, int per, int slices) {
  const int n0 = blockIdx.y * NT;
  return SlabCta{static_cast<int>(blockIdx.x) / slices,
                 static_cast<int>(blockIdx.x) % slices * per, n0,
                 min(NT, n - n0)};
}

// The bf16 forms' walk, 4b's and 4c's (see the top of this file): the
// slice's slab zeroed; the band's slots whose local block rows lie in the
// slice, a block BF_TK columns a step, through a cp.async ring of
// BF_STAGES stages of STAGE_BYTES; then Y from the slab, each element
// once. The form supplies a step's copies, load(st, slot, k0, xr0) (block
// `slot`'s columns k0 on and X's rows xr0 on into stage st), its product,
// step(st) (the warpgroups that hold block rows), the close of a block,
// close(window) (its sums into the slab at block row `window` of the
// slice, restarting them), and Y's store, store(row, j, v) (Y row `row`,
// the tile's columns j .. j + 3 from v, j < ncols).
template <int STAGE_BYTES, class Load, class Step, class Close, class Store>
__device__ __forceinline__ void slab_walk(
    const SlabCta& c, const int* __restrict__ counts,
    const int* __restrict__ lrows, const int* __restrict__ cols,
    unsigned char* ring, float* slab, int max_nb, int band_rows, int bm,
    int bk, int m, int per, const Frag& f, Load load, Step step, Close close,
    Store store) {
  __shared__ int meta[BF_STAGES];   // window of each step's block; -1: none
  __shared__ int opens[BF_STAGES];  // 1 where the step is its block's first
  const int t = threadIdx.x;
  const int nq = (bk + BF_TK - 1) / BF_TK;  // steps a block
  const int end = c.band * max_nb + counts[c.band];
  for (int e = t; e < per * bm * BF_S_LD; e += THREADS) slab[e] = 0.0f;

  // The loads' cursor: slot ls, its step lq. Every thread keeps the same.
  int ls = next_slot(lrows, c.band * max_nb, end, c.r0, per);
  int lq = 0;
  auto issue = [&](int stage) {
    unsigned char* st = ring + stage * STAGE_BYTES;
    if (ls >= end) {
      if (t == 0) meta[stage] = -1;
      return;
    }
    const int k0 = lq * BF_TK;
    load(st, ls, k0, static_cast<long long>(cols[ls]) * bk + k0);
    if (t == 0) {
      meta[stage] = lrows[ls] - c.r0;
      opens[stage] = lq == 0;
    }
    if (++lq == nq) {
      lq = 0;
      ls = next_slot(lrows, ls + 1, end, c.r0, per);
    }
  };

#pragma unroll
  for (int s = 0; s < BF_STAGES - 1; ++s) {
    issue(s);
    cp_async_commit();
  }
  int window = -1;  // the block row of the current block's sums
  for (int it = 0;; ++it) {
    cp_async_wait<BF_STAGES - 2>();
    fence_proxy_async();  // the copies land before the tensor cores read
    __syncthreads();      // step it has landed; step it - 1 is consumed
    const int stage = it % BF_STAGES;
    const int w = meta[stage];
    if (w < 0) break;  // the same for every thread of the CTA
    const bool first = opens[stage] != 0;
    issue((it + BF_STAGES - 1) % BF_STAGES);
    cp_async_commit();
    if (first && window >= 0) close(window);
    window = w;
    if (64 * f.wg < bm) step(ring + stage * STAGE_BYTES);
  }
  cp_async_wait<0>();
  if (window >= 0) close(window);
  __syncthreads();  // every block's sums are in the slab

  const long long row0 = static_cast<long long>(c.band) * band_rows +
                         static_cast<long long>(c.r0) * bm;
  const long long left = static_cast<long long>(m) - row0;
  const int slice_rows = min(per, band_rows / bm - c.r0) * bm;
  const int rows = left < slice_rows ? static_cast<int>(left) : slice_rows;
  for (int e = t; e < rows * (NT / 4); e += THREADS) {
    const int i = e / (NT / 4);
    const int j = e % (NT / 4) * 4;
    if (j < c.ncols) {
      store(static_cast<size_t>(row0 + i), j,
            *reinterpret_cast<const float4*>(slab + i * BF_S_LD + j));
    }
  }
}

// 4b: bf16 blocks and X, Y rounded once from the slab.
__global__ void __launch_bounds__(THREADS, 2)
bsr_spmm_cstat_bf16_kernel(const int* __restrict__ counts,
                           const int* __restrict__ lrows,
                           const int* __restrict__ cols,
                           const unsigned short* __restrict__ blocks,
                           const unsigned short* __restrict__ x,
                           unsigned short* __restrict__ y, int max_nb,
                           int band_rows, int bm, int bk, int m, int k, int n,
                           int per, int slices, bool a16, bool x16, bool y8) {
  using Stage = RowStage<true>;
  unsigned char* ring = aligned_ring();
  float* slab = reinterpret_cast<float*>(ring + BF_STAGES * Stage::BYTES);
  const SlabCta c = slab_cta(n, per, slices);
  const Frag f = frag();
  const int fill = bm > 64 ? ROWS : 64;  // block rows wgmma reads
  float blk[NT / 2] = {};                // the current block's sums
  slab_walk<Stage::BYTES>(
      c, counts, lrows, cols, ring, slab, max_nb, band_rows, bm, bk, m, per,
      f,
      [&](unsigned char* st, int ls, int k0, long long xr0) {
        const int depth = min(BF_TK, bk - k0);
        const long long x_left = static_cast<long long>(k) - xr0;
        const int x_depth = x_left < depth
                                ? static_cast<int>(max(x_left, 0LL))
                                : depth;
        stage_panel(st, blocks + static_cast<size_t>(ls) * bm * bk + k0, bk,
                    bm, depth, fill, a16);
        stage_nmajor_bf16(reinterpret_cast<unsigned short*>(st + PANEL_BYTES),
                          x + static_cast<size_t>(xr0) * n + c.n0, n, x_depth,
                          c.ncols, x16);
      },
      [&](const unsigned char* st) {
        StepFrags a;
        xt_frags(a, reinterpret_cast<const unsigned short*>(st + PANEL_BYTES),
                 f);
        mma_step(blk, a, descriptor_sw128(st + f.wg * 64 * 128));
      },
      [&](int window) { add_block(blk, slab, window, bm, f); },
      [&](size_t row, int j, const float4& v) {
        store_bf16x4(y + row * n + c.n0 + j, v, c.ncols - j, y8);
      });
}

// ---- The 3-pass form, 4c (see the top of this file).

// A stage: the block's hi and lo (128 x 64) slices, swizzled, then X's hi
// and lo (64 x 64) slices, N-major (row stride XH_LD).
constexpr int X3C_X_BYTES = BF_TK * XH_LD * 2;
constexpr int X3C_STAGE_BYTES = 2 * PANEL_BYTES + 2 * X3C_X_BYTES;
constexpr size_t X3C_SMEM = BF_STAGES * X3C_STAGE_BYTES + SWIZZLE_BYTES +
                            sizeof(float) * BM_MAX * BF_S_LD;
static_assert(X3C_STAGE_BYTES % SWIZZLE_BYTES == 0,
              "every stage's block slices start on a swizzle atom");
static_assert(X3C_SMEM <= 232448, "one CTA an SM");

// A step of the transposed product in three bf16 passes: hi += X_hi^T
// A_hi^T (four wgmma m64n64k16 into fresh accumulators, added in f32) and
// cross += X_hi^T A_lo^T + X_lo^T A_hi^T (straight into the cross sum).
__device__ __forceinline__ void mma_step_x3(float (&hi)[NT / 2],
                                            float (&cross)[NT / 2],
                                            StepFrags& xh, StepFrags& xl,
                                            uint64_t bh, uint64_t bl) {
  float d[NT / 2];
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < BF_TK / 16; ++s) {
    wgmma_bf16(d, xh[s], bh + 32 / 16 * s, s > 0);
  }
#pragma unroll
  for (int s = 0; s < BF_TK / 16; ++s) {
    wgmma_bf16(cross, xh[s], bl + 32 / 16 * s, 1);
    wgmma_bf16(cross, xl[s], bh + 32 / 16 * s, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int s = 0; s < BF_TK / 16; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      fence_operand(xh[s][e]);
      fence_operand(xl[s][e]);
    }
#pragma unroll
  for (int e = 0; e < NT / 2; ++e) {
    fence_operand(d[e]);
    fence_operand(cross[e]);
    hi[e] += d[e];
  }
}

// The block's sum, cross + hi as the plain version adds them, into its
// window of the slab (add_block); both restart at zero.
__device__ __forceinline__ void add_block_x3(float (&hi)[NT / 2],
                                             float (&cross)[NT / 2],
                                             float* slab, int window, int bm,
                                             const Frag& f) {
#pragma unroll
  for (int e = 0; e < NT / 2; ++e) {
    cross[e] += hi[e];
    hi[e] = 0.0f;
  }
  add_block(cross, slab, window, bm, f);
}

// 4c: slab_walk on split planes, the blocks' hi and lo planes (a_hi,
// a_lo: slot s's row i at row s bm + i, dpa columns) and X's (x_hi, x_lo:
// dpx columns), both zero past their widths; Y in f32.
__global__ void __launch_bounds__(THREADS, 1)
bsr_spmm_cstat_bf16x3_kernel(const int* __restrict__ counts,
                             const int* __restrict__ lrows,
                             const int* __restrict__ cols,
                             const unsigned short* __restrict__ a_hi,
                             const unsigned short* __restrict__ a_lo,
                             const unsigned short* __restrict__ x_hi,
                             const unsigned short* __restrict__ x_lo,
                             float* __restrict__ y, int max_nb,
                             int band_rows, int bm, int bk, int dpa, int dpx,
                             int m, int k, int n, int per, int slices,
                             bool y16) {
  unsigned char* ring = aligned_ring();
  float* slab = reinterpret_cast<float*>(ring + BF_STAGES * X3C_STAGE_BYTES);
  const SlabCta c = slab_cta(n, per, slices);
  const Frag f = frag();
  const int fill = bm > 64 ? ROWS : 64;  // block rows wgmma reads
  float hi[NT / 2] = {};                 // the current block's hi sums
  float cross[NT / 2] = {};              // and its cross sums
  slab_walk<X3C_STAGE_BYTES>(
      c, counts, lrows, cols, ring, slab, max_nb, band_rows, bm, bk, m, per,
      f,
      [&](unsigned char* st, int ls, int k0, long long xr0) {
        const long long x_left = static_cast<long long>(k) - xr0;
        const int x_depth = x_left < BF_TK
                                ? static_cast<int>(max(x_left, 0LL))
                                : BF_TK;
        // the planes are zero past bk and n: whole 16-byte lines throughout
        const size_t a_at = static_cast<size_t>(ls) * bm * dpa + k0;
        stage_panel(st, a_hi + a_at, dpa, bm, BF_TK, fill, true);
        stage_panel(st + PANEL_BYTES, a_lo + a_at, dpa, bm, BF_TK, fill,
                    true);
        const size_t x_at = static_cast<size_t>(xr0) * dpx + c.n0;
        unsigned short* xs =
            reinterpret_cast<unsigned short*>(st + 2 * PANEL_BYTES);
        stage_nmajor_bf16(xs, x_hi + x_at, dpx, x_depth, NT, true);
        stage_nmajor_bf16(xs + BF_TK * XH_LD, x_lo + x_at, dpx, x_depth, NT,
                          true);
      },
      [&](const unsigned char* st) {
        const unsigned short* xs =
            reinterpret_cast<const unsigned short*>(st + 2 * PANEL_BYTES);
        StepFrags xh, xl;
        xt_frags(xh, xs, f);
        xt_frags(xl, xs + BF_TK * XH_LD, f);
        mma_step_x3(hi, cross, xh, xl, descriptor_sw128(st + f.wg * 64 * 128),
                    descriptor_sw128(st + PANEL_BYTES + f.wg * 64 * 128));
      },
      [&](int window) { add_block_x3(hi, cross, slab, window, bm, f); },
      [&](size_t row, int j, const float4& v) {
        float* p = y + row * n + c.n0 + j;
        if (y16) {  // ncols % 4 == 0
          *reinterpret_cast<float4*>(p) = v;
          return;
        }
        const float w[4] = {v.x, v.y, v.z, v.w};
        for (int i = 0; i < 4 && j + i < c.ncols; ++i) p[i] = w[i];
      });
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

int launch_bf16(const void* counts, const void* lrows, const void* cols,
                const void* blocks, const void* x, void* y, int bands,
                int max_nb, int band_rows, int bm, int bk, int m, int k,
                int n, void* stream) {
  const int per = BM_MAX / bm;
  const int slices = (band_rows / bm + per - 1) / per;
  const cudaError_t attr = cudaFuncSetAttribute(
      bsr_spmm_cstat_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(BF_SMEM_BYTES));
  if (attr != cudaSuccess) {
    cudaGetLastError();  // clear it, so that the next launch's check is clean
    return static_cast<int>(attr);
  }
  const dim3 grid(bands * slices, (n + NT - 1) / NT);
  bsr_spmm_cstat_bf16_kernel<<<grid, THREADS, BF_SMEM_BYTES,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), static_cast<const int*>(lrows),
      static_cast<const int*>(cols),
      static_cast<const unsigned short*>(blocks),
      static_cast<const unsigned short*>(x), static_cast<unsigned short*>(y),
      max_nb, band_rows, bm, bk, m, k, n, per, slices,
      bk % 8 == 0 && aligned16(blocks), n % 8 == 0 && aligned16(x),
      n % 4 == 0 && aligned8(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (int[3]) = {CTAs, output columns a CTA, rows a CTA's slice} of the
// launch spgrid_bsr_spmm_cstat_bf16 makes for these sizes: NT = 64.
extern "C" int spgrid_bsr_spmm_cstat_bf16_shape(int bands, int band_rows,
                                                int bm, int n, void* out) {
  if (bm > BM_MAX || bm <= 0 || band_rows % bm != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per = BM_MAX / bm;
  int* shape = static_cast<int*>(out);
  shape[0] = bands * ((band_rows / bm + per - 1) / per) * ((n + NT - 1) / NT);
  shape[1] = NT;
  shape[2] = per * bm;
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form: blocks, x and y as bf16 bit patterns; the same arguments.
extern "C" int spgrid_bsr_spmm_cstat_bf16(const void* counts,
                                          const void* lrows, const void* cols,
                                          const void* blocks, const void* x,
                                          void* y, int bands, int max_nb,
                                          int band_rows, int bm, int bk,
                                          int m, int k, int n,
                                          void* stream) {
  if (bm > BM_MAX || bm <= 0 || bk <= 0 || band_rows % bm != 0 ||
      (n + NT - 1) / NT > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_bf16(counts, lrows, cols, blocks, x, y, bands, max_nb,
                     band_rows, bm, bk, m, k, n, stream);
}

// out (int[3]) = {CTAs, output columns a CTA, rows a CTA's slice} of the
// launch spgrid_bsr_spmm_cstat_bf16x3 makes for these sizes (NT = 64);
// scratch (long long[1]) = the bytes of its split planes: the slots'
// blocks (bands max_nb bm rows of bk), then X's (k rows of n).
extern "C" int spgrid_bsr_spmm_cstat_bf16x3_shape(int bands, int max_nb,
                                                  int band_rows, int bm,
                                                  int bk, int k, int n,
                                                  void* out, void* scratch) {
  if (bm > BM_MAX || bm <= 0 || bk <= 0 || band_rows % bm != 0 ||
      bands <= 0 || max_nb <= 0 || k < 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *static_cast<long long*>(scratch) =
      plane_pair_bytes(static_cast<long long>(bands) * max_nb * bm, bk) +
      plane_pair_bytes(plane_rows(k), n);
  return spgrid_bsr_spmm_cstat_bf16_shape(bands, band_rows, bm, n, out);
}

// 4c: blocks, x and y in f32 at matmul precision 'high', the same
// arguments as spgrid_bsr_spmm_cstat and scratch (on 16 B) the bytes
// spgrid_bsr_spmm_cstat_bf16x3_shape reports. Two launches: the split pass
// (the blocks and X), then the slab kernel.
extern "C" int spgrid_bsr_spmm_cstat_bf16x3(const void* counts,
                                            const void* lrows,
                                            const void* cols,
                                            const void* blocks, const void* x,
                                            void* y, void* scratch, int bands,
                                            int max_nb, int band_rows, int bm,
                                            int bk, int m, int k, int n,
                                            void* stream) {
  const long long rows = static_cast<long long>(bands) * max_nb * bm;
  if (bm > BM_MAX || bm <= 0 || bk <= 0 || band_rows % bm != 0 ||
      bands <= 0 || max_nb <= 0 || k < 0 || n <= 0 || rows > INT_MAX ||
      (n + NT - 1) / NT > 65535 || !aligned16(scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int split = split_pair(blocks, static_cast<int>(rows), bk, x, k, n,
                               scratch, stream);
  if (split != 0) return split;
  const long long dpa = plane_cols(bk);
  const long long dpx = plane_cols(n);
  const unsigned short* a_hi = static_cast<const unsigned short*>(scratch);
  const unsigned short* x_hi = a_hi + 2 * rows * dpa;
  const cudaError_t attr = cudaFuncSetAttribute(
      bsr_spmm_cstat_bf16x3_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(X3C_SMEM));
  if (attr != cudaSuccess) {
    cudaGetLastError();  // clear it, so that the next launch's check is clean
    return static_cast<int>(attr);
  }
  const int per = BM_MAX / bm;
  const int slices = (band_rows / bm + per - 1) / per;
  const dim3 grid(bands * slices, (n + NT - 1) / NT);
  bsr_spmm_cstat_bf16x3_kernel<<<grid, THREADS, X3C_SMEM,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), static_cast<const int*>(lrows),
      static_cast<const int*>(cols), a_hi, a_hi + rows * dpa, x_hi,
      x_hi + plane_rows(k) * dpx, static_cast<float*>(y), max_nb, band_rows,
      bm, bk, static_cast<int>(dpa), static_cast<int>(dpx), m, k, n, per,
      slices, n % 4 == 0 && aligned16(y));
  return static_cast<int>(cudaGetLastError());
}

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
