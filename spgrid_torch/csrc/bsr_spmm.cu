// Block-sparse-row SpMM, Y = A @ X with A in DeviceBSR layout.
//
// Replaces: spgrid/ops/pallas/bsr_spmm.py, _kernel / _bsr_spmm (the Pallas
// TPU kernel behind `bsr_pallas` and every SpMM of the attention pipeline).
//
// Bound on the H100: a dense-block kernel does the blocks' full work,
// 2 nb bm bk n flops. At the main path's shapes (512 x 512, all 16 blocks
// of 128^2 stored, n = 512: the headline and the pipeline's weights) that
// is 0.27 GFLOP, 4 us on the f32 CUDA cores at 67 TFLOP/s, and three times
// as much in 3xTF32 on the tensor cores, 1.6 us at 495 TFLOP/s; A, X and Y
// (3 MB) sit in L2. The grid is what is short: 4 block rows x 8 column
// tiles of 64 is 32 tiles for 132 SMs, each a contraction of 16 steps.
//
// Design (the tile of block_mma.cuh, its `row_tile_spmm`, which
// panel_spmm.cu runs too):
// - One tile a (block row, slice of 128 of its rows, 64 columns of X): a
//   block row of bm <= 128 rows is one slice, a taller one runs as slices of
//   128 rows; below 64 rows one warpgroup multiplies. The tile's steps are
//   its block row's blocks (row_ptr, rebuilt from block_rows so that
//   empty block rows have none and pad blocks, at block row mb, are never
//   visited) times TK = 32 of each block's bk columns: a step stages the
//   block's (rows x 32) slice and X's (32 x 64) slice, which is split into
//   K-major TF32 hi and lo core matrices (X is N-major in device memory).
// - The tile's steps are split across a cluster of C CTAs, C the largest
//   power of two up to 8 for which tiles x C CTAs still fit on the card's
//   SMs (`cluster_for` in block_mma.cuh, from the grid and the SM count):
//   at the main path C = 4, 128 CTAs of 4 steps. The partial tiles are summed in rank
//   order through distributed shared memory and each element of Y is
//   written once, zeros included (an empty block row writes zeros), with no
//   atomics. Rows >= m and columns >= n are never written; X rows >= k read
//   as zero. Blocks and X are staged by 16-byte cp.async where bk % 4 == 0
//   (blocks) or n % 4 == 0 (X) and the operand starts on 16 bytes, else by
//   4-byte copies.
//
// Device time on the headline (NVIDIA H100 80GB HBM3, 700 W power limit):
// 0.0150 ms at cluster 4 (0.0320 at cluster 1), against 0.0313 for
// torch.sparse.mm; the f32 CUDA-core tile this design replaced, 64 CTAs of
// 32 unpipelined steps, took 0.0561 ms on the same card.
//
// The bf16 form (the Pallas kernel at dtype bf16: bf16 blocks and X, f32
// sums, Y rounded once to bf16): the bf16 tile of bf16_mma.cuh
// (`bf16_row_tile`, which the panel kernel's bf16 forms run too), a block
// row being a band whose blocks are its slots, row_ptr[r] .. row_ptr[r + 1]
// - 1. Bound on the H100 at the headline twin (16 blocks of 128^2, X and Y
// 512 x 512): 1,572,864 bytes of bf16 blocks, X and Y, 0.47 us at 3.35
// TB/s, above the blocks' 0.27 GFLOP at 989 TFLOP/s (0.27 us).
#include "bf16_mma.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, 2)
bsr_spmm_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cols,
                const float* __restrict__ blocks, const float* __restrict__ x,
                float* __restrict__ y, int bm, int bk, int m, int k, int n,
                int slices, int col_tiles, bool a16, bool x16, bool y16) {
  const RowTile t = row_tile(slices, col_tiles);
  row_tile_spmm(t, row_ptr[t.r], row_ptr[t.r + 1], cols, blocks, x, y, bm,
                bk, m, k, n, a16, x16, y16);
}

__global__ void __launch_bounds__(THREADS, 2)
bsr_spmm_bf16_kernel(const int* __restrict__ row_ptr,
                     const int* __restrict__ cols,
                     const unsigned short* __restrict__ blocks, const void* x,
                     void* y, int bm, int bk, int m, int k, int n, int slices,
                     int col_tiles, bool a16, bool x16, bool y16) {
  const RowTile t = row_tile(slices, col_tiles);
  const int first = row_ptr[t.r];
  bf16_row_tile<true>(t, first, row_ptr[t.r + 1] - first, nullptr, cols,
                      blocks, x, y, bm, bk, m, k, n, a16, x16, y16);
}

}  // namespace

// out (int[6]) = {tiles, cluster, ROWS, NT, TK, STAGES} of the launch
// spgrid_bsr_spmm makes for these sizes at cluster 0 on the current card.
extern "C" int spgrid_bsr_spmm_shape(int mb, int bm, int n, void* out) {
  if (mb <= 0 || bm <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return report_shape(row_tiles(mb, bm, n), out);
}

// cluster: 0 for the launch rule (cluster_for), else 1, 2, 4 or 8.
extern "C" int spgrid_bsr_spmm(const void* row_ptr, const void* cols,
                               const void* blocks, const void* x, void* y,
                               int mb, int bm, int bk, int m, int k, int n,
                               int cluster, void* stream) {
  if (mb <= 0 || bm <= 0 || bk <= 0 || m <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_clusters(
      bsr_spmm_kernel, row_tiles(mb, bm, n), cluster, stream,
      static_cast<const int*>(row_ptr), static_cast<const int*>(cols),
      static_cast<const float*>(blocks), static_cast<const float*>(x),
      static_cast<float*>(y), bm, bk, m, k, n, (bm + ROWS - 1) / ROWS,
      (n + NT - 1) / NT, bk % 4 == 0 && aligned16(blocks),
      n % 4 == 0 && aligned16(x), n % 4 == 0 && aligned16(y));
}

// out (int[6]) = {tiles, cluster, ROWS, NT, BF_TK, BF_STAGES} of the
// launch spgrid_bsr_spmm_bf16 makes for these sizes at cluster 0.
extern "C" int spgrid_bsr_spmm_bf16_shape(int mb, int bm, int n, void* out) {
  if (mb <= 0 || bm <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return report_shape(row_tiles(mb, bm, n), out, BF_TK, BF_STAGES);
}

// The bf16 form: blocks, X and Y as bf16 bit patterns. cluster: 0 for the
// launch rule (cluster_for), else 1, 2, 4 or 8.
extern "C" int spgrid_bsr_spmm_bf16(const void* row_ptr, const void* cols,
                                    const void* blocks, const void* x,
                                    void* y, int mb, int bm, int bk, int m,
                                    int k, int n, int cluster, void* stream) {
  if (mb <= 0 || bm <= 0 || bk <= 0 || m <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_tiles(
      bsr_spmm_bf16_kernel, row_tiles(mb, bm, n), cluster,
      RowStage<true>::SMEM, stream, static_cast<const int*>(row_ptr),
      static_cast<const int*>(cols),
      static_cast<const unsigned short*>(blocks), x, y, bm, bk, m, k, n,
      (bm + ROWS - 1) / ROWS, (n + NT - 1) / NT,
      bk % 8 == 0 && aligned16(blocks), n % 8 == 0 && aligned16(x),
      n % 4 == 0 && aligned8(y));
}

extern "C" const char* spgrid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
