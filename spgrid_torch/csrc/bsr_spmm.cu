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
// Design (the tile of block_mma.cuh):
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
#include "block_mma.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, 2)
bsr_spmm_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cols,
                const float* __restrict__ blocks, const float* __restrict__ x,
                float* __restrict__ y, int bm, int bk, int m, int k, int n,
                int slices, int col_tiles, bool a16, bool x16, bool y16) {
  extern __shared__ float4 smem4[];
  float* sb = reinterpret_cast<float*>(smem4);  // split X slice
  float* ring = sb + 2 * SB_FLOATS;
  const Frag f = frag();
  const int ranks = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int tile = blockIdx.x / ranks;
  const int n0 = tile % col_tiles * NT;
  const int i0 = tile / col_tiles % slices * ROWS;  // first row in the block
  const int r = tile / col_tiles / slices;          // block row
  const int rows = min(ROWS, bm - i0);
  const int ncols = min(NT, n - n0);
  const int begin = row_ptr[r];
  const int nq = (bk + TK - 1) / TK;  // steps a block
  const long long total = static_cast<long long>(row_ptr[r + 1] - begin) * nq;
  const long long s0 = total * rank / ranks;
  const int steps = static_cast<int>(total * (rank + 1) / ranks - s0);

  auto issue = [&](int it, float* as) {
    const long long s = s0 + it;
    const int b = begin + static_cast<int>(s / nq);
    const int k0 = static_cast<int>(s % nq) * TK;
    const long long xr0 = static_cast<long long>(cols[b]) * bk + k0;
    const long long x_left = static_cast<long long>(k) - xr0;
    const int depth = min(TK, bk - k0);
    const int x_depth = x_left < depth ? static_cast<int>(max(x_left, 0LL))
                                       : depth;
    stage_kmajor(as, blocks + (static_cast<size_t>(b) * bm + i0) * bk + k0,
                 bk, rows, depth, rows > 64 ? ROWS : 64, a16);
    stage_nmajor(as + A_FLOATS, x + static_cast<size_t>(xr0) * n + n0, n,
                 x_depth, ncols, x16);
  };
  float acc[NT / 2] = {};
  mainloop(acc, ring, sb, steps, rows, f, issue,
           [](const float* xs, float* to) { split_nmajor(xs, to); });

  const long long row0 = static_cast<long long>(r) * bm + i0;
  const int out_rows = static_cast<int>(
      min(static_cast<long long>(rows), static_cast<long long>(m) - row0));
  reduce_store(acc, ring, out_rows, ncols, f,
               [&](int i, int j, const float4& v) {
                 float* p = y + static_cast<size_t>(row0 + i) * n + n0 + j;
                 if (y16) {  // ncols % 4 == 0
                   *reinterpret_cast<float4*>(p) = v;
                   return;
                 }
                 const float w[4] = {v.x, v.y, v.z, v.w};
                 for (int c = 0; c < 4 && j + c < ncols; ++c) p[c] = w[c];
               });
}

// The tiles of a launch: block rows x 128-row slices x 64-column tiles.
long long spmm_tiles(int mb, int bm, int n) {
  return static_cast<long long>(mb) * ((bm + ROWS - 1) / ROWS) *
         ((n + NT - 1) / NT);
}

}  // namespace

// out (int[6]) = {tiles, cluster, ROWS, NT, TK, STAGES} of the launch
// spgrid_bsr_spmm makes for these sizes at cluster 0 on the current card.
extern "C" int spgrid_bsr_spmm_shape(int mb, int bm, int n, void* out) {
  if (mb <= 0 || bm <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return report_shape(spmm_tiles(mb, bm, n), out);
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
      bsr_spmm_kernel, spmm_tiles(mb, bm, n), cluster, stream,
      static_cast<const int*>(row_ptr), static_cast<const int*>(cols),
      static_cast<const float*>(blocks), static_cast<const float*>(x),
      static_cast<float*>(y), bm, bk, m, k, n, (bm + ROWS - 1) / ROWS,
      (n + NT - 1) / NT, bk % 4 == 0 && aligned16(blocks),
      n % 4 == 0 && aligned16(x), n % 4 == 0 && aligned16(y));
}

extern "C" const char* spgrid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
