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
// sums, Y rounded once to bf16) takes two routes, split by 128-row slice on
// the host when the layout is built (ops/layouts.py, `route_blocks`):
// - The entry route: a block row whose blocks hold at most T nonzero
//   entries a block on average (T = ENTRY_ROUTE_MAX below, scaled to the
//   block's area) gives its entries to a row stream (`slot_rows.
//   stream_order`: a bf16 value and an X row an entry, ordered by output
//   row, then block order, then column), which slot_rows.cuh's walk reads
//   over the listed rows: a warp a row, no shared memory, 32 warps an SM,
//   the products exact in f32 (one fmaf each), the sum in stream order,
//   each element of Y rounded once. Bound: the stream (6 bytes an entry),
//   an X row gathered an entry (mostly from L2), Y once.
// - The tile route: the other block rows' slices run the bf16 tile over
//   all their blocks: the pipelined tile of bf16_mma.cuh (`bf16_pipe_tile`:
//   TMA, a producer warpgroup, 128 columns of X, overlapped steps) where
//   TMA takes the operands (bk and n multiples of 8, blocks and X on 16
//   bytes), else the cp.async tile (`bf16_row_tile`, 64 columns). Bound:
//   the blocks' dense work, 2 bm bk n flops a block, at 989 TFLOP/s, or
//   their bytes.
// The two launches write disjoint rows of Y, each element once, rounded
// once, with no atomics; pad blocks (block row mb) are on neither route.
// A slice keeps one route for all its blocks: a first form that added the
// entries of a tile slice's near-empty blocks to the tile's output after
// its rank sum (a dependent chain of loads an element, after the last
// step) ran well behind the same slices all on the tile.
//
// The threshold T, entries a 128 x 128 block, from the sweep of
// chip_smoke.py's 11a (the run PERF.md section 6 names; NVIDIA H100 80GB
// HBM3, 700 W): one 8192^2 matrix, every block present, uniform random
// entries, n = 512, device ms by graph replay with each route forced:
//   entries a block  8.0    32.0   63.9   127.5  190.9  222.5  254.0  504.1
//   entry route      0.0088 0.0220 0.0391 0.0710 0.1071 0.1236 0.1773 0.2921
//   tile route       0.1550 0.1556 0.1550 0.1556 0.1556 0.1546 0.1558 0.1549
// The tile's time is flat (the blocks' dense work); the walk's grows with
// the entries and passes it between 222.5 and 254, where the rows (64
// blocks wide) pass the walk's LONG_ROW (128 entries) and go to the
// long-row walk. T = 224, past the last point at which the walk won.
#include "bf16_mma.cuh"
#include "slot_rows.cuh"

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

// The threshold T of the entry route: a block row of (bm, bk) blocks whose
// blocks hold at most T bm bk / 128^2 nonzero entries each on average
// takes the entry route (the host split, ops/layouts.py: ENTRY_ROUTE_MAX,
// held equal to this by tests/test_torch_block_route.py).
constexpr int ENTRY_ROUTE_MAX = 224;

// The tile route on the cp.async tile: a tile a (listed slice, 64 columns).
__global__ void __launch_bounds__(THREADS, 2)
bsr_spmm_bf16_kernel(const int* __restrict__ row_ptr,
                     const int* __restrict__ cols,
                     const unsigned short* __restrict__ blocks,
                     const int* __restrict__ tile_slices, const void* x,
                     void* y, int bm, int bk, int m, int k, int n, int slices,
                     int col_tiles, bool a16, bool x16, bool y16) {
  const RowTile t = listed_tile<NT>(tile_slices, slices, col_tiles);
  const int first = row_ptr[t.r];
  bf16_row_tile<true>(t, first, row_ptr[t.r + 1] - first, nullptr, cols,
                      blocks, x, y, bm, bk, m, k, n, a16, x16, y16);
}

// The tile route on the pipelined tile: a tile a (listed slice, 128
// columns).
__global__ void __launch_bounds__(PT_THREADS, 1)
bsr_spmm_bf16_pipe_kernel(const __grid_constant__ CUtensorMap a_map,
                          const __grid_constant__ CUtensorMap x_map,
                          const int* __restrict__ row_ptr,
                          const int* __restrict__ cols,
                          const int* __restrict__ tile_slices,
                          unsigned short* y, int bm, int bk, int m, int n,
                          int slices, int col_tiles, bool y16) {
  const RowTile t = listed_tile<PT_NT>(tile_slices, slices, col_tiles);
  const int first = row_ptr[t.r];
  bf16_pipe_tile(t, first, row_ptr[t.r + 1] - first, nullptr, cols, &a_map,
                 &x_map, y, bm, bk, m, n, y16);
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

// Whether the bf16 form's tile route runs the pipelined tile for these
// sizes (its operands on 16 bytes, as torch allocates them).
bool pipelined(int bk, int n) { return bk % 8 == 0 && n % 8 == 0; }

// out (int[6]) = {tiles, cluster, ROWS, cols, BF_TK, stages} of the tile
// route's launch spgrid_bsr_spmm_bf16 makes at cluster 0 for `slices`
// listed slices: 128 columns through PT_STAGES where the pipelined tile
// runs, else 64 through BF_STAGES.
extern "C" int spgrid_bsr_spmm_bf16_shape(int slices, int bk, int n,
                                          void* out) {
  if (slices <= 0 || bk <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pipelined(bk, n)) {
    return report_shape(pipe_tiles(slices, n), out, BF_TK, PT_STAGES, PT_NT,
                        PT_SHARE);
  }
  return report_shape(static_cast<long long>(slices) * ((n + NT - 1) / NT),
                      out, BF_TK, BF_STAGES);
}

// The bf16 form's tile route: blocks, X and Y as bf16 bit patterns; the
// slices tile_slices[0 .. num_slices - 1] (slice s: block row s / slices,
// its rows (s % slices) 128 on, slices = ceil(bm / 128)), each over its
// block row's blocks row_ptr[r] .. row_ptr[r + 1] - 1; nb blocks of (bm,
// bk) in `blocks`. cluster: 0 for the launch rule (cluster_for), else 1, 2,
// 4 or 8.
extern "C" int spgrid_bsr_spmm_bf16(const void* row_ptr, const void* cols,
                                    const void* blocks,
                                    const void* tile_slices, const void* x,
                                    void* y, int num_slices, int nb, int bm,
                                    int bk, int m, int k, int n, int cluster,
                                    void* stream) {
  if (num_slices <= 0 || nb <= 0 || bm <= 0 || bk <= 0 || m <= 0 || k <= 0 ||
      n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int slices = (bm + ROWS - 1) / ROWS;
  const bool y16 = n % 4 == 0 && aligned8(y);
  CUtensorMap a_map, x_map;
  if (pipelined(bk, n) &&
      pipe_maps(&a_map, &x_map, blocks, static_cast<long long>(nb) * bm, bk,
                x, k, n)) {
    return launch_cta_tiles(
        bsr_spmm_bf16_pipe_kernel, pipe_tiles(num_slices, n), cluster,
        PT_SMEM, PT_THREADS, PT_SHARE, stream, a_map, x_map,
        static_cast<const int*>(row_ptr), static_cast<const int*>(cols),
        static_cast<const int*>(tile_slices), static_cast<unsigned short*>(y),
        bm, bk, m, n, slices, (n + PT_NT - 1) / PT_NT, y16);
  }
  return launch_tiles(
      bsr_spmm_bf16_kernel,
      static_cast<long long>(num_slices) * ((n + NT - 1) / NT), cluster,
      RowStage<true>::SMEM, stream, static_cast<const int*>(row_ptr),
      static_cast<const int*>(cols),
      static_cast<const unsigned short*>(blocks),
      static_cast<const int*>(tile_slices), x, y, bm, bk, m, k, n, slices,
      (n + NT - 1) / NT, bk % 8 == 0 && aligned16(blocks),
      n % 8 == 0 && aligned16(x), y16);
}

// The bf16 form's entry route: slot_rows.cuh's walk over the listed rows
// rows[0 .. num_rows - 1] of the entry stream (row_slot (m + 1), vals (bf16),
// xrows), the products exact in f32, Y rounded once; long_rows (num_long of
// them, among the listed rows) have more than long_row entries and take
// the long-row walk.
extern "C" int spgrid_bsr_spmm_bf16_entries(
    const void* row_slot, const void* vals, const void* xrows,
    const void* rows, const void* long_rows, const void* x, void* y,
    int num_rows, int n, int long_row, int num_long, void* stream) {
  return spgrid::slot_rows::launch<true, false>(
      row_slot, vals, xrows, long_rows, x, y, num_rows, n, long_row, num_long,
      stream, static_cast<const int*>(rows));
}

extern "C" const char* spgrid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
