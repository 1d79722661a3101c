// Block-sparse-row SpMM, Y = A @ X with A in DeviceBSR layout.
//
// Replaces: spgrid/ops/pallas/bsr_spmm.py, _kernel / _bsr_spmm (the Pallas
// TPU kernel behind `bsr_pallas` and every SpMM of the attention pipeline).
//
// Bound on the H100: at the main path's shapes (512 x 512, all 16 blocks of
// 128^2 stored, n = 512) A, X and Y together are ~3 MB and sit in the 50 MB
// L2, and only 64 CTAs run, one per SM: each of a CTA's 32 unpipelined
// shared-memory stages waits out an L2 round trip, so the kernel is latency
// bound (56 us on an H100 SXM at 700 W, where cuBLAS takes 13 us for the
// dense product). At 4096^2, 50 % (512 CTAs) the latency is hidden and it is
// bound by f32 FMA issue and shared-memory reads: 16 TFLOP/s of block work.
//
// Design: one CTA per (block row, 64 columns of X, 64 rows of the block).
// It walks the block row's blocks through row_ptr (a pointer rebuilt from
// block_rows, so the zero coverage blocks the layout inserts for empty block
// rows are counted), stages each block and X tile in shared memory, and
// keeps the 64 x 64 sum in registers. The Pallas kernel's sequential grid
// zeroed an output tile only on a row's first block; here each CTA writes
// its whole tile, zeros included, with no atomics, so the result is
// deterministic and no row of Y is left unwritten. Pad blocks (block_row =
// mb) lie past row_ptr[mb] and are never visited. X is read in place at
// (k, n) and Y is written at (m, n): rows and columns past the edges are
// masked instead of padded.
#include "block_tile.cuh"

namespace {

__global__ void __launch_bounds__(spgrid::THREADS)
bsr_spmm_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cols,
                const float* __restrict__ blocks, const float* __restrict__ x,
                float* __restrict__ y, int bm, int bk, int m, int k, int n) {
  __shared__ spgrid::Stage s;
  const int r = blockIdx.x;
  spgrid::block_row_spmm(s, row_ptr[r], row_ptr[r + 1], cols, blocks, bm, bk,
                         static_cast<long long>(r) * bm, x, y, m, k, n);
}

}  // namespace

extern "C" int spgrid_bsr_spmm(const void* row_ptr, const void* cols,
                               const void* blocks, const void* x, void* y,
                               int mb, int bm, int bk, int m, int k, int n,
                               void* stream) {
  const dim3 grid(mb, spgrid::cdiv(n, spgrid::TILE),
                  spgrid::cdiv(bm, spgrid::TILE));
  bsr_spmm_kernel<<<grid, spgrid::THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(cols),
      static_cast<const float*>(blocks), static_cast<const float*>(x),
      static_cast<float*>(y), bm, bk, m, k, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spgrid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
