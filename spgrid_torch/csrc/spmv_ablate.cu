// WROW SpMV ablation: WROW v1's own row walk (wrow_rows.cuh) in five
// variants, each with one stage of the walk compiled out, for timing where
// v1's time goes. Only "full" computes y = A @ x; the others are wrong by
// design.
//
// Replaces: scripts/exp_spmv_ablate.py, _kernel / _spmv_variant (the Pallas
// TPU probe that deleted one stage of the WROW group body at a time: the
// x-row loads, the lane gather, the y read-modify-write).
//
// For a slot of row q (t = q mod 128) with value v, x index xi = 128 w + c
// and r its piece's place in its group, thread t of q's block adds
//
//   full      v * x[xi]                 to y[q]  (WROW v1, the same kernel)
//   nogather  v * x[(xi & ~127) + t]    to y[q]  (no scatter in a window)
//   noload    v * x[128 r + c]          to y[q]  (1,024 fixed x entries)
//   normw     v * x[xi]                 to y[q mod 128]
//   empty     v                         to y[q mod 128]
//
// An x index at or past k reads 0. What each removes from v1's body:
// nogather the scatter of the staged x gather, noload the x traffic, normw
// the one y write (an atomicAdd in its place), empty everything but
// streaming the values; normw and empty sum every block into y[0:128] with
// atomicAdd, in an order that changes from run to run.
//
// Bound on the H100: device-memory bytes. At the probe's 100000^2 matrix
// (2,095,859 nnz) the product needs each nnz's value and column and x and
// y once: 11.28 MB at a byte a column, ~3.4 us at 3.35 TB/s. The walk reads
// the row stream, 8 bytes a live slot (16.8 MB, and a byte more a slot for
// noload), where the padded walk that this probe ran before read all of
// the layout's 113,944 pieces of 128 slots (72.9 MB, utilization 0.14).
//
// Design: the variant is a template parameter of wrow_rows.cuh's walk, so
// "full" is the kernel that wrow_spmv.cu launches, compiled from the same
// source, and gives its bits; the other four are that walk with one stage
// compiled out.
#include "wrow_rows.cuh"

// row_slot, vals, cols, pieces, x, y, variant, blocks, m, k, stream
extern "C" int spgrid_spmv_ablate(const void* row_slot, const void* vals,
                                  const void* cols, const void* pieces,
                                  const void* x, void* y, int variant,
                                  int blocks, int m, int k, void* stream) {
  using namespace spgrid::wrow_rows;
  switch (variant) {
    case FULL:
      return launch<FULL>(row_slot, vals, cols, pieces, x, y, blocks, m, k,
                          stream);
    case NOGATHER:
      return launch<NOGATHER>(row_slot, vals, cols, pieces, x, y, blocks, m,
                              k, stream);
    case NOLOAD:
      return launch<NOLOAD>(row_slot, vals, cols, pieces, x, y, blocks, m, k,
                            stream);
    case NORMW:
      return launch<NORMW>(row_slot, vals, cols, pieces, x, y, blocks, m, k,
                           stream);
    case EMPTY:
      return launch<EMPTY>(row_slot, vals, cols, pieces, x, y, blocks, m, k,
                           stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
