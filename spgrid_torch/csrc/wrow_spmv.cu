// Window-row packed SpMV, y = A @ x with A in DeviceWROW layout.
//
// Replaces: spgrid/ops/pallas/wrow_spmv.py, _kernel / _spmv (v1; the Pallas
// TPU kernel behind `wrow_spmv`, the route of every SpMV under 5 % density:
// per group of 8 pieces, 8 window rows of x, one 128-lane gather, a
// sublane sum and a read-modify-write of one row of the resident y).
//
// Bound on the H100: device-memory bytes. The padded pieces are mostly
// empty (2.5 % full at the 100000^2 scattered matrix: ~423 MB of slots for
// 2.1M nnz), so the kernel reads the layout's row-ordered live-slot stream
// (DeviceWROW.row_*, built on the host): each live slot's f32 value and
// int32 x index, 8 bytes, ~17 MB there, ~3.6 MB at the 65535^2
// hypersparse one; with x, y and the row pointer ~5.5 us at 3.35 TB/s.
// Two flops a slot are nothing beside that; each slot's x read is a
// gather, mostly from L2.
//
// Design: v1's grid, one CTA of 128 threads per 128-row target block,
// thread t for row t of the block, which it writes once: the row walk of
// wrow_rows.cuh (its FULL form; spmv_ablate.cu runs the same walk with one
// stage compiled out at a time). The stream holds a row's live slots
// contiguously in piece order, the order in which the padded kernel summed
// the row, and thread t sums them in that order with fmaf from 0.0f, so y
// has the padded kernel's bits. Each warp stages its 32 rows in rounds of
// 32 slots a row through shared memory, so a row of thousands of slots runs
// in rounds beside the warp's other rows, all 32 lanes loading. Slots whose
// value is 0 or whose x index lies at or past k (x is not padded to the
// window) are not in the stream.
//
// The bf16 form (wrow_spmv at dtype bf16): the same walk on bf16 values, x
// and y, 6 bytes a live slot, the x index marked where a slot opens one of
// its row's groups of 8 pieces: each group's products for a row summed in
// f32 and rounded to bf16 before they are added into the f32 row, y rounded
// once, where the Pallas body rounds (wrow_rows.cuh).
#include "wrow_rows.cuh"

// row_slot, vals, cols, x, y, blocks, m, stream
extern "C" int spgrid_wrow_spmv(const void* row_slot, const void* vals,
                                const void* cols, const void* x, void* y,
                                int blocks, int m, void* stream) {
  return spgrid::wrow_rows::launch<spgrid::wrow_rows::FULL>(
      row_slot, vals, cols, nullptr, x, y, blocks, m, 0, stream);
}

// The bf16 form: vals, x and y as bf16 bit patterns, cols marked with the
// groups' starts (bit 31); the same arguments.
extern "C" int spgrid_wrow_spmv_bf16(const void* row_slot, const void* vals,
                                     const void* cols, const void* x, void* y,
                                     int blocks, int m, void* stream) {
  return spgrid::wrow_rows::launch<spgrid::wrow_rows::FULL, true>(
      row_slot, vals, cols, nullptr, x, y, blocks, m, 0, stream);
}
