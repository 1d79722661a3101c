// Window-row packed SpMV, variant v2: y = A @ x with A in DeviceWROW layout,
// walking the live-slot stream in equal ranges with a carried accumulator.
//
// Replaces: spgrid/ops/pallas/wrow_spmv.py, _kernel_v2 / _spmv_v2 (the
// Pallas TPU kernel behind `wrow_spmv(..., variant="v2")`: one (8, 128)
// accumulator carried across groups and grid steps, flushed into y at each
// change of target block).
//
// Bound on the H100: device-memory bytes: each nnz's value and int8 column
// once plus x and y (~11.3 MB, ~3.4 us at 3.35 TB/s at the 100000^2
// scattered matrix). The padded pieces hold ~40x more slots than nnz there
// (utilization 0.025: 423 MB of 5-byte slots, >= 126 us to stream), so this
// kernel does not read them: it reads the layout's live-slot stream
// (DeviceWROW.slot_*: value, x index and row, 9 bytes a live slot, ~18.9 MB
// there).
//
// Design: what v2 keeps from the TPU kernel is the work split, equal
// contiguous ranges a CTA with an accumulator carried through a target
// block and flushed once a block; here the range is one of live slots (on
// the TPU, one of groups). The walk, the flush and the carry combine are the shared
// spgrid::slot_stream ones (slot_stream.cuh): 256 threads a CTA,
// `slots_per_cta` slots a range, a 128-float shared-memory accumulator fed
// by shared-memory atomicAdd (a piece's slots are distinct rows, but the
// pieces of a block hit the same rows), blocks that straddle ranges summed
// by a second kernel in range order, every row of y written. Slots whose
// value is 0 or whose x index lies at or past k were dropped when the
// stream was built: x is not padded. The result is not bit-reproducible
// from run to run (the order of the shared-memory atomics); it agrees with
// v1 and the plain version to f32 rounding.
#include "slot_stream.cuh"

// block_slot, vals, cols (int32 x index), rows (uint8), x, y, carry,
// num_slots, slots_per_cta, blocks, m, stream
extern "C" int spgrid_wrow_spmv_v2(const void* block_slot, const void* vals,
                                   const void* cols, const void* rows,
                                   const void* x, void* y, void* carry,
                                   int num_slots, int slots_per_cta,
                                   int blocks, int m, void* stream) {
  return spgrid::slot_stream::launch<false>(block_slot, vals, cols, rows, x, y,
                                            carry, num_slots, slots_per_cta,
                                            blocks, m, stream);
}
