// bf16 as the kernels' bf16 forms hold it: values and operands as bf16 bit
// patterns (unsigned short), widened to f32 to compute, each rounding to
// bf16 to nearest, ties to even (what XLA does to an f32 result on the CPU,
// where the Pallas kernels' bf16 operations are computed in f32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace spgrid {
namespace bf16 {
namespace {

// The element type of values, x and y: f32, or bf16 as its bit pattern.
template <bool BF>
using Elem = std::conditional_t<BF, unsigned short, float>;

// A marked row stream's x index (ops/kernels/slot_rows.py:mark_groups):
// bit 31 set on the slot that opens one of its row's groups.
constexpr int X_INDEX = 0x7fffffff;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

__device__ __forceinline__ unsigned short round_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// v rounded to bf16 and widened back: one bf16 operation's result
__device__ __forceinline__ float rounded(float v) {
  return widen(round_bf16(v));
}

// v as an element of y: itself in f32, rounded in bf16
template <bool BF>
__device__ __forceinline__ Elem<BF> narrow(float v) {
  if constexpr (BF) {
    return round_bf16(v);
  } else {
    return v;
  }
}

}  // namespace
}  // namespace bf16
}  // namespace spgrid
