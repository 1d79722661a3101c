// The register-tiled f32 product of panel_spmm.cu, on the CUDA cores.
// bsr_spmm.cu and sddmm.cu moved to the 3xTF32 tensor-core tile of
// block_mma.cuh; panel_spmm is the next kernel to take it.
//
// One CTA of 256 threads owns a 64 x 64 output tile. The contraction runs in
// steps of TK = 16: each step stages a (64 x 16) slice of the left operand
// and a (16 x 64) slice of the right operand in shared memory, depth-major,
// and every thread accumulates a 4 x 4 micro-tile in registers with f32 FMA
// on the CUDA cores. Thread (ty, tx) owns rows ty + 16 r and columns
// tx + 16 c, so the 16 threads of a half-warp read 16 neighbouring words of
// the right slice and one broadcast word of the left slice.
//
// No tensor cores: one TF32 product keeps about three decimal digits and
// would miss the f32 accuracy gate (1e-4 relative against the f64 oracle);
// the 3xTF32 split of tf32x3.cuh keeps f32's accuracy.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace spgrid {

constexpr int TILE = 64;      // output rows and columns per CTA
constexpr int TK = 16;        // contraction depth staged per step
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int MICRO = 4;      // 4 x 4 outputs per thread

// Both slices are stored depth-major; the +1 keeps the transposed stores of
// stage_rows off a single bank.
struct Stage {
  float a[TK][TILE + 1];
  float b[TK][TILE + 1];
};

// dst[kk][i] = src[i * ld + kk] for i < rows and kk < depth, 0 elsewhere.
// Neighbouring threads take neighbouring kk, i.e. neighbouring addresses.
__device__ __forceinline__ void stage_rows(float (*dst)[TILE + 1],
                                           const float* __restrict__ src,
                                           size_t ld, int rows, int depth) {
  for (int e = threadIdx.x; e < TILE * TK; e += THREADS) {
    const int kk = e % TK;
    const int i = e / TK;
    dst[kk][i] = (i < rows && kk < depth) ? src[i * ld + kk] : 0.0f;
  }
}

// dst[kk][j] = src[kk * ld + j] for kk < depth and j < cols, 0 elsewhere.
__device__ __forceinline__ void stage_cols(float (*dst)[TILE + 1],
                                           const float* __restrict__ src,
                                           size_t ld, int depth, int cols) {
  for (int e = threadIdx.x; e < TILE * TK; e += THREADS) {
    const int j = e % TILE;
    const int kk = e / TILE;
    dst[kk][j] = (kk < depth && j < cols) ? src[kk * ld + j] : 0.0f;
  }
}

// acc[r][c] += sum_kk a[kk][ty + 16 r] * b[kk][tx + 16 c]
__device__ __forceinline__ void multiply(float (&acc)[MICRO][MICRO],
                                         const Stage& s) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int kk = 0; kk < TK; ++kk) {
    float av[MICRO];
    float bv[MICRO];
#pragma unroll
    for (int r = 0; r < MICRO; ++r) av[r] = s.a[kk][ty + 16 * r];
#pragma unroll
    for (int c = 0; c < MICRO; ++c) bv[c] = s.b[kk][tx + 16 * c];
#pragma unroll
    for (int r = 0; r < MICRO; ++r)
#pragma unroll
      for (int c = 0; c < MICRO; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// One CTA's tile of a band's panels (a row of blocks):
//   Y[row0 + i0 + i, n0 + j] = sum_{b in [begin, end)}
//       blocks[b][i0 + i, :] . X[cols[b] * bk + :, n0 + j]
// with i0 = blockIdx.z * TILE and n0 = blockIdx.y * TILE. The CTA writes
// every element of its tile that lies inside the block row (i0 + i < bm)
// and inside Y (row < m, column < n), zeros included, so Y needs no
// initialisation and no row of it is left unwritten. X rows >= k are never
// read: block columns at or past k hold zeros by construction.
__device__ __forceinline__ void block_row_spmm(
    Stage& s, int begin, int end, const int* __restrict__ cols,
    const float* __restrict__ blocks, int bm, int bk, long long row0,
    const float* __restrict__ x, float* __restrict__ y, int m, int k, int n) {
  const int i0 = blockIdx.z * TILE;
  const int n0 = blockIdx.y * TILE;
  const int rows = min(TILE, bm - i0);
  const int ncols = min(TILE, n - n0);
  float acc[MICRO][MICRO] = {};
  for (int b = begin; b < end; ++b) {
    const long long xr0 = static_cast<long long>(cols[b]) * bk;
    const float* blk = blocks + (static_cast<size_t>(b) * bm + i0) * bk;
    for (int k0 = 0; k0 < bk; k0 += TK) {
      const long long left = static_cast<long long>(k) - (xr0 + k0);
      int depth = min(TK, bk - k0);
      if (left < depth) depth = left > 0 ? static_cast<int>(left) : 0;
      if (depth == 0) break;  // the same for every thread of the CTA
      stage_rows(s.a, blk + k0, bk, rows, depth);
      stage_cols(s.b, x + static_cast<size_t>(xr0 + k0) * n + n0, n, depth, ncols);
      __syncthreads();
      multiply(acc, s);
      __syncthreads();
    }
  }
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < MICRO; ++r) {
    const int i = ty + 16 * r;
    const long long row = row0 + i0 + i;
    if (i >= rows || row >= m) continue;
#pragma unroll
    for (int c = 0; c < MICRO; ++c) {
      const int j = tx + 16 * c;
      if (j < ncols) y[static_cast<size_t>(row) * n + n0 + j] = acc[r][c];
    }
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace spgrid
