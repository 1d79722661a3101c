// C-stationary block-sparse SpMM, Y = A @ X with A in DeviceBSRCol layout.
//
// Replaces: spgrid/ops/pallas/bsr_spmm_cstat.py, _kernel / _bsr_spmm_cstat
// (the Pallas TPU kernel behind `bsrc_pallas`). What the TPU kernel keeps
// out of device memory: each band's output slab (R + bm rows x 512 columns,
// ~4.5 MB of VMEM) is accumulated on chip and written once, and each X tile
// is read once per distinct block column of a band, because a band's blocks
// are sorted by (block column, block row).
//
// Bound on the H100: at the main path's 8192^2 matrix with 316 blocks of
// 128^2 and n = 512, the product needs its 413,698 nnz, X and Y once
// (~37 MB, ~11 us at 3.35 TB/s); its 0.42 GFLOP on the f32 CUDA cores take
// ~6 us. A dense-block kernel does the blocks' full work (5.3 GFLOP, ~79 us
// at 67 TFLOP/s), and this one re-reads each block once per column tile.
//
// Design: the slab does not fit a CTA's 227 KB of shared memory at 512
// columns, so the idea is kept with a narrower tile: one CTA per (band,
// NT = 16 output columns) holds the band's R x NT slab in shared memory
// (128 KB at R = 2048), starts it at zero, walks the band's real slots
// (counts[band] of them; pad slots are never read), restages the bk x NT
// X tile only when the block column changes, and writes the slab once to
// the rows of the band that lie below m. Each block is staged TK columns
// at a time; thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and columns
// 2 tx, 2 tx + 1 of every block, sums them in registers over the block and
// adds them to the slab rows of the block's window, which no other thread
// touches: no atomics. X rows >= k and columns >= n read as zeros. Few
// CTAs (bands x n / 16: 128 at the main path, 64 at 4096^2), one CTA an
// SM (the slab), and a block re-read per column tile are the known costs
// of this first version: its time is set by the latency of staging each
// block's slices from L2, which no other CTA on the SM hides.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int NT = 16;           // output columns per CTA
constexpr int TK = 32;           // block columns staged per step
constexpr int BM_MAX = 128;      // rows of a block the CTA covers
constexpr int THREADS = 256;     // 32 row groups x 8 column pairs
constexpr int ROWS = BM_MAX / 32;  // 4 rows a thread
constexpr int COLS = NT / 8;       // 2 columns a thread
constexpr int AS_LD = BM_MAX + 4;  // A slice row stride (16-byte aligned)

size_t smem_bytes(int band_rows, int bk) {
  return sizeof(float) * (static_cast<size_t>(band_rows) * NT +
                          static_cast<size_t>(bk) * NT +
                          static_cast<size_t>(TK) * AS_LD);
}

__global__ void __launch_bounds__(THREADS)
bsr_spmm_cstat_kernel(const int* __restrict__ counts,
                      const int* __restrict__ lrows,
                      const int* __restrict__ cols,
                      const float* __restrict__ blocks,
                      const float* __restrict__ x, float* __restrict__ y,
                      int max_nb, int band_rows, int bm, int bk, int m, int k,
                      int n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* as = smem;                    // TK x AS_LD, depth-major A slice
  float* xs = as + TK * AS_LD;         // bk x NT X tile
  float* slab = xs + bk * NT;          // band_rows x NT
  const int band = blockIdx.x;
  const int n0 = blockIdx.y * NT;
  const int ncols = min(NT, n - n0);
  const int t = threadIdx.x;
  const int ty = t / 8;
  const int tx = t % 8;

  for (int e = t; e < band_rows * NT; e += THREADS) slab[e] = 0.0f;
  const int begin = band * max_nb;
  const int end = begin + counts[band];
  int staged = -1;
  for (int s = begin; s < end; ++s) {
    const int c = cols[s];  // the same for every thread of the CTA
    if (c != staged) {
      __syncthreads();  // every thread is done with the previous tile
      const long long xr0 = static_cast<long long>(c) * bk;
      for (int e = t; e < bk * NT; e += THREADS) {
        const int kk = e / NT;
        const int j = e % NT;
        xs[e] = (xr0 + kk < k && j < ncols)
                    ? x[static_cast<size_t>(xr0 + kk) * n + n0 + j]
                    : 0.0f;
      }
      staged = c;
    }
    float acc[ROWS][COLS] = {};
    const float* blk = blocks + static_cast<size_t>(s) * bm * bk;
    for (int k0 = 0; k0 < bk; k0 += TK) {
      const int depth = min(TK, bk - k0);
      __syncthreads();  // the last slice is consumed; the X tile is staged
      for (int e = t; e < bm * TK; e += THREADS) {
        const int kk = e % TK;
        const int i = e / TK;
        as[kk * AS_LD + i] =
            kk < depth ? blk[static_cast<size_t>(i) * bk + k0 + kk] : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < depth; ++kk) {
        // rows >= bm hold stale values; their sums are never stored
        const float4 av = *reinterpret_cast<const float4*>(
            as + kk * AS_LD + ROWS * ty);
        const float2 xv = *reinterpret_cast<const float2*>(
            xs + (k0 + kk) * NT + COLS * tx);
        const float a[ROWS] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          acc[r][0] = fmaf(a[r], xv.x, acc[r][0]);
          acc[r][1] = fmaf(a[r], xv.y, acc[r][1]);
        }
      }
    }
    float* win = slab + static_cast<size_t>(lrows[s]) * bm * NT;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = ROWS * ty + r;
      if (i >= bm) break;
#pragma unroll
      for (int cc = 0; cc < COLS; ++cc) win[i * NT + COLS * tx + cc] += acc[r][cc];
    }
  }
  __syncthreads();
  const long long row0 = static_cast<long long>(band) * band_rows;
  const long long left = static_cast<long long>(m) - row0;
  const int rows = left < band_rows ? static_cast<int>(left) : band_rows;
  for (int e = t; e < rows * NT; e += THREADS) {
    const int i = e / NT;
    const int j = e % NT;
    if (j < ncols) y[static_cast<size_t>(row0 + i) * n + n0 + j] = slab[e];
  }
}

}  // namespace

extern "C" int spgrid_bsr_spmm_cstat(const void* counts, const void* lrows,
                                     const void* cols, const void* blocks,
                                     const void* x, void* y, int bands,
                                     int max_nb, int band_rows, int bm,
                                     int bk, int m, int k, int n,
                                     void* stream) {
  if (bm > BM_MAX || bm <= 0 || band_rows % bm != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(band_rows, bk);
  const cudaError_t attr = cudaFuncSetAttribute(
      bsr_spmm_cstat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) {
    cudaGetLastError();  // clear it, so that the next launch's check is clean
    return static_cast<int>(attr);
  }
  const dim3 grid(bands, (n + NT - 1) / NT);
  bsr_spmm_cstat_kernel<<<grid, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), static_cast<const int*>(lrows),
      static_cast<const int*>(cols), static_cast<const float*>(blocks),
      static_cast<const float*>(x), static_cast<float*>(y), max_nb, band_rows,
      bm, bk, m, k, n);
  return static_cast<int>(cudaGetLastError());
}
