// Block-sparse SDDMM: S_b = mask_b * (Q[rows[b] * bm : +bm] @ K[cols[b] * bk : +bk]^T)
// for every stored block b of a DeviceBSR mask.
//
// Replaces: spgrid/ops/pallas/sddmm.py, _kernel / _bsr_sddmm (the Pallas TPU
// kernel behind the attention pipeline's SDDMM stage).
//
// Bound on the H100: 2 * nb * bm * bk * d flops on the CUDA cores. The Q and
// K row panels a block reads are re-read by every block of the same block
// row or column and stay in L2. At the pipeline's shapes (512^2 mask, 13
// blocks of 128^2, d = 512) only 52 CTAs run and each of their 32
// unpipelined stages waits out an L2 round trip: latency bound, 85 us on an
// H100 SXM at 700 W.
//
// Design: one CTA per (mask block, 64 x 64 sub-tile of the bm x bk block).
// It loops over d in steps of 16, staging 64 rows of Q and 64 rows of K
// depth-major. Both are read row-major as stored: K^T is never formed (the
// Pallas version padded and transposed K in device memory first). The sum
// stays in registers and is multiplied by the mask block once, at the end.
// Q rows >= mq and K rows >= mk read as zeros, so pad blocks (block_row =
// mb) give zero blocks, as the Pallas kernel's sacrificial zero panel of Q
// did. Every element of the (nb, bm, bk) output is written.
#include "block_tile.cuh"

namespace {

__global__ void __launch_bounds__(spgrid::THREADS)
bsr_sddmm_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                 const float* __restrict__ mask, const float* __restrict__ q,
                 const float* __restrict__ kmat, float* __restrict__ out,
                 int bm, int bk, int mq, int mk, int d) {
  using spgrid::TILE;
  __shared__ spgrid::Stage s;
  const int b = blockIdx.x;
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.z * TILE;
  const long long q0 = static_cast<long long>(rows[b]) * bm + i0;
  const long long k0 = static_cast<long long>(cols[b]) * bk + j0;
  const long long q_left = static_cast<long long>(mq) - q0;
  const long long k_left = static_cast<long long>(mk) - k0;
  int qrows = min(TILE, bm - i0);
  int krows = min(TILE, bk - j0);
  if (q_left < qrows) qrows = q_left > 0 ? static_cast<int>(q_left) : 0;
  if (k_left < krows) krows = k_left > 0 ? static_cast<int>(k_left) : 0;

  float acc[spgrid::MICRO][spgrid::MICRO] = {};
  if (qrows > 0 && krows > 0) {  // the same for every thread of the CTA
    const float* qt = q + static_cast<size_t>(q0) * d;
    const float* kt = kmat + static_cast<size_t>(k0) * d;
    for (int d0 = 0; d0 < d; d0 += spgrid::TK) {
      const int depth = min(spgrid::TK, d - d0);
      spgrid::stage_rows(s.a, qt + d0, d, qrows, depth);
      spgrid::stage_rows(s.b, kt + d0, d, krows, depth);
      __syncthreads();
      spgrid::multiply(acc, s);
      __syncthreads();
    }
  }

  const size_t base = static_cast<size_t>(b) * bm * bk;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < spgrid::MICRO; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= bm) continue;
#pragma unroll
    for (int c = 0; c < spgrid::MICRO; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j >= bk) continue;
      const size_t at = base + static_cast<size_t>(i) * bk + j;
      out[at] = acc[r][c] * mask[at];
    }
  }
}

}  // namespace

extern "C" int spgrid_bsr_sddmm(const void* rows, const void* cols,
                                const void* mask, const void* q,
                                const void* kmat, void* out, int nb, int bm,
                                int bk, int mq, int mk, int d, void* stream) {
  const dim3 grid(nb, spgrid::cdiv(bm, spgrid::TILE),
                  spgrid::cdiv(bk, spgrid::TILE));
  bsr_sddmm_kernel<<<grid, spgrid::THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<const int*>(cols),
      static_cast<const float*>(mask), static_cast<const float*>(q),
      static_cast<const float*>(kmat), static_cast<float*>(out), bm, bk, mq,
      mk, d);
  return static_cast<int>(cudaGetLastError());
}
