// Vertical-panel SpMM, Y = A @ X with A in DevicePanels layout, in two
// forms: f32 panels (3xTF32, below) and bf16 panels (further below).
//
// Replaces: spgrid/ops/pallas/panel_spmm.py, _kernel / _panel_spmm (the
// Pallas TPU kernel behind `panel_pallas`, and behind `cv_panel` with its
// bf16 panels at precision "default": bf16 panels times X rounded to bf16,
// f32 sums).
//
// Bound on the H100: the same work as the BSR kernel with taller blocks: a
// panel is all R rows of a row band for one block column (R x bk), and the
// kernel does the panels' full work, 2 R bk n flops each. At the headline
// (512 x 512, n = 512) R = 512: one band of four panels, 0.27 GFLOP, three
// times over in 3xTF32, 1.6 us at 495 TFLOP/s; A, X and Y (3 MB) sit in
// L2. The grid is what is short: 4 row slices x 8 column tiles of 64 is 32
// tiles for 132 SMs, each a contraction of 16 steps.
//
// Design (the tile of block_mma.cuh, as bsr_spmm.cu runs it): a band is a
// row of blocks whose blocks are its panel slots, so each tile (band, slice
// of 128 of its R rows, 64 columns of X) runs `row_tile_spmm` over slots
// band * max_p .. band * max_p + counts[band] - 1, 3xTF32 on the tensor
// cores through a cp.async ring, its steps split across a cluster of C
// CTAs (`cluster_for`, from the grid and the SM count: C = 4 at the
// headline, 128 CTAs of 4 steps). Bands taller than 128 rows run as slices
// of 128 (16 at the default R = 2048; the last slice of R = 1000 has 104
// rows); below 64 rows one warpgroup multiplies. Pad slots (zero panels
// that repeat the band's last column) lie past the band's count and are
// never visited. Every element of Y is written once, zeros included (a
// band with no panel writes zeros), with no atomics; rows >= m are never
// written and X rows >= k read as zero.
#include <cuda_bf16.h>

#include "block_mma.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, 2)
panel_spmm_kernel(const int* __restrict__ counts, const int* __restrict__ cols,
                  const float* __restrict__ panels,
                  const float* __restrict__ x, float* __restrict__ y,
                  int max_p, int band_rows, int bk, int m, int k, int n,
                  int slices, int col_tiles, bool a16, bool x16, bool y16) {
  const RowTile t = row_tile(slices, col_tiles);
  const int begin = t.r * max_p;
  row_tile_spmm(t, begin, begin + counts[t.r], cols, panels, x, y,
                band_rows, bk, m, k, n, a16, x16, y16);
}

// The bf16 form (`cv_panel`). Bound on the H100: at the headline (one band
// of R = 512 rows, four panels, n = 512) the panels' dense work is 0.27
// GFLOP, 0.27 us at 989 TFLOP/s bf16, and A (256 KB in bf16), X and Y (2 MB
// in f32) sit in L2; as in the f32 form, the grid is what is short.
//
// Design: the f32 form's walk and launch (a tile is a band's 128-row slice
// by 64 columns of X, its steps the band's real panels times 32 of their
// bk columns, split across a cluster where the tiles alone leave the card
// idle, the ranks' partial tiles summed in rank order through distributed
// shared memory: `reduce_store`), with a simpler step. A step stages the
// panel's (rows x 32) bf16 slice row-major and X's (32 x 64) slice
// transposed, each X value rounded to bf16 (to nearest, ties to even) on
// its way into shared memory; warp w multiplies the tile's rows 16 w ..
// 16 w + 15 with mma.sync m16n8k16 bf16: two k16 products a column group
// of 8, into fresh f32 accumulators that are then added to the running
// f32 sums (the tensor cores truncate their accumulate). One product per
// step, not 3xTF32's three: a bf16 x bf16 product is exact in f32. No
// ring: the staging and the products of a step take turns.
constexpr int BF_LD = TK + 8;  // bf16 row stride of a staged slice

__device__ __forceinline__ uint32_t bf16_pair(unsigned short lo,
                                              unsigned short hi) {
  return static_cast<uint32_t>(lo) | static_cast<uint32_t>(hi) << 16;
}

// d (16 x 8, f32) += a (16 x 16, bf16, row-major fragments) b (16 x 8,
// bf16, column fragments): mma.sync m16n8k16, warp-collective.
__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2,
                                         float& d3, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS, 2)
panel_spmm_bf16_kernel(const int* __restrict__ counts,
                       const int* __restrict__ cols,
                       const unsigned short* __restrict__ panels,
                       const float* __restrict__ x, float* __restrict__ y,
                       int max_p, int band_rows, int bk, int m, int k, int n,
                       int slices, int col_tiles) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // the partial tile, last
  unsigned short* as = reinterpret_cast<unsigned short*>(smem4);
  unsigned short* bs = as + ROWS * BF_LD;  // X slice: [column][depth]
  const RowTile t = row_tile(slices, col_tiles);
  const Frag f = frag();
  const int ranks = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int rows = min(ROWS, band_rows - t.i0);
  const int ncols = min(NT, n - t.n0);
  const int nq = (bk + TK - 1) / TK;  // steps a panel
  const int begin = t.r * max_p;
  const long long total = static_cast<long long>(counts[t.r]) * nq;
  const long long s0 = total * rank / ranks;
  const int steps = static_cast<int>(total * (rank + 1) / ranks - s0);
  const int warp = threadIdx.x / 32;
  const int g = f.g, q = f.q;

  float acc[NT / 2] = {};
  for (int it = 0; it < steps; ++it) {
    const long long s = s0 + it;
    const int b = begin + static_cast<int>(s / nq);
    const int k0 = static_cast<int>(s % nq) * TK;
    const int depth = min(TK, bk - k0);
    const long long xr0 = static_cast<long long>(cols[b]) * bk + k0;
    const long long x_left = static_cast<long long>(k) - xr0;
    const int x_depth = x_left < depth ? static_cast<int>(max(x_left, 0LL))
                                       : depth;
    __syncthreads();  // the previous step's slices are consumed
    const unsigned short* src =
        panels + (static_cast<size_t>(b) * band_rows + t.i0) * bk + k0;
    for (int e = threadIdx.x; e < ROWS * (TK / 2); e += THREADS) {
      const int i = e / (TK / 2);
      const int c = e % (TK / 2) * 2;
      unsigned short lo = 0, hi = 0;
      if (i < rows) {
        const unsigned short* p = src + static_cast<size_t>(i) * bk + c;
        if (c < depth) lo = p[0];
        if (c + 1 < depth) hi = p[1];
      }
      *reinterpret_cast<uint32_t*>(as + i * BF_LD + c) = bf16_pair(lo, hi);
    }
    for (int e = threadIdx.x; e < TK * NT; e += THREADS) {
      const int kk = e / NT;
      const int j = e % NT;
      const float v = kk < x_depth && j < ncols
                          ? x[static_cast<size_t>(xr0 + kk) * n + t.n0 + j]
                          : 0.0f;
      bs[j * BF_LD + kk] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    }
    __syncthreads();  // the step's slices are in place
    if (16 * warp < rows) {
      float d[NT / 2] = {};
#pragma unroll
      for (int ks = 0; ks < TK / 16; ++ks) {
        const unsigned short* pa =
            as + (16 * warp + g) * BF_LD + 16 * ks + 2 * q;
        const uint32_t a[4] = {
            *reinterpret_cast<const uint32_t*>(pa),
            *reinterpret_cast<const uint32_t*>(pa + 8 * BF_LD),
            *reinterpret_cast<const uint32_t*>(pa + 8),
            *reinterpret_cast<const uint32_t*>(pa + 8 * BF_LD + 8)};
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          const unsigned short* pb =
              bs + (8 * j + g) * BF_LD + 16 * ks + 2 * q;
          mma_bf16(d[4 * j], d[4 * j + 1], d[4 * j + 2], d[4 * j + 3], a,
                   *reinterpret_cast<const uint32_t*>(pb),
                   *reinterpret_cast<const uint32_t*>(pb + 8));
        }
      }
#pragma unroll
      for (int e = 0; e < NT / 2; ++e) acc[e] += d[e];
    }
  }
  __syncthreads();  // the slices are free for the partial tile

  const long long row0 = static_cast<long long>(t.r) * band_rows + t.i0;
  const int out_rows = static_cast<int>(
      min(static_cast<long long>(rows), static_cast<long long>(m) - row0));
  reduce_store(acc, ring, out_rows, ncols, f,
               [&](int i, int j, const float4& v) {
                 float* p = y + static_cast<size_t>(row0 + i) * n + t.n0 + j;
                 const float w[4] = {v.x, v.y, v.z, v.w};
                 for (int c = 0; c < 4 && j + c < ncols; ++c) p[c] = w[c];
               });
}

}  // namespace

// out (int[6]) = {tiles, cluster, ROWS, NT, TK, STAGES} of the launch
// spgrid_panel_spmm makes for these sizes at cluster 0 on the current card.
extern "C" int spgrid_panel_spmm_shape(int bands, int band_rows, int n,
                                       void* out) {
  if (bands <= 0 || band_rows <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return report_shape(row_tiles(bands, band_rows, n), out);
}

// cluster: 0 for the launch rule (cluster_for), else 1, 2, 4 or 8.
extern "C" int spgrid_panel_spmm(const void* counts, const void* cols,
                                 const void* panels, const void* x, void* y,
                                 int bands, int max_p, int band_rows, int bk,
                                 int m, int k, int n, int cluster,
                                 void* stream) {
  if (bands <= 0 || max_p <= 0 || band_rows <= 0 || bk <= 0 || m <= 0 ||
      n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_clusters(
      panel_spmm_kernel, row_tiles(bands, band_rows, n), cluster, stream,
      static_cast<const int*>(counts), static_cast<const int*>(cols),
      static_cast<const float*>(panels), static_cast<const float*>(x),
      static_cast<float*>(y), max_p, band_rows, bk, m, k, n,
      (band_rows + ROWS - 1) / ROWS, (n + NT - 1) / NT,
      bk % 4 == 0 && aligned16(panels), n % 4 == 0 && aligned16(x),
      n % 4 == 0 && aligned16(y));
}

// The bf16 form: panels as bf16 bit patterns; the launch is the f32 form's
// (spgrid_panel_spmm_shape reports it). cluster: 0 for the launch rule,
// else 1, 2, 4 or 8.
extern "C" int spgrid_panel_spmm_bf16(const void* counts, const void* cols,
                                      const void* panels, const void* x,
                                      void* y, int bands, int max_p,
                                      int band_rows, int bk, int m, int k,
                                      int n, int cluster, void* stream) {
  if (bands <= 0 || max_p <= 0 || band_rows <= 0 || bk <= 0 || m <= 0 ||
      n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_clusters(
      panel_spmm_bf16_kernel, row_tiles(bands, band_rows, n), cluster, stream,
      static_cast<const int*>(counts), static_cast<const int*>(cols),
      static_cast<const unsigned short*>(panels),
      static_cast<const float*>(x), static_cast<float*>(y), max_p, band_rows,
      bk, m, k, n, (band_rows + ROWS - 1) / ROWS, (n + NT - 1) / NT);
}
