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

// The bf16 form (`cv_panel`). Bound on the H100: the bytes of the
// function (each nnz's bf16 value and index, X and Y in f32 once) over
// 3.35 TB/s, 0.0108 ms on LINE_B (8192^2, 413,698 nnz, n = 512); the
// panels' dense work over 989 TFLOP/s bf16 lies below it where the panels
// are sparse. At the headline (one band of R = 512 rows, four panels, n =
// 512) A (256 KB in bf16), X and Y (2 MB in f32) sit in L2 and the grid is
// short, as in the f32 form.
//
// Design: the f32 form's launch (a tile is a band's 128-row slice by 64
// columns of X, its steps split across a cluster where the tiles alone
// leave the card idle, the ranks' partial tiles summed in rank order
// through distributed shared memory: `sum_store`), with three changes.
//  1. A tile walks only its live slots: those of its band's real panels
//     that hold an entry of the CSR in its 128-row slice, in column order,
//     from the host-built index slice_ptr / slice_slots (on LINE_B 316 of
//     the 1,216 (panel, slice) pairs). A tile with none writes zeros.
//  2. Steps of BF_TK = 64 (a panel row slice is 128 bytes) come in through
//     a cp.async ring of BF_STAGES: the panel's (128 x 64) bf16 slice goes
//     straight into wgmma's K-major layout with the 128-byte swizzle (a row
//     a 128-byte line, its 16-byte chunks permuted by the row), so eight
//     threads copy a whole line of a panel row and write it to eight banks
//     at once; X's (64 x 64) f32 slice N-major.
//  3. The product runs transposed, Y^T tile = X^T P^T, so that the bf16
//     panel, which needs no rounding, is the shared-memory operand as it
//     lies, and X is rounded to bf16 (to nearest, ties to even) as its
//     fragments are loaded into registers: each warpgroup multiplies its
//     64 rows of the slice (wgmma's N) by all 64 columns of X (wgmma's M)
//     with wgmma m64n64k16 bf16, four a step into fresh f32 accumulators
//     that are then added to the running f32 sums (the tensor cores
//     truncate their accumulate). A bf16 x bf16 product is exact in f32.
// 16-byte copies where `a16` (bk % 8 == 0, panels on 16 B) and `x16` (n %
// 4 == 0, X on 16 B), else 2-byte loads and 4-byte cp.async; `y16` stores
// float4s.
constexpr int BF_TK = 64;         // contraction depth a step, in bf16
constexpr int BF_STAGES = 3;      // steps in the ring: two CTAs an SM
constexpr int XS_LD = NT + 4;     // row stride of an X slice: fragment
                                  // loads hit 32 banks
constexpr int PANEL_BYTES = ROWS * BF_TK * 2;
constexpr int BF_STAGE_BYTES = PANEL_BYTES + BF_TK * XS_LD * 4;
constexpr int SWIZZLE_BYTES = 1024;  // the 128-byte swizzle's atom: 8 rows
// the ring, and a swizzle atom's worth of room to align it
constexpr size_t BF_SMEM_BYTES = BF_STAGES * BF_STAGE_BYTES + SWIZZLE_BYTES;
static_assert(BF_TK * 2 == 128, "a step's panel row is one swizzled line");
static_assert(BF_STAGE_BYTES % SWIZZLE_BYTES == 0,
              "every stage's panel slice starts on a swizzle atom");
static_assert(ROWS * RED_LD * sizeof(float) <= BF_SMEM_BYTES - SWIZZLE_BYTES,
              "the partial tile fits in the ring");

// Byte of row i, columns 8 c8 .. 8 c8 + 7, of a staged panel slice: rows of
// 128 bytes whose 16-byte chunks are permuted by the row (chunk c8 at c8 ^
// (i % 8)), wgmma's K-major layout with the 128-byte swizzle.
__device__ __forceinline__ int swizzled(int i, int c8) {
  return i * 128 + ((c8 ^ (i % 8)) * 16);
}

// dst (on a swizzle atom) = src's (rows x depth) bf16 slice (row stride
// ld), zeros elsewhere, for fill rows, swizzled. Eight neighbouring threads
// copy one 128-byte line of a row.
__device__ __forceinline__ void stage_panel(
    unsigned char* dst, const unsigned short* __restrict__ src, int ld,
    int rows, int depth, int fill, bool vec) {
  if (vec) {  // depth % 8 == 0
    for (int e = threadIdx.x; e < fill * (BF_TK / 8); e += THREADS) {
      const int i = e / (BF_TK / 8);
      const int c8 = e % (BF_TK / 8);
      unsigned char* d = dst + swizzled(i, c8);
      if (i < rows && 8 * c8 < depth) {
        cp_async16(d, src + static_cast<size_t>(i) * ld + 8 * c8);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    for (int e = threadIdx.x; e < fill * BF_TK; e += THREADS) {
      const int i = e / BF_TK;
      const int c = e % BF_TK;
      unsigned short* d =
          reinterpret_cast<unsigned short*>(dst + swizzled(i, c / 8)) + c % 8;
      *d = i < rows && c < depth ? src[static_cast<size_t>(i) * ld + c]
                                 : static_cast<unsigned short>(0);
    }
  }
}

// Shared-memory descriptor of a K-major operand with the 128-byte swizzle
// starting at p: 8-row groups SWIZZLE_BYTES apart (the leading offset is
// unused); p + 32 bytes is the next 16 of K within the atom.
__device__ __forceinline__ uint64_t descriptor_sw128(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(SWIZZLE_BYTES >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// lo, hi rounded to bf16 (to nearest, ties to even), lo in the low half.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x 64, f32) = a (64 x 16, bf16 fragments in registers) * b (16 x 64,
// bf16 K-major in shared memory) + (accumulate ? d : 0); warpgroup-
// collective and asynchronous until wgmma_wait.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

// acc += X^T (the step's 64 x 64 f32 slice xs, N-major, rounded to bf16 as
// it is loaded) times P^T (the warpgroup's 64 rows of the step's panel
// slice ps). Accumulator 4 j + 2 h + c holds column 16 w + 8 h + g of the
// tile (wgmma's row) and row 64 wg + 8 j + 2 q + c (wgmma's column).
__device__ __forceinline__ void multiply_bf16(float (&acc)[NT / 2],
                                              const float* __restrict__ xs,
                                              const unsigned char* ps,
                                              const Frag& f) {
  const float* p = xs + 2 * f.q * XS_LD + 16 * f.w + f.g;
  uint32_t a[BF_TK / 16][4];
#pragma unroll
  for (int s = 0; s < BF_TK / 16; ++s) {
    const float* ps16 = p + 16 * s * XS_LD;
    a[s][0] = bf16x2(ps16[0], ps16[XS_LD]);
    a[s][1] = bf16x2(ps16[8], ps16[XS_LD + 8]);
    a[s][2] = bf16x2(ps16[8 * XS_LD], ps16[9 * XS_LD]);
    a[s][3] = bf16x2(ps16[8 * XS_LD + 8], ps16[9 * XS_LD + 8]);
  }
  const uint64_t b = descriptor_sw128(ps + f.wg * 64 * 128);
  float d[NT / 2];
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < BF_TK / 16; ++s) {
    wgmma_bf16(d, a[s], b + 32 / 16 * s, s > 0);  // 16 bf16 of K on
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int s = 0; s < BF_TK / 16; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_operand(a[s][e]);
#pragma unroll
  for (int e = 0; e < NT / 2; ++e) {
    fence_operand(d[e]);
    acc[e] += d[e];
  }
}

__global__ void __launch_bounds__(THREADS, 2)
panel_spmm_bf16_kernel(const int* __restrict__ slice_ptr,
                       const int* __restrict__ slice_slots,
                       const int* __restrict__ cols,
                       const unsigned short* __restrict__ panels,
                       const float* __restrict__ x, float* __restrict__ y,
                       int band_rows, int bk, int m, int k, int n, int slices,
                       int col_tiles, bool a16, bool x16, bool y16) {
  extern __shared__ float4 smem4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4);
  ring += (SWIZZLE_BYTES - smem_u32(ring) % SWIZZLE_BYTES) % SWIZZLE_BYTES;
  const RowTile t = row_tile(slices, col_tiles);
  const Frag f = frag();
  const int ranks = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int rows = min(ROWS, band_rows - t.i0);
  const int ncols = min(NT, n - t.n0);
  const int nq = (bk + BF_TK - 1) / BF_TK;  // steps a slot
  const int slice = t.r * slices + t.i0 / ROWS;
  const int first = slice_ptr[slice];
  const long long total =
      static_cast<long long>(slice_ptr[slice + 1] - first) * nq;
  const long long s0 = total * rank / ranks;
  const int steps = static_cast<int>(total * (rank + 1) / ranks - s0);

  auto issue = [&](int it, unsigned char* stage) {
    const long long s = s0 + it;
    const int b = slice_slots[first + static_cast<int>(s / nq)];
    const int k0 = static_cast<int>(s % nq) * BF_TK;
    const int depth = min(BF_TK, bk - k0);
    const long long xr0 = static_cast<long long>(cols[b]) * bk + k0;
    const long long x_left = static_cast<long long>(k) - xr0;
    const int x_depth = x_left < depth ? static_cast<int>(max(x_left, 0LL))
                                       : depth;
    stage_panel(stage,
                panels + (static_cast<size_t>(b) * band_rows + t.i0) * bk + k0,
                bk, rows, depth, rows > 64 ? ROWS : 64, a16);
    stage_nmajor<BF_TK, XS_LD>(
        reinterpret_cast<float*>(stage + PANEL_BYTES),
        x + static_cast<size_t>(xr0) * n + t.n0, n, x_depth, ncols, x16);
  };

  float acc[NT / 2] = {};
#pragma unroll
  for (int s = 0; s < BF_STAGES - 1; ++s) {
    if (s < steps) issue(s, ring + s * BF_STAGE_BYTES);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<BF_STAGES - 2>();
    fence_proxy_async();  // the copies land before the tensor cores read
    __syncthreads();      // step it has landed; step it - 1 is consumed
    const int next = it + BF_STAGES - 1;
    if (next < steps) {
      issue(next, ring + next % BF_STAGES * BF_STAGE_BYTES);
    }
    cp_async_commit();
    const unsigned char* stage = ring + it % BF_STAGES * BF_STAGE_BYTES;
    if (64 * f.wg < rows) {
      multiply_bf16(acc, reinterpret_cast<const float*>(stage + PANEL_BYTES),
                    stage, f);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the partial tile

  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        part[(64 * f.wg + 8 * j + 2 * f.q + c) * RED_LD + 16 * f.w + 8 * h +
             f.g] = acc[4 * j + 2 * h + c];
      }
  const long long row0 = static_cast<long long>(t.r) * band_rows + t.i0;
  const int out_rows = static_cast<int>(
      min(static_cast<long long>(rows), static_cast<long long>(m) - row0));
  sum_store(part, out_rows, ncols, [&](int i, int j, const float4& v) {
    float* p = y + static_cast<size_t>(row0 + i) * n + t.n0 + j;
    if (y16) {  // ncols % 4 == 0
      *reinterpret_cast<float4*>(p) = v;
      return;
    }
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

// out (int[6]) = {tiles, cluster, ROWS, NT, BF_TK, BF_STAGES} of the
// launch spgrid_panel_spmm_bf16 makes for these sizes at cluster 0.
extern "C" int spgrid_panel_spmm_bf16_shape(int bands, int band_rows, int n,
                                            void* out) {
  if (bands <= 0 || band_rows <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return report_shape(row_tiles(bands, band_rows, n), out, BF_TK, BF_STAGES);
}

// The bf16 form: panels as bf16 bit patterns, walked by the live-slice
// index (slice_ptr: bands x ceil(band_rows / 128) + 1 offsets into
// slice_slots). cluster: 0 for the launch rule, else 1, 2, 4 or 8.
extern "C" int spgrid_panel_spmm_bf16(const void* slice_ptr,
                                      const void* slice_slots,
                                      const void* cols, const void* panels,
                                      const void* x, void* y, int bands,
                                      int band_rows, int bk, int m, int k,
                                      int n, int cluster, void* stream) {
  if (bands <= 0 || band_rows <= 0 || bk <= 0 || m <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_tiles(
      panel_spmm_bf16_kernel, row_tiles(bands, band_rows, n), cluster,
      BF_SMEM_BYTES, stream, static_cast<const int*>(slice_ptr),
      static_cast<const int*>(slice_slots), static_cast<const int*>(cols),
      static_cast<const unsigned short*>(panels),
      static_cast<const float*>(x), static_cast<float*>(y), band_rows, bk, m,
      k, n, (band_rows + ROWS - 1) / ROWS, (n + NT - 1) / NT,
      bk % 8 == 0 && aligned16(panels), n % 4 == 0 && aligned16(x),
      n % 4 == 0 && aligned16(y));
}
