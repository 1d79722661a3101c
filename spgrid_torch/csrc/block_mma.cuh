// The 3xTF32 tensor-core tile that bsr_spmm.cu, panel_spmm.cu and sddmm.cu
// share.
//
// A CTA of two warpgroups owns a ROWS x NT (128 x 64) output tile and
// computes a range of its contraction in steps of TK = 32: each step's A
// slice (ROWS x TK, depth contiguous) and B slice (TK x NT, staged in the
// layout its operand has in device memory) come in by cp.async through a
// ring of STAGES steps, B is split once a step into TF32 hi and lo K-major
// core matrices, and each warpgroup multiplies its 64 rows with wgmma
// m64n64k8, A in registers, split there (`split_nmajor` and `multiply` of
// tf32x3.cuh, which bsr_spmm_cstat.cu runs at NT = 64 and 128). A step's
// products go to fresh accumulators that are then added to the running f32
// sum: the tensor cores truncate their accumulate.
//
// A tile's contraction may be split across a thread-block cluster of up to
// CLUSTER_MAX CTAs, rank r taking steps [S r / C, S (r + 1) / C) of the
// tile's S steps, so that a grid of few tiles still fills the card
// (`cluster_for` picks C from the grid and the card's SMs). Each
// CTA leaves its partial tile in its own shared memory; after a cluster
// barrier, every output element is summed over the ranks' partial tiles in
// rank order through distributed shared memory and stored once, by one
// rank: no atomics, one fixed order, so two calls give the same bits.
#pragma once

#include <cooperative_groups.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "tf32x3.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int ROWS = 128;       // tile rows, two warpgroups of 64
constexpr int NT = 64;          // tile columns
constexpr int STAGES = 3;       // steps in the ring: two CTAs an SM
constexpr int CLUSTER_MAX = 8;  // the portable cluster size
constexpr int X_LD = n_major_ld<NT>;  // row stride of a B slice, N-major
constexpr int A_FLOATS = ROWS * A_LD;
// A step's B slice: NT rows of A_LD (K-major) or TK rows of X_LD (N-major).
constexpr int B_FLOATS = NT * A_LD;
static_assert(TK * X_LD == B_FLOATS, "both B layouts fill one slot");
constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
// A step's split B, B_hi then B_lo, K-major in 8 x 16-byte core matrices:
// [8 columns][TK / 4][8][4 depths].
constexpr int SB_FLOATS = NT * TK;
constexpr int RED_LD = NT + 8;  // row stride of the partial tile
static_assert(ROWS * RED_LD <= STAGES * STAGE_FLOATS,
              "the partial tile fits in the ring");
constexpr size_t SMEM_BYTES =
    sizeof(float) * (2 * SB_FLOATS + STAGES * STAGE_FLOATS);

// dst[i][c] (row stride A_LD) = src[i * ld + c] for i < nrows and c <
// depth, 0 elsewhere, for i < fill rows: 16-byte copies where `vec` (src
// rows start on 16 B and depth % 4 == 0), else 4-byte ones.
__device__ __forceinline__ void stage_kmajor(float* dst,
                                             const float* __restrict__ src,
                                             size_t ld, int nrows, int depth,
                                             int fill, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < fill * (TK / 4); e += THREADS) {
      const int i = e / (TK / 4);
      const int c = e % (TK / 4) * 4;
      float* d = dst + i * A_LD + c;
      if (i < nrows && c < depth) {
        cp_async16(d, src + i * ld + c);
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int e = threadIdx.x; e < fill * TK; e += THREADS) {
      const int i = e / TK;
      const int c = e % TK;
      float* d = dst + i * A_LD + c;
      if (i < nrows && c < depth) {
        cp_async4(d, src + i * ld + c);
      } else {
        *d = 0.0f;
      }
    }
  }
}

// dst[kk][j] (row stride LD) = src[kk * ld + j] for kk < depth and j <
// ncols, 0 elsewhere, for kk < DEPTH: 16-byte copies where `vec` (src rows
// start on 16 B and ncols % 4 == 0), else 4-byte ones.
template <int DEPTH = TK, int LD = X_LD>
__device__ __forceinline__ void stage_nmajor(float* dst,
                                             const float* __restrict__ src,
                                             size_t ld, int depth, int ncols,
                                             bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < DEPTH * (NT / 4); e += THREADS) {
      const int kk = e / (NT / 4);
      const int j = e % (NT / 4) * 4;
      float* d = dst + kk * LD + j;
      if (kk < depth && j < ncols) {
        cp_async16(d, src + kk * ld + j);
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int e = threadIdx.x; e < DEPTH * NT; e += THREADS) {
      const int kk = e / NT;
      const int j = e % NT;
      float* d = dst + kk * LD + j;
      if (kk < depth && j < ncols) {
        cp_async4(d, src + kk * ld + j);
      } else {
        *d = 0.0f;
      }
    }
  }
}

// A B slice staged K-major (NT rows of depth, stride A_LD) split into core
// matrices: a core-matrix row is 4 neighbouring depths, one float4.
__device__ __forceinline__ void split_kmajor(const float* __restrict__ bs,
                                             float* __restrict__ sb) {
  for (int e = threadIdx.x; e < NT * (TK / 4); e += THREADS) {
    const int r = e % 8;
    const int k4 = e / 8 % (TK / 4);
    const int grp = e / (8 * (TK / 4));
    const float4 v =
        *reinterpret_cast<const float4*>(bs + (8 * grp + r) * A_LD + 4 * k4);
    const float w[4] = {v.x, v.y, v.z, v.w};
    store_split<NT>(sb, ((grp * (TK / 4) + k4) * 8 + r) * 4, w);
  }
}

// The ring: `issue(it, stage)` stages step it of this CTA's range into a
// stage (cp.async, zeros for what it does not copy), `split_b(b_slice, sb)`
// splits a staged B slice. Every thread commits one group an iteration, so
// the wait counts hold. Warpgroups whose rows lie past the tile's `rows`
// stage and split with the others but do not multiply.
template <class Issue, class SplitB>
__device__ __forceinline__ void mainloop(float (&acc)[NT / 2], float* ring,
                                         float* sb, int steps, int rows,
                                         const Frag& f, Issue issue,
                                         SplitB split_b) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) issue(s, ring + s * STAGE_FLOATS);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step it has landed; step it - 1 is consumed
    const int next = it + STAGES - 1;
    if (next < steps) issue(next, ring + next % STAGES * STAGE_FLOATS);
    cp_async_commit();
    const float* as = ring + it % STAGES * STAGE_FLOATS;
    split_b(as + A_FLOATS, sb);
    fence_proxy_async();
    __syncthreads();  // the split B slice is in place
    if (64 * f.wg < rows) multiply<NT>(acc, as, sb, f);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the partial tile
}

// Sums the cluster's partial tiles, each rank's in `part` (ROWS x W, row
// stride LD: NT and RED_LD unless a tile says otherwise), and stores each
// element of the tile's rows x ncols once, the CTA's CTA_THREADS threads
// sharing the work: `store(i, j, v)` gets v = the sums of columns j .. j +
// 3 of row i (j % 4 == 0; columns >= ncols hold garbage).
template <int W = NT, int LD = RED_LD, int CTA_THREADS = THREADS,
          class Store>
__device__ __forceinline__ void sum_store(float* part, int rows, int ncols,
                                          Store store) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every rank's partial tile is in place
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  for (int e = rank * CTA_THREADS + threadIdx.x; e < rows * (W / 4);
       e += ranks * CTA_THREADS) {
    const int i = e / (W / 4);
    const int j = e % (W / 4) * 4;
    if (j >= ncols) continue;
    const int at = i * LD + j;
    float4 v = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(part, 0) + at);
    for (int q = 1; q < ranks; ++q) {
      const float4 u = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, q) + at);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    store(i, j, v);
  }
  cluster.sync();  // no rank leaves while another reads its tile
}

// sum_store of the tiles whose accumulators `acc` hold in the Frag layout,
// each rank's partial tile laid out at the start of its ring.
template <class Store>
__device__ __forceinline__ void reduce_store(const float (&acc)[NT / 2],
                                             float* ring, int rows, int ncols,
                                             const Frag& f, Store store) {
  float* part = ring;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * f.wg + 16 * f.w + 8 * h + f.g;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      *reinterpret_cast<float2*>(part + r * RED_LD + 8 * j + 2 * f.q) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  sum_store(part, rows, ncols, store);
}

// A tile of a row-tiled product (bsr_spmm.cu, panel_spmm.cu): row of
// blocks r, its rows i0 .. i0 + 127, X's columns n0 .. n0 + NT - 1; the
// tiles run along X's columns first, then a row's slices, then the rows,
// each on the `cluster` CTAs of one cluster.
struct RowTile {
  int r, i0, n0;
};

__device__ __forceinline__ RowTile row_tile(int slices, int col_tiles) {
  const int tile =
      blockIdx.x / static_cast<int>(cg::this_cluster().num_blocks());
  return RowTile{tile / col_tiles / slices,
                 tile / col_tiles % slices * ROWS, tile % col_tiles * NT};
}

// The same over a list of slices (slice s = row of blocks s / slices, its
// rows (s % slices) 128 on), tiles of W columns: the launch's q-th slice is
// list[q], or q where list is null.
template <int W>
__device__ __forceinline__ RowTile listed_tile(const int* __restrict__ list,
                                               int slices, int col_tiles) {
  const int tile =
      blockIdx.x / static_cast<int>(cg::this_cluster().num_blocks());
  const int q = tile / col_tiles;
  const int s = list != nullptr ? __ldg(list + q) : q;
  return RowTile{s / slices, s % slices * ROWS, tile % col_tiles * W};
}

// The tiles of a row-tiled launch: rows of blocks x 128-row slices of a
// block's bm rows x 64-column tiles of n.
long long row_tiles(int rows_of_blocks, int bm, int n) {
  return static_cast<long long>(rows_of_blocks) * ((bm + ROWS - 1) / ROWS) *
         ((n + NT - 1) / NT);
}

// This CTA's share of row tile t of Y = A @ X, A's row t.r made of the
// (bm, bk) blocks begin .. end - 1 of `blocks`, block b at block column
// cols[b]:
//   Y[t.r bm + t.i0 + i, t.n0 + j] =
//       sum_b blocks[b][t.i0 + i, :] . X[cols[b] bk + :, t.n0 + j].
// The tile's steps (its blocks times TK of each block's bk columns) are
// split across the cluster, rank r taking [S r / C, S (r + 1) / C); a step
// stages the block's (rows x 32) slice and X's (32 x 64) slice (N-major in
// device memory, split into K-major core matrices). Every element of the
// tile inside the block's rows and inside Y (row < m, column < n) is
// written once, zeros included (a row with no block writes zeros); X rows
// >= k read as zero. Blocks and X are staged by 16-byte cp.async where
// `a16` (bk % 4 == 0, blocks on 16 B) and `x16` (n % 4 == 0, X on 16 B),
// else by 4-byte copies; `y16` (n % 4 == 0, Y on 16 B) stores float4s.
__device__ __forceinline__ void row_tile_spmm(
    const RowTile& t, int begin, int end, const int* __restrict__ cols,
    const float* __restrict__ blocks, const float* __restrict__ x,
    float* __restrict__ y, int bm, int bk, int m, int k, int n, bool a16,
    bool x16, bool y16) {
  extern __shared__ float4 smem4[];
  float* sb = reinterpret_cast<float*>(smem4);  // split X slice
  float* ring = sb + 2 * SB_FLOATS;
  const Frag f = frag();
  const int ranks = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int rows = min(ROWS, bm - t.i0);
  const int ncols = min(NT, n - t.n0);
  const int nq = (bk + TK - 1) / TK;  // steps a block
  const long long total = static_cast<long long>(end - begin) * nq;
  const long long s0 = total * rank / ranks;
  const int steps = static_cast<int>(total * (rank + 1) / ranks - s0);

  auto issue = [&](int it, float* as) {
    const long long s = s0 + it;
    const int b = begin + static_cast<int>(s / nq);
    const int k0 = static_cast<int>(s % nq) * TK;
    const long long xr0 = static_cast<long long>(cols[b]) * bk + k0;
    const long long x_left = static_cast<long long>(k) - xr0;
    const int depth = min(TK, bk - k0);
    const int x_depth = x_left < depth ? static_cast<int>(max(x_left, 0LL))
                                       : depth;
    stage_kmajor(as, blocks + (static_cast<size_t>(b) * bm + t.i0) * bk + k0,
                 bk, rows, depth, rows > 64 ? ROWS : 64, a16);
    stage_nmajor(as + A_FLOATS, x + static_cast<size_t>(xr0) * n + t.n0, n,
                 x_depth, ncols, x16);
  };
  float acc[NT / 2] = {};
  mainloop(acc, ring, sb, steps, rows, f, issue,
           [](const float* xs, float* to) { split_nmajor<NT>(xs, to); });

  const long long row0 = static_cast<long long>(t.r) * bm + t.i0;
  const int out_rows = static_cast<int>(
      min(static_cast<long long>(rows), static_cast<long long>(m) - row0));
  reduce_store(acc, ring, out_rows, ncols, f,
               [&](int i, int j, const float4& v) {
                 float* p = y + static_cast<size_t>(row0 + i) * n + t.n0 + j;
                 if (y16) {  // ncols % 4 == 0
                   *reinterpret_cast<float4*>(p) = v;
                   return;
                 }
                 const float w[4] = {v.x, v.y, v.z, v.w};
                 for (int c = 0; c < 4 && j + c < ncols; ++c) p[c] = w[c];
               });
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The cluster a launch of `tiles` tiles takes: the largest power of two up
// to CLUSTER_MAX for which tiles x cluster CTAs still fit on the current
// card's SMs / `share`, one an SM (1 when the tiles alone fill them).
int cluster_for(long long tiles, int share = 1) {
  int device = 0;
  int sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int cluster = 1;
  while (cluster < CLUSTER_MAX && tiles * cluster * 2 * share <= sms) {
    cluster *= 2;
  }
  return cluster;
}

// out (int[6]) = {tiles, cluster, ROWS, cols, step, stages}: the launch of
// `tiles` tiles of `cols` columns that launch_clusters makes at cluster 0,
// for a kernel whose steps are `step` deep through a ring of `stages`.
int report_shape(long long tiles, void* out, int step = TK,
                 int stages = STAGES, int cols = NT, int share = 1) {
  if (tiles < 1 || tiles > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* shape = static_cast<int*>(out);
  shape[0] = static_cast<int>(tiles);
  shape[1] = cluster_for(tiles, share);
  shape[2] = ROWS;
  shape[3] = cols;
  shape[4] = step;
  shape[5] = stages;
  return static_cast<int>(cudaGetLastError());
}

// Launches `kernel` on tiles x cluster CTAs of `threads` threads in
// clusters of `cluster` along x, `smem` bytes of dynamic shared memory
// each. Cluster 0 takes `cluster_for`'s at `share`; 1, 2, 4 or 8 forces
// that size (for tests and sweeps).
template <class... Params, class... Args>
int launch_cta_tiles(void (*kernel)(Params...), long long tiles, int cluster,
                     size_t smem, int threads, int share, void* stream,
                     Args... args) {
  if (cluster == 0 && tiles >= 1) cluster = cluster_for(tiles, share);
  if (cluster < 1 || cluster > CLUSTER_MAX || (cluster & (cluster - 1)) != 0 ||
      tiles < 1 || tiles * cluster > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) {
    cudaGetLastError();  // clear it, so that the next launch's check is clean
    return static_cast<int>(attr);
  }
  cudaLaunchAttribute dims[1];
  dims[0].id = cudaLaunchAttributeClusterDimension;
  dims[0].val.clusterDim.x = cluster;
  dims[0].val.clusterDim.y = 1;
  dims[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(tiles * cluster));
  config.blockDim = dim3(static_cast<unsigned>(threads));
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = dims;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// launch_cta_tiles with CTAs of THREADS threads.
template <class... Params, class... Args>
int launch_tiles(void (*kernel)(Params...), long long tiles, int cluster,
                 size_t smem, void* stream, Args... args) {
  return launch_cta_tiles(kernel, tiles, cluster, smem, THREADS, 1, stream,
                          args...);
}

// launch_tiles with the 3xTF32 tile's SMEM_BYTES.
template <class... Params, class... Args>
int launch_clusters(void (*kernel)(Params...), long long tiles, int cluster,
                    void* stream, Args... args) {
  return launch_tiles(kernel, tiles, cluster, SMEM_BYTES, stream, args...);
}

}  // namespace
