// Two gather probes: a row gather by asynchronous per-row copies
// (dma_gather) and a chain of dependent in-row gathers (shuffle_bench).
//
// Replaces: scripts/exp_pallas_gather.py, dma_gather (the Pallas TPU probe
// that fetched each row x[idx] with its own HBM-to-VMEM DMA into a scratch
// of two halves of G/2 rows, G rows a grid step) and shuffle_bench (a
// chain of `reps` dependent take_along_axis lane gathers plus 1.0 on one
// resident (256, 128) tile).
//
// dma_gather: out (steps * G, n) = x[idx.reshape(-1)], idx (steps, G).
//   Bound on the H100: device-memory bytes: each distinct gathered row read
//   once and each output row written once (at the probe's X of 65536 x 512
//   f32, 134 MB and past the 50 MB L2, and 24,576 rows of 2 KB: ~0.1 GB,
//   ~30 us at 3.35 TB/s). Nothing is computed.
//   Design: the output is one contiguous range of rows whatever G is; G
//   only shaped the TPU's grid, so the kernel does not keep a CTA a step,
//   and its times at G = 64 and 256 are those of one design. When a row is
//   a multiple of 16 bytes and x and out are 16-byte aligned (BULK), a
//   persistent grid of one-warp CTAs, as many as the SMs hold at the ring's
//   shared memory, takes chunks of R consecutive output rows in a
//   grid-stride loop. Each CTA keeps a ring of S stages of R rows in shared
//   memory that never drains between chunks: each row arrives by its own
//   cp.async.bulk (the TMA's bulk copy, global to shared), completed on its
//   stage's mbarrier; a landed chunk leaves by one cp.async.bulk of the whole
//   stage to its contiguous output range (shared to global, a bulk group),
//   and a stage is refilled only after cp.async.bulk.wait_group.read says
//   its store has read it, so S - 1 chunks arrive while one leaves. No
//   write-back through registers, no divide and no CTA-wide barrier in the
//   steady state: the warp's lanes issue one row's copy each and lane 0 the
//   store. A row whose index lies outside x is never read: its lanes zero it
//   in the stage behind fence.proxy.async before the store. The rule
//   (ring_for, here only) takes stages of about 32 KB, R = 32 KB / 4n rows
//   (1 to 32), and S = 6 of them where they fit; a caller may force S and R
//   for a sweep. The stores carry no L2 hint: an evict_first store was tried
//   and its effect lay inside the run-to-run spread. Otherwise, one CTA a
//   step stages its rows in chunks of at most 32 rows and 32 KB, two chunks
//   in flight, each row copied by 4-byte cp.async (one commit group a
//   chunk) and written out by the threads: any n is taken. The result is
//   exact: it is a copy.
//
// shuffle_bench: acc = src; `reps` times acc = take_along_axis(acc, idx, 1)
//   + 1.0; out = acc. src and idx (rows, 128).
//   Bound on the H100: operations: one f32 add an element a step (8.4 MFLOP
//   at 256 x 128 and 256 steps, ~0.13 us at 67 TFLOP/s) against 0.4 MB of
//   src, idx and out (~0.1 us). The chain is serial: its latency, not
//   either bound, sets the time, which is what the probe measures.
//   Design: the rows are independent (the gather runs along axis 1), so a
//   CTA is one warp and owns one row, and the 256 rows of the probe spread
//   over every SM (at most 2 chains an SM). The row lives in registers:
//   lane t holds elements t + 32q, q = 0..3, and its indices, split into
//   the source lane (idx & 31) and register (idx >> 5). A step gathers each
//   of its 4 elements by one __shfl_sync of every register from the source
//   lane (16 shuffles) and a select by register, then adds 1.0: no shared
//   memory, no store and no barrier on the chain. Each step still gathers
//   from the one before: composing the index map would give the same bits
//   without the dependent gathers the probe exists to time. All steps run
//   inside one launch. The result is exact: the same f32 additions in the
//   same order. An index outside the row reads 0.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int LANE = 128;
constexpr int THREADS = 256;            // dma_gather CTA, 4-byte copies
constexpr int MAX_CHUNK_ROWS = 32;
constexpr int STAGE_BYTES = 32 * 1024;  // one chunk's shared memory
constexpr int MAX_STAGES = 8;           // dma_gather ring (BULK)
constexpr int RING_STAGES = 6;          // the rule's S where it fits
constexpr int MAX_RING_ROWS = 32;       // a lane a row of a chunk
constexpr int MAX_RING_BYTES = 232448 - 1024;  // 227 KB less static
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Orders this thread's earlier generic accesses to shared memory before
// later asynchronous-proxy (bulk copy) writes to it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t"
      "}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One stage to its output range (shared to global), in this thread's
// current bulk group.
__device__ __forceinline__ void bulk_copy_s2g(void* dst, const void* src,
                                              unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until all but this thread's newest bulk group have read their
// shared memory.
__device__ __forceinline__ void bulk_wait_read_all_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

int chunk_rows_words(int G, int n) {
  int r = STAGE_BYTES / (4 * n);
  if (r < 1) r = 1;
  if (r > MAX_CHUNK_ROWS) r = MAX_CHUNK_ROWS;
  return r < G ? r : G;
}

// 4-byte cp.async copies and float stores: any n, any alignment.
__global__ void __launch_bounds__(THREADS)
dma_gather_words(const float* __restrict__ x, const int* __restrict__ idx,
                 float* __restrict__ out, int k, int n, int G, int R) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const size_t stage_floats = static_cast<size_t>(R) * n;
  const int tid = threadIdx.x;
  const int* step_idx = idx + static_cast<size_t>(blockIdx.x) * G;
  float* step_out = out + static_cast<size_t>(blockIdx.x) * G * n;
  const int chunks = (G + R - 1) / R;

  // start the copies of chunk c into stage c & 1
  auto issue = [&](int c) {
    const int r0 = c * R;
    const int rows = min(R, G - r0);
    float* s = smem + (c & 1) * stage_floats;
    for (int r = 0; r < rows; ++r) {
      const int g = step_idx[r0 + r];
      if (g < 0 || g >= k) continue;
      const float* src = x + static_cast<size_t>(g) * n;
      for (int j = tid; j < n; j += THREADS) {
        cp_async4(s + static_cast<size_t>(r) * n + j, src + j);
      }
    }
    cp_async_commit();
  };

  issue(0);
  if (chunks > 1) {
    issue(1);
  } else {
    cp_async_commit();  // an empty group keeps the wait count uniform
  }
  for (int c = 0; c < chunks; ++c) {
    const int r0 = c * R;
    const int rows = min(R, G - r0);
    const float* s = smem + (c & 1) * stage_floats;
    cp_async_wait_all_but_one();
    __syncthreads();
    float* dst = step_out + static_cast<size_t>(r0) * n;
    const int total = rows * n;
    for (int e = tid; e < total; e += THREADS) {
      const int r = e / n;
      const int g = step_idx[r0 + r];
      dst[e] = (g >= 0 && g < k) ? s[e] : 0.0f;
    }
    if (c + 2 < chunks) {
      __syncthreads();  // every thread is done with stage c & 1
      issue(c + 2);
    } else {
      cp_async_commit();
    }
  }
}

// BULK: a persistent CTA of one warp; chunk i of this CTA is chunk
// blockIdx.x + i * gridDim.x of the output, R rows from row R times that,
// in stage i % S, landing in phase (i / S) & 1 of its mbarrier.
__global__ void __launch_bounds__(32)
dma_gather_ring(const float* __restrict__ x, const int* __restrict__ idx,
                float* __restrict__ out, int k, int n, long long total,
                int R, int S) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t landed[MAX_STAGES];
  __shared__ unsigned dead[MAX_STAGES];  // rows of a stage outside x
  const int lane = threadIdx.x;
  const unsigned row_bytes = 4u * static_cast<unsigned>(n);
  const size_t stage_bytes = static_cast<size_t>(R) * row_bytes;
  const long long chunks = (total + R - 1) / R;
  const long long first = blockIdx.x;
  const long long stride = gridDim.x;
  if (first >= chunks) return;
  const long long mine = (chunks - 1 - first) / stride + 1;
  if (lane == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&landed[s], 1);
    fence_mbar_init();
  }
  __syncwarp();

  // lane l starts the copy of row l of chunk i into its stage
  auto load = [&](long long i) {
    const long long r0 = (first + i * stride) * R;
    const int rows = static_cast<int>(min(static_cast<long long>(R),
                                          total - r0));
    const int s = static_cast<int>(i % S);
    const int g = lane < rows ? idx[r0 + lane] : 0;
    const bool live = lane < rows && g >= 0 && g < k;
    const unsigned live_rows = __ballot_sync(FULL, live);
    const unsigned dead_rows = __ballot_sync(FULL, lane < rows && !live);
    if (lane == 0) {
      dead[s] = dead_rows;
      mbar_arrive_expect_tx(&landed[s], __popc(live_rows) * row_bytes);
    }
    __syncwarp();
    unsigned char* const dst = ring + s * stage_bytes + lane * row_bytes;
    const float* const src = x + static_cast<size_t>(g) * n;
    if (live) bulk_copy_g2s(dst, src, row_bytes, &landed[s]);
  };

  for (long long i = 0; i < S && i < mine; ++i) load(i);
  for (long long i = 0; i < mine; ++i) {
    const int s = static_cast<int>(i % S);
    mbar_wait(&landed[s], static_cast<unsigned>((i / S) & 1));
    const long long r0 = (first + i * stride) * R;
    const int rows = static_cast<int>(min(static_cast<long long>(R),
                                          total - r0));
    unsigned char* stage = ring + s * stage_bytes;
    const unsigned dead_rows = dead[s];
    if (dead_rows != 0) {  // rare: zero the rows outside x, then fence
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (unsigned d = dead_rows; d != 0; d &= d - 1) {
        float4* row = reinterpret_cast<float4*>(
            stage + static_cast<size_t>(__ffs(d) - 1) * row_bytes);
        for (int j = lane; j < n / 4; j += 32) row[j] = zero;
      }
      fence_proxy_async();
      __syncwarp();
    }
    if (lane == 0) {
      bulk_copy_s2g(out + r0 * n, stage,
                    static_cast<unsigned>(rows) * row_bytes);
      bulk_commit();
    }
    // refill the stage of chunk i - 1 once its store has read it
    const long long next = i - 1 + S;
    if (i >= 1 && next < mine) {
      if (lane == 0) bulk_wait_read_all_but_one();
      __syncwarp();
      load(next);
    }
  }
  if (lane == 0) bulk_wait_all();
}

__global__ void __launch_bounds__(32)
shuffle_bench_kernel(const float* __restrict__ src,
                     const int* __restrict__ idx, float* __restrict__ out,
                     int reps) {
  const int lane = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * LANE;
  float r[4];    // acc[lane + 32 q]
  int from[4];   // the lane that holds acc[idx], in register reg
  int reg[4];
  bool ok[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = lane + 32 * q;
    r[q] = src[row + j];
    const int id = idx[row + j];
    ok[q] = id >= 0 && id < LANE;
    from[q] = id & 31;
    reg[q] = ok[q] ? id >> 5 : 0;
  }
  for (int step = 0; step < reps; ++step) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float s[4];
#pragma unroll
      for (int q2 = 0; q2 < 4; ++q2) {
        s[q2] = __shfl_sync(FULL, r[q2], from[q]);
      }
      const float g = reg[q] < 2 ? (reg[q] == 0 ? s[0] : s[1])
                                 : (reg[q] == 2 ? s[2] : s[3]);
      v[q] = (ok[q] ? g : 0.0f) + 1.0f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) r[q] = v[q];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) out[row + lane + 32 * q] = r[q];
}

// The BULK path's launch: S stages of R rows, its shared memory and CTAs.
struct Ring {
  int stages, rows, ctas;
  size_t smem;
};

// Resolves stages and chunk_rows (0: the rule's) for rows of n floats,
// sets the kernel's shared memory and counts the CTAs of its persistent
// grid for `total` output rows on the current card.
cudaError_t ring_for(int n, long long total, int stages, int chunk_rows,
                     Ring* ring) {
  const size_t row_bytes = 4 * static_cast<size_t>(n);
  int R = chunk_rows;
  if (R == 0) {
    R = static_cast<int>(std::min<size_t>(
        MAX_RING_ROWS, std::max<size_t>(1, STAGE_BYTES / row_bytes)));
  }
  int S = stages;
  if (S == 0 && R >= 1 && R <= MAX_RING_ROWS) {
    S = static_cast<int>(std::max<size_t>(
        2, std::min<size_t>(RING_STAGES, MAX_RING_BYTES / (R * row_bytes))));
  }
  if (n < 4 || n % 4 != 0 || S < 2 || S > MAX_STAGES || R < 1 ||
      R > MAX_RING_ROWS || static_cast<size_t>(S) * R * row_bytes >
                               static_cast<size_t>(MAX_RING_BYTES)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = static_cast<size_t>(S) * R * row_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      dma_gather_ring, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int per_sm = 0, device = 0, sms = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dma_gather_ring, 32, smem);
  }
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch checks clean
    return err;
  }
  const long long chunks = (total + R - 1) / R;
  *ring = Ring{S, R,
               static_cast<int>(std::min<long long>(
                   chunks, static_cast<long long>(per_sm) * sms)),
               smem};
  return cudaSuccess;
}

}  // namespace

// out (int[3]) = {S, R, CTAs}: the BULK path's ring and persistent grid for
// steps * G rows of n floats (n % 4 == 0) at stages and chunk_rows (0: the
// rule's), as spgrid_dma_gather launches it on the current card.
extern "C" int spgrid_dma_gather_shape(int n, int steps, int G, int stages,
                                       int chunk_rows, void* out) {
  if (steps < 1 || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  Ring ring;
  const cudaError_t err = ring_for(
      n, static_cast<long long>(steps) * G, stages, chunk_rows, &ring);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* const shape = static_cast<int*>(out);
  shape[0] = ring.stages;
  shape[1] = ring.rows;
  shape[2] = ring.ctas;
  return static_cast<int>(cudaSuccess);
}

// stages (2..8) and chunk_rows (1..32), or 0 for the rule's: the ring of
// the BULK path, S stages of R rows (S R n 4 bytes at most 227 KB less
// 1 KB); grid (int*, or NULL): the CTAs launched.
extern "C" int spgrid_dma_gather(const void* x, const void* idx, void* out,
                                 int k, int n, int steps, int G, int stages,
                                 int chunk_rows, void* grid, void* stream) {
  if (n < 1 || G < 1 || steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* const grid_out = static_cast<int*>(grid);
  if (grid_out != nullptr) *grid_out = 0;
  if (steps == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bulk = n % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!bulk) {
    const int R = chunk_rows_words(G, n);
    const size_t smem = 2 * sizeof(float) * static_cast<size_t>(R) * n;
    const cudaError_t attr = cudaFuncSetAttribute(
        dma_gather_words, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch checks clean
      return static_cast<int>(attr);
    }
    dma_gather_words<<<steps, THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(idx),
        static_cast<float*>(out), k, n, G, R);
    if (grid_out != nullptr) *grid_out = steps;
    return static_cast<int>(cudaGetLastError());
  }
  const long long total = static_cast<long long>(steps) * G;
  Ring ring;
  const cudaError_t err = ring_for(n, total, stages, chunk_rows, &ring);
  if (err != cudaSuccess) return static_cast<int>(err);
  dma_gather_ring<<<ring.ctas, 32, ring.smem, s>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx),
      static_cast<float*>(out), k, n, total, ring.rows, ring.stages);
  if (grid_out != nullptr) *grid_out = ring.ctas;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spgrid_shuffle_bench(const void* src, const void* idx,
                                    void* out, int rows, int reps,
                                    void* stream) {
  if (reps < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  shuffle_bench_kernel<<<rows, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const int*>(idx),
      static_cast<float*>(out), reps);
  return static_cast<int>(cudaGetLastError());
}
