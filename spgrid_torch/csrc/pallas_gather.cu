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
//   Design: one CTA a step (G rows). The TPU's scratch of (2, G/2, n) is
//   512 KB at G = 256 and n = 512, more than a CTA's 227 KB, so the CTA
//   stages its rows in chunks of at most 32 rows and 32 KB, two chunks in
//   flight (as the TPU kernel kept two halves): while one landed chunk is
//   written out with coalesced stores (a step's output rows are one
//   contiguous range), the next is arriving. Each row is copied from global
//   to shared memory asynchronously: with one cp.async.bulk a row (the
//   TMA's bulk copy, completed on an mbarrier that counts the chunk's
//   bytes) when a row is a multiple of 16 bytes and x and out are 16-byte
//   aligned, and with 4-byte cp.async copies (one commit group a chunk)
//   otherwise, so any n is taken. An index outside x gives a row of zeros
//   and is never read. The result is exact: it is a copy.
//
// shuffle_bench: acc = src; `reps` times acc = take_along_axis(acc, idx, 1)
//   + 1.0; out = acc. src and idx (rows, 128).
//   Bound on the H100: operations: one f32 add an element a step (8.4 MFLOP
//   at 256 x 128 and 256 steps, ~0.13 us at 67 TFLOP/s) against 0.4 MB of
//   src, idx and out (~0.1 us). The chain is serial: its latency, not
//   either bound, sets the time, which is what the probe measures.
//   Design: the rows are independent (the gather runs along axis 1), so one
//   warp owns a 128-wide row, 4 elements a lane, its indices held in
//   registers, and ping-pongs the row between two 128-float buffers in
//   shared memory with __syncwarp() between steps. All steps run inside one
//   launch. The result is exact: the same f32 additions in the same order.
//   An index outside the row reads 0.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int LANE = 128;
constexpr int THREADS = 256;            // dma_gather CTA
constexpr int MAX_CHUNK_ROWS = 32;
constexpr int STAGE_BYTES = 32 * 1024;  // one chunk's shared memory
constexpr int SHUFFLE_WARPS = 4;        // rows a shuffle_bench CTA

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

int chunk_rows(int G, int n) {
  int r = STAGE_BYTES / (4 * n);
  if (r < 1) r = 1;
  if (r > MAX_CHUNK_ROWS) r = MAX_CHUNK_ROWS;
  return r < G ? r : G;
}

// BULK: one cp.async.bulk a row (n % 4 == 0, 16-byte aligned x and out),
// float4 stores; else 4-byte cp.async copies and float stores.
template <bool BULK>
__global__ void __launch_bounds__(THREADS)
dma_gather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                  float* __restrict__ out, int k, int n, int G, int R) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const size_t stage_floats = static_cast<size_t>(R) * n;
  __shared__ uint64_t bars[2];
  const int tid = threadIdx.x;
  const int* step_idx = idx + static_cast<size_t>(blockIdx.x) * G;
  float* step_out = out + static_cast<size_t>(blockIdx.x) * G * n;
  const int chunks = (G + R - 1) / R;
  const unsigned row_bytes = 4u * static_cast<unsigned>(n);

  if (BULK) {
    if (tid == 0) {
      mbar_init(&bars[0], 1);
      mbar_init(&bars[1], 1);
      fence_mbar_init();
    }
    __syncthreads();
  }

  // start the copies of chunk c into stage c & 1
  auto issue = [&](int c) {
    const int r0 = c * R;
    const int rows = min(R, G - r0);
    float* s = smem + (c & 1) * stage_floats;
    if (BULK) {
      if (tid < 32) {  // warp 0: lane l copies row l of the chunk
        const int g = tid < rows ? step_idx[r0 + tid] : -1;
        const bool live = g >= 0 && g < k;
        const unsigned live_rows = __popc(__ballot_sync(0xffffffffu, live));
        if (tid == 0) mbar_arrive_expect_tx(&bars[c & 1],
                                            live_rows * row_bytes);
        __syncwarp();
        if (live) {
          bulk_copy_g2s(s + static_cast<size_t>(tid) * n,
                        x + static_cast<size_t>(g) * n, row_bytes,
                        &bars[c & 1]);
        }
      }
    } else {
      for (int r = 0; r < rows; ++r) {
        const int g = step_idx[r0 + r];
        if (g < 0 || g >= k) continue;
        const float* src = x + static_cast<size_t>(g) * n;
        for (int j = tid; j < n; j += THREADS) {
          cp_async4(s + static_cast<size_t>(r) * n + j, src + j);
        }
      }
      cp_async_commit();
    }
  };

  issue(0);
  if (chunks > 1) {
    issue(1);
  } else if (!BULK) {
    cp_async_commit();  // an empty group keeps the wait count uniform
  }
  for (int c = 0; c < chunks; ++c) {
    const int r0 = c * R;
    const int rows = min(R, G - r0);
    const float* s = smem + (c & 1) * stage_floats;
    if (BULK) {
      mbar_wait(&bars[c & 1], (c >> 1) & 1);
    } else {
      cp_async_wait_all_but_one();
      __syncthreads();
    }
    float* dst = step_out + static_cast<size_t>(r0) * n;
    if (BULK) {
      const int n4 = n / 4;
      const int total4 = rows * n4;
      for (int e = tid; e < total4; e += THREADS) {
        const int r = e / n4;
        const int g = step_idx[r0 + r];
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (g >= 0 && g < k) v = reinterpret_cast<const float4*>(s)[e];
        reinterpret_cast<float4*>(dst)[e] = v;
      }
    } else {
      const int total = rows * n;
      for (int e = tid; e < total; e += THREADS) {
        const int r = e / n;
        const int g = step_idx[r0 + r];
        dst[e] = (g >= 0 && g < k) ? s[e] : 0.0f;
      }
    }
    if (c + 2 < chunks) {
      if (BULK) fence_proxy_async();
      __syncthreads();  // every thread is done with stage c & 1
      issue(c + 2);
    } else if (!BULK) {
      cp_async_commit();
    }
  }
}

__global__ void __launch_bounds__(32 * SHUFFLE_WARPS)
shuffle_bench_kernel(const float* __restrict__ src,
                     const int* __restrict__ idx, float* __restrict__ out,
                     int rows, int reps) {
  __shared__ float buf[SHUFFLE_WARPS][2][LANE];
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * SHUFFLE_WARPS + w;
  if (row >= rows) return;  // the whole warp: no CTA-wide barrier below
  const float* s = src + row * LANE;
  const int* ix = idx + row * LANE;
  int id[4];
  bool ok[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = lane + 32 * q;
    buf[w][0][j] = s[j];
    id[q] = ix[j];
    ok[q] = id[q] >= 0 && id[q] < LANE;
    if (!ok[q]) id[q] = 0;
  }
  __syncwarp();
  int cur = 0;
  for (int r = 0; r < reps; ++r) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = (ok[q] ? buf[w][cur][id[q]] : 0.0f) + 1.0f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) buf[w][cur ^ 1][lane + 32 * q] = v[q];
    __syncwarp();
    cur ^= 1;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    out[row * LANE + lane + 32 * q] = buf[w][cur][lane + 32 * q];
  }
}

}  // namespace

extern "C" int spgrid_dma_gather(const void* x, const void* idx, void* out,
                                 int k, int n, int steps, int G,
                                 void* stream) {
  if (n < 1 || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (steps == 0) return static_cast<int>(cudaSuccess);
  const int R = chunk_rows(G, n);
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(R) * n;
  const bool bulk = n % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaError_t attr =
      bulk ? cudaFuncSetAttribute(dma_gather_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))
           : cudaFuncSetAttribute(dma_gather_kernel<false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem));
  if (attr != cudaSuccess) {
    cudaGetLastError();  // clear it, so that the next launch's check is clean
    return static_cast<int>(attr);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bulk) {
    dma_gather_kernel<true><<<steps, THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(idx),
        static_cast<float*>(out), k, n, G, R);
  } else {
    dma_gather_kernel<false><<<steps, THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(idx),
        static_cast<float*>(out), k, n, G, R);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spgrid_shuffle_bench(const void* src, const void* idx,
                                    void* out, int rows, int reps,
                                    void* stream) {
  if (reps < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (rows + SHUFFLE_WARPS - 1) / SHUFFLE_WARPS;
  shuffle_bench_kernel<<<blocks, 32 * SHUFFLE_WARPS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const int*>(idx),
      static_cast<float*>(out), rows, reps);
  return static_cast<int>(cudaGetLastError());
}
