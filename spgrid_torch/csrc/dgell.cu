// Gather-ELL SpMM, the ELL part of Y = A @ X with A in DeviceDGELL layout.
//
// Replaces: spgrid/ops/pallas/dgell.py, _kernel / _dgell_call (the Pallas
// TPU kernel behind `dgell`, which fetches each nnz's X row with its own
// HBM-to-VMEM copy; it never compiled on a TPU, so this is its first run
// on hardware). The COO tail is added by the wrapper with index_add_, as
// the JAX package adds it in XLA outside the Pallas kernel.
//
// Bound on the H100: device-memory bytes. At the main path's 100000^2
// scattered matrix (2.1M nnz, n = 512) the product needs X and Y once
// (205 MB each) and the nnz (17 MB): ~127 us at 3.35 TB/s. A gather kernel
// reads one 2 KB X row per live slot (~4.2 GB, mostly past the 50 MB L2),
// so the row reads, not the flops, set its time.
//
// Design: a CTA of ROWS x 128 threads takes ROWS rows, a row to each
// 128-thread slice; the slice's threads run across the n columns, four
// floats a thread when n is a multiple of 4 (and X and Y are 16-byte
// aligned), so each X row read is one coalesced 2 KB load at n = 512. A
// thread keeps its columns' sums in registers over the row's slots and
// writes them once. Slots whose value is 0 (the empty slots, column 0) are
// skipped. No atomics, no shared memory.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS_X = 128;  // threads across the columns of one row
constexpr int ROWS = 4;         // rows per CTA

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.0f; }
  __device__ static void fma(T& acc, float v, T x) { acc = fmaf(v, x, acc); }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ static void fma(T& acc, float v, T x) {
    acc.x = fmaf(v, x.x, acc.x);
    acc.y = fmaf(v, x.y, acc.y);
    acc.z = fmaf(v, x.z, acc.z);
    acc.w = fmaf(v, x.w, acc.w);
  }
};

template <int VEC>
__global__ void __launch_bounds__(THREADS_X * ROWS)
dgell_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
             const float* __restrict__ x, float* __restrict__ y, int m,
             int slots, int n) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const long long row = static_cast<long long>(blockIdx.x) * ROWS + threadIdx.y;
  if (row >= m) return;
  const int* rc = cols + row * slots;
  const float* rv = vals + row * slots;
  const int nv = n / VEC;  // vectors a row
  const T* xv = reinterpret_cast<const T*>(x);
  T* yv = reinterpret_cast<T*>(y) + row * nv;
  for (int j = threadIdx.x; j < nv; j += THREADS_X) {
    T acc = V::zero();
    for (int s = 0; s < slots; ++s) {
      const float v = rv[s];
      if (v == 0.0f) continue;
      V::fma(acc, v, xv[static_cast<size_t>(rc[s]) * nv + j]);
    }
    yv[j] = acc;
  }
}

}  // namespace

extern "C" int spgrid_dgell(const void* cols, const void* vals, const void* x,
                            void* y, int m, int slots, int n, void* stream) {
  const dim3 block(THREADS_X, ROWS);
  const dim3 grid((m + ROWS - 1) / ROWS);
  const bool aligned = n % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned) {
    dgell_kernel<4><<<grid, block, 0, s>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(x), static_cast<float*>(y), m, slots, n);
  } else {
    dgell_kernel<1><<<grid, block, 0, s>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(x), static_cast<float*>(y), m, slots, n);
  }
  return static_cast<int>(cudaGetLastError());
}
