// pq_encode: PQ encoding of a vector shard on the card (offline build).
//
// No TPU kernel precedes it: the reference encodes on the host
// (src/repro/core/graph/pq.py::encode_pq, numpy). At a 31.25M-vector shard
// a PyTorch formulation writes the [n, M, K] distance block to device
// memory (about 1 TB at M=32, K=256), so the encode gets a kernel.
//
//   x [n, D] uint8 or float32, centroids [M, K, DSUB] float32 -> [n, M] uint8
//   code[i, m] = first k minimising sum_s (x[i, m*DSUB+s] - c[m, k, s])^2,
//   the sum folded over s in order (numpy's order for DSUB < 8).
//
// Bound: operations (3*DSUB fp32 ops per (row, m, k) against D+M bytes a
// row). Design: one block per (tile of 256 rows, subspace m); the block
// stages subspace m's K*DSUB centroids in shared memory and each thread
// keeps its DSUB inputs in registers, scans the K centroids and keeps the
// first minimum (strict <), as argmin does. The widths of the repo's
// shards (DSUB 1, 2, 3, 4, 8, 16) are templates; any other DSUB runs the
// generic kernel, which stages each thread's inputs in shared memory
// beside the centroids ([s][thread], so a warp's reads hit distinct
// banks) and folds the same sum in the same order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int DSUB>
__global__ void pq_encode_kernel(const T* __restrict__ x,
                                 const float* __restrict__ cents,
                                 uint8_t* __restrict__ codes, long long n,
                                 int m, int k, long long tiles) {
  extern __shared__ float cs[];
  const int sub = (int)(blockIdx.x % m);
  const long long row = (blockIdx.x / m) * kThreads + threadIdx.x;
  const float* cm = cents + (long long)sub * k * DSUB;
  for (int i = threadIdx.x; i < k * DSUB; i += kThreads) cs[i] = cm[i];
  __syncthreads();
  if (row >= n) return;
  float xs[DSUB];
  const T* xr = x + row * (long long)m * DSUB + sub * DSUB;
#pragma unroll
  for (int s = 0; s < DSUB; ++s) xs[s] = (float)xr[s];
  float best = 0.0f;
  int arg = 0;
  for (int c = 0; c < k; ++c) {
    const float* cc = cs + c * DSUB;
    float t = __fsub_rn(xs[0], cc[0]);
    float acc = __fmul_rn(t, t);
#pragma unroll
    for (int s = 1; s < DSUB; ++s) {
      t = __fsub_rn(xs[s], cc[s]);
      acc = __fadd_rn(acc, __fmul_rn(t, t));
    }
    if (c == 0 || acc < best) {
      best = acc;
      arg = c;
    }
  }
  codes[row * m + sub] = (uint8_t)arg;
}

// Any dsub: the same fold, the inputs staged in shared memory.
template <typename T>
__global__ void pq_encode_any_kernel(const T* __restrict__ x,
                                     const float* __restrict__ cents,
                                     uint8_t* __restrict__ codes,
                                     long long n, int m, int k, int dsub) {
  extern __shared__ float cs[];
  float* xs = cs + k * dsub;  // [dsub][kThreads]
  const int sub = (int)(blockIdx.x % m);
  const long long row = (blockIdx.x / m) * kThreads + threadIdx.x;
  const float* cm = cents + (long long)sub * k * dsub;
  for (int i = threadIdx.x; i < k * dsub; i += kThreads) cs[i] = cm[i];
  if (row < n) {
    const T* xr = x + row * (long long)m * dsub + (long long)sub * dsub;
    for (int s = 0; s < dsub; ++s)
      xs[s * kThreads + threadIdx.x] = (float)xr[s];
  }
  __syncthreads();
  if (row >= n) return;
  float best = 0.0f;
  int arg = 0;
  for (int c = 0; c < k; ++c) {
    const float* cc = cs + c * dsub;
    float t = __fsub_rn(xs[threadIdx.x], cc[0]);
    float acc = __fmul_rn(t, t);
    for (int s = 1; s < dsub; ++s) {
      t = __fsub_rn(xs[s * kThreads + threadIdx.x], cc[s]);
      acc = __fadd_rn(acc, __fmul_rn(t, t));
    }
    if (c == 0 || acc < best) {
      best = acc;
      arg = c;
    }
  }
  codes[row * m + sub] = (uint8_t)arg;
}

template <typename T, int DSUB>
int run(const void* x, const void* cents, void* codes, long long n,
        long long m, long long k, void* stream) {
  const size_t smem = (size_t)k * DSUB * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pq_encode_kernel<T, DSUB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long tiles = (n + kThreads - 1) / kThreads;
  pq_encode_kernel<T, DSUB><<<(unsigned)(tiles * m), kThreads, smem,
                              (cudaStream_t)stream>>>(
      (const T*)x, (const float*)cents, (uint8_t*)codes, n, (int)m, (int)k,
      tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int run_any(const void* x, const void* cents, void* codes, long long n,
            long long m, long long k, long long dsub, void* stream) {
  const size_t smem = (size_t)(k + kThreads) * dsub * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pq_encode_any_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {  // more than a block may take: refused, and
      cudaGetLastError();    // the error not left for the next launch
      return (int)e;
    }
  }
  const long long tiles = (n + kThreads - 1) / kThreads;
  pq_encode_any_kernel<T><<<(unsigned)(tiles * m), kThreads, smem,
                            (cudaStream_t)stream>>>(
      (const T*)x, (const float*)cents, (uint8_t*)codes, n, (int)m, (int)k,
      (int)dsub);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* cents, void* codes, long long n,
             long long m, long long k, long long dsub, void* stream) {
  switch (dsub) {
    case 1: return run<T, 1>(x, cents, codes, n, m, k, stream);
    case 2: return run<T, 2>(x, cents, codes, n, m, k, stream);
    case 3: return run<T, 3>(x, cents, codes, n, m, k, stream);
    case 4: return run<T, 4>(x, cents, codes, n, m, k, stream);
    case 8: return run<T, 8>(x, cents, codes, n, m, k, stream);
    case 16: return run<T, 16>(x, cents, codes, n, m, k, stream);
    default: return run_any<T>(x, cents, codes, n, m, k, dsub, stream);
  }
}

}  // namespace

extern "C" int pq_encode_u8(const void* x, const void* cents, void* codes,
                            long long n, long long m, long long k,
                            long long dsub, void* stream) {
  return dispatch<uint8_t>(x, cents, codes, n, m, k, dsub, stream);
}

extern "C" int pq_encode_f32(const void* x, const void* cents, void* codes,
                             long long n, long long m, long long k,
                             long long dsub, void* stream) {
  return dispatch<float>(x, cents, codes, n, m, k, dsub, stream);
}
