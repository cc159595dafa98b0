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
// first minimum (strict <), as argmin does.
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
int dispatch(const void* x, const void* cents, void* codes, long long n,
             long long m, long long k, long long dsub, void* stream) {
  switch (dsub) {
    case 1: return run<T, 1>(x, cents, codes, n, m, k, stream);
    case 2: return run<T, 2>(x, cents, codes, n, m, k, stream);
    case 4: return run<T, 4>(x, cents, codes, n, m, k, stream);
    case 8: return run<T, 8>(x, cents, codes, n, m, k, stream);
    case 16: return run<T, 16>(x, cents, codes, n, m, k, stream);
    default: return (int)cudaErrorInvalidValue;
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
