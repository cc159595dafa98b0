// pq_adc_batched: per-query PQ asymmetric distance computation on Hopper.
//
// Replaces src/repro/kernels/pq_adc/pq_adc.py::pq_adc_batched_pallas
// (_kernel_batched), which scored codes by a one-hot x LUT matmul on the
// TPU's MXU. Here the lookup is a plain gather from shared memory.
//
//   codes [nq, n, M] uint8, luts [nq, M, K] float32 -> out [nq, n] float32
//   out[q, i] = lut[q, 0, c0] + lut[q, 1, c1] + ... (left fold, m in order)
//
// Bound: bytes. Each row reads M code bytes and writes 4 bytes; each
// query's LUT (M*K*4 = 32 KiB at M=32) is read once per block of rows.
// Design: one block per (query, tile of 256 rows); the block stages its
// query's LUT in shared memory and each thread folds one row's M lookups
// in order with __fadd_rn, so the sum is bit-identical to the plain
// PyTorch version's left fold.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void pq_adc_batched_kernel(const uint8_t* __restrict__ codes,
                                      const float* __restrict__ luts,
                                      float* __restrict__ out, long long n,
                                      int m, int k, long long tiles) {
  extern __shared__ float lut[];
  const long long q = blockIdx.x / tiles;
  const long long row = (blockIdx.x % tiles) * kThreads + threadIdx.x;
  const float* lq = luts + q * m * k;
  for (int i = threadIdx.x; i < m * k; i += kThreads) lut[i] = lq[i];
  __syncthreads();
  if (row >= n) return;
  const uint8_t* c = codes + (q * n + row) * m;
  float acc = lut[c[0]];
  for (int j = 1; j < m; ++j) acc = __fadd_rn(acc, lut[j * k + c[j]]);
  out[q * n + row] = acc;
}

}  // namespace

extern "C" int pq_adc_batched(const void* codes, const void* luts, void* out,
                              long long nq, long long n, long long m,
                              long long k, void* stream) {
  const size_t smem = (size_t)m * k * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pq_adc_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long tiles = (n + kThreads - 1) / kThreads;
  pq_adc_batched_kernel<<<(unsigned)(nq * tiles), kThreads, smem,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const float*)luts, (float*)out, n, (int)m,
      (int)k, tiles);
  return (int)cudaGetLastError();
}
