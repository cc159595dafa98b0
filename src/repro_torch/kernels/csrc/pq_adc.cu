// pq_adc: single-LUT PQ asymmetric distance computation on Hopper.
//
// Replaces src/repro/kernels/pq_adc/pq_adc.py::pq_adc_pallas (_kernel),
// which scored row blocks by a one-hot x LUT matmul on the TPU's MXU. Here
// the lookup is a plain gather from shared memory, as in pq_adc_batched.cu.
//
//   codes [n, M] uint8 or int32, lut [M, K] float32 -> out [n] float32
//   out[i] = lut[0, c0] + lut[1, c1] + ... (left fold, m in order)
//
// Bound: bytes. Each row reads M code bytes (4M for int32 codes) and
// writes 4 bytes; the LUT is read once per block. Design: a grid-stride
// loop over rows with at most 132*8 blocks, so each block stages the
// M*K*4-byte LUT (32 KiB at M=32) in shared memory once and then scores
// many rows; each thread folds one row's M lookups in order with
// __fadd_rn, bit-identical to the plain version's left fold.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 8;

template <typename Code>
__global__ void pq_adc_kernel(const Code* __restrict__ codes,
                              const float* __restrict__ lut,
                              float* __restrict__ out, long long n, int m,
                              int k) {
  extern __shared__ float s[];
  for (int i = threadIdx.x; i < m * k; i += kThreads) s[i] = lut[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
       row < n; row += stride) {
    const Code* c = codes + row * m;
    float acc = s[(int)c[0]];
    for (int j = 1; j < m; ++j) acc = __fadd_rn(acc, s[j * k + (int)c[j]]);
    out[row] = acc;
  }
}

template <typename Code>
int run(const void* codes, const void* lut, void* out, long long n,
        long long m, long long k, cudaStream_t stream) {
  const size_t smem = (size_t)m * k * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pq_adc_kernel<Code>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  pq_adc_kernel<Code><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const Code*)codes, (const float*)lut, (float*)out, n, (int)m, (int)k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pq_adc(const void* codes, const void* lut, void* out,
                      long long n, long long m, long long k,
                      long long code_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (code_bytes == 1) return run<uint8_t>(codes, lut, out, n, m, k, s);
  return run<int32_t>(codes, lut, out, n, m, k, s);
}
