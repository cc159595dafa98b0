// byteplane: XOR-delta inverse of the vector store's load path on Hopper.
//
// Replaces src/repro/kernels/byteplane/byteplane.py::byteplane_decode_pallas
// (_kernel), which XOR-ed row blocks of BN=256 vectors against a base
// vector held in VMEM.
//
//   packed [n, V] uint8, base [V] uint8 -> out [n, V] uint8
//   out[i, j] = packed[i, j] ^ base[j]
//
// Bound: bytes. Each byte is read once and written once (2nV + V bytes),
// one XOR per byte. Design: the row structure does not matter, so the
// flat [n*V] buffer is walked by a grid-stride loop of 16-byte words
// (uint4 loads and stores, neighbouring threads on neighbouring words).
// The base is staged in shared memory; byte o of the buffer takes
// base[o % V], and each thread carries its column c = (16 w) % V from word
// to word by adding the stride's column step, so there is no 64-bit
// division in the loop. V need not divide 16 (spacev-like rows are 100 B).
// When a pointer is not 16-byte aligned, or for the bytes after the last
// whole word, a byte-wise loop does the same XOR.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

__device__ __forceinline__ void stage_base(const uint8_t* __restrict__ base,
                                           uint8_t* sb, int v) {
  for (int i = threadIdx.x; i < v; i += blockDim.x) sb[i] = base[i];
  __syncthreads();
}

__global__ void byteplane_words(const uint4* __restrict__ in,
                                const uint8_t* __restrict__ base,
                                uint4* __restrict__ out, long long nwords,
                                int v) {
  extern __shared__ uint8_t sb[];
  stage_base(base, sb, v);
  long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int c = (int)((w * 16) % v);
  const int step = (int)((stride * 16) % v);
  for (; w < nwords; w += stride) {
    uint4 x = in[w];
    uint32_t* xw = reinterpret_cast<uint32_t*>(&x);
    int cj = c;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t key = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        key |= (uint32_t)sb[cj] << (8 * b);
        cj = (cj + 1 == v) ? 0 : cj + 1;
      }
      xw[q] ^= key;
    }
    out[w] = x;
    c += step;
    if (c >= v) c -= v;
  }
}

__global__ void byteplane_bytes(const uint8_t* __restrict__ in,
                                const uint8_t* __restrict__ base,
                                uint8_t* __restrict__ out, long long start,
                                long long total, int v) {
  extern __shared__ uint8_t sb[];
  stage_base(base, sb, v);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = start + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride)
    out[i] = in[i] ^ sb[i % v];
}

long long blocks_for(long long items) {
  long long b = (items + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

}  // namespace

extern "C" int byteplane_decode(const void* packed, const void* base,
                                void* out, long long n, long long v,
                                void* stream) {
  const long long total = n * v;
  const size_t smem = (size_t)v;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        byteplane_words, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(byteplane_bytes,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned =
      (((uintptr_t)packed | (uintptr_t)out) & 15) == 0;
  const long long nwords = aligned ? total / 16 : 0;
  if (nwords)
    byteplane_words<<<(unsigned)blocks_for(nwords), kThreads, smem, s>>>(
        (const uint4*)packed, (const uint8_t*)base, (uint4*)out, nwords,
        (int)v);
  const long long done = nwords * 16;
  if (done < total)
    byteplane_bytes<<<(unsigned)blocks_for(total - done), kThreads, smem,
                      s>>>((const uint8_t*)packed, (const uint8_t*)base,
                           (uint8_t*)out, done, total, (int)v);
  return (int)cudaGetLastError();
}
