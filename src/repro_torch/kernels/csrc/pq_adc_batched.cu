// pq_adc_batched: per-query PQ asymmetric distance computation on Hopper,
// the code rows read by id.
//
// Replaces src/repro/kernels/pq_adc/pq_adc.py::pq_adc_batched_pallas
// (_kernel_batched), which scored codes by a one-hot x LUT matmul on the
// TPU's MXU. Here the lookup is a plain gather from shared memory.
//
//   table [N, M] uint8, luts [nq, M, K] float32, ids [nq, E] int32
//   -> out [nq, E] float32
//   out[q, e] = ADC of table[min(ids[q, e], N - 1)] against luts[q]
//               (lut[q, 0, c0] + lut[q, 1, c1] + ..., m folded in order),
//   +inf where ids < 0 (no row read) — beam_step's scoring contract.
//   Without ids (null), the table is the [nq * E, M] view of gathered
//   [nq, E, M] codes and out[q, e] scores row q * E + e.
//
// Bound: bytes — each query's LUT (M*K*4 = 32 KiB at M=32) read once, the
// valid rows' M bytes, the ids and the output: ~48 MB at the shard's hop
// (nq=1024, E=512, 60% valid, M=32). Design: one block per query, so each
// LUT is read once. One thread starts a bulk copy of the LUT into shared
// memory on an mbarrier; meanwhile every thread reads its ids and loads
// its rows into registers (two 16-byte loads a 32-byte row; narrower
// loads where M or the table's address does not allow them). After the
// barrier each thread folds its rows in order with __fadd_rn, so the sum
// is bit-identical to the plain version's left fold. The copy, the loads
// and the fold are adc_rows.cuh's, shared with beam_step.cu. A LUT too
// large for a block's shared memory (the entry point asks the device:
// M=384 at K=256, 384 KiB) is staged adc::kSlice sub-spaces at a time in two
// buffers (fold_sliced), each row's sum carried over the slices in m
// order in its output entry.
#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 2;  // rows a thread holds in registers per group

template <int VEC>
__global__ void __launch_bounds__(kThreads)
pq_adc_batched_kernel(const uint8_t* __restrict__ table, long long n,
                      const float* __restrict__ luts,
                      const int32_t* __restrict__ ids,
                      float* __restrict__ out, int e, int m, int k, int bulk,
                      int off_bar) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut = (float*)smem;
  unsigned long long* bar = (unsigned long long*)(smem + off_bar);
  const int tid = threadIdx.x;
  const long long q = blockIdx.x;
  const float* lq = luts + q * m * k;
  if (bulk) {
    if (tid == 0) adc::lut_barrier_init(bar);
    __syncthreads();
    if (tid == 0)
      adc::lut_copy_start(lut, lq, (unsigned)(m * k * sizeof(float)), bar);
  }
  const int group = kRows * kThreads;
  for (int g0 = 0; g0 < e; g0 += group) {
    long long rid[kRows];
    uint32_t w[kRows][adc::kRowBytes / 4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int x = g0 + r * kThreads + tid;
      rid[r] = x >= e ? -1 : ids ? (long long)ids[q * e + x] : q * e + x;
      if (rid[r] >= n) rid[r] = n - 1;
      if (rid[r] >= 0) adc::load_row<VEC>(table, rid[r], m, w[r]);
    }
    if (g0 == 0) {  // the first group's loads fly while the LUT arrives
      if (bulk) {
        adc::lut_copy_wait(bar);
      } else {
        for (int i = tid; i < m * k; i += kThreads) lut[i] = lq[i];
        __syncthreads();
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int x = g0 + r * kThreads + tid;
      if (x < e)
        out[q * e + x] = rid[r] >= 0
            ? adc::fold_row<VEC>(lut, w[r], table, rid[r], m, k)
            : __int_as_float(0x7f800000);
    }
  }
}

// Row x of query q: ids[q, x], or row q * e + x of a gathered table.
struct QueryRows {
  const int32_t* ids;
  long long q;
  int e;
  __device__ __forceinline__ long long operator()(int x) const {
    return ids ? (long long)ids[q * e + x] : q * e + x;
  }
};

// The same scores with the LUT staged slice by slice (see the top).
template <int VEC>
__global__ void __launch_bounds__(kThreads)
pq_adc_batched_wide_kernel(const uint8_t* __restrict__ table, long long n,
                           const float* __restrict__ luts,
                           const int32_t* __restrict__ ids,
                           float* __restrict__ out, int e, int m, int k,
                           int bulk, int off_bar) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* bufs = (float*)smem;
  unsigned long long* bar = (unsigned long long*)(smem + off_bar);
  const long long q = blockIdx.x;
  const float* lq = luts + q * m * k;
  if (bulk) adc::slices_start(bufs, lq, m, k, bar);
  adc::fold_sliced<VEC, kRows>(table, n, lq, m, k, e, bulk, bufs, bar,
                               QueryRows{ids, q, e}, out + q * e);
}

template <int VEC>
int launch_vec(const void* table, const void* luts, const void* ids,
               void* out, long long n, long long nq, long long e,
               long long m, long long k, bool wide, cudaStream_t stream) {
  const size_t lut_bytes = (size_t)m * k * sizeof(float);
  const int bulk = ((uintptr_t)luts % 16 == 0) && (lut_bytes % 16 == 0);
  const size_t off_bar = wide ? adc::slice_bytes(k)
                              : (lut_bytes + 15) & ~(size_t)15;
  const size_t smem = off_bar + 16;
  auto kernel = pq_adc_batched_kernel<VEC>;
  if constexpr (VEC != 0)  // a wide row is read in slices, never whole
    if (wide) kernel = pq_adc_batched_wide_kernel<VEC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)nq, kThreads, smem, stream>>>(
      (const uint8_t*)table, n, (const float*)luts, (const int32_t*)ids,
      (float*)out, (int)e, (int)m, (int)k, bulk, (int)off_bar);
  return (int)cudaGetLastError();
}

}  // namespace

// ids == nullptr: the table is [nq * e, m] and no row is masked. The LUT
// is staged whole where it fits a block's shared memory on the device,
// else in ceil(m / adc::kSlice) slices.
extern "C" int pq_adc_batched(const void* table, const void* luts,
                              const void* ids, void* out, long long n,
                              long long nq, long long e, long long m,
                              long long k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (adc::lut_sliced(m, k, 16)) {
    switch (adc::slice_vec(table, m)) {
      case 16:
        return launch_vec<16>(table, luts, ids, out, n, nq, e, m, k, true, s);
      case 8:
        return launch_vec<8>(table, luts, ids, out, n, nq, e, m, k, true, s);
      case 4:
        return launch_vec<4>(table, luts, ids, out, n, nq, e, m, k, true, s);
      default:
        return launch_vec<1>(table, luts, ids, out, n, nq, e, m, k, true, s);
    }
  }
  switch (adc::row_vec(table, m)) {
    case 0:
      return launch_vec<0>(table, luts, ids, out, n, nq, e, m, k, false, s);
    case 16:
      return launch_vec<16>(table, luts, ids, out, n, nq, e, m, k, false, s);
    case 8:
      return launch_vec<8>(table, luts, ids, out, n, nq, e, m, k, false, s);
    case 4:
      return launch_vec<4>(table, luts, ids, out, n, nq, e, m, k, false, s);
    default:
      return launch_vec<1>(table, luts, ids, out, n, nq, e, m, k, false, s);
  }
}
