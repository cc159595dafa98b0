// rerank_l2: exact squared L2 distances for the phase-2 re-rank (§3.4).
//
// Replaces src/repro/kernels/rerank_l2/rerank_l2.py::rerank_l2_pallas
// (_kernel_grouped). The Pallas body used ||q||^2 + ||x||^2 - 2 q.x on the
// MXU, which can dip below 0; this kernel computes the contract of the
// reference oracle instead:
//
//   queries [Q, D] float32, cands [Q, C, D] uint8 or float32 -> [Q, C]
//   out[q, c] = sum_d (float(x[q, c, d]) - q[q, d])^2, folded over d in order
//
// Bound: bytes (Q*C*D candidate bytes in, Q*C*4 out; 3 flops a byte is far
// below the card's ratio). At the serving shapes (Q=1024, C=10, D=128) it
// moves ~1.8 MB and is launch-bound. Design: one thread per (q, c) folds
// over d with __fsub_rn/__fmul_rn/__fadd_rn, so nvcc cannot contract the
// fold into FMAs and the result is bit-identical to the plain version;
// rows of a multiple of 16 bytes are read as 16-byte vectors.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void rerank_l2_kernel(const float* __restrict__ queries,
                                 const T* __restrict__ cands,
                                 float* __restrict__ out, long long total,
                                 long long c, int d) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const float* q = queries + (i / c) * d;
  const T* x = cands + i * d;
  float acc = 0.0f;
  if (d > 0) {
    const float t = __fsub_rn((float)x[0], q[0]);
    acc = __fmul_rn(t, t);
  }
  for (int j = 1; j < d; ++j) {
    const float t = __fsub_rn((float)x[j], q[j]);
    acc = __fadd_rn(acc, __fmul_rn(t, t));
  }
  out[i] = acc;
}

// Rows whose bytes are a multiple of 16 (D % 16 == 0 for uint8, D % 4 == 0
// for float32): each thread reads its row as 16-byte vectors and the query
// as float4s; the fold is the same, element by element in order.
template <typename T>
__global__ void rerank_l2_vec_kernel(const float* __restrict__ queries,
                                     const T* __restrict__ cands,
                                     float* __restrict__ out, long long total,
                                     long long c, int d) {
  constexpr int kPer = 16 / sizeof(T);
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const float* q = queries + (i / c) * d;
  const uint4* x = reinterpret_cast<const uint4*>(cands + i * d);
  float acc = 0.0f;  // 0 + t0*t0 == t0*t0: the same fold as above
  for (int v = 0; v < d / kPer; ++v) {
    const uint4 w = x[v];
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int b = 0; b < kPer; b += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(q + v * kPer + b);
      const float qs[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = __fsub_rn((float)e[b + j], qs[j]);
        acc = __fadd_rn(acc, __fmul_rn(t, t));
      }
    }
  }
  out[i] = acc;
}

template <typename T>
int run(const void* queries, const void* cands, void* out, long long nq,
        long long c, long long d, void* stream) {
  const long long total = nq * c;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  const bool vec = (d * (long long)sizeof(T)) % 16 == 0
                   && (uintptr_t)cands % 16 == 0
                   && (uintptr_t)queries % 16 == 0;
  if (vec) {
    rerank_l2_vec_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)queries, (const T*)cands, (float*)out, total, c,
        (int)d);
  } else {
    rerank_l2_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)queries, (const T*)cands, (float*)out, total, c,
        (int)d);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rerank_l2_u8(const void* queries, const void* cands, void* out,
                            long long nq, long long c, long long d,
                            void* stream) {
  return run<uint8_t>(queries, cands, out, nq, c, d, stream);
}

extern "C" int rerank_l2_f32(const void* queries, const void* cands,
                             void* out, long long nq, long long c, long long d,
                             void* stream) {
  return run<float>(queries, cands, out, nq, c, d, stream);
}
