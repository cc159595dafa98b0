// rerank_l2: exact squared L2 distances for the phase-2 re-rank (§3.4),
// the candidate rows read by id.
//
// Replaces src/repro/kernels/rerank_l2/rerank_l2.py::rerank_l2_pallas
// (_kernel_grouped). The Pallas body used ||q||^2 + ||x||^2 - 2 q.x on the
// MXU, which can dip below 0; this kernel computes the contract of the
// reference oracle instead:
//
//   queries [Q, D] float32, table [N, D] uint8 or float32, ids [Q, C] int32
//   -> out [Q, C] float32
//   out[q, c] = sum_d (float(x[d]) - q[q, d])^2, folded over d in order,
//   x = table[clip(ids[q, c], 0, N - 1)] (no masking: the caller masks).
//   Without ids (null), the table is the [Q * C, D] view of gathered
//   [Q, C, D] candidates and x is row q * C + c.
//
// Bound: bytes (Q*C*D candidate bytes in, Q*C*4 out; 3 flops a byte is far
// below the card's ratio). At the serving shapes (Q=1024, C=10, D=128 u8)
// it moves ~1.9 MB, ~0.6 us: a launch's own latency is the floor. Design:
// one warp per query, kWarps queries a block, so Q=1024 spreads over every
// SM; the warp folds its candidates 32 at a time (rerank_rows.cuh: rows
// staged by id in tiles, the fold bit-identical to the plain version's).
// Any C (chunks of 32 candidates), any D (tiles) and either dtype.
#include <cuda_runtime.h>
#include <stdint.h>

#include "rerank_rows.cuh"

namespace {

constexpr int kWarps = 4;          // queries a block

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
rerank_l2_kernel(const float* __restrict__ queries,
                 const uint8_t* __restrict__ table, long long n,
                 const int32_t* __restrict__ ids, float* __restrict__ out,
                 long long nq, int c, int d, rows::Plan plan) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q = (long long)blockIdx.x * kWarps + warp;
  if (q >= nq) return;  // whole warps only; nothing below syncs the block
  uint32_t* region = smem + warp * plan.region;
  for (int c0 = 0; c0 < c; c0 += plan.chunk) {
    const int nr = min(plan.chunk, c - c0);
    long long rid = 0;  // lane r holds the id of row c0 + r
    if (lane < nr) {
      rid = ids ? (long long)ids[q * c + c0 + lane] : q * c + c0 + lane;
      rid = rid < 0 ? 0 : (rid >= n ? n - 1 : rid);
    }
    const float acc = rows::fold<T, VEC>(queries + q * d, table, rid, nr,
                                         d, plan, region);
    if (lane < nr) out[q * c + c0 + lane] = acc;
  }
}

template <typename T, int VEC>
int launch_vec(const void* queries, const void* table, const void* ids,
               void* out, long long n, long long nq, long long c,
               long long d, cudaStream_t stream) {
  const rows::Plan plan = rows::plan<T>(d, c);
  const size_t smem = (size_t)kWarps * plan.region * 4;
  cudaError_t err = rows::allow_smem(rerank_l2_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((nq + kWarps - 1) / kWarps);
  rerank_l2_kernel<T, VEC><<<blocks, kWarps * 32, smem, stream>>>(
      (const float*)queries, (const uint8_t*)table, n, (const int32_t*)ids,
      (float*)out, nq, (int)c, (int)d, plan);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* queries, const void* table, const void* ids, void* out,
        long long n, long long nq, long long c, long long d, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (rows::vec_width<T>(d, table)) {
    case 16:
      return launch_vec<T, 16>(queries, table, ids, out, n, nq, c, d, s);
    case 8:
      return launch_vec<T, 8>(queries, table, ids, out, n, nq, c, d, s);
    case 4:
      return launch_vec<T, 4>(queries, table, ids, out, n, nq, c, d, s);
    default:
      return launch_vec<T, 1>(queries, table, ids, out, n, nq, c, d, s);
  }
}

}  // namespace

// ids == nullptr: the table is [nq * c, d], row q * c + c' for (q, c').
extern "C" int rerank_l2_u8(const void* queries, const void* table,
                            const void* ids, void* out, long long n,
                            long long nq, long long c, long long d,
                            void* stream) {
  return run<uint8_t>(queries, table, ids, out, n, nq, c, d, stream);
}

extern "C" int rerank_l2_f32(const void* queries, const void* table,
                             const void* ids, void* out, long long n,
                             long long nq, long long c, long long d,
                             void* stream) {
  return run<float>(queries, table, ids, out, n, nq, c, d, stream);
}
