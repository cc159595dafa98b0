// rerank_loop: the phase-2 re-rank (§3.4) of every query, its whole
// benefit-ratio loop, in one launch.
//
// No TPU kernel: the reference's re-rank is a lax.while_loop over
// candidate batches around its rerank_l2 call
// (src/repro/core/search/beam.py). This kernel runs that loop per query,
// with the semantics of kernels/rerank_loop/rerank_loop.py::rerank_loop_ref
// (the port's plain loop), bit for bit:
//
//   queries [Q, D] float32, table [N, D] uint8 or float32, cand [Q, L]
//   int32 (-1 = none), tomb [N] bool or null; K (<= L), B, max_batches,
//   thr (float32)
//   dist(id) = +inf if id < 0 or tomb[clip(id)], else the squared L2 of
//   table[clip(id, 0, N - 1)] folded over d in order (rerank_rows.cuh)
//   heap = cand[:, :K] with their distances (batch 0, always re-ranked)
//   for b < max_batches while the row goes: batch = cand[K + bB, +B)
//     (cut at L); heap ++ batch ranked by (distance, position), ties to
//     the lower position (torch's stable sort: -0 ties +0, NaN last), the
//     K first kept; displaced = how many of them came from the batch;
//     below = displaced / B < thr (float32, __fdiv_rn); the row stops
//     after a batch where both it and the batch before were below (the
//     one-batch lookahead)
//   -> out_i / out_d [Q, K] the heap in that order (max_batches = 0: the
//   stable sort of batch 0), batches [Q] int32 the batches run
//
// Design: one warp per query, kWarps queries a block; each warp runs its
// own loop, so a finished row costs nothing and no row waits for another.
// A batch's distances are the rerank_l2 fold (rows staged by id in shared
// memory, lane r folding row r); the heap and the batch sit in the warp's
// row of the global scratch wd / wi [Q, K + B] (the warp's own, L1-cached),
// and the merge ranks all K + B entries 32 at a time (each lane's entry
// against every other by shuffles), so any K + B. The order and the
// arithmetic are the plain loop's; only the host's reads of the row flags
// between batches are gone.
//
// Bound: bytes (per query K + B x batches ids and rows read, K ids and
// distances written; DEEP1B's serve shape, 1,024 queries of 384-byte rows
// at K = B = 10, reads ~4 KB a batch a query). Each batch is a chain of
// dependent reads (ids, then rows), so latency, not bytes, sets the time.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "rerank_rows.cuh"

namespace {

constexpr int kWarps = 4;          // queries a block
constexpr unsigned kFull = 0xffffffffu;

// Order bits of a distance, ascending as torch's sort orders floats: -0
// ties +0, every NaN above +inf and tied with every other NaN.
__device__ __forceinline__ unsigned order_bits(float d) {
  if (isnan(d)) return kFull;
  unsigned u = __float_as_uint(d);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The distances of `count` candidates `ids` into dd / di (whole warp).
template <typename T, int VEC>
__device__ __forceinline__ void exact(
    const float* __restrict__ query, const uint8_t* __restrict__ table,
    long long n, const uint8_t* __restrict__ tomb,
    const int32_t* __restrict__ ids, int count, int d, const rows::Plan& p,
    uint32_t* region, float* dd, int32_t* di) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < count; c0 += p.chunk) {
    const int nr = min(p.chunk, count - c0);
    int id = -1;
    long long rid = 0;
    if (lane < nr) {
      id = __ldg(ids + c0 + lane);
      rid = id < 0 ? 0 : (id >= n ? n - 1 : id);
    }
    float acc = rows::fold<T, VEC>(query, table, rid, nr, d, p, region);
    if (lane < nr) {
      if (id < 0 || (tomb != nullptr && __ldg(tomb + rid)))
        acc = __int_as_float(0x7f800000);
      dd[c0 + lane] = acc;
      di[c0 + lane] = id;
    }
  }
}

// Rank the m entries (wd, wi) by (distance, position) and write the
// `keep` first, in order, to (od, oi) (whole warp) -> how many of them
// sit at a position >= `from`.
__device__ __forceinline__ int merge(const float* wd, const int32_t* wi,
                                     int m, int keep, int from, float* od,
                                     int32_t* oi) {
  const int lane = threadIdx.x & 31;
  int moved = 0;
  for (int i0 = 0; i0 < m; i0 += 32) {
    const int i = i0 + lane;
    const unsigned ki = i < m ? order_bits(wd[i]) : kFull;
    int rank = 0;
    for (int j0 = 0; j0 < m; j0 += 32) {
      const int j = j0 + lane;
      const unsigned kj = j < m ? order_bits(wd[j]) : kFull;
      const int cnt = min(32, m - j0);
      for (int t = 0; t < cnt; ++t) {
        const unsigned kt = __shfl_sync(kFull, kj, t);
        rank += (kt < ki) | ((kt == ki) & (j0 + t < i));
      }
    }
    const bool win = i < m && rank < keep;
    if (win) {
      od[rank] = wd[i];
      oi[rank] = wi[i];
    }
    moved += __popc(__ballot_sync(kFull, win && i >= from));
  }
  return moved;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
rerank_loop_kernel(const float* __restrict__ queries,
                   const uint8_t* __restrict__ table, long long n,
                   const uint8_t* __restrict__ tomb,
                   const int32_t* __restrict__ cand, long long nq, int l,
                   int k, int b, int max_batches, float thr, int d,
                   rows::Plan plan, float* wd, int32_t* wi, float* out_d,
                   int32_t* out_i, int32_t* batches) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q = (long long)blockIdx.x * kWarps + warp;
  if (q >= nq) return;  // whole warps only; nothing below syncs the block
  uint32_t* region = smem + warp * plan.region;
  const float* query = queries + q * d;
  const int32_t* row = cand + q * l;
  float* hd = wd + q * (k + b);    // the heap, then the batch
  int32_t* hi = wi + q * (k + b);
  float* od = out_d + q * k;
  int32_t* oi = out_i + q * k;
  exact<T, VEC>(query, table, n, tomb, row, k, d, plan, region, hd, hi);
  __syncwarp();
  if (max_batches == 0) merge(hd, hi, k, k, k, od, oi);
  int ran = 0;
  bool pending = false;  // the last batch's benefit test fired
  for (int bt = 0; bt < max_batches; ++bt) {
    const int at = k + bt * b;
    const int width = max(0, min(b, l - at));
    exact<T, VEC>(query, table, n, tomb, row + at, width, d, plan, region,
                  hd + k, hi + k);
    __syncwarp();
    const int moved = merge(hd, hi, k + width, k, k, od, oi);
    ++ran;
    const bool below = __fdiv_rn((float)moved, (float)b) < thr;
    const bool go = !(pending && below);
    pending = below;
    if (!go || bt + 1 == max_batches) break;
    __syncwarp();  // every lane has read the heap and written the merge
    for (int i = lane; i < k; i += 32) {
      hd[i] = od[i];
      hi[i] = oi[i];
    }
    __syncwarp();
  }
  if (lane == 0) batches[q] = ran;
}

template <typename T, int VEC>
int launch_vec(const void* queries, const void* table, const void* tomb,
               const void* cand, void* wd, void* wi, void* out_d,
               void* out_i, void* batches, long long n, long long nq,
               long long l, long long k, long long b, long long max_batches,
               float thr, long long d, cudaStream_t stream) {
  const rows::Plan plan = rows::plan<T>(d, k > b ? k : b);
  const size_t smem = (size_t)kWarps * plan.region * 4;
  cudaError_t err = rows::allow_smem(rerank_loop_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((nq + kWarps - 1) / kWarps);
  rerank_loop_kernel<T, VEC><<<blocks, kWarps * 32, smem, stream>>>(
      (const float*)queries, (const uint8_t*)table, n,
      (const uint8_t*)tomb, (const int32_t*)cand, nq, (int)l, (int)k,
      (int)b, (int)max_batches, thr, (int)d, plan, (float*)wd,
      (int32_t*)wi, (float*)out_d, (int32_t*)out_i, (int32_t*)batches);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* queries, const void* table, const void* tomb,
        const void* cand, void* wd, void* wi, void* out_d, void* out_i,
        void* batches, long long n, long long nq, long long l, long long k,
        long long b, long long max_batches, long long thr_bits,
        long long d, void* stream) {
  const int32_t bits = (int32_t)thr_bits;
  float thr;
  memcpy(&thr, &bits, sizeof thr);
  cudaStream_t s = (cudaStream_t)stream;
  const int vec = rows::vec_width<T>(d, table);
  auto go = vec == 16 ? launch_vec<T, 16> : vec == 8 ? launch_vec<T, 8>
            : vec == 4 ? launch_vec<T, 4> : launch_vec<T, 1>;
  return go(queries, table, tomb, cand, wd, wi, out_d, out_i, batches, n,
            nq, l, k, b, max_batches, thr, d, s);
}

}  // namespace

// thr_bits: the float32 threshold's bits. wd / wi: [nq, k + b] scratch.
extern "C" int rerank_loop_u8(const void* queries, const void* table,
                              const void* tomb, const void* cand, void* wd,
                              void* wi, void* out_d, void* out_i,
                              void* batches, long long n, long long nq,
                              long long l, long long k, long long b,
                              long long max_batches, long long thr_bits,
                              long long d, void* stream) {
  return run<uint8_t>(queries, table, tomb, cand, wd, wi, out_d, out_i,
                      batches, n, nq, l, k, b, max_batches, thr_bits, d,
                      stream);
}

extern "C" int rerank_loop_f32(const void* queries, const void* table,
                               const void* tomb, const void* cand, void* wd,
                               void* wi, void* out_d, void* out_i,
                               void* batches, long long n, long long nq,
                               long long l, long long k, long long b,
                               long long max_batches, long long thr_bits,
                               long long d, void* stream) {
  return run<float>(queries, table, tomb, cand, wd, wi, out_d, out_i,
                    batches, n, nq, l, k, b, max_batches, thr_bits, d,
                    stream);
}
