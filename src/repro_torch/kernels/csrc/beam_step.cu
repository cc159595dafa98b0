// beam_step: the fused hop tail of the batch-first beam search (§3.4).
//
// Replaces src/repro/kernels/beam_step/beam_step.py::beam_step_pallas
// (_kernel), which scored neighbours by a one-hot x LUT matmul on the MXU
// and selected the top-L with a [T, T] stable-rank compare.
//
//   pq_codes [n, M] uint8, luts [nq, M, K] f32, cand_ids [nq, L] i32,
//   cand_d [nq, L] f32, new_ids [nq, E] i32 (-1 = masked)
//   -> ids [nq, L] i32, d [nq, L] f32, top_idx [nq, L] i32
//   d_new[e] = ADC of pq_codes[min(new_ids[e], n - 1)] (m folded in order),
//   +inf where new_ids < 0 (no row read); merged = [cand | new]
//   (T = L + E); output = the L smallest merged entries by (distance,
//   merged index) — lax.top_k's tie-break.
//
// Bound: bytes — the LUTs (M*K*4: 32 KiB a query at M=32, 384 KiB at
// M=384) and the valid rows of the table: ~50 MB per hop at nq=1024,
// E=512 (60% valid), M=32, L=200; ~0.53 GB at M=384. Design: one block
// per query.
// - Overlapped loads. One thread starts a bulk copy (cp.async.bulk, the
//   TMA's non-tensor form) of the query's LUT into shared memory, its
//   completion counted on an mbarrier. Meanwhile every thread reads its
//   new_ids and issues the loads of its rows of pq_codes into registers
//   (two 16-byte loads for a 32-byte row; narrower loads when M or the
//   table's address does not allow them; rows wider than 32 bytes are read
//   byte by byte in the fold). It then waits on the barrier and folds m in
//   order with __fadd_rn, bit-identical to the plain version. The copy,
//   the row loads and the fold are adc_rows.cuh's, shared with
//   pq_adc_batched.cu.
// - Top-L by filter and merge. Every merged entry has a 64-bit key: the
//   order-preserving bits of its distance (-0 folded onto +0) above its
//   merged index (keys.cuh's sort_key), so keys are distinct and ascend
//   in (distance, index) order. A new key can enter the top L only if it
//   is smaller than the key of candidate L-1 (the L candidate keys beat
//   every larger one), so the block keeps only those, compacts them with
//   a warp ballot and a prefix over the warps, bitonic-sorts the
//   survivors (a power of two >= their count) and merges them with the
//   candidate half: each entry's output position is its index in its own
//   run plus its rank in the other (a binary search).
// - Any input. The search always passes a candidate half sorted by
//   (distance, index) — the previous hop's output or the [e_d, inf, ...]
//   start — but a caller may not: a vote over adjacent pairs finds an
//   unsorted half, which is then sorted in shared memory first.
// - A LUT too large for a block's shared memory beside its keys (the
//   entry point asks the device: M=384 at K=256) runs
//   beam_step_wide_kernel, which stages it adc::kSlice sub-spaces at a time in two buffers (adc_rows.cuh's
//   fold_sliced): it scores every new id into dnew first, slice by slice
//   (a row's 32 bytes of a slice in two 16-byte loads), each sum carried
//   over the slices in m order, so the same left fold; then filters,
//   compacts and merges as above.
// Shared memory at the shard's shapes: 32 KiB LUT + 256 candidate and 512
// survivor keys + 512 distances, ~41 KB a block; the wide path's two
// 32 KiB slices in place of the LUT, ~74 KB (three blocks an SM).
#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_rows.cuh"
#include "keys.cuh"

namespace {

using adc::fold_row;
using adc::kRowBytes;
using adc::load_row;
using keys::sort_key;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;       // rows a thread holds in registers per group
constexpr unsigned kFull = 0xffffffffu;

// Ascending bitonic sort of keys[0..p), p a power of two; ends synced.
__device__ void bitonic(unsigned long long* keys, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (p >> 1); i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = keys[lo], b = keys[hi];
        if ((a > b) == ((lo & size) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Entries of sorted keys[0..len) smaller than x.
__device__ __forceinline__ int rank_in(const unsigned long long* keys,
                                       int len, unsigned long long x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Keys of the candidate half into ckeys[0..lpad) (~0 past L), sorted
// where the half does not ascend -> the key of candidate L-1. Ends synced.
__device__ __forceinline__ unsigned long long candidate_keys(
    unsigned long long* ckeys, const float* cd, int l_size, int lpad) {
  int unsorted = 0;
  for (int i = threadIdx.x; i < lpad; i += kThreads) {
    if (i < l_size) {
      const unsigned long long ki = sort_key(cd[i], (unsigned)i);
      ckeys[i] = ki;
      if (i + 1 < l_size && ki > sort_key(cd[i + 1], (unsigned)(i + 1)))
        unsorted = 1;
    } else {
      ckeys[i] = ~0ull;
    }
  }
  if (__syncthreads_or(unsorted)) bitonic(ckeys, lpad);
  return ckeys[l_size - 1];
}

// Append the keys of a group's rows that pass (row r * kThreads + tid of
// the group in key[r]) to skeys after the ``kept`` there -> the new count,
// the same in every thread. Ends synced.
__device__ __forceinline__ int compact(const unsigned long long* key,
                                       const bool* pass, unsigned* wcnt,
                                       unsigned long long* skeys, int kept) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned ballot[kRows];
  unsigned mine = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    ballot[r] = __ballot_sync(kFull, pass[r]);
    mine += __popc(ballot[r]);
  }
  if (lane == 0) wcnt[warp] = mine;
  __syncthreads();
  int base = kept, total = 0;
  for (int i = 0; i < kWarps; ++i) {
    const int c = (int)wcnt[i];
    if (i < warp) base += c;
    total += c;
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (ballot[r] & (1u << lane))
      skeys[base + __popc(ballot[r] & below)] = key[r];
    base += __popc(ballot[r]);
  }
  __syncthreads();  // wcnt is rewritten by the next group
  return kept + total;
}

// Sort the ``kept`` survivors, then merge them with the candidate half by
// rank into the query's output rows.
__device__ __forceinline__ void merge_out(
    unsigned long long* skeys, const unsigned long long* ckeys, int kept,
    int l_size, long long q, const float* cd,
    const int32_t* __restrict__ cand_ids, const float* dnew,
    const int32_t* nid, int32_t* __restrict__ out_ids,
    float* __restrict__ out_d, int32_t* __restrict__ out_idx) {
  int spad = 1;
  while (spad < kept) spad <<= 1;
  for (int i = kept + threadIdx.x; i < spad; i += kThreads) skeys[i] = ~0ull;
  __syncthreads();
  if (spad > 1) bitonic(skeys, spad);
  const int take = kept < l_size ? kept : l_size;
  for (int i = threadIdx.x; i < l_size + take; i += kThreads) {
    const bool cand = i < l_size;
    const unsigned long long key = cand ? ckeys[i] : skeys[i - l_size];
    const int pos = cand ? i + rank_in(skeys, kept, key)
                         : (i - l_size) + rank_in(ckeys, l_size, key);
    if (pos >= l_size) continue;
    const int t = (int)(key & 0xffffffffull);
    const long long o = q * l_size + pos;
    out_idx[o] = t;
    if (t < l_size) {
      out_d[o] = cd[t];
      out_ids[o] = cand_ids[q * l_size + t];
    } else {
      out_d[o] = dnew[t - l_size];
      out_ids[o] = nid[t - l_size];
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
beam_step_kernel(const uint8_t* __restrict__ table, long long n,
                 const float* __restrict__ luts,
                 const int32_t* __restrict__ cand_ids,
                 const float* __restrict__ cand_d,
                 const int32_t* __restrict__ new_ids,
                 int32_t* __restrict__ out_ids, float* __restrict__ out_d,
                 int32_t* __restrict__ out_idx, int e, int l_size, int m,
                 int k, int lpad, int bulk, int off_bar, int off_ckeys,
                 int off_skeys, int off_dnew) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut = (float*)smem;
  unsigned long long* bar = (unsigned long long*)(smem + off_bar);
  unsigned* wcnt = (unsigned*)(smem + off_bar + 16);
  unsigned long long* ckeys = (unsigned long long*)(smem + off_ckeys);
  unsigned long long* skeys = (unsigned long long*)(smem + off_skeys);
  float* dnew = (float*)(smem + off_dnew);
  const int tid = threadIdx.x;
  const long long q = blockIdx.x;
  const float* lq = luts + q * m * k;
  const float* cd = cand_d + q * l_size;
  const int32_t* nid = new_ids + q * e;
  const unsigned lut_bytes = (unsigned)(m * k * sizeof(float));

  if (bulk) {
    if (tid == 0) adc::lut_barrier_init(bar);
    __syncthreads();
    if (tid == 0) adc::lut_copy_start(lut, lq, lut_bytes, bar);
  }

  // Group 0's rows go out first: their loads fly while the LUT arrives.
  const int group = kRows * kThreads;
  int rid[kRows];
  uint32_t w[kRows][kRowBytes / 4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int x = r * kThreads + tid;
    rid[r] = x < e ? nid[x] : -1;
    if (rid[r] >= 0)
      load_row<VEC>(table, rid[r] < n ? rid[r] : n - 1, m, w[r]);
  }

  if (!bulk)
    for (int i = tid; i < m * k; i += kThreads) lut[i] = lq[i];
  const unsigned long long thr = candidate_keys(ckeys, cd, l_size, lpad);
  if (bulk) adc::lut_copy_wait(bar);

  // Score, filter and compact, one group of kRows * kThreads rows a pass.
  int kept = 0;  // survivors so far, the same in every thread
  for (int g0 = 0; g0 < e; g0 += group) {
    if (g0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int x = g0 + r * kThreads + tid;
        rid[r] = x < e ? nid[x] : -1;
        if (rid[r] >= 0)
          load_row<VEC>(table, rid[r] < n ? rid[r] : n - 1, m, w[r]);
      }
    }
    unsigned long long key[kRows];
    bool pass[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int x = g0 + r * kThreads + tid;
      pass[r] = false;
      if (x < e) {
        const float d = rid[r] >= 0
            ? fold_row<VEC>(lut, w[r], table, rid[r] < n ? rid[r] : n - 1, m,
                            k)
            : __int_as_float(0x7f800000);
        dnew[x] = d;
        key[r] = sort_key(d, (unsigned)(l_size + x));
        pass[r] = key[r] < thr;
      }
    }
    kept = compact(key, pass, wcnt, skeys, kept);
  }
  merge_out(skeys, ckeys, kept, l_size, q, cd, cand_ids, dnew, nid, out_ids,
            out_d, out_idx);
}

// The new ids of one query, as fold_sliced reads them.
struct QueryIds {
  const int32_t* nid;
  __device__ __forceinline__ int operator()(int x) const { return nid[x]; }
};

// The same hop with the LUT staged slice by slice (see the top).
template <int VEC>
__global__ void __launch_bounds__(kThreads)
beam_step_wide_kernel(const uint8_t* __restrict__ table, long long n,
                      const float* __restrict__ luts,
                      const int32_t* __restrict__ cand_ids,
                      const float* __restrict__ cand_d,
                      const int32_t* __restrict__ new_ids,
                      int32_t* __restrict__ out_ids,
                      float* __restrict__ out_d,
                      int32_t* __restrict__ out_idx, int e, int l_size,
                      int m, int k, int lpad, int bulk, int off_bar,
                      int off_ckeys, int off_skeys, int off_dnew) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* bufs = (float*)smem;
  unsigned long long* bar = (unsigned long long*)(smem + off_bar);
  unsigned* wcnt = (unsigned*)(smem + off_bar + 16);
  unsigned long long* ckeys = (unsigned long long*)(smem + off_ckeys);
  unsigned long long* skeys = (unsigned long long*)(smem + off_skeys);
  float* dnew = (float*)(smem + off_dnew);
  const int tid = threadIdx.x;
  const long long q = blockIdx.x;
  const float* lq = luts + q * m * k;
  const float* cd = cand_d + q * l_size;
  const int32_t* nid = new_ids + q * e;

  // The first two slices land while the candidate keys are made.
  if (bulk) adc::slices_start(bufs, lq, m, k, bar);
  const unsigned long long thr = candidate_keys(ckeys, cd, l_size, lpad);
  adc::fold_sliced<VEC, kRows>(table, n, lq, m, k, e, bulk, bufs, bar,
                               QueryIds{nid}, dnew);

  int kept = 0;
  for (int g0 = 0; g0 < e; g0 += kRows * kThreads) {
    unsigned long long key[kRows];
    bool pass[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int x = g0 + r * kThreads + tid;
      pass[r] = false;
      if (x < e) {
        key[r] = sort_key(dnew[x], (unsigned)(l_size + x));
        pass[r] = key[r] < thr;
      }
    }
    kept = compact(key, pass, wcnt, skeys, kept);
  }
  merge_out(skeys, ckeys, kept, l_size, q, cd, cand_ids, dnew, nid, out_ids,
            out_d, out_idx);
}

struct Args {
  const void *table, *luts, *cand_ids, *cand_d, *new_ids;
  void *out_ids, *out_d, *out_idx;
  long long n, nq, e, l_size, m, k;
  cudaStream_t stream;
};

// A block's shared memory after its LUT (whole, or two slices): the
// barrier and warp counts, candidate keys, survivor keys, new distances.
struct Keys {
  int lpad;
  size_t off_ckeys, off_skeys, off_dnew, bytes;  // offsets from the barrier
};

Keys keys_layout(long long e, long long l_size) {
  Keys s;
  s.lpad = 1;
  while (s.lpad < l_size) s.lpad <<= 1;
  int epad = 1;
  while (epad < e) epad <<= 1;
  s.off_ckeys = 16 + kWarps * sizeof(unsigned);
  s.off_skeys = s.off_ckeys + s.lpad * sizeof(unsigned long long);
  s.off_dnew = s.off_skeys + epad * sizeof(unsigned long long);
  s.bytes = s.off_dnew + (e ? e : 1) * sizeof(float);
  return s;
}

template <int VEC>
int launch_vec(const Args& a, bool wide) {
  const Keys ks = keys_layout(a.e, a.l_size);
  const size_t lut_bytes = (size_t)a.m * a.k * sizeof(float);
  const int bulk = ((uintptr_t)a.luts % 16 == 0) && (lut_bytes % 16 == 0);
  const size_t off_bar = wide ? adc::slice_bytes(a.k)
                              : (lut_bytes + 15) & ~(size_t)15;
  const size_t smem = off_bar + ks.bytes;
  auto kernel = beam_step_kernel<VEC>;
  if constexpr (VEC != 0)  // a wide row is read in slices, never whole
    if (wide) kernel = beam_step_wide_kernel<VEC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)a.nq, kThreads, smem, a.stream>>>(
      (const uint8_t*)a.table, a.n, (const float*)a.luts,
      (const int32_t*)a.cand_ids, (const float*)a.cand_d,
      (const int32_t*)a.new_ids, (int32_t*)a.out_ids, (float*)a.out_d,
      (int32_t*)a.out_idx, (int)a.e, (int)a.l_size, (int)a.m, (int)a.k,
      ks.lpad, bulk, (int)off_bar, (int)(off_bar + ks.off_ckeys),
      (int)(off_bar + ks.off_skeys), (int)(off_bar + ks.off_dnew));
  return (int)cudaGetLastError();
}

}  // namespace

// The slices beam_step stages a query's [m, k] LUT in at these shapes on
// the current device: 1 where the whole LUT fits a block's shared memory
// beside the block's keys, else ceil(m / adc::kSlice).
extern "C" long long beam_step_lut_slices(long long m, long long k,
                                          long long e, long long l_size) {
  return adc::lut_slices(m, k, keys_layout(e, l_size).bytes);
}

extern "C" int beam_step(const void* table, const void* luts,
                         const void* cand_ids, const void* cand_d,
                         const void* new_ids, void* out_ids, void* out_d,
                         void* out_idx, long long n, long long nq,
                         long long e, long long l_size, long long m,
                         long long k, void* stream) {
  const Args a{table, luts, cand_ids, cand_d, new_ids, out_ids, out_d,
               out_idx, n, nq, e, l_size, m, k, (cudaStream_t)stream};
  if (adc::lut_sliced(m, k, keys_layout(e, l_size).bytes)) {
    switch (adc::slice_vec(table, m)) {
      case 16: return launch_vec<16>(a, true);
      case 8: return launch_vec<8>(a, true);
      case 4: return launch_vec<4>(a, true);
      default: return launch_vec<1>(a, true);
    }
  }
  switch (adc::row_vec(table, m)) {
    case 0: return launch_vec<0>(a, false);
    case 16: return launch_vec<16>(a, false);
    case 8: return launch_vec<8>(a, false);
    case 4: return launch_vec<4>(a, false);
    default: return launch_vec<1>(a, false);
  }
}
