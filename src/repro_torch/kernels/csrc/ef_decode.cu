// ef_decode: Elias-Fano fixed-slot decode of adjacency lists (§3.2-§3.4).
//
// Replaces src/repro/kernels/ef_decode/ef_decode.py::ef_decode_pallas
// (_make_kernel), which found the i-th set bit of the high bitmap with an
// [R, nbits] rank-compare laid out for the TPU's vector unit. Here select
// is a popcount prefix over the bitmap's words and an in-word select.
//
//   slots [N, W] uint32, ids [B] int32 or none
//   -> nbrs [B, r_max] int32, counts [B] int32
//   row b decodes slots[min(max(ids[b], 0), N - 1)] (every row in order
//   without ids); word 0 = count; words 1..lw = r_max low parts of l bits
//   each; words lw+1..lw+hb = high bitmap (bit high[i] + i set).
//   nbrs[i] = ((pos_i - i) << l) | low_i, pos_i = position of set bit i;
//   padding decodes to universe-1; a rank the bitmap lacks decodes from
//   position 0, as the reference's argmax does.
//
// Bound: bytes at the serving shapes (B = nq*W = 4096 rows of 324 B read
// by id, 516 B written each: ~3.4 MB, launch-bound). Design: one warp per
// row. The warp reads its row's words coalesced (4-byte loads: a 324-byte
// row is not 16-byte aligned), all of them in flight at once, into a
// per-warp shared buffer, and scans the popcounts of the high words with
// shuffles into a per-warp prefix. Each lane then decodes the ranks
// r = lane + 32 i directly: a binary search over the prefix finds the word
// that holds rank r, __fns the bit in it, and the low part comes from the
// buffer. Every lane is busy and the stores are coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kBatch = 4;  // words a lane has in flight per pass
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned low_part(const uint32_t* low, int r,
                                             int l, int lw) {
  if (l == 0) return 0u;
  const int start = r * l;
  const int word = start >> 5;
  const int off = start & 31;
  const unsigned g0 = low[min(word, lw - 1)];
  const unsigned g1 = low[min(word + 1, lw - 1)];
  const unsigned v = (g0 >> off) | (off ? (g1 << (32 - off)) : 0u);
  return l >= 32 ? v : (v & ((1u << l) - 1u));
}

__global__ void __launch_bounds__(kWarps * 32)
ef_decode_kernel(const uint32_t* __restrict__ slots,
                 const int32_t* __restrict__ ids, long long n_slots,
                 int32_t* __restrict__ nbrs, int32_t* __restrict__ counts,
                 long long b, int words, int r_max, int l, int lw, int hb) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long s = (long long)blockIdx.x * kWarps + warp;
  if (s >= b) return;  // whole warp leaves together
  uint32_t* buf = smem + warp * (words + hb);  // the row's words
  uint32_t* pre = buf + words;  // set bits in high words 0..j (inclusive)
  long long row = s;
  if (ids) {
    row = ids[s];
    row = row < 0 ? 0 : (row >= n_slots ? n_slots - 1 : row);
  }
  const uint32_t* slot = slots + row * words;
  for (int i0 = 0; i0 < words; i0 += 32 * kBatch) {
    uint32_t v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + 32 * j + lane;
      v[j] = i < words ? __ldg(slot + i) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + 32 * j + lane;
      if (i < words) buf[i] = v[j];
    }
  }
  __syncwarp();
  const uint32_t* low = buf + 1;
  const uint32_t* high = buf + 1 + lw;
  if (lane == 0) counts[s] = (int32_t)buf[0];
  unsigned running = 0;
  for (int base = 0; base < hb; base += 32) {
    const int j = base + lane;
    unsigned incl = j < hb ? __popc(high[j]) : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (j < hb) pre[j] = running + incl;
    running += __shfl_sync(kFull, incl, 31);
  }
  __syncwarp();
  int32_t* out = nbrs + s * r_max;
  for (int r = lane; r < r_max; r += 32) {
    unsigned pos = 0;  // a rank the bitmap lacks decodes from position 0
    if ((unsigned)r < running) {
      int lo = 0, hi = hb - 1;  // first word whose prefix exceeds r
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (pre[mid] > (unsigned)r) hi = mid; else lo = mid + 1;
      }
      const unsigned before = lo ? pre[lo - 1] : 0u;
      pos = 32u * lo + __fns(high[lo], 0u, (int)((unsigned)r - before) + 1);
    }
    const unsigned hi_part = pos - (unsigned)r;
    out[r] = (int32_t)((hi_part << l) | low_part(low, r, l, lw));
  }
}

}  // namespace

extern "C" int ef_decode(const void* slots, const void* ids, void* nbrs,
                         void* counts, long long n_slots, long long b,
                         long long words, long long r_max, long long l,
                         long long lw, long long hb, void* stream) {
  const size_t smem = (size_t)kWarps * (words + hb) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ef_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ef_decode_kernel<<<(unsigned)((b + kWarps - 1) / kWarps), kWarps * 32,
                     smem, (cudaStream_t)stream>>>(
      (const uint32_t*)slots, (const int32_t*)ids, n_slots, (int32_t*)nbrs,
      (int32_t*)counts, b, (int)words, (int)r_max, (int)l, (int)lw, (int)hb);
  return (int)cudaGetLastError();
}
