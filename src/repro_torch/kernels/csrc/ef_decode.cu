// ef_decode: Elias-Fano fixed-slot decode of adjacency lists (§3.2-§3.4).
//
// Replaces src/repro/kernels/ef_decode/ef_decode.py::ef_decode_pallas
// (_make_kernel), which found the i-th set bit of the high bitmap with an
// [R, nbits] rank-compare laid out for the TPU's vector unit. Here select
// is a popcount prefix over the bitmap's words.
//
//   slots [B, W] uint32 -> nbrs [B, r_max] int32, counts [B] int32
//   word 0 = count; words 1..lw = r_max low parts of l bits each;
//   words lw+1..lw+hb = high bitmap (bit high[i] + i set).
//   nbrs[i] = ((pos_i - i) << l) | low_i, pos_i = position of set bit i;
//   padding decodes to universe-1; a rank the bitmap lacks decodes from
//   position 0, as the reference's argmax does.
//
// Bound: bytes at the serving shapes (B = nq*W = 4096 slots of 324 B in,
// 512 B out each: ~3.4 MB, launch-bound). Design: one warp per slot. Each
// lane takes one bitmap word, the warp scans the popcounts to give every
// word the rank of its first set bit, and the lane walks its word's set
// bits (__ffs), writing each decoded value with its low part unpacked
// across the word boundary.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
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

__global__ void ef_decode_kernel(const uint32_t* __restrict__ slots,
                                 int32_t* __restrict__ nbrs,
                                 int32_t* __restrict__ counts, long long b,
                                 int words, int r_max, int l, int lw,
                                 int hb) {
  const int lane = threadIdx.x & 31;
  const long long s = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= b) return;  // whole warp leaves together
  const uint32_t* slot = slots + s * words;
  const uint32_t* low = slot + 1;
  const uint32_t* high = slot + 1 + lw;
  int32_t* out = nbrs + s * r_max;
  if (lane == 0) counts[s] = (int32_t)slot[0];
  unsigned running = 0;
  for (int base = 0; base < hb; base += 32) {
    const int j = base + lane;
    unsigned w = j < hb ? high[j] : 0u;
    const unsigned pc = __popc(w);
    unsigned incl = pc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    unsigned r = running + incl - pc;
    while (w) {
      const int bit = __ffs(w) - 1;
      w &= w - 1;
      if (r < (unsigned)r_max) {
        const unsigned hi = (unsigned)(j * 32 + bit) - r;
        out[r] = (int32_t)((hi << l) | low_part(low, (int)r, l, lw));
      }
      ++r;
    }
    running += __shfl_sync(kFull, incl, 31);
  }
  for (unsigned r = running + lane; r < (unsigned)r_max; r += 32) {
    const unsigned hi = 0u - r;
    out[r] = (int32_t)((hi << l) | low_part(low, (int)r, l, lw));
  }
}

}  // namespace

extern "C" int ef_decode(const void* slots, void* nbrs, void* counts,
                         long long b, long long words, long long r_max,
                         long long l, long long lw, long long hb,
                         void* stream) {
  ef_decode_kernel<<<(unsigned)((b + kWarps - 1) / kWarps), kWarps * 32, 0,
                     (cudaStream_t)stream>>>(
      (const uint32_t*)slots, (int32_t*)nbrs, (int32_t*)counts, b, (int)words,
      (int)r_max, (int)l, (int)lw, (int)hb);
  return (int)cudaGetLastError();
}
