// ef_rows.cuh: one warp's decode of one Elias-Fano fixed slot, shared by
// ef_decode.cu (a warp a row of the table) and round_expand.cu (a warp a
// list of the round's frontier).
//
// Slot layout (core/codec/elias_fano.py): word 0 = count; words 1..lw =
// r_max low parts of l bits each; words lw+1..lw+hb = the high bitmap
// (bit high[i] + i set). Value i = ((pos_i - i) << l) | low_i, pos_i the
// position of set bit i; a rank the bitmap lacks decodes from position 0,
// as the reference's argmax does.
//
// - stage: the warp reads the slot's words coalesced (4-byte loads, all
//   in flight at once) into its shared buffer and scans the popcounts of
//   the high words with shuffles into a prefix -> the bitmap's set bits.
// - value: rank r of the staged slot: a binary search over the prefix
//   finds the word that holds it, __fns the bit in it, and the low part
//   comes from the buffer.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ef {

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

// The whole warp: slot's ``words`` words into buf[0..words) and the
// inclusive popcount prefix of its hb high words into pre[0..hb) -> the
// bitmap's set bits, in every lane. Ends warp-synced.
__device__ __forceinline__ unsigned stage(const uint32_t* __restrict__ slot,
                                          int words, int lw, int hb,
                                          uint32_t* buf, uint32_t* pre,
                                          int lane) {
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
  const uint32_t* high = buf + 1 + lw;
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
  return running;
}

// Value of rank r of a slot staged by ``stage`` (``running`` its result).
__device__ __forceinline__ int32_t value(const uint32_t* buf,
                                         const uint32_t* pre,
                                         unsigned running, int r, int l,
                                         int lw, int hb) {
  const uint32_t* high = buf + 1 + lw;
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
  return (int32_t)((hi_part << l) | low_part(buf + 1, r, l, lw));
}

}  // namespace ef
