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
// buffer. Every lane is busy and the stores are coalesced. The warp's
// staging and decode are ef_rows.cuh's, shared with round_expand.cu.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ef_rows.cuh"

namespace {

constexpr int kWarps = 8;

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
  const unsigned running = ef::stage(slots + row * words, words, lw, hb,
                                     buf, pre, lane);
  if (lane == 0) counts[s] = (int32_t)buf[0];
  int32_t* out = nbrs + s * r_max;
  for (int r = lane; r < r_max; r += 32)
    out[r] = ef::value(buf, pre, running, r, l, lw, hb);
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
