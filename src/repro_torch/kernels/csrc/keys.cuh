// keys.cuh: sort keys and the in-block sort that beam_step.cu,
// round_expand.cu and round_settle.cu share.
//
// - sort_key: a 64-bit key of a (distance, index) pair, ascending in
//   (distance, index) order: the order-preserving bits of the float (-0
//   folded onto +0, so the two tie as a float compare has them) above the
//   index. Keys are distinct where the indices are.
// - bitonic_i32: an ascending bitonic sort of a power-of-two run of int32
//   keys in shared memory by the whole block.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace keys {

__device__ __forceinline__ unsigned long long sort_key(float d, unsigned t) {
  unsigned u = __float_as_uint(d);
  if (u == 0x80000000u) u = 0u;  // -0 ties with +0, as a float compare does
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | t;
}

// Ascending bitonic sort of v[0..p), p a power of two, by every thread
// of the block (a multiple of 32 threads); ends synced. A stage of stride
// <= 32 swaps within 64-entry chunks, each of which one warp alone reads
// and writes (pair i is thread i mod blockDim's), so between two such
// stages a warp barrier orders the block's work; the block synchronises
// around the stages that cross chunks and at the end.
__device__ __forceinline__ void bitonic_i32(int32_t* v, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (p >> 1); i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const int32_t a = v[lo], b = v[hi];
        if ((a > b) == ((lo & size) == 0)) {
          v[lo] = b;
          v[hi] = a;
        }
      }
      const int next = stride > 1 ? stride >> 1 : size;  // the next stride
      if (stride > 32 || next > 32 || (size == p && stride == 1))
        __syncthreads();
      else
        __syncwarp();
    }
  }
}

}  // namespace keys
