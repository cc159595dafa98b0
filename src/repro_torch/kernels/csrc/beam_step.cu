// beam_step: the fused hop tail of the batch-first beam search (§3.4).
//
// Replaces src/repro/kernels/beam_step/beam_step.py::beam_step_pallas
// (_kernel), which scored neighbours by a one-hot x LUT matmul on the MXU
// and selected the top-L with a [T, T] stable-rank compare.
//
//   codes [nq, E, M] uint8, luts [nq, M, K] f32, cand_ids [nq, L] i32,
//   cand_d [nq, L] f32, new_ids [nq, E] i32 (-1 = masked)
//   -> ids [nq, L] i32, d [nq, L] f32, top_idx [nq, L] i32
//   d_new[e] = ADC of codes[e] (m folded in order), +inf where new_ids < 0;
//   merged = [cand | new] (T = L + E); output = the L smallest merged
//   entries by (distance, merged index) — lax.top_k's tie-break.
//
// Bound: bytes (the LUTs, 32 KiB a query, and the codes dominate: ~56.5 MB
// per hop at nq=1024, E=512, M=32, L=200). Design: one block per query.
// The block stages the query's LUT in shared memory and scores the E
// neighbours by gather, folding m in order with __fadd_rn (bit-identical to
// the plain version). Each merged entry becomes a 64-bit key: the
// order-preserving bits of its distance (-0 folded onto +0) above its
// merged index, so keys are distinct and their ascending order is
// (distance, index) order. A bitonic sort of the next power of two >= T
// keys in shared memory then yields the top L. At T = 712 the block holds
// 32 KiB of LUT + 12 KiB of keys and distances.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned long long sort_key(float d, unsigned t) {
  unsigned u = __float_as_uint(d);
  if (u == 0x80000000u) u = 0u;  // -0 ties with +0, as a float compare does
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | t;
}

__global__ void beam_step_kernel(const uint8_t* __restrict__ codes,
                                 const float* __restrict__ luts,
                                 const int32_t* __restrict__ cand_ids,
                                 const float* __restrict__ cand_d,
                                 const int32_t* __restrict__ new_ids,
                                 int32_t* __restrict__ out_ids,
                                 float* __restrict__ out_d,
                                 int32_t* __restrict__ out_idx, int e,
                                 int l_size, int m, int k, int tpad,
                                 int key_offset) {
  extern __shared__ unsigned char smem[];
  float* lut = (float*)smem;
  unsigned long long* keys = (unsigned long long*)(smem + key_offset);
  float* md = (float*)(keys + tpad);
  const long long q = blockIdx.x;
  const int t_real = l_size + e;
  const float* lq = luts + q * m * k;
  for (int i = threadIdx.x; i < m * k; i += blockDim.x) lut[i] = lq[i];
  __syncthreads();
  for (int t = threadIdx.x; t < tpad; t += blockDim.x) {
    if (t >= t_real) {
      keys[t] = ~0ull;
      continue;
    }
    float d;
    if (t < l_size) {
      d = cand_d[q * l_size + t];
    } else if (new_ids[q * e + (t - l_size)] < 0) {
      d = __int_as_float(0x7f800000);
    } else {
      const uint8_t* c = codes + (q * e + (t - l_size)) * m;
      d = lut[c[0]];
      for (int j = 1; j < m; ++j) d = __fadd_rn(d, lut[j * k + c[j]]);
    }
    md[t] = d;
    keys[t] = sort_key(d, (unsigned)t);
  }
  __syncthreads();
  for (int size = 2; size <= tpad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (tpad >> 1); i += blockDim.x) {
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
  for (int p = threadIdx.x; p < l_size; p += blockDim.x) {
    const int t = (int)(keys[p] & 0xffffffffull);
    out_idx[q * l_size + p] = t;
    out_d[q * l_size + p] = md[t];
    out_ids[q * l_size + p] =
        t < l_size ? cand_ids[q * l_size + t] : new_ids[q * e + (t - l_size)];
  }
}

}  // namespace

extern "C" int beam_step(const void* codes, const void* luts,
                         const void* cand_ids, const void* cand_d,
                         const void* new_ids, void* out_ids, void* out_d,
                         void* out_idx, long long nq, long long e,
                         long long l_size, long long m, long long k,
                         void* stream) {
  int tpad = 1;
  while (tpad < l_size + e) tpad <<= 1;
  const int key_offset = (int)(((size_t)m * k * sizeof(float) + 7) & ~7ull);
  const size_t smem = key_offset + (size_t)tpad * (sizeof(unsigned long long)
                                                   + sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        beam_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = tpad / 2;
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  beam_step_kernel<<<(unsigned)nq, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const float*)luts, (const int32_t*)cand_ids,
      (const float*)cand_d, (const int32_t*)new_ids, (int32_t*)out_ids,
      (float*)out_d, (int32_t*)out_idx, (int)e, (int)l_size, (int)m, (int)k,
      tpad, key_offset);
  return (int)cudaGetLastError();
}
