// adc_rows.cuh: what beam_step.cu, pq_adc_batched.cu and pq_adc.cu share
// to score PQ code rows against a query's LUT in shared memory.
//
// - lut_copy_start / lut_copy_wait: one thread starts a bulk copy
//   (cp.async.bulk, the TMA's non-tensor form) of the LUT into shared
//   memory, its completion counted on an mbarrier; every thread waits on
//   the barrier later, with a bounded spin (a copy that never lands traps).
// - load_row<VEC>: a code row of the [n, M] table into registers, VEC bytes
//   a load (16, 8, 4 or 1; 0 keeps nothing, for rows wider than
//   kRowBytes, which fold_row then reads byte by byte).
// - fold_row<VEC>: the row's ADC, m folded in order with __fadd_rn, so the
//   sum is bit-identical to the plain version's left fold.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace adc {

constexpr int kRowBytes = 32;  // widest row kept in registers

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Thread 0 only: arm ``bar`` (initialised by lut_barrier_init) for
// ``bytes`` and start the copy of ``src`` into ``dst``. Both addresses
// and ``bytes`` are multiples of 16.
__device__ __forceinline__ void lut_copy_start(void* dst, const void* src,
                                               unsigned bytes,
                                               unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Thread 0 only; the block must sync before another thread waits.
__device__ __forceinline__ void lut_barrier_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void lut_copy_wait(unsigned long long* bar) {
  unsigned done = 0;
  for (long long spin = 0; !done; ++spin) {
    if (spin == (1ll << 24)) __trap();  // a copy that never lands faults
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)) : "memory");
  }
}

// Row `id` of the table into w[0..8) (bytes little-endian), VEC bytes a
// load; VEC == 0 keeps nothing (rows wider than kRowBytes).
template <int VEC>
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ table,
                                         long long id, int m, uint32_t* w) {
  const uint8_t* src = table + id * m;
  if (VEC == 16) {
#pragma unroll
    for (int j = 0; j < kRowBytes / 16; ++j)
      if (j * 16 < m) {
        const uint4 v = __ldg((const uint4*)src + j);
        w[4 * j] = v.x; w[4 * j + 1] = v.y;
        w[4 * j + 2] = v.z; w[4 * j + 3] = v.w;
      }
  } else if (VEC == 8) {
#pragma unroll
    for (int j = 0; j < kRowBytes / 8; ++j)
      if (j * 8 < m) {
        const uint2 v = __ldg((const uint2*)src + j);
        w[2 * j] = v.x; w[2 * j + 1] = v.y;
      }
  } else if (VEC == 4) {
#pragma unroll
    for (int j = 0; j < kRowBytes / 4; ++j)
      if (j * 4 < m) w[j] = __ldg((const uint32_t*)src + j);
  } else if (VEC == 1) {
#pragma unroll
    for (int j = 0; j < kRowBytes / 4; ++j) w[j] = 0u;
#pragma unroll
    for (int j = 0; j < kRowBytes; ++j)
      if (j < m) w[j >> 2] |= (uint32_t)__ldg(src + j) << (8 * (j & 3));
  }
}

// ADC of one row, m folded in order (lut in shared memory, [m, k]).
template <int VEC>
__device__ __forceinline__ float fold_row(const float* lut, const uint32_t* w,
                                          const uint8_t* __restrict__ table,
                                          long long id, int m, int k) {
  if (VEC == 0) {
    const uint8_t* c = table + id * m;
    float d = lut[__ldg(c)];
    for (int j = 1; j < m; ++j) d = __fadd_rn(d, lut[j * k + __ldg(c + j)]);
    return d;
  }
  float d = lut[w[0] & 0xffu];
#pragma unroll
  for (int j = 1; j < kRowBytes; ++j)
    if (j < m) d = __fadd_rn(d, lut[j * k + ((w[j >> 2] >> (8 * (j & 3)))
                                             & 0xffu)]);
  return d;
}

// The widest load a row of m bytes at ``table`` allows (0: too wide to
// keep in registers).
inline int row_vec(const void* table, long long m) {
  const uintptr_t at = (uintptr_t)table;
  if (m > kRowBytes) return 0;
  if (m % 16 == 0 && at % 16 == 0) return 16;
  if (m % 8 == 0 && at % 8 == 0) return 8;
  if (m % 4 == 0 && at % 4 == 0) return 4;
  return 1;
}

}  // namespace adc
