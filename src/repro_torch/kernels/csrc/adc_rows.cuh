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
// - lut_sliced / slices_start / fold_sliced: a LUT too large for a
//   block's shared memory on the device (M = 384 at K = 256 is 384 KiB;
//   each entry point asks the device), staged kSlice sub-spaces at a
//   time in two buffers: the bulk copy of slice s + 2 starts once every
//   thread is done with slice s, so one slice lands while the other is
//   read. A row's bytes of each slice come in 16-byte loads where the
//   row width and the table's address allow it, and its sum is carried
//   from slice to slice in m order, so it is the same left fold.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace adc {

constexpr int kRowBytes = 32;  // widest row kept in registers
constexpr int kSlice = 32;     // sub-spaces of a staged LUT slice

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

// Wait for the phase of ``bar`` of that parity (0 for its first use).
__device__ __forceinline__ void lut_copy_wait(unsigned long long* bar,
                                              unsigned parity = 0) {
  unsigned done = 0;
  for (long long spin = 0; !done; ++spin) {
    if (spin == (1ll << 24)) __trap();  // a copy that never lands faults
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// The m bytes at src (those of the first kRowBytes) into w[0..8) (bytes
// little-endian), VEC bytes a load; VEC == 0 keeps nothing.
template <int VEC>
__device__ __forceinline__ void load_bytes(const uint8_t* __restrict__ src,
                                           int m, uint32_t* w) {
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

// Row `id` of the table into w[0..8) (bytes little-endian), VEC bytes a
// load; VEC == 0 keeps nothing (rows wider than kRowBytes).
template <int VEC>
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ table,
                                         long long id, int m, uint32_t* w) {
  load_bytes<VEC>(table + id * m, m, w);
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

// The widest load the rows of m bytes at ``table`` allow, from a row's
// start or from any slice's (slices start kSlice bytes apart).
inline int slice_vec(const void* table, long long m) {
  const uintptr_t at = (uintptr_t)table;
  if (m % 16 == 0 && at % 16 == 0) return 16;
  if (m % 8 == 0 && at % 8 == 0) return 8;
  if (m % 4 == 0 && at % 4 == 0) return 4;
  return 1;
}

// The widest load a row of m bytes at ``table`` allows (0: too wide to
// keep in registers).
inline int row_vec(const void* table, long long m) {
  return m > kRowBytes ? 0 : slice_vec(table, m);
}

// ------------------------------------------------------- sliced LUTs
// Shared memory of the two slice buffers.
inline size_t slice_bytes(long long k) {
  return 2 * (size_t)kSlice * k * sizeof(float);
}

// Shared memory a block of the current device may take (227 KB on sm_90).
inline size_t smem_limit() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return (size_t)bytes;
}

// The whole LUT (to 16 bytes) beside ``other`` bytes of a block's shared
// memory: staged whole where that fits the device, else in slices.
inline bool lut_sliced(long long m, long long k, size_t other) {
  return (((size_t)m * k * sizeof(float) + 15) & ~(size_t)15) + other >
         smem_limit();
}

inline long long lut_slices(long long m, long long k, size_t other) {
  return lut_sliced(m, k, other) ? (m + kSlice - 1) / kSlice : 1;
}

// Sub-spaces of slice s.
__device__ __forceinline__ int slice_len(int s, int m) {
  return min(kSlice, m - s * kSlice);
}

// Thread 0 only: start the copy of slice s of the [m, k] LUT ``lq`` into
// its buffer (bufs + (s & 1) * kSlice * k) on bar[s & 1].
__device__ __forceinline__ void slice_copy_start(float* bufs, const float* lq,
                                                 int s, int m, int k,
                                                 unsigned long long* bar) {
  lut_copy_start(bufs + (s & 1) * kSlice * k, lq + (long long)s * kSlice * k,
                 (unsigned)(slice_len(s, m) * k * sizeof(float)),
                 bar + (s & 1));
}

// Every thread: arm both barriers, then thread 0 starts the first two
// slices' copies. Only where the bulk copy applies (``bulk``).
__device__ __forceinline__ void slices_start(float* bufs, const float* lq,
                                             int m, int k,
                                             unsigned long long* bar) {
  if (threadIdx.x == 0) {
    lut_barrier_init(bar);
    lut_barrier_init(bar + 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    slice_copy_start(bufs, lq, 0, m, k, bar);
    if (m > kSlice) slice_copy_start(bufs, lq, 1, m, k, bar);
  }
}

// Continue the ADC d of a row over the cnt sub-spaces of a slice (lut
// [cnt, k], the row's bytes in w); ``first``: the slice of m = 0, where
// the fold starts from its first entry.
__device__ __forceinline__ float fold_slice(float d, bool first,
                                            const float* lut,
                                            const uint32_t* w, int cnt,
                                            int k) {
#pragma unroll
  for (int j = 0; j < kSlice; ++j)
    if (j < cnt) {
      const float v = lut[j * k + ((w[j >> 2] >> (8 * (j & 3))) & 0xffu)];
      d = (first && j == 0) ? v : __fadd_rn(d, v);
    }
  return d;
}

// Every thread: part[x] = ADC of row ids(x) (clipped to n - 1; +inf where
// it is < 0) for x < e, rows (x % blockDim.x) a thread, against the LUT
// lq staged slice by slice in bufs (slice_bytes(k)); with ``bulk`` the
// first two copies were started (slices_start), else each slice is
// copied by the block. A thread reads back only its own part entries.
// Ends synced.
template <int VEC, int ROWS, typename Ids>
__device__ __forceinline__ void fold_sliced(
    const uint8_t* __restrict__ table, long long n, const float* lq, int m,
    int k, int e, int bulk, float* bufs, unsigned long long* bar,
    const Ids& ids, float* part) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int slices = (m + kSlice - 1) / kSlice;
  for (int s = 0; s < slices; ++s) {
    const int cnt = slice_len(s, m);
    const float* lut = bufs + (bulk ? (s & 1) : 0) * kSlice * k;
    if (!bulk) {
      for (int i = tid; i < cnt * k; i += nt)
        bufs[i] = lq[(long long)s * kSlice * k + i];
      __syncthreads();
    }
    // at least one pass, so that every thread waits on every slice
    for (int g0 = 0; g0 == 0 || g0 < e; g0 += ROWS * nt) {
      long long rid[ROWS];
      uint32_t w[ROWS][kSlice / 4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int x = g0 + r * nt + tid;
        rid[r] = x < e ? (long long)ids(x) : -1;
        if (rid[r] >= n) rid[r] = n - 1;
        if (rid[r] >= 0)
          load_bytes<VEC>(table + rid[r] * m + s * kSlice, m - s * kSlice,
                          w[r]);
      }
      if (bulk && g0 == 0) lut_copy_wait(bar + (s & 1), (s >> 1) & 1);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int x = g0 + r * nt + tid;
        if (x < e)
          part[x] = rid[r] >= 0
              ? fold_slice(s ? part[x] : 0.0f, s == 0, lut, w[r], cnt, k)
              : __int_as_float(0x7f800000);
      }
    }
    __syncthreads();  // every thread is done with the slice's buffer
    if (bulk && tid == 0 && s + 2 < slices) {
      // the block's reads of the buffer before the copy's writes into it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      slice_copy_start(bufs, lq, s + 2, m, k, bar);
    }
  }
}

}  // namespace adc
