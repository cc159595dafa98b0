// pq_adc: single-LUT PQ asymmetric distance computation on Hopper: one
// query's LUT against a whole table of code rows (an exhaustive scan).
//
// Replaces src/repro/kernels/pq_adc/pq_adc.py::pq_adc_pallas (_kernel),
// which scored row blocks by a one-hot x LUT matmul on the TPU's MXU. Here
// the lookup is a gather from shared memory.
//
//   codes [n, M] uint8 or int32, lut [M, K] float32 -> out [n] float32
//   out[i] = lut[0, c0] + lut[1, c1] + ... (left fold, m in order, each add
//   __fadd_rn: bit-identical to the plain version)
//
// Bounds at the shard's scan (n = 31.25M, M = 32 uint8, K = 256): bytes,
// 1.0 GB of codes + 125 MB of output; and the n*M = 1e9 LUT reads from
// shared memory, at 32 a clock an SM when a warp's 32 reads fall on 32
// distinct banks. A lane a row reading lut[m, c] of an [M, K] LUT hits
// bank c % 32, so random codes cost ~3 passes a read, which puts the LUT
// reads near the byte bound; on the card that layout ran 18% slower on
// random codes than on all-equal ones (PERF.md). So the shard's
// shape takes a conflict-free layout:
//
// - lagged (uint8, M = 32, 16-byte aligned codes and LUT): lane l runs l
//   steps behind lane 0. At step t it reads subspace (t - l) mod 32: of
//   its current row for t >= l, of its previous row for t < l, so the
//   warp's 32 reads name 32 distinct subspaces. The LUT is stored
//   transposed and doubled, d[c * 64 + j] = lut[j % 32, c], so that read
//   is d[c * 64 + 32 - l + t], on bank (t - l) mod 32 whatever the code;
//   one byte_perm builds its offset from the code byte. A lane keeps its
//   row rotated by l bytes (the order of its two 16-byte loads, two selects
//   and a funnel shift), so step t reads byte t of a register, and it
//   carries two sums: the previous row's, finished at t = l - 1, and the
//   current row's, started from -0.0 (the additive identity) at t = l.
//   Each is a left fold in m. One row a lane is in flight while it folds
//   the last (more held ahead spilled registers and ran slower).
// - rows (every other shape): a lane folds whole rows, loaded with
//   adc_rows.cuh's 16-, 8-, 4- or 1-byte loads, four before the first is
//   folded, and accepts the bank conflicts; int32 codes and rows wider
//   than 32 bytes are folded straight from device memory.
//
// Both run a persistent grid of 1,024-thread blocks (one an SM, as the
// shared memory and registers allow), each block copying the LUT into
// shared memory once, by a bulk copy on an mbarrier that lands while its
// first rows load (a plain copy where the LUT is not 16-byte aligned).
#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_rows.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kRows = 4;    // rows a thread loads before folding (rows)
constexpr int kLag = 32;    // M of the lagged path (one subspace a lane)

// ------------------------------------------------------------ rows path
template <typename Code, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
pq_adc_rows(const Code* __restrict__ codes, const float* __restrict__ lut,
            float* __restrict__ out, long long n, int m, int k, int bulk,
            int off_bar) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s = (float*)smem;
  unsigned long long* bar = (unsigned long long*)(smem + off_bar);
  const int tid = threadIdx.x;
  if (bulk) {
    if (tid == 0) adc::lut_barrier_init(bar);
    __syncthreads();
    if (tid == 0)
      adc::lut_copy_start(s, lut, (unsigned)(m * k * sizeof(float)), bar);
  }
  const uint8_t* table = (const uint8_t*)codes;
  const long long step = (long long)gridDim.x * kThreads;
  long long row = (long long)blockIdx.x * kThreads + tid;
  for (bool first = true;; first = false) {
    uint32_t w[kRows][adc::kRowBytes / 4];
    if (VEC) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (row + r * step < n)
          adc::load_row<VEC>(table, row + r * step, m, w[r]);
    }
    if (first) {   // the first rows' loads fly while the LUT arrives
      if (bulk) {
        adc::lut_copy_wait(bar);
      } else {
        for (int i = tid; i < m * k; i += kThreads) s[i] = lut[i];
        __syncthreads();
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long x = row + r * step;
      if (x >= n) break;
      if constexpr (sizeof(Code) == 1) {
        out[x] = adc::fold_row<VEC>(s, w[r], table, x, m, k);
      } else {
        const Code* c = codes + x * m;
        float d = s[__ldg(c)];
        for (int j = 1; j < m; ++j)
          d = __fadd_rn(d, s[j * k + __ldg(c + j)]);
        out[x] = d;
      }
    }
    row += kRows * step;
    if (row >= n) break;
  }
}

// ---------------------------------------------------------- lagged path
// A 32-byte row into w, its 16-byte halves swapped where ``h`` (the
// rotation by four words); zeros where !ok.
__device__ __forceinline__ void load_halves(uint32_t* w, const uint8_t* row,
                                            int h, bool ok) {
  uint4 a = make_uint4(0, 0, 0, 0), b = a;
  if (ok) {
    a = __ldg((const uint4*)row + h);
    b = __ldg((const uint4*)row + (h ^ 1));
  }
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// r = the row rotated by ``lane`` bytes (byte t of r is byte (t - lane)
// mod 32 of the row), from x, the row already rotated by four words where
// lane & 16.
__device__ __forceinline__ void rotate(const uint32_t* x, int lane,
                                       uint32_t* r) {
  uint32_t y1[8], y[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) y1[i] = (lane & 4) ? x[(i + 7) & 7] : x[i];
#pragma unroll
  for (int i = 0; i < 8; ++i) y[i] = (lane & 8) ? y1[(i + 6) & 7] : y1[i];
  const unsigned sh = 8 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r[i] = __funnelshift_l(y[(i + 7) & 7], y[i], sh);
}

// v onto the previous row's sum for t < lane, else onto the current row's.
__device__ __forceinline__ void fold2(float& prev, float& cur, float v, int t,
                                      int lane) {
  asm("{\n .reg .pred p;\n setp.lt.s32 p, %2, %3;\n"
      " @p add.rn.f32 %0, %0, %4;\n @!p add.rn.f32 %1, %1, %4;\n}\n"
      : "+f"(prev), "+f"(cur) : "r"(t), "r"(lane), "f"(v));
}

__global__ void __launch_bounds__(kThreads, 1)
pq_adc_lagged(const uint8_t* __restrict__ codes,
              const float* __restrict__ lut, float* __restrict__ out,
              long long n, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* d = (float*)smem;                           // [k, 64]
  float* stage = (float*)(smem + k * 64 * 4);        // [32, k], as given
  unsigned long long* bar =
      (unsigned long long*)(smem + k * (64 + kLag) * 4);
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) adc::lut_barrier_init(bar);
  __syncthreads();
  if (tid == 0)
    adc::lut_copy_start(stage, lut, (unsigned)(kLag * k * 4), bar);

  // Rows first, first + step, ...; the warp runs as many steps as its
  // lane 0 has rows, plus one that finishes the last row.
  const long long step = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + tid;
  const long long lead = first - lane;
  const long long cnt = lead < n ? (n - 1 - lead) / step + 1 : 0;
  const int h = (lane >> 4) & 1;
  uint32_t next[8];   // the row after the one being folded, in flight
  load_halves(next, codes + first * kLag, h, first < n);
  adc::lut_copy_wait(bar);
  // d[c * 64 + j] = stage[(j % 32) * k + c]: lane i takes c = 32b + i and
  // j = (i + q) % 32 (and j + 32), so both sides hit 32 distinct banks.
  for (int q = tid >> 5; q < ((k + 31) & ~31); q += kThreads / 32) {
    const int c = (q & ~31) + lane, j = (lane + q) & 31;
    if (c < k) d[c * 64 + j] = d[c * 64 + j + 32] = stage[j * k + c];
  }
  __syncthreads();

  // Bytes t < lane come from the previous row: words w < qw whole, and the
  // low bytes (mk) of word qw.
  const int qw = lane >> 2;
  const uint32_t mk = (1u << (8 * (lane & 3))) - 1u;
  const uint32_t e = 128 - 4 * lane;   // byte offset of j = 32 - lane
  const unsigned char* dbytes = (const unsigned char*)d;
  uint32_t prev[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  float sum_prev = -0.0f;
  long long x = first;
  for (long long i = 0; i <= cnt; ++i, x += step) {
    uint32_t cur[8];
    rotate(next, lane, cur);
    load_halves(next, codes + (x + step) * kLag, h, x + step < n);
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const uint32_t mix = (prev[w] & mk) | (cur[w] & ~mk);
      prev[w] = w < qw ? prev[w] : w > qw ? cur[w] : mix;
    }
    float sum_cur = -0.0f;
#pragma unroll
    for (int t = 0; t < kLag; ++t) {
      // e + 256 * code: d's row of the code, column 32 - lane
      const uint32_t off =
          __byte_perm(prev[t >> 2], e, 0x6504 | ((t & 3) << 4));
      fold2(sum_prev, sum_cur, *(const float*)(dbytes + off + 4 * t), t,
            lane);
    }
    const long long done = x - step;   // the previous row, now folded
    if (done >= 0 && done < n) out[done] = sum_prev;
    sum_prev = sum_cur;
#pragma unroll
    for (int w = 0; w < 8; ++w) prev[w] = cur[w];
  }
}

// ---------------------------------------------------------------- launch
template <typename Kernel>
int grid_for(Kernel kernel, size_t smem, long long n, int* blocks) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long need = (n + kThreads - 1) / kThreads;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = (int)(need < most ? need : most);
  return 0;
}

template <typename Code, int VEC>
int run_rows(const void* codes, const void* lut, void* out, long long n,
             long long m, long long k, cudaStream_t stream) {
  const size_t lut_bytes = (size_t)m * k * sizeof(float);
  const int bulk = ((uintptr_t)lut % 16 == 0) && (lut_bytes % 16 == 0);
  const size_t off_bar = (lut_bytes + 15) & ~(size_t)15;
  const size_t smem = off_bar + 16;
  int blocks = 0;
  int err = grid_for(pq_adc_rows<Code, VEC>, smem, n, &blocks);
  if (err) return err;
  pq_adc_rows<Code, VEC><<<blocks, kThreads, smem, stream>>>(
      (const Code*)codes, (const float*)lut, (float*)out, n, (int)m, (int)k,
      bulk, (int)off_bar);
  return (int)cudaGetLastError();
}

int run_lagged(const void* codes, const void* lut, void* out, long long n,
               long long k, cudaStream_t stream) {
  const size_t smem = (size_t)k * (64 + kLag) * 4 + 16;
  int blocks = 0;
  int err = grid_for(pq_adc_lagged, smem, n, &blocks);
  if (err) return err;
  pq_adc_lagged<<<blocks, kThreads, smem, stream>>>(
      (const uint8_t*)codes, (const float*)lut, (float*)out, n, (int)k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pq_adc(const void* codes, const void* lut, void* out,
                      long long n, long long m, long long k,
                      long long code_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (code_bytes != 1)
    return run_rows<int32_t, 0>(codes, lut, out, n, m, k, s);
  if (m == kLag && (uintptr_t)codes % 16 == 0 && (uintptr_t)lut % 16 == 0
      && k * (64 + kLag) * 4 + 16 <= 227 * 1024)
    return run_lagged(codes, lut, out, n, k, s);
  switch (adc::row_vec(codes, m)) {
    case 0: return run_rows<uint8_t, 0>(codes, lut, out, n, m, k, s);
    case 16: return run_rows<uint8_t, 16>(codes, lut, out, n, m, k, s);
    case 8: return run_rows<uint8_t, 8>(codes, lut, out, n, m, k, s);
    case 4: return run_rows<uint8_t, 4>(codes, lut, out, n, m, k, s);
    default: return run_rows<uint8_t, 1>(codes, lut, out, n, m, k, s);
  }
}
