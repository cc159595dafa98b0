// rerank_l2: exact squared L2 distances for the phase-2 re-rank (§3.4),
// the candidate rows read by id.
//
// Replaces src/repro/kernels/rerank_l2/rerank_l2.py::rerank_l2_pallas
// (_kernel_grouped). The Pallas body used ||q||^2 + ||x||^2 - 2 q.x on the
// MXU, which can dip below 0; this kernel computes the contract of the
// reference oracle instead:
//
//   queries [Q, D] float32, table [N, D] uint8 or float32, ids [Q, C] int32
//   -> out [Q, C] float32
//   out[q, c] = sum_d (float(x[d]) - q[q, d])^2, folded over d in order,
//   x = table[clip(ids[q, c], 0, N - 1)] (no masking: the caller masks).
//   Without ids (null), the table is the [Q * C, D] view of gathered
//   [Q, C, D] candidates and x is row q * C + c.
//
// Bound: bytes (Q*C*D candidate bytes in, Q*C*4 out; 3 flops a byte is far
// below the card's ratio). At the serving shapes (Q=1024, C=10, D=128 u8)
// it moves ~1.9 MB, ~0.6 us: a launch's own latency is the floor. Design:
// one warp per query, kWarps queries a block, so Q=1024 spreads over every
// SM. The warp stages its query and up to 32 candidate rows in shared
// memory, a tile of at most kTileBytes of each row at a time: the rows by
// id with coalesced loads (16 bytes a lane where the row width and the
// table's address allow it, else 8, 4 or 1), the query as floats. Rows sit
// at an odd word stride, so when lane c then folds row c over d, the 32
// lanes read 32 different banks. Each lane loads kStep elements of its row
// and of the query before it folds them, so the fold does not wait on each
// shared-memory load. The fold runs __fsub_rn/__fmul_rn/__fadd_rn over d in
// order, carried across tiles, so nvcc cannot contract it into FMAs and the
// result is bit-identical to the plain version. Any C (chunks of 32
// candidates), any D (tiles) and either dtype.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;          // queries a block
constexpr int kTileBytes = 512;    // bytes of a row staged at a time
constexpr int kBatch = 4;          // loads a lane issues before storing
constexpr int kStep = 32;          // elements a lane loads before folding
constexpr unsigned kFull = 0xffffffffu;

// Element i of a staged row (uint8 rows: four to a word, little-endian).
template <typename T>
__device__ __forceinline__ float elem(const uint32_t* row, int i);

template <>
__device__ __forceinline__ float elem<uint8_t>(const uint32_t* row, int i) {
  return (float)((row[i >> 2] >> (8 * (i & 3))) & 0xffu);
}

template <>
__device__ __forceinline__ float elem<float>(const uint32_t* row, int i) {
  return __uint_as_float(row[i]);
}

// Store the VEC-byte word v at byte `off` of a staged row (4-byte aligned
// when VEC >= 4; the row's start is 4-byte aligned, not 16).
template <int VEC>
__device__ __forceinline__ void stage(uint32_t* row, int off,
                                      const uint4& v) {
  if (VEC == 1) {
    ((uint8_t*)row)[off] = (uint8_t)v.x;
  } else {
    uint32_t* dst = row + off / 4;
    dst[0] = v.x;
    if (VEC >= 8) dst[1] = v.y;
    if (VEC == 16) { dst[2] = v.z; dst[3] = v.w; }
  }
}

template <int VEC>
__device__ __forceinline__ uint4 load_word(const uint8_t* __restrict__ p) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (VEC == 16) {
    v = __ldg((const uint4*)p);
  } else if (VEC == 8) {
    const uint2 u = __ldg((const uint2*)p);
    v.x = u.x; v.y = u.y;
  } else if (VEC == 4) {
    v.x = __ldg((const uint32_t*)p);
  } else {
    v.x = __ldg(p);
  }
  return v;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
rerank_l2_kernel(const float* __restrict__ queries,
                 const uint8_t* __restrict__ table, long long n,
                 const int32_t* __restrict__ ids, float* __restrict__ out,
                 long long nq, int c, int d, int tile, int stride, int chunk,
                 int region) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q = (long long)blockIdx.x * kWarps + warp;
  if (q >= nq) return;  // whole warps only; nothing below syncs the block
  float* qs = (float*)smem + warp * region;  // 16-byte aligned
  uint32_t* rows = (uint32_t*)(qs + ((tile + 3) & ~3));
  const long long row_bytes = (long long)d * sizeof(T);
  for (int c0 = 0; c0 < c; c0 += chunk) {
    const int nr = min(chunk, c - c0);
    long long rid = 0;  // lane r holds the id of row c0 + r
    if (lane < nr) {
      rid = ids ? (long long)ids[q * c + c0 + lane] : q * c + c0 + lane;
      rid = rid < 0 ? 0 : (rid >= n ? n - 1 : rid);
    }
    float acc = 0.0f;  // 0 + t0*t0 == t0*t0: the plain version's fold
    for (int d0 = 0; d0 < d; d0 += tile) {
      const int w = min(tile, d - d0);
      const int words = w * (int)sizeof(T) / VEC;  // VEC divides the row
      __syncwarp();  // the previous tile's reads are done
      for (int i = lane; i < w; i += 32) qs[i] = queries[q * d + d0 + i];
      for (int base = 0; base < nr * words; base += 32 * kBatch) {
        uint4 v[kBatch];
        int r[kBatch], j[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int i = base + b * 32 + lane;
          r[b] = i / words;
          j[b] = i - r[b] * words;
          const long long id = __shfl_sync(kFull, rid, r[b] & 31);
          if (i < nr * words)
            v[b] = load_word<VEC>(table + id * row_bytes
                                  + (long long)d0 * sizeof(T) + j[b] * VEC);
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          if (base + b * 32 + lane < nr * words)
            stage<VEC>(rows + r[b] * stride, j[b] * VEC, v[b]);
      }
      __syncwarp();
      if (lane < nr) {
        const uint32_t* row = rows + lane * stride;
        int i = 0;
        for (; i + kStep <= w; i += kStep) {  // every load, then the fold
          const uint32_t* part = row + i * (int)sizeof(T) / 4;
          float x[kStep], qv[kStep];
#pragma unroll
          for (int j = 0; j < kStep; j += 4) {
            const float4 v = *(const float4*)(qs + i + j);
            qv[j] = v.x; qv[j + 1] = v.y; qv[j + 2] = v.z; qv[j + 3] = v.w;
          }
#pragma unroll
          for (int j = 0; j < kStep; ++j) x[j] = elem<T>(part, j);
#pragma unroll
          for (int j = 0; j < kStep; ++j) {
            const float t = __fsub_rn(x[j], qv[j]);
            acc = __fadd_rn(acc, __fmul_rn(t, t));
          }
        }
        for (; i < w; ++i) {
          const float t = __fsub_rn(elem<T>(row, i), qs[i]);
          acc = __fadd_rn(acc, __fmul_rn(t, t));
        }
      }
    }
    if (lane < nr) out[q * c + c0 + lane] = acc;
  }
}

template <typename T, int VEC>
int launch_vec(const void* queries, const void* table, const void* ids,
               void* out, long long n, long long nq, long long c,
               long long d, cudaStream_t stream) {
  const int tile = (int)(d < kTileBytes / (long long)sizeof(T)
                         ? d : kTileBytes / sizeof(T));
  const int stride = ((tile * (int)sizeof(T) + 3) / 4) | 1;  // odd: no
  const int chunk = (int)(c < 32 ? c : 32);                  // conflicts
  // a warp's query tile (a multiple of 4 words) and its rows
  const int region = (((tile + 3) & ~3) + chunk * stride + 3) & ~3;
  const size_t smem = (size_t)kWarps * region * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rerank_l2_kernel<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((nq + kWarps - 1) / kWarps);
  rerank_l2_kernel<T, VEC><<<blocks, kWarps * 32, smem, stream>>>(
      (const float*)queries, (const uint8_t*)table, n, (const int32_t*)ids,
      (float*)out, nq, (int)c, (int)d, tile, stride, chunk, region);
  return (int)cudaGetLastError();
}

// The widest load every row tile allows: rows and tiles start at
// multiples of VEC bytes.
template <typename T>
int run(const void* queries, const void* table, const void* ids, void* out,
        long long n, long long nq, long long c, long long d, void* stream) {
  const long long row_bytes = d * (long long)sizeof(T);
  const uintptr_t at = (uintptr_t)table;
  cudaStream_t s = (cudaStream_t)stream;
  if (row_bytes % 16 == 0 && at % 16 == 0)
    return launch_vec<T, 16>(queries, table, ids, out, n, nq, c, d, s);
  if (row_bytes % 8 == 0 && at % 8 == 0)
    return launch_vec<T, 8>(queries, table, ids, out, n, nq, c, d, s);
  if (row_bytes % 4 == 0 && at % 4 == 0)
    return launch_vec<T, 4>(queries, table, ids, out, n, nq, c, d, s);
  return launch_vec<T, 1>(queries, table, ids, out, n, nq, c, d, s);
}

}  // namespace

// ids == nullptr: the table is [nq * c, d], row q * c + c' for (q, c').
extern "C" int rerank_l2_u8(const void* queries, const void* table,
                            const void* ids, void* out, long long n,
                            long long nq, long long c, long long d,
                            void* stream) {
  return run<uint8_t>(queries, table, ids, out, n, nq, c, d, stream);
}

extern "C" int rerank_l2_f32(const void* queries, const void* table,
                             const void* ids, void* out, long long n,
                             long long nq, long long c, long long d,
                             void* stream) {
  return run<float>(queries, table, ids, out, n, nq, c, d, stream);
}
