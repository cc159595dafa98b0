// rerank_rows.cuh: one warp's exact squared L2 distances from its query to
// up to 32 table rows read by id, shared by rerank_l2.cu (the op) and
// rerank_loop.cu (the re-rank's whole benefit-ratio loop).
//
//   d(q, x) = sum_d (float(x[d]) - q[d])^2, folded over d in order,
//   x = table[id] (uint8 or float32 rows of D elements; the id clipped by
//   the caller).
//
// The warp stages its query and its rows in shared memory, a tile of at
// most kTileBytes of each row at a time: the rows by id with coalesced
// loads (16 bytes a lane where the row width and the table's address
// allow it, else 8, 4 or 1; vec_width), the query as floats. Rows sit at
// an odd word stride, so when lane r then folds row r over d, the 32 lanes
// read 32 different banks. Each lane loads kStep elements of its row and
// of the query before it folds them, so the fold does not wait on each
// shared-memory load. The fold runs __fsub_rn/__fmul_rn/__fadd_rn over d
// in order, carried across tiles, so nvcc cannot contract it into FMAs and
// the result is bit-identical to the plain versions' left fold. Any D
// (tiles) and either dtype.
//
// A warp's staging region (Plan::region words, 16-byte aligned) holds the
// query tile (a multiple of 4 words) and then `chunk` rows.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace rows {

constexpr int kTileBytes = 512;    // bytes of a row staged at a time
constexpr int kBatch = 4;          // loads a lane issues before storing
constexpr int kStep = 32;          // elements a lane loads before folding
constexpr unsigned kFull = 0xffffffffu;

// A warp's staging layout for rows of d elements of T, up to `most` rows
// (at most 32) at a time.
struct Plan {
  int tile;    // elements of a row staged at a time
  int stride;  // words between staged rows (odd: no bank conflicts)
  int chunk;   // rows staged at a time
  int region;  // words of a warp's region
};

template <typename T>
inline Plan plan(long long d, long long most) {
  Plan p;
  p.tile = (int)(d < kTileBytes / (long long)sizeof(T)
                 ? d : kTileBytes / sizeof(T));
  p.stride = ((p.tile * (int)sizeof(T) + 3) / 4) | 1;
  p.chunk = (int)(most < 32 ? most : 32);
  p.region = (((p.tile + 3) & ~3) + p.chunk * p.stride + 3) & ~3;
  return p;
}

// The widest load every row tile allows: rows and tiles start at
// multiples of the width in bytes.
template <typename T>
inline int vec_width(long long d, const void* table) {
  const long long row_bytes = d * (long long)sizeof(T);
  const uintptr_t at = (uintptr_t)table;
  if (row_bytes % 16 == 0 && at % 16 == 0) return 16;
  if (row_bytes % 8 == 0 && at % 8 == 0) return 8;
  if (row_bytes % 4 == 0 && at % 4 == 0) return 4;
  return 1;
}

// Let `kernel` take `smem` bytes of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

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

// Called by the whole warp: lane r < nr (nr <= p.chunk) gets the squared
// L2 of `query` [d] (global) and the table row of its `rid` (already in
// [0, N)), folded over d in order; the other lanes get 0. `region` is the
// warp's staging region.
template <typename T, int VEC>
__device__ __forceinline__ float fold(const float* __restrict__ query,
                                      const uint8_t* __restrict__ table,
                                      long long rid, int nr, int d,
                                      const Plan& p, uint32_t* region) {
  const int lane = threadIdx.x & 31;
  float* qs = (float*)region;  // 16-byte aligned
  uint32_t* staged = region + ((p.tile + 3) & ~3);
  const long long row_bytes = (long long)d * sizeof(T);
  float acc = 0.0f;  // 0 + t0*t0 == t0*t0: the plain version's fold
  for (int d0 = 0; d0 < d; d0 += p.tile) {
    const int w = min(p.tile, d - d0);
    const int words = w * (int)sizeof(T) / VEC;  // VEC divides the row
    __syncwarp();  // the previous tile's (or call's) reads are done
    for (int i = lane; i < w; i += 32) qs[i] = query[d0 + i];
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
          stage<VEC>(staged + r[b] * p.stride, j[b] * VEC, v[b]);
    }
    __syncwarp();
    if (lane < nr) {
      const uint32_t* row = staged + lane * p.stride;
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
  return acc;
}

}  // namespace rows
