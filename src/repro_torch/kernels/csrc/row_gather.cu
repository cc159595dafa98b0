// row_gather: rows of a table by id, the plainest hand-written gather.
//
//   table [N, row_bytes] bytes, ids [B] int32 -> out [B, row_bytes]
//   out[b] = table[min(max(ids[b], 0), N - 1)]
//
// No TPU kernel: a yardstick that no path calls. It measures what reading
// a hop's rows by id costs on this card (random rows of a table far
// larger than the L2), beside the torch index op table[ids] on the same
// rows: pq_codes[ids] are the rows beam_step reads, ef_slots[ids] those
// ef_decode reads. Bound: bytes. One thread per VEC-byte word of the
// output, VEC = 16 where the row width and both addresses allow it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void row_gather_kernel(const T* __restrict__ table,
                                  const int32_t* __restrict__ ids,
                                  T* __restrict__ out, long long n,
                                  long long b, long long words) {
  const long long total = b * words;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / words;
    long long id = ids[r];
    id = id < 0 ? 0 : (id >= n ? n - 1 : id);
    out[i] = __ldg(table + id * words + (i - r * words));
  }
}

template <typename T>
int go(const void* table, const void* ids, void* out, long long n,
       long long b, long long row_bytes, cudaStream_t stream) {
  const long long words = row_bytes / (long long)sizeof(T);
  const long long total = b * words;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 64) blocks = 132 * 64;
  row_gather_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      (const T*)table, (const int32_t*)ids, (T*)out, n, b, words);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int row_gather(const void* table, const void* ids, void* out,
                          long long n, long long b, long long row_bytes,
                          void* stream) {
  const uintptr_t a = (uintptr_t)table | (uintptr_t)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (row_bytes % 16 == 0 && a % 16 == 0)
    return go<uint4>(table, ids, out, n, b, row_bytes, s);
  if (row_bytes % 4 == 0 && a % 4 == 0)
    return go<uint32_t>(table, ids, out, n, b, row_bytes, s);
  return go<uint8_t>(table, ids, out, n, b, row_bytes, s);
}
