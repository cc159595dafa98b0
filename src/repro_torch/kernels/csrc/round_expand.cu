// round_expand: the first half of a traversal round's bookkeeping (§3.4),
// everything before the fused hop, for every query row in one launch.
//
// Replaces no TPU kernel: it replaces the plain PyTorch ops that
// core/search/beam.py ran before the hop (~25 ops a round: the frontier
// sort, its gathers and scatters, the Elias-Fano decode launch, the dedupe
// sort, the hash probe, the last-write-wins sort and scatter), whose plain
// version is kernels/search_round/search_round.py::round_expand_ref.
//
//   cand_ids [nq, L] i32, cand_d [nq, L] f32, expanded [nq, L] u8 (in
//   place), active [nq] u8, ef_slots [N, words] u32, visited [nq, H + 1]
//   i32 (in place), fetched, pq_ct [nq] i32 (added to), flag u8
//   -> new_ids [nq, W * r_max] i32
//   For an active row: the W smallest candidates by (distance, slot) among
//   the valid, unexpanded ones with a distance below +inf (ties to the
//   lower slot; -0 ties +0), those with a finite distance selected (their
//   slots marked expanded, counted into fetched); their lists decoded
//   (entries past a list's count and unselected lists are -1); the W *
//   r_max ids sorted ascending, a repeat of its predecessor -1; an id is
//   new where visited[h(id)] != id, h the uint32 product 2654435761 * id
//   shifted down to the table's bits; among new ids that share a slot the
//   one in the highest column (the largest id) is written there; new_ids
//   holds the new ids in their sorted columns, -1 elsewhere, and pq_ct
//   counts them. A frozen row writes -1s only. Block 0 clears ``flag``
//   here, before round_settle raises it, so the flag the host reads after
//   a round says whether any row is active for the next one.
//
// Bound: bytes. A row reads its candidate state (L x 9 B), the W EF slots
// it selects (4 x 324 B at R = 128 over a 31.25M-vector shard), one
// 32-byte sector of its hash table for each distinct id (~290 at the serve
// shapes) and writes a sector for each new id (the clear and the id land in
// the same sector) and new_ids (2 KB): ~21 MB a round at nq = 1,024, W = 4,
// R = 128, L = 200, hash bits 15 with 860 rows active, 6.3 us at 3.35 TB/s;
// less as rows finish. Design: one block of 256 threads per row, everything
// between the reads and the writes in registers or shared memory:
// - the W selections are W block-wide minimum reductions of each thread's
//   candidate keys (keys.cuh's sort_key, the fused hop's), one barrier
//   each; the thread that holds the chosen slot marks it and records its
//   id, so no thread waits on a load inside the loop;
// - a warp a list decodes the EF slots (ef_rows.cuh, the ef_decode
//   kernel's code) into shared memory;
// - the W * r_max ids (512 at the serve shapes) are bitonic-sorted in
//   shared memory, the stages inside a warp's 64 entries behind warp
//   barriers only (keys.cuh);
// - the probes of a row's table go out together, and last-write-wins
//   needs no sort: the new ids ascend with their column, so a clear of
//   the contested slots and an atomicMax leaves the highest column's id in
//   each;
// - thread 0 reads the row's counters at the start and writes them once.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ef_rows.cuh"
#include "keys.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 1024;   // candidate slots a row (4 keys a thread)
constexpr int kMaxE = 1024;   // W * r_max ids a row (4 a thread)
constexpr int kMaxW = 32;     // lists a round
constexpr int kMaxSlot = 2048;  // EF slot words + high words a warp stages
constexpr int kPerL = kMaxL / kThreads;
constexpr int kPerE = kMaxE / kThreads;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kMinusInf = 0x007fffffu;  // sort_key's high word of -inf

struct Shape {
  long long n_slots;
  int words, r_max, l, lw, hb;   // the EF slot layout
  int l_size, w, e, epad, bits;
};

__global__ void __launch_bounds__(kThreads)
round_expand_kernel(const uint32_t* __restrict__ slots,
                    const int32_t* __restrict__ cand_ids,
                    const float* __restrict__ cand_d,
                    uint8_t* __restrict__ expanded,
                    const uint8_t* __restrict__ active,
                    int32_t* __restrict__ visited,
                    int32_t* __restrict__ fetched,
                    int32_t* __restrict__ pq_ct, uint8_t* __restrict__ flag,
                    int32_t* __restrict__ new_ids, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* wmin = (unsigned long long*)smem;  // [w][kWarps]
  int32_t* ids = (int32_t*)(wmin + s.w * kWarps);         // [epad]
  int32_t* sel = ids + s.epad;                            // [w]
  uint32_t* efbuf = (uint32_t*)(sel + s.w);  // [kWarps][words + hb]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q = blockIdx.x;
  // The flag is cleared here and raised by round_settle (see the top).
  if (q == 0 && tid == 0) *flag = 0;
  int32_t* out = new_ids + q * s.e;
  if (!active[q]) {
    for (int i = tid; i < s.e; i += kThreads) out[i] = -1;
    return;
  }

  // The frontier: W block-wide minima of the candidates' keys.
  const int32_t* ci = cand_ids + q * s.l_size;
  const float* cd = cand_d + q * s.l_size;
  uint8_t* ex = expanded + q * s.l_size;
  int fetched_q = 0, pq_ct_q = 0;  // thread 0's, written back at the end
  if (tid == 0) {
    fetched_q = fetched[q];
    pq_ct_q = pq_ct[q];
  }
  unsigned long long key[kPerL];
  int32_t id[kPerL];
#pragma unroll
  for (int j = 0; j < kPerL; ++j) {
    const int i = tid + j * kThreads;
    key[j] = ~0ull;
    id[j] = i < s.l_size ? ci[i] : -1;
    if (id[j] >= 0 && !ex[i]) {
      const float d = cd[i];
      if (d < INFINITY) key[j] = keys::sort_key(d, (unsigned)i);
    }
  }
  int nsel = 0;  // the same in every thread
  for (int p = 0; p < s.w; ++p) {
    unsigned long long m = key[0];
#pragma unroll
    for (int j = 1; j < kPerL; ++j) m = key[j] < m ? key[j] : m;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const unsigned long long y = __shfl_xor_sync(kFull, m, o);
      m = y < m ? y : m;
    }
    if (lane == 0) wmin[p * kWarps + warp] = m;
    __syncthreads();
    unsigned long long best = wmin[p * kWarps];
    for (int i = 1; i < kWarps; ++i) {
      const unsigned long long y = wmin[p * kWarps + i];
      best = y < best ? y : best;
    }
    if (best == ~0ull) break;  // fewer than W candidates below +inf
    const bool finite = (unsigned)(best >> 32) != kMinusInf;
#pragma unroll
    for (int j = 0; j < kPerL; ++j)
      if (key[j] == best) {  // the slot's own thread marks and records it
        key[j] = ~0ull;
        if (finite) {
          ex[tid + j * kThreads] = 1;
          sel[nsel] = id[j];
        }
      }
    nsel += finite;
  }
  if (nsel == 0) {
    for (int i = tid; i < s.e; i += kThreads) out[i] = -1;
    return;
  }
  __syncthreads();  // sel[]

  // The selected lists, a warp each; the rest of the run -1, the
  // power-of-two padding past it above every id.
  uint32_t* buf = efbuf + warp * (s.words + s.hb);
  for (int j = warp; j < nsel; j += kWarps) {
    long long row = sel[j];
    row = row < 0 ? 0 : (row >= s.n_slots ? s.n_slots - 1 : row);
    const unsigned running = ef::stage(slots + row * s.words, s.words, s.lw,
                                       s.hb, buf, buf + s.words, lane);
    const int count = (int)buf[0];
    for (int r = lane; r < s.r_max; r += 32)
      ids[j * s.r_max + r] = r < count
          ? ef::value(buf, buf + s.words, running, r, s.l, s.lw, s.hb) : -1;
    __syncwarp();  // the buffer is staged again for the warp's next list
  }
  for (int i = nsel * s.r_max + tid; i < s.epad; i += kThreads)
    ids[i] = i < s.e ? -1 : INT32_MAX;
  __syncthreads();
  keys::bitonic_i32(ids, s.epad);

  // First occurrences, the probes, then last write wins.
  const long long stride = (1ll << s.bits) + 1;
  int32_t* vis = visited + q * stride;
  const int shift = 32 - s.bits;
  int32_t u[kPerE];
  unsigned h[kPerE];
  bool ok[kPerE];
  int news = 0;
  const int groups = (s.e + kThreads - 1) / kThreads;  // the same in all
#pragma unroll
  for (int j = 0; j < kPerE; ++j) {
    const int i = tid + j * kThreads;
    u[j] = -1;
    h[j] = 0;
    ok[j] = false;
    if (j >= groups) continue;
    if (i < s.e) {
      const int32_t v = ids[i];
      if (v >= 0 && (i == 0 || v != ids[i - 1])) {
        u[j] = v;
        h[j] = ((unsigned)v * 2654435761u) >> shift;
        ok[j] = vis[h[j]] != v;
      }
    }
    news += __syncthreads_count(ok[j]);  // every probe reads before a write
  }
#pragma unroll
  for (int j = 0; j < kPerE; ++j)
    if (ok[j]) vis[h[j]] = -1;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPerE; ++j) {
    const int i = tid + j * kThreads;
    if (ok[j]) atomicMax(vis + h[j], u[j]);
    if (i < s.e) out[i] = ok[j] ? u[j] : -1;
  }
  if (tid == 0) {
    fetched[q] = fetched_q + nsel;
    pq_ct[q] = pq_ct_q + news;
  }
}

}  // namespace

// The shapes the kernel takes: 1 or 0.
extern "C" long long round_expand_fits(long long l_size, long long w,
                                       long long r_max, long long words,
                                       long long hb, long long bits) {
  return l_size >= 1 && l_size <= kMaxL && w >= 1 && w <= kMaxW
         && r_max >= 1 && w * r_max <= kMaxE && words + hb <= kMaxSlot
         && bits >= 1 && bits <= 30;
}

extern "C" int round_expand(const void* slots, const void* cand_ids,
                            const void* cand_d, void* expanded,
                            const void* active, void* visited, void* fetched,
                            void* pq_ct, void* flag, void* new_ids,
                            long long n_slots, long long words,
                            long long r_max, long long l, long long lw,
                            long long hb, long long nq, long long l_size,
                            long long w, long long bits, void* stream) {
  if (!round_expand_fits(l_size, w, r_max, words, hb, bits) || n_slots < 1)
    return (int)cudaErrorInvalidValue;
  Shape s{n_slots, (int)words, (int)r_max, (int)l, (int)lw, (int)hb,
          (int)l_size, (int)w, (int)(w * r_max), 1, (int)bits};
  while (s.epad < s.e) s.epad <<= 1;
  const size_t smem = (size_t)w * kWarps * sizeof(unsigned long long)
      + (size_t)(s.epad + w) * sizeof(int32_t)
      + (size_t)kWarps * (words + hb) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        round_expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  round_expand_kernel<<<(unsigned)nq, kThreads, smem,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)slots, (const int32_t*)cand_ids,
      (const float*)cand_d, (uint8_t*)expanded, (const uint8_t*)active,
      (int32_t*)visited, (int32_t*)fetched, (int32_t*)pq_ct, (uint8_t*)flag,
      (int32_t*)new_ids, s);
  return (int)cudaGetLastError();
}
