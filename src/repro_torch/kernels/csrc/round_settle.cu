// round_settle: the second half of a traversal round's bookkeeping (§3.4),
// everything after the fused hop, for every query row in one launch.
//
// Replaces no TPU kernel: it replaces the plain PyTorch ops that
// core/search/beam.py ran after the hop (~20 ops a round: the gather of
// the expansion flags through the hop's merge, the stability sort of the
// top K + B ids and its compare, the counter updates, the next round's
// frontier test and the any-active reduction, and the copies of the new
// state over the old), whose plain version is
// kernels/search_round/search_round.py::round_settle_ref.
//
//   top_ids, top_d, top_i [nq, L] (the hop's output), and in place:
//   cand_ids [nq, L] i32, cand_d [nq, L] f32, expanded [nq, L] u8,
//   iters, stab, pf_iter [nq] i32, prev_top [nq, KB] i32, active [nq] u8,
//   flag u8
//   The hop's list becomes the candidate list; expanded[j] becomes the
//   old flag of the entry the hop put at j (top_i[j] < L), false for a new
//   one; for an active row, with top = the first KB ids sorted ascending:
//   stab = stab + W where top == prev_top, else 0; pf_iter = iters + 1
//   the first time stab reaches B; iters + 1; prev_top = top. The row is
//   active for the next round where a valid id is not expanded and iters
//   < max_iters; an active row raises ``flag`` (round_expand clears it).
//
// Bound: bytes. At nq = 1,024, L = 200: the hop's three [nq, L] outputs
// read, the old flags read and the candidate state (L x 9 B) written, the
// KB ids and the counters read and written: ~4.7 MB, 1.4 us at 3.35 TB/s,
// so its launch is what it costs. Design: one
// block of 256 threads per row; the old flags and the KB ids in shared
// memory, the stability sort a bitonic sort of KB (20 at the serve
// shapes, padded to 32) keys, and the row's three tests block-wide
// barrier reductions.
#include <cuda_runtime.h>
#include <stdint.h>

#include "keys.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 1024;  // the round_expand kernel's limit too

__global__ void __launch_bounds__(kThreads)
round_settle_kernel(const int32_t* __restrict__ top_ids,
                    const float* __restrict__ top_d,
                    const int32_t* __restrict__ top_i,
                    int32_t* __restrict__ cand_ids,
                    float* __restrict__ cand_d,
                    uint8_t* __restrict__ expanded,
                    int32_t* __restrict__ iters, int32_t* __restrict__ stab,
                    int32_t* __restrict__ pf_iter,
                    int32_t* __restrict__ prev_top,
                    uint8_t* __restrict__ active, uint8_t* __restrict__ flag,
                    int l_size, int kb, int kbpad, int w, int rerank_batch,
                    int max_iters) {
  __shared__ uint8_t old[kMaxL];
  __shared__ int32_t top[kMaxL];
  const int tid = threadIdx.x;
  const long long q = blockIdx.x;
  const long long o = q * l_size;
  const bool was = active[q] != 0;  // read before thread 0 writes it
  for (int i = tid; i < l_size; i += kThreads) old[i] = expanded[o + i];
  for (int i = tid; i < kbpad; i += kThreads)
    top[i] = i < kb ? top_ids[o + i] : INT32_MAX;
  __syncthreads();
  int open = 0;  // a valid id not expanded
  for (int j = tid; j < l_size; j += kThreads) {
    const int t = top_i[o + j];
    const uint8_t e = t < l_size ? old[t] : 0;
    const int32_t id = top_ids[o + j];
    cand_ids[o + j] = id;
    cand_d[o + j] = top_d[o + j];
    expanded[o + j] = e;
    open |= id >= 0 && !e;
  }
  const bool any_open = __syncthreads_or(open);
  keys::bitonic_i32(top, kbpad);
  int differ = 0;
  const int32_t* prev = prev_top + q * kb;
  for (int i = tid; i < kb; i += kThreads) differ |= top[i] != prev[i];
  const bool same = !__syncthreads_or(differ);
  if (was)
    for (int i = tid; i < kb; i += kThreads) prev_top[q * kb + i] = top[i];
  if (tid == 0) {
    int it = iters[q], st = stab[q], pf = pf_iter[q];
    if (was) {
      st = same ? st + w : 0;
      if (st >= rerank_batch && pf < 0) pf = it + 1;
      it += 1;
    }
    stab[q] = st;
    pf_iter[q] = pf;
    iters[q] = it;
    const bool next = any_open && it < max_iters;
    active[q] = next;
    if (next) *flag = 1;  // cleared by round_expand before this round's hop
  }
}

}  // namespace

extern "C" int round_settle(const void* top_ids, const void* top_d,
                            const void* top_i, void* cand_ids, void* cand_d,
                            void* expanded, void* iters, void* stab,
                            void* pf_iter, void* prev_top, void* active,
                            void* flag, long long nq, long long l_size,
                            long long kb, long long w, long long rerank_batch,
                            long long max_iters, void* stream) {
  if (l_size < 1 || l_size > kMaxL || kb < 1 || kb > l_size)
    return (int)cudaErrorInvalidValue;
  int kbpad = 1;
  while (kbpad < kb) kbpad <<= 1;
  round_settle_kernel<<<(unsigned)nq, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)top_ids, (const float*)top_d, (const int32_t*)top_i,
      (int32_t*)cand_ids, (float*)cand_d, (uint8_t*)expanded,
      (int32_t*)iters, (int32_t*)stab, (int32_t*)pf_iter,
      (int32_t*)prev_top, (uint8_t*)active, (uint8_t*)flag, (int)l_size,
      (int)kb, kbpad, (int)w, (int)rerank_batch, (int)max_iters);
  return (int)cudaGetLastError();
}
