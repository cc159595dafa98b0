// ef_record_decode: Elias-Fano byte-record decode of the block index
// store (§3.3), the bulk read of a restore.
//
// Replaces no TPU kernel: the JAX package decodes one record at a time on
// the host (src/repro/core/codec/elias_fano.py::decode_record, numpy). The
// port decoded records with plain PyTorch (decode_records_torch), in passes
// of 32,768 records of ~30 int64 ops over tensors of hundreds of MB, with
// the host blocking on each pass's bitmap width; that decode took over 90%
// of a restored segment. This kernel decodes every record of a call in one
// launch; decode_records_torch stays as its plain version.
//
//   buf [nbytes] uint8 (the block image), rec_start [N] int64,
//   rec_len [N] int32, pos [B] int64
//   -> vals [B, r_max] int64, counts [B] int64
//   row b decodes the record at p = pos[b]: bytes rec_start[p] ..
//   + rec_len[p] of buf. Record: u8 n | u8 lw | low bytes (n * lw bits,
//   value i's low part at bit i * lw, LSB-first) | high bytes (bit
//   (v_i >> lw) + i set, LSB-first). vals[b, i] = ((p_i - i) << lw) |
//   low_i, p_i the position of set bit i, for i < n; -1 from n to r_max.
//   counts[b] = n. A position outside [0, N), or a record longer than
//   the stage (1,085 B; no store the index store seals writes one, and
//   its decode_batch refuses a store that could), gives count -1 and a
//   row of -1.
//
// Bound: bytes. At R = 128 a row reads ~342 B of record (the store's
// 0.662 of 516 B) and 20 B of position and record table and writes
// 1,024 B of int64 list and an 8 B count: ~1.39 KB a row, ~5.8 GB and
// ~1.75 ms at 3.35 TB/s for a 4,194,304-row segment. Design: one warp per
// record, 64 warps an SM (registers capped at 32), so that many records'
// loads are in flight. The warp reads its record's table entry, then the
// record with 4-byte loads, all in flight at once, into a per-warp shared
// buffer (a word the image holds only in part is read byte by byte, so
// nothing past its end is read). The high bitmap is scanned a byte a
// lane: a warp prefix sum of the bytes' popcounts gives each set bit its
// rank i, and the bit at p stores p - i at rank i in shared memory (eight
// unrolled bit tests, no loop that diverges). Then lane l writes ranks
// l, l + 32, ...: (high << lw) | its low part, one funnel shift of two
// buffered words, so each warp's 1 KB of output goes out in coalesced
// 256 B stores, and the -1 padding too (the wrapper allocates with
// torch.empty). The instructions a record takes, not its bytes' latency,
// set the pace once the card is full, so each step above is the one with
// the fewest.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kBatch = 4;          // words a lane has in flight per pass
constexpr int kMaxCount = 255;     // the record's u8 count
// Staged bytes a warp: a record the encoder writes at universe <= 2^32
// is at most 863 B (n = 255), plus 3 bytes of alignment; records up to
// 4 * kStageWords - 3 = 1,085 B are decoded.
constexpr int kStageWords = 272;
constexpr int kBlocksPerSM = 8;    // caps registers at 32 a thread
constexpr unsigned kFull = 0xffffffffu;

// Bits [r * lw, r * lw + lw) of the low part (record bytes from 2 on),
// from a staged record: its byte 0 at byte `shift` of the words `w`.
__device__ __forceinline__ unsigned low_staged(const uint32_t* w, int shift,
                                               int r, int lw) {
  if (lw == 0) return 0u;
  const int bit = 8 * (shift + 2) + r * lw;
  const unsigned v = __funnelshift_r(w[bit >> 5], w[(bit >> 5) + 1],
                                     bit & 31);
  return lw == 32 ? v : v & ((1u << lw) - 1u);
}

// One staged record of len bytes at rec (its byte 0 at byte `shift` of
// the words `w`) -> its row of r_max values and its count. `high` holds
// the high parts by rank.
__device__ __forceinline__ void decode_row(const uint8_t* rec,
                                           const uint32_t* w, int shift,
                                           int len, uint32_t* high,
                                           long long* out, long long* count,
                                           int r_max, int lane) {
  const int n = len > 0 ? rec[0] : 0;
  int lw = len > 1 ? rec[1] : 0;
  lw = lw > 32 ? 32 : lw;  // the encoder writes 0..32
  const int hb0 = 2 + ((n * lw + 7) >> 3);
  // the high bitmap, a byte a lane: a warp prefix sum of the bytes'
  // popcounts ranks each set bit; the bit at p stores p - rank
  int found = 0;  // ranks placed so far, the same in every lane
  for (int base = hb0; base < len && found < n; base += 32) {
    const int k = base + lane;
    const unsigned byte = k < len ? rec[k] : 0u;
    const int c = __popc(byte);
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    int rank = found + incl - c;
    const unsigned p0 = 8u * (unsigned)(k - hb0);
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
      if ((byte >> bit) & 1u) {
        if (rank < n) high[rank] = p0 + bit - (unsigned)rank;
        ++rank;
      }
    }
    found += __shfl_sync(kFull, incl, 31);
  }
  __syncwarp();
  // a rank the bitmap lacks (no record the encoder writes) has high part 0
  for (int r = lane; r < r_max; r += 32) {
    long long v = -1;
    if (r < n) {
      const unsigned lo = low_staged(w, shift, r, lw);
      v = ((long long)(r < found ? high[r] : 0u) << lw) | lo;
    }
    out[r] = v;
  }
  if (lane == 0) *count = n;
}

__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSM)
ef_record_decode_kernel(const uint8_t* __restrict__ buf, long long nbytes,
                        const long long* __restrict__ rec_start,
                        const int32_t* __restrict__ rec_len, long long n_rec,
                        const long long* __restrict__ pos,
                        long long* __restrict__ vals,
                        long long* __restrict__ counts, long long b,
                        int r_max) {
  // one word of slack: a low part's funnel shift reads the next word
  __shared__ uint32_t stage[kWarps][kStageWords + 1];
  __shared__ uint32_t high[kWarps][kMaxCount + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long s = (long long)blockIdx.x * kWarps + warp;
  if (s >= b) return;  // whole warp leaves together
  const long long p = pos[s];
  long long* out = vals + s * (long long)r_max;
  long long len64 = p >= 0 && p < n_rec ? rec_len[p] : -1;
  if (len64 < 0 || len64 > 4 * kStageWords - 3) {  // not decoded
    for (int r = lane; r < r_max; r += 32) out[r] = -1;
    if (lane == 0) counts[s] = -1;
    return;
  }
  const long long st = rec_start[p];
  // nothing outside the image is read: the record is cut at its end
  if (st < 0 || st >= nbytes) len64 = 0;
  else if (len64 > nbytes - st) len64 = nbytes - st;
  const int len = (int)len64;
  const uint8_t* rec = buf + (st < 0 ? 0 : st);
  const uintptr_t first = (uintptr_t)rec;
  const int shift = (int)(first & 3u);
  const int words = (shift + len + 3) >> 2;
  // the record's words, all loads in flight at once; a word the image
  // holds only in part (its first or last) is read byte by byte
  const uint32_t* w0 = (const uint32_t*)(first - shift);
  const uintptr_t lo = (uintptr_t)buf, hi = lo + (uintptr_t)nbytes;
  const bool whole = (uintptr_t)w0 >= lo && (uintptr_t)(w0 + words) <= hi;
  uint32_t* w = stage[warp];
  for (int i0 = 0; i0 <= words; i0 += 32 * kBatch) {
    uint32_t v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + 32 * j + lane;
      v[j] = 0u;
      if (i >= words) continue;
      if (whole) {
        v[j] = __ldg(w0 + i);
      } else {
        const uintptr_t g = (uintptr_t)(w0 + i);
        for (int k = 0; k < 4; ++k)
          if (g + k >= lo && g + k < hi)
            v[j] |= (uint32_t)__ldg((const uint8_t*)(g + k)) << (8 * k);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + 32 * j + lane;
      if (i <= words) w[i] = v[j];  // the slack word is 0
    }
  }
  __syncwarp();
  decode_row((const uint8_t*)w + shift, w, shift, len, high[warp], out,
             counts + s, r_max, lane);
}

}  // namespace

extern "C" int ef_record_decode(const void* buf, const void* rec_start,
                                const void* rec_len, const void* pos,
                                void* vals, void* counts, long long nbytes,
                                long long n_rec, long long b, long long r_max,
                                void* stream) {
  ef_record_decode_kernel<<<(unsigned)((b + kWarps - 1) / kWarps),
                            kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, nbytes, (const long long*)rec_start,
      (const int32_t*)rec_len, n_rec, (const long long*)pos,
      (long long*)vals, (long long*)counts, b, (int)r_max);
  return (int)cudaGetLastError();
}
