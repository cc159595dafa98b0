// huffman_decode: the vector store's load path on Hopper, one launch per
// segment: decode the canonical-Huffman records of the requested rows and
// XOR each row of a delta chunk with its chunk's base.
//
// Replaces the reference's host composition: numpy decode_at
// (src/repro/core/codec/huffman.py:205), then _undelta
// (src/repro/core/storage/vector_store.py:133), which XORs each chunk
// through byteplane_decode_pallas (src/repro/kernels/byteplane/
// byteplane.py:25).
//
//   payload [P] u8    the segment's block image
//   starts  [m] i64   byte offset of each requested record
//   tables  [T, kTableWords] u32   one canonical table, or T plane tables
//                     (byte j of a row codes with table j % T)
//   bases   [c, V] u8, base_of [m] i32 (-1 = no delta)
//   -> out  [m, V] u8 = decode_at(payload, starts, V, tables), then
//          out[i] ^= bases[base_of[i]] where base_of[i] >= 0
//
// Bound: bytes. The records are read once and the rows written once (a
// prop-like segment: ~472 MB in, 537 MB out). Each record is a serial
// chain of variable-length codes, so one thread decodes one record; what
// the design spends its effort on is feeding 32 independent bit streams
// per warp without stalling on their loads:
//
// - Rounds. A warp decodes its 32 rows in rounds of kRound symbols. Before
//   a round the warp copies each lane's window of the payload (16-byte
//   aligned, long enough for kRound codes of 16 bits) into shared memory
//   with coalesced 16-byte loads, turned into big-endian 32-bit words.
//   A lane's bit cursor is then two words in registers (a0:a1, o bits
//   consumed) and a 16-bit MSB-first peek is one funnel shift; a word
//   crossed is refilled from shared memory, not from device memory. (Lanes
//   cross words at different codes, so a per-lane refill from device
//   memory makes the warp wait on some lane's load at nearly every code.)
// - Lookup. A first-level table of 2^12 (symbol, length) entries per table
//   in shared memory resolves every code of at most 12 bits; a longer code
//   (each covers under 2^-12 of the code space) falls to a canonical
//   decode by per-length limits.
// - Output. Symbols are assembled into W-byte pieces in registers (W = 16
//   when V % 16 == 0, else the widest of 8/4/2/1 dividing V), XOR-ed with
//   the base's piece and staged in shared memory; after the round the warp
//   writes its rows' bytes with coalesced stores.
//
// A grid of as many blocks as fit on the card walks the rows, so each block
// stages the tables (8.4 KB a table) once.
//
// Exactness: the first-level entry of a code of length l <= 12 spans whole
// 16-peek runs, and the canonical limits are the reference LUT's own
// ranges, so every peek decodes to the reference LUT's (symbol, length),
// including the (0, 0) of a prefix no code has. Window bytes past the
// payload are read with each index clamped to the last byte, as
// decode_at_torch clamps its peeks: nothing is read outside the tensor,
// and every peek equals the plain version's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLen = 16;
constexpr int kLutBits = 12;
// Per-table layout in 32-bit words (the wrapper packs it the same way):
// 2^12 uint16 entries (symbol | length << 8, length 0 = not resolved
// here), 16 limits, 16 index bases, 256 symbols in canonical order.
constexpr int kLimitAt = (1 << kLutBits) / 2;
constexpr int kBaseAt = kLimitAt + kMaxLen;
constexpr int kSymsAt = kBaseAt + kMaxLen;
constexpr int kTableWords = kSymsAt + 256 / 4;
constexpr int kThreads = 256;

// A round: kRound codes read from a window that starts up to 127 bits
// before the cursor; the reader holds the word after the one it is in.
constexpr int kRound = 64;
constexpr int kWinWords = (127 + kMaxLen * kRound) / 32 + 2;
constexpr int kWinChunks = (kWinWords * 4 + 15) / 16;
constexpr int kWinStride = 4 * kWinChunks + 1;    // words; odd: fewer
                                                  // bank conflicts
constexpr int kOutStride = kRound / 4 + 4;        // words, 16-byte aligned
constexpr size_t kLaneBytes = 4 * (kWinStride + kOutStride);

// A code longer than kLutBits bits, or a prefix no code has (-> 0, 0):
// the shortest length l whose left-justified limit exceeds the peek.
__device__ __noinline__ uint32_t decode_long(const uint32_t* tw,
                                             uint32_t peek) {
  const int32_t* base = reinterpret_cast<const int32_t*>(tw + kBaseAt);
  const uint8_t* syms = reinterpret_cast<const uint8_t*>(tw + kSymsAt);
  for (int l = kLutBits + 1; l <= kMaxLen; ++l)
    if (peek < tw[kLimitAt + l - 1])
      return syms[base[l - 1] + (int)(peek >> (kMaxLen - l))] |
             ((uint32_t)l << 8);
  return 0;
}

// (symbol | length << 8) of the code at the top of the 32 bits f.
__device__ __forceinline__ uint32_t decode_sym(const uint32_t* tw,
                                               uint32_t f) {
  const uint32_t e =
      reinterpret_cast<const uint16_t*>(tw)[f >> (32 - kLutBits)];
  return (e >> 8) ? e : decode_long(tw, f >> (32 - kMaxLen));
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// The big-endian word of the 8 bytes at p (8-aligned) where some lie
// outside [lo, hi): bytes before lo read 0 (they precede every record and
// are skipped), bytes past the end repeat the last byte.
__device__ __noinline__ uint64_t edge_word(uintptr_t p, uintptr_t lo,
                                           uintptr_t hi) {
  uint64_t x = 0;
  for (int b = 0; b < 8; ++b) {
    const uintptr_t q = p + b;
    const uint64_t byte =
        q < lo ? 0 : __ldg(reinterpret_cast<const uint8_t*>(q < hi ? q
                                                                   : hi - 1));
    x = (x << 8) | byte;
  }
  return x;
}

// A lane's bit cursor over its window of big-endian words in shared memory.
struct WindowReader {
  const uint32_t* win;
  uint32_t a0, a1;     // win[k], win[k + 1]
  int k, o;            // o bits of a0 consumed, 0..31

  __device__ __forceinline__ void start(const uint32_t* w, int bits) {
    win = w;
    k = bits >> 5;
    o = bits & 31;
    a0 = win[k];
    a1 = win[k + 1];
  }
  // The next 32 bits; a code of <= 16 bits at o < 32 lies in a0:a1.
  __device__ __forceinline__ uint32_t peek() const {
    return __funnelshift_l(a1, a0, o);
  }
  __device__ __forceinline__ void skip(int len) {
    o += len;
    if (o >= 32) {
      o -= 32;
      ++k;
      a0 = a1;
      a1 = win[k + 1];
    }
  }
  __device__ __forceinline__ int consumed() const { return 32 * k + o; }
};

template <int W>
__device__ __forceinline__ void xor_base(uint32_t* acc, const uint8_t* b) {
  if constexpr (W == 16) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(b));
    acc[0] ^= x.x; acc[1] ^= x.y; acc[2] ^= x.z; acc[3] ^= x.w;
  } else if constexpr (W == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(b));
    acc[0] ^= x.x; acc[1] ^= x.y;
  } else if constexpr (W == 4) {
    acc[0] ^= __ldg(reinterpret_cast<const uint32_t*>(b));
  } else if constexpr (W == 2) {
    acc[0] ^= __ldg(reinterpret_cast<const uint16_t*>(b));
  } else {
    acc[0] ^= __ldg(b);
  }
}

template <int W>
__device__ __forceinline__ void load_piece(uint32_t* acc,
                                           const uint8_t* src) {
  if constexpr (W == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(src);
    acc[0] = x.x; acc[1] = x.y; acc[2] = x.z; acc[3] = x.w;
  } else if constexpr (W == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(src);
    acc[0] = x.x; acc[1] = x.y;
  } else if constexpr (W == 4) {
    acc[0] = *reinterpret_cast<const uint32_t*>(src);
  } else if constexpr (W == 2) {
    acc[0] = *reinterpret_cast<const uint16_t*>(src);
  } else {
    acc[0] = *src;
  }
}

template <int W>
__device__ __forceinline__ void store_piece(uint8_t* dst,
                                            const uint32_t* acc) {
  if constexpr (W == 16)
    *reinterpret_cast<uint4*>(dst) = make_uint4(acc[0], acc[1], acc[2],
                                                acc[3]);
  else if constexpr (W == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(acc[0], acc[1]);
  else if constexpr (W == 4)
    *reinterpret_cast<uint32_t*>(dst) = acc[0];
  else if constexpr (W == 2)
    *reinterpret_cast<uint16_t*>(dst) = (uint16_t)acc[0];
  else
    *dst = (uint8_t)acc[0];
}

// Copy each lane's window [first, first + 16 kWinChunks) of the payload
// into its row of `wins`, as big-endian words; the warp's lanes take
// consecutive 16-byte chunks, so the loads coalesce.
__device__ __forceinline__ void fill_windows(uint32_t* wins, uintptr_t first,
                                             uintptr_t lo, uintptr_t hi,
                                             int lane) {
  for (int i = lane; i < 32 * kWinChunks; i += 32) {
    const int w = i / kWinChunks, c = i - w * kWinChunks;
    const uintptr_t a =
        __shfl_sync(0xffffffffu, (unsigned long long)first, w) + 16 * c;
    uint32_t* d = wins + w * kWinStride + 4 * c;
    if (a >= lo && a + 16 <= hi) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(a));
      d[0] = bswap32(x.x);
      d[1] = bswap32(x.y);
      d[2] = bswap32(x.z);
      d[3] = bswap32(x.w);
    } else {
      const uint64_t e0 = edge_word(a, lo, hi), e1 = edge_word(a + 8, lo, hi);
      d[0] = (uint32_t)(e0 >> 32);
      d[1] = (uint32_t)e0;
      d[2] = (uint32_t)(e1 >> 32);
      d[3] = (uint32_t)e1;
    }
  }
}

template <int W, bool kPlanar>
__global__ void __launch_bounds__(kThreads)
    huffman_decode_kernel(const uint8_t* __restrict__ payload,
                          long long nbytes,
                          const long long* __restrict__ starts, long long m,
                          int v, const uint4* __restrict__ tables, int ntab,
                          const uint8_t* __restrict__ bases,
                          const int* __restrict__ base_of,
                          uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  for (int i = threadIdx.x; i < ntab * kTableWords / 4; i += blockDim.x)
    smem[i] = tables[i];
  __syncthreads();
  const uint32_t* tw = reinterpret_cast<const uint32_t*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  uint32_t* scratch =
      reinterpret_cast<uint32_t*>(smem + ntab * kTableWords / 4);
  uint32_t* wins = scratch + warp * 32 * kWinStride;
  uint8_t* outs = reinterpret_cast<uint8_t*>(
      scratch + nwarps * 32 * kWinStride + warp * 32 * kOutStride);
  const uintptr_t lo = reinterpret_cast<uintptr_t>(payload);
  const uintptr_t hi = lo + (uintptr_t)nbytes;
  const long long warps = (long long)gridDim.x * nwarps;
  for (long long r0 = ((long long)blockIdx.x * nwarps + warp) * 32; r0 < m;
       r0 += warps * 32) {
    const long long r = r0 + lane;
    const bool active = r < m;
    const int rows = m - r0 < 32 ? (int)(m - r0) : 32;
    uintptr_t pos = lo + (active ? (uintptr_t)starts[r] : 0);
    int bit = 0;                      // bits of the byte at pos consumed
    const int b = active ? base_of[r] : -1;
    const uint8_t* base = bases + (long long)(b < 0 ? 0 : b) * v;
    int t = 0;                        // the plane table of the next byte
    for (int j = 0; j < v; j += kRound) {
      const int n = v - j < kRound ? v - j : kRound;
      const uintptr_t first = pos & ~(uintptr_t)15;
      __syncwarp();
      fill_windows(wins, first, lo, hi, lane);
      __syncwarp();
      if (active) {
        WindowReader rd;
        rd.start(wins + lane * kWinStride, (int)(pos - first) * 8 + bit);
        for (int p = 0; p < n; p += W) {
          uint32_t acc[(W + 3) / 4];
#pragma unroll
          for (int q = 0; q < (W + 3) / 4; ++q) acc[q] = 0;
#pragma unroll
          for (int k = 0; k < W; ++k) {
            const uint32_t e = decode_sym(tw + t * kTableWords, rd.peek());
            acc[k / 4] |= (e & 0xFF) << (8 * (k % 4));
            rd.skip((int)(e >> 8));
            if (kPlanar) t = (t + 1 == ntab) ? 0 : t + 1;
          }
          if (b >= 0) xor_base<W>(acc, base + j + p);
          store_piece<W>(outs + lane * 4 * kOutStride + p, acc);
        }
        const int used = rd.consumed();
        pos = first + (used >> 3);
        bit = used & 7;
      }
      __syncwarp();
      const int per_row = n / W;      // the warp writes its rows' n bytes
      for (int i = lane; i < rows * per_row; i += 32) {
        const int w = i / per_row, c = i - w * per_row;
        uint32_t acc[(W + 3) / 4];
        load_piece<W>(acc, outs + w * 4 * kOutStride + c * W);
        store_piece<W>(out + (r0 + w) * v + j + c * W, acc);
      }
    }
  }
}

template <int W, bool kPlanar>
int launch(const void* payload, long long nbytes, const void* starts,
           long long m, int v, const void* tables, int ntab,
           const void* bases, const void* base_of, void* out,
           cudaStream_t stream) {
  auto kern = huffman_decode_kernel<W, kPlanar>;
  const size_t smem = (size_t)ntab * kTableWords * 4 + kThreads * kLaneBytes;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (m + kThreads - 1) / kThreads;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const uint8_t*)payload, nbytes, (const long long*)starts, m, v,
      (const uint4*)tables, ntab, (const uint8_t*)bases, (const int*)base_of,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}

template <int W>
int launch_w(bool planar, const void* payload, long long nbytes,
             const void* starts, long long m, int v, const void* tables,
             int ntab, const void* bases, const void* base_of, void* out,
             cudaStream_t s) {
  return planar ? launch<W, true>(payload, nbytes, starts, m, v, tables, ntab,
                                  bases, base_of, out, s)
                : launch<W, false>(payload, nbytes, starts, m, v, tables,
                                   ntab, bases, base_of, out, s);
}

}  // namespace

// The widest piece W in {16, 8, 4, 2, 1} that divides V and keeps every
// row's stores and base loads aligned.
extern "C" int huffman_decode(const void* payload, long long nbytes,
                              const void* starts, long long m, long long v,
                              const void* tables, long long ntab,
                              const void* bases, const void* base_of,
                              void* out, void* stream) {
  if (m == 0 || v == 0) return 0;
  const uintptr_t ptrs = (uintptr_t)bases | (uintptr_t)out;
  int w = 16;
  while (w > 1 && ((v % w) || (ptrs % w))) w /= 2;
  const bool planar = ntab > 1;
  cudaStream_t s = (cudaStream_t)stream;
  const int vi = (int)v, nt = (int)ntab;
  switch (w) {
    case 16: return launch_w<16>(planar, payload, nbytes, starts, m, vi,
                                 tables, nt, bases, base_of, out, s);
    case 8: return launch_w<8>(planar, payload, nbytes, starts, m, vi, tables,
                               nt, bases, base_of, out, s);
    case 4: return launch_w<4>(planar, payload, nbytes, starts, m, vi, tables,
                               nt, bases, base_of, out, s);
    case 2: return launch_w<2>(planar, payload, nbytes, starts, m, vi, tables,
                               nt, bases, base_of, out, s);
    default: return launch_w<1>(planar, payload, nbytes, starts, m, vi,
                                tables, nt, bases, base_of, out, s);
  }
}
