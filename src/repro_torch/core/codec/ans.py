"""rANS entropy coding of sorted-id gap streams (Severo et al., *Lossless
Compression of Vector IDs for ANN Search*).

A sorted neighbor list becomes a gap stream (first value, then successive
differences). Each gap is coded as a *bit-length symbol* (0..33) through a
range-variant ANS coder plus ``bit_length - 1`` raw extra bits (the leading
bit of a gap is implicit in its bit length). After locality reordering the
bit-length distribution concentrates on a few small symbols, so the entropy
coder spends ~2-3 bits/id where byte-aligned varints are stuck at 8.

The records must be self-describing without shipping a frequency table: the
symbol model is a *parametric* two-sided geometric centered on a 1-byte
``hint`` (the rounded mean bit length), quantized deterministically to a
12-bit total, so encoder and decoder rebuild the identical table from the
header alone.

Record framing is tuned for R-length adjacency lists, where every header
byte is ~0.3 bits/id: renormalization is BYTE-granular (state stays under
2^24 and ships as u24, with no half-word flush waste), the header is 6
bytes (``u16 n | u8 hint | u24 state``), the FIRST id ships as a plain
LEB128 varint (it is an absolute position, not a locality gap — keeping it
out of the symbol stream stops one far-from-hint outlier from skewing the
model every record), and the extra-bits stream is laid down REVERSED at
the record tail. The rANS byte stream (read forward past the varint) and
the bit stream (read backward from the end) each consume exactly what
their encoder produced, so no words/bits boundary field is needed — the
record length itself, which the block layout already tracks, frames both.

Pure numpy/python — records are R-length adjacency lists, not bulk streams.

A copy of ``repro.core.codec.ans`` (host numpy).
"""
from __future__ import annotations

import functools

import numpy as np

SCALE_BITS = 12
SCALE = 1 << SCALE_BITS
NSYM = 34                    # bit-length symbols 0..33 (u32 gaps need <= 32)
RANS_L = 1 << 16             # renorm lower bound; byte renorm -> state < 2^24
HEADER_BYTES = 6             # u16 n | u8 hint | u24 state
_LAMBDA = 0.7                # geometric decay of the parametric symbol model


@functools.lru_cache(maxsize=NSYM)
def _model(hint: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(freq[NSYM], cum[NSYM+1], symbol_of_slot[SCALE]) for one hint.

    Deterministic integer quantization: floor-scale to ``SCALE - NSYM`` with
    a +1 floor per symbol (every symbol stays codable), then the remainder
    goes to the most probable symbol. Encoder and decoder call this with the
    same header hint, so the tables always agree.
    """
    w = np.exp(-_LAMBDA * np.abs(np.arange(NSYM) - int(hint)))
    freq = (np.floor(w / w.sum() * (SCALE - NSYM)).astype(np.int64) + 1)
    freq[int(np.argmax(freq))] += SCALE - int(freq.sum())
    cum = np.concatenate([[0], np.cumsum(freq)]).astype(np.int64)
    sym_of = np.repeat(np.arange(NSYM, dtype=np.int64), freq)
    return freq, cum, sym_of


class _BitWriter:
    """LSB-first raw bit sink for the extra-bits stream."""

    def __init__(self):
        self._acc = 0
        self._n = 0
        self._out: list[int] = []

    def write(self, value: int, nbits: int) -> None:
        if nbits <= 0:
            return
        self._acc |= (int(value) & ((1 << nbits) - 1)) << self._n
        self._n += nbits
        while self._n >= 8:
            self._out.append(self._acc & 0xFF)
            self._acc >>= 8
            self._n -= 8

    def getvalue(self) -> np.ndarray:
        out = list(self._out)
        if self._n:
            out.append(self._acc & 0xFF)
        return np.asarray(out, np.uint8)


class _TailBitReader:
    """Reads the LSB-first bit stream laid down reversed at the record tail:
    byte ``k`` of the writer's output is ``buf[-1 - k]``."""

    def __init__(self, buf: np.ndarray):
        self._buf = np.asarray(buf, np.uint8)
        self._pos = len(self._buf) - 1
        self._acc = 0
        self._n = 0

    def read(self, nbits: int) -> int:
        if nbits <= 0:
            return 0
        while self._n < nbits:
            self._acc |= int(self._buf[self._pos]) << self._n
            self._pos -= 1
            self._n += 8
        value = self._acc & ((1 << nbits) - 1)
        self._acc >>= nbits
        self._n -= nbits
        return value


def _rans_encode(symbols: np.ndarray, hint: int) -> tuple[np.ndarray, int]:
    """-> (u8 byte stream in DECODE order, final 24-bit state). Symbols are
    consumed in reverse (rANS is LIFO) so the decoder emits them forward."""
    freq, cum, _ = _model(hint)
    x = RANS_L
    out: list[int] = []
    for s in symbols[::-1]:
        f = int(freq[s])
        x_max = ((RANS_L >> SCALE_BITS) << 8) * f
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        x = ((x // f) << SCALE_BITS) + (x % f) + int(cum[s])
    return np.asarray(out[::-1], np.uint8), x


def _rans_decode(stream: np.ndarray, state: int, n: int,
                 hint: int) -> np.ndarray:
    freq, cum, sym_of = _model(hint)
    x = int(state)
    pos = 0
    out = np.empty(n, np.int64)
    for i in range(n):
        slot = x & (SCALE - 1)
        s = int(sym_of[slot])
        out[i] = s
        x = int(freq[s]) * (x >> SCALE_BITS) + slot - int(cum[s])
        while x < RANS_L and pos < len(stream):
            x = (x << 8) | int(stream[pos])
            pos += 1
    return out


def encode_gaps(values: np.ndarray) -> np.ndarray:
    """Sorted (nondecreasing) uint64 ids -> self-describing uint8 record.

    Raises ``ValueError`` on decreasing input (the codec contract mirrors
    Elias-Fano: callers sort, estimators sort for them) and on gaps wider
    than the symbol alphabet (planner candidates for such universes drop
    out instead of corrupting records).
    """
    v = np.asarray(values, np.uint64)
    if len(v) > 0xFFFF:
        raise ValueError(f"record too large for the u16 record header: "
                         f"{len(v)} > 65535")
    if len(v) > 1 and bool(np.any(v[1:] < v[:-1])):
        raise ValueError("ans_id requires nondecreasing ids")
    gaps = np.diff(v).astype(object).tolist() if len(v) else []
    symbols = np.asarray([int(g).bit_length() for g in gaps], np.int64)
    if len(symbols) and int(symbols.max()) >= NSYM:
        raise ValueError(f"ans_id gap needs {int(symbols.max())} bits "
                         f"(>= {NSYM}-symbol alphabet)")
    hint = int(np.clip(np.round(symbols.mean()), 0, NSYM - 1)) \
        if len(symbols) else 0
    first: list[int] = []
    if len(v):                          # absolute first id, LEB128
        g = int(v[0])
        while True:
            first.append((g & 0x7F) | (0x80 if g > 0x7F else 0))
            g >>= 7
            if not g:
                break
    stream, state = _rans_encode(symbols, hint) if len(symbols) \
        else (np.zeros(0, np.uint8), RANS_L)
    bw = _BitWriter()
    for g, s in zip(gaps, symbols):
        if s >= 1:                      # leading bit implicit in the symbol
            bw.write(int(g) - (1 << (s - 1)), s - 1)
    extra = bw.getvalue()
    hdr = np.zeros(HEADER_BYTES, np.uint8)
    hdr[0:2] = np.frombuffer(np.uint16(len(v)).tobytes(), np.uint8)
    hdr[2] = hint
    hdr[3:6] = np.frombuffer(np.uint32(state).tobytes(), np.uint8)[:3]
    return np.concatenate([hdr, np.asarray(first, np.uint8), stream,
                           extra[::-1]])


def decode_gaps(payload: np.ndarray) -> np.ndarray:
    payload = np.asarray(payload, np.uint8)
    n = int(payload[0:2].copy().view(np.uint16)[0])
    if n == 0:
        return np.zeros(0, np.uint64)
    hint = int(payload[2])
    state = (int(payload[3]) | (int(payload[4]) << 8)
             | (int(payload[5]) << 16))
    pos = HEADER_BYTES
    acc, shift = 0, 0                   # LEB128 absolute first id
    while True:
        b = int(payload[pos])
        pos += 1
        acc |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    # Forward rANS stream and backward tail bit stream share the body; each
    # consumes exactly what its encoder produced, so no boundary is stored.
    body = payload[pos:]
    symbols = _rans_decode(body, state, n - 1, hint)
    br = _TailBitReader(body)
    out = np.empty(n, np.uint64)
    out[0] = acc
    for i, s in enumerate(symbols):
        s = int(s)
        gap = 0 if s == 0 else (1 << (s - 1)) + br.read(s - 1)
        acc += gap
        out[i + 1] = acc
    return out


def record_bound(r: int, universe: int) -> int:
    """Worst-case record bytes for an R-list (§3.4 fixed-entry LRU sizing):
    LEB128 first id + every gap symbol at the model floor (12 bits) + full
    extra bits at the universe's width + renormalization slack."""
    max_bits = max(1, int(max(universe, 2) - 1).bit_length())
    return (HEADER_BYTES + 2
            + (max_bits + 6) // 7
            + (r * SCALE_BITS + 7) // 8
            + (r * max(0, max_bits - 1) + 7) // 8)
