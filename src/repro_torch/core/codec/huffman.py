"""Canonical Huffman coding over byte symbols (paper §3.2).

One frequency table per *segment* (paper §3.3: a single global table ignores
local statistics, per-chunk tables cost too much metadata). Encode/decode are
vectorised across records: every record advances one symbol per step in
lockstep, so a segment of ``n`` vectors of ``V`` bytes decodes in ``V``
steps instead of ``n*V`` python iterations. Records are byte-aligned so block
headers can address them with byte offsets (§3.3 block layout).

Code lengths are limited to MAX_LEN (16) — table-driven decode peeks MAX_LEN
bits and looks up (symbol, length) in a 64 Ki-entry LUT, mirroring the
FSE/fast-Huffman implementation the paper adopts [45].

Table construction and the numpy coder are copies of
``repro.core.codec.huffman`` (256 symbols: host work). The torch coder
(``record_bytes_torch``, ``encode_into_torch``, ``encode_records_torch``,
``decode_at_torch``) runs the same arithmetic on tensors where the data
lies, in int64 (PyTorch's CPU kernels lack uint32/uint64 shifts), and gives
the same bytes.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np
import torch

MAX_LEN = 16
NSYM = 256


def _huffman_lengths(freqs: np.ndarray) -> np.ndarray:
    """Code length per symbol from frequencies (0 for absent symbols)."""
    freqs = np.asarray(freqs, dtype=np.int64)
    present = np.flatnonzero(freqs)
    lengths = np.zeros(NSYM, dtype=np.int32)
    if len(present) == 0:
        return lengths
    if len(present) == 1:
        lengths[present[0]] = 1
        return lengths
    heap = [(int(freqs[s]), int(s), (int(s),)) for s in present]
    heapq.heapify(heap)
    counter = NSYM  # tiebreak id
    while len(heap) > 1:
        fa, _, sa = heapq.heappop(heap)
        fb, _, sb = heapq.heappop(heap)
        for s in sa + sb:
            lengths[s] += 1
        heapq.heappush(heap, (fa + fb, counter, sa + sb))
        counter += 1
    return lengths


def _limit_lengths(freqs: np.ndarray, max_len: int = MAX_LEN) -> np.ndarray:
    """Rebuild with flattened frequencies until max code length fits.

    Simple iterative damping (zlib-style heuristic): still a valid prefix
    code, with a negligible ratio loss on byte alphabets.
    """
    f = np.asarray(freqs, dtype=np.int64).copy()
    lengths = _huffman_lengths(f)
    while lengths.max(initial=0) > max_len:
        f = (f + 1) // 2
        f[np.asarray(freqs) > 0] = np.maximum(f[np.asarray(freqs) > 0], 1)
        lengths = _huffman_lengths(f)
    return lengths


@dataclass
class HuffmanTable:
    """Canonical code: codes assigned in (length, symbol) order."""
    lengths: np.ndarray          # [256] int32
    codes: np.ndarray            # [256] uint32 (MSB-first canonical code)
    decode_sym: np.ndarray       # [2**MAX_LEN] uint8
    decode_len: np.ndarray       # [2**MAX_LEN] uint8

    @property
    def size_bytes(self) -> int:
        # Persisted form is just the 256 code lengths (canonical reconstruction).
        return NSYM

    @classmethod
    def from_frequencies(cls, freqs: np.ndarray) -> "HuffmanTable":
        lengths = _limit_lengths(freqs)
        return cls.from_lengths(lengths)

    @classmethod
    def from_lengths(cls, lengths: np.ndarray) -> "HuffmanTable":
        lengths = np.asarray(lengths, dtype=np.int32)
        codes = np.zeros(NSYM, dtype=np.uint32)
        code = 0
        for ln in range(1, MAX_LEN + 1):
            for sym in np.flatnonzero(lengths == ln):
                codes[sym] = code
                code += 1
            code <<= 1
        # Decode LUT: index by the next MAX_LEN bits (MSB-first).
        decode_sym = np.zeros(1 << MAX_LEN, dtype=np.uint8)
        decode_len = np.zeros(1 << MAX_LEN, dtype=np.uint8)
        for sym in np.flatnonzero(lengths > 0):
            ln = int(lengths[sym])
            prefix = int(codes[sym]) << (MAX_LEN - ln)
            span = 1 << (MAX_LEN - ln)
            decode_sym[prefix:prefix + span] = sym
            decode_len[prefix:prefix + span] = ln
        return cls(lengths, codes, decode_sym, decode_len)

    @classmethod
    def from_data(cls, data: np.ndarray) -> "HuffmanTable":
        freqs = np.bincount(np.asarray(data, dtype=np.uint8).reshape(-1),
                            minlength=NSYM)
        return cls.from_frequencies(freqs)


@dataclass
class PlaneTables:
    """One canonical table per byte *plane* (byte position mod itemsize).

    Multi-byte elements (fp32/int16 vectors) have radically different
    per-plane distributions — exponent bytes nearly constant, low mantissa
    bytes near-uniform (paper Table 1's columnar concentration). A single
    unified stream pays the entropy of the *mixture*; XOR-delta only aligns
    each position's mode to zero (a per-position bijection cannot reshape a
    multi-modal position). P per-plane tables close that gap at P*256 B of
    segment metadata. Byte j of every record codes with table ``j % P``, so
    per-record random access is fully preserved."""
    tables: list                # [P] HuffmanTable

    @property
    def nplanes(self) -> int:
        return len(self.tables)

    @property
    def size_bytes(self) -> int:
        return NSYM * len(self.tables)

    @classmethod
    def from_data(cls, data: np.ndarray, nplanes: int) -> "PlaneTables":
        data = np.asarray(data, dtype=np.uint8)
        if data.ndim == 1:
            data = data[None, :]
        return cls([HuffmanTable.from_data(data[:, j::nplanes])
                    for j in range(nplanes)])

    def column_luts(self, v: int) -> tuple[np.ndarray, np.ndarray]:
        """(lengths, codes) per byte column -> [v, 256] each."""
        plane = np.arange(v) % self.nplanes
        lens = np.stack([t.lengths for t in self.tables])[plane]
        codes = np.stack([t.codes for t in self.tables])[plane]
        return lens, codes

    def table_for(self, j: int) -> HuffmanTable:
        return self.tables[j % self.nplanes]


def encode_records(data: np.ndarray, table: "HuffmanTable | PlaneTables"
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Encode rows of ``data`` [n, V] uint8 -> (payload bytes, byte offsets).

    Returns ``payload`` (concatenated byte-aligned records) and ``offsets``
    [n+1] int64 such that record i is ``payload[offsets[i]:offsets[i+1]]``.
    Bits are MSB-first within each byte. With :class:`PlaneTables`, byte
    column j codes with table ``j % P``.
    """
    data = np.asarray(data, dtype=np.uint8)
    n, v = data.shape
    if isinstance(table, PlaneTables):
        lut_len, lut_code = table.column_luts(v)         # [V, 256]
        cols = np.arange(v)[None, :]
        lens = lut_len[cols, data].astype(np.int64)      # [n, V]
        codes = lut_code[cols, data].astype(np.uint64)
    else:
        lens = table.lengths[data].astype(np.int64)      # [n, V]
        codes = table.codes[data].astype(np.uint64)
    row_bits = lens.sum(axis=1)
    row_bytes = (row_bits + 7) // 8
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(row_bytes, out=offsets[1:])
    payload = np.zeros(int(offsets[-1]), dtype=np.uint8)
    # Absolute bit position of each symbol (record start is byte aligned).
    bitpos = np.cumsum(lens, axis=1) - lens + (offsets[:n, None] * 8)
    end = bitpos + lens  # exclusive
    # Scatter symbol-by-symbol across all rows at once (V steps).
    payload64 = np.zeros((len(payload) + 8), dtype=np.uint8)  # slack for spill
    for j in range(v):
        bp, ln, cd = bitpos[:, j], lens[:, j], codes[:, j]
        byte = bp >> 3
        off = (bp & 7).astype(np.uint64)
        # Place code MSB-first starting at bit `off` of payload[byte]:
        # shift code into a 32-bit window aligned to the byte.
        shifted = cd << (np.uint64(32) - off - ln.astype(np.uint64))
        for k in range(4):  # max 16-bit code + 7-bit offset spans 3 bytes; 4 is safe
            part = ((shifted >> np.uint64(24 - 8 * k)) & np.uint64(0xFF)).astype(np.uint8)
            live = part != 0
            if np.any(live):
                np.bitwise_or.at(payload64, byte[live] + k, part[live])
    payload[:] = payload64[:len(payload)]
    del end
    return payload, offsets


def decode_records(payload: np.ndarray, offsets: np.ndarray, v: int,
                   table: HuffmanTable, select: np.ndarray | None = None
                   ) -> np.ndarray:
    """Decode records (all, or the subset ``select``) -> [m, V] uint8."""
    offsets = np.asarray(offsets, dtype=np.int64)
    starts = offsets[:-1] if select is None else offsets[:-1][select]
    return decode_at(payload, starts, v, table)


def decode_at(payload: np.ndarray, starts: np.ndarray, v: int,
              table: "HuffmanTable | PlaneTables") -> np.ndarray:
    """Decode records at absolute byte offsets ``starts`` -> [m, V] uint8.

    Lockstep vectorised decode: V steps, each peeking MAX_LEN bits per row
    via a 4-byte gather and the canonical LUT (column j's LUT under
    :class:`PlaneTables`).
    """
    payload = np.asarray(payload, dtype=np.uint8)
    starts = np.asarray(starts, dtype=np.int64)
    m = len(starts)
    out = np.zeros((m, v), dtype=np.uint8)
    buf = np.concatenate([payload, np.zeros(4, dtype=np.uint8)]).astype(np.uint32)
    bitpos = starts * 8
    planar = isinstance(table, PlaneTables)
    for j in range(v):
        tj = table.table_for(j) if planar else table
        byte = bitpos >> 3
        off = (bitpos & 7).astype(np.uint32)
        window = (buf[byte] << 24) | (buf[byte + 1] << 16) | (buf[byte + 2] << 8) | buf[byte + 3]
        peek = (window >> (np.uint32(32 - MAX_LEN) - off)) & np.uint32((1 << MAX_LEN) - 1)
        out[:, j] = tj.decode_sym[peek]
        bitpos = bitpos + tj.decode_len[peek]
    return out


def encoded_size_bits(data: np.ndarray,
                      table: "HuffmanTable | PlaneTables") -> int:
    data = np.asarray(data, np.uint8)
    if isinstance(table, PlaneTables):
        mat = data if data.ndim == 2 else data[None, :]
        lut_len, _ = table.column_luts(mat.shape[1])
        return int(lut_len[np.arange(mat.shape[1])[None, :], mat].sum())
    return int(table.lengths[data].sum())


# ------------------------------------------------------------------ torch
def _symbol_luts(table: "HuffmanTable | PlaneTables", v: int, device
                 ) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """(lengths, codes) as int64 tensors: [256] for one table, [V*256]
    (column-major by byte column) for plane tables; and whether planar."""
    if isinstance(table, PlaneTables):
        lens, codes = table.column_luts(v)
        planar = True
    else:
        lens, codes = table.lengths, table.codes
        planar = False
    as_t = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.int64).reshape(-1)).to(device)
    return as_t(lens), as_t(codes), planar


def _symbol_index(rows: torch.Tensor, planar: bool) -> torch.Tensor:
    idx = rows.to(torch.int64)
    if planar:
        idx = idx + (torch.arange(rows.shape[1], device=rows.device)
                     << 8)[None, :]
    return idx


def _row_batches(n: int, v: int, symbols: int = 1 << 22):
    step = max(1, symbols // max(1, v))
    for a in range(0, n, step):
        yield a, min(a + step, n)


def record_bytes_torch(data: torch.Tensor,
                       table: "HuffmanTable | PlaneTables") -> torch.Tensor:
    """Encoded bytes of each row of ``data`` [n, V] uint8 -> [n] int64
    (records are byte-aligned: ceil(bits / 8))."""
    n, v = data.shape
    lut_len, _, planar = _symbol_luts(table, v, data.device)
    out = torch.empty(n, dtype=torch.int64, device=data.device)
    for a, b in _row_batches(n, v):
        bits = lut_len[_symbol_index(data[a:b], planar)].sum(1)
        out[a:b] = (bits + 7) >> 3
    return out


def encode_into_torch(buf: torch.Tensor, starts: torch.Tensor,
                      data: torch.Tensor,
                      table: "HuffmanTable | PlaneTables") -> None:
    """Encode rows of ``data`` [n, V] uint8 and OR record i into the uint8
    tensor ``buf`` at byte offset ``starts[i]`` (MSB-first bits, as
    ``encode_records``). The bytes ``buf`` holds under the records must be
    zero; bytes around them (block headers) are kept.

    ``encode_records`` ORs each symbol's byte parts into the payload with
    ``np.bitwise_or.at``, which PyTorch lacks. Each symbol's bits occupy
    bit positions no other symbol touches, so adding the parts
    (``index_add_``) equals OR-ing them: no carry can arise. Parts are
    summed in an int32 scratch per row batch (a byte never exceeds 255)
    and OR-ed into ``buf`` once.
    """
    n, v = data.shape
    if n == 0:
        return
    dev = data.device
    lut_len, lut_code, planar = _symbol_luts(table, v, dev)
    shifts = torch.arange(24, -8, -8, device=dev)
    ks = torch.arange(4, device=dev)
    for a, b in _row_batches(n, v):
        sym = _symbol_index(data[a:b], planar)
        lens, codes = lut_len[sym], lut_code[sym]
        st = starts[a:b].to(torch.int64)
        lo = int(st.min())
        hi = int((st + ((lens.sum(1) + 7) >> 3)).max())
        bitpos = ((st - lo) << 3)[:, None] + torch.cumsum(lens, 1) - lens
        # the code placed MSB-first at bit (bitpos & 7) of a 32-bit window
        # aligned to byte (bitpos >> 3); a 16-bit code at offset <= 7
        # spans at most 3 bytes, so 4 parts are safe
        shifted = codes << (32 - (bitpos & 7) - lens)
        parts = (shifted[..., None] >> shifts) & 0xFF
        idx = (bitpos >> 3)[..., None] + ks
        acc = torch.zeros(hi - lo + 4, dtype=torch.int32, device=dev)
        acc.index_add_(0, idx.reshape(-1), parts.reshape(-1).to(torch.int32))
        buf[lo:hi] |= acc[:hi - lo].to(torch.uint8)


def encode_records_torch(data: torch.Tensor,
                         table: "HuffmanTable | PlaneTables"
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``encode_records`` on tensors: rows of ``data`` [n, V] uint8 ->
    (payload uint8, offsets [n+1] int64) on ``data.device``."""
    n = data.shape[0]
    nbytes = record_bytes_torch(data, table)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=data.device)
    torch.cumsum(nbytes, 0, out=offsets[1:])
    payload = torch.zeros(int(offsets[-1]), dtype=torch.uint8,
                          device=data.device)
    encode_into_torch(payload, offsets[:n], data, table)
    return payload, offsets


def decode_at_torch(payload: torch.Tensor, starts: torch.Tensor, v: int,
                    table: "HuffmanTable | PlaneTables") -> torch.Tensor:
    """``decode_at`` on tensors: records at byte offsets ``starts`` of the
    uint8 tensor ``payload`` -> [m, V] uint8, in V lockstep steps (each
    peeks MAX_LEN bits per row through a 4-byte gather).

    ``decode_at`` pads the payload with 4 zero bytes for the peeks that
    run past its end; here those reads are clamped to the last byte
    instead, which saves copying a segment's image. Either way the bytes
    read past a record only fill the peek's bits after the current code,
    and the canonical LUT maps every such suffix to the same (symbol,
    length)."""
    dev = payload.device
    m = starts.shape[0]
    out = torch.empty((m, v), dtype=torch.uint8, device=dev)
    if m == 0 or v == 0:
        return out
    last = payload.shape[0] - 1
    tables = table.tables if isinstance(table, PlaneTables) else [table]
    dsym = torch.from_numpy(np.stack([t.decode_sym for t in tables])).to(dev)
    dlen = torch.from_numpy(np.stack(
        [t.decode_len.astype(np.int64) for t in tables])).to(dev)
    weights = torch.tensor([24, 16, 8, 0], device=dev)
    ks = torch.arange(4, device=dev)
    bitpos = starts.to(torch.int64) << 3
    for j in range(v):
        t = j % len(tables)
        window = (payload[((bitpos >> 3)[:, None] + ks).clamp(max=last)]
                  .to(torch.int64) << weights).sum(1)
        peek = (window >> (32 - MAX_LEN - (bitpos & 7))) & ((1 << MAX_LEN) - 1)
        out[:, j] = dsym[t][peek]
        bitpos = bitpos + dlen[t][peek]
    return out
