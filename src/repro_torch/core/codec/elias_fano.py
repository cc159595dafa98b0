"""Elias-Fano encoding of monotone integer sequences (paper §3.2): the
compact byte records of the block index store (§3.3) and the fixed-size
slots of the device-resident adjacency (§3.4).

Slot layout, uint32 words (identical to ``repro.core.codec.elias_fano``):

    word 0            : n (actual neighbor count, <= r_max)
    words [1 .. LW]   : packed low bits (r_max * l bits, fixed l from r_max/U)
    words [LW+1 .. ]  : high bitmap (2*r_max + 1 bits worst case)

A list is padded to r_max with ``universe - 1`` before encoding, so every
slot has the same shape and vertex id -> slot address is direct.

The numpy functions (``encode``/``decode``, the record format
``encode_record``/``decode_record`` with its per-record optimal low width,
``slot_layout``, ``encode_slot``, ``decode_slot_np``) are copies of the
reference. On tensors: ``encode_slots_torch`` (byte-identical to a loop of
``encode_slot``), ``decode_slots_torch`` (the plain PyTorch version of the
``ef_decode`` kernel, the reference's ``decode_slot_jnp`` batched), and the
batched record coder ``encode_records_torch`` / ``encode_records_into_torch``
/ ``decode_records_torch`` (byte-identical to a loop of ``encode_record``;
the decode is the plain version of the ``ef_record_decode`` kernel).
On device, slots are an int32 bit-view of the uint32 words.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ... import tracing
from .bitpack import (MASK32, WORD_BITS, as_int32_bits, pack_fixed,
                      unpack_fixed_np, unpack_fixed_torch, words_for_bits)


def low_bits_width(n: int, universe: int) -> int:
    """l = max(0, ceil(log2(U/n))).

    The ceil split keeps the high bitmap within ``2n + 1`` bits, matching the
    paper's worst-case form ``2R + R*ceil(log2(N/R))`` exactly (§3.3)."""
    if n <= 0:
        return 0
    return max(0, int(math.ceil(math.log2(max(1, universe) / n))))


def worst_case_bits(n: int, universe: int) -> int:
    """Paper bound: 2n + n*ceil(log2(U/n)) bits (§3.3)."""
    if n <= 0:
        return 0
    return 2 * n + n * int(math.ceil(math.log2(max(2, universe) / n)))


def worst_case_record_bytes(n: int, universe: int) -> int:
    """The §3.4 fixed-entry cache bound in bytes — the ONE definition of
    the EF entry sizing rule (index store, serving-tier modeled LRUs, and
    the codec registry all derive from here)."""
    return (worst_case_bits(n, universe) + 7) // 8


@dataclass(frozen=True)
class EFList:
    """A variable-size Elias-Fano encoded monotone list."""
    n: int
    universe: int
    low_width: int
    low_words: np.ndarray    # uint32
    high_words: np.ndarray   # uint32 unary bitmap, n + (max_high) + 1 bits

    @property
    def size_bits(self) -> int:
        return 32 * (len(self.low_words) + len(self.high_words))


def encode(values: np.ndarray, universe: int,
           low_width: int | None = None) -> EFList:
    """Encode; ``low_width`` overrides the canonical split (the record
    header stores the width per record, so any 0..32 split decodes)."""
    values = np.asarray(values, dtype=np.uint64)
    n = len(values)
    if n and (np.any(np.diff(values.astype(np.int64)) < 0)):
        raise ValueError("Elias-Fano requires a non-decreasing sequence")
    if n and int(values[-1]) >= universe:
        raise ValueError("value out of universe")
    l = low_bits_width(n, universe) if low_width is None else int(low_width)
    if not 0 <= l <= 32:
        raise ValueError(f"low_width {l} outside [0, 32]")
    low = values & np.uint64((1 << l) - 1) if l else np.zeros(n, np.uint64)
    high = (values >> np.uint64(l)).astype(np.int64)
    low_words = pack_fixed(low, l) if l else np.zeros(0, np.uint32)
    hb_bits = n + (int(high[-1]) if n else 0) + 1
    high_words = np.zeros(words_for_bits(hb_bits), dtype=np.uint32)
    if n:
        pos = high + np.arange(n, dtype=np.int64)
        np.bitwise_or.at(high_words, pos // WORD_BITS,
                         (np.uint32(1) << (pos % WORD_BITS).astype(np.uint32)))
    return EFList(n=n, universe=universe, low_width=l,
                  low_words=low_words, high_words=high_words)


def decode(ef: EFList) -> np.ndarray:
    if ef.n == 0:
        return np.zeros(0, dtype=np.uint64)
    bits = np.unpackbits(ef.high_words.view(np.uint8), bitorder="little")
    pos = np.flatnonzero(bits)[: ef.n].astype(np.int64)
    high = (pos - np.arange(ef.n)).astype(np.uint64)
    low = unpack_fixed_np(ef.low_words, ef.n, ef.low_width)
    return (high << np.uint64(ef.low_width)) | low


# ---------------------------------------------------------------------------
# Compact byte-record format (block-based on-disk index store, §3.3)
# ---------------------------------------------------------------------------
# Record: u8 count | u8 low_width | low bytes (ceil(count*lw/8)) | high bytes.
# Trailing zero bits of the high bitmap are trimmed (decode re-pads), so the
# record size tracks the true encoded size, not word-rounded slack. The
# low/high split is chosen PER RECORD: the header already carries the width,
# so instead of the canonical ``ceil(log2(U/n))`` (a universe-level rule that
# assumes uniform gaps) each record takes the width minimizing its own byte
# count. After a locality reorder the per-list spans collapse far below the
# universe, and the per-record optimum tracks the span — this is where the
# relabeling actually turns into adjacency-tier bytes.


def record_bytes_for_width(n: int, last: int, low_width: int) -> int:
    """Exact record size (header + low + high) for an n-list whose maximum
    value is ``last`` under a given split. The high bitmap needs exactly
    ``n + (last >> low_width)`` bits: the final set bit sits at position
    ``(n - 1) + (last >> low_width)``."""
    if n == 0:
        return 2
    return (2 + (n * low_width + 7) // 8
            + (n + (last >> low_width) + 7) // 8)


def optimal_low_width(n: int, last: int, universe: int) -> int:
    """Smallest-record split for one list (ties -> smaller width)."""
    hi = max(1, min(32, int(max(universe - 1, 1)).bit_length()))
    return min(range(hi + 1),
               key=lambda lw: (record_bytes_for_width(n, last, lw), lw))


def encode_record(values: np.ndarray, universe: int) -> np.ndarray:
    values = np.asarray(values, dtype=np.uint64)
    n = len(values)
    if n > 255:
        raise ValueError("record format supports <= 255 neighbors")
    if n == 0:
        return np.asarray([0, 0], dtype=np.uint8)
    last = int(values[-1])
    lw = optimal_low_width(n, last, universe)
    e = encode(values, universe, low_width=lw)
    low_bytes = e.low_words.view(np.uint8)[: (n * lw + 7) // 8]
    hb_bits = n + (last >> lw)
    high_bytes = e.high_words.view(np.uint8)[: (hb_bits + 7) // 8]
    return np.concatenate([
        np.asarray([n, lw], dtype=np.uint8), low_bytes, high_bytes])


def decode_record(rec: np.ndarray, universe: int) -> np.ndarray:
    rec = np.asarray(rec, dtype=np.uint8)
    n, lw = int(rec[0]), int(rec[1])
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    nlb = (n * lw + 7) // 8
    low_b = rec[2:2 + nlb]
    high_b = rec[2 + nlb:]
    def _pad_words(b):
        pad = (-len(b)) % 4
        if pad:
            b = np.concatenate([b, np.zeros(pad, np.uint8)])
        return b.copy().view(np.uint32)
    ef = EFList(n=n, universe=universe, low_width=lw,
                low_words=_pad_words(low_b), high_words=_pad_words(high_b))
    return decode(ef)


# ---------------------------------------------------------------------------
# Fixed-size slot format (device-resident graph / LRU cache entries)
# ---------------------------------------------------------------------------


def slot_layout(r_max: int, universe: int) -> tuple[int, int, int, int]:
    """Returns (low_width, low_words, high_words, slot_words)."""
    l = low_bits_width(r_max, universe)
    lw = words_for_bits(r_max * l)
    # high bitmap: r_max set bits, max high value (universe-1)>>l < 2*r_max + 1
    hb = words_for_bits(r_max + ((universe - 1) >> l) + 1)
    return l, lw, hb, 1 + lw + hb


def encode_slot(values: np.ndarray, r_max: int, universe: int) -> np.ndarray:
    """Encode an ascending list (len <= r_max) into a fixed-size uint32 slot.

    The list is padded to r_max with ``universe - 1`` sentinels so the slot
    shape is static — decode recovers the true length from word 0.
    """
    values = np.asarray(values, dtype=np.uint64)
    n = len(values)
    if n > r_max:
        raise ValueError(f"{n} > r_max {r_max}")
    l, lw, hb, total = slot_layout(r_max, universe)
    padded = np.concatenate([values,
                             np.full(r_max - n, universe - 1, dtype=np.uint64)])
    slot = np.zeros(total, dtype=np.uint32)
    slot[0] = n
    low = padded & np.uint64((1 << l) - 1) if l else np.zeros(r_max, np.uint64)
    if l:
        slot[1:1 + lw] = pack_fixed(low, l, out=np.zeros(lw, np.uint32))
    high = (padded >> np.uint64(l)).astype(np.int64)
    pos = high + np.arange(r_max, dtype=np.int64)
    hw = np.zeros(hb, dtype=np.uint32)
    np.bitwise_or.at(hw, pos // WORD_BITS,
                     (np.uint32(1) << (pos % WORD_BITS).astype(np.uint32)))
    slot[1 + lw:] = hw
    return slot


def decode_slot_np(slot: np.ndarray, r_max: int, universe: int) -> np.ndarray:
    l, lw, hb, _ = slot_layout(r_max, universe)
    n = int(slot[0])
    bits = np.unpackbits(slot[1 + lw:].view(np.uint8), bitorder="little")
    pos = np.flatnonzero(bits)[:r_max].astype(np.int64)
    high = (pos - np.arange(r_max)).astype(np.uint64)
    low = unpack_fixed_np(slot[1:1 + lw], r_max, l)
    return ((high << np.uint64(l)) | low)[:n]


def encode_slots_torch(nbrs: torch.Tensor, counts: torch.Tensor, r_max: int,
                       universe: int, chunk: int = 1 << 18) -> torch.Tensor:
    """Batched slot encoder: padded neighbours ``[n, R]`` (entries past
    ``counts[i]`` are ignored) + ``counts [n]`` -> int32 slots
    ``[n, slot_words]`` on ``nbrs.device``.

    Each list is sorted ascending first, as ``ef_slots_from_graph`` does,
    so the result equals ``encode_slot(np.sort(adj), r_max, universe)``
    row for row. The low parts are OR-ed into their words with
    ``scatter_add_`` (the bits never overlap, so add is OR) and the high
    bits likewise (positions ``high[j] + j`` are distinct).
    """
    n, width = nbrs.shape
    if width > r_max:
        raise ValueError(f"neighbour width {width} > r_max {r_max}")
    l, lw, hb, total = slot_layout(r_max, universe)
    dev = nbrs.device
    out = torch.empty((n, total), dtype=torch.int32, device=dev)
    j = torch.arange(r_max, dtype=torch.int64, device=dev)
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        cnt = counts[a:b].to(torch.int64)
        if bool(((cnt < 0) | (cnt > r_max)).any()):
            raise ValueError(f"counts must lie in [0, {r_max}]")
        valid = j[None, :] < cnt[:, None]
        v = torch.full((b - a, r_max), universe, dtype=torch.int64, device=dev)
        v[:, :width] = nbrs[a:b]
        v = torch.where(valid, v, universe).sort(dim=1).values
        if bool(((v < 0) | ((v >= universe) & valid)).any()):
            raise ValueError(f"neighbour ids must lie in [0, {universe})")
        v = torch.where(valid, v, universe - 1)
        slots = torch.zeros((b - a, total + 1), dtype=torch.int64, device=dev)
        slots[:, 0] = cnt
        if l:
            start = j * l
            word = (1 + start // WORD_BITS).expand(b - a, -1)
            shifted = (v & ((1 << l) - 1)) << (start % WORD_BITS)
            slots.scatter_add_(1, word, shifted & MASK32)
            slots.scatter_add_(1, word + 1, shifted >> WORD_BITS)
        pos = (v >> l) + j
        slots.scatter_add_(1, 1 + lw + pos // WORD_BITS,
                           torch.ones_like(pos) << (pos % WORD_BITS))
        out[a:b] = as_int32_bits(slots[:, :total])
    return out


def decode_slots_torch(slots: torch.Tensor, r_max: int, universe: int):
    """Plain PyTorch EF slot decode: ``[B, W]`` int32 slots ->
    ``(neighbors [B, r_max] int32, counts [B] int32)``.

    Padding entries decode to ``universe - 1`` (callers mask with counts).
    Select-in-bitmap: the position of the (i+1)-th set bit is the first
    index where the running popcount reaches i+1 (``searchsorted`` on the
    cumulative sum); a rank the bitmap does not hold decodes from position
    0, as ``decode_slot_jnp``'s argmax does.
    """
    l, lw, hb, total = slot_layout(r_max, universe)
    if slots.shape[-1] != total:
        raise ValueError(f"slot width {slots.shape[-1]} != {total}")
    dev = slots.device
    low = unpack_fixed_torch(slots[:, 1:1 + lw], r_max, l)
    hw = slots[:, 1 + lw:].to(torch.int64) & MASK32
    bitidx = torch.arange(hb * WORD_BITS, dtype=torch.int64, device=dev)
    bits = (hw[:, bitidx // WORD_BITS] >> (bitidx % WORD_BITS)) & 1
    csum = bits.cumsum(1).contiguous()
    j = torch.arange(r_max, dtype=torch.int64, device=dev)
    want = (j + 1).expand(slots.shape[0], -1).contiguous()
    pos = torch.searchsorted(csum, want)
    pos = torch.where(pos < csum.shape[1], pos, 0)
    vals = (((pos - j) << l) | low) & MASK32
    return as_int32_bits(vals), slots[:, 0].contiguous()


# ---------------------------------------------------------------------------
# Byte records on tensors (the block index store's encoder and decoder)
# ---------------------------------------------------------------------------

def sort_lists_torch(nbrs: torch.Tensor, counts: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Padded lists ``[B, W]`` (entries past ``counts[i]`` ignored; without
    counts, negative entries are padding) -> (each list sorted ascending in
    int64, padding moved past the end, counts int64)."""
    v = nbrs.to(torch.int64)
    j = torch.arange(v.shape[1], device=v.device)
    if counts is None:
        valid = v >= 0
        counts = valid.sum(1)
    else:
        counts = counts.to(device=v.device, dtype=torch.int64)
        valid = j[None, :] < counts[:, None]
    big = torch.iinfo(torch.int64).max
    return torch.where(valid, v, big).sort(dim=1).values, counts


def record_layout_torch(values: torch.Tensor, counts: torch.Tensor,
                        universe: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per sorted list: (``optimal_low_width``, the record's byte length)
    -> two int64 tensors [B]. Ties go to the smaller width, as in
    ``optimal_low_width``; an empty list is the 2-byte header."""
    n = counts.to(torch.int64)
    last = values.gather(1, (n - 1).clamp(min=0)[:, None])[:, 0]
    last = torch.where(n > 0, last, 0)
    hi = max(1, min(32, int(max(universe - 1, 1)).bit_length()))
    lws = torch.arange(hi + 1, device=values.device)
    size = (2 + (n[:, None] * lws + 7) // 8
            + (n[:, None] + (last[:, None] >> lws) + 7) // 8)
    lw = torch.argmin(size * 64 + lws, dim=1)
    nbytes = torch.where(n > 0, size.gather(1, lw[:, None])[:, 0], 2)
    return torch.where(n > 0, lw, 0), nbytes


def encode_records_into_torch(buf: torch.Tensor, starts: torch.Tensor,
                              values: torch.Tensor, counts: torch.Tensor,
                              universe: int, batch: int = 1 << 16) -> None:
    """Write the ``encode_record`` bytes of every sorted list (``values``
    [B, W] from :func:`sort_lists_torch`, ``counts`` [B]) into the uint8
    tensor ``buf`` at byte offsets ``starts``, OR-ed over what ``buf``
    holds there (zero under the records; block headers around them stay).

    Each low part and each high-bitmap bit lands on bit positions no other
    part of the record touches, so ``index_add_`` of the parts into an
    int32 scratch equals the OR of ``np.bitwise_or.at`` in ``encode``.
    """
    if counts.numel() and int(counts.max()) > 255:
        raise ValueError("record format supports <= 255 neighbors")
    dev = values.device
    b_all, w = values.shape
    j = torch.arange(w, device=dev)
    ks = torch.arange(5, device=dev)
    for a in range(0, b_all, batch):
        b = min(a + batch, b_all)
        n = counts[a:b].to(torch.int64)
        v = values[a:b]
        valid = j[None, :] < n[:, None]
        if bool((valid & ((v < 0) | (v >= universe))).any()):
            raise ValueError("value out of universe")
        v = torch.where(valid, v, 0)
        lw, nbytes = record_layout_torch(v, n, universe)
        st = starts[a:b].to(torch.int64)
        lo = int(st.min())
        hi = int((st + nbytes).max())
        local = st - lo
        acc = torch.zeros(hi - lo + 8, dtype=torch.int32, device=dev)
        acc.index_add_(0, local, n.to(torch.int32))
        acc.index_add_(0, local + 1, lw.to(torch.int32))
        # low parts: value i's low bits at stream bit i*lw, LSB-first; a
        # <= 32-bit value at an in-byte offset <= 7 spans at most 5 bytes
        bstart = j[None, :] * lw[:, None]
        shifted = (v & ((1 << lw) - 1)[:, None]) << (bstart & 7)
        parts = torch.where(valid[..., None],
                            (shifted[..., None] >> (8 * ks)) & 0xFF, 0)
        idx = torch.where(valid, local[:, None] + 2 + (bstart >> 3),
                          local[:, None])[..., None] + ks
        acc.index_add_(0, idx.reshape(-1), parts.reshape(-1).to(torch.int32))
        # high bitmap: bit (v >> lw) + i set, after the low bytes
        pos = (v >> lw[:, None]) + j
        nlb = (n * lw + 7) >> 3
        hidx = local[:, None] + 2 + nlb[:, None] + (pos >> 3)
        bit = torch.where(valid, torch.ones_like(pos) << (pos & 7), 0)
        acc.index_add_(0, torch.where(valid, hidx, local[:, None]).reshape(-1),
                       bit.reshape(-1).to(torch.int32))
        buf[lo:hi] |= acc[:hi - lo].to(torch.uint8)


def encode_records_torch(values: torch.Tensor, counts: torch.Tensor,
                         universe: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched ``encode_record``: sorted lists -> (payload uint8, offsets
    [B+1] int64) on ``values.device``; record i equals
    ``encode_record(list_i, universe)`` byte for byte."""
    _, nbytes = record_layout_torch(values, counts, universe)
    offsets = torch.zeros(values.shape[0] + 1, dtype=torch.int64,
                          device=values.device)
    torch.cumsum(nbytes, 0, out=offsets[1:])
    payload = torch.zeros(int(offsets[-1]), dtype=torch.uint8,
                          device=values.device)
    if values.shape[0]:
        encode_records_into_torch(payload, offsets[:-1], values, counts,
                                  universe)
    return payload, offsets


def decode_records_torch(buf: torch.Tensor, starts: torch.Tensor,
                         lengths: torch.Tensor, r_max: int | None = None,
                         batch: int = 1 << 15
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched ``decode_record``: the records at byte offsets ``starts``
    (``lengths`` bytes each) of the uint8 tensor ``buf`` -> (values
    [B, r_max] int64, padded with -1 past each count; counts [B] int64).

    Select-in-bitmap as in ``decode_slots_torch``: the i-th value's high
    part is the position of the (i+1)-th set bit minus i, found by a
    search in the running popcount. Reads past a record only touch bits
    above the ones it needs, so the gathers are clamped to the buffer
    instead of padding it.
    """
    dev = buf.device
    starts = starts.to(torch.int64)
    lengths = lengths.to(torch.int64)
    last_byte = buf.shape[0] - 1
    n_all = buf[starts].to(torch.int64)
    if r_max is None and n_all.numel():
        with tracing.span("ef.sync"):
            r_max = int(n_all.max())
    r_max = r_max or 0
    out = torch.full((starts.shape[0], r_max), -1, dtype=torch.int64,
                     device=dev)
    j = torch.arange(r_max, device=dev)
    ks = torch.arange(5, device=dev)
    bit8 = torch.arange(8, device=dev)
    for a in range(0, starts.shape[0], batch):
        b = min(a + batch, starts.shape[0])
        st, n = starts[a:b], n_all[a:b]
        lw = buf[st + 1].to(torch.int64)
        bstart = j[None, :] * lw[:, None]
        idx = (st[:, None] + 2 + (bstart >> 3))[..., None] + ks
        window = (buf[idx.clamp(max=last_byte)].to(torch.int64)
                  << (8 * ks)).sum(-1)
        low = (window >> (bstart & 7)) & ((1 << lw) - 1)[:, None]
        nlb = (n * lw + 7) >> 3
        nhb = lengths[a:b] - 2 - nlb
        with tracing.span("ef.sync"):
            width = int(nhb.max())
        k = torch.arange(width, device=dev)
        hb = buf[((st + 2 + nlb)[:, None] + k).clamp(max=last_byte)] \
            .to(torch.int64)
        hb = torch.where(k[None, :] < nhb[:, None], hb, 0)
        bits = ((hb[..., None] >> bit8) & 1).reshape(b - a, -1)
        csum = bits.cumsum(1).contiguous()
        pos = torch.searchsorted(csum, (j + 1).expand(b - a, -1).contiguous())
        vals = ((pos - j) << lw[:, None]) | low
        out[a:b] = torch.where(j[None, :] < n[:, None], vals, -1)
    return out, n_all
