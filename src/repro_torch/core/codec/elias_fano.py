"""Elias-Fano fixed-size slots (paper §3.2-§3.4): the device-resident
compressed adjacency.

Slot layout, uint32 words (identical to ``repro.core.codec.elias_fano``):

    word 0            : n (actual neighbor count, <= r_max)
    words [1 .. LW]   : packed low bits (r_max * l bits, fixed l from r_max/U)
    words [LW+1 .. ]  : high bitmap (2*r_max + 1 bits worst case)

A list is padded to r_max with ``universe - 1`` before encoding, so every
slot has the same shape and vertex id -> slot address is direct.

``slot_layout``, ``encode_slot`` and ``decode_slot_np`` are numpy copies of
the reference. ``encode_slots_torch`` is the same encoder written for
tensors: a whole padded adjacency in, slots out, on any device, in row
chunks — byte-identical to a loop of ``encode_slot``. ``decode_slots_torch``
is the plain PyTorch version of the ``ef_decode`` kernel (the reference's
``decode_slot_jnp``, batched). On device, slots are an int32 bit-view of
the uint32 words.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .bitpack import (MASK32, WORD_BITS, as_int32_bits, pack_fixed,
                      unpack_fixed_np, unpack_fixed_torch, words_for_bits)


def low_bits_width(n: int, universe: int) -> int:
    """l = max(0, ceil(log2(U/n))).

    The ceil split keeps the high bitmap within ``2n + 1`` bits, matching the
    paper's worst-case form ``2R + R*ceil(log2(N/R))`` exactly (§3.3)."""
    if n <= 0:
        return 0
    return max(0, int(math.ceil(math.log2(max(1, universe) / n))))


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
