"""Fixed-width bit packing.

Host-side (numpy) encode and decode, copied from ``repro.core.codec.bitpack``,
plus a torch decode used on device tensors. Words are little-endian uint32;
bit ``i`` of the stream lives in word ``i // 32`` at in-word offset
``i % 32``. All decoders accept an arbitrary base bit offset so several
packed streams can share one word buffer (Elias-Fano slots do this).

Device tensors hold uint32 words as an int32 bit-view: PyTorch's CPU
kernels implement neither ``>>`` nor ``gather`` for ``torch.uint32``, so the
torch decoder widens the words to int64 and masks to 32 bits.
"""
from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32
MASK32 = 0xFFFFFFFF


def words_for_bits(nbits: int) -> int:
    return (int(nbits) + WORD_BITS - 1) // WORD_BITS


def pack_fixed(values: np.ndarray, width: int, *, out: np.ndarray | None = None,
               bit_offset: int = 0) -> np.ndarray:
    """Pack ``values`` (uint64-safe ints < 2**width) at ``width`` bits each.

    Returns a uint32 word array (newly allocated unless ``out`` is given).
    """
    values = np.asarray(values, dtype=np.uint64)
    n = values.shape[0]
    total_bits = bit_offset + n * width
    if out is None:
        out = np.zeros(words_for_bits(total_bits), dtype=np.uint32)
    if width == 0 or n == 0:
        return out
    if width > 33:  # value << (in-word offset <= 31) must fit in uint64 below
        raise ValueError(f"width {width} too large")
    start = bit_offset + np.arange(n, dtype=np.int64) * width
    word = start // WORD_BITS
    off = (start % WORD_BITS).astype(np.uint64)
    # A width<=57-bit value at in-word offset <32 spans at most 3 uint32 words.
    v = values << off
    for k, shift in enumerate((np.uint64(0), np.uint64(32), np.uint64(64))):
        part = ((v >> shift) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        idx = word + k
        live = part != 0
        if np.any(live):
            np.bitwise_or.at(out, idx[live], part[live])
    return out


def unpack_fixed_np(words: np.ndarray, n: int, width: int, *,
                    bit_offset: int = 0) -> np.ndarray:
    """numpy inverse of :func:`pack_fixed` -> uint64 array of length n."""
    if width == 0:
        return np.zeros(n, dtype=np.uint64)
    w64 = words.astype(np.uint64)
    start = bit_offset + np.arange(n, dtype=np.int64) * width
    word = start // WORD_BITS
    off = (start % WORD_BITS).astype(np.uint64)
    nw = len(w64)
    g0 = w64[word]
    g1 = np.where(word + 1 < nw, w64[np.minimum(word + 1, nw - 1)], 0)
    g2 = np.where(word + 2 < nw, w64[np.minimum(word + 2, nw - 1)], 0)
    val = (g0 >> off) | (g1 << (np.uint64(32) - off))  # shift 32 is valid on u64
    need_hi = (off.astype(np.int64) + width) > 64
    if np.any(need_hi):
        hi = g2 << (np.uint64(64) - off)  # off>0 whenever need_hi
        val = np.where(need_hi, val | hi, val)
    mask = (np.uint64(1) << np.uint64(width)) - np.uint64(1)
    return val & mask


def unpack_fixed_torch(words: torch.Tensor, n: int, width: int, *,
                       bit_offset: int = 0) -> torch.Tensor:
    """Torch decode of ``[..., nw]`` packed words (int32 bit-view or any
    integer dtype holding uint32 values) -> int64 ``[..., n]`` values in
    ``[0, 2**width)``. Requires ``width <= 32``. Mirrors
    ``unpack_fixed_jnp``: out-of-range word reads clamp to the last word
    (their bits are masked away)."""
    lead = words.shape[:-1]
    if width == 0:
        return torch.zeros(lead + (n,), dtype=torch.int64, device=words.device)
    if width > 32:
        raise ValueError("torch unpack supports width <= 32")
    nw = words.shape[-1]
    w = words.to(torch.int64) & MASK32
    start = bit_offset + torch.arange(n, dtype=torch.int64,
                                      device=words.device) * width
    word = start // WORD_BITS
    off = start % WORD_BITS
    g0 = w[..., word.clamp(0, nw - 1)]
    g1 = w[..., (word + 1).clamp(0, nw - 1)]
    lo = g0 >> off
    hi = torch.where(off > 0, (g1 << (WORD_BITS - off)) & MASK32, 0)
    return (lo | hi) & ((1 << width) - 1)


def as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> the int32 tensor with the same 32
    bits (how uint32 words travel on device)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
