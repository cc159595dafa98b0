"""Least bytes a kernel call must move, frozen.

Copied from ``chip_smoke.py``: ``HBM_BYTES_PER_S`` (line 202) and the
``beam_step``, ``ef_decode``, ``rerank_l2`` and ``huffman_decode`` arms of
``bounds()`` (lines 3470-3519), and the Elias-Fano slot width. The
originals read the counts off the call's tensors; these copies take the
counts, so the benchmark can sum them over a whole batch from
``SearchStats`` and shapes. Each input byte is counted read once and each
output byte written once.
"""
from __future__ import annotations

import math

#: H100 SXM data sheet: 3.35 TB/s of HBM3 at the 700 W power limit.
HBM_BYTES_PER_S = 3.35e12


def beam_step_bytes(valid: int, nq: int, m: int, k: int, l_size: int,
                    e: int, lut_rows: int | None = None) -> int:
    """One fused hop: the code rows of ``valid`` new ids, the LUTs of
    ``lut_rows`` queries (all ``nq`` in the original), the candidate list
    read (ids + distances), the ``[nq, e]`` new ids read, and the list
    written back (ids, distances, merge index)."""
    lut_rows = nq if lut_rows is None else lut_rows
    return (valid * m + lut_rows * m * k * 4 + nq * l_size * 8
            + nq * e * 4 + nq * l_size * 12)


def ef_decode_bytes(b: int, slot_words: int, r_max: int) -> int:
    """``b`` slots read by id, the ids read, lists and counts written."""
    return b * slot_words * 4 + b * 4 + b * (r_max + 1) * 4


def rerank_l2_bytes(nq: int, dim: int, rows: int, elt: int) -> int:
    """The queries, ``rows`` candidate rows read by id, distances out."""
    return nq * dim * 4 + rows * dim * elt + rows * 8


def huffman_decode_bytes(record_bytes: int, m: int, v: int,
                         base_bytes: int) -> int:
    """The records read, each record's start (8 B) and base index (4 B),
    the ``m`` rows of ``v`` bytes written, the chunk bases read."""
    return record_bytes + m * (8 + 4 + v) + base_bytes


def ef_slot_words(r: int, universe: int) -> int:
    """int32 words of one Elias-Fano slot of ``r`` ids below ``universe``:
    copied from ``src/repro_torch/core/codec/elias_fano.py``,
    ``low_bits_width`` (lines 36-43) and ``slot_layout`` (182-189), with
    ``words_for_bits`` (``bitpack.py``) as a ceiling over 32."""
    low = max(0, math.ceil(math.log2(max(1, universe) / r))) if r > 0 else 0
    low_words = -(-r * low // 32)
    high_words = -(-(r + ((universe - 1) >> low) + 1) // 32)
    return 1 + low_words + high_words
