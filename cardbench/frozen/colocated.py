"""The co-located layout's bytes, frozen.

Copied from ``src/repro_torch/core/storage/colocated.py``:
``ColocatedStore.record_bytes`` (lines 66-69), ``records_per_block``
(71-73), ``blocks_per_record`` (75-77), ``n_blocks`` (79-83) and
``physical_bytes`` (85-87). A DiskANN-style record holds the vector and
its list (count + R ids), page-aligned in 4 KiB blocks.
"""
from __future__ import annotations

BLOCK_SIZE = 4096


def record_bytes(dim: int, elt: int, r: int) -> int:
    return dim * elt + 4 * (r + 1)


def colocated_bytes(n: int, dim: int, elt: int, r: int) -> int:
    """Bytes of ``n`` co-located records of ``dim`` elements of ``elt``
    bytes and R = ``r``: ceil(n / floor(4096 / record)) blocks of 4 KiB
    (a record wider than a block spans whole blocks)."""
    rec = record_bytes(dim, elt, r)
    if rec > BLOCK_SIZE:
        n_blocks = n * -(-rec // BLOCK_SIZE)
    else:
        n_blocks = -(-n // max(1, BLOCK_SIZE // rec))
    return n_blocks * BLOCK_SIZE
