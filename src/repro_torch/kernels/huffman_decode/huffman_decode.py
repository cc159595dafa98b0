"""Huffman record decode + XOR-delta inverse: the vector store's load path
in one op.

    payload [P] uint8, starts [m] int64, v, table (a ``HuffmanTable``, or
    ``PlaneTables``: byte j of a row codes with table j % T), bases [c, V]
    uint8, base_of [m] int32 (-1 = no delta)
    -> [m, V] uint8: row i is the record at byte ``starts[i]`` of
       ``payload`` decoded, XOR ``bases[base_of[i]]`` where ``base_of[i] >= 0``

``huffman_decode_cuda`` launches ``csrc/huffman_decode.cu`` once: the
kernel that takes the place of the reference's host ``decode_at``
(``repro/core/codec/huffman.py``) followed by ``_undelta``
(``repro/core/storage/vector_store.py``), which XORs each chunk through
``byteplane_decode_pallas``. ``huffman_decode_ref`` is its plain version:
``huffman.decode_at_torch``, then the XOR of each row that has a base.
Both are exact, so they agree bit for bit.
"""
import numpy as np
import torch

from ... import tracing
from ...core.codec.huffman import MAX_LEN, PlaneTables, decode_at_torch
from ..build import check_cuda, launch

#: Peek bits the kernel's first-level table resolves; longer codes take
#: the canonical decode by per-length limits.
LUT_BITS = 12
# Per-table layout in 32-bit words, as csrc/huffman_decode.cu reads it:
# 2^LUT_BITS uint16 entries (symbol | length << 8; 0 = not resolved
# there), the left-justified limit and the symbol-index base of each code
# length 1..16, then the 256 symbols in canonical (length, symbol) order.
_LIMIT_AT = (1 << LUT_BITS) // 2
_BASE_AT = _LIMIT_AT + MAX_LEN
_SYMS_AT = _BASE_AT + MAX_LEN
TABLE_WORDS = _SYMS_AT + 256 // 4


def decoder_words(table) -> np.ndarray:
    """The kernel's decode tables of a ``HuffmanTable`` or ``PlaneTables``
    -> [T, TABLE_WORDS] int32.

    A code of length l <= LUT_BITS fills whole runs of 2^(16 - LUT_BITS)
    peeks of the table's 2^16-entry LUT, so the first-level entry of peek
    p is the LUT's entry at p's run; the limits are the LUT's ranges of
    each length, so the two decodes agree on every peek."""
    tables = table.tables if isinstance(table, PlaneTables) else [table]
    out = np.zeros((len(tables), TABLE_WORDS), np.int32)
    step = 1 << (MAX_LEN - LUT_BITS)
    lens_1_16 = np.arange(1, MAX_LEN + 1)
    for row, t in zip(out, tables):
        sym = t.decode_sym[::step].astype(np.uint16)
        ln = t.decode_len[::step].astype(np.uint16)
        short = (ln > 0) & (ln <= LUT_BITS)
        row[:_LIMIT_AT] = np.where(short, sym | (ln << 8), 0).astype(
            np.uint16).view(np.int32)
        lengths = np.asarray(t.lengths, np.int64)
        count = np.bincount(lengths, minlength=MAX_LEN + 1)[1:MAX_LEN + 1]
        first = np.zeros(MAX_LEN, np.int64)      # first code of each length
        code = 0
        for i in range(MAX_LEN):
            first[i] = code
            code = (code + count[i]) << 1
        row[_LIMIT_AT:_BASE_AT] = (first + count) << (MAX_LEN - lens_1_16)
        row[_BASE_AT:_SYMS_AT] = np.cumsum(count) - count - first
        order = np.lexsort((np.arange(len(lengths)), lengths))
        syms = np.zeros(256, np.uint8)
        canon = order[lengths[order] > 0]
        syms[:len(canon)] = canon
        row[_SYMS_AT:] = syms.view(np.int32)
    return out


def huffman_decode_ref(payload: torch.Tensor, starts: torch.Tensor, v: int,
                       table, bases: torch.Tensor,
                       base_of: torch.Tensor) -> torch.Tensor:
    out = decode_at_torch(payload, starts, v, table)
    if bases.shape[0]:
        out ^= torch.where((base_of >= 0)[:, None],
                           bases[base_of.clamp(min=0).long()], 0)
    return out


def huffman_decode_cuda(payload: torch.Tensor, starts: torch.Tensor, v: int,
                        table, bases: torch.Tensor,
                        base_of: torch.Tensor) -> torch.Tensor:
    m = starts.shape[0]
    if payload.dtype != torch.uint8 or payload.dim() != 1:
        raise TypeError("huffman_decode takes a 1-D uint8 payload")
    if starts.dtype != torch.int64 or starts.dim() != 1:
        raise TypeError("huffman_decode takes int64 record starts [m]")
    if bases.dtype != torch.uint8 or bases.dim() != 2 or \
            bases.shape[1] != v:
        raise ValueError(f"bases {tuple(bases.shape)} are not [c, {v}] "
                         f"uint8")
    if base_of.dtype != torch.int32 or base_of.shape != (m,):
        raise ValueError(f"base_of must be int32 [{m}]")
    dev = check_cuda(payload, starts, bases, base_of)
    out = torch.empty((m, v), dtype=torch.uint8, device=dev)
    if not m or not v:
        return out
    if not payload.numel():
        raise ValueError("huffman_decode: records in an empty payload")
    with tracing.span("vstore.sync"):
        past = bool((base_of >= bases.shape[0]).any())
    if past:
        raise ValueError("huffman_decode: base_of names a base past bases")
    words = torch.from_numpy(decoder_words(table))
    with tracing.span("vstore.sync"):      # a pageable copy drains the stream
        words = words.to(dev)
    launch("huffman_decode", "huffman_decode", payload, payload.numel(),
           starts, m, v, words, words.shape[0], bases, base_of, out)
    return out
