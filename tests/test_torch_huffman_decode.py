"""Port parity tier for ``huffman_decode``, the vector store's load of one
segment in one op: the plain PyTorch version (``decode_at_torch`` + the
per-row XOR) against the JAX package's numpy ``decode_at`` followed by
``xor_delta.apply_delta`` on the same seeded records, one table and plane
tables, over the repo's row widths and the load's hazards; and the decode
tables the CUDA kernel reads against the canonical LUT they replace. The
kernel against its plain version on the card is in
tests/test_torch_cuda.py, which holds the case maker.

Bytes must be identical; there is no tolerance in this file.
"""
import numpy as np
import pytest
import torch

from repro.core.codec import huffman as jhuff
from repro.core.codec import xor_delta as jxd

from repro_torch.core.codec import huffman
from repro_torch.kernels import dispatch
from repro_torch.kernels.huffman_decode import huffman_decode as hd

from test_torch_cuda import HUFFMAN_CASES, huffman_case

T = torch.from_numpy


def reference_table(table):
    """The JAX package's table(s) with the same code lengths."""
    if isinstance(table, huffman.PlaneTables):
        return jhuff.PlaneTables([jhuff.HuffmanTable.from_lengths(t.lengths)
                                  for t in table.tables])
    return jhuff.HuffmanTable.from_lengths(table.lengths)


def reference_load(payload, starts, v, table, bases, base_of):
    """The reference's load: ``decode_at``, then ``apply_delta`` of each
    chunk base over the rows that carry it."""
    out = jhuff.decode_at(payload, starts, v, reference_table(table))
    for k, base in enumerate(bases):
        sel = base_of == k
        out[sel] = jxd.apply_delta(out[sel], base)
    return out


@pytest.mark.parametrize("case", sorted(HUFFMAN_CASES))
def test_huffman_decode_matches_reference(case):
    kw = HUFFMAN_CASES[case]
    payload, starts, table, bases, base_of, want = huffman_case(**kw)
    v = kw["v"]
    ref = reference_load(payload, starts, v, table, bases, base_of)
    np.testing.assert_array_equal(ref, want)
    args = (T(payload), T(starts), v, table, T(bases), T(base_of))
    np.testing.assert_array_equal(hd.huffman_decode_ref(*args).numpy(), ref)
    np.testing.assert_array_equal(dispatch.huffman_decode(*args).numpy(), ref)
    # no chunk of the load has a base: the decode alone
    none = np.full_like(base_of, -1)
    np.testing.assert_array_equal(
        hd.huffman_decode_ref(T(payload), T(starts), v, table,
                              T(bases[:0]), T(none)).numpy(),
        reference_load(payload, starts, v, table, bases[:0], none))


def test_huffman_decode_empty_load():
    payload, starts, table, bases, base_of, _ = huffman_case("skewed", 16)
    got = dispatch.huffman_decode(T(payload), T(starts[:0]), 16, table,
                                  T(bases), T(base_of[:0]))
    assert got.shape == (0, 16) and got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), reference_load(payload, starts[:0], 16, table, bases,
                                    base_of[:0]))


def kernel_lookup(words: np.ndarray, peeks: np.ndarray):
    """The kernel's two-level decode of 16-bit peeks, in numpy: the
    first-level entry, else the canonical decode by per-length limits ->
    (symbols, lengths)."""
    lut = words[:hd._LIMIT_AT].view(np.uint16)
    limit = words[hd._LIMIT_AT:hd._BASE_AT].astype(np.int64)
    base = words[hd._BASE_AT:hd._SYMS_AT].astype(np.int64)
    syms = words[hd._SYMS_AT:].view(np.uint8)
    e = lut[peeks >> (huffman.MAX_LEN - hd.LUT_BITS)].astype(np.int64)
    sym, ln = e & 0xFF, e >> 8
    for p in np.flatnonzero(ln == 0):
        for length in range(hd.LUT_BITS + 1, huffman.MAX_LEN + 1):
            if peeks[p] < limit[length - 1]:
                sym[p] = syms[base[length - 1]
                              + (peeks[p] >> (huffman.MAX_LEN - length))]
                ln[p] = length
                break
    return sym, ln


@pytest.mark.parametrize("case", ["one-table-v128", "planes4-v100",
                                  "single-symbol", "16-bit-codes"])
def test_decoder_words_equal_the_canonical_lut(case):
    """Every 16-bit peek decodes through the kernel's tables to the LUT's
    (symbol, length), the (0, 0) of a prefix no code has included."""
    table = huffman_case(**HUFFMAN_CASES[case])[2]
    tables = getattr(table, "tables", [table])
    words = hd.decoder_words(table)
    assert words.shape == (len(tables), hd.TABLE_WORDS)
    peeks = np.arange(1 << huffman.MAX_LEN)
    for w, t in zip(words, tables):
        sym, ln = kernel_lookup(w, peeks)
        np.testing.assert_array_equal(sym, t.decode_sym)
        np.testing.assert_array_equal(ln, t.decode_len)


def test_huffman_decode_routes_by_the_byteplane_field():
    """No field routes the op (the ``byteplane`` field is gone with every
    per-op request): the tensors' device does. CPU tensors take the plain
    version, a request is no argument, and the CUDA wrapper refuses CPU
    tensors."""
    payload, starts, table, bases, base_of, want = huffman_case("skewed", 16)
    args = (T(payload), T(starts), 16, table, T(bases), T(base_of))
    np.testing.assert_array_equal(dispatch.huffman_decode(*args).numpy(),
                                  want)
    with pytest.raises(TypeError):
        dispatch.huffman_decode(*args, None)
    with pytest.raises(ValueError, match="CUDA"):
        hd.huffman_decode_cuda(*args)
