"""Kernel dispatch layer: one registry from (op, backend) to implementation.

The JAX reference resolves a per-op backend at config time. Here the
tensors' device picks every op's backend, and nothing else does:

    cuda   the hand-written CUDA kernel (``kernels/csrc``), for tensors on
           a CUDA device. A kernel that cannot be built or launched raises;
           nothing falls back to the plain version.
    ref    the plain PyTorch version, for tensors on the CPU.

Tensors on any other device raise.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

BACKENDS = ("ref", "cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device (raise if there is none); else the
    device given. Entry points run on the card unless told otherwise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def resolve_backend(device: torch.device) -> str:
    """The backend for tensors on ``device``: ``cuda`` on the card,
    ``ref`` on the CPU."""
    if device.type == "cuda":
        return "cuda"
    if device.type == "cpu":
        return "ref"
    raise ValueError(f"no kernel backend for tensors on {device}")


@functools.lru_cache(maxsize=1)
def _registry() -> dict[tuple[str, str], Callable]:
    from .beam_step.beam_step import beam_step_cuda, beam_step_ref
    from .byteplane.byteplane import (byteplane_decode_cuda,
                                      byteplane_decode_ref)
    from .ef_decode.ef_decode import ef_decode_cuda, ef_decode_ref
    from .ef_record_decode.ef_record_decode import (ef_record_decode_cuda,
                                                    ef_record_decode_ref)
    from .huffman_decode.huffman_decode import (huffman_decode_cuda,
                                                huffman_decode_ref)
    from .pq_adc.pq_adc import (pq_adc_batched_cuda, pq_adc_batched_ref,
                                pq_adc_cuda, pq_adc_ref)
    from .pq_encode.pq_encode import pq_encode_cuda, pq_encode_ref
    from .rerank_l2.rerank_l2 import rerank_l2_cuda, rerank_l2_ref
    from .rerank_loop.rerank_loop import rerank_loop_cuda, rerank_loop_ref

    table: dict[tuple[str, str], Callable] = {}
    for op, ref, kern in (
            ("pq_adc", pq_adc_ref, pq_adc_cuda),
            ("pq_adc_batched", pq_adc_batched_ref, pq_adc_batched_cuda),
            ("ef_decode", ef_decode_ref, ef_decode_cuda),
            ("ef_record_decode", ef_record_decode_ref,
             ef_record_decode_cuda),
            ("rerank_l2", rerank_l2_ref, rerank_l2_cuda),
            ("rerank_loop", rerank_loop_ref, rerank_loop_cuda),
            ("beam_step", beam_step_ref, beam_step_cuda),
            ("byteplane", byteplane_decode_ref, byteplane_decode_cuda),
            ("huffman_decode", huffman_decode_ref, huffman_decode_cuda),
            ("pq_encode", pq_encode_ref, pq_encode_cuda)):
        table[op, "ref"] = ref
        table[op, "cuda"] = kern
    return table


def get_impl(op: str, backend: str) -> Callable:
    """(op, backend) -> implementation."""
    try:
        return _registry()[op, backend]
    except KeyError:
        raise KeyError(f"no implementation registered for "
                       f"op={op!r} backend={backend!r}") from None


def _impl(op: str, t: torch.Tensor) -> Callable:
    return get_impl(op, resolve_backend(t.device))


# ------------------------------------------------------------- public ops
def pq_adc(codes, lut):
    """[n, M] codes x [M, K] LUT -> [n] ADC distances."""
    return _impl("pq_adc", codes)(codes, lut)


def pq_adc_batched(codes, luts, ids=None):
    """[N, M] uint8 code table x [nq, M, K] per-query LUTs, rows ``ids``
    [nq, E] int32 (clipped to N - 1) -> [nq, E], +inf where ids < 0; without
    ids, [nq, n, M] codes -> [nq, n]."""
    return _impl("pq_adc_batched", codes)(codes, luts, ids)


def ef_decode(slots, r_max: int, universe: int, ids=None):
    """[N, W] int32 (uint32 bit-view) slots, rows ``ids`` [B] int32
    (clipped to the table; every row without ids) -> (neighbors
    [B, r_max], counts [B])."""
    return _impl("ef_decode", slots)(slots, r_max, universe, ids)


def ef_record_decode(buf, rec_start, rec_len, pos):
    """The index store's Elias-Fano records at positions ``pos`` [B] int64
    of the [N] record table (``rec_start`` int64 byte offsets, ``rec_len``
    int32 lengths) into the uint8 image ``buf`` -> (values [B, max count]
    int64, -1 past each count; counts [B] int64). A position outside
    [0, N) gives count -1 and a row of -1."""
    return _impl("ef_record_decode", buf)(buf, rec_start, rec_len, pos)


def rerank_l2(queries, cands, ids=None):
    """[Q, D] queries x the [N, D] table, rows ``ids`` [Q, C] int32
    (clipped to [0, N - 1], nothing masked) -> squared L2 [Q, C]; without
    ids, [Q, C, D] candidates."""
    return _impl("rerank_l2", cands)(queries, cands, ids)


def rerank_loop(queries, vectors, cand_ids, k: int, b: int,
                max_batches: int, threshold: float, tombstone=None):
    """The phase-2 re-rank's benefit-ratio loop over the [N, D] table for
    [Q, D] float32 queries and their [Q, L] int32 candidates (batch 0 the
    first ``k``, then up to ``max_batches`` batches of ``b``; ids < 0 and
    ``tombstone``d ids read +inf) -> (ids [Q, min(k, L)], dists, batches
    [Q] int32), the heap in ascending stable order."""
    return _impl("rerank_loop", vectors)(queries, vectors, cand_ids, k, b,
                                         max_batches, threshold, tombstone)


def byteplane_decode(packed, base):
    """[n, V] uint8 XOR [V] uint8 base -> [n, V] uint8 (lossless)."""
    return _impl("byteplane", packed)(packed, base)


def huffman_decode(payload, starts, v: int, table, bases, base_of):
    """The vector store's load of one segment: the Huffman records at byte
    ``starts`` [m] of ``payload`` decoded to [m, v] uint8 with ``table``
    (one table or plane tables), row i XOR ``bases[base_of[i]]`` where
    ``base_of[i] >= 0``."""
    return _impl("huffman_decode", payload)(payload, starts, v, table, bases,
                                            base_of)


def beam_step(pq_codes, luts, cand_ids, cand_d, new_ids):
    """Fused hop tail: the [n, M] code rows of ``new_ids`` [nq, E] scored
    against [nq, M, K] LUTs and merged into the [nq, L] candidate list ->
    (cand_ids', cand_d', top_idx)."""
    return _impl("beam_step", pq_codes)(pq_codes, luts, cand_ids, cand_d,
                                        new_ids)


def pq_encode(vectors, centroids):
    """[n, d] vectors x [M, K, dsub] centroids -> [n, M] uint8 PQ codes."""
    return _impl("pq_encode", vectors)(vectors, centroids)
