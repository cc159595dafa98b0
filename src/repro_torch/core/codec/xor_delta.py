"""XOR-delta transform against a dimension-aligned base vector (paper §3.2).

The base vector takes the most frequent byte value at each *byte position*
across the vectors under consideration (per chunk, §3.3). XOR-ing each vector
against it concentrates the byte distribution near zero while preserving
losslessness, feeding a single unified Huffman stream instead of one stream
per byte column. The transform is applied only when a sampled entropy test
says it wins (§3.3 two-stage compression) — see :func:`delta_wins`.

The numpy functions are copies of ``repro.core.codec.xor_delta``. The torch
versions take the same decisions on tensors where they lie:
``build_base_torch`` and ``delta_wins_torch`` for one chunk, and
``chunk_bases_torch`` / ``chunk_decisions_torch`` for every chunk of a
sealing segment at once (one histogram pass, one host transfer). Ties in
the per-position mode go to the smallest byte value, as ``np.argmax``
does; the entropies are finished on the host with the reference's
formula, so the decision is the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from .entropy import byte_entropy, entropy_from_counts


def as_bytes(vectors: np.ndarray) -> np.ndarray:
    """View an [n, d] numeric array as [n, V] raw bytes (lossless)."""
    vectors = np.ascontiguousarray(vectors)
    return vectors.view(np.uint8).reshape(vectors.shape[0], -1)


def build_base(vec_bytes: np.ndarray) -> np.ndarray:
    """Most frequent byte per byte position -> base vector [V] uint8."""
    n, v = vec_bytes.shape
    base = np.zeros(v, dtype=np.uint8)
    for j in range(v):
        counts = np.bincount(vec_bytes[:, j], minlength=256)
        base[j] = counts.argmax()
    return base


def apply_delta(vec_bytes: np.ndarray, base: np.ndarray) -> np.ndarray:
    return np.bitwise_xor(vec_bytes, base[None, :])


def delta_wins(vec_bytes: np.ndarray, sample_frac: float = 0.1,
               margin_bits: float = 0.05) -> tuple[bool, np.ndarray]:
    """Two-stage test (paper §3.3): sample the first ``sample_frac`` of the
    chunk, build a candidate base, and compare raw vs XOR-delta entropy.

    ``margin_bits`` guards against sample overfit (the base is built from the
    same sample): delta must win by a real margin, since applying it also
    costs a base vector of chunk metadata. Returns (use_delta, base).
    """
    n = vec_bytes.shape[0]
    m = max(1, int(n * sample_frac))
    sample = vec_bytes[:m]
    base = build_base(sample)
    raw_h = byte_entropy(sample)
    delta_h = byte_entropy(apply_delta(sample, base))
    return bool(delta_h < raw_h - margin_bits), base


# ------------------------------------------------------------------ torch
def _chunk_rows(m: int, rows_per_chunk: int, sample_rows: list[int],
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """Row indices of the first ``sample_rows[c]`` rows of every chunk c,
    and the chunk of each."""
    lo = torch.arange(0, m, rows_per_chunk, device=device)
    take = torch.as_tensor(sample_rows, device=device)
    chunk = torch.repeat_interleave(torch.arange(len(sample_rows),
                                                 device=device), take)
    first = torch.cumsum(take, 0) - take
    rows = lo[chunk] + torch.arange(int(take.sum()), device=device) \
        - first[chunk]
    return rows, chunk


def chunk_bases_torch(vec_bytes: torch.Tensor, rows_per_chunk: int,
                      sample_rows: list[int]
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per chunk of ``rows_per_chunk`` rows: the base vector of its first
    ``sample_rows[c]`` rows (``build_base`` of that sample). Returns
    ``(bases [C, V] uint8, sample [S, V] uint8, chunk of each sample row)``.
    """
    m, v = vec_bytes.shape
    dev = vec_bytes.device
    n_chunks = len(sample_rows)
    rows, chunk = _chunk_rows(m, rows_per_chunk, sample_rows, dev)
    sample = vec_bytes[rows]
    col = torch.arange(v, device=dev)
    idx = ((chunk[:, None] * v + col) << 8) + sample.to(torch.int64)
    counts = torch.bincount(idx.reshape(-1), minlength=n_chunks * v * 256)
    bases = counts.view(n_chunks, v, 256).argmax(-1).to(torch.uint8)
    return bases, sample, chunk


def chunk_decisions_torch(vec_bytes: torch.Tensor, rows_per_chunk: int,
                          sample_frac: float = 0.1,
                          margin_bits: float = 0.05
                          ) -> tuple[list[bool], torch.Tensor]:
    """``delta_wins`` of every chunk of ``vec_bytes`` [m, V] (chunk c is
    rows ``c*rows_per_chunk`` onward) -> (use_delta per chunk, bases
    [C, V] uint8 on the tensors' device)."""
    m = vec_bytes.shape[0]
    sizes = [min(rows_per_chunk, m - lo) for lo in range(0, m, rows_per_chunk)]
    sample_rows = [max(1, int(n * sample_frac)) for n in sizes]
    bases, sample, chunk = chunk_bases_torch(vec_bytes, rows_per_chunk,
                                             sample_rows)
    n_chunks = len(sizes)
    key = (chunk << 8)[:, None]
    raw = torch.bincount((key + sample.to(torch.int64)).reshape(-1),
                         minlength=n_chunks * 256)
    delta = torch.bincount(
        (key + torch.bitwise_xor(sample, bases[chunk]).to(torch.int64))
        .reshape(-1), minlength=n_chunks * 256)
    counts = torch.stack([raw, delta]).view(2, n_chunks, 256).cpu().numpy()
    use = [entropy_from_counts(counts[1, c])
           < entropy_from_counts(counts[0, c]) - margin_bits
           for c in range(n_chunks)]
    return use, bases


def build_base_torch(vec_bytes: torch.Tensor) -> torch.Tensor:
    """``build_base`` of a uint8 tensor [n, V] -> [V] uint8."""
    n = vec_bytes.shape[0]
    return chunk_bases_torch(vec_bytes, max(1, n), [n])[0][0]


def delta_wins_torch(vec_bytes: torch.Tensor, sample_frac: float = 0.1,
                     margin_bits: float = 0.05
                     ) -> tuple[bool, torch.Tensor]:
    """``delta_wins`` of a uint8 tensor [n, V] -> (use_delta, base [V])."""
    n = vec_bytes.shape[0]
    use, bases = chunk_decisions_torch(vec_bytes, max(1, n), sample_frac,
                                       margin_bits)
    return use[0], bases[0]
