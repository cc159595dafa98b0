"""Dataset compressibility characterization (paper §3.2, Table 1).

Global vs dimensional dispersion and global vs columnar byte entropy: the
paper's evidence that normalized embedding vectors concentrate per dimension
(and per byte column), which the XOR-delta + Huffman pipeline exploits.

The numpy functions are copies of ``repro.core.codec.entropy``.
``byte_counts_torch`` counts bytes where the data lies (a shard's chunks
stay on the card); the entropy itself is always finished on the host by
``entropy_from_counts``, the reference's float64 formula, so a decision
taken on device counts equals the reference's bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def entropy_from_counts(counts) -> float:
    """Shannon entropy (bits/byte) of a 256-bin byte histogram."""
    counts = np.asarray(counts).astype(np.float64)
    p = counts / max(1, counts.sum())
    nz = p > 0
    return float(-(p[nz] * np.log2(p[nz])).sum())


def byte_entropy(data: np.ndarray) -> float:
    """Shannon entropy (bits/byte) over all bytes of ``data``."""
    b = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    return entropy_from_counts(np.bincount(b, minlength=256))


def byte_counts_torch(data: torch.Tensor) -> torch.Tensor:
    """256-bin histogram of the bytes of a uint8 tensor, on its device."""
    return torch.bincount(data.reshape(-1).to(torch.int64), minlength=256)


def byte_entropy_torch(data: torch.Tensor) -> float:
    """``byte_entropy`` of a uint8 tensor: counted on its device, finished
    on the host (same float as the reference)."""
    return entropy_from_counts(byte_counts_torch(data).cpu().numpy())


def columnar_entropy(vec_bytes: np.ndarray) -> float:
    """Average entropy of each byte column across vectors."""
    n, v = vec_bytes.shape
    ent = 0.0
    for j in range(v):
        ent += byte_entropy(vec_bytes[:, j])
    return ent / v


def global_dispersion(vectors: np.ndarray) -> float:
    """Std-dev across all values in the dataset."""
    return float(np.asarray(vectors, dtype=np.float64).std())


def dimensional_dispersion(vectors: np.ndarray) -> float:
    """Average per-dimension std-dev."""
    return float(np.asarray(vectors, dtype=np.float64).std(axis=0).mean())


def characterize(vectors: np.ndarray) -> dict:
    """Table-1 style characterization of a vector dataset."""
    vb = np.ascontiguousarray(vectors).view(np.uint8)
    vb = vb.reshape(vectors.shape[0], -1)
    return {
        "global_dispersion": global_dispersion(vectors),
        "dimensional_dispersion": dimensional_dispersion(vectors),
        "global_entropy": byte_entropy(vectors),
        "columnar_entropy": columnar_entropy(vb),
    }
