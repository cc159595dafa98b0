"""Product quantization (Jegou et al.) — the in-memory lossy codes that
DiskANN-family systems (and DecoupleVS, §3.1) keep in DRAM/HBM to steer
graph traversal without touching full-precision vectors.

``train_pq`` and ``encode_pq`` are numpy copies of ``repro.core.graph.pq``.
``encode_pq_torch`` encodes device tensors (the ``pq_encode`` kernel on a
card, its plain version on the CPU) and gives the same codes as
``encode_pq``. ``build_lut`` and ``adc_lookup_np`` are the host engine's
numpy LUT and ADC (``core/search/engine.py``). ``build_lut_torch`` is the
per-query ADC table builder of the search path (``build_lut_jnp``),
folding over ``dsub`` in order.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ... import tracing
from ...kernels import dispatch


@dataclass
class PQCodebook:
    centroids: np.ndarray   # [M, K, dsub] float32
    dim: int

    @property
    def n_subspaces(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_centroids(self) -> int:
        return self.centroids.shape[1]


def train_pq(vectors: np.ndarray, m: int = 8, k: int = 256, iters: int = 8,
             seed: int = 0, sample: int = 20_000) -> PQCodebook:
    """Train M sub-codebooks of K centroids by Lloyd's k-means."""
    x = np.asarray(vectors, dtype=np.float32)
    n, d = x.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by m {m}")
    dsub = d // m
    rng = np.random.default_rng(seed)
    if n > sample:
        x = x[rng.choice(n, size=sample, replace=False)]
        n = sample
    k_eff = min(k, n)
    cents = np.zeros((m, k, dsub), dtype=np.float32)
    for mi in range(m):
        sub = x[:, mi * dsub:(mi + 1) * dsub]
        c = sub[rng.choice(n, size=k_eff, replace=False)].copy()
        for _ in range(iters):
            d2 = ((sub[:, None, :] - c[None, :, :]) ** 2).sum(-1)
            assign = d2.argmin(1)
            for ci in range(k_eff):
                mask = assign == ci
                if mask.any():
                    c[ci] = sub[mask].mean(0)
        cents[mi, :k_eff] = c
        if k_eff < k:  # duplicate to fill the table (tiny datasets)
            cents[mi, k_eff:] = c[rng.integers(0, k_eff, size=k - k_eff)]
    return PQCodebook(centroids=cents, dim=d)


def encode_pq(vectors: np.ndarray, cb: PQCodebook, chunk: int = 4096) -> np.ndarray:
    """Encode [n, d] -> [n, M] uint8 codes."""
    x = np.asarray(vectors, dtype=np.float32)
    n, d = x.shape
    m, k, dsub = cb.centroids.shape
    codes = np.zeros((n, m), dtype=np.uint8)
    for i in range(0, n, chunk):
        xi = x[i:i + chunk]
        for mi in range(m):
            sub = xi[:, mi * dsub:(mi + 1) * dsub]
            d2 = ((sub[:, None, :] - cb.centroids[mi][None, :, :]) ** 2).sum(-1)
            codes[i:i + chunk, mi] = d2.argmin(1).astype(np.uint8)
    return codes


def build_lut(query: np.ndarray, cb: PQCodebook) -> np.ndarray:
    """Per-query ADC lookup table [M, K] float32 of squared sub-distances."""
    q = np.asarray(query, dtype=np.float32)
    m, k, dsub = cb.centroids.shape
    qs = q.reshape(m, 1, dsub)
    return ((qs - cb.centroids) ** 2).sum(-1).astype(np.float32)


def adc_lookup_np(codes: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Oracle ADC: dist[i] = sum_m lut[m, codes[i, m]]."""
    m = lut.shape[0]
    return lut[np.arange(m)[None, :], codes].sum(-1)


def encode_pq_torch(vectors: torch.Tensor, centroids: torch.Tensor,
                    chunk: int = 1 << 18) -> torch.Tensor:
    """Encode ``[n, d]`` uint8 or float32 vectors against ``[M, K, dsub]``
    centroids -> ``[n, M]`` uint8 codes on ``vectors.device``: per
    subspace, the first centroid at least squared-L2 distance, the distance
    folded over ``dsub`` in order (numpy's order for ``dsub < 8``, so the
    codes equal ``encode_pq``'s)."""
    n = vectors.shape[0]
    m, _, dsub = centroids.shape
    with tracing.span("pq.encode", {"rows": n, "m": m, "dsub": dsub}):
        out = torch.empty((n, m), dtype=torch.uint8, device=vectors.device)
        for a in range(0, n, chunk):
            out[a:a + chunk] = dispatch.pq_encode(vectors[a:a + chunk],
                                                  centroids)
    return out


def build_lut_torch(queries: torch.Tensor, centroids: torch.Tensor
                    ) -> torch.Tensor:
    """Per-query ADC tables: queries ``[nq, d]`` x centroids ``[M, K, dsub]``
    -> ``[nq, M, K]`` float32 squared sub-distances, folded over ``dsub``
    in order (the order jnp's ``.sum(-1)`` takes for these widths)."""
    m, k, dsub = centroids.shape
    q = queries.to(torch.float32).reshape(-1, m, 1, dsub)
    diff = q - centroids[None]
    sq = diff * diff
    acc = sq[..., 0].clone()
    for s in range(1, dsub):
        acc += sq[..., s]
    return acc.contiguous()
