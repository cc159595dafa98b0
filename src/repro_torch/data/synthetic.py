"""Deterministic synthetic datasets with the statistical profile of the
paper's workloads (§4.1, Table 2).

``sift-like``  — uint8 image-descriptor style: per-dimension concentrated,
                 moderately skewed histograms (SIFT1M: global entropy 2.63,
                 columnar 1.73; dimensional dispersion < global).
``spacev-like``— int8 web-embedding style: higher entropy, mild concentration
                 (SPACEV1M: global 5.59, columnar 5.46).
``prop-like``  — FP32 normalized embeddings (DecoupleVS100M style): tiny
                 dispersion (0.09 global / 0.06 dimensional), strong
                 byte-positional locality (exponent bytes nearly constant).

The numpy generators are copies of ``repro.data.synthetic`` (same seeds,
same bytes). ``sift_like_torch`` and ``prop_like_torch`` draw the same
distributions on a device from a ``torch.Generator``: a shard of tens of
millions of vectors is made where it will be stored and searched instead of
being copied over from the host.
"""
from __future__ import annotations

import numpy as np
import torch


def make_vector_dataset(kind: str, n: int, dim: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "sift-like":
        # Gradient-histogram style: nonnegative, many near-zero bins, a few
        # strong bins per dimension; per-dimension scale varies.
        scale = rng.uniform(1.5, 12.0, size=dim)
        raw = rng.gamma(shape=0.6, scale=scale[None, :], size=(n, dim))
        return np.clip(raw, 0, 255).astype(np.uint8)
    if kind == "spacev-like":
        center = rng.integers(-30, 30, size=dim)
        raw = center[None, :] + rng.normal(0, 24.0, size=(n, dim))
        return np.clip(raw, -128, 127).astype(np.int8)
    if kind == "prop-like":
        # L2-normalized fp32 embeddings with anisotropic spectrum. Values
        # are rounded to ~3 decimal digits, matching production embedding
        # dumps (quantised/truncated transport), which concentrates the
        # exponent and low-mantissa bytes — the byte-positional locality
        # the paper measures on DecoupleVS100M (Table 1).
        spectrum = rng.uniform(0.2, 1.0, size=dim) ** 2
        raw = rng.normal(0, 1.0, size=(n, dim)) * spectrum[None, :]
        raw /= np.linalg.norm(raw, axis=1, keepdims=True) + 1e-12
        return np.round(raw, 3).astype(np.float32)
    if kind == "cluster-like":
        # Mixture-of-Gaussians embeddings: well-separated centers with
        # tight within-cluster spread (the regime selective shard routing
        # assumes). Cluster count scales with n.
        n_clusters = max(8, min(64, n // 64))
        centers = rng.normal(0, 1.0, size=(n_clusters, dim))
        centers /= np.linalg.norm(centers, axis=1, keepdims=True) + 1e-12
        who = rng.integers(0, n_clusters, size=n)
        raw = centers[who] + rng.normal(0, 0.08, size=(n, dim))
        return raw.astype(np.float32)
    raise ValueError(f"unknown dataset kind {kind!r}")


def make_queries(kind: str, n_queries: int, dim: int, seed: int = 1) -> np.ndarray:
    """Queries drawn from the same distribution (held-out seed)."""
    return make_vector_dataset(kind, n_queries, dim, seed=seed + 10_000)


def ground_truth(base: np.ndarray, queries: np.ndarray, k: int,
                 metric: str = "l2") -> np.ndarray:
    """Exact top-k by brute force (float64 accumulation) -> [nq, k] ids."""
    b = base.astype(np.float64)
    q = queries.astype(np.float64)
    if metric == "l2":
        d = ((q[:, None, :] - b[None, :, :]) ** 2).sum(-1) if len(b) * len(q) < 4e6 \
            else _chunked_l2(q, b)
    elif metric == "ip":
        d = -(q @ b.T)
    else:
        raise ValueError(metric)
    return np.argsort(d, axis=1)[:, :k]


def _chunked_l2(q: np.ndarray, b: np.ndarray, chunk: int = 256) -> np.ndarray:
    out = np.zeros((len(q), len(b)))
    bb = (b * b).sum(-1)
    for i in range(0, len(q), chunk):
        qi = q[i:i + chunk]
        out[i:i + chunk] = (qi * qi).sum(-1)[:, None] + bb[None, :] - 2 * qi @ b.T
    return out


def sift_like_torch(n: int, dim: int, seed: int, device,
                    chunk: int = 1 << 20) -> torch.Tensor:
    """``sift-like`` [n, dim] uint8 drawn on ``device``: per-dimension scale
    ~ U(1.5, 12), values Gamma(0.6) * scale clipped to [0, 255] and
    truncated, as ``make_vector_dataset`` does. Same distribution, not the
    same bytes: the draws come from a ``torch.Generator`` seeded with
    ``seed``, in row chunks so the float temporaries stay small."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    scale = torch.empty(dim, device=device).uniform_(1.5, 12.0, generator=g)
    alpha = torch.full((min(chunk, n), dim), 0.6, device=device)
    out = torch.empty((n, dim), dtype=torch.uint8, device=device)
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        raw = torch._standard_gamma(alpha[:b - a], generator=g) * scale
        out[a:b] = raw.clamp_(0, 255).to(torch.uint8)
    return out


def prop_like_torch(n: int, dim: int, seed: int, device,
                    chunk: int = 1 << 18) -> torch.Tensor:
    """``prop-like`` [n, dim] float32 drawn on ``device``: Gaussian rows
    scaled by a per-dimension spectrum ~ U(0.2, 1)^2, L2-normalised (+1e-12)
    and rounded to 3 decimals in float64 before the cast, as
    ``make_vector_dataset`` does. Same distribution, not the same bytes: the
    draws come from a ``torch.Generator`` seeded with ``seed``, in row
    chunks so the float64 temporaries stay small."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    spectrum = torch.empty(dim, dtype=torch.float64, device=device).uniform_(
        0.2, 1.0, generator=g) ** 2
    out = torch.empty((n, dim), dtype=torch.float32, device=device)
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        raw = torch.randn((b - a, dim), dtype=torch.float64, generator=g,
                          device=device) * spectrum
        raw /= torch.linalg.vector_norm(raw, dim=1, keepdim=True) + 1e-12
        out[a:b] = torch.round(raw, decimals=3).float()
    return out


def make_token_batch(vocab: int, batch: int, seq: int, seed: int = 0) -> np.ndarray:
    """Synthetic LM token stream (Zipf-ish) for serve smoke tests."""
    rng = np.random.default_rng(seed)
    z = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
    return (z % vocab).astype(np.int32)
