"""Sharded ANNS, host half — the port of the partitioning, building and
routing parts of ``repro.core.distributed.sharded_index``.

The dataset is partitioned — contiguous id ranges or balanced k-means
clusters — into one Vamana sub-graph + PQ codes per shard, stacked on a
leading shard axis (:class:`ShardedIndex`). The serving tier
(``serve/ann.py``) fans a query batch out shard by shard on one device and
merges the per-shard top-K on the host.

**Selective shard routing** (SPANN's closest-posting-list pruning): a
replicated :class:`ShardRouter` — per-shard k-means centroids over the
shard's own rows — scores shards per query; only the top
``ceil(route_frac * S)`` shards keep their candidates. Routing only
preserves recall when the partition is *clustered* (``partition="cluster"``).

Local ids translate to global ids through ``ShardedIndex.row_ids`` (-1 marks
the pad rows that fill the last shard to a uniform size), so pad rows are
masked out of every merge.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...kernels.beam_step.beam_step import stable_smallest
from ..index import build_device_index
from ..search.beam import resolve_device


class ShardedIndex(NamedTuple):
    """Per-shard DeviceIndex tensors stacked on a leading shard axis."""
    neighbors: torch.Tensor     # [S, n, R] int32
    counts: torch.Tensor        # [S, n] int32
    ef_slots: torch.Tensor      # [S, n, W] int32 bit-view of uint32
    pq_codes: torch.Tensor      # [S, n, M] uint8
    pq_centroids: torch.Tensor  # [S, M, K, dsub] float32
    vectors: torch.Tensor       # [S, n, d]
    medoid: torch.Tensor        # [S] int64
    row_ids: torch.Tensor       # [S, n] int32 global id per local slot;
                                # -1 = pad row (masked out of every merge)


class ShardRouter(NamedTuple):
    """Replicated per-shard centroids: score[q, s] = min_c ||q - c_{s,c}||²
    (SPANN closest-posting-list routing, one hot router per query batch)."""
    centroids: torch.Tensor     # [S, C, d] float32


# ------------------------------------------------------------- partitioning
def _kmeans(x: np.ndarray, k: int, rng, iters: int = 8) -> np.ndarray:
    """Plain seeded Lloyd's over [n, d] -> [k, d] centroids (empty clusters
    re-seeded from the farthest points so k centroids always come back)."""
    n = len(x)
    cent = x[rng.choice(n, size=min(k, n), replace=False)].astype(np.float64)
    if len(cent) < k:
        cent = np.concatenate([cent, np.repeat(cent[-1:], k - len(cent), 0)])
    for _ in range(iters):
        d2 = ((x[:, None, :] - cent[None]) ** 2).sum(-1)      # [n, k]
        asn = d2.argmin(1)
        for c in range(k):
            m = asn == c
            if m.any():
                cent[c] = x[m].mean(0)
            else:
                cent[c] = x[d2.min(1).argmax()]
    return cent.astype(np.float32)


def _partition(vectors: np.ndarray, n_shards: int, per: int, mode: str,
               seed: int) -> list:
    """-> list of [<= per] int64 global-id arrays, one per shard."""
    n = len(vectors)
    if mode == "range":
        return [np.arange(i * per, min((i + 1) * per, n), dtype=np.int64)
                for i in range(n_shards)]
    if mode != "cluster":
        raise ValueError(f"partition must be 'range' or 'cluster', "
                         f"got {mode!r}")
    rng = np.random.default_rng(seed)
    # Two-level SPANN-style partition: fine k-means clusters (several per
    # shard) laid out along a greedy nearest-centroid TOUR and chopped into
    # ``per``-sized contiguous shards, so a data mode lands on one shard
    # except at the <= S-1 chop boundaries.
    n_fine = min(n, max(n_shards, min(8 * n_shards, n // 8 or 1)))
    cent = _kmeans(vectors.astype(np.float64), n_fine, rng)
    d2 = ((vectors[:, None, :] - cent[None].astype(np.float64)) ** 2).sum(-1)
    asn = d2.argmin(1)
    clusters = [np.nonzero(asn == c)[0] for c in range(n_fine)]
    live = [c for c in range(n_fine) if len(clusters[c])]
    means = np.stack([vectors[clusters[c]].mean(0) for c in live]) \
        .astype(np.float64)
    cd2 = ((means[:, None, :] - means[None]) ** 2).sum(-1)
    tour, left = [0], set(range(1, len(live)))
    while left:
        prev = tour[-1]
        nxt = min(left, key=lambda c: (cd2[prev, c], c))
        tour.append(nxt)
        left.remove(nxt)
    order = np.concatenate([clusters[live[c]] for c in tour])
    return [np.asarray(b, np.int64) for b in np.array_split(order, n_shards)]


def build_sharded_index(vectors: np.ndarray, n_shards: int, r: int = 32,
                        l_build: int = 64, pq_m: int = 8, seed: int = 0,
                        partition: str = "range", device=None
                        ) -> tuple[ShardedIndex, int]:
    """-> (stacked per-shard index on ``device`` (None = the card), shard
    rows ``per``).

    Shards with fewer than ``per`` members are padded with duplicates of
    their last row so the stack is rectangular; pad slots carry
    ``row_ids == -1`` and are masked out of every merge.
    """
    dev = resolve_device(device)
    vectors = np.asarray(vectors, np.float32)
    n = len(vectors)
    per = -(-n // n_shards)
    parts, row_ids = [], []
    for i, gids in enumerate(_partition(vectors, n_shards, per, partition,
                                        seed)):
        if not len(gids):
            raise ValueError(f"shard {i} is empty (n={n}, S={n_shards})")
        sub = vectors[gids]
        pad = per - len(gids)
        if pad:      # duplicate the last member; masked via row_ids == -1
            sub = np.concatenate([sub, np.repeat(sub[-1:], pad, 0)])
        idx, _, _ = build_device_index(sub, r=r, l_build=l_build, pq_m=pq_m,
                                       seed=seed + i, device=dev)
        parts.append(idx)
        row_ids.append(np.concatenate(
            [gids, np.full(pad, -1, np.int64)]).astype(np.int32))
    stack = lambda f: torch.stack([getattr(p, f) for p in parts])
    return ShardedIndex(
        neighbors=stack("neighbors"), counts=stack("counts"),
        ef_slots=stack("ef_slots"), pq_codes=stack("pq_codes"),
        pq_centroids=stack("pq_centroids"), vectors=stack("vectors"),
        medoid=stack("medoid"),
        row_ids=torch.from_numpy(np.stack(row_ids)).to(dev)), per


def sharded_index_from_numpy(arrays: dict, device=None) -> ShardedIndex:
    """A :class:`ShardedIndex` on ``device`` (None = the card) from numpy
    arrays named like its fields (e.g. ``{k: np.asarray(v) for k, v in
    ref_sharded._asdict().items()}`` of a reference index, ``row_ids``
    included). uint32 EF slots become their int32 bit-view."""
    dev = resolve_device(device)

    def t(name, dtype=None):
        a = np.array(arrays[name], copy=True, order="C")
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out = torch.from_numpy(a)
        return out.to(device=dev, dtype=dtype or out.dtype)

    return ShardedIndex(
        neighbors=t("neighbors", torch.int32), counts=t("counts", torch.int32),
        ef_slots=t("ef_slots"), pq_codes=t("pq_codes", torch.uint8),
        pq_centroids=t("pq_centroids", torch.float32), vectors=t("vectors"),
        medoid=t("medoid", torch.int64), row_ids=t("row_ids", torch.int32))


# ------------------------------------------------------------------ routing
def build_router(index: ShardedIndex, c: int = 4, seed: int = 0
                 ) -> ShardRouter:
    """k-means ``c`` centroids per shard over its REAL rows (pad rows
    excluded via row_ids) — the replicated routing table, on the index's
    device."""
    vecs = index.vectors.cpu().numpy().astype(np.float32)
    rids = index.row_ids.cpu().numpy()
    cents = []
    for s in range(vecs.shape[0]):
        rows = vecs[s][rids[s] >= 0]
        cents.append(_kmeans(rows.astype(np.float64), c,
                             np.random.default_rng(seed + s)))
    return ShardRouter(centroids=torch.from_numpy(np.stack(cents))
                       .to(index.vectors.device))


def route_mask(centroids, queries, route_frac: float) -> torch.Tensor:
    """[S, C, d] centroids x [Q, d] queries -> bool [Q, S]: the top
    ``ceil(route_frac * S)`` shards per query by min-centroid distance, on
    the centroids' device. Ties go to the lower shard index (the
    reference's ``lax.top_k``), through the stable ascending sort; the
    squared distance folds over d in order."""
    centroids = torch.as_tensor(centroids, dtype=torch.float32)
    queries = torch.as_tensor(queries, dtype=torch.float32).to(
        centroids.device)
    s = centroids.shape[0]
    m = max(1, min(s, int(-(-route_frac * s // 1))))
    diff = queries[:, None, None, :] - centroids[None]
    sq = diff * diff
    d2 = sq[..., 0].clone()
    for j in range(1, sq.shape[-1]):
        d2 += sq[..., j]
    score = d2.min(-1).values                                 # [Q, S]
    _, idx = stable_smallest(score, m)                        # [Q, m]
    return torch.zeros((queries.shape[0], s), dtype=torch.bool,
                       device=centroids.device).scatter_(1, idx, True)
