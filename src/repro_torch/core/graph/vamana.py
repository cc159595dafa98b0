"""Vamana graph construction (DiskANN [17]) — the auxiliary index that
DecoupleVS compresses and stores decoupled from vector data.

Host-side (numpy) offline build, as in the paper (§4.1: index construction is
the expensive offline step; DecoupleVS's compression+layout transform runs
afterwards over the finished graph). Greedy best-first search + robust prune
with the two-pass (α=1 then α) schedule.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class VamanaGraph:
    adjacency: list          # list[np.ndarray int32], out-neighbors per vertex
    medoid: int
    r: int

    @property
    def n(self) -> int:
        return len(self.adjacency)

    def degree_stats(self) -> tuple[float, int]:
        degs = [len(a) for a in self.adjacency]
        return float(np.mean(degs)), int(np.max(degs))

    def to_padded(self, r_max: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """-> (neighbors [n, r_max] int32 padded with -1, counts [n] int32)."""
        r_max = r_max or self.r
        n = self.n
        out = np.full((n, r_max), -1, dtype=np.int32)
        cnt = np.zeros(n, dtype=np.int32)
        for i, a in enumerate(self.adjacency):
            a = a[:r_max]
            out[i, :len(a)] = a
            cnt[i] = len(a)
        return out, cnt


def _l2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = a - b
    return (d * d).sum(-1)


def greedy_search(vectors: np.ndarray, adjacency, entry: int, query: np.ndarray,
                  l_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Best-first search -> (visited ids, visited dists), visited = expanded.

    Classic DiskANN GreedySearch with candidate list size ``l_size``.
    """
    cand_ids = [entry]
    cand_dists = [float(_l2(vectors[entry], query))]
    expanded: set[int] = set()
    in_cand = {entry}
    visited_ids: list[int] = []
    visited_dists: list[float] = []
    while True:
        best, best_d = -1, np.inf
        for cid, cd in zip(cand_ids, cand_dists):
            if cid not in expanded and cd < best_d:
                best, best_d = cid, cd
        if best < 0:
            break
        expanded.add(best)
        visited_ids.append(best)
        visited_dists.append(best_d)
        nbrs = [x for x in adjacency[best] if x not in in_cand]
        if nbrs:
            nd = _l2(vectors[np.asarray(nbrs)], query[None, :])
            cand_ids.extend(nbrs)
            cand_dists.extend(nd.tolist())
            in_cand.update(nbrs)
        if len(cand_ids) > l_size:
            order = np.argsort(cand_dists)[:l_size]
            keep = set(order.tolist())
            cand_ids = [cand_ids[i] for i in sorted(keep)]
            cand_dists = [cand_dists[i] for i in sorted(keep)]
    return np.asarray(visited_ids, np.int32), np.asarray(visited_dists, np.float32)


def robust_prune(p: int, cand_ids: np.ndarray, vectors: np.ndarray,
                 alpha: float, r: int) -> np.ndarray:
    """RobustPrune: diverse neighbor selection with slack α."""
    cand_ids = np.unique(np.asarray(cand_ids, np.int64))
    cand_ids = cand_ids[cand_ids != p]
    if len(cand_ids) == 0:
        return np.zeros(0, np.int32)
    dists = _l2(vectors[cand_ids], vectors[p][None, :])
    order = np.argsort(dists)
    cand_ids, dists = cand_ids[order], dists[order]
    alive = np.ones(len(cand_ids), dtype=bool)
    result: list[int] = []
    for i in range(len(cand_ids)):
        if not alive[i]:
            continue
        c = cand_ids[i]
        result.append(int(c))
        if len(result) >= r:
            break
        # Kill candidates closer to c than (their distance to p) / alpha.
        rest = np.flatnonzero(alive)
        rest = rest[rest > i]
        if len(rest):
            d_cc = _l2(vectors[cand_ids[rest]], vectors[c][None, :])
            alive[rest[alpha * d_cc <= dists[rest]]] = False
    return np.asarray(result, np.int32)


def build_vamana(vectors: np.ndarray, r: int = 32, l_build: int = 64,
                 alpha: float = 1.2, seed: int = 0) -> VamanaGraph:
    vectors = np.asarray(vectors, dtype=np.float32)
    n = len(vectors)
    rng = np.random.default_rng(seed)
    medoid = int(_l2(vectors, vectors.mean(0, keepdims=True)).argmin())
    # Random regular start.
    adjacency = [rng.choice(n, size=min(r, n - 1), replace=False).astype(np.int32)
                 for _ in range(n)]
    for i in range(n):
        adjacency[i] = adjacency[i][adjacency[i] != i]
    for pass_alpha in (1.0, alpha):
        for i in rng.permutation(n):
            visited, _ = greedy_search(vectors, adjacency, medoid, vectors[i], l_build)
            cand = np.concatenate([visited, adjacency[i]])
            adjacency[i] = robust_prune(i, cand, vectors, pass_alpha, r)
            for q in adjacency[i]:
                if i not in adjacency[q]:
                    merged = np.append(adjacency[q], i)
                    if len(merged) > r:
                        adjacency[q] = robust_prune(int(q), merged, vectors,
                                                    pass_alpha, r)
                    else:
                        adjacency[q] = merged.astype(np.int32)
    return VamanaGraph(adjacency=adjacency, medoid=medoid, r=r)
