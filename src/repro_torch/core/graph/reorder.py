"""Locality-aware graph reordering (Severo et al., *Lossless Compression of
Vector IDs for ANN Search*).

A Vamana graph's neighbor lists reference vertices that are close in the
vector space but arbitrary in id space, so sorted adjacency lists have
near-uniform gaps (~U/R) and every beam hop touches scattered 4 KiB blocks.
Relabeling vertices by a locality-preserving order makes each list's ids
cluster around the vertex's own position: gaps collapse (gap/delta codecs
such as ``delta_varint``/``ans_id`` start winning the planner's per-component
arbitration against Elias-Fano) and a beam frontier's lists co-reside in few
blocks (``CompressedIndexStore.get_neighbors_batch`` dedupes the reads).

Three orderings are provided:

- :func:`bfs_order` — breadth-first from the medoid. Cheap (O(E)), and on a
  navigable small-world graph BFS ranks double as a coarse distance-to-entry
  ordering, so neighborhoods land in contiguous rank ranges.
- :func:`bisection_order` — recursive graph bisection (the BP-style scheme
  the id-compression paper uses): split the vertex set by competitive BFS
  growth from a far-apart seed pair, recurse per half, emit leaves in BFS
  order. Slower but tighter clustering on multi-modal corpora.
- :func:`minla_order` — BFS seeded, then refined by median/mean placement
  sweeps (a classic minimum-linear-arrangement heuristic: each vertex moves
  toward the median position of its undirected neighborhood, and the sweep
  is kept only when it shrinks the adjacency tier's actual record bytes).
  This is the strongest of the three on every synthetic world because the
  objective IS the storage cost, not a proxy.

The permutation is applied at *seal time*: a :class:`GraphOrder` carries
``perm`` (external id -> internal position) and ``inv`` (internal ->
external); stores lay records out at internal positions and encode neighbor
lists in internal ids, then un-map back to external ids at the API boundary
(``to_external``). Everything above the store keeps speaking external ids.

A copy of ``repro.core.graph.reorder`` (host numpy): the ``order=``
argument of ``CompressedIndexStore.from_graph``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from .vamana import VamanaGraph

#: Ordering kinds accepted by :func:`compute_order` (and by the
#: ``order=``/``reorder=`` string shorthands across the stores).
KINDS = ("identity", "bfs", "bisection", "minla")


@dataclass(frozen=True)
class GraphOrder:
    """A vertex relabeling: ``perm[external] = internal`` and its inverse
    ``inv[internal] = external``. Both are dense permutations of [0, n)."""
    perm: np.ndarray            # [n] int64, external id -> internal position
    inv: np.ndarray             # [n] int64, internal position -> external id
    kind: str = "identity"

    @property
    def n(self) -> int:
        return len(self.perm)

    @classmethod
    def identity(cls, n: int) -> "GraphOrder":
        eye = np.arange(n, dtype=np.int64)
        return cls(perm=eye, inv=eye.copy(), kind="identity")

    @classmethod
    def from_inv(cls, inv: np.ndarray, kind: str) -> "GraphOrder":
        inv = np.asarray(inv, np.int64)
        perm = np.empty_like(inv)
        perm[inv] = np.arange(len(inv), dtype=np.int64)
        return cls(perm=perm, inv=inv, kind=kind)

    def _map(self, table: np.ndarray, ids) -> np.ndarray:
        """Apply ``table`` elementwise, passing through -1 padding (the
        device path pads short result rows with -1)."""
        ids = np.asarray(ids, np.int64)
        safe = np.clip(ids, 0, len(table) - 1)
        return np.where(ids >= 0, table[safe], np.int64(-1))

    def to_internal(self, ids) -> np.ndarray:
        return self._map(self.perm, ids)

    def to_external(self, ids) -> np.ndarray:
        """Un-map search results back to external ids (the API boundary)."""
        return self._map(self.inv, ids)

    def validate(self) -> None:
        n = self.n
        if sorted(self.perm.tolist()) != list(range(n)):
            raise ValueError("perm is not a permutation of [0, n)")
        if not np.array_equal(self.perm[self.inv], np.arange(n)):
            raise ValueError("inv is not the inverse of perm")


# ---------------------------------------------------------------------------
# Orderings
# ---------------------------------------------------------------------------

def _as_lists(adjacency) -> list[np.ndarray]:
    return [np.asarray(a, np.int64) for a in adjacency]


def bfs_order(adjacency, medoid: int) -> GraphOrder:
    """BFS visit ranks from the medoid; unreachable vertices keep their
    relative id order at the tail. Deterministic: neighbors expand in
    ascending external id."""
    adj = _as_lists(adjacency)
    n = len(adj)
    seen = np.zeros(n, dtype=bool)
    order: list[int] = []
    q = deque([int(medoid)])
    seen[int(medoid)] = True
    while q:
        v = q.popleft()
        order.append(v)
        for w in np.sort(adj[v]):
            w = int(w)
            if 0 <= w < n and not seen[w]:
                seen[w] = True
                q.append(w)
    for v in np.flatnonzero(~seen):
        order.append(int(v))
    return GraphOrder.from_inv(np.asarray(order, np.int64), kind="bfs")


def _restricted_bfs(adj: list[np.ndarray], members: set[int],
                    start: int) -> list[int]:
    """BFS order within ``members`` from ``start``; unreached members append
    in ascending id order."""
    seen = {start}
    out = [start]
    q = deque([start])
    while q:
        v = q.popleft()
        for w in np.sort(adj[v]):
            w = int(w)
            if w in members and w not in seen:
                seen.add(w)
                out.append(w)
                q.append(w)
    out.extend(sorted(members - seen))
    return out


def _far_vertex(adj: list[np.ndarray], members: set[int], start: int) -> int:
    """Last vertex reached by restricted BFS — an eccentric seed."""
    seen = {start}
    q = deque([start])
    last = start
    while q:
        v = q.popleft()
        last = v
        for w in np.sort(adj[v]):
            w = int(w)
            if w in members and w not in seen:
                seen.add(w)
                q.append(w)
    return last


def bisection_order(adjacency, leaf: int = 64) -> GraphOrder:
    """Recursive graph bisection: pick a far-apart seed pair (double BFS),
    grow two fronts competitively so each half is connected and balanced,
    recurse, and emit each leaf in restricted-BFS order."""
    adj = _as_lists(adjacency)
    n = len(adj)
    out: list[int] = []

    def recurse(members: set[int]) -> None:
        if len(members) <= leaf:
            if members:
                out.extend(_restricted_bfs(adj, members, min(members)))
            return
        a = _far_vertex(adj, members, min(members))
        b = _far_vertex(adj, members, a)
        if a == b:                      # fully disconnected subset
            out.extend(sorted(members))
            return
        half_a: set[int] = {a}
        half_b: set[int] = {b}
        qa, qb = deque([a]), deque([b])
        claimed = {a, b}
        target = len(members) // 2
        while qa or qb:
            # The smaller half grows first -> balanced split.
            grow_a = (len(half_a) <= len(half_b) and qa) or not qb
            q, half = (qa, half_a) if grow_a else (qb, half_b)
            v = q.popleft()
            for w in np.sort(adj[v]):
                w = int(w)
                if w in members and w not in claimed \
                        and len(half) < len(members) - target:
                    claimed.add(w)
                    half.add(w)
                    q.append(w)
        rest = members - claimed
        for v in sorted(rest):          # unreached: to the smaller half
            (half_a if len(half_a) <= len(half_b) else half_b).add(v)
        recurse(half_a)
        recurse(half_b)

    recurse(set(range(n)))
    return GraphOrder.from_inv(np.asarray(out, np.int64), kind="bisection")


def _adjacency_record_bytes(lens: np.ndarray, last: np.ndarray) -> int:
    """Total Elias-Fano record bytes for lists of the given lengths and
    (internal-id) maxima, each at its per-record optimal low width — the
    exact quantity ``encode_record`` produces and ``pack_blocks`` packs
    (see ``codec.elias_fano.record_bytes_for_width``), vectorized over the
    33 candidate widths."""
    lws = np.arange(33, dtype=np.int64)
    m = lens[:, None]
    low = (m * lws[None, :] + 7) // 8
    high = (m + (last[:, None] >> lws[None, :]) + 7) // 8
    per = np.where(lens[:, None] > 0, 2 + low + high, 2)
    return int(per.min(axis=1).sum())


def minla_order(adjacency, medoid: int, sweeps: int = 32) -> GraphOrder:
    """BFS-seeded median/mean placement sweeps (a minimum-linear-arrangement
    heuristic). Each sweep re-sorts vertices by the median (every 4th sweep:
    mean) position of their undirected neighborhood, with the current
    position as a stable tie-break; the best order under the REAL objective
    — total per-record-optimal EF adjacency bytes — is kept. Deterministic:
    no randomness, fixed sweep schedule."""
    adj = _as_lists(adjacency)
    n = len(adj)
    if n == 0:
        return GraphOrder.identity(0)

    # Undirected neighborhoods, padded to a rectangle for vectorized sweeps.
    und: list[set[int]] = [set() for _ in range(n)]
    for u, a in enumerate(adj):
        for w in a:
            w = int(w)
            if 0 <= w < n and w != u:
                und[u].add(w)
                und[w].add(u)
    deg = np.asarray([len(s) for s in und], np.int64)
    width = max(1, int(deg.max()))
    nbr = np.zeros((n, width), np.int64)
    mask = np.zeros((n, width), bool)
    for u, s in enumerate(und):
        k = len(s)
        if k:
            nbr[u, :k] = sorted(s)
            mask[u, :k] = True

    # Objective inputs: list lengths are order-invariant; maxima re-map.
    lens = np.asarray([len(a) for a in adj], np.int64)
    flat = np.concatenate([a for a in adj if len(a)]) \
        if int(lens.sum()) else np.zeros(0, np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)])[:-1][lens > 0]

    def score(perm: np.ndarray) -> int:
        last = np.full(n, 0, np.int64)
        if len(flat):
            last[lens > 0] = np.maximum.reduceat(perm[flat], starts)
        return _adjacency_record_bytes(lens, last)

    inv = bfs_order(adj, medoid).inv
    perm = np.empty(n, np.int64)
    perm[inv] = np.arange(n)
    best_bytes, best_perm = score(perm), perm.copy()
    for it in range(sweeps):
        nbr_pos = np.where(mask, perm[nbr].astype(np.float64), np.nan)
        with np.errstate(invalid="ignore"):
            key = (np.nanmean(nbr_pos, axis=1) if it % 4 == 3
                   else np.nanmedian(nbr_pos, axis=1))
        key = np.where(deg > 0, key, perm.astype(np.float64))
        inv = np.lexsort((perm, key)).astype(np.int64)
        perm = np.empty(n, np.int64)
        perm[inv] = np.arange(n)
        s = score(perm)
        if s < best_bytes:
            best_bytes, best_perm = s, perm.copy()
    order = GraphOrder.from_inv(np.argsort(best_perm, kind="stable"),
                                kind="minla")
    return order


def compute_order(adjacency, medoid: int, kind: str) -> GraphOrder:
    """Ordering factory for the ``order="bfs"`` string shorthands."""
    if kind == "identity":
        return GraphOrder.identity(len(adjacency))
    if kind == "bfs":
        return bfs_order(adjacency, medoid)
    if kind == "bisection":
        return bisection_order(adjacency)
    if kind == "minla":
        return minla_order(adjacency, medoid)
    raise ValueError(f"unknown ordering kind {kind!r}; expected one "
                     f"of {KINDS}")


# ---------------------------------------------------------------------------
# Applying an order
# ---------------------------------------------------------------------------

def apply_order(adjacency, order: GraphOrder) -> list[np.ndarray]:
    """Relabel a whole adjacency structure into internal-id space:
    ``out[i]`` is the sorted internal-id neighbor list of the vertex stored
    at internal position ``i`` (external id ``order.inv[i]``)."""
    adj = _as_lists(adjacency)
    return [np.sort(order.perm[adj[int(ext)]]) for ext in order.inv]


def relabel_graph(graph: VamanaGraph, order: GraphOrder) -> VamanaGraph:
    """A fully relabeled :class:`VamanaGraph` (device-pipeline form): feed
    it ``vectors[order.inv]`` / ``codes[order.inv]`` and un-map search
    results with ``order.to_external``."""
    adj = [a.astype(np.int32) for a in apply_order(graph.adjacency, order)]
    return VamanaGraph(adjacency=adj, medoid=int(order.perm[graph.medoid]),
                       r=graph.r)


# ---------------------------------------------------------------------------
# Locality metrics (bench reporting)
# ---------------------------------------------------------------------------

def gap_bits(adjacency) -> float:
    """Mean ``ceil(log2(gap + 1))`` over all within-list gaps of the sorted
    lists — the quantity gap codecs pay per id. Reordering is exactly the
    transform that shrinks it."""
    total_bits, total = 0, 0
    for a in adjacency:
        a = np.sort(np.asarray(a, np.int64))
        if len(a) < 2:
            continue
        gaps = np.diff(a)
        total_bits += int(np.ceil(np.log2(gaps + 1)).sum())
        total += len(gaps)
    return total_bits / max(1, total)
