"""Plain reference of one shard's search (paper §3.4), for ``correct``.

Straight PyTorch over the benchmark's own inputs: the vectors, the graph
as an ``[n, R]`` table of neighbour ids, the PQ codebook and the entry
vertex. It imports nothing of the program and takes nothing the program
made: the PQ codes are encoded here again, and the graph is read from
the input table, not from Elias-Fano slots.

The search it runs is the one the deployment states:

- per-query ADC tables, each squared sub-distance folded over the
  sub-space's dimensions in order;
- a beam of ``l_size`` candidates seeded with the entry vertex; each round
  expands the ``beam_width`` nearest unexpanded candidates, reads their
  lists, keeps each neighbour once, drops those the visited set holds
  (an open-addressing table of ``2**visited_hash_bits`` slots a query,
  multiplicative hash, the last writer of a slot keeps it), scores the
  rest by ADC (the code bytes' table entries folded in sub-space order)
  and keeps the ``l_size`` nearest, ties to the earlier entry;
- a query stops when no candidate is left unexpanded or after
  ``max_iters`` rounds;
- the re-rank reads exact squared distances (folded over the dimensions
  in order) of the first ``k`` candidates, then of batches of
  ``rerank_batch``, and stops one batch after a batch moves fewer than
  ``benefit_threshold`` of its rows into the top ``k``.

``dtype`` is the precision of the tables and distances: float32 as the
deployment states, or a lower one for the control.
"""
from __future__ import annotations

import torch

_HASH = 2654435761


def encode(rows: torch.Tensor, centroids: torch.Tensor,
           chunk: int = 1 << 15, dtype=torch.float32) -> torch.Tensor:
    """PQ codes of ``rows``: per sub-space the first centroid at least
    squared distance -> [len(rows), M] uint8."""
    m, k, dsub = centroids.shape
    c = centroids.to(dtype)
    out = torch.empty((rows.shape[0], m), dtype=torch.uint8,
                      device=rows.device)
    for a in range(0, rows.shape[0], chunk):
        x = rows[a:a + chunk].to(dtype).reshape(-1, m, 1, dsub)
        diff = x - c[None]
        sq = diff * diff
        acc = sq[..., 0].clone()
        for s in range(1, dsub):
            acc += sq[..., s]
        out[a:a + chunk] = acc.argmin(-1).to(torch.uint8)
    return out


class Codes:
    """The PQ codes of a table, encoded when a row is first read."""

    def __init__(self, table, centroids, dtype=torch.float32):
        self.table, self.centroids, self.dtype = table, centroids, dtype
        n, m = table.shape[0], centroids.shape[0]
        self.codes = torch.zeros((n, m), dtype=torch.uint8,
                                 device=table.device)
        self.known = torch.zeros(n, dtype=torch.bool, device=table.device)

    def __getitem__(self, ids: torch.Tensor) -> torch.Tensor:
        need = torch.unique(ids[~self.known[ids]])
        if need.numel():
            self.codes[need] = encode(self.table[need], self.centroids,
                                      dtype=self.dtype)
            self.known[need] = True
        return self.codes[ids]


def tables(queries: torch.Tensor, centroids: torch.Tensor,
           dtype=torch.float32) -> torch.Tensor:
    """ADC tables [nq, M, K]."""
    m, k, dsub = centroids.shape
    diff = (queries.to(dtype).reshape(-1, m, 1, dsub)
            - centroids.to(dtype)[None])
    sq = diff * diff
    acc = sq[..., 0].clone()
    for s in range(1, dsub):
        acc += sq[..., s]
    return acc


def _smallest(x: torch.Tensor, k: int):
    """k smallest of each row, ties to the lower column."""
    v, i = torch.sort(x, dim=1, stable=True)
    return v[:, :k], i[:, :k]


def search(table, graph, centroids, entry: int, queries, cfg: dict,
           dtype=torch.float32, codes: Codes | None = None):
    """queries [nq, D] float32 -> (ids [nq, k] int64, dists [nq, k] as
    float32, rounds [nq] int32). ``codes`` may carry the codes a search
    of the same table and precision encoded."""
    codes = codes or Codes(table, centroids, dtype)
    dev = queries.device
    n, nq = table.shape[0], queries.shape[0]
    L, W, K, B = cfg["l_size"], cfg["beam_width"], cfg["k"], \
        cfg["rerank_batch"]
    bits = cfg["visited_hash_bits"]
    H = 1 << bits
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    lut = tables(queries, centroids, dtype)
    rows = torch.arange(nq, device=dev)

    def adc(ids):
        c = codes[ids.clamp(0, n - 1).long()].long()          # [nq, E, M]
        acc = torch.gather(lut[:, 0, :], 1, c[..., 0])
        for j in range(1, c.shape[2]):
            acc = acc + torch.gather(lut[:, j, :], 1, c[..., j])
        return torch.where(ids >= 0, acc, inf)

    def slot(ids):
        return ((ids.long().clamp(min=0) * _HASH) & 0xFFFFFFFF) >> (32 - bits)

    first = torch.full((nq, 1), entry, dtype=torch.int64, device=dev)
    ids = torch.full((nq, L), -1, dtype=torch.int64, device=dev)
    ids[:, :1] = first
    dist = torch.full((nq, L), float("inf"), dtype=dtype, device=dev)
    dist[:, :1] = adc(first)
    seen = torch.full((nq, H + 1), -1, dtype=torch.int64, device=dev)
    seen[rows, slot(first[:, 0])] = entry
    done = torch.zeros((nq, L), dtype=torch.bool, device=dev)
    rounds = torch.zeros(nq, dtype=torch.int32, device=dev)
    while True:
        open_ = (ids >= 0) & ~done
        live = open_.any(1) & (rounds < cfg["max_iters"])
        if not bool(live.any()):
            break
        pick_d, pick = _smallest(
            torch.where(open_ & live[:, None], dist, inf), W)
        picked = torch.where(torch.isfinite(pick_d),
                             torch.gather(ids, 1, pick), -1)
        done.scatter_(1, pick, torch.gather(done, 1, pick) | (picked >= 0))
        lists = graph[picked.clamp(min=0)].long()              # [nq, W, R]
        lists = torch.where(picked[..., None] >= 0, lists, -1)
        nb = torch.sort(lists.reshape(nq, -1), dim=1).values
        once = torch.ones_like(nb, dtype=torch.bool)
        once[:, 1:] = nb[:, 1:] != nb[:, :-1]
        nb = torch.where(once, nb, -1)
        s = slot(nb)
        fresh = (nb >= 0) & (torch.gather(seen, 1, s) != nb)
        # the last fresh entry of a row that hashes to a slot keeps it
        key = torch.where(fresh, s, H)
        sk, order = torch.sort(key, dim=1, stable=True)
        last = torch.ones_like(fresh)
        last[:, :-1] = sk[:, 1:] != sk[:, :-1]
        keep = torch.zeros_like(fresh).scatter_(1, order, last) & fresh
        seen.scatter_(1, torch.where(keep, s, H), torch.where(keep, nb, -1))
        new = torch.where(fresh, nb, -1)
        dist, top = _smallest(torch.cat([dist, adc(new)], 1), L)
        ids = torch.gather(torch.cat([ids, new], 1), 1, top)
        done = torch.gather(torch.cat([done, torch.zeros_like(fresh)], 1),
                            1, top)
        rounds += live.to(torch.int32)
    return _rerank(table, queries, ids, cfg, dtype) + (rounds,)


def _rerank(table, queries, cand, cfg, dtype):
    n, nq = table.shape[0], queries.shape[0]
    K, B = cfg["k"], cfg["rerank_batch"]
    inf = torch.tensor(float("inf"), dtype=dtype, device=queries.device)
    q = queries.to(dtype)

    def exact(ids):
        x = table[ids.clamp(0, n - 1)].to(dtype)               # [nq, c, D]
        diff = x - q[:, None, :]
        sq = diff * diff
        acc = sq[..., 0].clone()
        for j in range(1, sq.shape[2]):
            acc += sq[..., j]
        return torch.where(ids >= 0, acc, inf)

    heap, heap_d = cand[:, :K], exact(cand[:, :K])
    go = torch.ones(nq, dtype=torch.bool, device=queries.device)
    stop_next = torch.zeros_like(go)
    n_batches = min(cfg["max_rerank_batches"],
                    max(0, (cfg["l_size"] - K) // B))
    b = 0
    while b < n_batches and bool(go.any()):
        nxt = cand[:, K + b * B:K + (b + 1) * B]
        d = torch.where(go[:, None], exact(nxt), inf)
        new_d, top = _smallest(torch.cat([heap_d, d], 1), K)
        new_ids = torch.gather(torch.cat([heap, nxt], 1), 1, top)
        moved = (top >= K).sum(1).to(torch.float32) / B
        low = moved < cfg["benefit_threshold"]
        heap = torch.where(go[:, None], new_ids, heap)
        heap_d = torch.where(go[:, None], new_d, heap_d)
        go, stop_next = go & (~stop_next | ~low), torch.where(go, low,
                                                              stop_next)
        b += 1
    d, order = torch.sort(heap_d, dim=1, stable=True)
    return torch.gather(heap, 1, order), d.to(torch.float32)
