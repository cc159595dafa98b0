"""The benchmark's inputs, made on the device from the seed.

Vectors, graph, PQ codebook and query pool are drawn here with
``torch.Generator``s on the device, in a few large calls, so the program
under test receives only generated inputs. For a given seed every tensor
is the same bit for bit from run to run: the draws are seeded per purpose,
sums that decide a value are exact (integers, or fixed point), and every
top-k selects on unique keys (the distance's bits with the column below
them), so no tie is left to a kernel's order.

**Data.** A mixture of ``n / cluster_size`` equal clusters whose centres lie
in a ``latent_dim``-dimensional space, mapped to the configuration's width
by one fixed random projection, plus full-width noise. Vertex ids are a
random permutation of the clusters' rows, as ids in a real shard are in
insertion order, not in cluster order. ``uint8`` rows (SIFT's gradient
bins) are the non-negative part of the projection, scaled and rounded, so
many bins are zero; ``float32`` rows (DEEP's CNN descriptors) are
L2-normalised and left unrounded.

**Graph.** R out-edges a vertex: the ``R - long_links`` nearest rows by
exact squared distance among its own cluster and its ``near_clusters``
nearest clusters (batched GEMMs, a batch of clusters at a time), and
``long_links`` links to random rows of farther clusters, so that the graph
stays connected and a greedy search can cross the space. The far links
are Kleinberg's small world: link j of a vertex goes to the cluster at a
rank (by centre distance from its own) drawn log-uniformly from the j-th of
``long_links`` equal bands of log-rank between the nearest clusters and
the farthest, so every scale of distance has a link and greedy routing
takes few hops. Repeats and the vertex itself are dropped and the next
nearest rows fill in, so every list has R distinct ids. The entry vertex
is the medoid (the row nearest the mean). This is not a Vamana build,
whose pruning leaves long edges of its own.

**Codebook.** Lloyd's k-means of each PQ sub-space on a sample of rows,
from sampled rows as the first centres, with exact fixed-point sums.

**Queries.** ``query_pool`` rows drawn from the same mixture with a seed
of their own, as float32 on the host.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import numpy as np

from .frozen.shard import medoid_of

_FIXED = float(1 << 20)     # fixed-point scale of the k-means sums


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose of one run seed."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def dtype_of(torch, cfg: dict):
    return {"uint8": torch.uint8, "float32": torch.float32}[cfg["dtype"]]


@dataclass
class World:
    vectors: object         # [n, D] the config's dtype, on the device
    graph: object           # [n, R] int32 neighbour ids, on the device
    medoid: int
    centroids: object       # [M, K, dsub] float32, on the device, or None
    queries: np.ndarray     # [query_pool, D] float32, on the host


class _Space:
    """The mixture: cluster centres, projection, id permutation."""

    def __init__(self, torch, cfg: dict, seed: int, device):
        gen = cfg["assumed"]["generator"]
        self.torch, self.cfg, self.gen = torch, cfg, gen
        self.n, self.dim = cfg["n_vectors"], cfg["dim"]
        self.size = gen["cluster_size"]
        if self.n % self.size:
            raise ValueError(f"n_vectors {self.n} is not a whole number of "
                             f"clusters of {self.size}")
        self.n_clusters = self.n // self.size
        self.device, self.seed = device, seed
        g = self.rng("space")
        self.centres = torch.randn((self.n_clusters, gen["latent_dim"]),
                                   generator=g, device=device)
        self.proj = torch.randn((gen["latent_dim"], self.dim), generator=g,
                                device=device) / math.sqrt(gen["latent_dim"])
        self.perm = torch.randperm(self.n, generator=self.rng("ids"),
                                   device=device)

    def rng(self, tag: str):
        return self.torch.Generator(device=self.device).manual_seed(
            subseed(self.seed, tag))

    def rows(self, cluster, g):
        """Rows drawn from the clusters ``cluster`` [m] -> [m, D]."""
        torch, gen = self.torch, self.gen
        z = self.centres[cluster] + gen["cluster_spread"] * torch.randn(
            (cluster.shape[0], self.centres.shape[1]), generator=g,
            device=self.device)
        y = z @ self.proj + gen["noise"] * torch.randn(
            (cluster.shape[0], self.dim), generator=g, device=self.device)
        if self.cfg["dtype"] == "uint8":
            return (y.clamp_(min=0) * gen["scale"]).round_().clamp_(
                max=255).to(torch.uint8)
        return y / torch.linalg.vector_norm(y, dim=1, keepdim=True)

    def vectors(self):
        torch = self.torch
        out = torch.empty((self.n, self.dim), dtype=dtype_of(torch, self.cfg),
                          device=self.device)
        g = self.rng("rows")
        step = max(1, (1 << 21) // self.size) * self.size
        for a in range(0, self.n, step):
            b = min(a + step, self.n)
            cluster = torch.arange(a, b, device=self.device) // self.size
            out[self.perm[a:b]] = self.rows(cluster, g)
        return out

    def queries(self, count: int) -> np.ndarray:
        torch = self.torch
        g = self.rng("queries")
        cluster = torch.randint(0, self.n_clusters, (count,), generator=g,
                                device=self.device)
        return self.rows(cluster, g).float().cpu().numpy()


def _keys(torch, d):
    """Unique int64 keys ordering ``d`` (>= 0 floats) by value, then by
    column."""
    col = torch.arange(d.shape[-1], device=d.device)
    return (d.clamp(min=0).view(torch.int32).to(torch.int64) << 24) | col


def cluster_links(torch, space: "_Space", rows: int = 2048):
    """(each cluster's ``near_clusters`` nearest other clusters [C, k];
    each vertex's ``long_links`` far link targets [n, long_links]), both
    by centre distance (see the module's docstring)."""
    gen, centres, size = space.gen, space.centres, space.size
    c, k, n_long = space.n_clusters, gen["near_clusters"], gen["long_links"]
    dev = centres.device
    sq = (centres * centres).sum(1)
    near = torch.empty((c, k), dtype=torch.int64, device=dev)
    far = torch.empty((space.n, n_long), dtype=torch.int32, device=dev)
    members = space.perm.view(c, size)
    lo, hi = math.log(k + 1), math.log(c - 1)
    band = torch.arange(n_long, device=dev)
    g = space.rng("far")
    for a in range(0, c, rows):
        b = min(a + rows, c)
        d = sq[a:b, None] + sq[None] - 2 * centres[a:b] @ centres.T
        d[torch.arange(b - a), torch.arange(a, b)] = float("inf")
        order = torch.sort(_keys(torch, d), dim=1).indices       # [b-a, C]
        near[a:b] = order[:, :k]
        u = (band + torch.rand((b - a, size, n_long), generator=g,
                               device=dev)) / n_long
        rank = torch.exp(lo + u * (hi - lo)).long().clamp(max=c - 2)
        target = torch.gather(order, 1, rank.reshape(b - a, -1))
        row = torch.randint(0, size, target.shape, generator=g, device=dev)
        far[members[a:b].reshape(-1)] = members[target, row].reshape(
            -1, n_long).to(torch.int32)
    return near, far


def build_graph(torch, space: _Space, vectors):
    """[n, R] int32 neighbour ids (see the module's docstring)."""
    cfg, gen = space.cfg, space.gen
    n, size, r = space.n, space.size, cfg["r"]
    k_near = gen["near_clusters"]
    dev = vectors.device
    near, far_all = cluster_links(torch, space)
    clusters = torch.cat([torch.arange(space.n_clusters, device=dev)[:, None],
                          near], 1)                        # self first
    members = space.perm.view(space.n_clusters, size)
    width = (1 + k_near) * size
    batch = max(1, gen["graph_batch_elems"] // (size * width))
    graph = torch.empty((n, r), dtype=torch.int32, device=dev)
    own = torch.arange(size, device=dev)
    for c0 in range(0, space.n_clusters, batch):
        c1 = min(c0 + batch, space.n_clusters)
        b = c1 - c0
        mem = members[c0:c1]                                   # [b, S]
        cand = members[clusters[c0:c1]].reshape(b, width)      # [b, 5S]
        xm = vectors[mem].float()
        xc = vectors[cand].float()
        d = ((xm * xm).sum(-1)[:, :, None] + (xc * xc).sum(-1)[:, None, :]
             - 2 * torch.bmm(xm, xc.transpose(1, 2)))
        d[:, own, own] = float("inf")                          # itself
        top = torch.topk(_keys(torch, d), r, dim=-1, largest=False).indices
        nearest = torch.gather(cand, 1, top.reshape(b, -1)).reshape(b * size,
                                                                    r)
        me = mem.reshape(-1, 1)
        lists = torch.cat([far_all[me[:, 0]].long(), nearest], 1)
        srt, order = torch.sort(lists, dim=1, stable=True)
        again = torch.zeros_like(srt, dtype=torch.bool)
        again[:, 1:] = srt[:, 1:] == srt[:, :-1]
        keep = ~torch.zeros_like(again).scatter_(1, order, again) \
            & (lists != me)
        keep &= keep.cumsum(1) <= r
        graph[me[:, 0]] = lists[keep].reshape(-1, r).to(torch.int32)
    return graph


def train_codebook(torch, space: _Space, vectors):
    """[M, K, dsub] float32 PQ centroids by k-means on a sample."""
    cfg, gen = space.cfg, space.gen
    m, k = cfg["pq_m"], cfg["pq_k"]
    dsub = cfg["dim"] // m
    g = space.rng("codebook")
    pick = torch.randperm(space.n, generator=g, device=vectors.device)
    x = vectors[pick[:gen["pq_sample"]]].float()
    s = x.shape[0]
    xs = x.reshape(s, m, dsub).transpose(0, 1).contiguous()    # [M, S, ds]
    fixed = torch.round(xs * _FIXED).to(torch.int64)
    first = torch.randperm(s, generator=g, device=vectors.device)[:k]
    cent = xs[:, first].clone()                                # [M, K, ds]
    flat = (torch.arange(m, device=x.device) * k)[:, None]
    for _ in range(gen["pq_iters"]):
        assign = torch.empty((m, s), dtype=torch.int64, device=x.device)
        for a in range(0, m, 4):
            diff = xs[a:a + 4, :, None, :] - cent[a:a + 4, None]
            assign[a:a + 4] = (diff * diff).sum(-1).argmin(-1)
        idx = (assign + flat).reshape(-1)
        sums = torch.zeros((m * k, dsub), dtype=torch.int64, device=x.device)
        sums.index_add_(0, idx, fixed.reshape(-1, dsub))
        count = torch.zeros(m * k, dtype=torch.int64, device=x.device)
        count.index_add_(0, idx, torch.ones_like(idx))
        mean = (sums.double() / _FIXED / count.clamp(min=1)[:, None]).float()
        cent = torch.where((count > 0)[:, None], mean,
                           cent.reshape(m * k, dsub)).reshape(m, k, dsub)
    return cent.contiguous()


def make_world(torch, cfg: dict, seed: int, device, codebook: bool = True,
               clock=None) -> World:
    """Every input of a run of ``cfg`` for ``seed`` on ``device``;
    ``clock(part)``, if given, is called after each part."""
    clock = clock or (lambda part: None)
    space = _Space(torch, cfg, seed, device)
    vectors = space.vectors()
    clock("vectors")
    graph = build_graph(torch, space, vectors)
    clock("graph")
    medoid = medoid_of(torch, vectors)
    centroids = train_codebook(torch, space, vectors) if codebook else None
    clock("codebook")
    world = World(vectors=vectors, graph=graph, medoid=medoid,
                  centroids=centroids,
                  queries=space.queries(cfg["query_pool"]))
    clock("queries")
    return world
