"""Sharded ANNS over 8-32 shards — the port of
``repro.core.distributed.sharded_index``.

The dataset is partitioned — contiguous id ranges or balanced k-means
clusters — into one Vamana sub-graph + PQ codes per shard, stacked on a
leading shard axis (:class:`ShardedIndex`). A query batch is replicated;
each shard runs the batch-first beam search (``search_batched``), then the
per-shard top-K candidates meet in one of two merges
(:func:`make_sharded_search`):

- **flat**: one all-gather of K rows per shard + a global top-K over the
  K·S gathered candidates (gathered rows grow linearly in S);
- **hierarchical** (default): a butterfly merge per mesh axis, innermost
  axis first — each of the log2(S_axis) steps exchanges only K
  already-reduced rows with the XOR partner, so a shard receives
  K·Σ log2(S_axis) rows instead of K·S (:func:`merge_comm_rows`).
  Axes whose size is not a power of two take the flat merge for that axis
  only.

The reference runs this as one ``shard_map`` program. Here it is a
per-shard program over a small exchange (all-gather, XOR-partner swap) with
two forms of :class:`Mesh`, which run the same steps and give the same rows
bit for bit:

- **stacked** (:func:`make_mesh`): all S shards on one device, searched one
  after another; the all-gather is the stacked tensor itself and the swap
  an ``index_select`` along the shard axis. This is the form one GPU runs.
- **process group** (:func:`make_process_mesh`): one shard per rank of a
  ``torch.distributed`` process group (NCCL on GPUs, gloo on the CPU), one
  subgroup per mesh axis; the all-gather is ``all_gather_into_tensor`` and
  the swap ``batch_isend_irecv`` with the partner.

**Selective shard routing** (SPANN's closest-posting-list pruning): a
replicated :class:`ShardRouter` — per-shard k-means centroids over the
shard's own rows — scores shards per query; only the top
``ceil(route_frac * S)`` shards keep their candidates, the rest contribute
(-1, +inf) rows. Routing only preserves recall when the partition is
*clustered* (``partition="cluster"``).

Local ids translate to global ids through ``ShardedIndex.row_ids`` (-1 marks
the pad rows that fill the last shard to a uniform size), so pad rows are
masked out of every merge. The serving tier (``serve/ann.py``) fans a batch
out shard by shard on one device and merges on the host instead.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...kernels.beam_step.beam_step import stable_smallest
from ..index import build_device_index
from ..search.beam import (DeviceIndex, SearchParams, resolve_device,
                           search_batched)


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


# ------------------------------------------------------------------- meshes
class Mesh(NamedTuple):
    """The shard axes of a sharded search, row-major: ``axis_names`` with
    ``axis_sizes`` (S shards, their product). ``groups`` None is the
    stacked form: all S shards on ``device`` in one process. Otherwise the
    process-group form: this process holds shard ``rank`` (its coordinates
    row-major over the axes) and ``groups[a]`` is the subgroup of the ranks
    that differ from it only along axis a, in coordinate order."""
    axis_names: tuple
    axis_sizes: tuple
    device: torch.device
    groups: tuple | None = None
    rank: int = 0

    @property
    def n_shards(self) -> int:
        return int(np.prod(self.axis_sizes))


def _axes(axis_sizes, axis_names) -> tuple[tuple, tuple]:
    sizes = tuple(int(s) for s in np.atleast_1d(axis_sizes))
    names = (axis_names,) if isinstance(axis_names, str) \
        else tuple(axis_names)
    if len(sizes) != len(names) or min(sizes) < 1:
        raise ValueError(f"mesh axes {names} do not match sizes {sizes}")
    return sizes, names


def make_mesh(axis_sizes, axis_names=("data",), device=None) -> Mesh:
    """The stacked form: S = prod(axis_sizes) shards on one ``device``
    (None = the card), searched one after another in this process."""
    sizes, names = _axes(axis_sizes, axis_names)
    return Mesh(names, sizes, resolve_device(device))


def make_process_mesh(axis_sizes, axis_names=("data",),
                      device=None) -> Mesh:
    """The process-group form: one shard per rank of the initialised
    default process group (its world size must be S), on ``device``
    (None = the card of index ``rank % device_count``). Every rank calls
    it, in the same order: it creates one subgroup per line of each axis."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_process_mesh needs an initialised "
                           "process group (torch.distributed."
                           "init_process_group)")
    sizes, names = _axes(axis_sizes, axis_names)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != int(np.prod(sizes)):
        raise ValueError(f"a mesh of {sizes} needs {int(np.prod(sizes))} "
                         f"ranks, the process group has {world}")
    if device is None:
        resolve_device(None)                    # raises without a card
        device = torch.device("cuda", rank % torch.cuda.device_count())
    coords = np.arange(world).reshape(sizes)
    groups = []
    for a, size in enumerate(sizes):
        mine = None
        for line in np.moveaxis(coords, a, -1).reshape(-1, size):
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                mine = group
        groups.append(mine)
    return Mesh(names, sizes, torch.device(device), tuple(groups), rank)


def place_on_mesh(index: ShardedIndex, mesh: Mesh) -> ShardedIndex:
    """The shards this process holds, on the mesh's device: all of them in
    the stacked form, shard ``rank`` (a leading axis of 1) in the
    process-group form."""
    if mesh.groups is None:
        return ShardedIndex(*(t.to(mesh.device) for t in index))
    r = mesh.rank
    return ShardedIndex(*(t[r:r + 1].to(mesh.device) for t in index))


class _StackedExchange:
    """The exchange of the stacked form: [S, ...] tensors on one device,
    shard s at coordinates ``unravel(s, sizes)``; each exchange is one
    ``index_select`` along the shard axis."""

    def __init__(self, sizes: tuple, device: torch.device):
        self.sizes = sizes
        self.flat = torch.arange(int(np.prod(sizes)), device=device)

    def _coord(self, a: int):
        stride = int(np.prod(self.sizes[a + 1:]))
        return (self.flat // stride) % self.sizes[a], stride

    def all_gather(self, x, a: int):
        """[S, ...] -> [S, size_a, ...]: each shard gets the rows of every
        shard on its line along axis a, in coordinate order."""
        c, stride = self._coord(a)
        size = self.sizes[a]
        j = torch.arange(size, device=c.device)
        idx = self.flat[:, None] + (j[None] - c[:, None]) * stride
        return x.index_select(0, idx.reshape(-1)).reshape(
            (len(self.flat), size) + x.shape[1:])

    def swap(self, x, a: int, step: int):
        """[S, ...] -> [S, ...]: each shard gets its XOR partner's rows
        (coordinate c -> c ^ step along axis a)."""
        c, stride = self._coord(a)
        return x.index_select(0, self.flat + ((c ^ step) - c) * stride)


class _GroupExchange:
    """The exchange of the process-group form: [1, ...] tensors, one shard
    per rank, one subgroup per axis."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def all_gather(self, x, a: int):
        import torch.distributed as dist
        x = x.contiguous()
        out = x.new_empty((self.mesh.axis_sizes[a],) + x.shape[1:])
        dist.all_gather_into_tensor(out, x, group=self.mesh.groups[a])
        return out[None]

    def swap(self, x, a: int, step: int):
        import torch.distributed as dist
        group = self.mesh.groups[a]
        me = dist.get_group_rank(group, self.mesh.rank)
        peer = dist.get_global_rank(group, me ^ step)
        x = x.contiguous()
        buf = torch.empty_like(x)
        for work in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, x, peer, group),
                 dist.P2POp(dist.irecv, buf, peer, group)]):
            work.wait()
        return buf


# ------------------------------------------------------------------- merges
def merge_comm_rows(k: int, axis_sizes, mode: str = "hier") -> int:
    """(id, dist) rows RECEIVED per shard during the merge — the comm model
    that ``engine.shard_merge_cost_us`` prices. flat: K·S. hier:
    K·Σ log2(axis) (butterfly), non-power-of-two axes priced flat for that
    axis."""
    sizes = [int(s) for s in (axis_sizes if np.ndim(axis_sizes) else
                              [axis_sizes])]
    if mode == "flat":
        return k * int(np.prod(sizes))
    rows = 0
    for s in sizes:
        if s <= 1:
            continue
        rows += k * s if s & (s - 1) else k * int(round(np.log2(s)))
    return rows


def _lex_topk(ids, d, k):
    """[..., M] candidates -> top-k by (distance, id) lexicographic order —
    the deterministic tie-break every merge stage shares, so the final
    top-K is independent of merge topology (flat vs tree, any axis order).
    Pad rows (id -1, dist +inf) sink to the tail. Two stable sorts: by id
    (-1 as INT32_MAX), then by distance."""
    big = torch.iinfo(torch.int32).max
    order = torch.sort(torch.where(ids < 0, big, ids), dim=-1,
                       stable=True).indices
    ids, d = ids.gather(-1, order), d.gather(-1, order)
    order = torch.sort(d, dim=-1, stable=True).indices
    return ids.gather(-1, order)[..., :k], d.gather(-1, order)[..., :k]


def _pack(ids, d):
    """(ids, dists) -> one int32 tensor (the dists' bits), one exchange."""
    return torch.cat([ids, d.view(torch.int32)], -1)


def _unpack(rows, k):
    return rows[..., :k], rows[..., k:].view(torch.float32)


def _merge_axis_flat(ids, d, ex, a, k):
    rows = ex.all_gather(_pack(ids, d), a)              # [S, s, Q, 2K]
    all_i, all_d = _unpack(rows, ids.shape[-1])
    s, _, q = all_i.shape[:3]
    return _lex_topk(all_i.transpose(1, 2).reshape(s, q, -1),
                     all_d.transpose(1, 2).reshape(s, q, -1), k)


def _merge_axis_tree(ids, d, ex, a, size, k):
    """Butterfly (recursive-doubling) top-K on one mesh axis: log2(size)
    steps with the XOR partner, each exchanging only the K already-reduced
    rows; afterwards every shard on the axis holds the identical
    axis-global top-K."""
    step = 1
    while step < size:
        o_ids, o_d = _unpack(ex.swap(_pack(ids, d), a, step), ids.shape[-1])
        ids, d = _lex_topk(torch.cat([ids, o_ids], -1),
                           torch.cat([d, o_d], -1), k)
        step *= 2
    return ids, d


def merge_sharded(gids, dists, mesh: Mesh, k: int, merge: str = "hier"):
    """The merge of :func:`make_sharded_search`: [S_here, Q, K] global ids
    (int32) + distances of the shards this process holds (all S stacked,
    or one a rank) -> the global top-``k`` [Q, k], the same on every shard.
    Innermost (last) axis first: candidates are reduced to K per node
    before any cross-node exchange."""
    if merge not in ("hier", "flat"):
        raise ValueError(f"merge must be 'hier' or 'flat', got {merge!r}")
    ex = _StackedExchange(mesh.axis_sizes, gids.device) \
        if mesh.groups is None else _GroupExchange(mesh)
    for a in reversed(range(len(mesh.axis_sizes))):
        size = mesh.axis_sizes[a]
        if merge == "hier" and size & (size - 1) == 0:
            gids, dists = _merge_axis_tree(gids, dists, ex, a, size, k)
        else:
            gids, dists = _merge_axis_flat(gids, dists, ex, a, k)
    return gids[0], dists[0]


def shard_topk(index: ShardedIndex, queries: torch.Tensor, p: SearchParams):
    """Each held shard's local search (``search_batched``, one shard after
    another) with its ids made global -> ([S_here, Q, K] int32 global ids,
    [S_here, Q, K] distances). Pad rows (row_id -1) and empty result slots
    land at (-1, +inf), so they never outrank a real candidate."""
    out_i, out_d = [], []
    for i in range(index.pq_codes.shape[0]):
        local = DeviceIndex(
            neighbors=index.neighbors[i], counts=index.counts[i],
            ef_slots=index.ef_slots[i], pq_codes=index.pq_codes[i],
            pq_centroids=index.pq_centroids[i], vectors=index.vectors[i],
            medoid=index.medoid[i])
        ids, dists, _ = search_batched(local, queries, p, queries.device)
        rids = index.row_ids[i]
        gids = torch.where(
            ids >= 0, rids[ids.clamp(0, rids.shape[0] - 1).long()], -1)
        out_i.append(gids)
        out_d.append(torch.where(gids >= 0, dists, torch.inf))
    return torch.stack(out_i), torch.stack(out_d)


def make_sharded_search(mesh: Mesh, p: SearchParams, merge: str = "hier",
                        router: ShardRouter = None, route_frac: float = 1.0):
    """-> search(index, queries [Q, d]) -> (ids [Q, K] int32, dists [Q, K]),
    where ``index`` is :func:`place_on_mesh`'s: local search
    (:func:`shard_topk`) -> routing mask -> :func:`merge_sharded`.

    The shards lie row-major over the mesh's axes (the reference's
    ``axis``). ``merge="hier"`` runs the butterfly merge per axis,
    innermost first; ``"flat"`` is the K·S all-gather. With a
    ``router``, each query's candidates are masked to its top
    ``ceil(route_frac * S)`` shards before the merge (``route_frac=1.0``
    is bit-identical to no router). In the process-group form every rank
    calls the search with the same queries and gets the same rows.
    """
    if merge not in ("hier", "flat"):
        raise ValueError(f"merge must be 'hier' or 'flat', got {merge!r}")
    stacked = mesh.groups is None
    cents = None if router is None else \
        torch.as_tensor(router.centroids).to(mesh.device)
    mine = torch.arange(mesh.n_shards, device=mesh.device) if stacked \
        else torch.tensor([mesh.rank], device=mesh.device)

    def run(index: ShardedIndex, queries):
        held = index.pq_codes.shape[0]
        if held != (mesh.n_shards if stacked else 1):
            raise ValueError(f"index holds {held} shards; place it with "
                             f"place_on_mesh for this mesh")
        q = torch.as_tensor(queries, dtype=torch.float32).to(mesh.device)
        gids, d = shard_topk(index, q, p)
        if cents is not None:
            keep = route_mask(cents, q, route_frac)[:, mine].T[..., None]
            gids = torch.where(keep, gids, -1)
            d = torch.where(keep, d, torch.inf)
        return merge_sharded(gids, d, mesh, p.k, merge)
    return run


# ------------------------------------------------------- production dry-run
def lower_production_search(mesh, ann_cfg, p: SearchParams | None = None,
                            merge: str = "hier") -> dict:
    """Shape-only pass of the paper's own workload on the production mesh
    (the ``decouplevs-ann`` dry-run cell): the ``ShardedIndex`` one rank
    holds as ``meta`` tensors (one shard: EF graph slots, PQ codes and
    codebook, rerank vectors, row ids; the raw-adjacency ablation tensor
    a 1-entry stub), with the reference's per-shard shapes, and the
    replicated query batch. No allocation.

    The dataset shards over EVERY mesh axis (traversal keeps the ``model``
    axis idle, so using it for shards multiplies aggregate HBM): 1B
    vectors over 256/512 shards. Returns, per rank, each tensor's shape,
    dtype and bytes and their total, the merge's rows received per query
    (``merge_comm_rows``) and its modeled µs (``shard_merge_cost_us``).

    Nothing is traced: the port's traversal is a host loop that reads a
    flag from the device each hop (``core/search/beam.py``), which a
    ``meta`` tensor cannot answer, so the search's FLOPs and bytes are not
    counted here. ``p`` (default: the reference's production
    SearchParams) is returned with the shapes."""
    from ..codec.elias_fano import slot_layout
    from ..search.engine import shard_merge_cost_us
    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(int(x) for x in mesh.shape)
    n_shards = int(np.prod(sizes))
    per = -(-ann_cfg.n_vectors // n_shards)
    p = p or SearchParams(l_size=ann_cfg.l_size, beam_width=ann_cfg.beam_width,
                          k=ann_cfg.k, rerank_batch=ann_cfg.rerank_batch,
                          r_max=ann_cfg.r, universe=per, max_iters=64,
                          use_ef=True, visited_hash_bits=15)
    _, _, _, slot_words = slot_layout(ann_cfg.r, per)
    dt = getattr(torch, ann_cfg.dtype)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    index = ShardedIndex(
        neighbors=meta((1, 1, ann_cfg.r), torch.int32),
        counts=meta((1, per), torch.int32),
        ef_slots=meta((1, per, slot_words), torch.int32),
        pq_codes=meta((1, per, ann_cfg.pq_m), torch.uint8),
        pq_centroids=meta((1, ann_cfg.pq_m, 256, ann_cfg.dim // ann_cfg.pq_m),
                          torch.float32),
        vectors=meta((1, per, ann_cfg.dim), dt),
        medoid=meta((1,), torch.int64),
        row_ids=meta((1, per), torch.int32))
    tensors = dict(index._asdict(),
                   queries=meta((ann_cfg.query_batch, ann_cfg.dim),
                                torch.float32))
    shapes = {k: {"shape": list(t.shape), "dtype": str(t.dtype).split(".")[-1],
                  "bytes": t.numel() * t.element_size()}
              for k, t in tensors.items()}
    return {"mesh_axes": dict(zip(names, sizes)), "n_shards": n_shards,
            "per_shard": per, "slot_words": slot_words,
            "search_params": {k: v for k, v in p._asdict().items()
                              if k != "kernels"},
            "tensors": shapes,
            "total_bytes": sum(v["bytes"] for v in shapes.values()),
            "merge": merge,
            "merge_comm_rows": merge_comm_rows(ann_cfg.k, sizes, merge),
            "merge_cost_us": shard_merge_cost_us(ann_cfg.k, sizes, merge)}
