"""Batched, shard-parallel ANN serving engine — the single entry point from
a query batch to global top-K ids+scores; the port of
``repro.serve.ann``.

Three layers:

1. **Pad-and-bucket batching.** Queries are admitted in fixed bucket sizes
   (ascending, e.g. ``(1, 8, 32)``); a ragged tail is padded up to the
   smallest covering bucket by repeating the last query (when the padding
   is worth the saved dispatches, :func:`plan_buckets`) and the pad rows
   are sliced off. Each bucket is one host-to-device copy and one call of
   the batch-first beam search of ``core/search/beam.py``.
2. **Shard fan-out + global top-K merge.** A ``ShardedIndex``
   (``core/distributed/sharded_index.py``) is searched shard by shard on
   one device with the same bucketed call; local ids are translated by the
   shard's ``row_ids`` map and a stable host merge over the S*K gathered
   candidates yields the final K.
3. **Admission/stats.** Every served batch reports the paper's metrics
   (graph I/Os, vector I/Os, cache hits, modeled latency) by replaying the
   device fetch trace through the fixed-entry LRU of §3.4
   (``core/storage/blockstore.LRUCache``) and pricing the counters with the
   I/O model constants of ``core/search/engine.py`` (T_IO/T_PQ/T_EX/T_DEC).
   Only the ids, distances and the replayed stats of each bucket come back
   to the host.

**Live-updatable serving (§3.5).** A ``BatchedSearcher`` also accepts a
``SnapshotHandle`` (the streaming-update tier's publication point): each
served batch *pins* the current snapshot once — every bucket and the I/O
accounting run against that snapshot's cached device view, so queries in
flight never observe a half-published merge — and the next batch picks up
whatever view the updater published since (hot swap; no searcher rebuild).
Tombstones are masked inside the beam (``filter_tombstones``) and buffered
inserts are covered by the memtable side-scan, merged as one more "shard"
in the global top-K.

The searcher runs on ``device`` (None = the card, which the index must be
on); ``device="cpu"`` runs the plain PyTorch path.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import tracing
from ..core.codec import elias_fano as ef
from ..core.distributed.sharded_index import (ShardedIndex, ShardRouter,
                                              route_mask)
from ..core.search.beam import (DeviceIndex, SearchParams, resolve_device,
                                search)
from ..core.search.engine import (T_EX, T_IO, T_PQ, manifest_dec_costs,
                                  merge_topk, rerank_tail_us)
from ..core.storage.blockstore import BlockStore, LRUCache
from ..core.update.consistency import (ShardedSnapshotHandle,
                                       SnapshotHandle, memtable_topk)

__all__ = ["ServeConfig", "BatchReport", "BatchedSearcher", "plan_buckets",
           "merge_topk"]


@dataclass
class ServeConfig:
    buckets: tuple = (1, 8, 32)     # ascending pad-and-bucket sizes
    cache_bytes: int = 1 << 20      # modeled §3.4 fixed-entry LRU, per shard
    account_io: bool = True         # replay fetch traces through the I/O model
    manifest: object = None         # StorageManifest: price each tier's
                                    # decode at its planner-resolved codec
                                    # (engine.CODEC_DEC_US) instead of the
                                    # flat T_DEC
    shared_budget: bool = False     # pool cache_bytes across partitions
                                    # (multi-tenant mode: per-tenant LRUs
                                    # with quota floors, global-LRU eviction)
    max_chunks: int = 0             # >0: cap the bucket plan's dispatch
                                    # count per batch (overflow raises
                                    # instead of silently growing the plan)
    prefetch_depth: int = 0         # >0: the trace replay models the
                                    # engine's speculative multi-hop
                                    # prefetch — hop k+1's blocks issued
                                    # while hop k computes, window bounded
                                    # to this many entries; covered rounds
                                    # skip the T_IO stall (overlap pricing)
    prefetch_budget: int = 32       # max wasted speculations per query
    route_frac: float = 1.0         # selective shard routing (needs a
                                    # router): each query's candidates come
                                    # from its top ceil(route_frac * S)
                                    # shards by router score; the rest
                                    # contribute (-1, +inf) rows at ZERO
                                    # modeled I/O. 1.0 == full fan-out
                                    # (bit-identical to no router).


@dataclass
class BatchReport:
    """Per served batch: the bucket plan + the paper's I/O-model metrics."""
    n_queries: int = 0
    n_padded: int = 0               # total padded rows across buckets
    buckets: list = field(default_factory=list)   # bucket size per chunk
    n_shards: int = 1
    wall_s: float = 0.0
    qps: float = 0.0
    # I/O model (summed over queries and shards; engine.QueryStats semantics)
    graph_ios: int = 0              # uncached adjacency-list block reads
    vector_ios: int = 0             # full-precision vector block reads
    cache_hits: int = 0             # §3.4 fixed-entry LRU hits
    pq_ops: int = 0
    exact_ops: int = 0
    decompressions: int = 0
    io_rounds: int = 0              # traversal rounds with >=1 STALLING read
                                    # (prefetch-covered rounds excluded)
    rerank_batches: int = 0
    # Speculative prefetch replay (ServeConfig.prefetch_depth > 0):
    prefetch_issued: int = 0        # speculative block reads issued
    prefetch_hits: int = 0          # speculations consumed by a demand fetch
    prefetch_wasted: int = 0        # speculations never consumed (<= budget
                                    # per query, window evictions included)
    covered_rounds: int = 0         # rounds fully served by speculation
                                    # (no stall — blocking pays T_IO there)
    overlap_saved_us: float = 0.0   # blocking price of the same traversal
                                    # minus the overlapped price, summed
                                    # over queries; >= 0
    modeled_latency_us: float = 0.0   # mean per-query modeled latency
    modeled_p99_us: float = 0.0
    snapshot_version: int = -1      # live mode: the snapshot pinned for this
                                    # batch (-1 for frozen indexes)
    shard_versions: list = field(default_factory=list)  # sharded-live mode:
                                    # the per-shard version vector pinned
                                    # for this batch (no batch spans a
                                    # publish on any shard)
    mem_candidates: int = 0         # live mode: memtable rows side-scanned
    # Selective shard routing (ServeConfig.route_frac < 1 with a router):
    routed_rows: int = 0            # (query, shard) pairs actually searched
    fanout_frac: float = 1.0        # routed_rows / (nq * n_shards)
    failed_shards: list = field(default_factory=list)  # shards skipped by
                                    # the graceful-degradation arm
    prefetch_queues: dict = field(default_factory=dict)  # component ->
                                    # blockstore PrefetchQueue counters
    # Component-aware storage engine metrics (BlockStore partitions):
    component_io: dict = field(default_factory=dict)     # shard -> IOStats
    storage_bytes: dict = field(default_factory=dict)    # live mode: bytes
                                    # per component of the pinned snapshot
    # Admission-tier fields (serve/admission.py fills the queue ones after
    # the cut; the searcher fills tenants/per-query latency when asked):
    tenants: dict = field(default_factory=dict)   # tenant -> rows in batch
    per_query_latency_us: list = field(default_factory=list)  # modeled, per
                                    # row (arrival order)
    cut_us: float = -1.0            # simulated clock at batch cut
    cut_reason: str = ""            # "full" | "deadline" | "drain"
    queue_wait_us_mean: float = 0.0  # arrival -> cut, averaged over rows
    queue_wait_us_max: float = 0.0
    slack_min_us: float = 0.0       # tightest modeled slack at the cut


def _peel_cost(remaining: int, buckets: list) -> tuple:
    """(padding, chunks) of the greedy largest-fit decomposition of a tail
    (peel the largest fitting bucket until the sliver, then pad the sliver
    to the smallest bucket). The cost plan_buckets weighs padding against."""
    padding = chunks = 0
    while remaining > 0:
        fit = next((b for b in reversed(buckets) if b <= remaining), None)
        chunks += 1
        if fit is None:                 # sliver below the smallest bucket
            padding += buckets[0] - remaining
            break
        remaining -= fit
    return padding, chunks


def plan_buckets(nq: int, buckets: tuple, max_chunks: int = 0) -> list:
    """-> [(start, count, bucket)]: full largest buckets, then the ragged
    tail. The tail is padded to its smallest covering bucket only when the
    padding is worth the saved dispatches: pad iff
    ``padding <= peel_padding + (peel_chunks - 1) * min_bucket`` — i.e. the
    padded rows cost no more than the extra dispatches of the greedy
    largest-fit decomposition, priced at one smallest-bucket each. A
    9-query tail with buckets (1, 8, 32) runs as 8+1 (zero padding, one
    extra dispatch); a 7-query tail pads to 8 (1 pad row beats 7
    dispatches); a 17-query tail runs as 8+8+1, NOT padded to 32 (the old
    rule silently padded 15 rows there).

    ``max_chunks > 0`` makes the overflow path explicit: a plan needing
    more dispatches (nq exceeding what ``max_chunks`` buckets can hold)
    raises instead of silently growing — callers with a bounded queue
    depth (the admission tier) chunk the stream deliberately."""
    buckets = sorted(buckets)
    if not buckets or buckets[0] <= 0:
        raise ValueError(f"bucket sizes must be positive, got {buckets}")
    out, start = [], 0
    remaining = nq
    while remaining > 0:
        cover = next((b for b in buckets if b >= remaining), None)
        fit = next((b for b in reversed(buckets) if b <= remaining), None)
        if cover is not None:
            if fit is None:             # nothing fits: pad is the only move
                out.append((start, remaining, cover))
                break
            peel_pad, peel_chunks = _peel_cost(remaining, buckets)
            if cover - remaining <= peel_pad + (peel_chunks - 1) * buckets[0]:
                out.append((start, remaining, cover))
                break
        out.append((start, fit, fit))
        start += fit
        remaining -= fit
    if max_chunks and len(out) > max_chunks:
        raise ValueError(
            f"bucket plan for nq={nq} needs {len(out)} dispatches "
            f"> max_chunks={max_chunks} (largest bucket {buckets[-1]}); "
            f"chunk the stream before admission")
    return out


class BatchedSearcher:
    """Serve query batches against a DeviceIndex (1 shard), a ShardedIndex,
    or a live ``SnapshotHandle`` (§3.5 streaming index — hot-swapped on
    every publish, pinned per served batch).

    >>> searcher = BatchedSearcher(index, SearchParams(...))
    >>> ids, dists, report = searcher.search(queries)   # [nq, d] float32

    ``device`` (None = the card) is where every shard is searched; the
    index, the sharded index or the snapshots' device views must be there.
    """

    def __init__(self, index, p: SearchParams, cfg: ServeConfig = None,
                 shard_size: int = 0, router: ShardRouter = None,
                 device=None):
        cfg = cfg or ServeConfig()
        self.device = resolve_device(device)
        if cfg.account_io:
            # trace_hints rides along when the speculative window is on:
            # the replay issues speculation from the beam's provisional-
            # frontier hints (the honest predictor), not the ground truth.
            p = p._replace(trace_fetches=True,
                           trace_hints=cfg.prefetch_depth > 0)
        self._handle = index if isinstance(index, SnapshotHandle) else None
        self._shandle = index if isinstance(index, ShardedSnapshotHandle) \
            else None
        self._router = router
        if router is not None and not isinstance(index, ShardedIndex):
            raise ValueError("selective shard routing needs a frozen "
                             "ShardedIndex (routers score data partitions, "
                             "not live handles)")
        if self._handle is not None:
            snap = self._handle.current()
            store = snap.index_store
            # Live mode: the beam masks the snapshot's tombstones, and the
            # EF decode geometry must match the updater's store (its slot
            # universe carries id headroom past the current max id).
            p = p._replace(filter_tombstones=True, universe=store.universe,
                           r_max=store.r)
        elif self._shandle is not None:
            u, r = self._sharded_geometry(self._shandle.pin())
            p = p._replace(filter_tombstones=True, universe=u, r_max=r)
        self.p = p
        self.cfg = cfg
        # Decompressions split per tier (graph lists, vector records): with
        # a planner manifest each tier prices at its RESOLVED codec's cost.
        self._t_dec_ix, self._t_dec_vec = manifest_dec_costs(cfg.manifest)
        self._row_ids = None           # frozen sharded: global-id maps
        self._key_maps = None          # frozen sharded: accounting keys
        if self._handle is not None:
            self._shards = None        # resolved per batch (snapshot pin)
            self.shard_size = int(snap.device.pq_codes.shape[0])
            n_caches = 1
        elif self._shandle is not None:
            self._shards = None        # resolved per batch (version vector)
            self.shard_size = 0        # ids translate via handle offsets
            n_caches = len(self._shandle)
        elif isinstance(index, ShardedIndex):
            s = index.pq_codes.shape[0]
            # Named-field construction: ShardedIndex carries fields a
            # DeviceIndex does not (row_ids), so positional splatting
            # would silently land them in the tombstone slot. Each shard
            # is a view of the stacked tensors (no copy).
            self._shards = [
                DeviceIndex(neighbors=index.neighbors[i],
                            counts=index.counts[i],
                            ef_slots=index.ef_slots[i],
                            pq_codes=index.pq_codes[i],
                            pq_centroids=index.pq_centroids[i],
                            vectors=index.vectors[i],
                            medoid=index.medoid[i])
                for i in range(s)]
            self.shard_size = shard_size or int(index.pq_codes.shape[1])
            self._row_ids = index.row_ids.cpu().numpy().astype(np.int64)
            # Accounting keys stay globally unique even for pad rows
            # (row_id -1): pads map past the real-id space so one tenant
            # partition spanning shards never collides.
            n_total = int((self._row_ids >= 0).sum())
            per = self._row_ids.shape[1]
            self._key_maps = self._row_ids.copy()
            for i in range(s):
                pad = self._key_maps[i] < 0
                self._key_maps[i, pad] = (n_total + i * per
                                          + np.nonzero(pad)[0])
            n_caches = s
        else:
            self._shards = [index]
            self.shard_size = int(index.pq_codes.shape[0])
            n_caches = 1
        # The modeled storage engine: one BlockStore whose partitions are
        # the per-shard §3.4 fixed-entry LRUs (entries sized to the EF
        # worst case so capacity is a hard bound — index_store semantics);
        # the fetch-trace replay accounts reads per shard component.
        universe = p.universe or self.shard_size
        entry_bytes = ef.worst_case_record_bytes(p.r_max, universe)
        self.blocks = BlockStore(cache_bytes=cfg.cache_bytes,
                                 shared_budget=cfg.shared_budget)
        self._entry_bytes = entry_bytes
        self._caches = [
            self.blocks.register_cache(f"shard{i}", entry_bytes)
            for i in range(n_caches)]
        # Multi-tenant mode (admission tier): per-tenant LRU partitions on
        # the same BlockStore, registered up front (register_tenant) or
        # lazily on first sight; floors recorded so a geometry change can
        # re-register with the same quotas.
        self._tenant_caches: dict = {}
        self._tenant_floors: dict = {}
        self._seq = 0                  # served batches, for the spans

    # ------------------------------------------------------------ tenants
    def register_tenant(self, tenant: str, floor_bytes: int = 0) -> None:
        """Create the tenant's LRU partition (quota floor in bytes; only
        enforced under ``ServeConfig(shared_budget=True)``). Idempotent for
        an unchanged floor; the admission tier calls this per configured
        tenant so quota floors are reserved before traffic arrives."""
        if tenant in self._tenant_caches \
                and self._tenant_floors.get(tenant) == floor_bytes:
            return
        self._tenant_floors[tenant] = floor_bytes
        self._tenant_caches[tenant] = self.blocks.register_tenant_cache(
            tenant, self._entry_bytes, floor_bytes=floor_bytes)

    def _tenant_cache(self, tenant: str) -> LRUCache:
        if tenant not in self._tenant_caches:
            self.register_tenant(tenant)
        return self._tenant_caches[tenant]

    # ----------------------------------------------------- sharded-live pin
    @staticmethod
    def _sharded_geometry(snaps: list) -> tuple:
        """The (universe, r) every shard of a version vector must share —
        the serving tier searches every shard with ONE set of parameters,
        so a per-shard EF geometry drift is a configuration error, not a
        hot-swap."""
        geos = {(int(s.index_store.universe), int(s.index_store.r))
                for s in snaps}
        if len(geos) != 1:
            raise ValueError(f"sharded serving requires a uniform EF "
                             f"geometry across shards, got {sorted(geos)}")
        return geos.pop()

    def _renew_geometry(self, entry_bytes: int, n_caches: int) -> None:
        """A fallback full rebuild renewed the EF geometry; re-size the
        modeled LRUs to the new worst-case entry bound (§3.4). Tenant
        partitions re-register at the new bound, keeping their quota
        floors (cold caches, same quotas)."""
        self._entry_bytes = entry_bytes
        self._caches = [self.blocks.register_cache(f"shard{i}", entry_bytes)
                        for i in range(n_caches)]
        self._tenant_caches = {
            t: self.blocks.register_tenant_cache(t, entry_bytes,
                                                 floor_bytes=f)
            for t, f in self._tenant_floors.items()}

    # ------------------------------------------------------------- serving
    def search(self, queries: np.ndarray, tenants: list = None,
               failed_shards=None):
        """queries [nq, d] -> (ids [nq, K], dists [nq, K], BatchReport).

        ids are global (shard offset / row_ids map applied); rows are
        sorted by exact re-ranked distance, -1 = no result.

        ``tenants`` (one label per row, arrival order) switches the I/O
        accounting to per-tenant LRU partitions: row qi's fetch trace
        replays through tenant qi's partition (keys are GLOBAL ids, so one
        tenant partition spans shards) and its block reads are charged to
        the ``tenant:<name>`` component. The ids/dists path is untouched —
        tenancy changes what is *measured*, never what is *returned*
        (bit-exactness is the admission tier's acceptance gate).

        ``failed_shards`` (iterable of shard indices) is the graceful-
        degradation arm: those shards are treated as unresponsive — the
        merge runs over whatever shards respond, recall degrades, nothing
        crashes. With a router and ``ServeConfig(route_frac < 1)``, each
        query only searches (and is only charged I/O for) its routed
        shards.
        """
        self._seq += 1
        with tracing.span("serve.batch",
                          {"batch": self._seq, "rows": len(queries)}):
            return self._search(queries, tenants, failed_shards)

    def _search(self, queries, tenants, failed_shards):
        queries = np.asarray(queries, np.float32)
        nq = len(queries)
        if tenants is not None and len(tenants) != nq:
            raise ValueError(f"tenants ({len(tenants)}) must label every "
                             f"query row ({nq})")
        # Live mode: pin ONE snapshot (or one per-shard version VECTOR) for
        # the whole batch — every bucket and shard below reads these
        # snapshots' device views, so a merge that publishes mid-batch on
        # any shard is invisible until the next search() call (hot swap at
        # batch granularity, §3.5 consistency).
        snap = self._handle.current() if self._handle is not None else None
        snaps = self._shandle.pin() if self._shandle is not None else None
        offsets = None
        if snap is not None:
            store = snap.index_store
            if (store.universe != self.p.universe
                    or store.r != self.p.r_max):
                # A fallback full rebuild renewed the EF geometry; re-pin
                # the search parameters at the new bound.
                self.p = self.p._replace(universe=store.universe,
                                         r_max=store.r)
                self._renew_geometry(
                    ef.worst_case_record_bytes(store.r, store.universe), 1)
            shards = [snap.device]
            self.shard_size = int(snap.device.pq_codes.shape[0])
        elif snaps is not None:
            u, r = self._sharded_geometry(snaps)
            if u != self.p.universe or r != self.p.r_max:
                self.p = self.p._replace(universe=u, r_max=r)
                self._renew_geometry(ef.worst_case_record_bytes(r, u),
                                     len(snaps))
            shards = [s.device for s in snaps]
            offsets = self._shandle.offsets
        else:
            shards = self._shards
        failed = {int(s) for s in (failed_shards or ())}
        route = None
        if self._router is not None and self.cfg.route_frac < 1.0:
            mask = route_mask(self._router.centroids, queries,
                              self.cfg.route_frac)
            with tracing.span("serve.sync"):
                route = mask.cpu().numpy()
        mem_lanes = 1 if snap is not None else \
            (len(shards) if snaps is not None else 0)
        n_lanes = len(shards) + mem_lanes
        report = BatchReport(n_queries=nq, n_shards=len(shards),
                             snapshot_version=snap.version if snap else -1,
                             failed_shards=sorted(failed))
        if snaps is not None:
            report.shard_versions = [s.version for s in snaps]
        if route is not None:
            report.routed_rows = int(route.sum())
            report.fanout_frac = report.routed_rows / max(1, nq * len(shards))
        else:
            report.routed_rows = nq * len(shards)
        if tenants is not None:
            for t in tenants:
                report.tenants[t] = report.tenants.get(t, 0) + 1
        t0 = time.perf_counter()
        chunks = plan_buckets(nq, self.cfg.buckets, self.cfg.max_chunks)
        out_ids = np.full((n_lanes, nq, self.p.k), -1, np.int64)
        out_d = np.full((n_lanes, nq, self.p.k), np.inf, np.float32)
        lat = np.zeros((n_lanes, nq), np.float64)
        for start, count, bucket in chunks:
            with tracing.span("serve.bucket",
                              {"bucket": bucket, "rows": count}):
                report.buckets.append(bucket)
                report.n_padded += bucket - count
                q = queries[start:start + count]
                if bucket > count:      # pad by repeating the last query
                    q = np.concatenate(
                        [q, np.repeat(q[-1:], bucket - count, 0)])
                with tracing.span("serve.sync"):   # one copy a bucket
                    qj = torch.from_numpy(q).to(self.device)
                for si, shard in enumerate(shards):
                    if si in failed:
                        continue        # unresponsive: merge the rest
                    active = None
                    if route is not None:
                        active = route[start:start + count, si]
                        if not active.any():
                            continue    # no query routed here: zero I/O
                    ids, dists, stats = search(shard, qj, self.p, self.device)
                    with tracing.span("serve.sync"):
                        ids = ids[:count].cpu().numpy()
                    with tracing.span("serve.sync"):
                        d = dists[:count].cpu().numpy()
                    if self._row_ids is not None:
                        # Frozen sharded: global ids through the shard's
                        # row_ids map; pad rows (row_id -1) are masked to
                        # (-1, +inf) so they never surface in the merge.
                        rm = self._row_ids[si]
                        gids = np.where(ids >= 0,
                                        rm[np.clip(ids, 0, len(rm) - 1)], -1)
                        d = np.where(gids >= 0, d, np.inf).astype(np.float32)
                    else:
                        off = offsets[si] if offsets is not None \
                            else si * self.shard_size
                        gids = np.where(ids >= 0,
                                        ids.astype(np.int64) + off, -1)
                    if active is not None:
                        gids = np.where(active[:, None], gids, -1)
                        d = np.where(active[:, None], d,
                                     np.inf).astype(np.float32)
                    out_ids[si, start:start + count] = gids
                    out_d[si, start:start + count] = d
                    if self.cfg.account_io:
                        key_map = None
                        if tenants is not None:
                            rows = tenants[start:start + count]
                            caches = [self._tenant_cache(t) for t in rows]
                            comps = [f"tenant:{t}" for t in rows]
                            if self._key_maps is not None:
                                off, key_map = 0, self._key_maps[si]
                            else:
                                off = offsets[si] if offsets is not None \
                                    else si * self.shard_size
                        else:
                            caches = [self._caches[si]] * count
                            comps = [f"shard{si}"] * count
                            off = 0
                        with tracing.span("serve.replay"):
                            lat[si, start:start + count] = self._account(
                                report, stats, count, caches, comps,
                                key_offset=off, key_map=key_map, active=active)
        with tracing.span("serve.merge"):
            if snap is not None:
                # Memtable side-scan: buffered inserts are one more "shard" in
                # the global merge (ids are globally unique fresh dense ids).
                out_ids[-1], out_d[-1] = memtable_topk(
                    snap, queries, self.p.k, self.device)
                report.mem_candidates = len(snap.mem_rows)
            elif snaps is not None:
                # One memtable lane per shard, local fresh ids translated by
                # the handle's per-shard offset.
                for si, s in enumerate(snaps):
                    if si in failed:
                        continue
                    mids, md = memtable_topk(s, queries, self.p.k,
                                             self.device)
                    out_ids[len(shards) + si] = np.where(
                        mids >= 0, mids + offsets[si], -1)
                    out_d[len(shards) + si] = md
                    report.mem_candidates += len(s.mem_rows)
            ids, dists = merge_topk(out_ids, out_d, self.p.k)
        report.wall_s = time.perf_counter() - t0
        report.qps = nq / max(report.wall_s, 1e-9)
        if self.cfg.account_io:
            per_q = lat.max(axis=0)     # shards fan out in parallel
            report.modeled_latency_us = float(per_q.mean())
            report.modeled_p99_us = float(np.percentile(per_q, 99))
            report.per_query_latency_us = [float(v) for v in per_q]
            # Per-component engine metrics: cumulative BlockStore stats
            # (per-shard partitions; the updater's own components when a
            # live snapshot's stores share an engine are reported there).
            report.component_io = {n: s.snapshot() for n, s in
                                   self.blocks.components.items()}
            if self.cfg.prefetch_depth > 0:
                report.prefetch_queues = self.blocks.prefetch_stats()
        if snap is not None:
            report.storage_bytes = dict(
                adjacency=snap.index_store.physical_bytes,
                adjacency_sparse_index=snap.index_store.sparse_index_bytes,
                vector_chunks=snap.vector_store.physical_bytes,
                vector_metadata=snap.vector_store.metadata_bytes)
        elif snaps is not None:
            report.storage_bytes = dict(
                adjacency=sum(s.index_store.physical_bytes for s in snaps),
                adjacency_sparse_index=sum(
                    s.index_store.sparse_index_bytes for s in snaps),
                vector_chunks=sum(
                    s.vector_store.physical_bytes for s in snaps),
                vector_metadata=sum(
                    s.vector_store.metadata_bytes for s in snaps))
        return ids, dists, report

    # ------------------------------------------------------ I/O accounting
    def _account(self, report: BatchReport, stats, count: int,
                 caches: list, components: list, key_offset: int = 0,
                 key_map=None, active=None) -> np.ndarray:
        """Replay one bucket's fetch traces (arrival order) through each
        row's fixed-entry LRU partition (per-shard in the classic path, per
        TENANT in admission mode — one entry per row); price counters with
        the engine.py latency model (latency_aware arm: vector reads off
        the traversal critical path). Uncached fetches are accounted as
        block reads on the row's BlockStore component; ``key_offset`` (or
        ``key_map``, the frozen-sharded row_ids table) translates shard-
        local ids to global keys so one tenant partition spans shards
        without collisions. Rows with ``active[qi]`` false (the router
        skipped this shard for that query) are priced at zero — a
        non-routed shard does no I/O. Returns per-query modeled latency
        [count] in µs."""
        # Only what the replay reads comes back to the host, as lists.
        pf_on = self.cfg.prefetch_depth > 0
        with tracing.span("serve.sync"):
            trace = stats.fetch_trace[:count].tolist()      # [c, iters, W]
            pq_ops = stats.pq_dists[:count].tolist()
            exact = stats.exact_dists[:count].tolist()
            batches = stats.rerank_batches[:count].tolist()
            hints = stats.hint_trace[:count].tolist() if pf_on else None
        if key_map is not None:
            key_map = key_map.tolist()
        lat = np.zeros(count)
        for qi in range(count):
            if active is not None and not active[qi]:
                continue            # routed away: zero modeled I/O here
            cache, component = caches[qi], components[qi]
            # Speculative window: hop ri's HINT row (the provisional
            # frontier the engine recorded BEFORE merging that hop's
            # neighbors — the honest, lossy predictor) is issued while hop
            # ri's compute runs; hop ri+1's demand reads then consume
            # whatever the hints got right. The queue lives on the shared
            # BlockStore (one per component), so its depth/budget bound
            # speculation across the whole batch, and `wasted` is a
            # lifetime counter — charged here by delta.
            pfq = self.blocks.register_prefetch(
                component, self.cfg.prefetch_depth,
                self.cfg.prefetch_budget) if pf_on else None
            w0 = pfq.wasted if pfq is not None else 0
            misses = hits = io_rounds = covered = pf_hits = 0
            rounds = trace[qi]
            for ri, round_ids in enumerate(rounds):
                round_miss = round_pf = 0
                for vid in round_ids:
                    if vid < 0:
                        continue
                    key = int(key_map[vid]) if key_map is not None \
                        else int(vid) + key_offset
                    if cache.get(key) is not None:
                        hits += 1
                        continue
                    if pfq is not None and pfq.take(key):
                        cache.note_prefetch_hit()
                        pf_hits += 1
                        round_pf += 1
                    else:
                        self.blocks.read(component)    # one 4 KiB block
                        misses += 1
                        round_miss += 1
                        if pfq is not None:
                            pfq.fill(key)
                    cache.put(key, True)
                if round_miss:
                    io_rounds += 1      # at least one read stalls the round
                elif round_pf:
                    covered += 1        # fully served by in-flight reads
                if pfq is not None and ri < len(hints[qi]):
                    # Issue this hop's provisional-frontier guesses while
                    # its compute runs (live path: guesses can be wrong —
                    # unconsumed issues surface in prefetch_wasted).
                    for vid in hints[qi][ri]:
                        if vid < 0:
                            continue
                        key = int(key_map[vid]) if key_map is not None \
                            else int(vid) + key_offset
                        if cache.peek(key) is None and pfq.offer(key):
                            self.blocks.read(component)
                            report.prefetch_issued += 1
            # decompressions: EF list decode per fetched list (graph tier)
            # + per-record decompress on the vector tier (§3.3 layout).
            dec_ix = (misses + pf_hits + hits) if self.p.use_ef else 0
            dec_vec = int(exact[qi])
            dec = dec_ix + dec_vec
            # graph_ios stays DEMAND-equivalent (engine.QueryStats
            # semantics): a consumed speculation replaced the demand read
            # it pre-empted; wasted issues are reported separately.
            report.graph_ios += misses + pf_hits
            report.cache_hits += hits
            report.vector_ios += int(exact[qi])
            report.pq_ops += int(pq_ops[qi])
            report.exact_ops += int(exact[qi])
            report.decompressions += dec
            report.io_rounds += io_rounds
            report.rerank_batches += int(batches[qi])
            io = io_rounds * T_IO
            cpu = (int(pq_ops[qi]) * T_PQ + int(exact[qi]) * T_EX
                   + dec_ix * self._t_dec_ix + dec_vec * self._t_dec_vec)
            tail = rerank_tail_us(batches[qi])
            if pfq is not None:
                pfq.drain()
                report.prefetch_hits += pf_hits
                report.prefetch_wasted += pfq.wasted - w0
                report.covered_rounds += covered
                # Overlap pricing (engine "pipelined_overlap"): stalled
                # rounds overlap compute, covered rounds pay no T_IO, plus
                # a half-read pipeline fill when anything was covered.
                # Saved is measured against the blocking price of the SAME
                # traversal, where covered rounds stall too (>= 0 always).
                fill = 0.5 * T_IO if covered else 0.0
                overlapped = max(io, cpu) + fill
                report.overlap_saved_us += \
                    (io + covered * T_IO + cpu) - overlapped
                lat[qi] = overlapped + tail
            else:
                lat[qi] = max(io, cpu) + min(io, cpu) * 0.1 + tail
        return lat
