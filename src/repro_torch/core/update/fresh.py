"""Decoupled streaming updates (paper §3.5): FreshDiskANN-style batch merges
for the auxiliary index + log-structured appends & GC for vector data,
served by the SAME batched device search core as a frozen index — the port
of ``repro.core.update.fresh``.

The asymmetric treatment is the paper's point:

- the graph is globally interconnected -> buffered deletes/inserts are merged
  in batches with robust-prune repair. The merge tracks the **dirty vertex
  set** (repair-patched + deleted + inserted + back-edge-patched vertices)
  and rewrites ONLY the 4 KiB index-store blocks holding those lists
  (``CompressedIndexStore.rewrite_blocks``); a full rebuild remains the
  fallback (block overflow / EF-universe overflow).
- vector data has no inter-record dependencies -> inserts append to the
  active mutable segment at insert time, deletes only mark staleness, and a
  background GC pass (greedy by garbage ratio) reclaims space without
  rewriting the whole store.

Search during updates runs over every published :class:`Snapshot`'s device
view (``consistency.py``): graph results come from ``search`` with
tombstones masked in-beam, and buffered inserts are covered by the
brute-force memtable side-scan, merged through the same top-K merge the
sharded serving tier uses. The insert path of the merge batches all
buffered points through one ``search_candidates`` traversal over the
pre-merge snapshot.

The vector store returns rows as tensors on its device. The merge brings
them to the host in batches — one ``get`` for every row the delete repair
prunes with, one per insert for its candidates and one per insert for its
back-edge patches — while each logical read of the reference accounts the
same read I/O (``DecoupledVectorStore.account_reads``).

ID contract: vertex ids are *dense* (id == graph array position), exactly as
in DiskANN. Fresh inserts must allocate the next dense ids; reusing an id
that already exists in the graph raises ``ValueError``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ... import tracing
from ..graph.pq import PQCodebook, encode_pq
from ..graph.vamana import robust_prune
from ..search.beam import (SearchParams, resolve_device, search,
                           search_candidates)
from ..search.engine import merge_cost_us, merge_topk
from ..storage.blockstore import BlockStore
from ..storage.index_store import CompressedIndexStore
from ..storage.layout import BLOCK_SIZE
from ..storage.vector_store import DecoupledVectorStore
from .consistency import (Snapshot, SnapshotHandle, build_device_view,
                          memtable_topk)


@dataclass
class UpdateConfig:
    r: int = 32
    l_build: int = 64
    alpha: float = 1.2
    merge_threshold: int = 256        # buffered inserts triggering a merge
    gc_threshold: float = 0.25
    cache_bytes: int = 0
    fill_factor: float = 0.85         # index-store build-time block fill cap:
                                      # the headroom that keeps dirty-block
                                      # rewrites in place (§3.5 incremental)
    universe_headroom: float = 2.0    # EF universe slack over the current max
                                      # id, so fresh dense ids stay encodable
                                      # without forcing a full rebuild
    incremental: bool = True          # False -> always full store rebuild
    benefit_threshold: float = 0.0    # live-search re-rank early-stop; 0.0 =
                                      # exact re-rank of the whole cand list
    reorder: str | None = None        # seal-time locality ordering of the
                                      # index store ("bfs"/"bisection");
                                      # merges that INSERT under an ordered
                                      # store take the full-rebuild path
    device: object = None             # where the index store, the device
                                      # views and the searches live; None =
                                      # the card


@dataclass
class MergeStats:
    """One merge's accounting: dirty set, block-granular write I/O, and the
    engine-modeled cost. The phases show as ``update.*`` spans
    (``repro_torch.tracing``)."""
    dirty_vertices: int = 0
    inserted: int = 0
    deleted: int = 0
    blocks_rewritten: int = 0
    blocks_appended: int = 0
    total_blocks: int = 0
    write_bytes: int = 0              # index-store merge write I/O
    cache_invalidated: int = 0
    full_rebuild: bool = False
    modeled_cost_us: float = 0.0      # engine.merge_cost_us pricing


class _Rows:
    """One merge's host copies of vector rows, keyed by id: ``fetch`` brings
    every missing row of a batch to the host in one ``get``; ``vecs`` and
    ``vec`` serve the reference's reads from the copies and account each
    read's I/O as the reference's ``get`` does. Rows never change within a
    merge (ids are not reused), so a copy equals a fresh read. The copies
    are float32 whatever the store's dtype, so ``robust_prune`` measures
    true distances on a uint8 store too (uint8 differences would wrap mod
    256); float32 holds every uint8 distance at D <= 256 exactly."""

    def __init__(self, store: DecoupledVectorStore, buffer: dict):
        self.store, self.buffer = store, buffer
        self.rows: dict[int, np.ndarray] = {}

    def fetch(self, ids) -> None:
        miss = sorted({int(i) for i in ids if int(i) not in self.rows})
        if miss:
            got = self.store.get(np.asarray(miss, np.int64), account=False)
            for i, row in zip(miss, got.cpu().numpy().astype(np.float32)):
                self.rows[i] = row

    def vecs(self, ids: np.ndarray) -> np.ndarray:
        """The reference's ``_vecs``: one accounted store read."""
        ids = np.asarray(ids, np.int64)
        self.store.account_reads(ids)
        self.fetch(ids)
        return np.stack([self.rows[int(i)] for i in ids]) \
            if len(ids) else np.zeros((0, self.store.cfg.dim), np.float32)

    def vec(self, vid: int) -> np.ndarray:
        """The reference's ``_vec``: the buffered vector, else one
        accounted single-row store read."""
        if vid in self.buffer:
            return self.buffer[vid]
        self.store.account_reads(np.asarray([vid], np.int64))
        self.fetch([vid])
        return self.rows[vid]


class StreamingIndex:
    """DecoupleVS update path over (CompressedIndexStore, DecoupledVectorStore).

    Reads and writes share one engine: searches (live or mid-merge) run the
    batched beam core over the current snapshot's device view; merges use
    the same core to find insert candidates, then rewrite only dirty blocks.
    Everything device-resident lives on ``cfg.device`` (None = the card).
    """

    def __init__(self, adjacency: list, medoid: int,
                 vector_store: DecoupledVectorStore, pq_codes: np.ndarray,
                 codebook: PQCodebook, cfg: UpdateConfig):
        self.device = resolve_device(cfg.device)
        self.adjacency = [np.asarray(a, np.int64) for a in adjacency]
        self.medoid = medoid
        self.vector_store = vector_store
        self.pq_codes = np.asarray(pq_codes, np.uint8)
        self.cb = codebook
        self.cfg = cfg
        self.insert_buffer: dict[int, np.ndarray] = {}
        self.delete_buffer: set[int] = set()
        self.merges = 0
        self.last_merge: MergeStats | None = None
        # ONE storage engine under both tiers (§3.3): every index-store
        # build/rewrite accounts through it, and the vector tier's engine
        # chains into its total, so merge write-amp is read off one ruler.
        self.blocks = BlockStore(cache_bytes=cfg.cache_bytes)
        self.blocks.adopt("vector_chunks", vector_store.blocks.io)
        store = self._build_index_store()
        self.handle = SnapshotHandle(Snapshot(
            version=0, index_store=store, vector_store=vector_store,
            pq_codes=self.pq_codes,
            device=self._device_view(store.universe)))

    # ------------------------------------------------------------- helpers
    def _build_index_store(self) -> CompressedIndexStore:
        needed = max(len(self.adjacency), self._max_id() + 1)
        universe = max(needed, int(needed * self.cfg.universe_headroom))
        return CompressedIndexStore.from_graph(
            self.adjacency, self.medoid, self.cfg.r, universe=universe,
            cache_bytes=self.cfg.cache_bytes,
            fill_factor=self.cfg.fill_factor,
            block_store=self.blocks,
            order=self.cfg.reorder, device=self.device)

    def _max_id(self) -> int:
        ids = self.vector_store.ids
        return int(ids[-1]) if len(ids) else len(self.adjacency) - 1

    def _fetch_view_rows(self, ids: np.ndarray) -> torch.Tensor:
        """Re-rank rows for the device view, as one unaccounted ``get``:
        zero-fill ids whose vector records are gone (deleted vertices are
        unreachable post-repair, the rows just keep the array dense). This
        is the publish-time device materialization, not serving I/O."""
        ids = np.asarray(ids, np.int64)
        vs = self.vector_store
        out = torch.zeros((len(ids), vs.cfg.dim), dtype=torch.float32,
                          device=vs.device)
        have = torch.nonzero(vs.contains(ids)).squeeze(1)
        if len(have):
            out[have] = vs.get(ids[have.cpu().numpy()],
                               account=False).to(torch.float32)
        return out

    def _device_view(self, universe: int, prev=None, dirty=None):
        return build_device_view(
            self.adjacency, self.medoid, self.pq_codes, self.cb.centroids,
            self._fetch_view_rows, self.vector_store.cfg.dim,
            r_max=self.cfg.r, universe=universe, prev=prev, dirty=dirty,
            device=self.device)

    def _params(self, k: int, l_size: int, universe: int) -> SearchParams:
        return SearchParams(
            l_size=l_size, k=k, r_max=self.cfg.r, universe=universe,
            benefit_threshold=self.cfg.benefit_threshold,
            filter_tombstones=True)

    # ------------------------------------------------------------- updates
    def insert(self, ids: np.ndarray, vecs: np.ndarray) -> None:
        ids = np.asarray(ids, np.int64).reshape(-1)
        reused = [int(i) for i in ids if int(i) < len(self.adjacency)]
        if reused:
            raise ValueError(
                f"id reuse not supported: ids {reused[:5]} already exist in "
                f"the graph (dense-id contract — allocate fresh ids)")
        # Also reject re-inserting a fresh id that is already buffered or
        # already holds a vector-store record, and duplicates within one
        # call.
        stored = set(ids[self.vector_store.contains(ids).cpu().numpy()]
                     .tolist())
        seen: set[int] = set()
        dup = [int(i) for i in ids
               if int(i) in self.insert_buffer or int(i) in stored
               or (int(i) in seen or seen.add(int(i)))]
        if dup:
            raise ValueError(
                f"id reuse not supported: ids {dup[:5]} already inserted "
                f"(buffered or stored; delete + merge before reusing)")
        vecs = np.asarray(vecs, np.float32)
        # Vector data path: append to the active segment NOW (§3.5).
        self.vector_store.append(ids, vecs)
        rows = {}
        for i, v in zip(ids, vecs):
            self.insert_buffer[int(i)] = v
            rows[int(i)] = v
        self.handle.with_mem_rows(rows)
        if len(self.insert_buffer) >= self.cfg.merge_threshold:
            self.merge()

    def delete(self, ids: np.ndarray) -> None:
        ids = [int(i) for i in np.asarray(ids).reshape(-1)]
        self.delete_buffer.update(ids)
        self.handle.with_tombstones(ids)   # batch-visible immediately

    # ------------------------------------------------------------- merge
    def merge(self, force_full: bool = False) -> MergeStats:
        """Batch merge: delete-repair + insert + dirty-block store rewrite +
        GC + publish. Returns the merge's :class:`MergeStats` (also kept as
        ``self.last_merge``)."""
        stats = MergeStats()
        snap0 = self.handle.current()
        reused = sorted(i for i in self.insert_buffer
                        if i < len(self.adjacency))
        if reused:
            raise ValueError(
                f"id reuse not supported: buffered ids {reused[:5]} already "
                f"exist in the graph (dense-id contract)")
        rows = _Rows(self.vector_store, self.insert_buffer)
        dirty: set[int] = set()
        with tracing.span("update.repair"):
            D = {d for d in self.delete_buffer if d < len(self.adjacency)}
            stats.deleted = len(D)
            # 1. Delete consolidation (FreshDiskANN): patch every vertex whose
            #    list touches D with its deleted neighbors' neighbors. Every
            #    candidate list depends on the pre-merge graph alone, so all
            #    are formed first and the rows they prune with fetched at once.
            if D:
                dead = np.zeros(len(self.adjacency), bool)
                dead[np.asarray(sorted(D), np.int64)] = True
                patched = []
                for p in self._touching(dead):
                    nbrs = self.adjacency[p]
                    hit = nbrs[dead[nbrs]]
                    pulled = np.concatenate([self.adjacency[d] for d in hit])
                    pulled = pulled[~dead[pulled] & (pulled != p)]
                    patched.append((p, np.union1d(nbrs[~dead[nbrs]], pulled)))
                prune = [(p, cand) for p, cand in patched
                         if len(cand) > self.cfg.r]
                if prune:
                    need = np.unique(np.concatenate(
                        [c for _, c in prune]
                        + [np.asarray([p for p, _ in prune], np.int64)]))
                    # the reference reads each distinct row once, one block
                    # each
                    k = int(self._sealed(need).sum())
                    self.vector_store.io.read(k * BLOCK_SIZE, n=k)
                    rows.fetch(need)
                for p, cand in patched:
                    if len(cand) > self.cfg.r:
                        vmat = np.stack([rows.rows[int(c)] for c in cand]
                                        + [rows.rows[p]])
                        local = robust_prune(len(cand), np.arange(len(cand)),
                                             vmat, self.cfg.alpha, self.cfg.r)
                        cand = cand[local]
                    self.adjacency[p] = cand
                    dirty.add(p)
                for d in D:
                    self.adjacency[d] = np.zeros(0, np.int64)
                dirty.update(D)

        # 2. Insert buffered points: ONE batched device traversal over the
        #    pre-merge snapshot supplies every point's candidate pool, then
        #    robust prune + back-edge patching on the host.
        with tracing.span("update.insert"):
            # A buffered insert that was deleted before the merge must NOT be
            # integrated (it would resurrect: publish clears the tombstones);
            # its vector row is reclaimed with the other deletes in step 3.
            items = sorted((vid, v) for vid, v in self.insert_buffer.items()
                           if vid not in self.delete_buffer)
            stats.inserted = len(items)
            if items:
                top = items[-1][0]    # grow the PQ codes once for every insert
                if top >= len(self.pq_codes):
                    grow = np.zeros((top + 1 - len(self.pq_codes),
                                     self.pq_codes.shape[1]), np.uint8)
                    self.pq_codes = np.concatenate([self.pq_codes, grow])
                qs = np.stack([v for _, v in items])
                p_ins = self._params(k=min(10, self.cfg.l_build),
                                     l_size=self.cfg.l_build,
                                     universe=snap0.index_store.universe)
                cand_rows, _ = search_candidates(snap0.device, qs, p_ins,
                                                 self.device)
                cand_rows = cand_rows.cpu().numpy().astype(np.int64)
            for (vid, v), row in zip(items, cand_rows if items else ()):
                while len(self.adjacency) <= vid:
                    self.adjacency.append(np.zeros(0, np.int64))
                cand_ids = np.asarray(
                    [c for c in row if c >= 0 and c not in self.delete_buffer],
                    np.int64)
                vmat = np.concatenate([rows.vecs(cand_ids), v[None]]) \
                    if len(cand_ids) else v[None]
                local = robust_prune(len(cand_ids), np.arange(len(cand_ids)),
                                     vmat, self.cfg.alpha, self.cfg.r)
                self.adjacency[vid] = cand_ids[local]
                dirty.add(vid)
                grow = [int(q) for q in self.adjacency[vid]
                        if vid not in self.adjacency[int(q)]
                        and len(self.adjacency[int(q)]) + 1 > self.cfg.r]
                if grow:      # the rows the back-edge prunes read, in one get
                    rows.fetch(np.concatenate(
                        [self.adjacency[q] for q in grow]
                        + [np.asarray(grow + [vid], np.int64)]))
                for q in self.adjacency[vid]:
                    q = int(q)
                    if vid not in self.adjacency[q]:
                        merged = np.append(self.adjacency[q], vid)
                        if len(merged) > self.cfg.r:
                            qv = np.concatenate([rows.vecs(merged),
                                                 rows.vec(q)[None]])
                            keep = robust_prune(
                                len(merged), np.arange(len(merged)), qv,
                                self.cfg.alpha, self.cfg.r)
                            merged = merged[keep]
                        self.adjacency[q] = merged
                        dirty.add(q)
                # PQ code for steering future traversals.
                self.pq_codes[vid] = encode_pq(v[None], self.cb)[0]

        # 3. Vector-data path: tombstones -> stale marks, then GC (§3.5).
        #    The whole delete buffer is marked (not just D): a deleted
        #    buffered insert has a vector row but no graph slot, and ids
        #    that never existed are skipped by mark_stale.
        with tracing.span("update.vector"):
            self.vector_store.mark_stale(
                np.asarray(sorted(self.delete_buffer), np.int64))
            self.vector_store.seal_active()
            self.vector_store.gc(self.cfg.gc_threshold)

        # 4. Index-store merge: rewrite only dirty blocks; full rebuild is
        #    the fallback (and the forced baseline for write-amp studies).
        with tracing.span("update.store"):
            if self.medoid in D:
                alive = [i for i, a in enumerate(self.adjacency)
                         if len(a) and i not in D]
                self.medoid = alive[0] if alive else 0
            stats.dirty_vertices = len(dirty)
            old_store = snap0.index_store
            store = None
            if self.cfg.incremental and not force_full:
                res = old_store.rewrite_blocks(self.adjacency, dirty,
                                               medoid=self.medoid)
                if res is not None:
                    store, rep = res
                    stats.blocks_rewritten = rep.blocks_rewritten
                    stats.blocks_appended = rep.blocks_appended
                    stats.total_blocks = rep.total_blocks
                    stats.write_bytes = rep.write_bytes
                    stats.cache_invalidated = rep.cache_invalidated
            if store is None:                     # full rebuild (or forced)
                store = self._build_index_store()
                store.io.write(store.physical_bytes, n=store.n_blocks)
                stats.full_rebuild = True
                stats.blocks_rewritten = store.n_blocks
                stats.total_blocks = store.n_blocks
                stats.write_bytes = store.physical_bytes
            stats.modeled_cost_us = merge_cost_us(
                stats.blocks_rewritten + stats.blocks_appended,
                len(self.adjacency) if stats.full_rebuild else len(dirty))

        # 5. Publish: device view patched from the previous snapshot's view
        #    where the store merge was incremental (same EF universe).
        with tracing.span("update.publish"):
            prev_view = snap0.device \
                if store.universe == old_store.universe else None
            view = self._device_view(store.universe, prev=prev_view,
                                     dirty=dirty)
            self.handle.publish(Snapshot(
                version=snap0.version + 1, index_store=store,
                vector_store=self.vector_store, pq_codes=self.pq_codes,
                tombstones=frozenset(), mem_rows={}, device=view))
        self.insert_buffer.clear()
        self.delete_buffer.clear()
        self.merges += 1
        self.last_merge = stats
        return stats

    def _touching(self, dead: np.ndarray, chunk: int = 1 << 14):
        """The live vertices whose lists hold a ``dead`` id, ascending:
        the lists are flattened a chunk at a time and reduced in numpy, so
        the scan costs no Python step per vertex."""
        for a in range(0, len(self.adjacency), chunk):
            lists = self.adjacency[a:a + chunk]
            lens = np.fromiter(map(len, lists), np.int64, len(lists))
            full = lens > 0
            if not full.any():
                continue
            hit = np.zeros(len(lists), bool)
            hit[full] = np.logical_or.reduceat(
                dead[np.concatenate(lists)], (np.cumsum(lens) - lens)[full])
            yield from (a + np.flatnonzero(hit & ~dead[a:a + len(lists)])
                        ).tolist()

    def _sealed(self, ids: np.ndarray) -> np.ndarray:
        """Per id: whether its record lies in a sealed segment (a read of it
        costs a block; the mutable segment's rows cost none)."""
        seg, _ = self.vector_store.location(ids)
        return (seg >= 0).cpu().numpy()

    # ------------------------------------------------------------- search
    def search(self, query: np.ndarray, k: int = 10, l_size: int = 64
               ) -> np.ndarray:
        """Snapshot search honouring tombstones + buffered inserts (§3.5)."""
        ids, _ = self.search_batch(np.asarray(query, np.float32)[None],
                                   k=k, l_size=l_size)
        return ids[0]

    def search_batch(self, queries: np.ndarray, k: int = 10,
                     l_size: int = 64) -> tuple[np.ndarray, np.ndarray]:
        """Batched live search -> (ids [nq, k], dists [nq, k]); -1 = none."""
        snap = self.handle.current()
        p = self._params(k, l_size, snap.index_store.universe)
        return snapshot_search(snap, queries, p, self.device)


def snapshot_search(snap: Snapshot, queries: np.ndarray, p: SearchParams,
                    device=None) -> tuple[np.ndarray, np.ndarray]:
    """Search one live snapshot with the frozen-index engine (§3.5 reads) on
    ``device`` (None = the card, where the snapshot's view must be):
    ``search`` over the snapshot's device view (tombstones masked in-beam
    via ``p.filter_tombstones``) + the brute-force memtable side-scan over
    buffered inserts, merged by the serving tier's top-K merge. ``p`` must
    carry the snapshot's EF universe."""
    queries = np.asarray(queries, np.float32)
    ids, dists, _ = search(snap.device, queries, p, device)
    gids = ids.cpu().numpy().astype(np.int64)
    gd = dists.cpu().numpy().astype(np.float32)
    mids, md = memtable_topk(snap, queries, p.k, device)
    out_i, out_d = merge_topk(np.stack([gids, mids]).astype(np.int64),
                              np.stack([gd, md]), p.k)
    return out_i, out_d
