"""Batch-visible consistency model (paper §3.5) with a device-resident view —
the port of ``repro.core.update.consistency``.

Searches run against an immutable *snapshot* (index store + vector store +
tombstone set). A merge builds the next snapshot in the background and
publishes it atomically; in-flight queries keep referencing the old snapshot
(Python object lifetime models the paper's "stale segments released only
after in-flight queries finalize"). Newly deleted vectors are filtered by the
tombstone set even before their on-disk references are removed, so they are
never returned mid-batch.

Every snapshot carries a cached **device view**: the same
:class:`~repro_torch.core.search.beam.DeviceIndex` a frozen index serves
from — padded adjacency, EF slots, PQ codes, re-rank vectors — plus a boolean
tombstone mask, built ONCE per publish (:func:`build_device_view`, patched
from the previous view where only a dirty subset of vertices changed). The
view's tensors are never written after the publish: a delete makes a NEW
mask (a clone with the bits set), so a batch that pinned the old snapshot
keeps the old mask. Buffered inserts are covered by the brute-force memtable
side-scan (:func:`memtable_topk`) merged into the graph top-K.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ...kernels import dispatch
from ..codec.elias_fano import encode_slots_torch, slot_layout
from ..search.beam import DeviceIndex, resolve_device


@dataclass(frozen=True)
class Snapshot:
    version: int
    index_store: object
    vector_store: object
    pq_codes: object
    tombstones: frozenset = frozenset()
    mem_rows: dict = field(default_factory=dict)   # buffered inserts id->vec
    device: DeviceIndex | None = None   # device view + tombstone mask
                                        # (publish-time artifact; never
                                        # written — with_tombstones swaps in
                                        # a new mask)


def build_device_view(adjacency: list, medoid: int, pq_codes: np.ndarray,
                      pq_centroids: np.ndarray, fetch_vectors, dim: int,
                      r_max: int, universe: int,
                      prev: DeviceIndex | None = None,
                      dirty=None, device=None) -> DeviceIndex:
    """Host graph state -> the device-resident :class:`DeviceIndex` a
    snapshot serves from (padded adjacency + EF slots + PQ codes + re-rank
    vectors + a cleared tombstone mask) on ``device`` (None = the card).

    ``fetch_vectors(ids) -> [k, dim]`` (array or tensor) supplies re-rank
    rows (the update tier backs it with the vector store, zero-filling ids
    whose records are gone — such vertices are unreachable after
    delete-repair).

    With ``prev`` + ``dirty`` (and an unchanged EF slot layout — same
    ``r_max``/``universe``) only the dirty rows and the appended tail are
    re-encoded/re-fetched; everything else is copied from the previous view
    into new tensors (the previous view stays as it was). The lists are
    encoded by the batched slot coder, bit-equal to the reference's
    per-vertex ``encode_slot``.
    """
    dev = resolve_device(device)
    n = len(adjacency)
    words = slot_layout(r_max, universe)[3]
    n_prev = prev.neighbors.shape[0] if prev is not None else 0
    reuse = (prev is not None and dirty is not None and n_prev <= n
             and prev.ef_slots.shape[1] == words
             and prev.neighbors.shape[1] == r_max
             and prev.vectors.shape[1] == dim)
    nbrs = torch.full((n, r_max), -1, dtype=torch.int32, device=dev)
    cnts = torch.zeros(n, dtype=torch.int32, device=dev)
    slots = torch.zeros((n, words), dtype=torch.int32, device=dev)
    vecs = torch.zeros((n, dim), dtype=torch.float32, device=dev)
    if reuse:
        nbrs[:n_prev] = prev.neighbors
        cnts[:n_prev] = prev.counts
        slots[:n_prev] = prev.ef_slots
        vecs[:n_prev] = prev.vectors
        todo = sorted({int(d) for d in dirty if 0 <= int(d) < n}
                      | set(range(n_prev, n)))
    else:
        todo = range(n)
    todo = np.asarray(list(todo), np.int64)
    if len(todo):
        rows = np.full((len(todo), r_max), -1, np.int64)
        counts = np.zeros(len(todo), np.int64)
        for j, i in enumerate(todo):
            adj = np.sort(np.asarray(adjacency[i], np.int64))[:r_max]
            rows[j, :len(adj)] = adj
            counts[j] = len(adj)
        rows_t = torch.from_numpy(rows).to(dev)
        at = torch.from_numpy(todo).to(dev)
        nbrs[at] = rows_t.to(torch.int32)
        cnts[at] = torch.from_numpy(counts).to(dev, torch.int32)
        slots[at] = encode_slots_torch(rows_t, torch.from_numpy(counts).to(dev),
                                       r_max, universe)
        vecs[at] = torch.as_tensor(fetch_vectors(todo)).to(dev, torch.float32)
    return DeviceIndex(
        neighbors=nbrs, counts=cnts, ef_slots=slots,
        pq_codes=torch.from_numpy(np.ascontiguousarray(pq_codes, np.uint8))
        .to(dev),
        pq_centroids=torch.from_numpy(np.ascontiguousarray(
            pq_centroids, np.float32)).to(dev),
        vectors=vecs,
        medoid=torch.tensor(int(medoid), dtype=torch.int64, device=dev),
        tombstone=torch.zeros(n, dtype=torch.bool, device=dev))


def memtable_topk(snap: Snapshot, queries: np.ndarray, k: int,
                  device=None) -> tuple[np.ndarray, np.ndarray]:
    """Brute-force side-scan of the snapshot's buffered inserts (§3.5):
    exact L2 against every live mem row -> (ids [nq, k], d [nq, k]) padded
    with (-1, +inf), on the host. The live rows go to ``device`` (None = the
    card) as one ``[n_mem, D]`` table and every query reads all of them by
    id through ``dispatch.rerank_l2`` — the memtable is one more
    exact-distance batch to the compute tier."""
    queries = np.asarray(queries, np.float32)
    nq = len(queries)
    ids = np.full((nq, k), -1, np.int64)
    d = np.full((nq, k), np.inf, np.float32)
    rows = [(i, v) for i, v in snap.mem_rows.items()
            if i not in snap.tombstones]
    if not rows:
        return ids, d
    dev = resolve_device(device)
    mids = np.asarray([i for i, _ in rows], np.int64)
    mat = np.stack([np.asarray(v, np.float32) for _, v in rows])
    table = torch.from_numpy(mat).to(dev)
    every = torch.arange(len(rows), dtype=torch.int32, device=dev)
    dd = dispatch.rerank_l2(torch.from_numpy(queries).to(dev), table,
                            ids=every.expand(nq, -1).contiguous())
    dd = dd.cpu().numpy()
    take = min(k, len(rows))
    order = np.argsort(dd, axis=1, kind="stable")[:, :take]
    ids[:, :take] = mids[order]
    d[:, :take] = np.take_along_axis(dd, order, 1)
    return ids, d


class SnapshotHandle:
    """Atomic snapshot publication point."""

    def __init__(self, initial: Snapshot):
        self._lock = threading.Lock()
        self._snap = initial

    def current(self) -> Snapshot:
        with self._lock:
            return self._snap

    def publish(self, snap: Snapshot) -> None:
        with self._lock:
            if snap.version <= self._snap.version:
                raise ValueError("snapshot versions must increase")
            self._snap = snap

    def with_tombstones(self, ids) -> None:
        """Deletions become visible immediately (batch-visible reads): the
        id set grows AND the device view gets a new mask with the bits set
        (a clone: a batch that pinned the previous snapshot keeps its
        mask), so both the host filters and the in-beam re-rank mask see
        them without a publish."""
        with self._lock:
            ids = [int(i) for i in ids]
            snap = self._snap
            dev = snap.device
            if dev is not None and dev.tombstone is not None:
                n = int(dev.tombstone.shape[0])
                hit = [i for i in ids if 0 <= i < n]
                if hit:
                    mask = dev.tombstone.clone()
                    mask[torch.tensor(hit, dtype=torch.int64,
                                      device=mask.device)] = True
                    dev = dev._replace(tombstone=mask)
            self._snap = replace(snap,
                                 tombstones=snap.tombstones | frozenset(ids),
                                 device=dev)

    def with_mem_rows(self, rows: dict) -> None:
        with self._lock:
            merged = dict(self._snap.mem_rows)
            merged.update(rows)
            self._snap = replace(self._snap, mem_rows=merged)


class ShardedSnapshotHandle:
    """Per-shard publication points for the sharded serving tier: each shard
    carries its OWN :class:`SnapshotHandle` (its updater publishes
    independently), and a batch pins a consistent **version vector** — one
    :meth:`pin` reads every shard's current snapshot once, so no served
    batch spans a publish on any shard.

    ``offsets[i]`` translates shard *i*'s local ids to global ids. The
    default reserves each shard's full id headroom — the previous shards'
    EF slot universes — so ids stay disjoint even as shards grow toward
    their universe; pass explicit offsets for a pre-assigned global id
    space. Shards must share one EF geometry (r, universe).
    """

    def __init__(self, handles: list, offsets: list | None = None):
        if not handles:
            raise ValueError("need at least one shard handle")
        self.handles = list(handles)
        if offsets is None:
            offsets, off = [], 0
            for h in self.handles:
                offsets.append(off)
                snap = h.current()
                store = snap.index_store
                off += int(store.universe if store is not None
                           else snap.device.pq_codes.shape[0])
        if len(offsets) != len(self.handles):
            raise ValueError(f"{len(offsets)} offsets for "
                             f"{len(self.handles)} shards")
        self.offsets = [int(o) for o in offsets]

    def __len__(self) -> int:
        return len(self.handles)

    def pin(self) -> list:
        """One consistent snapshot per shard (the batch's version vector:
        ``[s.version for s in pin()]``)."""
        return [h.current() for h in self.handles]

    def versions(self) -> list:
        return [h.current().version for h in self.handles]
