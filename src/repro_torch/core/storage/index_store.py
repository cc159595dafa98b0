"""Block-based compressed auxiliary-index store (paper §3.3) with the
fixed-entry LRU cache of §3.4.

Each 4 KiB block holds multiple Elias-Fano-compressed adjacency lists behind
a block header; a sparse in-memory index maps boundary vertex IDs to block
offsets (4 B/entry — the paper's ~19.6 MiB @ SIFT100M structure). The LRU
cache stores *compressed* lists in fixed-size entries sized to the EF
worst-case bound, so more lists fit than with 32-bit raw lists (≥20.9% at
R=128, N=1e9 — §3.4).

The port of ``repro.core.storage.index_store``. The block image and its
record tables (``data``, ``sparse_index``, ``rec_block``, ``rec_start``,
``rec_len``) are tensors on the store's device (the card unless the caller
asks for the CPU). ``from_graph`` takes the graph as a list of arrays or as
one ``[n, W]`` tensor padded with -1 (a shard's 31M lists), encodes every
Elias-Fano record with the batched torch coder and packs them with
``pack_blocks_torch``: the same bytes as the reference. The per-vertex
read API (``get_neighbors``, ``get_neighbors_batch``, prefetch) is the
reference's host-side I/O model and decodes one record on the host;
``decode_batch`` decodes many records where they lie (one
``ef_record_decode`` launch on the card).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ... import tracing
from ...kernels import dispatch
from ...kernels.ef_record_decode.ef_record_decode import (MAX_RECORD_BYTES,
                                                          fits_stage)
from ..codec import elias_fano as ef
from ..codec import registry as codecs
from ..search.beam import resolve_device
from .blockstore import BlockStore, IOStats, LRUCache, PrefetchQueue
from .layout import (BLOCK_SIZE, block_bytes_needed, locate_block,
                     locate_block_runs, pack_block_image, pack_blocks,
                     pack_blocks_coresident, pack_blocks_torch)

#: BlockStore component this tier accounts under (see blockstore.py).
COMPONENT = "adjacency"

#: Rows of a padded adjacency sorted and encoded at a time.
_ROW_BATCH = 1 << 18


def _record_bound(codec: str, r: int, universe: int) -> int:
    """Worst-case encoded bytes of one R-list under ``codec`` — the §3.4
    fixed-entry LRU sizing, dispatched to the codec's own bound so the
    sizing rule lives in ONE place per codec (a codec without a
    ``record_bound`` is not an adjacency candidate and raises loudly
    rather than mis-sizing the cache)."""
    cdc = codecs.get(codec)
    bound = getattr(cdc, "record_bound", None)
    if bound is None:
        raise ValueError(f"codec {codec!r} declares no adjacency record "
                         f"bound (not an index-store codec)")
    return bound(r, universe)


def padded_adjacency(adjacency) -> torch.Tensor:
    """A list of id arrays -> one int64 ``[n, max degree]`` tensor padded
    with -1; a 2-D tensor or array is taken as already padded."""
    if isinstance(adjacency, torch.Tensor):
        return adjacency
    if isinstance(adjacency, np.ndarray) and adjacency.ndim == 2:
        return torch.from_numpy(adjacency)
    lists = [np.asarray(a, np.int64).reshape(-1) for a in adjacency]
    width = max([len(a) for a in lists], default=0)
    out = np.full((len(lists), max(1, width)), -1, np.int64)
    for i, a in enumerate(lists):
        out[i, :len(a)] = a
    return torch.from_numpy(out)


def _lists(padded: torch.Tensor) -> list[np.ndarray]:
    """-1-padded rows -> the list of arrays (host)."""
    rows = padded.cpu().numpy()
    return [r[r >= 0].astype(np.int64) for r in rows]


def _np(t):
    return None if t is None else t.cpu().numpy()


def _on(dev, *arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            .to(dev) for a in arrays]


@dataclass
class RewriteReport:
    """Accounting for one index-store merge (incremental or full)."""
    blocks_rewritten: int = 0     # existing blocks repacked in place
    blocks_appended: int = 0      # fresh blocks for newly inserted vertices
    total_blocks: int = 0         # store size after the merge
    write_bytes: int = 0          # merge write I/O at block granularity
    dirty_records: int = 0        # adjacency lists re-encoded
    cache_invalidated: int = 0    # LRU entries dropped (dirty lists only)
    full_rebuild: bool = False    # incremental infeasible -> whole store


@dataclass
class CompressedIndexStore:
    """Codec-compressed adjacency lists in 4 KiB blocks + sparse index.

    The record codec is a registry name (``elias_fano`` default — the §3.2
    choice; the planner may select ``bitpack``/``raw`` when a dataset's id
    streams say so). I/O + cache come from a :class:`BlockStore` component
    (private engine unless one is shared in)."""
    data: torch.Tensor           # physical block image (uint8)
    n_blocks: int
    sparse_index: torch.Tensor   # [n_blocks] boundary first-id (int64)
    rec_block: torch.Tensor      # [n] block per vertex (int32)
    rec_start: torch.Tensor      # [n] absolute byte offset (int64)
    rec_len: torch.Tensor        # [n] record byte length (int32)
    universe: int
    r: int
    medoid: int                  # EXTERNAL id (like every id at this API)
    io: IOStats = None
    cache: LRUCache = None
    fill_factor: float = 1.0     # build-time block fill cap (rewrite headroom)
    codec: str = "elias_fano"    # adjacency record codec (registry name)
    blocks: BlockStore = None    # owning engine (None for direct construction)
    #: Seal-time locality ordering (``core/graph/reorder.GraphOrder``) or
    #: None for external-id layout. Records live at internal positions and
    #: hold internal ids; the API stays external-id.
    order: object = None
    #: Co-resident seal layout (pack_blocks_coresident); the sparse index
    #: stays sorted through the runs indirection (run_first_id/run_block).
    coresident: bool = False
    run_first_id: torch.Tensor = None
    run_block: torch.Tensor = None
    #: Speculative block-read window (blockstore.PrefetchQueue), enabled by
    #: the engine via :meth:`enable_prefetch`. Only warms residency
    #: accounting — reads/decodes return identical data either way.
    prefetch: PrefetchQueue = None

    @classmethod
    def from_graph(cls, adjacency, medoid: int, r: int,
                   universe: int | None = None,
                   cache_bytes: int = 0,
                   fill_factor: float = 1.0,
                   codec: str = "elias_fano",
                   block_store: BlockStore = None,
                   order=None,
                   coresident: bool = False,
                   device=None) -> "CompressedIndexStore":
        """``adjacency``: a list of id arrays or an ``[n, W]`` tensor padded
        with -1. ``order`` may be a
        :class:`~repro_torch.core.graph.reorder.GraphOrder` or an
        ordering-kind string (``"bfs"``/``"bisection"``/``"identity"``,
        computed here from the graph + medoid); the permutation is applied
        at THIS seal point. ``coresident=True`` packs each record into the
        same 4 KiB block as its hottest in-order neighbors (host packing).
        ``device=None`` builds on the card."""
        dev = resolve_device(device)
        padded = padded_adjacency(adjacency)
        n = padded.shape[0]
        universe = universe or n
        if isinstance(order, str):
            from ..graph import reorder as _reorder
            order = _reorder.compute_order(_lists(padded), medoid, kind=order)
        cdc = codecs.get(codec)
        if order is not None:
            if order.n != n:
                raise ValueError(f"order covers {order.n} vertices, "
                                 f"graph has {n}")
            perm = torch.from_numpy(order.perm)
            rows = padded[torch.from_numpy(order.inv)].to(torch.int64)
            padded = torch.where(rows >= 0, perm[rows.clamp(min=0)], -1)
        run_first_id = run_block = None
        if codec == "elias_fano" and not coresident:
            lens = torch.empty(n, dtype=torch.int64, device=dev)
            for a in range(0, n, _ROW_BATCH):
                v, cnt = ef.sort_lists_torch(padded[a:a + _ROW_BATCH].to(dev))
                lens[a:a + _ROW_BATCH] = ef.record_layout_torch(
                    v, cnt, universe)[1]
            pk = pack_blocks_torch(torch.arange(n, device=dev), lens,
                                   implicit_ids=True, fill_factor=fill_factor)
            for a in range(0, n, _ROW_BATCH):
                v, cnt = ef.sort_lists_torch(padded[a:a + _ROW_BATCH].to(dev))
                ef.encode_records_into_torch(
                    pk.data, pk.rec_start[a:a + _ROW_BATCH], v, cnt,
                    universe)
        else:
            internal_adj = [np.sort(a) for a in _lists(padded)]
            records = [cdc.encode(adj.astype(np.uint64), universe=universe)
                       for adj in internal_adj]
            if coresident:
                pk = pack_blocks_coresident(np.arange(n), records,
                                            internal_adj,
                                            fill_factor=fill_factor)
                run_first_id, run_block = _on(dev, pk.run_first_id,
                                              pk.run_block)
                pk.data, pk.rec_block, pk.rec_start, pk.rec_len, \
                    pk.block_first_id = _on(dev, pk.data, pk.rec_block,
                                            pk.rec_start, pk.rec_len,
                                            pk.block_first_id)
            else:
                offsets = np.concatenate(
                    [[0], np.cumsum([len(x) for x in records])]).astype(
                        np.int64)
                payload = np.concatenate(records) if records \
                    else np.zeros(0, np.uint8)
                pk = pack_blocks_torch(
                    torch.arange(n, device=dev), torch.from_numpy(
                        np.diff(offsets)).to(dev), implicit_ids=True,
                    fill_factor=fill_factor,
                    payload=torch.from_numpy(payload).to(dev),
                    offsets=torch.from_numpy(offsets).to(dev))
        bs = block_store or BlockStore()
        entry_bytes = _record_bound(codec, r, universe)
        return cls(data=pk.data, n_blocks=pk.n_blocks,
                   sparse_index=pk.block_first_id, rec_block=pk.rec_block,
                   rec_start=pk.rec_start, rec_len=pk.rec_len,
                   universe=universe, r=r, medoid=medoid,
                   io=bs.fresh_io(COMPONENT),
                   cache=bs.register_cache(COMPONENT, entry_bytes,
                                           cache_bytes),
                   fill_factor=fill_factor, codec=codec, blocks=bs,
                   order=order, coresident=coresident,
                   run_first_id=run_first_id, run_block=run_block)

    # ------------------------------------------------------ incremental merge
    def rewrite_blocks(self, adjacency: list, dirty_ids,
                       medoid: int | None = None
                       ) -> tuple["CompressedIndexStore", RewriteReport] | None:
        """Block-granular merge: re-encode ONLY the adjacency lists in
        ``dirty_ids`` and rewrite ONLY the 4 KiB blocks that hold them;
        vertices appended past the current universe of records are packed
        into fresh blocks at the tail. Returns a NEW store (the receiver is
        immutable so in-flight snapshots keep reading the old image) plus a
        :class:`RewriteReport`, or ``None`` when the incremental path is
        infeasible (a dirty block overflows 4 KiB, a new neighbor id falls
        outside the store's EF universe, or an insert into an ordered or
        co-resident store) and the caller must rebuild (``from_graph``).

        The reference's host algorithm, run on host copies of the block
        image and record tables; the new store's tensors go back to the
        receiver's device.
        """
        rec_block0, rec_start0 = _np(self.rec_block), _np(self.rec_start)
        rec_len0, data0 = _np(self.rec_len), _np(self.data)
        n_old = len(rec_start0)
        n_new = len(adjacency)
        if n_new < n_old:
            return None
        if self.order is not None and n_new > n_old:
            return None
        if self.coresident and n_new > n_old:
            return None
        dirty_list = list(dirty_ids)
        dirty = np.unique(np.asarray(dirty_list, np.int64)) \
            if dirty_list else np.zeros(0, np.int64)
        appended = np.arange(n_old, n_new, dtype=np.int64)
        dirty_old = dirty[(dirty >= 0) & (dirty < n_old)]
        perm = self.order.perm if self.order is not None else None
        dirty_pos = perm[dirty_old] if perm is not None else dirty_old
        cdc = codecs.get(self.codec)
        recs: dict[int, np.ndarray] = {}          # keyed by POSITION
        for ext, pos in zip(np.concatenate([dirty_old, appended]),
                            np.concatenate([dirty_pos, appended])):
            adj = np.asarray(adjacency[int(ext)], np.int64)
            if perm is not None:
                adj = perm[adj]
            adj = np.sort(adj.astype(np.uint64))
            if len(adj) and int(adj[-1]) >= self.universe:
                return None
            recs[int(pos)] = cdc.encode(adj, universe=self.universe)

        data = data0.copy()
        rec_block = np.concatenate([rec_block0,
                                    np.zeros(len(appended), np.int32)])
        rec_start = np.concatenate([rec_start0,
                                    np.zeros(len(appended), np.int64)])
        rec_len = np.concatenate([rec_len0,
                                  np.zeros(len(appended), np.int32)])
        touched = np.unique(rec_block0[dirty_pos]) \
            if len(dirty_pos) else np.zeros(0, np.int32)
        implicit = not self.coresident
        for b in touched:
            if self.coresident:
                members = np.flatnonzero(rec_block0 == b)
            else:
                members = np.arange(
                    np.searchsorted(rec_block0, b, side="left"),
                    np.searchsorted(rec_block0, b, side="right"))
            payloads = []
            for vid in members:
                vid = int(vid)
                if vid in recs:
                    payloads.append(recs[vid])
                else:
                    s = int(rec_start0[vid])
                    payloads.append(data0[s:s + int(rec_len0[vid])])
            need = block_bytes_needed(len(members),
                                      sum(len(p) for p in payloads),
                                      implicit_ids=implicit)
            if need > BLOCK_SIZE:                  # grown past the block
                return None
            base = int(b) * BLOCK_SIZE
            img, offsets = pack_block_image(members, payloads,
                                            implicit_ids=implicit)
            for vid, off, rec in zip(members, offsets, payloads):
                rec_start[int(vid)] = base + int(off)
                rec_len[int(vid)] = len(rec)
            data[base:base + BLOCK_SIZE] = img
        sparse_index = _np(self.sparse_index)
        n_blocks = self.n_blocks
        if len(appended):
            pk = pack_blocks(appended, [recs[int(v)] for v in appended],
                             implicit_ids=True, fill_factor=self.fill_factor)
            data = np.concatenate([data, pk.data])
            rec_block[n_old:] = pk.rec_block + n_blocks
            rec_start[n_old:] = pk.rec_start + n_blocks * BLOCK_SIZE
            rec_len[n_old:] = pk.rec_len
            sparse_index = np.concatenate([sparse_index, pk.block_first_id])
            n_blocks += pk.n_blocks
        cache = self.cache.clone() if self.cache is not None else None
        invalidated = cache.invalidate(dirty_old) if cache is not None else 0
        if cache is not None and self.blocks is not None:
            self.blocks.replace_cache(COMPONENT, cache)
        report = RewriteReport(
            blocks_rewritten=len(touched),
            blocks_appended=n_blocks - self.n_blocks,
            total_blocks=n_blocks,
            write_bytes=(len(touched) + n_blocks - self.n_blocks) * BLOCK_SIZE,
            dirty_records=len(recs), cache_invalidated=invalidated)
        io = self.blocks.fresh_io(COMPONENT) if self.blocks is not None \
            else IOStats()
        io.write(report.write_bytes, n=len(touched) + report.blocks_appended)
        dev = self.data.device
        data, sparse_index, rec_block, rec_start, rec_len = _on(
            dev, data, sparse_index, rec_block, rec_start, rec_len)
        store = CompressedIndexStore(
            data=data, n_blocks=n_blocks, sparse_index=sparse_index,
            rec_block=rec_block, rec_start=rec_start, rec_len=rec_len,
            universe=self.universe, r=self.r,
            medoid=self.medoid if medoid is None else medoid,
            io=io, cache=cache, fill_factor=self.fill_factor,
            codec=self.codec, blocks=self.blocks, order=self.order,
            coresident=self.coresident,
            run_first_id=self.run_first_id, run_block=self.run_block)
        return store, report

    # ------------------------------------------------------------- reads
    def _pos(self, vid: int) -> int:
        """External id -> internal record position (identity when no
        seal-time ordering is set)."""
        if self.order is not None:
            return int(self.order.perm[int(vid)])
        return int(vid)

    def block_of(self, vid: int) -> int:
        """Block index holding ``vid``'s record — the unit a beam hop pays
        T_IO for (blocks-per-hop accounting in engine.py)."""
        return int(self.rec_block[self._pos(vid)])

    def _decode_record(self, vid: int) -> np.ndarray:
        pos = self._pos(vid)
        s = int(self.rec_start[pos])
        rec = self.data[s:s + int(self.rec_len[pos])].cpu().numpy()
        vals = codecs.get(self.codec).decode(
            rec, universe=self.universe).astype(np.int64)
        if self.order is not None:
            vals = np.sort(self.order.inv[vals])
        return vals

    def decode_batch(self, ids) -> tuple[torch.Tensor, torch.Tensor]:
        """Decode the records of many vertices at once where the image
        lies (Elias-Fano records only; no I/O accounting, no cache): the
        bulk check that every record round-trips, and a restore's read of
        the lists. Returns (sorted external neighbor ids ``[B, max count]``
        int64 padded with -1, counts): ``dispatch.ef_record_decode``, one
        kernel launch and one read of the largest count on the card. An id
        outside [0, n) gets count -1 and a row of -1. A store whose records
        could be longer than the kernel stages is refused."""
        if self.codec != "elias_fano":
            raise ValueError("decode_batch decodes Elias-Fano records only")
        if not fits_stage(self.r, self.universe):
            raise ValueError(
                f"decode_batch: records of up to {self.r} ids below "
                f"{self.universe} may be longer than {MAX_RECORD_BYTES} B")
        with tracing.span("istore.decode_batch"):
            if not isinstance(ids, torch.Tensor):
                ids = torch.from_numpy(np.ascontiguousarray(ids,
                                                            dtype=np.int64))
            pos = ids.to(device=self.data.device,
                         dtype=torch.int64).contiguous()
            if self.order is not None:
                n = self.rec_start.shape[0]
                perm = torch.from_numpy(self.order.perm).to(pos.device)
                inside = (pos >= 0) & (pos < n)
                pos = torch.where(inside, perm[pos.clamp(0, max(n - 1, 0))],
                                  -1)
            vals, cnt = dispatch.ef_record_decode(
                self.data, self.rec_start, self.rec_len, pos)
            if self.order is not None:
                inv = torch.from_numpy(self.order.inv).to(vals.device)
                big = torch.iinfo(torch.int64).max
                vals = torch.where(vals >= 0, inv[vals.clamp(min=0)], big)
                vals = vals.sort(1).values
                vals = torch.where(vals == big, -1, vals)
            return vals, cnt

    def _demand_block(self, bid: int) -> bool:
        """Account one demand block fetch. Returns True when the block was
        already resident in the prefetch window (speculative or buffered) —
        no new read, no stall; otherwise accounts the read and enters the
        block into the window as a buffered (consumed) entry."""
        if self.prefetch is not None and self.prefetch.take(bid):
            return True
        self.io.read(BLOCK_SIZE)
        if self.prefetch is not None:
            self.prefetch.fill(bid)
        return False

    def get_neighbors(self, vid: int) -> np.ndarray:
        cached = self.cache.get(vid)
        if cached is not None:
            return cached
        if self._demand_block(self.block_of(int(vid))):
            self.cache.note_prefetch_hit()       # absent list, resident block
        out = self._decode_record(int(vid))
        self.cache.put(int(vid), out)
        return out

    def get_neighbors_batch(self, ids) -> dict:
        """One beam hop's frontier reads with block dedup: cache misses
        that share a 4 KiB block cost ONE read. Returns {external id ->
        sorted external neighbor ids}; per-list decode accounting is
        unchanged. Blocks already resident in the prefetch window skip the
        read (their lists reclassify miss -> prefetch hit)."""
        out: dict[int, np.ndarray] = {}
        misses: list[int] = []
        for vid in ids:
            vid = int(vid)
            cached = self.cache.get(vid)
            if cached is not None:
                out[vid] = cached
            else:
                misses.append(vid)
        if misses:
            served = {int(b) for b in
                      np.unique([self.block_of(v) for v in misses])
                      if self._demand_block(int(b))}
            for vid in misses:
                if self.block_of(vid) in served:
                    self.cache.note_prefetch_hit()
                rec = self._decode_record(vid)
                self.cache.put(vid, rec)
                out[vid] = rec
        return out

    # ---------------------------------------------------------- prefetch
    def enable_prefetch(self, depth: int = 8, budget: int = 32
                        ) -> PrefetchQueue:
        """Attach the speculative block-read window (idempotent for
        unchanged bounds; registered on the owning BlockStore)."""
        bs = self.blocks if self.blocks is not None else BlockStore()
        self.blocks = bs
        self.prefetch = bs.register_prefetch(COMPONENT, depth, budget)
        return self.prefetch

    def prefetch_hint(self, ids) -> int:
        """Speculatively read the blocks holding ``ids``'s records. Pure
        accounting warm-up: never decodes, never touches the record cache's
        stats, never changes traversal. Returns the block reads issued."""
        if self.prefetch is None:
            return 0
        n = 0
        for vid in ids:
            vid = int(vid)
            if self.cache.peek(vid) is not None:   # list already decoded
                continue
            if self.prefetch.offer(self.block_of(vid)):
                self.io.read(BLOCK_SIZE)
                n += 1
        return n

    def drain_prefetch(self) -> int:
        """End-of-search barrier: unconsumed speculations become waste and
        the per-search waste budget resets."""
        return self.prefetch.drain() if self.prefetch is not None else 0

    # ------------------------------------------------------------- sizes
    @property
    def physical_bytes(self) -> int:
        return self.n_blocks * BLOCK_SIZE

    @property
    def sparse_index_bytes(self) -> int:
        if self.coresident and self.run_first_id is not None:
            # Runs indirection: 4 B boundary id + 4 B block per run.
            return 8 * len(self.run_first_id)
        return 4 * self.n_blocks                  # 4 B/entry (§3.3)

    def locate(self, vid: int) -> int:
        """Sparse-index block lookup for ``vid`` (external id). Must agree
        with ``block_of`` for every stored id; the co-resident tier answers
        through the sorted runs indirection."""
        pos = self._pos(vid)
        if self.coresident and self.run_first_id is not None:
            return locate_block_runs(_np(self.run_first_id),
                                     _np(self.run_block), pos)
        return locate_block(_np(self.sparse_index), pos)

    @classmethod
    def sparse_index_worst_case_bytes(cls, n: int, r: int) -> int:
        bits = ef.worst_case_bits(r, n)
        return -(-n * bits // 8192)               # paper formula (§3.3)


@dataclass
class RawIndexStore:
    """Uncompressed decoupled adjacency store ("Decouple" ablation arm):
    fixed-size records (count + R ids), direct offset by vertex ID.
    ``neighbors`` is a list of arrays or an ``[n, W]`` tensor padded with
    -1 (a shard's graph stays one tensor)."""
    neighbors: object
    r: int
    medoid: int
    io: IOStats = None
    cache: LRUCache = None
    blocks: BlockStore = None

    @classmethod
    def from_graph(cls, adjacency, medoid: int, r: int,
                   cache_bytes: int = 0,
                   block_store: BlockStore = None) -> "RawIndexStore":
        entry_bytes = 4 * (r + 1)
        bs = block_store or BlockStore()
        neighbors = adjacency if isinstance(adjacency, torch.Tensor) \
            else [np.asarray(a, np.int64) for a in adjacency]
        return cls(neighbors=neighbors,
                   r=r, medoid=medoid, io=bs.fresh_io(COMPONENT),
                   cache=bs.register_cache(COMPONENT, entry_bytes,
                                           cache_bytes),
                   blocks=bs)

    def get_neighbors(self, vid: int) -> np.ndarray:
        cached = self.cache.get(vid)
        if cached is not None:
            return cached
        self.io.read(BLOCK_SIZE)
        out = self.neighbors[int(vid)]
        if isinstance(out, torch.Tensor):
            out = out[out >= 0].cpu().numpy().astype(np.int64)
        self.cache.put(int(vid), out)
        return out

    @property
    def record_bytes(self) -> int:
        return 4 * (self.r + 1)

    @property
    def physical_bytes(self) -> int:
        # fixed-size records packed into blocks (no spanning)
        per_block = BLOCK_SIZE // self.record_bytes
        if per_block == 0:
            per_blk_blocks = -(-self.record_bytes // BLOCK_SIZE)
            return len(self.neighbors) * per_blk_blocks * BLOCK_SIZE
        return -(-len(self.neighbors) // per_block) * BLOCK_SIZE
