"""Decoupled, log-structured, compressed vector data store (paper §3.3, §3.5).

Segment -> chunk -> 4 KiB block hierarchy:

- A *mutable* segment accepts log-structured appends. At capacity it is
  *sealed*: each chunk (C uncompressed bytes) takes the two-stage compression
  decision (sampled-entropy XOR-delta test, then a single per-segment Huffman
  table over the transformed bytes), and records are packed into blocks.
- Chunk metadata (block offsets/counts, block boundary ids, base vector) and
  the per-segment frequency table are the in-memory compression metadata whose
  footprint the β parameter bounds.
- Deletions mark records stale; GC (§3.5) greedily rewrites the highest
  garbage-ratio segments, copying live records into fresh mutable segments and
  atomically switching the id→location mapping.

I/O accounting models the paper's storage layer: every block touched is a
4 KiB read; appends and GC copies are logged writes.

The port of ``repro.core.storage.vector_store``. Segments live on the
store's device (``StoreConfig.device``; None = the card): the mutable
segment is a byte buffer, and a sealed segment keeps its block image, record
tables, ids, stale mask and chunk bases as tensors. The seal takes the §3.3
decisions with ``xor_delta.chunk_decisions_torch``, builds the segment's
Huffman table(s) from a device histogram, packs every chunk at once with
``pack_blocks_torch`` and encodes each record straight into its block; it
keeps the segment's chunk bases stacked, with each chunk's index into
them. The load path (``decode_rows``) makes one ``dispatch.huffman_decode``
call per segment: the reference's ``decode_at`` and its per-chunk
``_undelta`` in one op, the ``huffman_decode`` kernel on the card. The
id -> (segment, row) map is three sorted tensors instead of a dict.
Results, bytes and I/O counts equal the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ... import tracing
from ...kernels import dispatch
from ..codec import huffman, xor_delta
from ..search.beam import resolve_device
from .blockstore import BlockStore, IOStats
from .layout import (BLOCK_SIZE, PackedBlocks, chunk_size_for_beta, id_runs,
                     pack_blocks_coresident, pack_blocks_torch)

#: BlockStore component this tier accounts under (see blockstore.py).
COMPONENT = "vector_chunks"

#: Manifest codec name -> StoreConfig.vector_codec seal mode.
_CODEC_MODES = {"raw": "raw", "huffman": "huffman",
                "xor_delta_huffman": "xor_delta_huffman",
                "plane_huffman": "plane_huffman"}

_TORCH_DTYPES = {np.dtype(t): getattr(torch, t) for t in (
    "uint8", "int8", "int16", "int32", "int64", "float16", "float32",
    "float64")}
_NUMPY_DTYPES = {t: d for d, t in _TORCH_DTYPES.items()}

#: Bytes of a segment histogrammed or copied at a time during a seal.
_BATCH_BYTES = 1 << 26


def torch_dtype(dtype) -> torch.dtype:
    """A numpy or torch dtype -> the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype)]


def _rows_per_batch(v: int) -> int:
    return max(1, _BATCH_BYTES // max(1, v))


def _stack_bases(bases: list, v: int, device):
    """A segment's per-chunk bases (a [V] uint8 tensor or None each) ->
    (each chunk's base as a row of the stack, or None; the stack [c, V];
    each chunk's row in it, [n_chunks] int32, -1 = no base)."""
    have = [b for b in bases if b is not None]
    stack = torch.stack(have) if have else torch.zeros(
        (0, v), dtype=torch.uint8, device=device)
    index, rows, k = [], [], 0
    for b in bases:
        index.append(-1 if b is None else k)
        rows.append(None if b is None else stack[k])
        k += b is not None
    return rows, stack, torch.tensor(index, dtype=torch.int32,
                                     device=device)


@dataclass
class ChunkMeta:
    first_block: int
    n_blocks: int
    boundary_ids: torch.Tensor   # first id of each block in this chunk
    base: torch.Tensor | None    # XOR base (None -> delta not applied)
    n_runs: int = 0              # coresident packing: sorted id runs in the
                                 # indirection sparse index (0 = in-order
                                 # layout, one boundary id per block)

    @property
    def meta_bytes(self) -> int:
        # offset(4) + n_blocks(4) + base vector V bytes + sparse index:
        # 4 per boundary id in order, 8 per run (id + block) co-resident.
        base = len(self.base) if self.base is not None else 0
        index = 8 * self.n_runs if self.n_runs else 4 * len(self.boundary_ids)
        return 8 + index + base


@dataclass
class SealedSegment:
    ids: torch.Tensor            # [m] sorted int64
    packed: PackedBlocks         # physical block image (tensors)
    chunks: list[ChunkMeta]
    huff: object | None          # HuffmanTable | PlaneTables; None -> raw
    v_bytes: int
    dtype: torch.dtype
    dim: int
    rows_per_chunk: int
    bases: torch.Tensor          # [c, V] uint8: the chunks' bases, stacked
    chunk_base: torch.Tensor     # [n_chunks] int32 index into bases, -1 none
    stale: torch.Tensor = field(default=None)  # [m] bool

    def __post_init__(self):
        if self.stale is None:
            self.stale = torch.zeros(len(self.ids), dtype=torch.bool,
                                     device=self.ids.device)

    @property
    def physical_bytes(self) -> int:
        return self.packed.physical_bytes

    @property
    def metadata_bytes(self) -> int:
        t = sum(c.meta_bytes for c in self.chunks)
        if self.huff is not None:
            t += self.huff.size_bytes
        return t

    @property
    def garbage_ratio(self) -> float:
        m = len(self.ids)
        return int(self.stale.sum()) / m if m else 0.0

    def rows_of(self, ids) -> torch.Tensor:
        ids = torch.as_tensor(ids, dtype=torch.int64).to(self.ids.device)
        m = len(self.ids)
        rows = torch.searchsorted(self.ids, ids)
        ok = (rows < m) & (self.ids[rows.clamp(max=max(m - 1, 0))] == ids) \
            if m else torch.zeros_like(ids, dtype=torch.bool)
        with tracing.span("vstore.sync"):
            held = bool(ok.all())
        if not held:
            raise KeyError(f"ids not in segment: {ids[~ok][:5].tolist()}")
        return rows

    def account_reads(self, rows: torch.Tensor, io: IOStats) -> None:
        """One 4 KiB read for each distinct block holding ``rows``."""
        nblk = int(torch.unique(self.packed.rec_block[rows]).numel())
        io.read(nblk * BLOCK_SIZE, n=nblk)

    def decode_bytes(self, rows, io: IOStats | None = None) -> torch.Tensor:
        """Fetch + decompress records -> [k, V] uint8."""
        rows = torch.as_tensor(rows, dtype=torch.int64).to(self.ids.device)
        pk = self.packed
        if io is not None:
            self.account_reads(rows, io)
        with tracing.span("vstore.decode"):
            if self.huff is None:
                cols = torch.arange(self.v_bytes, device=rows.device)
                return pk.data[pk.rec_start[rows][:, None] + cols]
            base_of = self.chunk_base[rows // self.rows_per_chunk]
            return dispatch.huffman_decode(pk.data, pk.rec_start[rows],
                                           self.v_bytes, self.huff,
                                           self.bases, base_of)

    def decode_rows(self, rows, io: IOStats | None = None) -> torch.Tensor:
        """Fetch + decompress records -> [k, dim] of the store's dtype.

        The records are decoded, and the rows of every chunk with a base
        XOR-ed back, by one ``dispatch.huffman_decode`` call: the kernel
        for tensors on the card, its plain version on the CPU.
        """
        raw = self.decode_bytes(rows, io)
        return raw.view(self.dtype).reshape(raw.shape[0], self.dim)


class MutableSegment:
    """The log-structured append target: ids and raw record bytes in
    buffers on the store's device, grown as rows arrive."""

    def __init__(self, capacity: int, v_bytes: int, device):
        self.capacity = capacity
        self.v_bytes = v_bytes
        self.device = device
        self.n = 0
        self._ids = torch.zeros(0, dtype=torch.int64, device=device)
        self._rows = torch.zeros((0, v_bytes), dtype=torch.uint8,
                                 device=device)
        self.stale_set: set[int] = set()

    @property
    def ids(self) -> torch.Tensor:
        return self._ids[:self.n]

    @property
    def rows(self) -> torch.Tensor:
        return self._rows[:self.n]

    def append(self, ids: torch.Tensor, rows: torch.Tensor) -> int:
        take = min(self.capacity - self.n, len(ids))
        need = self.n + take
        if need > len(self._ids):
            size = min(self.capacity, max(need, 2 * len(self._ids)))
            grown = torch.zeros(size, dtype=torch.int64, device=self.device)
            grown[:self.n] = self.ids
            self._ids = grown
            grown = torch.zeros((size, self.v_bytes), dtype=torch.uint8,
                                device=self.device)
            grown[:self.n] = self.rows
            self._rows = grown
        self._ids[self.n:need] = ids[:take]
        self._rows[self.n:need] = rows[:take]
        self.n = need
        return take

    @property
    def full(self) -> bool:
        return self.n >= self.capacity


@dataclass
class StoreConfig:
    dim: int
    dtype: object                       # numpy or torch dtype
    segment_capacity: int = 4096        # vectors per segment (512 MiB / V in prod)
    chunk_bytes: int = 4 << 20          # C (4 MiB paper default)
    beta: float | None = None           # if set, derive C from β (§3.3)
    compress: bool = True               # False -> "Decouple" ablation arm
    vector_codec: str = "auto"          # seal-time codec mode: "auto" (the
                                        # §3.3 two-stage sampled-entropy
                                        # test), "xor_delta_huffman"
                                        # (forced delta), "huffman",
                                        # "plane_huffman", "raw";
                                        # planner-selected via from_manifest
    reorder: str | None = None          # the seal-time graph ordering this
                                        # store's rows were relabeled by
                                        # (manifest contract; the store
                                        # itself stays id-transparent)
    coresident: bool = False            # seal-time co-residency packing
                                        # of each chunk's records with their
                                        # graph neighbors (set_affinity)
    device: object = None               # where segments live; None = the
                                        # card (raise without one)

    @property
    def v_bytes(self) -> int:
        return int(torch_dtype(self.dtype).itemsize * self.dim)

    @property
    def resolved_codec(self) -> str:
        """The effective seal mode (compress=False overrides to raw)."""
        if not self.compress or self.vector_codec == "raw":
            return "raw"
        if self.vector_codec not in ("auto", "huffman", "xor_delta_huffman",
                                     "plane_huffman"):
            raise ValueError(f"unknown vector_codec {self.vector_codec!r}")
        return self.vector_codec

    def from_manifest(self, manifest) -> "StoreConfig":
        """Resolve the seal mode from a planner manifest's
        ``vector_chunks`` selection. A codec the store cannot seal with
        raises."""
        name = manifest.codec_for(COMPONENT, default="auto")
        if name != "auto" and name not in _CODEC_MODES:
            raise ValueError(
                f"manifest selected vector codec {name!r} but the vector "
                f"store implements only {sorted(_CODEC_MODES)} (+ 'auto')")
        mode = _CODEC_MODES.get(name, "auto")
        return replace(self, vector_codec=mode, compress=mode != "raw",
                       reorder=getattr(manifest, "reorder", None)
                       or self.reorder)

    @property
    def chunk_vectors(self) -> int:
        c = self.chunk_bytes if self.beta is None else \
            chunk_size_for_beta(self.beta, self.v_bytes)
        return max(1, c // self.v_bytes)


class DecoupledVectorStore:
    """Log-structured compressed vector data tier (paper §3.3 + §3.5).

    I/O is accounted through a :class:`BlockStore` component (a private
    engine unless one is shared in); ``self.io`` is this tier's
    per-component stats, chained into the engine total.
    """

    def __init__(self, config: StoreConfig, block_store: BlockStore = None):
        self.cfg = config
        self.device = resolve_device(config.device)
        self.dtype = torch_dtype(config.dtype)
        self.blocks = block_store or BlockStore()
        self.io = self.blocks.component_io(COMPONENT)
        self.sealed: dict[int, SealedSegment] = {}
        self._next_seg = 0
        self.active = self._new_mutable()
        # id -> (segment, row) as sorted parallel tensors; segment -1 is
        # the active (mutable) segment
        empty = torch.zeros(0, dtype=torch.int64, device=self.device)
        self._loc_ids, self._loc_seg, self._loc_row = empty, empty, empty
        self.compress_count = 0
        self._affinity = None       # id -> neighbor ids (coresident seals)

    # --------------------------------------------------------- id -> location
    def _ids(self, ids) -> torch.Tensor:
        if not isinstance(ids, torch.Tensor):
            ids = torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int64)
                                   .reshape(-1))
        return ids.to(device=self.device, dtype=torch.int64).reshape(-1)

    def _lookup(self, ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        n = len(self._loc_ids)
        pos = torch.searchsorted(self._loc_ids, ids).clamp(max=max(n - 1, 0))
        found = (self._loc_ids[pos] == ids) if n \
            else torch.zeros_like(ids, dtype=torch.bool)
        return found, pos

    def _set_loc(self, ids: torch.Tensor, seg, rows: torch.Tensor) -> None:
        """Point ``ids`` at (seg, rows); a repeated id keeps its last row."""
        if not len(ids):
            return
        order = torch.argsort(ids, stable=True)
        s = ids[order]
        last = torch.ones_like(s, dtype=torch.bool)
        last[:-1] = s[1:] != s[:-1]
        sel = order[last]
        seg = torch.as_tensor(seg, dtype=torch.int64, device=self.device)
        new_seg = seg.expand(len(ids))[sel]
        keep = ~torch.isin(self._loc_ids, ids[sel])
        all_ids = torch.cat([self._loc_ids[keep], ids[sel]])
        o = torch.argsort(all_ids)
        self._loc_ids = all_ids[o]
        self._loc_seg = torch.cat([self._loc_seg[keep], new_seg])[o]
        self._loc_row = torch.cat([self._loc_row[keep], rows[sel]])[o]

    def _drop_loc(self, ids: torch.Tensor) -> None:
        keep = ~torch.isin(self._loc_ids, ids)
        self._loc_ids = self._loc_ids[keep]
        self._loc_seg = self._loc_seg[keep]
        self._loc_row = self._loc_row[keep]

    @property
    def ids(self) -> torch.Tensor:
        """The ids the store holds a live record for, sorted (int64)."""
        return self._loc_ids

    def contains(self, ids) -> torch.Tensor:
        """Per id: whether the store holds a live record for it."""
        return self._lookup(self._ids(ids))[0]

    def location(self, ids) -> tuple[torch.Tensor, torch.Tensor]:
        """(segment, row) of each id (segment -1: the mutable segment);
        raise ``KeyError`` for an id the store does not hold."""
        ids = self._ids(ids)
        found, pos = self._lookup(ids)
        with tracing.span("vstore.sync"):
            held = bool(found.all())
        if not held:
            raise KeyError(int(ids[~found][0]))
        return self._loc_seg[pos], self._loc_row[pos]

    # ------------------------------------------------------------- writes
    def _new_mutable(self) -> MutableSegment:
        return MutableSegment(self.cfg.segment_capacity, self.cfg.v_bytes,
                              self.device)

    def _as_bytes(self, vecs) -> torch.Tensor:
        if not isinstance(vecs, torch.Tensor):
            vecs = torch.from_numpy(np.ascontiguousarray(
                vecs, dtype=_NUMPY_DTYPES[self.dtype]))
        vecs = vecs.to(device=self.device, dtype=self.dtype).contiguous()
        return vecs.view(torch.uint8).reshape(vecs.shape[0], self.cfg.v_bytes)

    def append(self, ids, vecs) -> None:
        ids = self._ids(ids)
        rows = self._as_bytes(vecs)
        while len(ids):
            take = self.active.append(ids, rows)
            self.io.write(take * self.cfg.v_bytes)   # log-structured append
            if self.active.full:
                self.seal_active()
            ids, rows = ids[take:], rows[take:]
        # Active-segment locations (rows never move until seal).
        self._set_loc(self.active.ids, -1,
                      torch.arange(self.active.n, device=self.device))

    def set_affinity(self, adjacency) -> None:
        """Install the graph adjacency (external id -> neighbor id array;
        a list indexed by id or a dict) that coresident seals group
        blocks by. Only consulted when ``cfg.coresident``; affects future
        seals, never already-sealed segments."""
        self._affinity = adjacency

    def _affinity_of(self, vid: int) -> np.ndarray:
        a = self._affinity
        if a is None:
            return np.zeros(0, np.int64)
        adj = a.get(vid) if hasattr(a, "get") else \
            (a[vid] if 0 <= vid < len(a) else None)
        return np.asarray(adj, np.int64) if adj is not None \
            else np.zeros(0, np.int64)

    def seal_active(self) -> None:
        seg = self.active
        if not seg.n:
            return
        order = torch.argsort(seg.ids, stable=True)
        ids = seg.ids[order]
        sealed = self._seal(ids, seg.rows[order])
        sid = self._next_seg
        self._next_seg += 1
        self.sealed[sid] = sealed
        m = len(ids)
        rows = torch.arange(m, device=self.device)
        # Rows deleted while still mutable stay out of the id->location map
        # and are marked stale in the sealed segment.
        stale = torch.tensor(sorted(seg.stale_set), dtype=torch.int64,
                             device=self.device)
        live = ~torch.isin(ids, stale)
        self._set_loc(ids[live], sid, rows[live])
        if len(stale):
            row = torch.searchsorted(ids, stale).clamp(max=m - 1)
            sealed.stale[row[ids[row] == stale]] = True
            self._drop_loc(stale)
        self.io.write(sealed.physical_bytes)   # background compression write
        self.active = self._new_mutable()

    def _table(self, data: torch.Tensor, mode: str):
        """The segment's Huffman table(s) from a device histogram of the
        transformed bytes (one table, or one per byte plane)."""
        v = data.shape[1]
        planes = self.dtype.itemsize if mode == "plane_huffman" else 1
        plane = ((torch.arange(v, device=data.device) % planes) << 8)[None]
        counts = torch.zeros(planes * 256, dtype=torch.int64,
                             device=data.device)
        step = _rows_per_batch(v)
        for a in range(0, data.shape[0], step):
            counts += torch.bincount(
                (plane + data[a:a + step].to(torch.int64)).reshape(-1),
                minlength=planes * 256)
        counts = counts.view(planes, 256).cpu().numpy()
        if mode == "plane_huffman":
            return huffman.PlaneTables([huffman.HuffmanTable.from_frequencies(
                c) for c in counts])
        return huffman.HuffmanTable.from_frequencies(counts[0])

    def _seal(self, ids: torch.Tensor, vb: torch.Tensor) -> SealedSegment:
        m, v = vb.shape
        dev = vb.device
        rpc = self.cfg.chunk_vectors
        chunk_lo = list(range(0, m, rpc))
        mode = self.cfg.resolved_codec
        bases: list[torch.Tensor | None] = [None] * len(chunk_lo)
        data = vb
        if mode != "raw":
            # Stage 1: per-chunk delta decision. "auto" runs the §3.3
            # sampled-entropy test; a planner-selected codec pins it.
            if mode == "xor_delta_huffman":
                sample = [max(1, (min(lo + rpc, m) - lo) // 10)
                          for lo in chunk_lo]
                bases = list(xor_delta.chunk_bases_torch(vb, rpc, sample)[0])
            elif mode == "auto":
                use, all_bases = xor_delta.chunk_decisions_torch(vb, rpc)
                bases = [b if u else None for u, b in zip(use, all_bases)]
            if any(b is not None for b in bases):
                data = vb.clone()
                for lo, base in zip(chunk_lo, bases):
                    if base is not None:
                        data[lo:lo + rpc] ^= base
            # Stage 2: per-segment frequency table(s).
            table = self._table(data, mode)
            lens = huffman.record_bytes_torch(data, table)
            self.compress_count += m
        else:
            table = None
            lens = torch.full((m,), v, dtype=torch.int64, device=dev)
        bases, stack, chunk_base = _stack_bases(bases, v, dev)
        if self.cfg.coresident and self._affinity is not None:
            return self._seal_coresident(ids, data, table, lens, bases,
                                         stack, chunk_base, rpc)
        # Pack every chunk at once (blocks never span chunks, Fig. 4), then
        # encode each record straight into its block.
        breaks = torch.tensor(chunk_lo, dtype=torch.int64, device=dev)
        pk = pack_blocks_torch(ids, lens, breaks=breaks)
        if table is not None:
            huffman.encode_into_torch(pk.data, pk.rec_start, data, table)
        else:
            cols = torch.arange(v, device=dev)
            step = _rows_per_batch(v)
            for a in range(0, m, step):
                pk.data[pk.rec_start[a:a + step][:, None] + cols] = \
                    vb[a:a + step]
        first = pk.rec_block[breaks].tolist() + [pk.n_blocks]
        chunks = [ChunkMeta(first_block=first[c],
                            n_blocks=first[c + 1] - first[c],
                            boundary_ids=pk.block_first_id[
                                first[c]:first[c + 1]],
                            base=bases[c]) for c in range(len(chunk_lo))]
        return SealedSegment(ids=ids, packed=pk, chunks=chunks, huff=table,
                             v_bytes=v, dtype=self.dtype, dim=self.cfg.dim,
                             rows_per_chunk=rpc, bases=stack,
                             chunk_base=chunk_base)

    def _seal_coresident(self, ids, data, table, lens, bases, stack,
                         chunk_base, rpc) -> SealedSegment:
        """Co-resident seal: the reference's host packing per chunk
        (``pack_blocks_coresident``), records encoded on the device first;
        the merged image and tables go back to the device."""
        dev = data.device
        m, v = data.shape
        if table is not None:
            payload, offsets = huffman.encode_records_torch(data, table)
        else:
            payload = data.reshape(-1)
            offsets = torch.arange(m + 1, device=dev) * v
        payload, offsets = payload.cpu().numpy(), offsets.cpu().numpy()
        records = [payload[offsets[i]:offsets[i + 1]] for i in range(m)]
        ids_np = ids.cpu().numpy()
        chunk_packs, chunks = [], []
        first_block = 0
        for ci, lo in enumerate(range(0, m, rpc)):
            hi = min(lo + rpc, m)
            cids = ids_np[lo:hi]
            nbrs = []
            for vid in cids:
                adj = self._affinity_of(int(vid))
                pos = np.searchsorted(cids, adj)
                np.clip(pos, 0, len(cids) - 1, out=pos)
                nbrs.append(pos[cids[pos] == adj])
            pk = pack_blocks_coresident(cids, records[lo:hi], nbrs)
            chunks.append(ChunkMeta(
                first_block=first_block, n_blocks=pk.n_blocks,
                boundary_ids=torch.from_numpy(pk.block_first_id).to(dev),
                base=bases[ci], n_runs=len(pk.run_first_id)))
            chunk_packs.append(pk)
            first_block += pk.n_blocks
        rec_block = np.concatenate(
            [pk.rec_block + cm.first_block
             for pk, cm in zip(chunk_packs, chunks)]).astype(np.int32)
        rec_start = np.concatenate(
            [pk.rec_start + cm.first_block * BLOCK_SIZE
             for pk, cm in zip(chunk_packs, chunks)]).astype(np.int64)
        run_first_id, run_block = id_runs(ids_np, rec_block)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        merged = PackedBlocks(
            data=t(np.concatenate([pk.data for pk in chunk_packs])),
            n_blocks=first_block, rec_block=t(rec_block),
            rec_start=t(rec_start),
            rec_len=t(np.concatenate([pk.rec_len for pk in chunk_packs])
                      .astype(np.int32)),
            block_first_id=t(np.concatenate(
                [pk.block_first_id for pk in chunk_packs])),
            run_first_id=t(run_first_id), run_block=t(run_block))
        return SealedSegment(ids=ids, packed=merged, chunks=chunks,
                             huff=table, v_bytes=v, dtype=self.dtype,
                             dim=self.cfg.dim, rows_per_chunk=rpc,
                             bases=stack, chunk_base=chunk_base)

    # ------------------------------------------------------------- reads
    def get(self, ids, account: bool = True) -> torch.Tensor:
        """Fetch records by id -> [k, dim] tensor on the store's device.
        ``account=False`` skips read-I/O accounting — for bulk loads into
        a device-resident view (publish-time materialization is not
        serving I/O), never for the query path."""
        with tracing.span("vstore.get"):
            ids = self._ids(ids)
            seg, row = self.location(ids)
            out = torch.empty((len(ids), self.cfg.v_bytes),
                              dtype=torch.uint8, device=self.device)
            with tracing.span("vstore.sync"):
                sids = torch.unique(seg).tolist()
            for sid in sids:
                with tracing.span("vstore.sync"):
                    sel = torch.nonzero(seg == sid).squeeze(1)
                if sid == -1:
                    got = self.active.rows[row[sel]]
                else:
                    s = self.sealed[sid]
                    got = s.decode_bytes(s.rows_of(ids[sel]),
                                         io=self.io if account else None)
                with tracing.span("vstore.sync"):
                    lo = int(sel[0])
                with tracing.span("vstore.sync"):
                    hi = int(sel[-1])
                if hi - lo + 1 == len(sel):    # one contiguous run
                    out[lo:lo + len(sel)] = got
                else:
                    out[sel] = got
            return out.view(self.dtype).reshape(len(ids), self.cfg.dim)

    def account_reads(self, ids) -> None:
        """Account the read I/O that ``get(ids)`` accounts (the distinct
        blocks of each sealed segment's rows), without decoding: lets a
        caller that fetches rows once for several logical reads keep the
        I/O of each read."""
        ids = self._ids(ids)
        seg, _ = self.location(ids)
        for sid in torch.unique(seg[seg >= 0]).tolist():
            s = self.sealed[sid]
            s.account_reads(s.rows_of(ids[seg == sid]), self.io)

    # ------------------------------------------------------------- updates
    def mark_stale(self, ids) -> None:
        ids = torch.unique(self._ids(ids))
        found, pos = self._lookup(ids)
        ids, seg, row = ids[found], self._loc_seg[pos[found]], \
            self._loc_row[pos[found]]
        self.active.stale_set.update(ids[seg == -1].tolist())
        for sid in torch.unique(seg[seg >= 0]).tolist():
            self.sealed[sid].stale[row[seg == sid]] = True
        self._drop_loc(ids)

    def gc(self, threshold: float = 0.3) -> int:
        """Greedy GC by garbage ratio (§3.5). Returns segments reclaimed.
        Live rows are read back through ``decode_rows`` (the byteplane
        load path) and copied forward."""
        victims = sorted((s for s in self.sealed.items()
                          if s[1].garbage_ratio > threshold),
                         key=lambda s: -s[1].garbage_ratio)
        n = 0
        for sid, seg in victims:
            live = ~seg.stale
            if bool(live.any()):
                rows = torch.nonzero(live).squeeze(1)
                vecs = seg.decode_rows(rows, io=self.io)      # GC read I/O
                self.append(seg.ids[rows], vecs)              # copy-forward
            # Atomic switch: old segment released only now (§3.5 consistency).
            del self.sealed[sid]
            n += 1
        return n

    # ------------------------------------------------------------- sizes
    @property
    def logical_bytes(self) -> int:
        m = sum(len(s.ids) for s in self.sealed.values()) + self.active.n
        return m * self.cfg.v_bytes

    @property
    def physical_bytes(self) -> int:
        t = sum(s.physical_bytes for s in self.sealed.values())
        return t + self.active.n * self.cfg.v_bytes

    @property
    def metadata_bytes(self) -> int:
        return sum(s.metadata_bytes for s in self.sealed.values())

    def beta_actual(self) -> float:
        lb = self.logical_bytes
        return self.metadata_bytes / lb if lb else 0.0
