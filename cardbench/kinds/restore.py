"""Kind ``restore``: the shard restored from its sealed vector and index
stores a segment's rows at a time, segments in order, cycling. A restore
is ``get(ids, account=False)`` into the resident table plus
``decode_batch(ids)`` into the resident lists and counts.

Mix keys: ``stretch_units``, the segments a traced stretch restores.

Before each restore the segment's rows of the table, lists and counts are
poisoned, and after it a checksum of each is kept on the device. The check
holds every restore's checksums, and the last restore of every segment row
by row, against the inputs: a restore that writes nothing, or stale rows,
on any cycle reads as wrong.
"""
from __future__ import annotations

import time
from contextlib import nullcontext

import numpy as np

from cardbench.frozen import bounds, shard
from cardbench.frozen.colocated import colocated_bytes
from cardbench.record import profile
from cardbench.world import dtype_of

#: Byte written over a segment's vector rows before its restore; no input
#: row is all of it.
POISON_BYTE = 0xA5
#: Bytes a boundary id (the sparse index's entry) and a Huffman code length
#: take when persisted, and the fixed bytes of a chunk's entry (offset and
#: block count).
BOUNDARY_ID_BYTES, CODE_LENGTH_BYTES, CHUNK_ENTRY_BYTES = 4, 1, 8


def units(n: int, rows_per_unit: int) -> list:
    """[(first row, end row)] of each segment of a store filled in id
    order."""
    return [(a, min(a + rows_per_unit, n)) for a in range(0, n, rows_per_unit)]


def checksum(torch, x, weights):
    """Position-weighted sum of a [rows, ...] block's 4-byte words: each
    row's word sum times its place in the block (from 1), in int64 that
    wraps. Rows unwritten, stale or out of place change it."""
    rows = x.shape[0]
    words = x.reshape(rows, -1).view(torch.int32)
    return (words.sum(1, dtype=torch.int64) * weights[:rows]).sum()


def stored_bytes(vs, ix) -> tuple:
    """(vector store bytes, index store bytes), read from the tensors the
    sealed stores hold: each block image as held, each sparse-index entry
    held at the persisted width of a boundary id, each chunk's entry and
    XOR base, and each Huffman table's code lengths."""
    vec = 0
    for seg in vs.sealed.values():
        pk = seg.packed
        vec += pk.data.nbytes
        vec += BOUNDARY_ID_BYTES * len(pk.block_first_id)
        vec += CHUNK_ENTRY_BYTES * len(seg.chunks)
        vec += sum(c.base.nbytes for c in seg.chunks if c.base is not None)
        if seg.huff is not None:
            tables = getattr(seg.huff, "tables", [seg.huff])
            vec += CODE_LENGTH_BYTES * sum(len(t.lengths) for t in tables)
    idx = ix.data.nbytes + BOUNDARY_ID_BYTES * len(ix.sparse_index)
    return vec, idx


class Cell:
    """The shard restored from its sealed vector and index stores."""

    def __init__(self, torch, prog, cfg, mix, world, seed, device, run,
                 trace):
        self.torch, self.prog, self.cfg, self.mix = torch, prog, cfg, mix
        self.world, self.seed, self.device = world, seed, device
        self.run, self.trace = run, trace
        self.stored = self.program_bytes = None

    def setup(self):
        torch, prog, cfg, w, dev = (self.torch, self.prog, self.cfg,
                                    self.world, self.device)
        n, dim, r = cfg["n_vectors"], cfg["dim"], cfg["r"]
        dt = dtype_of(torch, cfg)
        self.vs = shard.vector_store(prog, cfg, dt, dev)
        self.vs.append(torch.arange(n, device=dev), w.vectors)
        self.vs.seal_active()
        self.ix = shard.index_store(prog, w.graph, w.medoid, r, dev)
        # the inputs the check reads: the vectors wait on the host
        self.want_vectors = w.vectors.cpu()
        w.vectors = None
        self.table = torch.empty((n, dim), dtype=dt, device=dev)
        self.lists = torch.empty((n, r), dtype=torch.int32, device=dev)
        self.counts = torch.empty(n, dtype=torch.int32, device=dev)
        self.ids = torch.arange(n, device=dev)
        self.units = units(n, cfg["segment_bytes"] // (dim * dt.itemsize))
        self.weights = torch.arange(
            1, max(b - a for a, b in self.units) + 1, device=dev)
        self.restored = np.zeros(len(self.units), dtype=bool)
        self.log = []             # (segment, checksums) a restore
        self.row_bytes = dim * dt.itemsize + 4 * (r + 1)
        for u in {0, len(self.units) - 1}:
            self.restore(u)
        self.run.sync()
        self.restored[:] = False
        self.log = []
        self._poison(0, n)

    def _poison(self, a: int, b: int):
        self.table[a:b].view(self.torch.uint8).fill_(POISON_BYTE)
        self.lists[a:b].fill_(-1)
        self.counts[a:b].fill_(-1)

    def _sums(self, table, lists, counts):
        t, w = self.torch, self.weights
        return t.stack([checksum(t, table, w), checksum(t, lists, w),
                        checksum(t, counts, w)])

    def restore(self, u: int, span=None):
        """One segment's rows, poisoned first: their vectors into the
        resident table, their lists decoded; then their checksums.
        ``span`` (``Run.span`` or ``Run.label``) marks the two steps."""
        a, b = self.units[u]
        ids = self.ids[a:b]
        mark = span or (lambda torch, name: nullcontext())
        self._poison(a, b)
        with mark(self.torch, "restore.get"):
            self.table[a:b] = self.vs.get(ids, account=False)
        with mark(self.torch, "restore.decode"):
            vals, cnt = self.ix.decode_batch(ids)
            self.lists[a:b, :vals.shape[1]] = vals
            self.counts[a:b] = cnt
        self.log.append((u, self._sums(self.table[a:b], self.lists[a:b],
                                       self.counts[a:b])))
        self.restored[u] = True

    def window(self, seconds: float) -> dict:
        moved, k, t0 = 0, 0, time.perf_counter()
        while True:
            u = k % len(self.units)
            self.restore(u)
            self.run.sync()
            a, b = self.units[u]
            moved += (b - a) * self.row_bytes
            k += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        cfg = self.cfg
        self.stored = stored_bytes(self.vs, self.ix)
        self.program_bytes = (self.vs.physical_bytes + self.vs.metadata_bytes,
                              self.ix.physical_bytes
                              + self.ix.sparse_index_bytes)
        colo = colocated_bytes(cfg["n_vectors"], cfg["dim"],
                               self.table.element_size(), cfg["r"])
        return {"load_gbs": moved / elapsed / 1e9,
                "bytes_ratio": sum(self.stored) / colo, "attempted": k}

    def stretch(self):
        torch, run, cfg, vs = self.torch, self.run, self.cfg, self.vs
        n, dim, r = cfg["n_vectors"], cfg["dim"], cfg["r"]
        elt = self.table.element_size()
        vec, idx = self.stored
        run.counters["store.vector_bytes"] = vec
        run.counters["store.vector_raw"] = n * dim * elt
        run.counters["store.index_bytes"] = idx
        run.counters["store.index_raw"] = n * 4 * (r + 1)
        stretch = range(min(len(self.units), self.mix["stretch_units"]))
        for u in stretch:
            self.restore(u, run.span)
            a, b = self.units[u]
            run.count("restore.vector_moved", (b - a) * dim * elt)
            run.count("restore.index_moved", (b - a) * 4 * (r + 1))
            seg = vs.sealed.get(u)
            if seg is not None:
                run.count("huffman.bytes", bounds.huffman_decode_bytes(
                    int(seg.packed.rec_len.sum()), b - a, dim * elt,
                    seg.bases.numel()))

        def restores():
            for u in stretch:
                self.restore(u, run.label)
                run.sync()
        run.traces["main"] = profile(torch, restores, run.sync)

    def release(self):
        self.vs = self.ix = None

    def check(self, seed: int) -> dict:
        """Restores whose checksums differ from the inputs', and restored
        rows and lists that differ from the inputs: the last restore of
        every segment the window restored."""
        out = self._compare(self.table, self.lists, self.counts)
        out["restores_wrong"] = (self._restores_wrong(self.log), 0)
        out["_restores_checked"] = len(self.log)
        # the stores' bytes as read from their tensors, and as they count
        # them themselves: (vector store, index store)
        out["_stored_bytes"] = self.stored
        out["_stored_bytes_program"] = self.program_bytes
        return out

    def control(self, seed: int, dtype) -> dict:
        """The check's numbers with the inputs at the precision below
        theirs put in the program's place: float32 rows through ``dtype``,
        uint8 rows cut to their high four bits (int4); lists the
        reference's own."""
        x = self.want_vectors
        x = x & 0xF0 if x.dtype == self.torch.uint8 \
            else x.to(dtype).to(x.dtype)
        sums = []
        for u in np.flatnonzero(self.restored):
            a, b = self.units[u]
            lists, counts = self._want_lists(a, b)
            sums.append((u, self._sums(x[a:b].to(self.device), lists,
                                       counts)))
        out = self._compare(x)
        out["restores_wrong"] = (self._restores_wrong(sums), 0)
        return out

    def _want_lists(self, a: int, b: int):
        t = self.torch
        lists = self.world.graph[a:b].sort(1).values.to(t.int32)
        return lists, t.full((b - a,), lists.shape[1], dtype=t.int32,
                             device=lists.device)

    def _restores_wrong(self, sums) -> int:
        """Of (segment, checksums) records, those that differ from the
        checksums of the segment's inputs."""
        want = {}
        bad = 0
        for u, s in sums:
            if u not in want:
                a, b = self.units[u]
                lists, counts = self._want_lists(a, b)
                want[u] = self._sums(self.want_vectors[a:b].to(self.device),
                                     lists, counts)
            bad += int(not self.torch.equal(s, want[u]))
        return bad

    def _compare(self, table, lists=None, counts=None) -> dict:
        """Rows of ``table`` and lists of ``lists`` (None: the reference's
        own) that differ from the inputs."""
        torch = self.torch
        bad_rows = bad_lists = rows = 0
        for u in np.flatnonzero(self.restored):
            a, b = self.units[u]
            want = self.want_vectors[a:b].to(self.device)
            got = table[a:b].to(self.device)
            if got.dtype.is_floating_point:
                want, got = want.view(torch.int32), got.view(torch.int32)
            bad_rows += int((got != want).any(1).sum())
            if lists is not None:
                ref_lists, ref_counts = self._want_lists(a, b)
                bad_lists += int(((lists[a:b] != ref_lists).any(1)
                                  | (counts[a:b] != ref_counts)).sum())
            rows += b - a
        return {"vector_rows_wrong": (bad_rows, 0),
                "index_lists_wrong": (bad_lists, 0), "_rows_checked": rows}
