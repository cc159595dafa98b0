"""Co-located DiskANN-style baseline store (paper §2.2, Figure 1).

Each vertex record bundles the full-precision vector with its neighbor list
(count + R ids), page-aligned: records are fixed size, and the number of
records per 4 KiB block is ``floor(4096 / record_size)`` — any remainder is
the internal fragmentation the paper measures (Limitation #1). A single read
fetches vector + adjacency together (the search-friendly, storage-inefficient
layout DecoupleVS replaces).

Accounting runs through the shared :class:`BlockStore` engine at **block
granularity** — the cache holds whole 4 KiB blocks (every record in a cached
block hits), and ``rewrite_all`` counts one write per block — so this §2.2
baseline is measured on exactly the same ruler as the decoupled arms in
``bench_update.py``/``bench_storage.py``.

The port of ``repro.core.storage.colocated``, with the same byte and I/O
arithmetic. ``vectors`` may be a numpy array or a tensor and the graph a
list of arrays or one ``[n, W]`` tensor padded with -1, so a shard's
baseline is priced without a Python list of 31M arrays.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .blockstore import BlockStore, IOStats, LRUCache, PrefetchQueue
from .layout import BLOCK_SIZE

#: BlockStore component this baseline accounts under (see blockstore.py).
COMPONENT = "colocated"


@dataclass
class ColocatedStore:
    vectors: object            # [n, d] array or tensor
    neighbors: object          # list[np.ndarray] or [n, W] padded tensor
    r: int
    medoid: int
    io: IOStats = None
    cache: LRUCache = None     # keyed by BLOCK index (block granularity)
    blocks: BlockStore = None
    prefetch: PrefetchQueue = None   # speculative block window (engine-set)

    @classmethod
    def build(cls, vectors, adjacency, medoid: int, r: int,
              cache_bytes: int = 0,
              block_store: BlockStore = None) -> "ColocatedStore":
        bs = block_store or BlockStore()
        # One cache entry = one page group (co-located records are bundled
        # per page, so the cacheable unit is the page — §2.2 semantics; a
        # record wider than a page reserves all the blocks it spans, so
        # the byte budget stays honest for wide-vector corpora).
        record_bytes = (vectors.dtype.itemsize * vectors.shape[1]
                        + 4 * (r + 1))
        entry_bytes = max(1, -(-record_bytes // BLOCK_SIZE)) * BLOCK_SIZE
        neighbors = adjacency if isinstance(adjacency, torch.Tensor) \
            else [np.asarray(a, np.int64) for a in adjacency]
        return cls(vectors=vectors, neighbors=neighbors,
                   r=r, medoid=medoid, io=bs.fresh_io(COMPONENT),
                   cache=bs.register_cache(COMPONENT, entry_bytes,
                                           cache_bytes),
                   blocks=bs)

    @property
    def record_bytes(self) -> int:
        v_bytes = self.vectors.dtype.itemsize * self.vectors.shape[1]
        return v_bytes + 4 * (self.r + 1)

    @property
    def records_per_block(self) -> int:
        return max(1, BLOCK_SIZE // self.record_bytes)

    @property
    def blocks_per_record(self) -> int:
        return max(1, -(-self.record_bytes // BLOCK_SIZE))

    @property
    def n_blocks(self) -> int:
        if self.record_bytes > BLOCK_SIZE:
            return len(self.neighbors) * self.blocks_per_record
        return -(-len(self.neighbors) // self.records_per_block)

    @property
    def physical_bytes(self) -> int:
        return self.n_blocks * BLOCK_SIZE

    def block_of(self, vid: int) -> int:
        """First block holding ``vid``'s record (offset arithmetic — the
        co-located layout needs no sparse index)."""
        if self.record_bytes > BLOCK_SIZE:
            return int(vid) * self.blocks_per_record
        return int(vid) // self.records_per_block

    def get_record(self, vid: int) -> tuple:
        """One I/O returns (vector, neighbor list) — co-located semantics.
        The block is cached, so neighbors packed into the same page hit; a
        block resident in the prefetch window skips the read (and the
        lookup reclassifies miss -> prefetch hit: no stall)."""
        bid = self.block_of(int(vid))
        if self.cache.get(bid) is None:
            if self.prefetch is not None and self.prefetch.take(bid):
                self.cache.note_prefetch_hit()
            else:
                nblocks = self.blocks_per_record
                self.io.read(nblocks * BLOCK_SIZE, n=nblocks)
                if self.prefetch is not None:
                    self.prefetch.fill(bid)
            self.cache.put(bid, True)
        nbrs = self.neighbors[int(vid)]
        if isinstance(nbrs, torch.Tensor):
            nbrs = nbrs[nbrs >= 0]
        return (self.vectors[int(vid)], nbrs)

    # ---------------------------------------------------------- prefetch
    def enable_prefetch(self, depth: int = 8, budget: int = 32
                        ) -> PrefetchQueue:
        """Attach the speculative block-read window (PipeANN-style
        overlap on the co-located layout; idempotent for unchanged
        bounds)."""
        bs = self.blocks if self.blocks is not None else BlockStore()
        self.blocks = bs
        self.prefetch = bs.register_prefetch(COMPONENT, depth, budget)
        return self.prefetch

    def prefetch_hint(self, ids) -> int:
        """Speculatively read the pages holding ``ids``'s records (hop
        k+1's provisional frontier). Accounting-only warm-up; returns
        page-group issues (a record wider than a page reads all its
        blocks, same as the demand path)."""
        if self.prefetch is None:
            return 0
        n = 0
        for vid in ids:
            bid = self.block_of(int(vid))
            if self.cache.peek(bid) is not None:
                continue
            if self.prefetch.offer(bid):
                nblocks = self.blocks_per_record
                self.io.read(nblocks * BLOCK_SIZE, n=nblocks)
                n += 1
        return n

    def drain_prefetch(self) -> int:
        """End-of-search barrier: unconsumed speculations become waste."""
        return self.prefetch.drain() if self.prefetch is not None else 0

    def rewrite_all(self) -> IOStats:
        """Full index rewrite (what FreshDiskANN merges pay on this layout),
        block-granular: every page is written once."""
        self.io.write(self.physical_bytes, n=self.n_blocks)
        return self.io
