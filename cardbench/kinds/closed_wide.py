"""Kind ``closed_wide``: the ``closed`` kind (same mix keys, same window,
stretch and check) for configurations whose PQ codes are wide, with the
check's plain reference encoding the code rows it reads in chunks whose
temporaries stay under ``ENCODE_BYTES``.

The reference's ``encode`` takes 32,768 rows at a time and makes
``[rows, M, K, dsub]`` float32 temporaries: 3.2 GB at M = 32 over D = 96,
but 25.8 GB each at M = 384, K = 256, dsub 2, which beside the world's
rows do not fit the card. A row's code does not depend on the rows
encoded with it, so the codes, and every answer of the reference, are
the same whatever the chunk.
"""
from __future__ import annotations

import numpy as np
import torch

from cardbench import traffic
from cardbench.reference import search as ref

_closed = traffic.kind_module("closed")

#: Bytes of one of the reference encode's float32 temporaries.
ENCODE_BYTES = 1 << 30


class Codes(ref.Codes):
    """The reference's code cache, encoding in bounded chunks."""

    def __getitem__(self, ids):
        need = torch.unique(ids[~self.known[ids]])
        if need.numel():
            m, k, dsub = self.centroids.shape
            chunk = max(1, ENCODE_BYTES // (m * k * dsub * 4))
            self.codes[need] = ref.encode(self.table[need], self.centroids,
                                          chunk=chunk, dtype=self.dtype)
            self.known[need] = True
        return self.codes[ids]


class Cell(_closed.Cell):
    """Batches of queries through ``BatchedSearcher.search``; the check's
    reference encodes in bounded chunks."""

    def reference(self, rows, dtype):
        """The reference's (ids, dists) for pool rows ``rows``."""
        torch, w, cfg = self.torch, self.world, self.cfg
        codes = Codes(w.vectors, w.centroids, dtype)
        out_i, out_d = [], []
        for a in range(0, len(rows), _closed.REF_ROWS):
            q = torch.from_numpy(self.pool[rows[a:a + _closed.REF_ROWS]]).to(
                self.device)
            i, d, _ = ref.search(w.vectors, w.graph, w.centroids, w.medoid,
                                 q, cfg, dtype, codes)
            out_i.append(i.cpu().numpy())
            out_d.append(d.cpu().numpy())
        return np.concatenate(out_i), np.concatenate(out_d)
