"""Retrieval-augmented serving: the paper's ANNS layer feeding an LM.

Documents are embedded (mean-pooled embedding-table rows — a stand-in for
a production encoder), indexed by a DecoupleVS decoupled compressed store,
and retrieved at serve time to prepend context before generation. The
retrieval tier's I/O accounting (block reads, cache hits) is surfaced per
request.

Two retrieval paths share the same decoupled artifacts:

- ``batch=0`` (default): the host I/O-model engine
  (``core/search/engine.search_decoupled``), one query at a time — exact
  block-level accounting against the physical stores.
- ``batch>0``: the batched path (``serve/ann.BatchedSearcher``) on the
  engine's device — pad-and-bucket batches through the beam search's
  kernels, with the same metrics reproduced by replaying its fetch traces
  through the §3.4 LRU model.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.graph.pq import encode_pq, train_pq
from ..core.graph.vamana import build_vamana
from ..core.index import device_index_from_artifacts
from ..core.search.beam import SearchParams
from ..core.search.engine import EngineConfig, search_decoupled
from ..core.storage.index_store import CompressedIndexStore
from ..core.storage.layout import BLOCK_SIZE
from ..core.storage.vector_store import DecoupledVectorStore, StoreConfig
from .ann import BatchedSearcher, ServeConfig
from .engine import ServeEngine


def embed_tokens(params, tokens: np.ndarray) -> np.ndarray:
    """Mean-pooled embedding rows -> [B, d_model] float32 (L2-normalised).

    The rows are gathered where the table lives and the mean is taken on
    the host in numpy, in the reference's order: the Vamana build and the
    PQ training follow the vectors' last bits."""
    emb = params["embed"]
    ids = torch.as_tensor(np.asarray(tokens, np.int64), device=emb.device)
    rows = emb[ids].float().cpu().numpy()
    v = rows.mean(axis=-2)
    return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-9)


def row_parts(dim: int, itemsize: int) -> int:
    """Records a row is stored as: 1 where a raw row and its block header
    (8 bytes) fit one block; else the fewest equal slices of at most half
    a block each (headroom for a Huffman code longer than the raw bytes)."""
    if dim * itemsize + 8 <= BLOCK_SIZE:
        return 1
    return next(p for p in range(2, dim + 1)
                if dim % p == 0 and dim * itemsize // p <= BLOCK_SIZE // 2)


class SplitRows:
    """A vector store whose records are rows cut into ``parts`` equal
    slices, record ``i * parts + j`` holding slice j of row i: rows wider
    than a block (a model's embeddings) on the block layout, which keeps a
    record inside one block. ``get`` returns whole rows; reads are
    accounted on the store's own ``io`` (every block of every slice)."""

    def __init__(self, store: DecoupledVectorStore, parts: int, dim: int):
        self.store, self.parts, self.dim = store, parts, dim

    @property
    def io(self):
        return self.store.io

    @property
    def physical_bytes(self) -> int:
        return self.store.physical_bytes

    @property
    def logical_bytes(self) -> int:
        return self.store.logical_bytes

    def get(self, ids, account: bool = True) -> torch.Tensor:
        ids = np.asarray(ids, np.int64)
        sub = (ids[:, None] * self.parts + np.arange(self.parts)).reshape(-1)
        return self.store.get(sub, account).reshape(len(ids), self.dim)


@dataclass
class RAGPipeline:
    engine: ServeEngine
    doc_tokens: np.ndarray = None        # [n_docs, doc_len]
    k: int = 2
    cache_bytes: int = 1 << 16
    batch: int = 0    # >0: serve retrieval through the batched path
                      # (max bucket size = batch)

    def __post_init__(self):
        dev = self.engine.device
        docs = self.doc_tokens
        t0 = time.perf_counter()
        vecs = embed_tokens(self.engine.params, docs)
        t1 = time.perf_counter()
        self.graph = graph = build_vamana(vecs, r=16, l_build=32, seed=0)
        t2 = time.perf_counter()
        self.cb = train_pq(vecs, m=8, seed=0)
        self.codes = encode_pq(vecs, self.cb)
        t3 = time.perf_counter()
        self.index_store = CompressedIndexStore.from_graph(
            graph.adjacency, graph.medoid, 16, cache_bytes=self.cache_bytes,
            device=dev)
        n, d = vecs.shape
        parts = row_parts(d, vecs.itemsize)
        store = DecoupledVectorStore(StoreConfig(
            dim=d // parts, dtype=np.float32, segment_capacity=4096,
            device=dev))
        store.append(np.arange(n * parts), vecs.reshape(n * parts, -1))
        store.seal_active()
        self.vector_store = store if parts == 1 else SplitRows(store, parts, d)
        t4 = time.perf_counter()
        #: host-clock seconds of each build step
        self.build_s = dict(embed=t1 - t0, graph=t2 - t1, pq=t3 - t2,
                            stores=t4 - t3)
        self.cfg = EngineConfig(l_size=32, k=self.k, latency_aware=True,
                                compressed=True)
        self.searcher = None
        if self.batch:
            self.index = device_index_from_artifacts(vecs, graph, self.cb,
                                                     self.codes, dev)
            p = SearchParams(l_size=32, beam_width=4, k=self.k,
                             rerank_batch=5, r_max=16, universe=len(vecs),
                             max_iters=64)
            buckets = tuple(sorted({1, min(8, self.batch), self.batch}))
            self.searcher = BatchedSearcher(
                self.index, p, ServeConfig(buckets=buckets,
                                           cache_bytes=self.cache_bytes),
                device=dev)
            self.build_s["device_index"] = time.perf_counter() - t4

    def retrieve(self, query_tokens: np.ndarray):
        """-> (doc ids [B, k], stats dict with the paper's I/O metrics;
        on the batched path also the searcher's ``BatchReport``)."""
        q = embed_tokens(self.engine.params, query_tokens)
        if self.searcher is not None:
            ids, _, rep = self.searcher.search(q)
            ids = np.where(ids >= 0, ids, 0)
            return ids[:, :self.k], {
                "graph_ios": rep.graph_ios, "vector_ios": rep.vector_ios,
                "cache_hits": rep.cache_hits, "qps": rep.qps,
                "modeled_latency_us": rep.modeled_latency_us,
                "buckets": rep.buckets, "report": rep}
        ids, stats = [], []
        for row in q:
            i, s = search_decoupled(self.index_store, self.vector_store,
                                    self.codes, self.cb, row, self.cfg)
            ids.append(np.pad(i[:self.k], (0, max(0, self.k - len(i))),
                              constant_values=0))
            stats.append(s)
        return np.stack(ids), {
            "graph_ios": sum(s.graph_ios for s in stats),
            "vector_ios": sum(s.vector_ios for s in stats),
            "cache_hits": sum(s.cache_hits for s in stats)}

    def answer(self, query_tokens: np.ndarray, max_new: int = 8):
        """Retrieve-then-generate. -> (generated tokens, retrieval stats)."""
        doc_ids, stats = self.retrieve(query_tokens)
        ctx = self.doc_tokens[doc_ids].reshape(len(query_tokens), -1)
        prompt = np.concatenate([ctx, query_tokens], axis=1)
        gen = self.engine.generate(prompt, max_new=max_new)
        stats = dict(stats, retrieved=doc_ids)
        return gen, stats
