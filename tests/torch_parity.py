"""Shared builders and checks of the serving and update parity tiers
(tests/test_torch_serve.py, tests/test_torch_snapshot.py,
tests/test_torch_updates.py): the reference's world and the port's world
built from the same numpy inputs (vectors, a Vamana graph, a PQ codebook),
and the comparison of two ``BatchReport``s."""
import dataclasses

import numpy as np
import pytest

from repro.core.graph.pq import encode_pq, train_pq
from repro.core.graph.vamana import build_vamana
from repro.core.storage.vector_store import DecoupledVectorStore as JVS
from repro.core.storage.vector_store import StoreConfig as JStoreConfig
from repro.core.update.fresh import StreamingIndex as JStreamingIndex
from repro.core.update.fresh import UpdateConfig as JUpdateConfig

from repro_torch.core.graph.pq import PQCodebook
from repro_torch.core.storage.vector_store import (DecoupledVectorStore,
                                                   StoreConfig)
from repro_torch.core.update.fresh import StreamingIndex, UpdateConfig

#: BatchReport fields that are timings (never compared).
UNCOMPARED = {"wall_s", "qps"}


def streaming_pair(vecs, r=16, m=4, seg_cap=256, l_build=32, **cfg_kw):
    """(reference StreamingIndex, port StreamingIndex on the CPU) over one
    Vamana graph, one codebook and one sealed vector store each — the
    worlds of tests/conftest.py::make_streaming_index. ``cfg_kw`` forwards
    to both UpdateConfigs (merges fire only when a test asks)."""
    vecs = np.asarray(vecs, np.float32)
    graph = build_vamana(vecs, r=r, l_build=32, seed=0)
    cb = train_pq(vecs, m=m, seed=0)
    codes = encode_pq(vecs, cb)
    cfg_kw.setdefault("merge_threshold", 10**9)
    dim = vecs.shape[1]
    jvs = JVS(JStoreConfig(dim=dim, dtype=np.float32,
                           segment_capacity=seg_cap, chunk_bytes=4096))
    tvs = DecoupledVectorStore(StoreConfig(dim=dim, dtype=np.float32,
                                           segment_capacity=seg_cap,
                                           chunk_bytes=4096, device="cpu"))
    for vs in (jvs, tvs):
        vs.append(np.arange(len(vecs)), vecs)
        vs.seal_active()
    ref = JStreamingIndex(graph.adjacency, graph.medoid, jvs, codes.copy(),
                          cb, JUpdateConfig(r=r, l_build=l_build, **cfg_kw))
    port = StreamingIndex(graph.adjacency, graph.medoid, tvs, codes.copy(),
                          PQCodebook(cb.centroids, cb.dim),
                          UpdateConfig(r=r, l_build=l_build, device="cpu",
                                       **cfg_kw))
    return ref, port


def assert_same_results(ref, port, rtol=1e-6):
    """(ids, dists, ...) of the reference against the port's: ids
    identical, distances within ``rtol``."""
    np.testing.assert_array_equal(np.asarray(port[0]), np.asarray(ref[0]))
    np.testing.assert_allclose(np.asarray(port[1]), np.asarray(ref[1]),
                               rtol=rtol)


def assert_same_report(a, b):
    """The reference's report ``a`` against the port's ``b``, on every
    field of the port's but the timings: integers, lists and dicts equal,
    floats within rtol 1e-12 (sums of the same counts at the same
    constants)."""
    for f in dataclasses.fields(b):
        if f.name in UNCOMPARED:
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, float):
            assert y == pytest.approx(x, rel=1e-12, abs=1e-9), f.name
        elif isinstance(x, list) and x and isinstance(x[0], float):
            np.testing.assert_allclose(y, x, rtol=1e-12, err_msg=f.name)
        else:
            assert x == y, f.name


def assert_same_merge(a, b):
    """Two MergeStats: every field but the phase wall times equal."""
    for f in dataclasses.fields(a):
        if not f.name.startswith("t_"):
            assert getattr(a, f.name) == getattr(b, f.name), f.name


def assert_same_index_state(ref, port):
    """Two StreamingIndexes: graph, PQ codes, medoid, buffers, published
    version and every I/O counter of both engines equal."""
    assert len(ref.adjacency) == len(port.adjacency)
    for a, b in zip(ref.adjacency, port.adjacency):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(ref.pq_codes, port.pq_codes)
    assert ref.medoid == port.medoid
    assert set(ref.insert_buffer) == set(port.insert_buffer)
    assert ref.delete_buffer == port.delete_buffer
    assert ref.handle.current().version == port.handle.current().version
    assert ref.vector_store.io.snapshot() == port.vector_store.io.snapshot()
    assert ref.blocks.stats() == port.blocks.stats()
    assert sorted(ref.vector_store.loc) == port.vector_store.ids.tolist()
