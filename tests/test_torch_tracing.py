"""The port's spans (``repro_torch.tracing``): a no-op without a profiler,
the ranges the serve, search and restore paths open under one, and the
same answers either way. All on the CPU."""
import functools
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core.codec import elias_fano as ef
from repro_torch.core.graph.pq import encode_pq_torch
from repro_torch.core.index import build_device_index
from repro_torch.core.search.beam import SearchParams, search
from repro_torch.core.storage.index_store import CompressedIndexStore
from repro_torch.core.storage.vector_store import (DecoupledVectorStore,
                                                   StoreConfig)
from repro_torch.serve.ann import BatchedSearcher, ServeConfig

N, DIM, R = 300, 16, 12
P = SearchParams(l_size=32, beam_width=4, k=10, rerank_batch=4, r_max=R,
                 universe=N, max_iters=64, max_rerank_batches=5,
                 benefit_threshold=0.5)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(N, DIM)).astype(np.float32)
    index, graph, _ = build_device_index(vecs, r=R, l_build=24, pq_m=4,
                                         device="cpu")
    queries = rng.normal(size=(20, DIM)).astype(np.float32)
    return vecs, index, graph, queries


def spans(fn):
    """(fn's result, [(name without the prefix, start, end)]) of the
    program spans ``fn`` opens under the profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    got = [(ev.name[len(tracing.PREFIX):], ev.time_range.start,
            ev.time_range.end) for ev in prof.events()
           if ev.name.startswith(tracing.PREFIX)]
    return out, sorted(got, key=lambda s: (s[1], -s[2]))


def named(got, name):
    return [s for s in got if s[0] == name]


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with no profiler")
    monkeypatch.setattr(tracing, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("search.round") is tracing.span("serve.batch",
                                                        {"rows": 3})
    with tracing.span("search.sync"):
        pass


def test_span_is_a_host_range_named_with_the_prefix_and_its_args():
    def fn():
        with tracing.span("serve.bucket", {"bucket": 8, "rows": 5}):
            with tracing.span("serve.sync"):
                return torch.ones(3).sum()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fn()
    got = {ev.name: ev for ev in prof.events()
           if ev.name.startswith(tracing.PREFIX)}
    assert set(got) == {"repro_torch.serve.bucket", "repro_torch.serve.sync"}
    assert got["repro_torch.serve.bucket"].kwinputs == {"bucket": 8,
                                                        "rows": 5}
    assert got["repro_torch.serve.sync"].cpu_parent.name == \
        "repro_torch.serve.bucket"
    assert all(ev.device_type == torch.autograd.DeviceType.CPU
               for ev in got.values())


def test_search_opens_a_round_span_a_round_and_a_sync_a_flag_read(world):
    _, index, _, queries = world
    q = torch.from_numpy(queries)
    (ids, dists, st), got = spans(lambda: search(index, q, P, "cpu"))
    rounds = int(st.iters.max())
    assert rounds > 1
    assert len(named(got, "search.round")) == rounds
    # the re-rank tests its flag while batches remain: once a batch run,
    # and once more where the loop stopped on the flag
    max_batches = min(P.max_rerank_batches,
                      (P.l_size - P.k) // P.rerank_batch)
    ran = int(st.rerank_batches.max())
    rerank_reads = ran + (ran < max_batches)
    traverse, = named(got, "search.traverse")
    rerank, = named(got, "search.rerank")
    syncs = named(got, "search.sync")
    assert sum(inside(s, traverse) for s in syncs) == rounds + 1
    assert sum(inside(s, rerank) for s in syncs) == rerank_reads
    assert len(syncs) == rounds + 1 + rerank_reads
    batch, = named(got, "search.batch")
    assert inside(traverse, batch) and inside(rerank, batch)
    assert inside(named(got, "search.lut")[0], batch)
    assert all(inside(r, traverse) for r in named(got, "search.round"))
    hops = named(got, "search.hop")
    assert len(hops) == rounds
    assert all(any(inside(h, r) for r in named(got, "search.round"))
               for h in hops)


def test_rerank_span_says_which_loop_ran(world):
    """``search.rerank`` carries ``fused``: 0 on the CPU, where the plain
    loop runs (its flag reads are the ``search.sync`` spans inside it) and
    no ``rerank_loop`` kernel launches."""
    from repro_torch.kernels import build
    _, index, _, queries = world
    build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        search(index, torch.from_numpy(queries), P, "cpu")
    got = [ev.kwinputs for ev in prof.events()
           if ev.name == tracing.PREFIX + "search.rerank"]
    assert got == [{"fused": 0}]
    assert build.LAUNCHES["rerank_loop"] == build.LAUNCHES["rerank_l2"] == 0


def test_hop_and_encode_spans_carry_their_shapes(world):
    """``search.hop`` records M, the LUT's bytes and the slices the fused
    hop stages it in; ``pq.encode`` the rows, M and dsub."""
    _, index, _, queries = world
    m, k, dsub = index.pq_centroids.shape
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        search(index, torch.from_numpy(queries), P, "cpu")
        encode_pq_torch(index.vectors[:50], index.pq_centroids)
    got = {}
    for ev in prof.events():
        got.setdefault(ev.name, []).append(ev.kwinputs)
    hops = got[tracing.PREFIX + "search.hop"]
    assert hops and all(h == {"m": m, "lut_bytes": m * k * 4,
                              "lut_slices": 1} for h in hops)
    assert got[tracing.PREFIX + "pq.encode"] == [{"rows": 50, "m": m,
                                                  "dsub": dsub}]


def test_served_batch_nests_searches_in_buckets(world):
    _, index, _, queries = world
    searcher = BatchedSearcher(index, P, ServeConfig(buckets=(8, 16),
                                                     account_io=False),
                               device="cpu")
    (_, _, report), got = spans(lambda: searcher.search(queries))
    batch, = named(got, "serve.batch")
    buckets = named(got, "serve.bucket")
    assert len(buckets) == len(report.buckets) >= 2
    assert all(inside(b, batch) for b in buckets)
    searches = named(got, "search.batch")
    assert len(searches) == len(buckets)
    assert all(any(inside(s, b) for b in buckets) for s in searches)
    assert len(named(got, "serve.merge")) == 1
    # the query copy and the two read-backs of each bucket
    assert len(named(got, "serve.sync")) == 3 * len(buckets)


def stores(vecs, graph):
    vs = DecoupledVectorStore(StoreConfig(dim=DIM, dtype=np.float32,
                                          segment_capacity=128,
                                          chunk_bytes=1 << 12,
                                          device="cpu"))
    vs.append(torch.arange(N), torch.from_numpy(vecs))
    vs.seal_active()
    ix = CompressedIndexStore.from_graph(graph.adjacency, graph.medoid, R,
                                         universe=N, device="cpu")
    return vs, ix


@pytest.mark.parametrize("batch", [64, 100, 300])
def test_decode_batch_reads_back_once_a_pass_and_once_more(world, batch,
                                                          monkeypatch):
    vecs, _, graph, _ = world
    _, ix = stores(vecs, graph)
    ids = torch.arange(N)
    want_vals, want_cnt = ix.decode_batch(ids)
    monkeypatch.setattr(ef, "decode_records_torch", functools.partial(
        ef.decode_records_torch, batch=batch))
    (vals, cnt), got = spans(lambda: ix.decode_batch(ids))
    assert len(named(got, "ef.sync")) == math.ceil(N / batch) + 1
    whole, = named(got, "istore.decode_batch")
    assert all(inside(s, whole) for s in named(got, "ef.sync"))
    assert torch.equal(vals, want_vals) and torch.equal(cnt, want_cnt)


def test_vector_store_get_reads_back_at_each_sync(world):
    vecs, _, graph, _ = world
    vs, _ = stores(vecs, graph)
    rows, got = spans(lambda: vs.get(torch.arange(128, 256), account=False))
    np.testing.assert_array_equal(rows.numpy(), vecs[128:256])
    whole, = named(got, "vstore.get")
    # one sealed segment: the lookup's flag, the segment ids, the rows'
    # positions, the segment's own lookup, its first and last position
    syncs = named(got, "vstore.sync")
    assert len(syncs) == 6
    assert all(inside(s, whole) for s in syncs)
    assert len(named(got, "vstore.decode")) == 1


def _search(world):
    _, index, _, queries = world
    ids, dists, st = search(index, torch.from_numpy(queries), P, "cpu")
    return [ids, dists, *st]


def _serve(world):
    _, index, _, queries = world
    searcher = BatchedSearcher(index, P, ServeConfig(buckets=(8, 16)),
                               device="cpu")
    ids, dists, report = searcher.search(queries)
    return [torch.from_numpy(ids), torch.from_numpy(dists),
            torch.tensor(report.graph_ios), torch.tensor(report.cache_hits)]


def _restore(world):
    vecs, _, graph, _ = world
    vs, ix = stores(vecs, graph)
    ids = torch.arange(N)
    return [vs.get(ids, account=False), *ix.decode_batch(ids)]


@pytest.mark.parametrize("path", [_search, _serve, _restore])
def test_results_are_bit_identical_under_the_profiler(world, path):
    plain = path(world)
    traced, got = spans(lambda: path(world))
    assert got
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)
