"""Port parity tier for the host I/O-model engine
(``repro_torch.core.search.engine``): the four paper configurations of
tests/test_engine.py and the prefetch pricing identities of
tests/test_prefetch.py, each run through the reference's engine over the
reference's stores and through the port's engine over the port's stores
(``device="cpu"``), built from the same seeded graph, codebook and vectors.

Every id, every ``QueryStats`` field and every price must be equal; the
float fields within rtol 1e-12 (they are sums of the same integer counts at
the same constants). The port's cost table holds only concrete backends of
its dispatch layer: ``ref`` and ``cuda``, priced alike.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.graph.pq import encode_pq, train_pq
from repro.core.graph.vamana import build_vamana
from repro.core.index import build_device_index as jbuild
from repro.core.index import recall_at_k
from repro.core.search import beam as jbeam
from repro.core.search import engine as jengine
from repro.core.storage.colocated import ColocatedStore as JColocated
from repro.core.storage.index_store import CompressedIndexStore as JIndex
from repro.core.storage.index_store import RawIndexStore as JRaw
from repro.core.storage import layout as jlayout
from repro.core.storage.vector_store import DecoupledVectorStore as JVS
from repro.core.storage.vector_store import StoreConfig as JConfig
from repro.data.synthetic import ground_truth, make_queries, make_vector_dataset
from repro.kernels.dispatch import KernelConfig as JKernelConfig
from repro.serve import ann as jann

from repro_torch.core.graph.pq import PQCodebook
from repro_torch.core.index import device_index_from_numpy
from repro_torch.core.search import beam as tbeam
from repro_torch.core.search import engine
from repro_torch.core.storage import layout
from repro_torch.core.storage.colocated import ColocatedStore
from repro_torch.core.storage.index_store import (CompressedIndexStore,
                                                  RawIndexStore)
from repro_torch.core.storage.vector_store import (DecoupledVectorStore,
                                                   StoreConfig)
from repro_torch.serve import ann

from torch_parity import assert_same_report

# 128-dim float32 records (512 B, ~8 a block), as tests/test_engine.py
# chooses, so per-vector I/O is meaningful: at 32 dims every vector read of
# a query dedupes into a few blocks and the arms' orderings do not show.
N, DIM, R, M = 600, 128, 16, 32
CACHE = 12 << 10


@pytest.fixture(scope="module")
def world():
    vecs = make_vector_dataset("prop-like", n=N, dim=DIM,
                               seed=3).astype(np.float32)
    graph = build_vamana(vecs, r=R, l_build=32, seed=0)
    cb = train_pq(vecs, m=M, seed=0)
    codes = encode_pq(vecs, cb)
    queries = make_queries("prop-like", 12, DIM).astype(np.float32)
    gt = ground_truth(vecs, queries, k=10)
    # Raw vector records: the engine reads the same rows and blocks either
    # way, and the CPU's plain Huffman decode would dominate this file
    # (the compressed load is held against the reference in
    # tests/test_torch_storage.py).
    jvs = JVS(JConfig(dim=DIM, dtype=np.float32, segment_capacity=256,
                      compress=False))
    tvs = DecoupledVectorStore(StoreConfig(dim=DIM, dtype=np.float32,
                                           segment_capacity=256,
                                           compress=False, device="cpu"))
    for vs in (jvs, tvs):
        vs.append(np.arange(N), vecs)
        vs.seal_active()
    return dict(vecs=vecs, graph=graph, cb=cb,
                tcb=PQCodebook(cb.centroids, cb.dim), codes=codes,
                queries=queries, gt=gt, jvs=jvs, tvs=tvs)


def stores(w, kind, **kw):
    """(reference store, port store) of ``kind``, fresh (cold caches)."""
    g = w["graph"]
    if kind == "comp":
        return (JIndex.from_graph(g.adjacency, g.medoid, R, cache_bytes=CACHE,
                                  **kw),
                CompressedIndexStore.from_graph(g.adjacency, g.medoid, R,
                                                cache_bytes=CACHE,
                                                device="cpu", **kw))
    if kind == "raw":
        return (JRaw.from_graph(g.adjacency, g.medoid, R, cache_bytes=CACHE),
                RawIndexStore.from_graph(g.adjacency, g.medoid, R,
                                         cache_bytes=CACHE))
    return (JColocated.build(w["vecs"], g.adjacency, g.medoid, R,
                             cache_bytes=CACHE),
            ColocatedStore.build(w["vecs"], g.adjacency, g.medoid, R,
                                 cache_bytes=CACHE))


def assert_same_stats(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, float):
            assert y == pytest.approx(x, rel=1e-12, abs=0), f.name
        else:
            assert x == y, f.name
    assert getattr(a, "prefetch_round", None) == \
        getattr(b, "prefetch_round", None)


def run_both(w, kind, store_kw=None, **cfg_kw):
    """Every query through both engines on fresh stores -> (ids [nq, 10],
    reference stats, port stats), stats checked equal query by query."""
    js, ts = stores(w, kind, **(store_kw or {}))
    jcfg = jengine.EngineConfig(**cfg_kw)
    tcfg = engine.EngineConfig(**cfg_kw)
    ids, jst, tst = [], [], []
    for q in w["queries"]:
        if kind == "colo":
            ja, jb = jengine.search_colocated(js, w["codes"], w["cb"], q, jcfg)
            ta, tb = engine.search_colocated(ts, w["codes"], w["tcb"], q, tcfg)
        else:
            ja, jb = jengine.search_decoupled(js, w["jvs"], w["codes"],
                                              w["cb"], q, jcfg)
            ta, tb = engine.search_decoupled(ts, w["tvs"], w["codes"],
                                             w["tcb"], q, tcfg)
        np.testing.assert_array_equal(ta, ja)
        assert ta.dtype == ja.dtype
        assert_same_stats(jb, tb)
        ids.append(np.pad(ja, (0, 10 - len(ja)), constant_values=-1))
        jst.append(jb)
        tst.append(tb)
    assert js.io.snapshot() == ts.io.snapshot()
    return np.stack(ids), jst, tst


# ------------------------------------------------- tests/test_engine.py
ARMS = {
    "diskann": ("colo", dict(pipelined=False)),
    "pipeann": ("colo", dict(pipelined=True)),
    "decouple": ("raw", dict(latency_aware=False)),
    "decouple_comp": ("comp", dict(latency_aware=False, compressed=True)),
    "decouplevs": ("comp", dict(latency_aware=True, compressed=True)),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_engine_arm_matches_reference(world, arm):
    kind, kw = ARMS[arm]
    run_both(world, kind, l_size=48, **kw)


def test_all_configs_reach_recall_matches_reference(world):
    """tests/test_engine.py's matched-recall sweep, both engines: the
    same ids at every L, so the same recall."""
    ids_dk, _, _ = run_both(world, "colo", l_size=48, pipelined=False)
    r_dk = recall_at_k(ids_dk, world["gt"], 10)
    assert r_dk >= 0.85
    best = 0.0
    for l_size in (48, 80):
        ids, _, _ = run_both(world, "comp", l_size=l_size,
                             latency_aware=True, compressed=True)
        best = max(best, recall_at_k(ids, world["gt"], 10))
    assert best >= r_dk - 0.02


def test_latency_aware_cuts_vector_io_matches_reference(world):
    _, _, plain = run_both(world, "comp", l_size=48, latency_aware=False,
                           compressed=True)
    _, _, aware = run_both(world, "comp", l_size=48, latency_aware=True,
                           compressed=True)
    assert np.mean([s.vector_ios for s in aware]) < \
        np.mean([s.vector_ios for s in plain])


def test_decoupled_modeled_latency_ordering_matches_reference(world):
    lat = {}
    for name, (kind, kw) in ARMS.items():
        _, jst, tst = run_both(world, kind, l_size=48, **kw)
        lat[name] = np.mean([s.latency_us for s in tst])
        assert lat[name] == np.mean([s.latency_us for s in jst])
    assert lat["pipeann"] < lat["diskann"]
    assert lat["decouple"] > lat["pipeann"]
    assert lat["decouplevs"] < lat["diskann"]


def test_cost_table_has_only_the_port_backends():
    """One cost row, the reference's ``ref`` row: no per-backend table, no
    TPU row, no fused-beam discount and no backend argument anywhere."""
    ref = jengine.KERNEL_COST_US["ref"]
    assert (engine.T_PQ, engine.T_EX, engine.T_DEC) == \
        (ref["pq"], ref["ex"], ref["dec"])
    for gone in ("KERNEL_COST_US", "FUSED_BEAM_DISCOUNT", "compute_costs",
                 "op_backend", "beam_compute_costs"):
        assert not hasattr(engine, gone), gone
    assert "kernel_backend" not in {
        f.name for f in dataclasses.fields(engine.EngineConfig)}
    assert (engine.T_PQ, engine.T_EX, engine.T_DEC, engine.T_IO) == \
        (jengine.T_PQ, jengine.T_EX, jengine.T_DEC, jengine.T_IO)


def _searcher_prices():
    """The serving tier's pricing: the port's BatchedSearcher and the
    reference's, its kernels all ``ref``, on one small index, their
    reports of one batch equal -> (the port's decode costs, the
    reference's costs)."""
    vecs = make_vector_dataset("prop-like", n=200, dim=16,
                               seed=0).astype(np.float32)
    jindex, _, _ = jbuild(vecs, r=8, l_build=16, pq_m=4, seed=0)
    tindex = device_index_from_numpy(
        {k: np.asarray(v) for k, v in jindex._asdict().items()}, "cpu")
    kw = dict(l_size=16, beam_width=4, k=5, rerank_batch=5, r_max=8,
              universe=200, max_iters=32)
    js = jann.BatchedSearcher(
        jindex, jbeam.SearchParams(**kw, kernels=JKernelConfig(
            *["ref"] * 5)), jann.ServeConfig(buckets=(4,)))
    ts = ann.BatchedSearcher(tindex, tbeam.SearchParams(**kw),
                             ann.ServeConfig(buckets=(4,)), device="cpu")
    queries = make_queries("prop-like", 4, 16).astype(np.float32)
    want, got = js.search(queries)[2], ts.search(queries)[2]
    assert got.modeled_latency_us > 0
    assert_same_report(want, got)
    return ((ts._t_dec_ix, ts._t_dec_vec),
            (js._t_pq, js._t_ex, js._t_dec_ix, js._t_dec_vec))


@pytest.mark.parametrize("site", ["searcher", "cpu_us", "merge"])
def test_every_pricing_site_prices_at_the_reference_ref_row(site):
    """The serving tier, the host engines' compute price and the merge's
    each price at the reference's ``ref`` constants, on the CPU and the
    card alike."""
    ref = jengine.KERNEL_COST_US["ref"]
    if site == "searcher":
        port_dec, ref_costs = _searcher_prices()
        assert ref_costs == (ref["pq"], ref["ex"], ref["dec"], ref["dec"])
        assert port_dec == (ref["dec"], ref["dec"])
    elif site == "cpu_us":
        kw = dict(pq_ops=37, exact_ops=11, decompressions=9, graph_decs=5,
                  vector_decs=4)
        want = 37 * ref["pq"] + 11 * ref["ex"] + 9 * ref["dec"]
        assert engine._cpu_us(engine.QueryStats(**kw)) == want
        assert engine._cpu_us(engine.QueryStats(**kw),
                              engine.EngineConfig()) == want
        assert jengine._cpu_us(jengine.QueryStats(**kw),
                               jengine.EngineConfig(
                                   kernel_backend="ref")) == want
    else:
        for blocks, lists in ((7, 90), (0, 3), (12, 0)):
            assert engine.merge_cost_us(blocks, lists) == \
                jengine.merge_cost_us(blocks, lists, "ref") == \
                blocks * jengine.T_IO_WRITE + lists * ref["dec"]


def test_manifest_vs_kernel_backend_dec_precedence_matches_reference():
    """The manifest picks each tier's codec cost; with no backend scaling
    left, every codec prices at the reference's ``ref`` rate."""
    def plans(mod, adj, vec):
        comps = {}
        for comp, codec in (("adjacency", adj), ("vector_chunks", vec)):
            if codec is not None:
                comps[comp] = mod.ComponentPlan(
                    component=comp, codec=codec, raw_bytes=100, est_bytes=50,
                    candidates={}, params={})
        return mod.StorageManifest(components=comps)

    for adj, vec in (("delta_varint", "ans_id"), (None, None),
                     ("raw", "huffman"), ("elias_fano", None)):
        want = jengine.manifest_dec_costs(plans(jlayout, adj, vec), "ref")
        got = engine.manifest_dec_costs(plans(layout, adj, vec))
        assert got == want
    assert engine.manifest_dec_costs(None) == \
        jengine.manifest_dec_costs(None, "ref")
    for codec in engine.CODEC_DEC_US:
        assert engine.t_dec_for(codec) == jengine.t_dec_for(codec, "ref")
    with pytest.raises(ValueError, match="unknown codec"):
        engine.t_dec_for("lz4")


def test_merge_topk_ties_and_prices_match_reference():
    """Stable merge: earlier lanes win distance ties, +inf sinks; and the
    merge/tail/service prices equal the reference's."""
    rng = np.random.default_rng(0)
    d = rng.integers(0, 4, (3, 5, 6)).astype(np.float32)   # many ties
    d[1, :, 4:] = np.inf
    ids = rng.integers(-1, 50, (3, 5, 6)).astype(np.int64)
    for k in (1, 6, 18):
        got = engine.merge_topk(ids, d, k)
        want = jengine.merge_topk(ids, d, k)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    tie_i = np.array([[[7]], [[3]]], np.int64)
    tie_d = np.zeros((2, 1, 1), np.float32)
    assert engine.merge_topk(tie_i, tie_d, 1)[0][0, 0] == 7
    for args in ((16, 4, "hier"), (16, [4, 8], "hier"), (16, [3, 8], "hier"),
                 (10, 32, "flat"), (10, 1, "hier")):
        assert engine.shard_merge_cost_us(*args) == \
            jengine.shard_merge_cost_us(*args)
    with pytest.raises(ValueError, match="merge mode"):
        engine.shard_merge_cost_us(4, 4, "tree")
    for b in (0, 1, 5):
        assert engine.rerank_tail_us(b) == jengine.rerank_tail_us(b)
    assert engine.merge_cost_us(7, 90) == jengine.merge_cost_us(7, 90, "ref")
    sm, jsm = engine.ServiceModel(150.0, 80.0), jengine.ServiceModel(150.0,
                                                                     80.0)
    for n in (0, 1, 9):
        assert sm.service_us(n) == jsm.service_us(n)
        assert sm.latest_cut_us(5000.0, n) == jsm.latest_cut_us(5000.0, n)
        assert sm.slack_us(5000.0, 100.0, n) == \
            jsm.slack_us(5000.0, 100.0, n)

    class Probe:
        modeled_latency_us = 321.5
    assert engine.service_model_from_report(Probe()) == \
        engine.ServiceModel(321.5, engine.T_IO)
    with pytest.raises(ValueError, match="modeled latency"):
        engine.service_model_from_report(object())


# ------------------------------------------------ tests/test_prefetch.py
@pytest.mark.parametrize("order", [None, "minla"])
@pytest.mark.parametrize("rerank_batch", [1, 7, 32])
def test_prefetch_invariance_decoupled_matches_reference(world, order,
                                                         rerank_batch):
    """Both engines agree with prefetch off and on; on the port, ids are
    invariant, waste stays within budget and the stall identity holds."""
    base = dict(l_size=48, latency_aware=True, compressed=True,
                rerank_batch=rerank_batch)
    ids_off, _, st_off = run_both(world, "comp", dict(order=order), **base)
    ids_on, _, st_on = run_both(world, "comp", dict(order=order),
                                prefetch_depth=6, prefetch_budget=16,
                                pricing="pipelined_overlap", **base)
    np.testing.assert_array_equal(ids_off, ids_on)
    for a, b in zip(st_off, st_on):
        assert b.prefetch_wasted <= 16
        assert a.io_rounds == b.io_rounds + b.covered_rounds
        assert a.traversal_rounds == b.traversal_rounds


def test_prefetch_invariance_coresident_matches_reference(world):
    base = dict(l_size=48, latency_aware=True, compressed=True)
    ids_plain, _, _ = run_both(world, "comp", dict(order="minla"), **base)
    ids_cor, _, st = run_both(world, "comp",
                              dict(order="minla", coresident=True),
                              prefetch_depth=6, pricing="pipelined_overlap",
                              **base)
    np.testing.assert_array_equal(ids_plain, ids_cor)
    assert sum(s.prefetch_hits for s in st) > 0


def test_prefetch_invariance_colocated_matches_reference(world):
    ids_off, _, st_off = run_both(world, "colo", l_size=48,
                                  pricing="blocking")
    ids_on, _, st_on = run_both(world, "colo", l_size=48, prefetch_depth=6,
                                prefetch_budget=16,
                                pricing="pipelined_overlap")
    np.testing.assert_array_equal(ids_off, ids_on)
    for a, b in zip(st_off, st_on):
        assert b.prefetch_wasted <= 16
        assert a.io_rounds == b.io_rounds + b.covered_rounds
        assert b.latency_us <= a.latency_us


def test_lru_conservation_matches_reference(world):
    js, ts = stores(world, "comp", order="minla")
    cfg = dict(l_size=48, latency_aware=True, compressed=True,
               prefetch_depth=6, pricing="pipelined_overlap")
    for q in world["queries"]:
        jengine.search_decoupled(js, world["jvs"], world["codes"],
                                 world["cb"], q, jengine.EngineConfig(**cfg))
        engine.search_decoupled(ts, world["tvs"], world["codes"],
                                world["tcb"], q, engine.EngineConfig(**cfg))
    for c in (js.cache, ts.cache):
        assert c.lookups == c.hits + c.misses + c.prefetch_hits
    assert (ts.cache.lookups, ts.cache.hits, ts.cache.misses,
            ts.cache.prefetch_hits) == (js.cache.lookups, js.cache.hits,
                                        js.cache.misses,
                                        js.cache.prefetch_hits)
    assert ts.cache.prefetch_hits > 0


def test_overlap_never_prices_above_blocking_matches_reference(world):
    base = dict(l_size=48, latency_aware=True, compressed=True)
    _, _, st_blk = run_both(world, "comp", dict(order="minla"),
                            pricing="blocking", **base)
    _, _, st_ovl = run_both(world, "comp", dict(order="minla"),
                            prefetch_depth=6, pricing="pipelined_overlap",
                            **base)
    assert sum(s.covered_rounds for s in st_ovl) > 0
    for a, b in zip(st_blk, st_ovl):
        assert b.latency_us <= a.latency_us
        assert b.overlap_saved_us >= 0.0
        if b.covered_rounds:
            assert b.latency_us < a.latency_us


def test_pricing_mode_validated(world):
    assert engine.PRICING_MODES == jengine.PRICING_MODES
    _, ts = stores(world, "comp")
    with pytest.raises(ValueError, match="pricing"):
        engine.search_decoupled(ts, world["tvs"], world["codes"],
                                world["tcb"], world["queries"][0],
                                engine.EngineConfig(pricing="typo"))
    _, tc = stores(world, "colo")
    with pytest.raises(ValueError, match="pricing"):
        engine.search_colocated(tc, world["codes"], world["tcb"],
                                world["queries"][0],
                                engine.EngineConfig(pricing="typo"))


def test_colocated_engine_reads_tensor_stores(world):
    """A co-located store holding tensors (the port's shard layout) gives
    the same ids and stats as one holding the numpy arrays."""
    g = world["graph"]
    cfg = engine.EngineConfig(l_size=48)
    a = ColocatedStore.build(world["vecs"], g.adjacency, g.medoid, R,
                             cache_bytes=CACHE)
    nb = np.full((N, R), -1, np.int64)
    for i, adj in enumerate(g.adjacency):
        nb[i, :len(adj)] = adj
    b = ColocatedStore.build(torch.from_numpy(world["vecs"]),
                             torch.from_numpy(nb), g.medoid, R,
                             cache_bytes=CACHE)
    for q in world["queries"][:4]:
        ia, sa = engine.search_colocated(a, world["codes"], world["tcb"], q,
                                         cfg)
        ib, sb = engine.search_colocated(b, world["codes"], world["tcb"], q,
                                         cfg)
        np.testing.assert_array_equal(ia, ib)
        assert_same_stats(sa, sb)
