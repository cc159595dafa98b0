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
from repro.core.index import recall_at_k
from repro.core.search import engine as jengine
from repro.core.storage.colocated import ColocatedStore as JColocated
from repro.core.storage.index_store import CompressedIndexStore as JIndex
from repro.core.storage.index_store import RawIndexStore as JRaw
from repro.core.storage import layout as jlayout
from repro.core.storage.vector_store import DecoupledVectorStore as JVS
from repro.core.storage.vector_store import StoreConfig as JConfig
from repro.data.synthetic import ground_truth, make_queries, make_vector_dataset
from repro.kernels.dispatch import KernelConfig as JKernelConfig

from repro_torch.core.graph.pq import PQCodebook
from repro_torch.core.search import engine
from repro_torch.core.storage import layout
from repro_torch.core.storage.colocated import ColocatedStore
from repro_torch.core.storage.index_store import (CompressedIndexStore,
                                                  RawIndexStore)
from repro_torch.core.storage.vector_store import (DecoupledVectorStore,
                                                   StoreConfig)
from repro_torch.kernels.dispatch import KernelConfig

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
    """No TPU row and no fused-beam discount; ``cuda`` prices as ``ref``
    (the reference's ``ref`` row) until the card's numbers replace it."""
    assert set(engine.KERNEL_COST_US) == {"ref", "cuda"}
    assert engine.KERNEL_COST_US["cuda"] == engine.KERNEL_COST_US["ref"] \
        == jengine.KERNEL_COST_US["ref"]
    assert not hasattr(engine, "FUSED_BEAM_DISCOUNT")
    for name in ("pallas", "auto-tuned", "pallas-interpret", "auto"):
        with pytest.raises(ValueError, match="unknown kernel backend"):
            engine.compute_costs(name)
    assert (engine.T_PQ, engine.T_EX, engine.T_DEC, engine.T_IO) == \
        (jengine.T_PQ, jengine.T_EX, jengine.T_DEC, jengine.T_IO)


@pytest.mark.parametrize("device,backend", [("cpu", "ref"),
                                            ("cuda", "cuda")])
def test_pricing_backend_follows_the_device(device, backend):
    """The serving tier prices at the backend an ``auto`` request resolves
    to on the index's device; the reference's CPU resolution is ``ref``."""
    k = KernelConfig()
    assert engine.op_backend(k, "pq_adc", device) == backend
    assert engine.beam_compute_costs(k, device) == \
        jengine.beam_compute_costs(JKernelConfig().resolve("cpu"))


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_manifest_vs_kernel_backend_dec_precedence_matches_reference(
        backend):
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
        got = engine.manifest_dec_costs(plans(layout, adj, vec), backend)
        assert got == want
    assert engine.manifest_dec_costs(None, backend) == \
        jengine.manifest_dec_costs(None, "ref")
    for codec in engine.CODEC_DEC_US:
        assert engine.t_dec_for(codec, backend) == \
            jengine.t_dec_for(codec, "ref")
    with pytest.raises(ValueError, match="unknown codec"):
        engine.t_dec_for("lz4", backend)


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
    assert engine.merge_cost_us(7, 90, "cuda") == \
        jengine.merge_cost_us(7, 90, "ref")
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
