"""Port parity tier for the serving tier (``repro_torch.serve.ann``): the
cases of tests/test_serve_ann.py, each served by the reference's
``BatchedSearcher`` and by the port's (``device="cpu"``) on the same
state — the reference's ``DeviceIndex`` and ``ShardedIndex`` handed over as
numpy, and live worlds built from the same graph, codebook and vectors.

Ids identical, distances within rtol 1e-6 (tests/test_torch_search.py),
every integer ``BatchReport`` field equal and its modeled prices within
rtol 1e-12.
"""
import numpy as np
import pytest
import torch

from repro.core.distributed import sharded_index as jsharded
from repro.core.index import build_device_index
from repro.core.search import beam as jbeam
from repro.core.storage import layout as jlayout
from repro.core.update.consistency import (
    ShardedSnapshotHandle as JShardedHandle)
from repro.data.synthetic import ground_truth, make_queries, make_vector_dataset
from repro.serve import ann as jann

from repro_torch.core.distributed.sharded_index import (
    ShardRouter, build_router, build_sharded_index, route_mask,
    sharded_index_from_numpy)
from repro_torch.core.index import device_index_from_numpy
from repro_torch.core.search import beam as tbeam
from repro_torch.core.search import engine
from repro_torch.core.search.beam import search, search_vmapped
from repro_torch.core.storage import layout
from repro_torch.core.update.consistency import ShardedSnapshotHandle
from repro_torch.serve import ann

from torch_parity import (assert_same_report, assert_same_results,
                          streaming_pair)

N, DIM = 400, 16


def arrays(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


@pytest.fixture(scope="module")
def small_world():
    vecs = make_vector_dataset("prop-like", n=N, dim=DIM,
                               seed=0).astype(np.float32)
    jindex, _, _ = build_device_index(vecs, r=16, l_build=32, pq_m=4, seed=0)
    tindex = device_index_from_numpy(arrays(jindex), "cpu")
    queries = make_queries("prop-like", 32, DIM).astype(np.float32)
    return vecs, jindex, tindex, queries


def params(mod, n, **kw):
    d = dict(l_size=32, beam_width=4, k=5, rerank_batch=5, r_max=16,
             universe=n, max_iters=64)
    d.update(kw)
    return mod.SearchParams(**d)


def serve_both(jindex, tindex, queries, cfg_kw=None, p_kw=None, n=N,
               reps=1, search_kw=None, **kw):
    """Both searchers over the same state and queries, ``reps`` batches;
    results and reports compared batch by batch. -> the port's results."""
    cfg_kw, p_kw, search_kw = cfg_kw or {}, p_kw or {}, search_kw or {}
    js = jann.BatchedSearcher(jindex, params(jbeam, n, **p_kw),
                              jann.ServeConfig(**cfg_kw), **kw)
    ts = ann.BatchedSearcher(tindex, params(tbeam, n, **p_kw),
                             ann.ServeConfig(**cfg_kw),
                             device="cpu", **_port_kw(kw))
    out = []
    for _ in range(reps):
        want = js.search(queries, **search_kw)
        got = ts.search(queries, **search_kw)
        assert_same_results(want, got)
        assert_same_report(want[2], got[2])
        out.append(got)
    return ts, out


def _port_kw(kw):
    """The port's searcher arguments for the reference's: a router goes
    over as the same centroids."""
    kw = dict(kw)
    if kw.get("router") is not None:
        kw["router"] = ShardRouter(centroids=torch.from_numpy(
            np.array(kw["router"].centroids)))
    return kw


# ------------------------------------------------------------ plan_buckets
def test_plan_buckets_matches_reference():
    for buckets in ((1, 8, 32), (8, 32), (1, 4), (3, 5, 17), (16,)):
        for nq in range(0, 90):
            assert ann.plan_buckets(nq, buckets) == \
                jann.plan_buckets(nq, buckets), (nq, buckets)
    assert ann.plan_buckets(17, (1, 8, 32)) == [(0, 8, 8), (8, 8, 8),
                                                (16, 1, 1)]
    assert ann.plan_buckets(71, (1, 8, 32), max_chunks=3) == [
        (0, 32, 32), (32, 32, 32), (64, 7, 8)]
    for args in ((71, (1, 8, 32), 2), (17, (1, 8, 32), 2)):
        with pytest.raises(ValueError, match="max_chunks"):
            ann.plan_buckets(*args)
    with pytest.raises(ValueError):
        ann.plan_buckets(4, (0,))


# ------------------------------------------------------------ single shard
@pytest.mark.parametrize("nq", [1, 7, 32])
def test_batched_equals_per_query_matches_reference(small_world, nq):
    """B in {1, 7, 32} through pad-and-bucket serving: the port's batch
    equals the reference's, and each row equals the port's nq=1 search."""
    vecs, jindex, tindex, queries = small_world
    ts, ((ids, dists, rep),) = serve_both(
        jindex, tindex, queries[:nq], cfg_kw=dict(buckets=(1, 8, 32)))
    assert ids.shape == (nq, 5)
    for qi in range(nq):
        i1, d1, _ = search(tindex, queries[qi][None], ts.p, device="cpu")
        np.testing.assert_array_equal(ids[qi], i1[0].numpy())
        np.testing.assert_array_equal(dists[qi], d1[0].numpy())


def test_search_vmapped_matches_reference(small_world):
    """The per-query baseline: ids equal the batched search's and the
    reference's vmapped search's; every stats field equals the batch's."""
    vecs, jindex, tindex, queries = small_world
    p = params(tbeam, N, trace_fetches=True)
    ids_b, d_b, st_b = search(tindex, queries[:8], p, device="cpu")
    ids_v, d_v, st_v = search_vmapped(tindex, queries[:8], p, device="cpu")
    np.testing.assert_array_equal(ids_v.numpy(), ids_b.numpy())
    np.testing.assert_array_equal(d_v.numpy(), d_b.numpy())
    for f, a, b in zip(st_b._fields, st_b, st_v):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
    want = jbeam.search_vmapped(jindex, queries[:8], params(jbeam, N))
    assert_same_results(want, (ids_v.numpy(), d_v.numpy()))


def test_io_accounting_matches_reference(small_world):
    """The fetch-trace replay through the §3.4 LRU: a repeated batch is
    served from the warm cache, and both reports of both tiers agree."""
    vecs, jindex, tindex, queries = small_world
    _, ((_, _, r1), (_, _, r2)) = serve_both(
        jindex, tindex, queries[:8], reps=2,
        cfg_kw=dict(buckets=(8,), cache_bytes=1 << 20))
    assert r1.graph_ios > 0 and r1.vector_ios == r1.exact_ops > 0
    assert r1.io_rounds > 0 and r1.modeled_latency_us > 0
    assert r2.graph_ios == 0 and r2.cache_hits >= r1.graph_ios


def test_stats_disabled_path_matches_reference(small_world):
    vecs, jindex, tindex, queries = small_world
    _, ((ids, _, rep),) = serve_both(
        jindex, tindex, queries[:8],
        cfg_kw=dict(buckets=(8,), account_io=False))
    assert rep.graph_ios == 0 and rep.modeled_latency_us == 0
    ids_ref, _, _ = search(tindex, queries[:8], params(tbeam, N),
                           device="cpu")
    np.testing.assert_array_equal(ids, ids_ref.numpy())


def test_tenants_and_prefetch_accounting_match_reference(small_world):
    """Per-tenant LRU partitions on a shared budget, with the speculative
    prefetch replay: every counter, queue and partition equal."""
    vecs, jindex, tindex, queries = small_world
    tenants = ["a", "b", "a", "c", "b", "a", "a", "c", "b", "a", "c", "a"]
    _, runs = serve_both(
        jindex, tindex, queries[:12], reps=2,
        cfg_kw=dict(buckets=(1, 4, 8), cache_bytes=1 << 12,
                    shared_budget=True, prefetch_depth=4,
                    prefetch_budget=8),
        search_kw=dict(tenants=tenants))
    rep = runs[0][2]
    assert rep.tenants == {"a": 6, "b": 3, "c": 3}
    assert rep.prefetch_issued > 0 and rep.prefetch_queues
    assert any(k.startswith("tenant:") for k in rep.component_io)


def test_manifest_pricing_matches_reference(small_world):
    vecs, jindex, tindex, queries = small_world

    def man(mod):
        plan = lambda c, codec: mod.ComponentPlan(
            component=c, codec=codec, raw_bytes=100, est_bytes=50,
            candidates={}, params={})
        return mod.StorageManifest(components={
            "adjacency": plan("adjacency", "delta_varint"),
            "vector_chunks": plan("vector_chunks", "huffman")})
    js = jann.BatchedSearcher(jindex, params(jbeam, N),
                              jann.ServeConfig(buckets=(8,),
                                               manifest=man(jlayout)))
    ts = ann.BatchedSearcher(tindex, params(tbeam, N),
                             ann.ServeConfig(buckets=(8,),
                                             manifest=man(layout)),
                             device="cpu")
    assert (engine.T_PQ, engine.T_EX, ts._t_dec_ix, ts._t_dec_vec) == \
        (js._t_pq, js._t_ex, js._t_dec_ix, js._t_dec_vec)
    assert_same_report(js.search(queries[:8])[2], ts.search(queries[:8])[2])


# ------------------------------------------------------------------ sharded
@pytest.fixture(scope="module")
def sharded_world():
    """tests/test_serve_ann.py's exhaustive 2-shard world, both ways."""
    vecs = make_vector_dataset("prop-like", n=240, dim=DIM,
                               seed=0).astype(np.float32)
    queries = make_queries("prop-like", 16, DIM).astype(np.float32)
    jsh, per = jsharded.build_sharded_index(vecs, 2, r=24, l_build=48,
                                            pq_m=4)
    tsh = sharded_index_from_numpy(arrays(jsh), "cpu")
    return vecs, queries, jsh, tsh, per


EXH = dict(l_size=256, beam_width=4, k=5, rerank_batch=16,
           benefit_threshold=0.0, max_rerank_batches=32, r_max=24,
           max_iters=256)


def test_port_builds_the_reference_sharded_index(sharded_world):
    vecs, _, jsh, _, per = sharded_world
    tsh, tper = build_sharded_index(vecs, 2, r=24, l_build=48, pq_m=4,
                                    device="cpu")
    assert tper == per
    for f, a in arrays(jsh).items():
        b = getattr(tsh, f).numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        np.testing.assert_array_equal(b, a, err_msg=f)


def test_sharded_merge_equals_unsharded_matches_reference(sharded_world):
    """With exhaustive search the 2-shard fan-out + global merge equals the
    unsharded top-K and brute force, on both tiers."""
    vecs, queries, jsh, tsh, per = sharded_world
    gt = ground_truth(vecs, queries, k=5)
    un, _, _ = build_device_index(vecs, r=24, l_build=48, pq_m=4, seed=0)
    _, ((ids_un, d_un, _),) = serve_both(
        un, device_index_from_numpy(arrays(un), "cpu"), queries, n=240,
        cfg_kw=dict(buckets=(16,)), p_kw=EXH)
    _, ((ids_sh, d_sh, rep),) = serve_both(
        jsh, tsh, queries, n=per, cfg_kw=dict(buckets=(16,)), p_kw=EXH,
        shard_size=per)
    assert rep.n_shards == 2
    np.testing.assert_array_equal(ids_un, gt)
    np.testing.assert_array_equal(ids_sh, gt)
    np.testing.assert_allclose(d_sh, d_un, rtol=1e-6)
    assert ids_sh.max() >= per


@pytest.fixture(scope="module")
def routed_world():
    """4 clustered shards of a 300-vector world with a padded last shard,
    and a router of 3 centroids a shard."""
    vecs = make_vector_dataset("prop-like", n=298, dim=DIM,
                               seed=4).astype(np.float32)
    queries = make_queries("prop-like", 12, DIM, seed=5).astype(np.float32)
    jsh, per = jsharded.build_sharded_index(vecs, 4, r=12, l_build=24,
                                            pq_m=4, partition="cluster")
    router = jsharded.build_router(jsh, c=3)
    return queries, jsh, sharded_index_from_numpy(arrays(jsh), "cpu"), \
        router, per


def test_router_and_route_mask_match_reference(routed_world):
    queries, jsh, tsh, router, _ = routed_world
    tr = build_router(tsh, c=3)
    np.testing.assert_array_equal(tr.centroids.numpy(),
                                  np.asarray(router.centroids))
    for frac in (0.1, 0.25, 0.5, 0.75, 1.0):
        np.testing.assert_array_equal(
            route_mask(tr.centroids, queries, frac).numpy(),
            np.asarray(jsharded.route_mask(router.centroids, queries, frac)))
    # equal scores: the lower shard index wins, as lax.top_k's does
    tie = np.zeros((3, 1, DIM), np.float32)
    np.testing.assert_array_equal(
        route_mask(tie, queries[:2], 0.34).numpy(),
        np.asarray(jsharded.route_mask(tie, queries[:2], 0.34)))


@pytest.mark.parametrize("case", ["full", "routed", "failed",
                                  "routed_failed"])
def test_sharded_serving_matches_reference(routed_world, case):
    """Frozen sharded fan-out with row_ids maps (pad rows masked), the
    router at route_frac 0.5 and a failed shard, with tenants so the key
    maps are replayed: every result and report field equal."""
    queries, jsh, tsh, router, per = routed_world
    kw = dict(shard_size=per)
    cfg_kw = dict(buckets=(1, 4), cache_bytes=1 << 12)
    search_kw = dict(tenants=["x", "y"] * 6)
    if "routed" in case:
        kw["router"] = router
        cfg_kw["route_frac"] = 0.5
    if "failed" in case:
        search_kw["failed_shards"] = [1]
    _, ((ids, _, rep),) = serve_both(jsh, tsh, queries, cfg_kw=cfg_kw,
                                     n=per, search_kw=search_kw, **kw)
    assert rep.n_shards == 4
    assert (rep.fanout_frac < 1.0) == ("routed" in case)
    assert (rep.failed_shards == [1]) == ("failed" in case)
    rids = np.asarray(jsh.row_ids)
    assert not np.isin(ids[ids >= 0], rids[rids < 0]).any()


def test_router_needs_a_frozen_sharded_index(small_world, routed_world):
    _, _, tindex, _ = small_world
    _, _, tsh, _, _ = routed_world
    router = build_router(tsh, c=2)
    with pytest.raises(ValueError, match="frozen"):
        ann.BatchedSearcher(tindex, params(tbeam, N), router=router,
                            device="cpu")


# --------------------------------------------------------------------- live
@pytest.fixture
def live_pair():
    vecs = make_vector_dataset("prop-like", n=300, dim=DIM,
                               seed=2).astype(np.float32)
    return (vecs,) + streaming_pair(vecs)


LIVE_P = dict(l_size=32, k=5, rerank_batch=5, max_iters=64,
              benefit_threshold=0.0)


def live_searchers(ref, port, buckets=(4, 8)):
    return (jann.BatchedSearcher(ref.handle, jbeam.SearchParams(**LIVE_P),
                                 jann.ServeConfig(buckets=buckets)),
            ann.BatchedSearcher(port.handle,
                                tbeam.SearchParams(**LIVE_P),
                                ann.ServeConfig(buckets=buckets),
                                device="cpu"))


def serve_live(js, ts, q):
    want, got = js.search(q), ts.search(q)
    assert_same_results(want, got)
    assert_same_report(want[2], got[2])
    return got


def test_live_searcher_matches_reference_and_streaming_search(live_pair):
    vecs, ref, port = live_pair
    js, ts = live_searchers(ref, port)
    q = vecs[[3, 50, 90, 123, 200]] + 0.001
    ids, _, rep = serve_live(js, ts, q)
    np.testing.assert_array_equal(ids, port.search_batch(q, k=5,
                                                         l_size=32)[0])
    assert rep.snapshot_version == port.handle.current().version
    assert rep.storage_bytes["adjacency"] > 0


def test_live_searcher_hot_swaps_on_publish_matches_reference(live_pair):
    """Each batch pins the snapshot current at admission; a merge between
    batches is picked up (version moves), tombstones/memtable included —
    on both tiers, with the same ids and reports at every step."""
    vecs, ref, port = live_pair
    js, ts = live_searchers(ref, port, buckets=(4,))
    q = vecs[[60, 61, 62, 63]]
    ids0, _, rep0 = serve_live(js, ts, q)
    v0 = rep0.snapshot_version
    target = int(ids0[0, 0])
    fresh_id = len(port.adjacency) + 10
    for x in (ref, port):
        x.delete([target])
        x.insert(np.array([fresh_id]), (vecs[60] * 1.0002)[None])
    ids1, _, rep1 = serve_live(js, ts, q)
    assert rep1.snapshot_version == v0
    assert target not in set(ids1.reshape(-1).tolist())
    assert fresh_id in set(ids1[0].tolist())
    assert rep1.mem_candidates == 1
    for x in (ref, port):
        x.merge()
    ids2, _, rep2 = serve_live(js, ts, q)
    assert rep2.snapshot_version == v0 + 1
    assert target not in set(ids2.reshape(-1).tolist())
    assert fresh_id in set(ids2[0].tolist())
    assert rep2.mem_candidates == 0


def test_sharded_live_serving_matches_reference():
    """Two live shards behind one ShardedSnapshotHandle: a version vector
    pinned a batch, one memtable lane a shard with its offset, a failed
    shard, and a publish on one shard only."""
    vecs = make_vector_dataset("prop-like", n=360, dim=DIM,
                               seed=6).astype(np.float32)
    pairs = [streaming_pair(vecs[:180]), streaming_pair(vecs[180:])]
    jh = JShardedHandle([r.handle for r, _ in pairs])
    th = ShardedSnapshotHandle([p.handle for _, p in pairs])
    assert th.offsets == jh.offsets
    js = jann.BatchedSearcher(jh, jbeam.SearchParams(**LIVE_P),
                              jann.ServeConfig(buckets=(4, 8)))
    ts = ann.BatchedSearcher(th, tbeam.SearchParams(**LIVE_P),
                             ann.ServeConfig(buckets=(4, 8)), device="cpu")
    q = np.concatenate([vecs[[5, 70]], vecs[[190, 300]]]) + 0.001
    serve_live(js, ts, q)
    for x in pairs[1]:
        x.delete([10])
        x.insert(np.array([190]), (vecs[300] * 1.0003)[None])
    ids, _, rep = serve_live(js, ts, q)
    assert rep.mem_candidates == 1
    assert th.offsets[1] + 190 in set(ids[3].tolist())
    for x in pairs[1]:
        x.merge()
    ids, _, rep = serve_live(js, ts, q)
    assert rep.shard_versions == [0, 1]
    want = js.search(q, failed_shards=[0])
    got = ts.search(q, failed_shards=[0])
    assert_same_results(want, got)
    assert_same_report(want[2], got[2])
