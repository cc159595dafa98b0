"""Port parity tier for the §3.5 update path
(``repro_torch.core.update.fresh``): the cases of tests/test_updates.py
that use only public APIs, and the merge paths of
tests/test_incremental_store.py driven through ``StreamingIndex`` — each on
a reference index and a port index (``device="cpu"``) built from the same
graph, codebook and vectors, through insert, delete, merge and GC.

After every step: ids identical (distances within rtol 1e-6), every
``MergeStats`` field but the wall times equal, and the graph, PQ codes,
buffers, versions and every I/O counter of both engines equal.
"""
import numpy as np
import pytest

from repro.core.graph.pq import encode_pq as jencode_pq
from repro.core.graph.pq import train_pq as jtrain_pq
from repro.core.graph.vamana import build_vamana as jbuild_vamana
from repro.core.graph.vamana import robust_prune as jrobust_prune
from repro.core.search.beam import SearchParams as JSearchParams
from repro.core.update.fresh import snapshot_search as jsnapshot_search
from repro.data.pipeline import StreamingVectorWorkload
from repro.data.synthetic import make_vector_dataset

from repro_torch.core.graph.pq import PQCodebook
from repro_torch.core.search.beam import SearchParams
from repro_torch.core.storage.vector_store import (DecoupledVectorStore,
                                                   StoreConfig)
from repro_torch.core.update.fresh import (StreamingIndex, UpdateConfig,
                                           snapshot_search)

from torch_parity import (assert_same_index_state, assert_same_merge,
                          assert_same_results, streaming_pair)


def search_both(ref, port, queries, k=10, l_size=64):
    want = ref.search_batch(queries, k=k, l_size=l_size)
    got = port.search_batch(queries, k=k, l_size=l_size)
    assert_same_results(want, got)
    return got[0]


def merge_both(ref, port, **kw):
    sa, sb = ref.merge(**kw), port.merge(**kw)
    assert_same_merge(sa, sb)
    assert_same_index_state(ref, port)
    return sb


def both(pair, method, *args):
    for x in pair:
        getattr(x, method)(*args)


@pytest.fixture(scope="module")
def streaming():
    vecs = make_vector_dataset("prop-like", n=400, dim=16,
                               seed=1).astype(np.float32)
    return (vecs,) + streaming_pair(vecs)


def test_no_private_greedy_loop():
    assert not hasattr(StreamingIndex, "_greedy_visit")
    assert not hasattr(StreamingIndex, "search_greedy")


def test_search_before_updates(streaming):
    vecs, ref, port = streaming
    ids = search_both(ref, port, (vecs[17] + 0.001)[None], k=5)
    assert 17 in ids[0]
    snap = port.handle.current()
    assert snap.device is not None
    assert int(snap.device.pq_codes.shape[0]) == len(port.adjacency)
    assert not bool(snap.device.tombstone.any())


def test_update_cycle_matches_reference(streaming):
    """The module world through test_updates.py's sequence: a delete seen
    before any merge, an insert seen through the memtable, the id-reuse
    guards, a merge of deletes + inserts, and a GC-triggering merge."""
    vecs, ref, port = streaming
    pair = (ref, port)
    target = int(search_both(ref, port, vecs[33][None], k=1)[0, 0])
    both(pair, "delete", [target])
    assert bool(port.handle.current().device.tombstone[target])
    assert target not in search_both(ref, port, vecs[33][None])[0]
    new_vec = vecs[100] + 0.0005
    both(pair, "insert", np.array([400]), new_vec[None])
    assert 400 in search_both(ref, port, new_vec[None], k=3)[0]
    for x in pair:
        with pytest.raises(ValueError, match="id reuse"):
            x.insert(np.array([17]), vecs[17][None])
        with pytest.raises(ValueError, match="id reuse"):
            x.insert(np.array([400]), vecs[11][None])
        with pytest.raises(ValueError, match="id reuse"):
            x.insert(np.array([451, 451]), np.stack([vecs[12], vecs[13]]))
    assert_same_index_state(ref, port)
    dead = [3, 7, 11]
    both(pair, "delete", dead)
    both(pair, "insert", np.array([401, 402]),
         np.stack([vecs[3] * 1.001, vecs[7] * 0.999]))
    st = merge_both(ref, port)
    assert st.inserted == 3 and st.deleted == 4 and st.dirty_vertices > 0
    got = search_both(ref, port, vecs[3][None])[0]
    assert 3 not in got and 7 not in got and 401 in got
    for adj in port.adjacency:
        assert not (set(adj.tolist()) & set(dead + [target]))
    snap = port.handle.current()
    assert snap.version == 1 and not snap.mem_rows
    assert int(snap.device.pq_codes.shape[0]) == len(port.adjacency)
    # GC: delete most of one segment's rows, merge, live data still served
    phys0 = port.vector_store.physical_bytes
    victims = list(range(150, 250))
    both(pair, "delete", victims)
    merge_both(ref, port)
    assert port.vector_store.physical_bytes < phys0
    assert port.vector_store.physical_bytes == ref.vector_store.physical_bytes
    got = search_both(ref, port, vecs[[120, 300]], k=5)
    assert not np.isin(got, victims).any()


def test_merge_id_reuse_guard():
    vecs = make_vector_dataset("prop-like", n=150, dim=12,
                               seed=2).astype(np.float32)
    ref, port = streaming_pair(vecs)
    for x in (ref, port):
        x.insert_buffer[17] = vecs[17]
        with pytest.raises(ValueError, match="id reuse"):
            x.merge()


def test_delete_of_buffered_insert_not_resurrected_by_merge():
    vecs = make_vector_dataset("prop-like", n=300, dim=12,
                               seed=6).astype(np.float32)
    ref, port = streaming_pair(vecs, seg_cap=512)
    v = vecs[42] * 1.0003
    both((ref, port), "insert", np.array([300]), v[None])
    both((ref, port), "delete", [300])
    assert 300 not in search_both(ref, port, v[None], k=5)[0]
    merge_both(ref, port)
    assert len(port.adjacency) == 300
    assert 300 not in search_both(ref, port, v[None], k=5)[0]
    assert not bool(port.vector_store.contains([300])[0])
    for adj in port.adjacency:
        assert 300 not in set(adj.tolist())


def _small_delta(pair, vecs, base_n):
    both(pair, "delete", [5, 9])
    both(pair, "insert", np.array([base_n, base_n + 1]),
         np.stack([vecs[5] * 1.001, vecs[9] * 0.999]))


@pytest.mark.parametrize("force_full", [False, True])
def test_incremental_and_full_merges_match_reference(force_full):
    """tests/test_updates.py's incremental-vs-full pair: the same delta
    through rewrite_blocks or a forced rebuild, on both tiers; the store's
    lists decode to the graph and the write I/O is block-granular."""
    vecs = make_vector_dataset("prop-like", n=300, dim=12,
                               seed=4).astype(np.float32)
    ref, port = streaming_pair(vecs)
    _small_delta((ref, port), vecs, 300)
    st = merge_both(ref, port, force_full=force_full)
    assert st.full_rebuild == force_full
    store = port.handle.current().index_store
    jstore = ref.handle.current().index_store
    vals, cnt = store.decode_batch(np.arange(len(port.adjacency)))
    for vid, adj in enumerate(port.adjacency):
        np.testing.assert_array_equal(vals[vid, :int(cnt[vid])].numpy(),
                                      np.sort(adj))
    np.testing.assert_array_equal(store.data.numpy(), jstore.data)
    if force_full:
        assert st.write_bytes == store.physical_bytes
    else:
        assert st.write_bytes == (st.blocks_rewritten
                                  + st.blocks_appended) * 4096
        assert store.io.write_bytes == st.write_bytes
    assert st.modeled_cost_us > 0
    search_both(ref, port, vecs[[5, 9, 40]])


@pytest.mark.parametrize("case", ["fill", "universe", "reorder",
                                  "small_segments"])
def test_merge_paths_match_reference(case):
    """Two insert/delete/merge cycles under each store setting: block
    headroom (in-place rewrites), no EF-universe headroom (fresh ids past
    the universe force the rebuild fallback and a new device view), a
    seal-time ordering (inserts force the rebuild path) and small vector
    segments (the active segment seals mid-insert, GC reclaims)."""
    kw = dict(fill=dict(fill_factor=0.85),
              universe=dict(universe_headroom=1.0),
              reorder=dict(reorder="bfs"),
              small_segments=dict(gc_threshold=0.1))[case]
    seg_cap = 64 if case == "small_segments" else 256
    vecs = make_vector_dataset("prop-like", n=260, dim=16,
                               seed=8).astype(np.float32)
    ref, port = streaming_pair(vecs, seg_cap=seg_cap, **kw)
    rng = np.random.default_rng(3)
    next_id = 260
    full = []
    for cycle in range(2):
        live = [i for i, a in enumerate(port.adjacency) if len(a)]
        dead = rng.choice(live, size=12, replace=False).tolist()
        both((ref, port), "delete", dead)
        fresh = np.arange(next_id, next_id + 10)
        next_id += 10
        both((ref, port), "insert", fresh,
             vecs[rng.choice(260, 10)] * 1.0007)
        full.append(merge_both(ref, port).full_rebuild)
        got = search_both(ref, port, vecs[rng.choice(260, 6)], k=5)
        assert not np.isin(got, dead).any()
    if case in ("reorder", "universe"):
        assert all(full)
    if case == "fill":
        assert not any(full)


def test_live_recall_matches_python_path_golden():
    """tests/test_updates.py's replacement schedule (workload seed 7, query
    seed 3) on both tiers: the same ids after each cycle, and recall@10 at
    the golden 1.0 of the pre-refactor Python path."""
    n, dim = 400, 16
    vecs = make_vector_dataset("prop-like", n, dim, seed=1).astype(np.float32)
    ref, port = streaming_pair(vecs, m=8)
    live = {i: vecs[i] for i in range(n)}
    wl = StreamingVectorWorkload(vecs, replace_frac=0.4, iterations=2)
    rng = np.random.default_rng(3)
    recalls = []
    for cyc in wl.cycles():
        both((ref, port), "delete", cyc["delete"])
        for d in cyc["delete"]:
            live.pop(int(d))
        both((ref, port), "insert", cyc["insert_ids"], cyc["insert_vecs"])
        for i, v in zip(cyc["insert_ids"], cyc["insert_vecs"]):
            live[int(i)] = v
        merge_both(ref, port)
        lids = np.asarray(sorted(live))
        mat = np.stack([live[i] for i in lids])
        qsel = rng.choice(len(lids), size=16, replace=False)
        universe = port.handle.current().index_store.universe
        kw = dict(l_size=192, beam_width=8, k=10, r_max=16,
                  max_rerank_batches=32, benefit_threshold=0.0,
                  universe=universe, filter_tombstones=True)
        want = jsnapshot_search(ref.handle.current(), mat[qsel],
                                JSearchParams(**kw))
        ids, d = snapshot_search(port.handle.current(), mat[qsel],
                                 SearchParams(**kw), device="cpu")
        assert_same_results(want, (ids, d))
        for j, qi in enumerate(qsel):
            gt = lids[np.argsort(((mat - mat[qi][None]) ** 2).sum(-1),
                                 kind="stable")[:10]]
            recalls.append(len(set(ids[j].tolist()) & set(gt.tolist())) / 10)
    assert float(np.mean(recalls)) >= 1.0


@pytest.mark.parametrize("bits", [0, 10], ids=["dense", "hashed"])
def test_live_snapshot_visited_sets_match_reference(bits):
    """A live snapshot with a tombstone and a memtable row in play: with
    the dense and the hashed visited set the port's fused hop gives the
    reference's ids (the reference runs its unfused hop)."""
    vecs = make_vector_dataset("prop-like", n=200, dim=16,
                               seed=9).astype(np.float32)
    ref, port = streaming_pair(vecs)
    both((ref, port), "delete", [42])
    both((ref, port), "insert", np.array([240]), (vecs[50] * 1.0005)[None])
    queries = np.stack([vecs[50], vecs[42], vecs[7] + 0.002])
    universe = port.handle.current().index_store.universe
    kw = dict(l_size=32, k=5, r_max=16, universe=universe,
              benefit_threshold=0.0, filter_tombstones=True,
              visited_hash_bits=bits)
    want = jsnapshot_search(ref.handle.current(), queries,
                            JSearchParams(**kw))
    got = snapshot_search(port.handle.current(), queries,
                          SearchParams(**kw), device="cpu")
    assert_same_results(want, got, rtol=1e-5)
    assert 42 not in set(got[0].reshape(-1).tolist())
    assert 240 in set(got[0][0].tolist())


def _repair_oracle(adjacency, dead, vecs, r, alpha):
    """FreshDiskANN's delete repair over ``adjacency``: every vertex whose
    list touches ``dead`` -> its surviving neighbours plus its deleted
    neighbours' neighbours, pruned by ``robust_prune`` over ``vecs``."""
    out = {}
    for p, nbrs in enumerate(adjacency):
        hit = [v for v in nbrs if v in dead]
        if p in dead or not hit:
            continue
        pulled = {w for d in hit for w in adjacency[d]
                  if w not in dead and w != p}
        cand = np.asarray(sorted({v for v in nbrs if v not in dead}
                                 | pulled), np.int64)
        if len(cand) > r:
            vmat = np.stack([vecs[c] for c in cand] + [vecs[p]])
            cand = cand[jrobust_prune(len(cand), np.arange(len(cand)), vmat,
                                      alpha, r)]
        out[p] = cand
    return out


def test_delete_repair_on_a_uint8_store_prunes_by_true_distance():
    """The deployment's store holds uint8 records. The merge's delete
    repair prunes with true L2 distances there: every repaired list equals
    the repair recomputed over float64 rows, and that list differs from a
    prune over raw uint8 rows (whose differences wrap mod 256) for some
    vertex, so the test sees that fault. alpha is 1.25, exact in binary:
    alpha x distance is then exact in float32 as in float64 (at 1.2 the
    two round apart at ties, which is not the fault under test)."""
    n, dim, r, alpha = 400, 16, 16, 1.25
    vecs = make_vector_dataset("sift-like", n=n, dim=dim, seed=5)
    assert vecs.dtype == np.uint8
    graph = jbuild_vamana(vecs.astype(np.float32), r=r, l_build=32, seed=0)
    cb = jtrain_pq(vecs.astype(np.float32), m=4, seed=0)
    vs = DecoupledVectorStore(StoreConfig(dim=dim, dtype=np.uint8,
                                          segment_capacity=256,
                                          chunk_bytes=4096, device="cpu"))
    vs.append(np.arange(n), vecs)
    vs.seal_active()
    idx = StreamingIndex(graph.adjacency, graph.medoid, vs,
                         jencode_pq(vecs.astype(np.float32), cb),
                         PQCodebook(cb.centroids, cb.dim),
                         UpdateConfig(r=r, alpha=alpha, l_build=32,
                                      merge_threshold=10**9, device="cpu"))
    before = [a.copy() for a in idx.adjacency]
    dead = set(np.random.default_rng(0).choice(n, 24, replace=False)
               .tolist())
    idx.delete(sorted(dead))
    st = idx.merge()
    want = _repair_oracle(before, dead, vecs.astype(np.float64), r, alpha)
    wrapped = _repair_oracle(before, dead, vecs, r, alpha)
    assert st.deleted == len(dead) and len(want) > 0
    for p, cand in want.items():
        np.testing.assert_array_equal(idx.adjacency[p], cand, err_msg=str(p))
    assert any(not np.array_equal(want[p], wrapped[p]) for p in want)
    for d in dead:
        assert len(idx.adjacency[d]) == 0
