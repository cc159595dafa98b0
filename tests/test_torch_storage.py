"""Port parity tier for the §3.3 storage path: the block layout (numpy
copy and ``pack_blocks_torch``), the block-store accounting engine, the
decoupled vector store (seal, load through the ``huffman_decode`` op, stale
marks, GC), the Elias-Fano block index store, the raw and co-located
baselines, and the slice as a whole on a quickstart-sized world, each
against ``repro`` on the same seeded inputs. Everything runs on the CPU,
where ``huffman_decode`` is its plain PyTorch version.

Bytes, I/O counters, cache and prefetch statistics must be identical.
The only tolerance is the search distances' rtol 1e-6 of
tests/test_torch_search.py (XLA reorders the reference's sums in ``jit``).
"""
import numpy as np
import pytest
import torch

from repro.core.index import build_device_index
from repro.core.search import beam as jbeam
from repro.core.storage import blockstore as jbs
from repro.core.storage import layout as jlayout
from repro.core.storage.colocated import ColocatedStore as JColocated
from repro.core.storage.index_store import CompressedIndexStore as JIndex
from repro.core.storage.index_store import RawIndexStore as JRaw
from repro.core.storage.vector_store import DecoupledVectorStore as JVS
from repro.core.storage.vector_store import StoreConfig as JConfig
from repro.data.synthetic import make_queries, make_vector_dataset
from repro.kernels.dispatch import KernelConfig as JKernelConfig

from repro_torch.core.index import device_index_from_numpy
from repro_torch.core.search.beam import SearchParams, search
from repro_torch.core.storage import blockstore as bs
from repro_torch.core.storage import layout
from repro_torch.core.storage.colocated import ColocatedStore
from repro_torch.core.storage.index_store import (CompressedIndexStore,
                                                  RawIndexStore)
from repro_torch.core.storage.vector_store import (DecoupledVectorStore,
                                                   StoreConfig)
from repro_torch.kernels import dispatch

from conftest import random_graph

T = torch.from_numpy


def arr(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_packing(a, b):
    """A reference PackedBlocks (numpy) against a port one (either)."""
    assert a.n_blocks == b.n_blocks
    for f in ("data", "rec_block", "rec_start", "rec_len", "block_first_id",
              "run_first_id", "run_block"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, arr(y), err_msg=f)
            assert x.dtype == arr(y).dtype, f
    assert a.physical_bytes == b.physical_bytes


def records(m, max_len, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len, size=m)
    recs = [rng.integers(0, 256, size=n, dtype=np.uint8) for n in lens]
    ids = np.sort(rng.choice(10**6, size=m, replace=False))
    return ids, recs


# ------------------------------------------------------------------ layout
def test_closed_forms_match_reference():
    for v in (100, 128, 512):
        for c in (4096, 64 << 10, 4 << 20):
            assert layout.beta_for_chunk(c, v) == jlayout.beta_for_chunk(c, v)
            assert layout.chunk_metadata_bytes(c, v) == \
                jlayout.chunk_metadata_bytes(c, v)
        for beta in (0.002, 0.01, 0.2):
            assert layout.chunk_size_for_beta(beta, v) == \
                jlayout.chunk_size_for_beta(beta, v)
    with pytest.raises(ValueError):
        layout.chunk_size_for_beta(0.0001, 128)
    assert layout.block_bytes_needed(7, 300, True) == \
        jlayout.block_bytes_needed(7, 300, True)


@pytest.mark.parametrize("fill", [1.0, 0.7, 0.3, 0.01])
@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("m,max_len,seed", [(1, 5, 0), (400, 900, 1),
                                            (300, 40, 2)])
def test_pack_blocks_match_reference(m, max_len, seed, implicit, fill):
    ids, recs = records(m, max_len, seed)
    if implicit:
        ids = np.arange(m)
    want = jlayout.pack_blocks(ids, recs, implicit_ids=implicit,
                               fill_factor=fill)
    assert_same_packing(want, layout.pack_blocks(
        ids, recs, implicit_ids=implicit, fill_factor=fill))
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in recs])])
    got = layout.pack_blocks_torch(
        T(ids), T(np.diff(offsets)), implicit, fill,
        payload=T(np.concatenate(recs)), offsets=T(offsets))
    assert_same_packing(want, got)
    for i in (0, m // 2, m - 1):
        assert layout.locate_block(arr(got.block_first_id), int(ids[i])) \
            == int(got.rec_block[i])


@pytest.mark.parametrize("rows_per_chunk", [1, 7, 64, 1000])
def test_pack_blocks_torch_breaks_equal_per_chunk_packings(rows_per_chunk):
    """Blocks forced to start at each chunk: the image of the reference's
    per-chunk packings, concatenated."""
    ids, recs = records(300, 200, 3)
    packs = [jlayout.pack_blocks(ids[lo:lo + rows_per_chunk],
                                 recs[lo:lo + rows_per_chunk])
             for lo in range(0, 300, rows_per_chunk)]
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in recs])])
    got = layout.pack_blocks_torch(
        T(ids), T(np.diff(offsets)), breaks=torch.arange(0, 300, rows_per_chunk),
        payload=T(np.concatenate(recs)), offsets=T(offsets))
    np.testing.assert_array_equal(arr(got.data),
                                  np.concatenate([p.data for p in packs]))
    np.testing.assert_array_equal(arr(got.block_first_id), np.concatenate(
        [p.block_first_id for p in packs]))


def test_pack_blocks_torch_fill_and_oversize_rules():
    recs = [np.full(100, 7, np.uint8) for _ in range(200)]
    lens = torch.full((200,), 100)
    tight = layout.pack_blocks_torch(torch.arange(200), lens, True)
    slack = layout.pack_blocks_torch(torch.arange(200), lens, True, 0.5)
    assert slack.n_blocks > tight.n_blocks
    assert slack.n_blocks == jlayout.pack_blocks(
        np.arange(200), recs, implicit_ids=True, fill_factor=0.5).n_blocks
    big = layout.pack_blocks_torch(torch.arange(1), torch.tensor([3000]),
                                   True, 0.5)
    assert big.n_blocks == 1           # an empty block admits its record
    with pytest.raises(ValueError):
        layout.pack_blocks_torch(torch.arange(1), torch.tensor([4]),
                                 fill_factor=0.0)
    with pytest.raises(ValueError, match="larger than a block"):
        layout.pack_blocks_torch(torch.arange(1), torch.tensor([4095]))


def test_coresident_packing_and_runs_match_reference():
    ids, recs = records(200, 300, 4)
    adj, _ = random_graph(200, 8, seed=4)
    want = jlayout.pack_blocks_coresident(ids, recs, adj, fill_factor=0.8)
    got = layout.pack_blocks_coresident(ids, recs, adj, fill_factor=0.8)
    assert_same_packing(want, got)
    for vid in ids[:20]:
        assert layout.locate_block_runs(got.run_first_id, got.run_block,
                                        vid) == jlayout.locate_block_runs(
            want.run_first_id, want.run_block, vid)
    for a, b in zip(layout.id_runs(ids, got.rec_block),
                    jlayout.id_runs(ids, want.rec_block)):
        np.testing.assert_array_equal(a, b)


def test_manifest_round_trip_matches_reference(tmp_path):
    plan = dict(component="adjacency", codec="elias_fano", raw_bytes=100,
                est_bytes=40, candidates={"raw": 100, "elias_fano": 40},
                params={"universe": 10})
    m = layout.StorageManifest({"adjacency": layout.ComponentPlan(**plan)},
                               reorder="bfs")
    j = jlayout.StorageManifest({"adjacency": jlayout.ComponentPlan(**plan)},
                                reorder="bfs")
    assert m.to_json() == j.to_json() and m.total_ratio == j.total_ratio
    m.save(tmp_path / "m.json")
    assert jlayout.StorageManifest.load(tmp_path / "m.json").to_json() == \
        j.to_json()


# -------------------------------------------------------------- block store
@pytest.mark.parametrize("shared,floor", [(False, 0), (True, 0),
                                          (True, 3 * 64)])
def test_block_store_event_sequences_match_reference(shared, floor):
    """The same seeded sequence of reads, writes and cache traffic through
    both engines: identical stats after every step."""
    rng = np.random.default_rng(7)
    engines = [m.BlockStore(cache_bytes=10 * 64, shared_budget=shared)
               for m in (jbs, bs)]
    parts = []
    for e in engines:
        parts.append([e.register_cache("adjacency", 64, floor_bytes=floor),
                      e.register_cache("vector_chunks", 64),
                      e.register_tenant_cache("t", 64)])
    for step in range(300):
        op = int(rng.integers(0, 6))
        key = int(rng.integers(0, 40))
        p = int(rng.integers(0, 3))
        outs = []
        for e, ps in zip(engines, parts):
            if op == 0:
                e.read("adjacency", 4096, n=1)
            elif op == 1:
                e.write("vector_chunks", 8192, n=2)
            elif op == 2:
                outs.append(ps[p].get(key))
            elif op == 3:
                ps[p].put(key, key)
            elif op == 4:
                outs.append(ps[p].invalidate([key, key + 1]))
            else:
                outs.append(ps[p].peek(key))
        assert outs[:1] == outs[1:], step
        assert engines[0].stats() == engines[1].stats(), step


def test_lru_cache_clone_and_invalidate_match_reference():
    caches = [m.LRUCache(capacity=4, entry_bytes=10) for m in (jbs, bs)]
    for c in caches:
        for k in (1, 2, 3, 4):
            c.put(k, k * 10)
        c.get(1)
    clones = [c.clone() for c in caches]
    for c in clones:
        assert c.invalidate([2, 99]) == 1
        c.put(5, 50)
        c.put(6, 60)
        c.note_prefetch_hit()
    assert list(clones[0]._d) == list(clones[1]._d)
    for a, b in (caches, clones):
        assert (a.hits, a.misses, a.prefetch_hits, a.lookups,
                a.memory_bytes) == (b.hits, b.misses, b.prefetch_hits,
                                    b.lookups, b.memory_bytes)


@pytest.mark.parametrize("depth,budget", [(1, 1), (4, 6), (8, 32)])
def test_prefetch_queue_event_sequences_match_reference(depth, budget):
    rng = np.random.default_rng(depth * 10 + budget)
    qs = [m.PrefetchQueue(depth, budget) for m in (jbs, bs)]
    for step in range(400):
        op, key = int(rng.integers(0, 4)), int(rng.integers(0, 12))
        outs = []
        for q in qs:
            if op == 0:
                outs.append(q.offer(key))
            elif op == 1:
                outs.append(q.fill(key))
            elif op == 2:
                outs.append(q.take(key))
            else:
                outs.append(q.drain() if step % 5 == 0 else q.outstanding)
        assert outs[0] == outs[1], step
        assert qs[0].snapshot() == qs[1].snapshot(), step
    with pytest.raises(ValueError):
        bs.PrefetchQueue(0, 1)


def test_shared_budget_floors_match_reference():
    for m in (jbs, bs):
        e = m.BlockStore(cache_bytes=8 * 64, shared_budget=True)
        e.register_tenant_cache("a", 64, floor_bytes=5 * 64)
        with pytest.raises(ValueError, match="over-commit"):
            e.register_tenant_cache("b", 64, floor_bytes=4 * 64)
    budgets = [m.SharedBudget(capacity_bytes=10 * 16) for m in (jbs, bs)]
    for b, m in zip(budgets, (jbs, bs)):
        c = m.LRUCache(capacity=4, entry_bytes=16, budget=b,
                       floor_bytes=2 * 16)
        c.put(1, "x")
        c.clone()
    assert budgets[0].floor_bytes == budgets[1].floor_bytes == 64


# ------------------------------------------------------------ vector store
def assert_same_vector_store(a, b):
    assert sorted(a.sealed) == sorted(b.sealed)
    for sid in a.sealed:
        x, y = a.sealed[sid], b.sealed[sid]
        np.testing.assert_array_equal(x.ids, arr(y.ids))
        assert_same_packing(x.packed, y.packed)
        assert len(x.chunks) == len(y.chunks)
        for c, d in zip(x.chunks, y.chunks):
            assert (c.first_block, c.n_blocks, c.n_runs, c.meta_bytes) == \
                (d.first_block, d.n_blocks, d.n_runs, d.meta_bytes)
            np.testing.assert_array_equal(c.boundary_ids, arr(d.boundary_ids))
            assert (c.base is None) == (d.base is None)
            if c.base is not None:
                np.testing.assert_array_equal(c.base, arr(d.base))
        np.testing.assert_array_equal(x.stale, arr(y.stale))
        assert x.metadata_bytes == y.metadata_bytes
        assert x.garbage_ratio == y.garbage_ratio
    assert (a.logical_bytes, a.physical_bytes, a.metadata_bytes,
            a.beta_actual(), a.compress_count) == \
        (b.logical_bytes, b.physical_bytes, b.metadata_bytes,
         b.beta_actual(), b.compress_count)
    assert a.io.snapshot() == b.io.snapshot()
    assert a.blocks.stats() == b.blocks.stats()


def vector_stores(x, **kw):
    kw = dict(dim=x.shape[1], dtype=x.dtype, **kw)
    return JVS(JConfig(**kw)), DecoupledVectorStore(
        StoreConfig(device="cpu", **kw))


VS_CASES = [(kind, codec, co)
            for kind, dtype in (("sift-like", "u8"), ("prop-like", "f32"),
                                ("spacev-like", "i8"))
            for codec in ("auto", "huffman", "xor_delta_huffman",
                          "plane_huffman", "raw")
            if codec != "plane_huffman" or dtype == "f32"
            for co in (False, True)]


@pytest.mark.parametrize("kind,codec,coresident", VS_CASES)
def test_vector_store_matches_reference(kind, codec, coresident):
    """Appends across segment boundaries, the seal's block images and chunk
    metadata, reads with and without accounting, stale marks (sealed and
    mutable rows) and GC (which reloads through ``huffman_decode``)."""
    dim = {"sift-like": 32, "prop-like": 16, "spacev-like": 25}[kind]
    x = make_vector_dataset(kind, 1200, dim, seed=1)
    a, b = vector_stores(x, segment_capacity=500, chunk_bytes=2048,
                         vector_codec=codec, coresident=coresident)
    if coresident:
        adj, _ = random_graph(1200, 8, seed=2)
        a.set_affinity(adj)
        b.set_affinity(adj)
    for lo, hi in ((0, 700), (700, 1100), (1100, 1200)):
        a.append(np.arange(lo, hi), x[lo:hi])
        b.append(np.arange(lo, hi), x[lo:hi])
    assert_same_vector_store(a, b)
    ids = np.array([0, 5, 499, 500, 1050, 1199, 1150, 3])   # 1150+: mutable
    np.testing.assert_array_equal(arr(b.get(ids)), a.get(ids))
    np.testing.assert_array_equal(arr(b.get(ids, account=False)),
                                  a.get(ids, account=False))
    for s in (a, b):
        s.mark_stale(np.arange(0, 450))
        s.mark_stale(np.array([1190, 1191, 777777]))
    assert_same_vector_store(a, b)
    assert a.gc(0.3) == b.gc(0.3)
    for s in (a, b):
        s.seal_active()
    assert_same_vector_store(a, b)
    live = np.concatenate([np.arange(450, 1190), [1192, 1199]])
    np.testing.assert_array_equal(arr(b.get(live)), a.get(live))
    np.testing.assert_array_equal(arr(b.get(live[::-7], account=False)),
                                  x[live[::-7]])
    assert_same_vector_store(a, b)
    for dead in (0, 449, 1190):
        with pytest.raises(KeyError):
            b.get(np.array([dead]))


def prop_like_world():
    x = make_vector_dataset("prop-like", 4096, 128, seed=0)
    return (x,) + vector_stores(x, segment_capacity=4096,
                                chunk_bytes=2048 * 512)


def spy_huffman_decode(monkeypatch) -> list:
    """Record the ``base_of`` of every call of the plain ``huffman_decode``
    (the op of the load path on the CPU)."""
    calls = []
    ref = dispatch.get_impl("huffman_decode", "ref")

    def spy(payload, starts, v, table, bases, base_of):
        calls.append(arr(base_of))
        return ref(payload, starts, v, table, bases, base_of)
    monkeypatch.setitem(dispatch._registry(), ("huffman_decode", "ref"), spy)
    return calls


def test_prop_like_load_runs_byteplane(monkeypatch):
    """A prop-like world where the reference's §3.3 test chose XOR-delta
    in one chunk of two: the port seals the same bytes, and each load of
    the segment is one ``huffman_decode`` call (the op that carries the
    byteplane XOR on loads) whose ``base_of`` marks exactly the rows of
    the chunk with a base."""
    x, a, b = prop_like_world()
    for s in (a, b):
        s.append(np.arange(len(x)), x)
        s.seal_active()
    bases = [c.base is not None for c in a.sealed[0].chunks]
    assert bases == [True, False]
    assert_same_vector_store(a, b)
    calls = spy_huffman_decode(monkeypatch)
    got = b.get(np.arange(len(x)), account=False)
    np.testing.assert_array_equal(arr(got), x)
    assert len(calls) == 1
    np.testing.assert_array_equal(
        calls[0], np.where(np.arange(len(x)) < 2048, 0, -1))
    rows = np.array([4000, 3, 2047, 2048, 17])        # unsorted, both chunks
    np.testing.assert_array_equal(arr(b.get(rows)), a.get(rows))
    assert len(calls) == 2
    np.testing.assert_array_equal(calls[1], [-1, 0, 0, -1, 0])
    assert a.io.snapshot() == b.io.snapshot()


def test_gc_reloads_through_byteplane(monkeypatch):
    """GC reads the live rows of its victim back in one ``huffman_decode``
    call; only the live rows of the chunk with a base are XOR-ed."""
    x, a, b = prop_like_world()
    for s in (a, b):
        s.append(np.arange(len(x)), x)
        s.seal_active()
        s.mark_stale(np.arange(0, 2000))
    calls = spy_huffman_decode(monkeypatch)
    assert a.gc(0.3) == b.gc(0.3) == 1
    assert len(calls) == 1                       # rows 2000..4095
    np.testing.assert_array_equal(
        calls[0], np.where(np.arange(2000, 4096) < 2048, 0, -1))
    for s in (a, b):
        s.seal_active()
    assert_same_vector_store(a, b)
    np.testing.assert_array_equal(arr(b.get(np.arange(2000, 4096))),
                                  x[2000:])


@pytest.mark.parametrize("beta", [0.002, 0.01])
def test_vector_store_beta_and_manifest_configs_match_reference(beta):
    from repro.core.codec import registry as jreg
    x = make_vector_dataset("prop-like", 600, 16, seed=3)
    samples = {"vector_chunks": list(x.view(np.uint8).reshape(600, -1))}
    manifest = jreg.plan_components(samples, itemsize=4)
    a, b = vector_stores(x, segment_capacity=300, beta=beta)
    a.cfg, b.cfg = a.cfg.from_manifest(manifest), b.cfg.from_manifest(manifest)
    assert a.cfg.vector_codec == b.cfg.vector_codec
    assert a.cfg.chunk_vectors == b.cfg.chunk_vectors
    for s in (a, b):
        s.append(np.arange(600), x)
    assert_same_vector_store(a, b)


def test_vector_store_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecoupledVectorStore(StoreConfig(dim=4, dtype=np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompressedIndexStore.from_graph([np.arange(3)], 0, 3)


# ------------------------------------------------------------- index store
def assert_same_index(a, b):
    assert (a.n_blocks, a.universe, a.physical_bytes,
            a.sparse_index_bytes) == (b.n_blocks, b.universe,
                                      b.physical_bytes, b.sparse_index_bytes)
    for f in ("data", "sparse_index", "rec_block", "rec_start", "rec_len",
              "run_first_id", "run_block"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, arr(y), err_msg=f)
            assert x.dtype == arr(y).dtype, f


INDEX_CASES = [dict(), dict(fill_factor=0.6), dict(codec="bitpack"),
               dict(codec="delta_varint"), dict(codec="raw"),
               dict(codec="ans_id", order="bfs"), dict(order="bfs"),
               dict(order="bisection"), dict(coresident=True),
               dict(coresident=True, order="minla")]


@pytest.mark.parametrize("kw", INDEX_CASES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_index_store_from_graph_matches_reference(kw):
    adj, _ = random_graph(500, 24, seed=3)
    a = JIndex.from_graph(adj, 0, 24, cache_bytes=1 << 14, **kw)
    b = CompressedIndexStore.from_graph(adj, 0, 24, cache_bytes=1 << 14,
                                        device="cpu", **kw)
    assert_same_index(a, b)
    rng = np.random.default_rng(0)
    for _ in range(4):                    # frontier batches, warm cache
        hop = rng.integers(0, 500, size=16)
        got, want = b.get_neighbors_batch(hop), a.get_neighbors_batch(hop)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    for vid in (0, 7, 499):
        np.testing.assert_array_equal(b.get_neighbors(vid),
                                      a.get_neighbors(vid))
        assert b.locate(vid) == a.locate(vid) == a.block_of(vid)
    assert a.io.snapshot() == b.io.snapshot()
    assert a.blocks.stats() == b.blocks.stats()
    if b.codec == "elias_fano":
        vals, cnt = b.decode_batch(np.arange(500))
        for i in range(500):
            np.testing.assert_array_equal(arr(vals[i, :int(cnt[i])]),
                                          np.sort(adj[i]))


def test_index_store_accepts_a_padded_tensor_graph():
    """A shard's graph comes as one [n, W] tensor padded with -1."""
    adj, _ = random_graph(400, 16, seed=8)
    padded = np.full((400, 16), -1, np.int64)
    for i, a in enumerate(adj):
        padded[i, :len(a)] = np.random.default_rng(i).permutation(a)
    a = JIndex.from_graph(adj, 0, 16)
    b = CompressedIndexStore.from_graph(T(padded).to(torch.int32), 0, 16,
                                        device="cpu")
    assert_same_index(a, b)
    assert RawIndexStore.from_graph(T(padded), 0, 16).physical_bytes == \
        JRaw.from_graph(adj, 0, 16).physical_bytes


@pytest.mark.parametrize("depth,budget", [(2, 4), (8, 32)])
def test_index_store_prefetch_matches_reference(depth, budget):
    adj, _ = random_graph(400, 16, seed=5)
    stores = [JIndex.from_graph(adj, 0, 16, cache_bytes=1 << 12,
                                order="bfs"),
              CompressedIndexStore.from_graph(adj, 0, 16, cache_bytes=1 << 12,
                                              order="bfs", device="cpu")]
    for s in stores:
        s.enable_prefetch(depth, budget)
    rng = np.random.default_rng(depth)
    for step in range(30):
        hint = rng.integers(0, 400, size=12)
        hop = rng.integers(0, 400, size=8)
        outs = [(s.prefetch_hint(hint), sorted(s.get_neighbors_batch(hop)))
                for s in stores]
        assert outs[0] == outs[1], step
        if step % 6 == 5:
            assert stores[0].drain_prefetch() == stores[1].drain_prefetch()
    a, b = stores
    assert a.io.snapshot() == b.io.snapshot()
    assert a.blocks.stats() == b.blocks.stats()


REWRITES = ["dirty", "append", "overflow", "universe", "shrunk", "ordered"]


@pytest.mark.parametrize("case", REWRITES)
def test_index_store_rewrite_blocks_matches_reference(case):
    rng = np.random.default_rng(REWRITES.index(case))
    n, r, universe = 600, 16, 2400
    adj, _ = random_graph(n, r, seed=9)
    kw = dict(universe=universe, fill_factor=0.85, cache_bytes=1 << 14)
    if case == "overflow":
        adj = [np.sort(rng.choice(10**9, size=4, replace=False))
               for _ in range(n)]
        kw = dict(universe=1 << 30, fill_factor=1.0)
    if case == "ordered":
        kw["order"] = "bfs"
    a = JIndex.from_graph(adj, 0, r, **kw)
    b = CompressedIndexStore.from_graph(adj, 0, r, device="cpu", **kw)
    for vid in range(50):
        a.get_neighbors(vid)
        b.get_neighbors(vid)
    adj2 = [x.copy() for x in adj]
    dirty = np.arange(100, 160)
    if case == "overflow":
        dirty = np.flatnonzero(a.rec_block == 0)
    for d in dirty:
        size = 8 if case == "overflow" else int(rng.integers(4, r + 1))
        adj2[int(d)] = np.sort(rng.choice(10**9 if case == "overflow" else n,
                                          size=size, replace=False))
    if case == "append":
        adj2 += [np.sort(rng.choice(n, size=r, replace=False))
                 for _ in range(40)]
        dirty = []
    if case == "universe":
        adj2[0] = np.asarray([1, 2, universe + 5])
    if case == "shrunk":
        adj2 = adj2[:300]
    want = a.rewrite_blocks(adj2, dirty)
    got = b.rewrite_blocks(adj2, dirty)
    assert (want is None) == (got is None)
    if want is None:
        assert case in ("overflow", "universe", "shrunk")
        return
    assert vars(got[1]) == vars(want[1])
    assert_same_index(want[0], got[0])
    assert_same_index(a, b)               # the receivers did not change
    for vid in (8, 120, len(adj2) - 1):
        np.testing.assert_array_equal(got[0].get_neighbors(vid),
                                      want[0].get_neighbors(vid))
    assert a.blocks.stats() == b.blocks.stats()


def test_raw_index_store_matches_reference():
    adj, _ = random_graph(300, 32, seed=6)
    a = JRaw.from_graph(adj, 0, 32, cache_bytes=1 << 12)
    b = RawIndexStore.from_graph(adj, 0, 32, cache_bytes=1 << 12)
    assert (a.record_bytes, a.physical_bytes) == (b.record_bytes,
                                                  b.physical_bytes)
    for vid in (1, 2, 1, 299, 2):
        np.testing.assert_array_equal(b.get_neighbors(vid),
                                      a.get_neighbors(vid))
    assert a.io.snapshot() == b.io.snapshot()
    assert a.blocks.stats() == b.blocks.stats()


@pytest.mark.parametrize("dim,dtype", [(32, np.uint8), (128, np.float32),
                                       (1100, np.float32)])
def test_colocated_store_matches_reference(dim, dtype):
    vecs = make_vector_dataset("sift-like", 400, dim, seed=2).astype(dtype)
    adj, _ = random_graph(400, 16, seed=2)
    a = JColocated.build(vecs, adj, medoid=0, r=16, cache_bytes=1 << 16)
    b = ColocatedStore.build(T(vecs), adj, medoid=0, r=16,
                             cache_bytes=1 << 16)
    assert (a.record_bytes, a.records_per_block, a.n_blocks,
            a.physical_bytes) == (b.record_bytes, b.records_per_block,
                                  b.n_blocks, b.physical_bytes)
    for s in (a, b):
        s.enable_prefetch(4, 8)
    rng = np.random.default_rng(dim)
    for step in range(40):
        ids = rng.integers(0, 400, size=5)
        assert a.prefetch_hint(ids) == b.prefetch_hint(ids)
        vid = int(rng.integers(0, 400))
        (va, na), (vb, nb) = a.get_record(vid), b.get_record(vid)
        np.testing.assert_array_equal(arr(vb), va)
        np.testing.assert_array_equal(nb, na)
    assert a.drain_prefetch() == b.drain_prefetch()
    a.rewrite_all()
    b.rewrite_all()
    assert a.io.snapshot() == b.io.snapshot()
    assert a.blocks.stats() == b.blocks.stats()


# -------------------------------------------------------- the slice whole
@pytest.fixture(scope="module")
def quickstart_world():
    """examples/quickstart.py's build (sift-like uint8, R=24, L=48,
    pq_m=8) cut to n=1200, dim=64, with its stores."""
    n, dim = 1200, 64
    vecs = make_vector_dataset("sift-like", n, dim, seed=0)
    queries = make_queries("sift-like", 32, dim).astype(np.float32)
    index, graph, _ = build_device_index(vecs.astype(np.float32), r=24,
                                         l_build=48, pq_m=8)
    return vecs, queries, index, graph


def test_slice_storage_saving_and_search_match_reference(quickstart_world):
    """The quickstart's storage comparison gives the same bytes and
    saving in both packages; then the port's search over a DeviceIndex
    whose vectors were loaded from the port's store returns the reference
    search's ids."""
    vecs, queries, index, graph = quickstart_world
    n, dim = vecs.shape
    cfg = dict(dim=dim, dtype=vecs.dtype, segment_capacity=512)
    sizes = []
    for Colo, VS, Cfg, Ix, kw in (
            (JColocated, JVS, JConfig, JIndex, {}),
            (ColocatedStore, DecoupledVectorStore, StoreConfig,
             CompressedIndexStore, {"device": "cpu"})):
        colo = Colo.build(vecs, graph.adjacency, graph.medoid, 24)
        vs = VS(Cfg(**cfg, **kw))
        vs.append(np.arange(n), vecs)
        vs.seal_active()
        ix = Ix.from_graph(graph.adjacency, graph.medoid, 24,
                           cache_bytes=1 << 16, **kw)
        total = vs.physical_bytes + ix.physical_bytes
        sizes.append((colo.physical_bytes, vs.physical_bytes,
                      ix.physical_bytes,
                      vs.metadata_bytes + ix.sparse_index_bytes,
                      1 - total / colo.physical_bytes))
    assert sizes[0] == sizes[1]
    assert sizes[1][4] > 0.2               # the decoupled stores save space
    loaded = vs.get(np.arange(n), account=False)
    np.testing.assert_array_equal(arr(loaded), vecs)
    arrays = {k: np.asarray(v) for k, v in index._asdict().items()}
    arrays["vectors"] = arr(loaded).astype(np.float32)
    port_index = device_index_from_numpy(arrays, "cpu")
    base = dict(l_size=48, beam_width=4, k=10, rerank_batch=10, r_max=24,
                universe=n, max_iters=128)
    want = jbeam.search(index, queries, jbeam.SearchParams(
        **base, kernels=JKernelConfig("ref", "ref", "ref", "ref", "off")))
    got = search(port_index, torch.from_numpy(queries), SearchParams(**base),
                 device="cpu")
    np.testing.assert_array_equal(arr(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(arr(got[1]), np.asarray(want[1]), rtol=1e-6)
