"""Port parity tier for the §3.5 consistency model
(``repro_torch.core.update.consistency``): the seven cases of
tests/test_snapshot.py — publish monotonicity, immediate tombstone and
memtable visibility, in-flight isolation under a threaded publisher, and
hot swap between served batches — each run on the reference and on the
port; and the device view and the memtable side-scan against the
reference's on the same inputs.

The two hot-swap cases of the reference drive ``serve/admission.py``;
here the same schedule (batches of 4, a publish landing between two cuts)
is driven through ``BatchedSearcher`` directly, and
tests/test_torch_admission.py runs both cases through the port's queue.
"""
import threading
import zlib

import numpy as np
import pytest
import torch

from repro.core.search import beam as jbeam
from repro.core.update import consistency as jcons
from repro.data.synthetic import make_vector_dataset
from repro.serve import ann as jann

from repro_torch.core.search import beam as tbeam
from repro_torch.core.update import consistency as tcons
from repro_torch.serve import ann

from conftest import random_graph
from torch_parity import (assert_same_report, assert_same_results,
                          streaming_pair)

PACKAGES = {"reference": jcons, "port": tcons}


def seeded_cases(name, n, **bounds):
    """The reference file's deterministic fallback draws for ``name``."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    return [tuple(int(rng.integers(lo, hi + 1)) for lo, hi in bounds.values())
            for _ in range(n)]


def _snap(mod, version, payload=None):
    return mod.Snapshot(version=version, index_store=payload,
                        vector_store=None, pq_codes=version)


# ------------------------------------------------------ handle semantics
@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_publish_must_increase_version(pkg):
    mod = PACKAGES[pkg]
    h = mod.SnapshotHandle(_snap(mod, 0))
    h.publish(_snap(mod, 1))
    with pytest.raises(ValueError):
        h.publish(_snap(mod, 1))
    with pytest.raises(ValueError):
        h.publish(_snap(mod, 0))
    h.publish(_snap(mod, 5))
    assert h.current().version == 5


@pytest.mark.parametrize("versions", [c[0] for c in seeded_cases(
    "test_publish_version_monotone_over_any_sequence", 8,
    versions=(2, 12))])
def test_publish_version_monotone_over_any_sequence(versions):
    seen = {}
    for pkg, mod in PACKAGES.items():
        h = mod.SnapshotHandle(_snap(mod, 0))
        seen[pkg] = [0]
        for v in range(1, versions + 1):
            h.publish(_snap(mod, v))
            seen[pkg].append(h.current().version)
        assert seen[pkg] == sorted(seen[pkg])
    assert seen["port"] == seen["reference"]


def test_tombstones_and_mem_rows_visible_before_any_publish():
    for mod in PACKAGES.values():
        h = mod.SnapshotHandle(_snap(mod, 3))
        h.with_tombstones([7, 9])
        assert h.current().version == 3
        assert h.current().tombstones == frozenset({7, 9})
        h.with_tombstones([9, 11])
        assert h.current().tombstones == frozenset({7, 9, 11})
        h.with_mem_rows({100: "a"})
        h.with_mem_rows({101: "b"})
        assert h.current().version == 3
        assert set(h.current().mem_rows) == {100, 101}


@pytest.mark.parametrize("n_publishes", [c[0] for c in seeded_cases(
    "test_inflight_snapshot_isolation_threaded", 8, n_publishes=(4, 32))])
@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_inflight_snapshot_isolation_threaded(pkg, n_publishes):
    """A reader that pinned a snapshot keeps a self-consistent view while a
    publisher thread races ahead: no torn snapshot, the pinned one never
    mutates."""
    mod = PACKAGES[pkg]
    h = mod.SnapshotHandle(_snap(mod, 0, payload=0))
    stop = threading.Event()
    errors = []

    def publisher():
        for v in range(1, n_publishes + 1):
            h.publish(_snap(mod, v, payload=v * 10))
        stop.set()

    def reader():
        pinned = h.current()
        before = (pinned.version, pinned.index_store)
        while not stop.is_set():
            snap = h.current()
            if snap.version > 0 and snap.index_store != snap.version * 10:
                errors.append(("torn", snap.version))
            if snap.version > 0 and snap.pq_codes != snap.version:
                errors.append(("mixed", snap.version))
        if (pinned.version, pinned.index_store) != before:
            errors.append(("pinned-mutated",))

    readers = [threading.Thread(target=reader) for _ in range(3)]
    pub = threading.Thread(target=publisher)
    for t in readers:
        t.start()
    pub.start()
    pub.join(timeout=60.0)
    for t in readers:
        t.join(timeout=60.0)
    assert not pub.is_alive() and not any(t.is_alive() for t in readers)
    assert not errors, errors
    assert h.current().version == n_publishes


# ------------------------------------------------------------ device view
def view_inputs(n=120, r=12, dim=8, seed=0):
    adj, rng = random_graph(n, r, seed=seed)
    adj[5] = np.zeros(0, np.int64)                   # an empty list
    codes = rng.integers(0, 256, (n, 4), dtype=np.uint8)
    cents = rng.normal(size=(4, 256, dim // 4)).astype(np.float32)
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    return adj, codes, cents, vecs


def assert_same_view(jview, tview):
    for f in jview._fields:
        a = np.asarray(getattr(jview, f))
        b = getattr(tview, f).numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        np.testing.assert_array_equal(b, a, err_msg=f)
        assert b.dtype == a.dtype or f in ("medoid", "ef_slots"), f


@pytest.mark.parametrize("r_max,universe", [(12, 120), (12, 1000),
                                            (16, 250)])
def test_build_device_view_matches_reference(r_max, universe):
    """The batched slot coder's view is bit-equal to the reference's
    per-vertex ``encode_slot`` view, built whole and patched from a
    previous view (dirty rows + an appended tail)."""
    adj, codes, cents, vecs = view_inputs()
    fetch = lambda ids: vecs[ids]
    args = (codes, cents, fetch, 8)
    jv = jcons.build_device_view(adj, 3, *args, r_max=r_max,
                                 universe=universe)
    tv = tcons.build_device_view(adj, 3, *args, r_max=r_max,
                                 universe=universe, device="cpu")
    assert_same_view(jv, tv)
    adj2 = [a.copy() for a in adj] + [np.array([0, 7, 119]),
                                      np.zeros(0, np.int64)]
    adj2[9] = np.array([1, 2, 3])
    codes2 = np.concatenate([codes, codes[:2]])
    vecs2 = np.concatenate([vecs, vecs[:2] + 1])
    args2 = (codes2, cents, lambda ids: vecs2[ids], 8)
    jv2 = jcons.build_device_view(adj2, 4, *args2, r_max=r_max,
                                  universe=universe, prev=jv, dirty={9, 500})
    before = [t.clone() for t in tv]
    tv2 = tcons.build_device_view(adj2, 4, *args2, r_max=r_max,
                                  universe=universe, prev=tv, dirty={9, 500},
                                  device="cpu")
    assert_same_view(jv2, tv2)
    for a, b in zip(before, tv):                   # prev left as it was
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_mem,k", [(3, 5), (50, 10), (40, 40)])
def test_memtable_topk_matches_reference(n_mem, k):
    """Every query reads the whole memtable by id (C = n_mem, past 32);
    tombstoned rows are skipped; ids equal, distances within rtol 1e-6."""
    rng = np.random.default_rng(n_mem)
    rows = {1000 + 3 * i: rng.normal(size=16).astype(np.float32)
            for i in range(n_mem)}
    rows[1003] = rows[1000].copy()                 # an exact tie
    dead = frozenset({1006, 1000 + 3 * (n_mem - 1)})
    queries = rng.normal(size=(7, 16)).astype(np.float32)
    queries[0] = rows[1000]
    for mod, kw in ((jcons, {}), (tcons, dict(device="cpu"))):
        snap = mod.Snapshot(version=0, index_store=None, vector_store=None,
                            pq_codes=None, tombstones=dead, mem_rows=rows)
        got = mod.memtable_topk(snap, queries, k, **kw)
        if mod is jcons:
            want = got
    assert_same_results(want, got)
    assert not np.isin(got[0], list(dead)).any()
    empty = tcons.Snapshot(version=0, index_store=None, vector_store=None,
                           pq_codes=None)
    ids, d = tcons.memtable_topk(empty, queries, k, device="cpu")
    assert (ids == -1).all() and np.isinf(d).all()


def test_tombstones_clone_the_mask():
    """A delete publishes a NEW mask: the snapshot a batch pinned before
    it keeps its mask, so the delete is invisible to that batch."""
    adj, codes, cents, vecs = view_inputs()
    view = tcons.build_device_view(adj, 3, codes, cents, lambda i: vecs[i],
                                   8, r_max=12, universe=120, device="cpu")
    h = tcons.SnapshotHandle(tcons.Snapshot(
        version=0, index_store=None, vector_store=None, pq_codes=None,
        device=view))
    pinned = h.current()
    h.with_tombstones([4, 7, 500])
    assert not bool(pinned.device.tombstone.any())
    now = h.current().device.tombstone
    assert now.nonzero().reshape(-1).tolist() == [4, 7]
    assert h.current().tombstones == frozenset({4, 7, 500})


# ------------------------------------------------------------- hot swap
LIVE_P = dict(l_size=32, k=5, rerank_batch=5, max_iters=64,
              benefit_threshold=0.0)


def _live(seed):
    vecs = make_vector_dataset("prop-like", n=250, dim=16,
                               seed=seed).astype(np.float32)
    ref, port = streaming_pair(vecs, r=12, m=4)
    return vecs, ref, port


def _searchers(ref, port, buckets=(1, 4)):
    return (jann.BatchedSearcher(ref.handle, jbeam.SearchParams(**LIVE_P),
                                 jann.ServeConfig(buckets=buckets)),
            ann.BatchedSearcher(port.handle, tbeam.SearchParams(**LIVE_P),
                                ann.ServeConfig(buckets=buckets),
                                device="cpu"))


def test_publish_mid_queue_single_version_per_batch():
    """Batches of 4 of 16 queries; after batch 1 a merge publishes. Per-
    batch versions are monotone with exactly one swap, both tiers serve the
    same ids and reports, and each row equals a solo search on the
    archived snapshot of the version its batch pinned."""
    vecs, ref, port = _live(3)
    js, ts = _searchers(ref, port)
    queries = vecs[:16] + 0.001
    archived = {0: port.handle.current()}
    versions, served = [], []
    for b in range(4):
        q = queries[4 * b:4 * b + 4]
        want, got = js.search(q), ts.search(q)
        assert_same_results(want, got)
        assert_same_report(want[2], got[2])
        versions.append(got[2].snapshot_version)
        served.append((got[2].snapshot_version, q, got))
        if b == 1:
            for x in (ref, port):
                x.insert(np.array([len(vecs) + 1]), (vecs[0] * 1.0001)[None])
                x.merge()
            archived[port.handle.current().version] = port.handle.current()
    assert versions == sorted(versions) and len(set(versions)) == 2
    for version, q, (ids, dists, _) in served:
        solo = ann.BatchedSearcher(tcons.SnapshotHandle(archived[version]),
                                   tbeam.SearchParams(**LIVE_P),
                                   ann.ServeConfig(buckets=(1,)),
                                   device="cpu")
        for qi in range(len(q)):
            i1, d1, _ = solo.search(q[qi][None])
            np.testing.assert_array_equal(ids[qi], i1[0])
            np.testing.assert_array_equal(dists[qi], d1[0])


def test_threaded_publisher_never_splits_a_batch():
    """A publisher THREAD merges while batches are served; a handshake
    lands one publish after batch 0 and one after batch 2. Every batch
    pins one version, versions are monotone with both publishes landed, and
    the port serves what the reference serves on the same schedule."""
    vecs, ref, port = _live(5)
    js, ts = _searchers(ref, port)
    queries = vecs[:16] + 0.001
    go, done = threading.Event(), threading.Event()
    finished = threading.Event()
    failures = []

    def publisher():
        k = 0
        while go.wait(timeout=30.0):
            go.clear()
            if done.is_set():
                return
            try:
                nid = len(vecs) + 50 + k
                k += 1
                for x in (ref, port):
                    x.insert(np.array([nid]), (vecs[k] * 1.0003)[None])
                    x.merge()
            except Exception as e:        # surfaced in the main thread
                failures.append(e)
            finished.set()

    t = threading.Thread(target=publisher)
    t.start()
    versions = []
    try:
        for b in range(4):
            q = queries[4 * b:4 * b + 4]
            want, got = js.search(q), ts.search(q)
            assert_same_results(want, got)
            assert_same_report(want[2], got[2])
            versions.append(got[2].snapshot_version)
            if b in (0, 2):
                finished.clear()
                go.set()
                assert finished.wait(timeout=30.0), "publisher stalled"
    finally:
        done.set()
        go.set()
        t.join(timeout=30.0)
    assert not t.is_alive()
    assert not failures, failures
    assert versions == sorted(versions) and len(set(versions)) == 3
