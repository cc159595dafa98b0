"""The plain reference against the program on tiny worlds on the CPU, the
control against the reference, and a run that the check calls incorrect
for each fault a cell can have."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from cardbench import bench, program
from cardbench.bench import Bench
from cardbench.frozen import shard
from cardbench.reference import search as ref
from cardbench.world import make_world

PROG = program.load()
SERVE = "sift1b-shard.serve-1024"
RESTORE = ["deep1b-shard.restore", "sift1b-shard.restore"]


def _program_search(cfg, w, q):
    index = shard.device_index(torch, PROG, w.vectors, w.graph, w.centroids,
                               w.medoid, cfg["r"])
    p = shard.search_params(PROG, cfg)._replace(
        max_rerank_batches=cfg["max_rerank_batches"],
        benefit_threshold=cfg["benefit_threshold"])
    return PROG.search(index, q, p, "cpu")


@pytest.mark.parametrize("seed,bits,dtype", [
    (11, 15, "uint8"), (2147483659, 6, "uint8"), (13, 15, "float32"),
    (14, 5, "float32")])
def test_reference_equals_the_program(seed, bits, dtype, tiny_config):
    """Ids, distances and rounds bit for bit, with the visited table at
    the deployment's size and at a size where slots collide."""
    cfg = tiny_config("sift1b-shard", visited_hash_bits=bits, dtype=dtype)
    w = make_world(torch, cfg, seed, "cpu")
    q = torch.from_numpy(w.queries[:96])
    ids, dists, st = _program_search(cfg, w, q)
    got_ids, got_d, rounds = ref.search(w.vectors, w.graph, w.centroids,
                                        w.medoid, q, cfg)
    assert torch.equal(ids.long(), got_ids)
    assert torch.equal(dists.view(torch.int32), got_d.view(torch.int32))
    assert torch.equal(st.iters, rounds)


def test_reference_codes_equal_the_programs(tiny_config):
    cfg = tiny_config("sift1b-shard")
    w = make_world(torch, cfg, 5, "cpu")
    want = PROG.encode_pq_torch(w.vectors, w.centroids)
    codes = ref.Codes(w.vectors, w.centroids)
    ids = torch.arange(w.vectors.shape[0])
    assert torch.equal(codes[ids.flip(0)[::3]], want[ids.flip(0)[::3]])
    assert torch.equal(codes[ids], want)


def _bench(workload, seed, tiny_config):
    cfg = tiny_config(bench.cell_entry(bench.load_spec(),
                                       workload)["config"])
    b = Bench(torch, workload, seed, "cpu", trace=False, cfg=cfg)
    b.setup()
    return b


@pytest.mark.parametrize("workload", [SERVE] + RESTORE)
@pytest.mark.parametrize("seed", [3, 2147483700])
def test_control_is_incorrect_and_the_program_is_not(workload, seed,
                                                     tiny_config):
    b = _bench(workload, seed, tiny_config)
    b.measure(0.2)
    assert _correct(b.cell.check(seed))
    assert not _correct(b.cell.control(seed, torch.bfloat16))


def _correct(checks) -> bool:
    return all(v <= lim for v, lim in bench.shown(checks).values())


def _altered(search):
    """Answers altered where they are produced: each row's nearest id."""
    def broken(*a, **k):
        ids, dists, stats = search(*a, **k)
        ids = ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % 1000
        return ids, dists, stats
    return broken


def _half(search):
    """Half of the batch left out: the second half's rows are the first
    half's answers."""
    def broken(index, queries, *a, **k):
        ids, dists, stats = search(index, queries, *a, **k)
        h = (ids.shape[0] + 1) // 2
        ids, dists = ids.clone(), dists.clone()
        ids[h:] = ids[:ids.shape[0] - h]
        dists[h:] = dists[:ids.shape[0] - h]
        return ids, dists, stats
    return broken


def _half_served(serve):
    """Half of a served batch left out, at the serve tier: its second
    half's rows are the first half's answers."""
    def broken(self, queries, *a, **k):
        ids, dists, rep = serve(self, queries, *a, **k)
        h = (len(ids) + 1) // 2
        ids[h:], dists[h:] = ids[:len(ids) - h], dists[:len(ids) - h]
        return ids, dists, rep
    return broken


def _unchanged(search):
    """A traversal step that returns its state unchanged: the search
    stops at the entry vertex's list."""
    def broken(index, queries, p, *a, **k):
        return search(index, queries, p._replace(max_iters=1), *a, **k)
    return broken


@pytest.mark.parametrize("fault", [_altered, _half, _unchanged,
                                   _half_served])
def test_serve_faults_are_incorrect(fault, monkeypatch, tiny_config):
    from repro_torch.serve import ann
    if fault is _half_served:
        monkeypatch.setattr(ann.BatchedSearcher, "search",
                            fault(ann.BatchedSearcher.search))
    else:
        monkeypatch.setattr(ann, "search", fault(ann.search))
    b = _bench(SERVE, 21, tiny_config)
    b.measure(0.2)
    assert not _correct(b.cell.check(21))


def _stale_from(cell, first: int, last: int | None = None):
    """A ``get`` that writes nothing (hands back the table's rows as they
    stand) on a segment's calls ``first`` to ``last`` (from 0), and is
    sound on the others."""
    get, calls = cell.vs.get, {}

    def stale(ids, account=True):
        a = int(ids[0])
        k = calls[a] = calls.get(a, -1) + 1
        if k >= first and (last is None or k <= last):
            return cell.table[ids].clone()
        return get(ids, account)
    return stale


@pytest.mark.parametrize("workload", RESTORE)
@pytest.mark.parametrize("fault", ["unchanged", "stale_after_first",
                                   "stale_once", "altered", "half"])
def test_restore_faults_are_incorrect(workload, fault, monkeypatch,
                                      tiny_config):
    """Every fault planted after set-up, on the table set-up left: the
    check has to see it in what the window itself restored."""
    b = _bench(workload, 22, tiny_config)
    cell = b.cell
    get, decode = cell.vs.get, cell.ix.decode_batch
    if fault == "unchanged":         # no restore writes anything
        monkeypatch.setattr(cell.vs, "get", _stale_from(cell, 0))
    elif fault == "stale_after_first":   # sound once, then nothing written
        monkeypatch.setattr(cell.vs, "get", _stale_from(cell, 1))
    elif fault == "stale_once":      # nothing written on the second cycle,
        monkeypatch.setattr(cell.vs, "get",   # sound before and after it
                            _stale_from(cell, 1, 1))
    elif fault == "altered":         # one byte of each segment flipped
        def altered(ids, account=True):
            out = get(ids, account)
            out.view(torch.uint8).reshape(len(ids), -1)[0, 0] ^= 1
            return out
        monkeypatch.setattr(cell.vs, "get", altered)
    else:                            # half of each batch of lists left out
        def half(ids):
            vals, cnt = decode(ids)
            h = len(ids) // 2
            vals[h:], cnt[h:] = -1, 0
            return vals, cnt
        monkeypatch.setattr(cell.ix, "decode_batch", half)
    got = b.measure(3.0 if fault == "stale_once" else 0.5)
    checks = cell.check(22)
    assert not _correct(checks)
    if fault == "stale_once":        # the last cycle was sound: only the
        assert got["attempted"] >= 3 * len(cell.units)   # checksums see it
        assert checks["vector_rows_wrong"][0] == 0
        assert checks["restores_wrong"][0] > 0


def test_restore_reads_the_stores_bytes_from_their_tensors(tiny_config):
    """The bytes the harness reads from the sealed stores' tensors agree
    with the stores' own counts (which the metric does not use)."""
    for workload in RESTORE:
        b = _bench(workload, 23, tiny_config)
        b.measure(0.1)
        checks = b.cell.check(23)
        assert _correct(checks)
        assert checks["_stored_bytes"] == checks["_stored_bytes_program"]


@pytest.mark.cuda
def test_card_run_is_correct(card, tiny_config):
    """On the card: a tiny serve cell through the kernels, held against
    the reference."""
    cfg = tiny_config("sift1b-shard")
    b = Bench(torch, SERVE, 31, card, trace=False, cfg=cfg)
    b.setup()
    got = b.measure(1.0)
    checks = b.cell.check(31)
    assert b.result(got, 1.0, checks)["correct"]
    assert np.isfinite(got["qps"])
