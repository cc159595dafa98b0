"""``ef_record_decode``, the index store's Elias-Fano record decode: the
plain version (``decode_records_torch`` on the record table's entries)
against a loop of ``decode_record`` on the records that stress it, and
that loop against the reference's ``decode_record``; positions outside
the table and records past the kernel's stage; the dispatch on CPU
tensors, the CUDA wrapper's checks; and, marked ``cuda``, the kernel
against the plain version on the card bit for bit, and one
``decode_batch`` of a store on the card as one launch and one read back.

Integer work: there is no tolerance in this file. Only the CPU test that
holds the edge records to the reference imports ``repro``, inside it, so
the card cases run where only the port is:

    python -m pytest -q -m cuda tests/test_torch_ef_record_decode.py
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core.codec import elias_fano as ef
from repro_torch.core.storage.index_store import CompressedIndexStore
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.ef_record_decode.ef_record_decode import (
    MAX_RECORD_BYTES, ef_record_decode_cuda, ef_record_decode_ref,
    fits_stage)

T = torch.from_numpy


@pytest.fixture
def cuda():
    """The card; tests that take it skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernels)")
    return torch.device("cuda")


def record(values, universe, lw=None) -> np.ndarray:
    """``encode_record`` of ``values``, or the same record at low width
    ``lw`` (the header carries the width, so any 0..32 split decodes)."""
    values = np.asarray(values, np.uint64)
    if lw is None:
        return ef.encode_record(values, universe)
    n, last = len(values), int(values[-1])
    e = ef.encode(values, universe, low_width=lw)
    low = e.low_words.view(np.uint8)[:(n * lw + 7) // 8]
    high = e.high_words.view(np.uint8)[:(n + (last >> lw) + 7) // 8]
    return np.concatenate([np.asarray([n, lw], np.uint8), low, high])


def _sorted(rng, n, universe, distinct=True):
    return np.sort(rng.choice(universe, n, replace=False) if distinct
                   else rng.integers(0, universe, n))


def edge_records() -> dict:
    """Name -> (record, universe): the counts, widths and universes at the
    format's limits."""
    rng = np.random.default_rng(25)
    return {
        "n=0": (record([], 1000), 1000),
        "n=1": (record([5], 1000), 1000),
        "n=255": (record(_sorted(rng, 255, 10**6, False), 10**6), 10**6),
        "lw=0": (record(np.arange(40), 1000), 1000),
        # 1,515 bytes, longer than the kernel stages: no store writes it
        # (the split is forced), and the op gives it count -1
        "lw=0 long": (record(_sorted(rng, 255, 12_000), 12_000, lw=0),
                      12_000),
        "lw=32 one": (record([2**32 - 1], 2**32, lw=32), 2**32),
        "lw=32 R=128": (record(_sorted(rng, 128, 2**32), 2**32, lw=32),
                        2**32),
        "n=255 U=2^32": (record(_sorted(rng, 255, 2**32), 2**32), 2**32),
        "R=128 shard": (record(_sorted(rng, 128, 31_250_000), 31_250_000),
                        31_250_000),
    }


def image(recs, seed=0, gap=4):
    """The records laid out in one uint8 image with 0..gap-1 random bytes
    before each (the block headers' place), the last one ending on the
    image's last byte -> (image, rec_start int64, rec_len int32)."""
    rng = np.random.default_rng(seed)
    parts, starts, at = [], [], 0
    for r in recs:
        pad = rng.integers(0, 256, int(rng.integers(0, gap)), dtype=np.uint8)
        parts += [pad, r]
        starts.append(at + len(pad))
        at += len(pad) + len(r)
    return (np.concatenate(parts) if parts else np.zeros(0, np.uint8),
            np.asarray(starts, np.int64),
            np.asarray([len(r) for r in recs], np.int32))


def random_records(n, r=128, universe=31_250_000, seed=1):
    """``n`` records of R-lists (a tenth shorter, some empty) drawn as the
    index store holds them: sorted distinct ids below ``universe``."""
    rng = np.random.default_rng(seed)
    counts = np.where(rng.random(n) < 0.1, rng.integers(0, r + 1, n), r)
    vals = np.sort(rng.integers(0, universe, (n, r)), axis=1)
    padded = np.where(np.arange(r) < counts[:, None], vals, -1)
    v, cnt = ef.sort_lists_torch(T(padded))
    payload, offsets = ef.encode_records_torch(v, cnt, universe)
    return payload, offsets[:-1].contiguous(), \
        (offsets[1:] - offsets[:-1]).to(torch.int32)


def assert_decodes(vals, counts, recs, universe_of):
    """Row i of (vals, counts) is ``decode_record`` of ``recs[i]``, -1
    past its count; a record past the stage has count -1 and a row of
    -1."""
    vals, counts = vals.cpu().numpy(), counts.cpu().numpy()
    staged = [len(r) <= MAX_RECORD_BYTES for r in recs]
    assert vals.shape[1] == max([int(r[0]) for r, k in zip(recs, staged)
                                 if k], default=0)
    for i, r in enumerate(recs):
        if not staged[i]:
            assert counts[i] == -1 and (vals[i] == -1).all()
            continue
        want = ef.decode_record(r, universe_of[i]).astype(np.int64)
        assert counts[i] == len(want)
        np.testing.assert_array_equal(vals[i, :len(want)], want)
        assert (vals[i, len(want):] == -1).all()


def assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int64
        assert g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


EDGES = edge_records()


@pytest.mark.parametrize("name", sorted(EDGES))
def test_edge_record_decodes_as_the_reference(name):
    """The port's ``decode_record`` and the batched plain coder (at any
    length) equal the reference's ``decode_record`` on each edge record,
    forced splits included."""
    from repro.core.codec import elias_fano as jef
    rec, universe = EDGES[name]
    want = jef.decode_record(rec, universe).astype(np.int64)
    np.testing.assert_array_equal(ef.decode_record(rec, universe), want)
    vals, counts = ef.decode_records_torch(T(rec), torch.tensor([0]),
                                           torch.tensor([len(rec)]))
    assert counts.tolist() == [len(want)]
    np.testing.assert_array_equal(vals[0].numpy(), want)


@pytest.mark.parametrize("name", sorted(EDGES))
def test_plain_decode_of_edge_record_equals_decode_record(name):
    """Each edge record alone, last in its image, between neighbours."""
    rec, universe = EDGES[name]
    filler = record([3, 9, 700], 1000)
    for recs, at in (([rec], 0), ([filler, rec], 1), ([rec, filler], 0)):
        buf, st, ln = image(recs)
        vals, counts = ef_record_decode_ref(T(buf), T(st), T(ln),
                                            torch.tensor([at]))
        assert_decodes(vals, counts, [recs[at]], [universe])


def test_plain_decode_of_all_edge_records_out_of_order():
    recs = [r for r, _ in EDGES.values()]
    universes = [u for _, u in EDGES.values()]
    buf, st, ln = image(recs, seed=3)
    pos = np.random.default_rng(4).permutation(len(recs))
    pos = np.concatenate([pos, pos[:3]])          # repeats
    vals, counts = ef_record_decode_ref(T(buf), T(st), T(ln), T(pos))
    assert_decodes(vals, counts, [recs[p] for p in pos],
                   [universes[p] for p in pos])
    # every record in order
    vals, counts = ef_record_decode_ref(T(buf), T(st), T(ln),
                                        torch.arange(len(recs)))
    assert_decodes(vals, counts, recs, universes)


def test_positions_outside_the_table_give_count_minus_one():
    buf, st, ln = random_records(50, r=16, seed=9)
    pos = torch.tensor([-1, 3, 50, -50, 49, 1 << 40, 0])
    vals, counts = ef_record_decode_ref(buf, st, ln, pos)
    inside = torch.tensor([False, True, False, False, True, False, True])
    assert counts[~inside].tolist() == [-1] * 4
    assert bool((vals[~inside] == -1).all())
    want = ef_record_decode_ref(buf, st, ln, pos[inside])
    assert_same((vals[inside], counts[inside]), want)
    assert vals.shape[1] == want[0].shape[1]
    # none inside: width 0
    vals, counts = ef_record_decode_ref(buf, st, ln, torch.tensor([-2, 60]))
    assert vals.shape == (2, 0) and counts.tolist() == [-1, -1]


def test_stage_fits_every_record_the_store_writes_at_2_pow_32():
    assert fits_stage(128, 31_250_000) and fits_stage(255, 2**32)
    assert not fits_stage(255, 2**40)
    rng = np.random.default_rng(6)
    longest = max(len(ef.encode_record(_sorted(rng, 255, 2**32), 2**32))
                  for _ in range(20))
    assert longest <= MAX_RECORD_BYTES


def test_dispatch_sends_cpu_tensors_to_the_plain_decode(monkeypatch):
    buf, st, ln = random_records(300)
    pos = torch.randperm(300, generator=torch.Generator().manual_seed(0))
    want = ef.decode_records_torch(buf, st[pos], ln[pos])
    calls = []

    def plain(*args, **kw):
        calls.append(args)
        return want

    monkeypatch.setattr(ef, "decode_records_torch", plain)
    got = dispatch.ef_record_decode(buf, st, ln, pos)
    assert len(calls) == 1 and calls[0][3] == want[0].shape[1]
    assert_same(got, want)
    assert torch.equal(calls[0][1], st[pos]) and \
        torch.equal(calls[0][2], ln[pos])
    monkeypatch.undo()
    assert_same(dispatch.ef_record_decode(buf, st, ln, pos), want)


def test_decode_batch_on_the_cpu_goes_through_the_dispatch(monkeypatch):
    rng = np.random.default_rng(5)
    adj = np.sort(rng.integers(0, 400, (400, 12)), axis=1)
    store = CompressedIndexStore.from_graph(T(adj), 0, 12, universe=400,
                                            device="cpu")
    seen = []
    real = dispatch.ef_record_decode
    monkeypatch.setattr(dispatch, "ef_record_decode",
                        lambda *a, **k: seen.append(a) or real(*a, **k))
    ids = rng.permutation(400)
    vals, cnt = store.decode_batch(ids)
    assert len(seen) == 1
    np.testing.assert_array_equal(vals.numpy(), adj[ids])
    assert (cnt.numpy() == 12).all()


def _store(order=None, n=300, r=10, seed=7):
    rng = np.random.default_rng(seed)
    adj = np.sort(rng.integers(0, n, (n, r)), axis=1)
    return CompressedIndexStore.from_graph(T(adj), 0, r, universe=n,
                                           order=order, device="cpu"), adj


@pytest.mark.parametrize("order", [None, "bfs"])
def test_decode_batch_gives_ids_outside_the_store_count_minus_one(order):
    """An id outside [0, n) reads count -1 and a row of -1 (it used to
    raise on the CPU, wrap at -1, or fault on the card); the others decode
    as alone."""
    store, adj = _store(order=order)
    ids = np.asarray([5, -1, 300, 299, -300, 10**9, 0])
    inside = (ids >= 0) & (ids < 300)
    vals, cnt = store.decode_batch(ids)
    assert cnt.numpy()[~inside].tolist() == [-1] * 4
    assert bool((vals[torch.from_numpy(~inside)] == -1).all())
    want_vals, want_cnt = store.decode_batch(ids[inside])
    assert torch.equal(vals[torch.from_numpy(inside)], want_vals)
    assert torch.equal(cnt[torch.from_numpy(inside)], want_cnt)
    np.testing.assert_array_equal(want_vals.numpy(), adj[ids[inside]])


def test_decode_batch_refuses_a_store_past_the_stage():
    store, _ = _store()
    wide = dataclasses.replace(store, universe=2**48)
    with pytest.raises(ValueError, match="longer than 1085 B"):
        wide.decode_batch(np.arange(3))


def _good():
    buf, st, ln = random_records(8)
    return dict(buf=buf, rec_start=st, rec_len=ln, pos=torch.arange(8))


BAD = {
    "buf int8": ("buf", lambda a: a.to(torch.int8)),
    "buf 2-D": ("buf", lambda a: a[:8].reshape(2, 4)),
    "rec_start int32": ("rec_start", lambda a: a.to(torch.int32)),
    "rec_start 2-D": ("rec_start", lambda a: a.reshape(2, 4)),
    "rec_len int64": ("rec_len", lambda a: a.to(torch.int64)),
    "rec_len length": ("rec_len", lambda a: a[:7]),
    "pos int32": ("pos", lambda a: a.to(torch.int32)),
    "pos 2-D": ("pos", lambda a: a.reshape(2, 4)),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_cuda_wrapper_refuses_wrong_inputs_before_the_card(case,
                                                           monkeypatch):
    """A wrong dtype, rank or length raises ValueError naming the op, and
    nothing reaches the card: no tensor check of the device, no launch."""
    def touch(*a, **k):
        raise AssertionError("the wrapper reached the card")
    from repro_torch.kernels.ef_record_decode import ef_record_decode as m
    monkeypatch.setattr(m, "check_cuda", touch)
    monkeypatch.setattr(m, "launch", touch)
    args = _good()
    name, bad = BAD[case]
    args[name] = bad(args[name])
    with pytest.raises(ValueError, match="ef_record_decode takes"):
        ef_record_decode_cuda(**args)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        ef_record_decode_cuda(**_good())


# ------------------------------------------------------------ on the card
def _on(dev, *ts):
    return [t.to(dev) for t in ts]


@pytest.mark.cuda
def test_kernel_equals_plain_on_edge_records(cuda):
    recs = [r for r, _ in EDGES.values()]
    universes = [u for _, u in EDGES.values()]
    for seed, gap in ((0, 1), (1, 4), (2, 9)):      # every start alignment
        buf, st, ln = _on(cuda, *map(T, image(recs, seed=seed, gap=gap)))
        pos = torch.randperm(len(recs), device=cuda)
        pos = torch.cat([pos, pos[:3], torch.tensor([-5, 99], device=cuda)])
        build.reset_launches()
        got = ef_record_decode_cuda(buf, st, ln, pos)
        assert build.LAUNCHES["ef_record_decode"] == 1
        assert_same(got, ef_record_decode_ref(buf, st, ln, pos))
        order = torch.arange(len(recs), device=cuda)
        assert_same(ef_record_decode_cuda(buf, st, ln, order),
                    ef_record_decode_ref(buf, st, ln, order))
        keep = pos[:len(recs)].cpu().numpy()
        assert_decodes(got[0][:len(recs)], got[1][:len(recs)],
                       [recs[p] for p in keep], [universes[p] for p in keep])
    # each edge record last in the image, on its last byte
    for rec, _ in EDGES.values():
        buf, st, ln = _on(cuda, *map(T, image([record([1, 2], 9), rec])))
        both = torch.arange(2, device=cuda)
        assert_same(ef_record_decode_cuda(buf, st, ln, both),
                    ef_record_decode_ref(buf, st, ln, both))


@pytest.mark.cuda
def test_kernel_equals_plain_on_random_records(cuda):
    buf, st, ln = _on(cuda, *random_records(100_000))
    pos = torch.randperm(100_000, device=cuda)
    got = ef_record_decode_cuda(buf, st, ln, pos)
    torch.cuda.synchronize()
    assert_same(got, ef_record_decode_ref(buf, st, ln, pos))
    assert got[0].shape == (100_000, 128)
    # an odd image address (the image a view one byte in)
    big = torch.empty(buf.numel() + 1, dtype=torch.uint8, device=cuda)
    big[1:] = buf
    assert_same(ef_record_decode_cuda(big[1:], st, ln, pos), got)
    # no records
    empty = ef_record_decode_cuda(buf, st, ln, pos[:0])
    assert empty[0].shape == (0, 0) and empty[1].shape == (0,)


@pytest.mark.cuda
def test_kernel_equals_plain_past_2_gib(cuda):
    payload, st, ln = random_records(2_000, seed=7)
    far = (1 << 31) + 3
    big = torch.zeros(far + payload.numel(), dtype=torch.uint8, device=cuda)
    big[far:] = payload.to(cuda)
    st, ln = _on(cuda, st + far, ln)
    pos = torch.randperm(2_000, device=cuda)
    got = ef_record_decode_cuda(big, st, ln, pos)
    assert_same(got, ef_record_decode_ref(big, st, ln, pos))
    assert_same(got, ef_record_decode_ref(*_on(cuda, payload, st - far, ln),
                                          pos))


def _spans(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(ev.name[len(tracing.PREFIX):], ev.time_range.start,
                  ev.time_range.end) for ev in prof.events()
                 if ev.name.startswith(tracing.PREFIX)]


@pytest.mark.cuda
def test_decode_batch_is_one_launch_and_one_read_back(cuda):
    """One decode_batch of 100,000 records on the card: one
    ef_record_decode launch and one ef.sync span, inside
    istore.decode_batch; the lists equal the graph's."""
    n, r = 100_000, 128
    g = torch.Generator(device=cuda).manual_seed(25)
    adj = torch.randint(0, n, (n, r), generator=g, device=cuda)
    store = CompressedIndexStore.from_graph(adj, 0, r, universe=n,
                                            device=cuda)
    ids = torch.arange(n, device=cuda)
    torch.cuda.synchronize()
    build.reset_launches()
    (vals, cnt), got = _spans(lambda: store.decode_batch(ids))
    torch.cuda.synchronize()
    assert build.LAUNCHES["ef_record_decode"] == 1
    syncs = [s for s in got if s[0] == "ef.sync"]
    whole = [s for s in got if s[0] == "istore.decode_batch"]
    assert len(syncs) == 1 and len(whole) == 1
    assert whole[0][1] <= syncs[0][1] and syncs[0][2] <= whole[0][2]
    assert torch.equal(vals, adj.sort(1).values)
    assert bool((cnt == r).all())
    ref = ef_record_decode_ref(store.data, store.rec_start, store.rec_len,
                               ids)
    assert_same((vals, cnt), ref)
