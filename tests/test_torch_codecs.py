"""Port parity tier for the codecs of the §3.3 storage path: Huffman
tables and coders (numpy copy and torch), Elias-Fano lists and byte
records (numpy copy and the batched torch coder), every registry codec,
the compression planner's manifests, the XOR-delta decisions and the
locality orderings, each against ``repro`` on the same seeded inputs.

Bytes must be identical; there is no tolerance in this file.
"""
import numpy as np
import pytest
import torch

from repro.core.codec import ans as jans
from repro.core.codec import elias_fano as jef
from repro.core.codec import entropy as jentropy
from repro.core.codec import huffman as jhuff
from repro.core.codec import registry as jreg
from repro.core.codec import xor_delta as jxd
from repro.core.graph import reorder as jreorder
from repro.data.synthetic import make_vector_dataset

from repro_torch.core.codec import ans, elias_fano as ef, entropy, huffman
from repro_torch.core.codec import registry, xor_delta
from repro_torch.core.graph import reorder

from conftest import random_graph

T = torch.from_numpy


def byte_rows(dist: str, n: int, v: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        return rng.integers(0, 256, size=(n, v), dtype=np.uint8)
    if dist == "skewed":
        return (rng.gamma(1.0, 10.0, size=(n, v)) % 256).astype(np.uint8)
    if dist == "constant":
        return np.full((n, v), 7, dtype=np.uint8)
    if dist == "prop-like":   # fp32 rows: 4 byte planes
        x = make_vector_dataset("prop-like", n, max(1, v // 4), seed=seed)
        return x.view(np.uint8).reshape(n, -1)
    raise ValueError(dist)


def tables(data: np.ndarray, planar: bool):
    if planar:
        return (jhuff.PlaneTables.from_data(data, 4),
                huffman.PlaneTables.from_data(data, 4))
    return jhuff.HuffmanTable.from_data(data), huffman.HuffmanTable.from_data(data)


def assert_same_table(a, b):
    for x, y in zip(getattr(a, "tables", [a]), getattr(b, "tables", [b])):
        for f in ("lengths", "codes", "decode_sym", "decode_len"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    assert a.size_bytes == b.size_bytes


# ---------------------------------------------------------------- huffman
DISTS = ["uniform", "skewed", "constant", "prop-like"]


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("dist", DISTS)
def test_huffman_tables_match_reference(dist, planar):
    data = byte_rows(dist, 300, 32, seed=len(dist))
    assert_same_table(*tables(data, planar))


def test_huffman_length_limit_matches_reference():
    freqs = np.zeros(256, dtype=np.int64)
    freqs[:30] = 2 ** np.arange(30)
    a = jhuff.HuffmanTable.from_frequencies(freqs)
    b = huffman.HuffmanTable.from_frequencies(freqs)
    assert_same_table(a, b)
    assert b.lengths.max() <= huffman.MAX_LEN


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("dist,n,v", [("uniform", 1, 1), ("skewed", 60, 48),
                                      ("constant", 5, 12),
                                      ("prop-like", 200, 64),
                                      ("skewed", 500, 32)])
def test_huffman_coders_match_reference(dist, n, v, planar):
    data = byte_rows(dist, n, v, seed=n + v)
    jt, pt = tables(data, planar)
    payload, offsets = jhuff.encode_records(data, jt)
    p_np, o_np = huffman.encode_records(data, pt)
    p_t, o_t = huffman.encode_records_torch(T(data), pt)
    for p, o in ((p_np, o_np), (p_t.numpy(), o_t.numpy())):
        np.testing.assert_array_equal(p, payload)
        np.testing.assert_array_equal(o, offsets)
    np.testing.assert_array_equal(
        huffman.record_bytes_torch(T(data), pt).numpy(), np.diff(offsets))
    sel = np.random.default_rng(n).permutation(n)
    want = jhuff.decode_at(payload, offsets[:-1][sel], v, jt)
    np.testing.assert_array_equal(want, data[sel])
    np.testing.assert_array_equal(
        huffman.decode_at(payload, offsets[:-1][sel], v, pt), want)
    np.testing.assert_array_equal(huffman.decode_at_torch(
        T(payload), T(offsets[:-1][sel]), v, pt).numpy(), want)
    np.testing.assert_array_equal(huffman.decode_records(
        payload, offsets, v, pt, select=sel), want)


def test_huffman_encode_into_keeps_the_bytes_around_records():
    """Records ORed into a buffer at scattered offsets leave the bytes
    between them (block headers) as they were."""
    data = byte_rows("skewed", 40, 16, seed=1)
    table = huffman.HuffmanTable.from_data(data)
    nbytes = huffman.record_bytes_torch(T(data), table)
    starts = torch.cumsum(nbytes + 3, 0) - nbytes
    buf = torch.zeros(int(starts[-1] + nbytes[-1]) + 5, dtype=torch.uint8)
    gaps = torch.ones_like(buf, dtype=torch.bool)
    for s, n in zip(starts.tolist(), nbytes.tolist()):
        gaps[s:s + n] = False
    buf[gaps] = 0xA5
    huffman.encode_into_torch(buf, starts, T(data), table)
    assert bool((buf[gaps] == 0xA5).all())
    np.testing.assert_array_equal(
        huffman.decode_at_torch(buf, starts, 16, table).numpy(), data)


# ------------------------------------------------------------ elias-fano
def ef_lists(universe: int, seed: int, count: int = 120) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for t in range(count):
        n = int(rng.integers(0, min(universe, 255) + 1)) if t % 5 else \
            int(rng.integers(0, 3))
        if t % 7 == 0:          # a dense run: a narrow span, small width
            lo = int(rng.integers(0, max(1, universe - 300)))
            span = np.arange(lo, min(universe, lo + 300))
            vals = rng.choice(span, size=min(n, len(span)), replace=False)
        else:
            vals = rng.choice(universe, size=n, replace=False) \
                if universe <= 10**6 else np.unique(
                    rng.integers(0, universe, size=n))
        out.append(np.sort(vals).astype(np.uint64))
    return out


UNIVERSES = [2, 64, 1000, 10**5, 31_250_000, 2**32]


@pytest.mark.parametrize("universe", UNIVERSES)
def test_ef_records_match_reference(universe):
    lists = ef_lists(universe, seed=universe % 97)
    want = [jef.encode_record(v, universe) for v in lists]
    for v, w in zip(lists, want):
        np.testing.assert_array_equal(ef.encode_record(v, universe), w)
        np.testing.assert_array_equal(ef.decode_record(w, universe),
                                      jef.decode_record(w, universe))
    width = max(1, max(len(v) for v in lists))
    padded = np.full((len(lists), width), -1, np.int64)
    rng = np.random.default_rng(1)
    for i, v in enumerate(lists):   # shuffled: the batched coder sorts
        padded[i, :len(v)] = rng.permutation(v.astype(np.int64))
    vals, cnt = ef.sort_lists_torch(T(padded))
    payload, offsets = ef.encode_records_torch(vals, cnt, universe)
    np.testing.assert_array_equal(payload.numpy(), np.concatenate(want))
    np.testing.assert_array_equal(
        np.diff(offsets.numpy()), [len(w) for w in want])
    got, counts = ef.decode_records_torch(payload, offsets[:-1],
                                          offsets[1:] - offsets[:-1], width)
    for i, v in enumerate(lists):
        assert int(counts[i]) == len(v)
        np.testing.assert_array_equal(got[i, :len(v)].numpy(),
                                      v.astype(np.int64))
        assert bool((got[i, len(v):] == -1).all())


def test_ef_record_width_rules_match_reference():
    for n in (1, 2, 7, 128, 255):
        for last in (0, 1, 255, 4095, 10**6, 2**32 - 1):
            for universe in (last + 1, 2**32):
                assert ef.optimal_low_width(n, last, universe) == \
                    jef.optimal_low_width(n, last, universe)
                for lw in range(33):
                    assert ef.record_bytes_for_width(n, last, lw) == \
                        jef.record_bytes_for_width(n, last, lw)
    for r, u in ((128, 31_250_000), (96, 10**8), (1, 2), (24, 1200)):
        assert ef.worst_case_bits(r, u) == jef.worst_case_bits(r, u)
        assert ef.worst_case_record_bytes(r, u) == \
            jef.worst_case_record_bytes(r, u)


@pytest.mark.parametrize("low_width", [None, 0, 5, 32])
def test_ef_lists_match_reference(low_width):
    rng = np.random.default_rng(3)
    v = np.sort(rng.choice(10**6, size=200, replace=False)).astype(np.uint64)
    a = jef.encode(v, 10**6, low_width)
    b = ef.encode(v, 10**6, low_width)
    assert (a.n, a.universe, a.low_width) == (b.n, b.universe, b.low_width)
    np.testing.assert_array_equal(a.low_words, b.low_words)
    np.testing.assert_array_equal(a.high_words, b.high_words)
    np.testing.assert_array_equal(ef.decode(b), v)


def test_ef_batched_coder_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="255"):
        ef.encode_records_torch(torch.zeros((1, 256), dtype=torch.int64),
                                torch.tensor([256]), 10**6)
    with pytest.raises(ValueError, match="universe"):
        ef.encode_records_torch(torch.tensor([[3, 1000]]), torch.tensor([2]),
                                1000)


# ---------------------------------------------------------- codec registry
def samples_for(component: str, seed: int) -> tuple[list, dict]:
    rng = np.random.default_rng(seed)
    if component == "adjacency":
        adj, _ = random_graph(400, 16, seed=seed)
        return adj[:64], {"universe": 400}
    if component == "ef_slots":
        return [rng.integers(0, 2**32, size=20, dtype=np.uint64).astype(
            np.uint32) for _ in range(16)], {}
    if component == "pq_codes":
        return [rng.integers(0, 256, size=32, dtype=np.uint8)
                for _ in range(32)], {}
    if component == "vector_chunks":
        x = make_vector_dataset("sift-like", 64, 32, seed=seed)
        return [row for row in x], {}
    if component == "permutation":
        return [rng.permutation(500)[:50] for _ in range(8)], \
            {"universe": 500}
    raise ValueError(component)


CODEC_CASES = [(name, comp) for name in sorted(jreg.names())
               for comp in jreg.COMPONENTS
               if comp in jreg.get(name).components]


@pytest.mark.parametrize("name,component", CODEC_CASES)
def test_registry_codec_matches_reference(name, component):
    recs, ctx = samples_for(component, seed=len(name) + len(component))
    jc, pc = jreg.get(name), registry.get(name)
    assert jc.components == pc.components
    kw = dict(universe=ctx.get("universe"))
    if name == "plane_huffman":
        recs = [make_vector_dataset("prop-like", 8, 16, seed=2)[i]
                for i in range(8)]
        kw["itemsize"] = 4
    try:
        want = jc.estimate_bytes(recs, **kw)
    except (TypeError, ValueError) as err:
        with pytest.raises(type(err)):
            pc.estimate_bytes(recs, **kw)
        return
    assert pc.estimate_bytes(recs, **kw) == want
    for rec in recs[:8]:
        rec = np.sort(np.asarray(rec)) if component in (
            "adjacency", "permutation") else np.asarray(rec)
        if name == "elias_fano" and kw["universe"] is None:
            continue
        enc = jc.encode(rec, **kw)
        np.testing.assert_array_equal(pc.encode(rec, **kw), enc)
        np.testing.assert_array_equal(pc.decode(enc, **kw),
                                      jc.decode(enc, **kw))
    bound = getattr(jc, "record_bound", None)
    if bound is not None:
        for r, u in ((16, 400), (128, 31_250_000), (1, 2)):
            assert pc.record_bound(r, u) == bound(r, u)


def test_registry_names_and_components_match_reference():
    assert registry.names() == jreg.names()
    assert registry.COMPONENTS == jreg.COMPONENTS
    for comp in jreg.COMPONENTS:
        assert [c.name for c in registry.codecs_for(comp)] == \
            [c.name for c in jreg.codecs_for(comp)]


@pytest.mark.parametrize("kind,dtype", [("sift-like", np.uint8),
                                        ("prop-like", np.float32)])
def test_plan_components_manifest_matches_reference(kind, dtype, tmp_path):
    x = make_vector_dataset(kind, 600, 32, seed=4).astype(dtype)
    adj, _ = random_graph(600, 16, seed=4)
    vb = x.view(np.uint8).reshape(len(x), -1)
    samples = {"adjacency": adj, "vector_chunks": list(vb),
               "pq_codes": list(vb[:, :8]),
               "permutation": [np.random.default_rng(0).permutation(600)]}
    kw = dict(universe=600, itemsize=x.dtype.itemsize, sample_limit=128,
              reorder="bfs")
    want = jreg.plan_components(samples, **kw)
    got = registry.plan_components(samples, **kw)
    assert got.to_json() == want.to_json()
    got.save(tmp_path / "m.json")
    assert type(got).load(tmp_path / "m.json").to_json() == want.to_json()


def test_ans_gap_records_match_reference():
    for seed in range(6):
        rng = np.random.default_rng(seed)
        v = np.sort(rng.choice(2**20, size=int(rng.integers(0, 300)),
                               replace=False)).astype(np.uint64)
        enc = jans.encode_gaps(v)
        np.testing.assert_array_equal(ans.encode_gaps(v), enc)
        np.testing.assert_array_equal(ans.decode_gaps(enc), v)
        assert ans.record_bound(128, 2**20) == jans.record_bound(128, 2**20)


# --------------------------------------------------------------- xor-delta
@pytest.mark.parametrize("rows_per_chunk", [4000, 512, 333])
@pytest.mark.parametrize("kind,dim", [("sift-like", 32), ("prop-like", 32),
                                      ("spacev-like", 100)])
def test_xor_delta_decisions_match_reference(kind, dim, rows_per_chunk):
    vb = jxd.as_bytes(make_vector_dataset(kind, 4000, dim, seed=7))
    use, bases = xor_delta.chunk_decisions_torch(T(vb), rows_per_chunk)
    for c, lo in enumerate(range(0, len(vb), rows_per_chunk)):
        u, b = jxd.delta_wins(vb[lo:lo + rows_per_chunk])
        assert use[c] == u
        np.testing.assert_array_equal(bases[c].numpy(), b)
    u, b = xor_delta.delta_wins_torch(T(vb))
    assert (u, b.numpy().tolist()) == (lambda r: (r[0], r[1].tolist()))(
        jxd.delta_wins(vb))
    np.testing.assert_array_equal(xor_delta.build_base_torch(T(vb)).numpy(),
                                  jxd.build_base(vb))
    np.testing.assert_array_equal(xor_delta.delta_wins(vb)[1],
                                  jxd.delta_wins(vb)[1])


def test_xor_delta_prop_like_chooses_delta_and_sift_like_does_not():
    """The §3.3 test on the two corpora the storage phase seals, at
    2048-row (1 MiB) chunks of 128-dim fp32 and uint8 rows: prop-like takes
    XOR-delta in a chunk, sift-like in none, as in the reference."""
    prop = jxd.as_bytes(make_vector_dataset("prop-like", 4096, 128, seed=0))
    sift = jxd.as_bytes(make_vector_dataset("sift-like", 8192, 128, seed=0))
    use = xor_delta.chunk_decisions_torch(T(prop), 2048)[0]
    assert use == [jxd.delta_wins(prop[lo:lo + 2048])[0]
                   for lo in (0, 2048)] and any(use)
    assert not any(xor_delta.chunk_decisions_torch(T(sift), 8192)[0])


def test_entropy_matches_reference():
    for kind in ("sift-like", "prop-like", "spacev-like"):
        x = make_vector_dataset(kind, 2000, 16, seed=1)
        assert entropy.characterize(x) == jentropy.characterize(x)
        vb = jxd.as_bytes(x)
        assert entropy.byte_entropy_torch(T(vb)) == jentropy.byte_entropy(vb)


# --------------------------------------------------------------- reorder
@pytest.mark.parametrize("kind", list(jreorder.KINDS))
def test_orders_match_reference(kind):
    adj, _ = random_graph(300, 12, seed=5)
    a = jreorder.compute_order(adj, 7, kind)
    b = reorder.compute_order(adj, 7, kind)
    np.testing.assert_array_equal(a.perm, b.perm)
    np.testing.assert_array_equal(a.inv, b.inv)
    b.validate()
    assert reorder.gap_bits(reorder.apply_order(adj, b)) == \
        jreorder.gap_bits(jreorder.apply_order(adj, a))
    np.testing.assert_array_equal(b.to_external([3, -1, 299]),
                                  a.to_external([3, -1, 299]))
