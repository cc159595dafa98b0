"""Port parity tier for the §3.4 query path: ``repro_torch``'s batch-first
beam search + re-rank against the JAX reference's ``search`` on the same
index (the reference's ``DeviceIndex`` handed over through
``device_index_from_numpy``), so a graph-build difference cannot hide a
search difference.

Ids and every ``SearchStats`` field (traces on) must be identical.
Distances are held to rtol 1e-6: the reference computes them inside
``jit``, where XLA fuses the LUT's and the rerank's sums into another
order than the eager oracles' left folds (which the port's folds equal bit
for bit, tests/test_torch_kernels.py and ``test_luts_are_identical``); on
this world the ids do not depend on it.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core.graph.pq import build_lut_jnp
from repro.core.index import build_device_index
from repro.core.search import beam as ref_beam
from repro.data.synthetic import make_queries, make_vector_dataset
from repro.kernels.dispatch import KernelConfig as JKernelConfig

from repro_torch import tracing
from repro_torch.core.index import device_index_from_numpy, recall_at_k
from repro_torch.core.search import beam
from repro_torch.core.search.beam import (SearchParams, search,
                                          search_candidates, search_one)
from repro_torch.core.graph.pq import build_lut_torch
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.beam_step.beam_step import beam_step_ref
from repro_torch.kernels.ef_decode.ef_decode import ef_decode_ref
from repro_torch.kernels.pq_adc.pq_adc import pq_adc_batched_ref
from repro_torch.kernels.search_round import search_round as sr

from conftest import build_search_world
from test_torch_cuda import ROUND_CASES, round_case

GOLDEN_RECALL_AT_10 = 0.971875     # tests/test_search.py's pinned golden
JREF = JKernelConfig("ref", "ref", "ref", "ref", "off")
BASE = dict(l_size=48, beam_width=4, k=10, rerank_batch=10, r_max=24,
            universe=1200, max_iters=128, trace_fetches=True,
            trace_hints=True)


@pytest.fixture(scope="module")
def world():
    vecs, idx, graph, cb, queries, gt = build_search_world()
    arrays = {k: np.asarray(v) for k, v in idx._asdict().items()}
    return idx, device_index_from_numpy(arrays, "cpu"), arrays, queries, gt


@pytest.fixture(scope="module")
def jax_runs(world):
    """Reference results, computed once per parameter set."""
    ref_idx, _, _, queries, _ = world
    cache = {}

    def run(nq, **kw):
        key = (nq, tuple(sorted(kw.items())))
        if key not in cache:
            p = ref_beam.SearchParams(**{**BASE, **kw}, kernels=JREF)
            cache[key] = ref_beam.search(ref_idx, queries[:nq], p)
        return cache[key]
    return run


def _port(**kw):
    return SearchParams(**{**BASE, **kw})


def assert_same_search(got, want):
    ids, dists, stats = got
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(dists.numpy(), np.asarray(want[1]), rtol=1e-6)
    assert stats._fields == want[2]._fields
    for name, a, b in zip(stats._fields, stats, want[2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


@pytest.mark.parametrize("bits", [0, 10], ids=["dense", "hashed"])
@pytest.mark.parametrize("max_iters", [128, 5])
@pytest.mark.parametrize("nq", [1, 7, 32])
def test_search_matches_reference(world, jax_runs, nq, max_iters, bits):
    """The port's one path (the fused hop) against the reference's unfused
    hop, run to its end and frozen at an iteration cap."""
    _, index, _, queries, _ = world
    kw = dict(visited_hash_bits=bits, max_iters=max_iters)
    got = search(index, queries[:nq], _port(**kw), device="cpu")
    assert_same_search(got, jax_runs(nq, **kw))


@pytest.fixture(scope="module", params=["sift-like", "prop-like"])
def world128(request):
    """A d = 128 world (n=1200, pq_m=16, the shard's width) built by the
    reference, which hands its vectors over as float32; for the sift-like
    world the port also searches the same vectors as uint8, the shard's
    dtype -> (reference index, port indexes by vector dtype, queries, a
    cache of reference runs)."""
    vecs = make_vector_dataset(request.param, n=1200, dim=128, seed=0)
    ref_idx, _, _ = build_device_index(vecs, r=24, l_build=48, pq_m=16,
                                       seed=0)
    arrays = {k: np.asarray(v) for k, v in ref_idx._asdict().items()}
    ports = {"float32": device_index_from_numpy(arrays, "cpu")}
    if vecs.dtype == np.uint8:
        ports["uint8"] = device_index_from_numpy({**arrays, "vectors": vecs},
                                                 "cpu")
    queries = make_queries(request.param, 32, 128).astype(np.float32)
    return ref_idx, ports, queries, {}


@pytest.mark.parametrize("bits", [0, 10], ids=["dense", "hashed"])
@pytest.mark.parametrize("max_iters", [128, 5])
@pytest.mark.parametrize("nq", [7, 32])
def test_search_matches_reference_d128(world128, nq, max_iters, bits):
    ref_idx, ports, queries, runs = world128
    kw = dict(visited_hash_bits=bits, max_iters=max_iters)
    if (nq, bits, max_iters) not in runs:
        p = ref_beam.SearchParams(**{**BASE, **kw}, kernels=JREF)
        runs[nq, bits, max_iters] = ref_beam.search(ref_idx, queries[:nq], p)
    for index in ports.values():
        got = search(index, queries[:nq], _port(**kw), device="cpu")
        assert_same_search(got, runs[nq, bits, max_iters])


def test_raw_adjacency_and_tombstones_match_reference(world):
    """The uncompressed-adjacency ablation and the live-snapshot tombstone
    mask take the same path as in the reference."""
    ref_idx, _, arrays, queries, _ = world
    tomb = np.zeros(len(arrays["counts"]), bool)
    tomb[::5] = True
    index = device_index_from_numpy({**arrays, "tombstone": tomb}, "cpu")
    ref_live = ref_idx._replace(tombstone=jnp.asarray(tomb))
    for kw in (dict(use_ef=False), dict(filter_tombstones=True)):
        p = ref_beam.SearchParams(**{**BASE, **kw}, kernels=JREF)
        want = ref_beam.search(ref_live, queries[:7], p)
        assert_same_search(search(index, queries[:7], _port(**kw),
                                  device="cpu"), want)


#: Re-rank settings around BASE: the default, thresholds at which every
#: batch or none reads below (and 0.1, where at B = 10 one displaced entry
#: is exactly the threshold), no batch, one batch, B = 4 with K = 12.
RERANK_KW = {
    "default": dict(),
    "thr-0.1": dict(benefit_threshold=0.1),
    "thr-1": dict(benefit_threshold=1.0),
    "thr-0": dict(benefit_threshold=0.0),
    "no-batch": dict(max_rerank_batches=0),
    "one-batch": dict(max_rerank_batches=1, benefit_threshold=0.5),
    "k12-b4": dict(k=12, rerank_batch=4, benefit_threshold=0.3),
}


def _rerank_against_reference(ref_idx, index, queries, kw):
    """The op ``dispatch.rerank_loop`` on CPU tensors, on the candidates
    the port's traversal leaves, against the reference's ``rerank`` of the
    same candidates: ids, batches run and exact-distance counts equal,
    distances to rtol 1e-6 (the module's rule)."""
    p = _port(**kw)
    cand_ids, _ = search_candidates(index, queries, p, device="cpu")
    K, B = p.k, p.rerank_batch
    max_batches = min(p.max_rerank_batches, max(0, (p.l_size - K) // B))
    ids, dists, batches = dispatch.rerank_loop(
        torch.from_numpy(queries).float(), index.vectors, cand_ids, K, B,
        max_batches, p.benefit_threshold)
    want = ref_beam.rerank(
        ref_idx, jnp.asarray(queries, jnp.float32),
        jnp.asarray(cand_ids.numpy()),
        ref_beam.SearchParams(**{**BASE, **kw}, kernels=JREF))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(dists.numpy(), np.asarray(want[1]),
                               rtol=1e-6)
    np.testing.assert_array_equal(batches.numpy(), np.asarray(want[2][0]))
    np.testing.assert_array_equal(K + batches.numpy() * B,
                                  np.asarray(want[2][1]))
    return batches


@pytest.mark.parametrize("kw", sorted(RERANK_KW))
def test_rerank_loop_matches_the_reference_rerank(world, kw):
    ref_idx, index, _, queries, _ = world
    batches = _rerank_against_reference(ref_idx, index, queries[:32],
                                        RERANK_KW[kw])
    if kw == "no-batch":
        assert not batches.any()


@pytest.mark.parametrize("kw", ["default", "thr-0.1", "k12-b4"])
def test_rerank_loop_matches_the_reference_rerank_d128(world128, kw):
    """The same at d = 128, the port's rows float32 and (sift-like) the
    shard's uint8."""
    ref_idx, ports, queries, _ = world128
    for index in ports.values():
        _rerank_against_reference(ref_idx, index, queries, RERANK_KW[kw])


def test_luts_are_identical(world):
    """Bit-equal to the reference's LUT builder; within rtol 1e-6 of the
    same builder compiled under jit, where XLA fuses the dsub fold."""
    ref_idx, index, _, queries, _ = world
    build = jax.vmap(build_lut_jnp, in_axes=(0, None))
    got = build_lut_torch(torch.from_numpy(queries), index.pq_centroids)
    want = build(jnp.asarray(queries), ref_idx.pq_centroids)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(build)(
        jnp.asarray(queries), ref_idx.pq_centroids)), rtol=1e-6)


def test_golden_recall(world):
    """The golden is the dense visited set's: on this world the 2^10-slot
    hash set evicts, re-visits and stops at recall@10 0.865625."""
    _, index, _, queries, gt = world
    ids, _, _ = search(index, queries, _port(), device="cpu")
    rec = recall_at_k(ids, gt, 10)
    assert rec >= GOLDEN_RECALL_AT_10, f"recall@10 = {rec}"


def test_batch_invisibility(world):
    """A row of a batched search equals the nq=1 run of that query."""
    _, index, _, queries, _ = world
    p = _port(visited_hash_bits=10)
    ids, dists, stats = search(index, queries, p, device="cpu")
    for qi in [0, 13, 31]:
        i1, d1, s1 = search_one(index, queries[qi], p, device="cpu")
        np.testing.assert_array_equal(ids[qi].numpy(), i1.numpy())
        np.testing.assert_array_equal(dists[qi].numpy(), d1.numpy())
        for name, a, b in zip(stats._fields, stats, s1):
            np.testing.assert_array_equal(a[qi].numpy(), b.numpy(),
                                          err_msg=name)


def test_search_candidates_matches_reference(world):
    ref_idx, index, _, queries, _ = world
    p_ref = ref_beam.SearchParams(**BASE, kernels=JREF)
    want_ids, want_d = ref_beam.search_candidates(ref_idx, queries[:7],
                                                  p_ref)
    got_ids, got_d = search_candidates(index, queries[:7], _port(),
                                       device="cpu")
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6)


def test_search_refuses_an_index_on_another_device(world):
    _, index, _, queries, _ = world
    with pytest.raises(ValueError, match="index lives on"):
        search(index, queries[:2], _port(), device="meta")


def _plain_traverse(index, luts, p):
    """The traversal as a loop of the factored plain round: the kernels'
    plain versions (``round_expand_ref`` with the hash set, ``expand``
    with the dense one), the hop's (``beam_step_ref``) and
    ``round_settle_ref``, until the flag falls."""
    n, nq = index.pq_codes.shape[0], luts.shape[0]
    L, W, bits = p.l_size, p.beam_width, p.visited_hash_bits
    universe = p.universe or n
    rows = torch.arange(nq)
    entry = index.medoid.to(torch.int32).expand(nq).contiguous()
    cand_ids = torch.full((nq, L), -1, dtype=torch.int32)
    cand_ids[:, 0] = entry
    cand_d = torch.full((nq, L), torch.inf)
    cand_d[:, 0] = pq_adc_batched_ref(index.pq_codes, luts,
                                      entry[:, None])[:, 0]
    if bits:
        visited = torch.full((nq, (1 << bits) + 1), -1, dtype=torch.int32)
        visited[rows, sr.hash_slots(entry, bits)] = entry
        expanded = torch.zeros((nq, L), dtype=torch.bool)
    else:
        visited = torch.zeros((nq, n + 1), dtype=torch.bool)
        visited[rows, entry.long()] = True
        expanded = torch.zeros((nq, n + 1), dtype=torch.bool)
    iters, fetched, pq_ct, stab = torch.zeros((4, nq),
                                              dtype=torch.int32).unbind(0)
    pf_iter = torch.full((nq,), -1, dtype=torch.int32)
    prev_top = torch.full((nq, min(p.k + p.rerank_batch, L)), -1,
                          dtype=torch.int32)
    active = sr.unexpanded(cand_ids, expanded, bits > 0).any(1)
    flag = active.any()
    new_ids = torch.empty((nq, W * p.r_max), dtype=torch.int32)
    while bool(flag):
        if bits:
            sr.round_expand_ref(index.ef_slots, p.r_max, universe, cand_ids,
                                cand_d, expanded, active, visited, fetched,
                                pq_ct, flag, new_ids, W, bits)
        else:
            new_ids, _ = sr.expand(
                lambda ids: sr.ef_lists(ef_decode_ref, index.ef_slots,
                                        p.r_max, universe, ids),
                cand_ids, cand_d, expanded, active, visited, fetched, pq_ct,
                W, bits)
        sr.round_settle_ref(
            *beam_step_ref(index.pq_codes, luts, cand_ids, cand_d, new_ids),
            cand_ids, cand_d, expanded, iters, stab, pf_iter, prev_top,
            active, flag, W, p.rerank_batch, p.max_iters, by_slot=bits > 0)
    return cand_ids, cand_d, (iters, fetched, pf_iter, pq_ct + 1)


@pytest.mark.parametrize("bits", [0, 10], ids=["dense", "hashed"])
@pytest.mark.parametrize("nq", [1, 7, 32])
def test_plain_round_matches_the_reference_traversal(world, nq, bits):
    """A loop of the factored plain round equals the reference's
    ``traverse`` on the same LUTs (ids and counters exactly; distances
    to rtol 1e-6, the reference folding its sums inside its loop's
    compiled body), and the port's ``traverse`` on the CPU bit for bit."""
    ref_idx, index, _, queries, _ = world
    kw = dict(visited_hash_bits=bits, trace_fetches=False,
              trace_hints=False)
    p = _port(**kw)
    luts = build_lut_torch(torch.from_numpy(queries[:nq]),
                           index.pq_centroids)
    got = _plain_traverse(index, luts, p)
    want = ref_beam.traverse(
        ref_idx, jnp.asarray(luts.numpy()),
        ref_beam.SearchParams(**{**BASE, **kw}, kernels=JREF))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6)
    for name, a, b in zip(("iters", "fetched", "pf_iter", "pq"), got[2],
                          want[2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    port = beam.traverse(index, luts, p)
    for a, b in zip(got[:2] + got[2], port[:2] + port[2][:4]):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      b.numpy().view(np.int32))


def test_the_fused_round_is_chosen_from_what_traverse_observes(
        world, monkeypatch):
    """The CPU always runs the plain round. On a card (a round that can be
    captured) the round's bookkeeping is the two kernels only with the
    hash set over EF slots, no trace buffers and shapes the kernel library
    says a block holds (``round_expand_fits``, asked with the round's EF
    slot layout; stood in for here, where no library is built)."""
    from repro_torch.core.codec.elias_fano import slot_layout
    _, index, _, queries, _ = world
    n = index.pq_codes.shape[0]
    luts = build_lut_torch(torch.from_numpy(queries[:2]), index.pq_centroids)
    serve = SearchParams(l_size=200, beam_width=4, k=10, rerank_batch=10,
                         r_max=128, universe=31_250_000,
                         visited_hash_bits=15)
    asked, says = [], {"fits": 1}

    def library(name, entry, *args):
        asked.append((name, entry) + args)
        return says["fits"]
    monkeypatch.setattr(sr, "query", library)
    for bits in (0, 15):
        assert not beam._fused(luts, serve._replace(visited_hash_bits=bits),
                               n)
    assert not asked
    on_card = beam._graphable
    monkeypatch.setattr(beam, "_graphable", lambda luts, p: on_card(
        luts.to("meta"), p) or not (p.trace_fetches or p.trace_hints
                                    or p.visited_hash_bits <= 0))
    assert beam._fused(luts, serve, n)
    _, _, hb, words = slot_layout(128, 31_250_000)
    assert asked == [("round_expand", "round_expand_fits", 200, 4, 128,
                      words, hb, 15)]
    assert beam._fused(luts, serve._replace(l_size=1024, beam_width=8), n)
    assert beam._fused(luts, serve._replace(universe=0), n)
    _, _, hb, words = slot_layout(128, n)
    assert asked[-1][2:] == (200, 4, 128, words, hb, 15)
    del asked[:]
    for other in (dict(use_ef=False), dict(visited_hash_bits=0),
                  dict(trace_fetches=True), dict(trace_hints=True)):
        assert not beam._fused(luts, serve._replace(**other), n), other
    assert not asked
    says["fits"] = 0
    for other in ({}, dict(l_size=1025), dict(beam_width=33, r_max=4)):
        assert not beam._fused(luts, serve._replace(**other), n), other
    assert len(asked) == 3


def test_round_span_says_which_round_ran(world):
    """Each ``search.round`` span carries ``fused``: 0 for the plain round,
    which the CPU runs whatever the visited set, and no round kernel
    launches."""
    from torch.profiler import ProfilerActivity, profile
    _, index, _, queries, _ = world
    build.reset_launches()
    for bits in (0, 10):
        p = _port(visited_hash_bits=bits, trace_fetches=False,
                  trace_hints=False)
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            _, _, st = search(index, torch.from_numpy(queries[:5]), p,
                              device="cpu")
        rounds = [ev.kwinputs for ev in prof.events()
                  if ev.name == tracing.PREFIX + "search.round"]
        assert len(rounds) == int(st.iters.max()) > 1
        assert all(r == {"fused": 0} for r in rounds)
    assert build.LAUNCHES["round_expand"] == build.LAUNCHES[
        "round_settle"] == 0


def test_round_kernels_refuse_cpu_tensors_and_shapes_they_do_not_take():
    """The wrappers launch on the card or raise: a CPU tensor, new ids of
    another width, a hash table of another size (a round wider than a block
    is the card test ``test_round_kernels_state_the_shapes_they_take``)."""
    c = ROUND_CASES["world"]
    slots, _, _, state = round_case(**c)
    st = {k: torch.from_numpy(np.array(v))
          for k, v in state.items()}
    new_ids = torch.empty((c["nq"], c["w"] * c["r_max"]), dtype=torch.int32)

    def expand(w=c["w"], bits=c["bits"], visited=st["visited"]):
        sr.round_expand_cuda(torch.from_numpy(slots), c["r_max"],
                             c["universe"], st["cand_ids"], st["cand_d"],
                             st["expanded"], st["active"], visited,
                             st["fetched"], st["pq_ct"], st["flag"],
                             new_ids if w == c["w"] else new_ids[:, :1], w,
                             bits)
    with pytest.raises(ValueError, match="one CUDA device"):
        expand()
    with pytest.raises(ValueError, match="do not fit"):
        expand(w=40)
    with pytest.raises(ValueError, match="do not fit"):
        expand(visited=st["visited"][:, :-1])
    top = (st["cand_ids"], st["cand_d"],
           torch.zeros_like(st["cand_ids"]))
    rest = (st["cand_ids"], st["cand_d"], st["expanded"], st["iters"],
            st["stab"], st["pf_iter"])
    with pytest.raises(ValueError, match="one CUDA device"):
        sr.round_settle_cuda(*top, *rest, st["prev_top"], st["active"],
                             st["flag"], c["w"], 10, 64)
    with pytest.raises(TypeError, match="round_settle takes"):
        sr.round_settle_cuda(top[0], top[1], top[2].long(), *rest,
                             st["prev_top"], st["active"], st["flag"],
                             c["w"], 10, 64)
