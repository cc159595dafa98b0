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

from repro_torch.core.index import device_index_from_numpy, recall_at_k
from repro_torch.core.search.beam import (SearchParams, search,
                                          search_candidates, search_one)
from repro_torch.core.graph.pq import build_lut_torch
from repro_torch.kernels.dispatch import KernelConfig

from conftest import build_search_world

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


def _port(beam_step, **kw):
    return SearchParams(**{**BASE, **kw},
                        kernels=KernelConfig(beam_step=beam_step))


def assert_same_search(got, want):
    ids, dists, stats = got
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(dists.numpy(), np.asarray(want[1]), rtol=1e-6)
    assert stats._fields == want[2]._fields
    for name, a, b in zip(stats._fields, stats, want[2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


@pytest.mark.parametrize("bits", [0, 10], ids=["dense", "hashed"])
@pytest.mark.parametrize("beam_step", ["auto", "off"],
                         ids=["fused", "unfused"])
@pytest.mark.parametrize("nq", [1, 7, 32])
def test_search_matches_reference(world, jax_runs, nq, beam_step, bits):
    _, index, _, queries, _ = world
    got = search(index, queries[:nq], _port(beam_step,
                                            visited_hash_bits=bits),
                 device="cpu")
    assert_same_search(got, jax_runs(nq, visited_hash_bits=bits))


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
@pytest.mark.parametrize("beam_step", ["auto", "off"],
                         ids=["fused", "unfused"])
@pytest.mark.parametrize("nq", [7, 32])
def test_search_matches_reference_d128(world128, nq, beam_step, bits):
    ref_idx, ports, queries, runs = world128
    if (nq, bits) not in runs:
        p = ref_beam.SearchParams(**{**BASE, "visited_hash_bits": bits},
                                  kernels=JREF)
        runs[nq, bits] = ref_beam.search(ref_idx, queries[:nq], p)
    for index in ports.values():
        got = search(index, queries[:nq], _port(beam_step,
                                                visited_hash_bits=bits),
                     device="cpu")
        assert_same_search(got, runs[nq, bits])


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
        assert_same_search(search(index, queries[:7], _port("auto", **kw),
                                  device="cpu"), want)


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


@pytest.mark.parametrize("beam_step", ["auto", "off"])
def test_golden_recall(world, beam_step):
    _, index, _, queries, gt = world
    ids, _, _ = search(index, queries, _port(beam_step), device="cpu")
    rec = recall_at_k(ids, gt, 10)
    assert rec >= GOLDEN_RECALL_AT_10, f"recall@10 = {rec}"


def test_batch_invisibility(world):
    """A row of a batched search equals the nq=1 run of that query."""
    _, index, _, queries, _ = world
    p = _port("auto", visited_hash_bits=10)
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
    got_ids, got_d = search_candidates(index, queries[:7], _port("auto"),
                                       device="cpu")
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6)


def test_search_refuses_an_index_on_another_device(world):
    _, index, _, queries, _ = world
    with pytest.raises(ValueError, match="index lives on"):
        search(index, queries[:2], _port("auto"), device="meta")
