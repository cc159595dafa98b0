"""Port parity tier for the offline build: synthetic data, PQ, Vamana, the
EF slot codecs and the device index of ``repro_torch`` against the JAX
reference, byte for byte on the same seeds; plus the package's import
boundary and its default device."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import decouplevs_ann as ref_cfg
from repro.core import index as ref_index
from repro.core.codec import bitpack as ref_bitpack
from repro.core.codec import elias_fano as ref_ef
from repro.core.graph import vamana as ref_vamana
from repro.data import synthetic as ref_synth

from repro_torch.configs import decouplevs_ann as cfg
from repro_torch.core import index
from repro_torch.core.codec import bitpack, elias_fano
from repro_torch.core.graph import pq, vamana
from repro_torch.core.distributed import sharded_index
from repro_torch.core.search import beam
from repro_torch.core.update import consistency, fresh
from repro_torch.serve import admission, ann
from repro_torch.data import synthetic
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models.api import Model
from repro_torch.models.schema import params_from_numpy
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.rag import RAGPipeline

from conftest import build_search_world


@pytest.fixture(scope="module")
def world():
    vecs, idx, graph, cb, queries, gt = build_search_world()
    return vecs, idx, graph, cb, queries


def _arrays(ref_idx):
    return {k: np.asarray(v) for k, v in ref_idx._asdict().items()}


@pytest.mark.parametrize("kind", ["sift-like", "spacev-like", "prop-like",
                                  "cluster-like"])
def test_synthetic_data_is_byte_identical(kind):
    a = synthetic.make_vector_dataset(kind, 700, 24, seed=3)
    b = ref_synth.make_vector_dataset(kind, 700, 24, seed=3)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    qa, qb = (m.make_queries(kind, 9, 24) for m in (synthetic, ref_synth))
    assert qa.tobytes() == qb.tobytes()
    np.testing.assert_array_equal(
        synthetic.ground_truth(a.astype(np.float32), qa.astype(np.float32), 5),
        ref_synth.ground_truth(b.astype(np.float32), qb.astype(np.float32), 5))


def test_sift_like_torch_draws_the_sift_distribution():
    """The on-device generator is seeded and keeps the sift-like profile:
    uint8, mostly small values, per-dimension scales in [1.5, 12]."""
    a = synthetic.sift_like_torch(20_000, 16, seed=4, device="cpu", chunk=7000)
    b = synthetic.sift_like_torch(20_000, 16, seed=4, device="cpu", chunk=7000)
    assert a.dtype == torch.uint8 and torch.equal(a, b)
    ref = ref_synth.make_vector_dataset("sift-like", 20_000, 16, seed=4)
    for x in (a.numpy(), ref):
        # E[Gamma(0.6) * s] = 0.6 s, s in [1.5, 12], less the truncation
        means = x.astype(np.float64).mean(0)
        assert 0.3 < means.min() and means.max() < 0.6 * 12
        assert 0.2 < (x == 0).mean() < 0.5


def test_config_matches_reference():
    assert dataclasses.asdict(cfg.CONFIG) == dataclasses.asdict(
        ref_cfg.CONFIG)
    assert dataclasses.asdict(cfg.smoke_config()) == dataclasses.asdict(
        ref_cfg.smoke_config())


def test_pq_codebook_and_codes_are_byte_identical(world):
    vecs, idx, _, cb, _ = world
    mine = pq.train_pq(vecs, m=8, seed=0)
    assert mine.centroids.tobytes() == cb.centroids.tobytes()
    codes = pq.encode_pq(vecs, mine)
    assert codes.tobytes() == np.asarray(idx.pq_codes).tobytes()
    on_torch = pq.encode_pq_torch(torch.from_numpy(vecs),
                                  torch.from_numpy(mine.centroids), chunk=500)
    assert on_torch.numpy().tobytes() == codes.tobytes()


def test_vamana_graph_is_identical():
    vecs = synthetic.make_vector_dataset("prop-like", 300, 16, seed=1)
    mine = vamana.build_vamana(vecs, r=12, l_build=24, seed=1)
    ref = ref_vamana.build_vamana(vecs, r=12, l_build=24, seed=1)
    assert mine.medoid == ref.medoid and mine.r == ref.r
    for a, b in zip(mine.adjacency, ref.adjacency):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(mine.to_padded(), ref.to_padded()):
        np.testing.assert_array_equal(a, b)


def test_build_device_index_matches_reference():
    vecs = synthetic.make_vector_dataset("prop-like", 260, 16, seed=2)
    mine, graph, cb = index.build_device_index(vecs, r=10, l_build=20,
                                               pq_m=4, seed=2, device="cpu")
    ref, _, _ = ref_index.build_device_index(vecs, r=10, l_build=20, pq_m=4,
                                             seed=2)
    _assert_same_index(mine, _arrays(ref))


def _assert_same_index(mine, arrays):
    for name, got in mine._asdict().items():
        want = arrays.get(name)
        if want is None or np.ndim(want) == 0 and want.dtype == object:
            assert got is None
            continue
        got = got.numpy()
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.dtype == want.dtype or name in ("medoid",), name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_device_index_from_numpy_round_trips(world):
    _, idx, graph, cb, _ = world
    arrays = _arrays(idx)
    mine = index.device_index_from_numpy(arrays, "cpu")
    assert mine.ef_slots.dtype == torch.int32 and mine.tombstone is None
    _assert_same_index(mine, arrays)
    back = {k: (None if v is None else v.numpy())
            for k, v in mine._asdict().items()}
    back["ef_slots"] = back["ef_slots"].view(np.uint32)
    _assert_same_index(index.device_index_from_numpy(back, "cpu"), arrays)
    from_graph = index.device_index_from_artifacts(
        np.asarray(idx.vectors), graph, cb, np.asarray(idx.pq_codes), "cpu")
    _assert_same_index(from_graph, arrays)
    tomb = np.zeros(len(arrays["counts"]), bool)
    tomb[::7] = True
    live = index.device_index_from_numpy({**arrays, "tombstone": tomb},
                                         "cpu")
    np.testing.assert_array_equal(live.tombstone.numpy(), tomb)


def test_ef_slots_are_byte_identical(world):
    _, idx, graph, _, _ = world
    slots = index.ef_slots_from_graph(graph)
    assert slots.tobytes() == np.asarray(idx.ef_slots).tobytes()
    nbrs, counts = graph.to_padded()
    batched = elias_fano.encode_slots_torch(torch.from_numpy(nbrs),
                                            torch.from_numpy(counts), 24,
                                            1200, chunk=500)
    assert batched.numpy().view(np.uint32).tobytes() == slots.tobytes()


@pytest.mark.parametrize("r_max,universe",
                         [(8, 64), (16, 1000), (24, 10**5), (32, 10**6),
                          (1, 2), (128, 31_250_000)])
def test_batched_encoder_equals_encode_slot_loop(r_max, universe):
    """Padded, unsorted rows with empty and full lists -> the same bytes as
    ``encode_slot(np.sort(row[:count]))`` of the reference, row by row."""
    rng = np.random.default_rng(r_max)
    lens = np.array([0, 1, r_max, r_max // 2, min(13, r_max), 0, r_max])
    nbrs = np.full((len(lens), r_max), -1, np.int64)
    for i, ln in enumerate(lens):
        nbrs[i, :ln] = rng.choice(universe, size=ln, replace=False)
    got = elias_fano.encode_slots_torch(torch.from_numpy(nbrs),
                                        torch.from_numpy(lens), r_max,
                                        universe, chunk=3)
    want = np.stack([ref_ef.encode_slot(np.sort(row[:ln]).astype(np.uint64),
                                        r_max, universe)
                     for row, ln in zip(nbrs, lens)])
    assert got.numpy().view(np.uint32).tobytes() == want.tobytes()
    for row, ln, slot in zip(nbrs, lens, want):
        np.testing.assert_array_equal(
            elias_fano.decode_slot_np(slot, r_max, universe),
            np.sort(row[:ln]).astype(np.uint64))
    with pytest.raises(ValueError, match="counts"):
        elias_fano.encode_slots_torch(torch.from_numpy(nbrs),
                                      torch.from_numpy(lens + 1), r_max,
                                      universe)


def test_copied_codecs_match_reference():
    rng = np.random.default_rng(0)
    for width in (1, 7, 18, 32):
        vals = rng.integers(0, 2 ** width, 77, dtype=np.uint64)
        words = bitpack.pack_fixed(vals, width, bit_offset=5)
        assert words.tobytes() == ref_bitpack.pack_fixed(
            vals, width, bit_offset=5).tobytes()
        np.testing.assert_array_equal(
            bitpack.unpack_fixed_np(words, 77, width, bit_offset=5), vals)
        got = bitpack.unpack_fixed_torch(
            torch.from_numpy(words.view(np.int32)), 77, width, bit_offset=5)
        want = ref_bitpack.unpack_fixed_jnp(words, 77, width, bit_offset=5)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for r_max, universe in ((24, 1200), (128, 31_250_000)):
        assert elias_fano.slot_layout(r_max, universe) == \
            ref_ef.slot_layout(r_max, universe)


def test_verify_index_slots(world):
    _, idx, _, _, _ = world
    arrays = _arrays(idx)
    mine = index.device_index_from_numpy(arrays, "cpu")
    assert index.verify_index_slots(mine, 24, 1200)
    bad = arrays["ef_slots"].copy()
    bad[5, 2] ^= 1 << 3                       # one low bit of list 5
    broken = index.device_index_from_numpy({**arrays, "ef_slots": bad}, "cpu")
    assert not index.verify_index_slots(broken, 24, 1200)


def test_recall_at_k_matches_reference():
    rng = np.random.default_rng(0)
    pred, gt = rng.integers(0, 50, (9, 10)), rng.integers(0, 50, (9, 10))
    assert index.recall_at_k(torch.from_numpy(pred), gt, 10) == \
        ref_index.recall_at_k(pred, gt, 10)


def test_package_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "assert len(mods) >= 20, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep))}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_default_to_the_card(world):
    """Without a device argument every entry point asks for CUDA and, with
    no card present, raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    vecs, idx, _, _, queries = world
    arrays = _arrays(idx)
    on_cpu = index.device_index_from_numpy(arrays, "cpu")
    lm = Model.from_config(reduce_config(get_config("internlm2-1.8b")))
    lm_params = lm.init(0, device="cpu")
    p = beam.SearchParams(l_size=16, r_max=24, universe=1200, max_iters=4)
    snap = consistency.Snapshot(version=0, index_store=None,
                                vector_store=None, pq_codes=None,
                                mem_rows={7: vecs[7]},
                                device=on_cpu._replace(
                                    tombstone=torch.zeros(1200, dtype=bool)))
    calls = [
        lambda: index.build_device_index(vecs[:50], r=8, l_build=8, pq_m=4),
        lambda: index.device_index_from_numpy(arrays),
        lambda: beam.search(on_cpu, queries[:2], p),
        lambda: beam.search_batched(on_cpu, queries[:2], p),
        lambda: beam.search_one(on_cpu, queries[0], p),
        lambda: beam.search_candidates(on_cpu, queries[:2], p),
        lambda: beam.search_vmapped(on_cpu, queries[:2], p),
        lambda: ann.BatchedSearcher(on_cpu, p),
        lambda: sharded_index.build_sharded_index(vecs[:60], 2, r=8,
                                                  l_build=8, pq_m=4),
        lambda: sharded_index.sharded_index_from_numpy(
            {k: np.stack([v, v]) for k, v in arrays.items()
             if k != "tombstone"} | {"row_ids": np.zeros((2, 1200))}),
        lambda: consistency.build_device_view(
            [np.array([1]), np.array([0])], 0, arrays["pq_codes"][:2],
            arrays["pq_centroids"], lambda i: vecs[i], 32, r_max=24,
            universe=1200),
        lambda: consistency.memtable_topk(snap, queries[:2], 5),
        lambda: fresh.snapshot_search(snap, queries[:2], p),
        lambda: fresh.StreamingIndex(
            [np.array([1]), np.array([0])], 0, None, arrays["pq_codes"][:2],
            pq.PQCodebook(arrays["pq_centroids"], 32),
            fresh.UpdateConfig(r=24)),
        lambda: sharded_index.make_mesh(8),
        lambda: admission.calibrate_service_model(
            ann.BatchedSearcher(on_cpu, p), queries[:2]),
        lambda: lm.init(0),
        lambda: params_from_numpy({"w": np.zeros(2, np.float32)}),
        lambda: ServeEngine(lm, lm_params),
        lambda: RAGPipeline(ServeEngine(lm, lm_params),
                            doc_tokens=np.zeros((4, 3), np.int32)),
        lambda: launch_serve.main(["--requests", "1", "--max-new", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
