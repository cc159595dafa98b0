"""Port parity tier for the merges of a sharded search
(``repro_torch.core.distributed.sharded_index``: ``make_sharded_search``,
``merge_sharded``, ``merge_comm_rows``): the reference's ``shard_map``
program against the port's two forms on the same index.

The reference runs in one subprocess with 32 XLA host devices forced
before its import (as tests/test_sharded.py does), on the same
cluster-like world (960 x 16, 12 queries), and hands its stacked index,
router centroids and merged rows over as numpy. Then:

- the stacked form (all S shards on the CPU) at S in {8, 16, 32}: hier ==
  flat bit for bit, ids identical to the reference's, distances within
  rtol 1e-6, routed at 1.0 == unrouted; a (2, 4) mesh against the
  reference's 2-axis mesh; S = 6, which takes the flat merge on its one
  axis;
- the process-group form over gloo, one process a shard, at 8 ranks (1-D
  and (2, 4)) and 6 ranks: equal to the stacked form bit for bit.
"""
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.distributed import sharded_index as jsharded
from repro.core.search.engine import shard_merge_cost_us as j_merge_cost

from repro_torch.core.distributed.sharded_index import (
    ShardRouter, build_router, make_mesh, make_sharded_search,
    merge_comm_rows, merge_sharded, place_on_mesh, route_mask,
    sharded_index_from_numpy, shard_topk, _lex_topk)
from repro_torch.core.search.engine import shard_merge_cost_us

from test_distributed import _run
from torch_mesh_worker import FIELDS, params

REPO = Path(__file__).resolve().parents[1]
#: case -> (axis sizes, axis names); the 1-D power-of-two cases also route
CASES = {"s8": ((8,), ("data",)), "s16": ((16,), ("data",)),
         "s32": ((32,), ("data",)), "pod2x4": ((2, 4), ("pod", "data")),
         "s6": ((6,), ("data",))}
ROUTED = ("s8", "s16", "s32")


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    """The reference's index and merged rows of every case, one npz each."""
    out = tmp_path_factory.mktemp("mesh")
    _run(f"""
        import numpy as np, jax
        from repro.core.distributed import (build_router,
                                            build_sharded_index,
                                            make_sharded_search,
                                            place_on_mesh)
        from repro.core.search.beam import SearchParams
        from repro.data.synthetic import make_vector_dataset
        vecs = make_vector_dataset("cluster-like", 960, 16,
                                   seed=0).astype(np.float32)
        rng = np.random.default_rng(1)
        qid = rng.choice(len(vecs), size=12, replace=False)
        queries = (vecs[qid] + 0.001).astype(np.float32)
        for name, (sizes, names) in {CASES!r}.items():
            S = int(np.prod(sizes))
            mesh = jax.make_mesh(sizes, names, devices=jax.devices()[:S])
            axis = names if len(names) > 1 else names[0]
            index, per = build_sharded_index(vecs, S, r=16, l_build=32,
                                             pq_m=4, partition="cluster")
            placed = place_on_mesh(index, mesh, axis)
            p = SearchParams(l_size=32, beam_width=4, k=5, rerank_batch=5,
                             r_max=16, universe=per, max_iters=64)
            out = {{f: np.asarray(getattr(index, f))
                    for f in index._fields}}
            for merge in ("hier", "flat"):
                ids, d = make_sharded_search(mesh, p, axis=axis,
                                             merge=merge)(placed, queries)
                out[merge + "_ids"], out[merge + "_d"] = ids, d
            if name in {ROUTED!r}:
                router = build_router(index, c=4)
                ids, d = make_sharded_search(
                    mesh, p, axis=axis, merge="hier", router=router,
                    route_frac=1.0)(placed, queries)
                out["routed_ids"], out["routed_d"] = ids, d
                out["centroids"] = router.centroids
            np.savez("{out}/" + name + ".npz", per=per, queries=queries,
                     axis_sizes=np.array(sizes), axis_names=np.array(names),
                     **{{k: np.asarray(v) for k, v in out.items()}})
        result = {{}}
    """, devices=32)
    return out


def load(ref_dir, case):
    data = np.load(ref_dir / f"{case}.npz")
    index = sharded_index_from_numpy({f: data[f] for f in FIELDS}, "cpu")
    return data, index


def stacked(data, index, **kw):
    """The stacked form's rows on the CPU."""
    sizes = tuple(int(s) for s in data["axis_sizes"])
    names = tuple(str(n) for n in data["axis_names"])
    mesh = make_mesh(sizes, names, device="cpu")
    ids, d = make_sharded_search(mesh, params(int(data["per"])), **kw)(
        place_on_mesh(index, mesh), data["queries"])
    return ids.numpy(), d.numpy()


def assert_bits(a, b):
    """Two (ids, dists) pairs equal bit for bit."""
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(np.asarray(a[1]).view(np.int32),
                                  np.asarray(b[1]).view(np.int32))


def assert_reference(got, data, mode):
    np.testing.assert_array_equal(got[0], data[f"{mode}_ids"])
    np.testing.assert_allclose(got[1], data[f"{mode}_d"], rtol=1e-6)


# ------------------------------------------------------------ stacked form
@pytest.mark.parametrize("case", ROUTED)
def test_stacked_merge_matches_reference(ref_dir, case):
    """S in {8, 16, 32}: hier == flat bit for bit, both equal the
    reference's rows; the port's router equals the reference's and routing
    at 1.0 is the unrouted search bit for bit; at 0.5 every returned id
    lies in one of its query's routed shards."""
    data, index = load(ref_dir, case)
    assert_bits((data["hier_ids"], data["hier_d"]),
                (data["flat_ids"], data["flat_d"]))
    hier, flat = stacked(data, index), stacked(data, index, merge="flat")
    assert_bits(hier, flat)
    assert_reference(hier, data, "hier")
    assert_reference(flat, data, "flat")
    router = build_router(index, c=4)
    np.testing.assert_array_equal(router.centroids.numpy(),
                                  data["centroids"])
    routed = stacked(data, index, router=router, route_frac=1.0)
    assert_bits(routed, hier)
    assert_reference(routed, data, "routed")
    ids, _ = stacked(data, index, router=router, route_frac=0.5)
    mask = route_mask(router.centroids, data["queries"], 0.5).numpy()
    shard_of = {int(g): s for s, row in enumerate(data["row_ids"])
                for g in row if g >= 0}
    for qi, row in enumerate(ids):
        assert all(mask[qi, shard_of[int(g)]] for g in row if g >= 0), qi
    assert int(ids.max()) >= 960 // 2          # late shards contribute


def test_stacked_two_axis_mesh_matches_reference(ref_dir):
    """A (pod 2, data 4) mesh, data merged first: hier == flat, both equal
    the reference's 2-axis shard_map rows."""
    data, index = load(ref_dir, "pod2x4")
    hier, flat = stacked(data, index), stacked(data, index, merge="flat")
    assert_bits(hier, flat)
    assert_reference(hier, data, "hier")
    assert_reference(flat, data, "flat")


def test_non_power_of_two_axis_takes_the_flat_merge(ref_dir):
    """S = 6: the hierarchical request gathers flat on that axis (6 rows of
    K received, not a butterfly), so hier == flat == the reference."""
    data, index = load(ref_dir, "s6")
    hier, flat = stacked(data, index), stacked(data, index, merge="flat")
    assert_bits(hier, flat)
    assert_reference(hier, data, "hier")
    assert merge_comm_rows(5, [6], "hier") == merge_comm_rows(5, [6], "flat")


def test_merge_equals_a_host_merge_of_the_shards(ref_dir):
    """The merged rows are the (distance, id) top-K of every shard's own
    rows (shard_topk), merged on the host."""
    data, index = load(ref_dir, "s32")
    p = params(int(data["per"]))
    gids, d = shard_topk(index, torch.from_numpy(data["queries"]), p)
    ids, dists = stacked(data, index)
    cand_i = gids.permute(1, 0, 2).reshape(len(ids), -1).numpy()
    cand_d = d.permute(1, 0, 2).reshape(len(ids), -1).numpy()
    for qi in range(len(ids)):
        key = np.where(cand_i[qi] < 0, np.iinfo(np.int32).max, cand_i[qi])
        order = np.lexsort((key, cand_d[qi]))[:p.k]
        np.testing.assert_array_equal(ids[qi], cand_i[qi][order])
        np.testing.assert_array_equal(dists[qi], cand_d[qi][order])
    mesh = make_mesh((32,), device="cpu")
    assert_bits(merge_sharded(gids, d, mesh, p.k), (ids, dists))


def test_lex_topk_matches_reference():
    """The tie-break every merge stage shares: (distance, id) order with
    -1 last, on rows full of equal distances and pad rows."""
    rng = np.random.default_rng(3)
    ids = rng.integers(-1, 50, (64, 40)).astype(np.int32)
    d = rng.integers(0, 6, (64, 40)).astype(np.float32)
    d[ids < 0] = np.inf
    want = jsharded._lex_topk(ids, d, 10)
    got = _lex_topk(torch.from_numpy(ids), torch.from_numpy(d), 10)
    assert_bits((got[0].numpy(), got[1].numpy()),
                tuple(np.asarray(x) for x in want))


# ---------------------------------------------------------- process groups
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world,cases", [(8, ("s8", "pod2x4")),
                                         (6, ("s6",))],
                         ids=["8-ranks", "6-ranks"])
def test_process_group_form_equals_stacked(ref_dir, tmp_path, world, cases):
    """The gloo form, one process a shard (8 ranks as a 1-D and a (2, 4)
    mesh; 6 ranks): every rank returns the stacked form's rows bit for bit,
    hier, flat and (1-D 8) routed at 0.5."""
    port = free_port()
    files = [str(ref_dir / f"{c}.npz") for c in cases]
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_mesh_worker.py"),
         str(r), str(world), str(port), str(tmp_path), *files],
        env=env, cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    for case in cases:
        data, index = load(ref_dir, case)
        want = {"hier": stacked(data, index),
                "flat": stacked(data, index, merge="flat")}
        if "centroids" in data:
            want["routed"] = stacked(
                data, index, route_frac=0.5,
                router=ShardRouter(torch.from_numpy(data["centroids"])))
        for r in range(world):
            got = np.load(tmp_path / f"{case}.rank{r}.npz")
            assert sorted(k[:-4] for k in got if k.endswith("_ids")) == \
                sorted(want)
            for mode, rows in want.items():
                assert_bits((got[f"{mode}_ids"], got[f"{mode}_d"]), rows)


# ------------------------------------------------------------- units, API
def test_merge_comm_rows_and_cost():
    """The comm model and its pricing, as tests/test_sharded.py holds them,
    and equal to the reference's on every mesh of up to three axes."""
    k = 10
    for s in (8, 16, 32):
        hier = merge_comm_rows(k, [s], "hier")
        flat = merge_comm_rows(k, [s], "flat")
        assert hier == k * int(np.log2(s))
        assert flat == k * s
        assert hier < flat
        assert shard_merge_cost_us(64, [s], "hier") \
            < shard_merge_cost_us(64, [s], "flat")
    assert shard_merge_cost_us(k, [32], "hier") \
        < shard_merge_cost_us(k, [32], "flat")
    assert shard_merge_cost_us(k, [8], "flat") \
        < shard_merge_cost_us(k, [8], "hier")
    assert merge_comm_rows(k, [6], "hier") == k * 6
    with pytest.raises(ValueError):
        shard_merge_cost_us(k, [8], "nope")
    for sizes in ([1], [2], [6], [8], [2, 4], [3, 4], [2, 2, 8], 32):
        for mode in ("hier", "flat"):
            assert merge_comm_rows(k, sizes, mode) == \
                jsharded.merge_comm_rows(k, sizes, mode)
            assert shard_merge_cost_us(k, sizes, mode) == \
                j_merge_cost(k, sizes, mode)


def test_sharded_search_rejects_what_it_cannot_run(ref_dir):
    data, index = load(ref_dir, "s8")
    mesh = make_mesh((8,), device="cpu")
    p = params(int(data["per"]))
    with pytest.raises(ValueError, match="merge"):
        make_sharded_search(mesh, p, merge="tree")
    with pytest.raises(ValueError, match="place_on_mesh"):
        make_sharded_search(make_mesh((4,), device="cpu"), p)(
            index, data["queries"])
    with pytest.raises(ValueError, match="sizes"):
        make_mesh((2, 4), ("data",), device="cpu")
    from repro_torch.core.distributed.sharded_index import make_process_mesh
    with pytest.raises(RuntimeError, match="process group"):
        make_process_mesh((8,), device="cpu")
