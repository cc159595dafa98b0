"""CPU tier of the port's dry-run (``repro_torch.launch.{dryrun, roofline,
summarize, inject_tables}``, ``lower_production_search``):

- ``RooflineTerms`` and ``combine`` math (the reference's
  test_dryrun::test_roofline_terms_math at the H100's rates);
- ``active_params`` and ``optimizer_analytic_terms`` equal the reference's
  for the ten archs;
- the ``decouplevs-ann`` cell: each rank's tensors have the reference's
  per-shard shapes and bytes at 256 and 512 shards (the reference lowered
  in a subprocess with 512 forced XLA host devices; the port's medoid is
  int64 where the reference's is int32);
- a small LM cell traced on a fake (2, 4) mesh in this process: the train
  step's per-rank FLOPs within 10% of 6·N·D / 8, the collectives this
  module's counter sees equal CommDebugMode's, the per-layer split sums
  to the total; prefill and decode trace and communicate;
- ``python -m repro_torch.launch.dryrun --arch decouplevs-ann
  --both-meshes`` writes its JSON (fake group of 512 ranks), and
  ``summarize`` tables it with the LM cell; ``inject_tables`` fills the
  markers of a document.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.launch import roofline as jroofline
from repro.models.api import Model as JModel

from repro_torch.configs import ARCHS, get_config, reduce_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun, inject_tables, roofline, summarize
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.api import Model
from repro_torch.train.trainer import TrainConfig

from test_distributed import _run

REPO = Path(__file__).resolve().parents[1]
WORLD = 8


def _reference_optimizer_terms(n):
    """The reference dryrun module sets XLA_FLAGS when imported: keep the
    environment of later subprocesses as it was."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import optimizer_analytic_terms
        return optimizer_analytic_terms(n)
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


# ------------------------------------------------------------------ roofline
def test_roofline_terms_math():
    r = roofline.H100_DATASHEET
    assert (r.flops_per_s, r.bytes_per_s, r.link_bytes_per_s) == \
        (989e12, 3.35e12, 450e9)
    t = roofline.RooflineTerms(flops=989e12, bytes_accessed=3.35e12,
                               coll_bytes=450e9)
    assert abs(t.compute_s - 1.0) < 1e-9
    assert abs(t.memory_s - 1.0) < 1e-9
    assert abs(t.collective_s - 1.0) < 1e-9
    assert t.step_time_s == 1.0
    assert abs(t.roofline_fraction(989e12) - 1.0) < 1e-9
    c = roofline.combine([(t, 2.0), (t, 1.0)])
    assert abs(c.flops - 3 * 989e12) < 1
    measured = roofline.Rates(500e12, 2e12, 100e9, "measured")
    m = roofline.RooflineTerms(1e12, 4e9, 1e9, rates=measured)
    assert (m.compute_s, m.memory_s, m.collective_s) == (2e-3, 2e-3, 1e-2)
    assert m.dominant == "collective" and m.as_dict()["rates"] == "measured"


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_active_params_match_reference(arch):
    want = jroofline.active_params(JModel.from_config(j_get_config(arch)))
    assert roofline.active_params(Model.from_config(get_config(arch))) == \
        want
    assert roofline.model_flops(want, 1024, "train") == \
        jroofline.model_flops(want, 1024, "train")


def test_optimizer_analytic_terms_match_reference():
    n = Model.from_config(get_config("internlm2-1.8b")).n_params() / 256
    want = _reference_optimizer_terms(n)
    got = dryrun.optimizer_analytic_terms(n)
    assert (got.flops, got.bytes_accessed, got.coll_bytes) == \
        (want.flops, want.bytes_accessed, want.coll_bytes)


# ------------------------------------------------------------------ ANN cell
@pytest.fixture(scope="module")
def ref_ann():
    """The reference's lowered arguments at 256 and 512 shards."""
    return _run("""
        import numpy as np, jax
        from jax.sharding import Mesh
        from repro.configs.decouplevs_ann import CONFIG
        from repro.core.distributed.sharded_index import \\
            lower_production_search
        result = {}
        for shape, axes in (((16, 16), ("data", "model")),
                            ((2, 16, 16), ("pod", "data", "model"))):
            n = int(np.prod(shape))
            mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)
            args = lower_production_search(mesh, CONFIG).args_info[0]
            result[str(n)] = [[list(a.shape), str(a.dtype)]
                              for a in jax.tree_util.tree_leaves(args)]
    """, devices=512)


FIELDS = ("neighbors", "counts", "ef_slots", "pq_codes", "pq_centroids",
          "vectors", "medoid", "row_ids", "queries")


@pytest.mark.parametrize("multi_pod,n", [(False, 256), (True, 512)])
def test_ann_cell_matches_reference(ref_ann, multi_pod, n):
    from types import SimpleNamespace
    from repro_torch.configs.decouplevs_ann import CONFIG
    from repro_torch.core.distributed.sharded_index import \
        lower_production_search
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    got = lower_production_search(
        SimpleNamespace(mesh_dim_names=axes, shape=shape), CONFIG)
    assert got["n_shards"] == n
    width = {"int32": 4, "uint32": 4, "uint8": 1, "float32": 4,
             "int64": 8}
    for field, (gshape, dtype) in zip(FIELDS, ref_ann[str(n)]):
        t = got["tensors"][field]
        # the reference's global arrays hold one shard a device
        want = gshape if field == "queries" else [1] + gshape[1:]
        assert t["shape"] == want, field
        if field == "medoid":
            assert (dtype, t["dtype"]) == ("int32", "int64")
            continue
        assert t["bytes"] == int(np.prod(want)) * width[dtype], field
    # ~1.7 GB at 256 shards and ~0.84 GB at 512 (69 / 65 slot words)
    assert got["slot_words"] == (65 if multi_pod else 69)
    per = got["per_shard"]
    assert got["total_bytes"] == per * (4 + 4 * got["slot_words"] + 32
                                        + 128 + 4) + 128 * 4 + 8 \
        + 32 * 256 * 4 * 4 + 1024 * 128 * 4
    assert got["merge_comm_rows"] == (90 if multi_pod else 80)


# ------------------------------------------------------------------- LM cell
@pytest.fixture(scope="module")
def fake_mesh():
    """A fake process group of 8 ranks in this process, and its (2, 4)
    mesh; destroyed after the module."""
    import torch.distributed as dist
    dryrun.init_fake_world(WORLD)
    try:
        yield make_local_mesh(model_axis=4, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _small_model() -> Model:
    """Four dense layers wide enough that the layers' params dominate the
    stem (6ND counts neither the embedding nor the head)."""
    cfg = dataclasses.replace(
        reduce_config(get_config("internlm2-1.8b"), d_model=256), n_heads=4,
        n_kv_heads=4, head_dim=64, d_ff=1024, n_layers=4, vocab=256)
    return Model.from_config(cfg)


@pytest.fixture(scope="module")
def lm_cell(fake_mesh):
    model = _small_model()
    shape = ShapeSpec("t", 64, 16, "train")
    rules = dryrun._rules_for(model.cfg, shape, fake_mesh)
    cell = dryrun.lm_cell(model, shape, fake_mesh, rules,
                          tcfg=TrainConfig(remat=None, attn_mode="dense"))
    return model, shape, cell


def test_small_lm_cell_flops_near_6nd(lm_cell):
    model, shape, cell = lm_cell
    c = cell["counts"]
    six_nd = 6 * roofline.active_params(model) * 16 * 64 / WORLD
    assert cell["model_flops_per_device"] == six_nd
    assert abs(c["flops"] / six_nd - 1) < 0.10, c["flops"] / six_nd
    kinds = {"all_gather_into_tensor": "all-gather",
             "all_reduce": "all-reduce",
             "reduce_scatter_tensor": "reduce-scatter"}
    assert c["coll_counts"] == {kinds[k]: v for k, v in
                                c["comm_debug_counts"].items()}
    assert sum(c["coll_breakdown"].values()) > 0
    assert abs(sum(v["flops"] for v in c["by_scope"].values())
               - c["flops"]) < 1
    assert c["by_scope"]["layer:attn/swiglu"]["flops"] > 0.9 * c["flops"]
    assert c["by_scope"]["optimizer"]["bytes"] > 0
    assert c["peak_bytes"] > 0
    r = cell["roofline"]
    assert r["step_time_s"] == max(r["compute_s"], r["memory_s"],
                                   r["collective_s"])


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_small_lm_serve_programs_trace(fake_mesh, kind):
    model = _small_model()
    shape = ShapeSpec(kind, 64, 16, kind)
    rules = dryrun._rules_for(model.cfg, shape, fake_mesh)
    counts = dryrun.trace_program(model, shape, fake_mesh, rules)
    assert counts["flops"] > 0 and counts["bytes"] > 0
    assert sum(counts["coll_breakdown"].values()) > 0, \
        f"{kind}: a sharded program must communicate"


def test_dryrun_cli_and_summarize(tmp_path, lm_cell):
    out = tmp_path / "dr"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "decouplevs-ann", "--both-meshes", "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    for mesh in ("pod16x16", "pod2x16x16"):
        cell = json.loads((out / f"decouplevs-ann__search__{mesh}.json"
                           ).read_text())
        assert cell["mesh"] == mesh and cell["total_bytes"] > 0.8e9
    model, shape, cell = lm_cell
    dryrun.write_cell(dict(cell, arch="small", shape="t", mesh="pod16x16"),
                      out)
    trace = summarize.trace_table(out)
    assert "| decouplevs-ann | search |" in trace and "| small | t |" in trace
    roof = summarize.roofline_table("pod16x16", out)
    assert "| small | t |" in roof and "decouplevs-ann" not in roof
    doc = ("# x\n<!--DRYRUN_TABLE-->\nold\n<!--ROOFLINE_TABLE-->\nold\n"
           "## next\n")
    got = inject_tables.inject(doc, {inject_tables.MARKERS[0]: trace,
                                     inject_tables.MARKERS[1]: roof})
    assert "old" not in got and got.endswith("## next\n")
    assert got.index(trace) < got.index(roof)
    again = inject_tables.inject(got, {inject_tables.MARKERS[0]: trace,
                                       inject_tables.MARKERS[1]: roof})
    assert again == got
