"""CPU tier of the port's sharding policy over a ``torch.distributed``
DeviceMesh (``repro_torch.models.sharding``, ``launch/mesh.py``,
``restore_checkpoint(shardings=)``, the trainer under a policy):

- ``_resolve`` against the reference's on a stub mesh (the reference's
  resolves without devices): every schema leaf of the ten archs, both
  production meshes, both rule sets, with and without shapes; the
  placements against the spec they came from;
- row ownership on an 8-rank gloo (2, 4) mesh against the reference's
  ``NamedSharding(...).devices_indices_map`` (8 forced XLA host devices in
  a subprocess, the mesh built with ``jax.sharding.Mesh``): each rank holds
  exactly JAX's slice, a dimension split over both axes included;
- a sharded train step on that mesh (reduced internlm2 with 4 query heads
  over the model axis and 2 replicated KV heads, rwkv6 and deepseek-moe)
  against the reference, within tests/test_torch_train.py's tolerances:
  ``Model.loss`` and every gradient leaf of the first batch against the
  reference's jitted value_and_grad (loss 1e-5 relative, each leaf within
  1e-4 of its largest magnitude), then 3 make_train_step steps against
  its jitted step (loss and grad norm 1e-5 relative, each param leaf
  within 1e-4 of its largest magnitude: Adam's m/sqrt(v) scales the
  sharded sums' last bits up where a gradient is near 0); the same steps
  with 2 microbatches for internlm2 and deepseek-moe;
- an elastic restore: saved unsharded and restored under (2, 4), and
  saved under (2, 4) and restored unsharded, bit for bit; the init placed
  leaf by leaf against the full init;
- ``make_production_mesh`` below 256 / 512 ranks raises, and so do both
  launchers' ``--mesh pod|multipod`` in one process.

The gloo ranks are tests/torch_dtensor_worker.py, spawned once a module.
"""
import json
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.models import sharding as jsharding
from repro.models.api import Model as JModel
from repro.optim import adamw as jadamw
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_train_step as j_make_train_step

from repro_torch.configs import ARCHS, get_config
from repro_torch.ft.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import sharding
from repro_torch.models.api import Model
from repro_torch.models.schema import params_from_numpy, tree_leaves

from test_distributed import _run
from torch_dtensor_worker import ELASTIC_ARCH, MODEL_AXIS, TRAIN_ARCHS
from torch_train_parity import (GRAD_REL, LOSS_RTOL, as_jax,
                                assert_grads_close, jax_loss_and_grads,
                                reference, train_batch)

REPO = Path(__file__).resolve().parents[1]
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
RULES = {"default": "DEFAULT_RULES", "long": "LONG_CONTEXT_RULES"}
GLOO = ((2, MODEL_AXIS), ("data", "model"))
#: Specs of the row-ownership case: one axis, both axes on one dimension
#: (major to minor), the other order of dimensions, uneven-free shapes.
OWNERSHIP = [((8, 12), ["data", "model"]), ((8, 12), ["model", "data"]),
             ((16, 3), [["data", "model"], None]),
             ((4, 8, 6), [None, ["data", "model"], None]),
             ((6, 4), [None, "model"]), ((5, 7), [None, None])]
TRAIN_STEPS = 3
TRAIN_KW = dict(microbatches=1, remat=None, attn_mode="dense", warmup=2,
                total_steps=10)
#: The archs also stepped with 2 microbatches (2 rows each, one a data
#: rank): a dense one, and the MoE one, whose load-balance loss is not
#: linear in a microbatch's tokens, so it sees which rows a microbatch takes.
MB_ARCHS = ["deepseek-moe-16b", "internlm2-1.8b"]


def _leaves_with_keys(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_keys(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _j_spec(p) -> tuple:
    return tuple(tuple(e) if isinstance(e, tuple) else e for e in p)


# ----------------------------------------------------------------- _resolve
@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_resolve_matches_reference(arch, mesh, rules):
    """Every leaf of the arch's schema, without and with its shape: the
    port's spec equals the reference's PartitionSpec entry for entry, and
    the placements put ``Shard(i)`` on exactly the mesh dimensions that
    entry i names."""
    assert set(J_ARCHS) == set(ARCHS)
    sizes, names = MESHES[mesh]
    jmesh = SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))
    tmesh = SimpleNamespace(mesh_dim_names=names, shape=sizes)
    jr, tr = getattr(jsharding, RULES[rules]), getattr(sharding, RULES[rules])
    assert jr == tr
    jleaves = dict(_leaves_with_keys(JModel.from_config(
        j_get_config(arch)).schema))
    tleaves = dict(_leaves_with_keys(Model.from_config(
        get_config(arch)).schema))
    assert jleaves.keys() == tleaves.keys()
    for key, spec in tleaves.items():
        for shape in (None, spec.shape):
            want = _j_spec(jsharding._resolve(jr, jmesh, spec.axes,
                                              shape=shape))
            got = sharding._resolve(tr, tmesh, spec.axes, shape=shape)
            assert got == want, (key, shape)
            pl = sharding.placements(tmesh, got)
            for j, name in enumerate(names):
                dims = [i for i, e in enumerate(got) if e == name or
                        (isinstance(e, tuple) and name in e)]
                want_pl = (torch.distributed.tensor.Shard(dims[0]) if dims
                           else torch.distributed.tensor.Replicate())
                assert len(dims) <= 1 and pl[j] == want_pl, (key, got, pl)


def test_policy_is_a_no_op_without_a_mesh():
    model = Model.from_config(get_config("internlm2-1.8b"))
    assert all(s is None for s in tree_leaves(model.param_shardings()))
    assert all(all(e is None for e in s)
               for s in tree_leaves(model.param_specs()))
    x = torch.ones(2, 3)
    assert sharding.shard(x, "batch", None) is x
    assert sharding.gather_dp({"w": x})["w"] is x


def test_param_specs_under_a_policy_match_reference():
    sizes, names = MESHES["multipod"]
    jmesh = SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))
    tmesh = SimpleNamespace(mesh_dim_names=names, shape=sizes)
    with jsharding.policy(jmesh), sharding.policy(tmesh):
        want = [_j_spec(p) for p in jax.tree_util.tree_leaves(
            JModel.from_config(j_get_config("jamba-v0.1-52b")).param_specs(),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
        got = tree_leaves(Model.from_config(
            get_config("jamba-v0.1-52b")).param_specs())
    assert got == want


# ----------------------------------------------------------- production mesh
@pytest.mark.parametrize("multi_pod,n", [(False, 256), (True, 512)])
def test_production_mesh_needs_its_ranks(multi_pod, n):
    with pytest.raises(RuntimeError, match=f"need {n} devices .*have 1"):
        make_production_mesh(multi_pod=multi_pod, device_type="cpu")


@pytest.mark.parametrize("launcher", ["train", "serve"])
@pytest.mark.parametrize("mesh,n", [("pod", 256), ("multipod", 512)])
def test_launchers_take_the_production_meshes(tmp_path, launcher, mesh, n):
    """``--mesh pod|multipod`` is accepted, and in one process raises with
    the reference's message (``need N devices ...; have 1``)."""
    main = launch_train.main if launcher == "train" else launch_serve.main
    extra = ["--ckpt-dir", str(tmp_path)] if launcher == "train" else []
    with pytest.raises(RuntimeError, match=f"need {n} devices .*have 1"):
        main(["--device", "cpu", "--mesh", mesh, *extra])


# ------------------------------------------------------------------ gloo tier
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _npz_params(np_params) -> dict:
    return {"params/" + "/".join(k): np.asarray(v)
            for k, v in _leaves_with_keys(np_params)}


def _ref(arch):
    return reference(arch, **TRAIN_ARCHS[arch])


def _batches(ref) -> dict:
    out = {}
    for i in range(TRAIN_STEPS):
        b = train_batch(ref.jm.cfg, seed=10 + i, b=4)
        out[f"tokens{i}"], out[f"labels{i}"] = b["tokens"], b["labels"]
    return out


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """The 8 ranks' outputs of every case (ownership, train, elastic)."""
    out = tmp_path_factory.mktemp("dtensor")
    (out / "ownership.json").write_text(json.dumps(
        [{"shape": s, "spec": p} for s, p in OWNERSHIP]))
    for arch in TRAIN_ARCHS:
        ref = _ref(arch)
        np.savez(out / f"train.{arch}.npz", **_batches(ref),
                 **_npz_params(ref.np_params))
    (out / "train.json").write_text(json.dumps(
        {"archs": sorted(TRAIN_ARCHS), "steps": TRAIN_STEPS, "lr": 1e-3,
         "tcfg": TRAIN_KW, "mb_archs": MB_ARCHS}))
    save_checkpoint(out / "ckpt_unsharded", 1,
                    params_from_numpy(_ref(ELASTIC_ARCH).np_params, "cpu"))
    world, port = 8, _free_port()
    env = {"PYTHONPATH": f"{REPO / 'src'}:{REPO / 'tests'}",
           "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_dtensor_worker.py"),
         str(r), str(world), str(port), str(out)],
        env=env, cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs[0][-4000:]
    return out


@pytest.fixture(scope="module")
def jax_ownership():
    """Device r's index slices of every OWNERSHIP case under JAX."""
    return _run(f"""
        import numpy as np, jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        mesh = Mesh(np.array(jax.devices()).reshape({GLOO[0]}), {GLOO[1]})
        result = []
        for shape, spec in {OWNERSHIP!r}:
            spec = [tuple(e) if isinstance(e, list) else e for e in spec]
            m = NamedSharding(mesh, P(*spec)).devices_indices_map(
                tuple(shape))
            result.append({{str(d.id): [[s.start or 0,
                                         s.stop if s.stop is not None
                                         else n]
                                        for s, n in zip(idx, shape)]
                            for d, idx in m.items()}})
    """, devices=8)


def test_row_ownership_matches_jax(gloo, jax_ownership):
    for r in range(8):
        local = np.load(gloo / f"own.rank{r}.npz")
        for i, (shape, _) in enumerate(OWNERSHIP):
            full = np.arange(int(np.prod(shape))).reshape(shape)
            want = full[tuple(slice(a, b) for a, b in
                              jax_ownership[i][str(r)])]
            np.testing.assert_array_equal(local[f"c{i}"], want,
                                          err_msg=f"rank {r} case {i}")


def _hold_steps_against_reference(ref, data, got, kw) -> None:
    """``got``'s TRAIN_STEPS steps against the reference's jitted step
    under ``kw``: loss and grad norm each step, every param leaf after."""
    jstep = jax.jit(j_make_train_step(ref.jm, jadamw.AdamWConfig(lr=1e-3),
                                      JTrainConfig(**kw)))
    jp, js = ref.jp, jadamw.init_opt_state(ref.jp)
    for i in range(TRAIN_STEPS):
        batch = {"tokens": data[f"tokens{i}"], "labels": data[f"labels{i}"]}
        jp, js, jm = jstep(jp, js, as_jax(batch))
        np.testing.assert_allclose(got["loss"][i], float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"][i],
                                   float(jm["grad_norm"]), rtol=1e-5)
    want = _npz_params(jax.tree_util.tree_map(np.asarray, jp))
    assert sorted(want) == sorted(k for k in got.files
                                  if k.startswith("params/"))
    assert_grads_close([want[k] for k in sorted(want)],
                       [got[k] for k in sorted(want)], rel=GRAD_REL)


@pytest.mark.parametrize("arch", sorted(TRAIN_ARCHS))
def test_sharded_train_step_matches_reference(gloo, arch):
    ref = _ref(arch)
    data = np.load(gloo / f"train.{arch}.npz")
    got = np.load(gloo / f"train.{arch}.out.npz")
    batch0 = {"tokens": data["tokens0"], "labels": data["labels0"]}
    want_loss, want_grads = jax_loss_and_grads(ref, batch0,
                                               attn_mode="dense")
    np.testing.assert_allclose(float(got["loss0"]), want_loss,
                               rtol=LOSS_RTOL)
    keys = sorted(k for k in got.files if k.startswith("grads/"))
    assert_grads_close(want_grads, [got[k] for k in keys], rel=GRAD_REL)
    _hold_steps_against_reference(ref, data, got, TRAIN_KW)


@pytest.mark.parametrize("arch", MB_ARCHS)
def test_sharded_microbatched_train_step_matches_reference(gloo, arch):
    """2 microbatches on the (2, 4) mesh: each takes contiguous global rows,
    as the reference's split does, and its rows are then placed over the
    data ranks; the steps equal the reference's jitted 2-microbatch step
    within the same tolerances."""
    _hold_steps_against_reference(
        _ref(arch), np.load(gloo / f"train.{arch}.npz"),
        np.load(gloo / f"train.{arch}.mb2.out.npz"),
        dict(TRAIN_KW, microbatches=2))


def test_elastic_restore_unsharded_checkpoint_onto_the_mesh(gloo):
    """Saved on one device, restored under (2, 4): every leaf's full array
    is the saved one bit for bit, and each rank holds its placement's
    shard (here rank 0's and 7's local shapes)."""
    ref = _ref(ELASTIC_ARCH)
    got = np.load(gloo / "restored.npz")
    want = {k[len("params/"):]: v for k, v in
            _npz_params(ref.np_params).items()}
    assert set(got.files) == set(want)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    model = Model.from_config(ref.tm.cfg)
    sizes, names = GLOO
    tmesh = SimpleNamespace(mesh_dim_names=names, shape=sizes)
    for r in (0, 7):
        shapes = json.loads((gloo / f"shapes.rank{r}.json").read_text())
        for key, spec in _leaves_with_keys(model.schema):
            pl = sharding.placements(tmesh, sharding._resolve(
                sharding.DEFAULT_RULES, tmesh, spec.axes, shape=spec.shape))
            want_shape = list(spec.shape)
            for n, p in zip(sizes, pl):
                if isinstance(p, torch.distributed.tensor.Shard):
                    want_shape[p.dim] //= n
            assert shapes["/".join(key)] == want_shape, key


def test_sharded_init_matches_full_init(gloo):
    """``Model.init(shardings=)`` places each leaf as it is drawn: on every
    rank of the (2, 4) mesh each leaf's shard and placements equal those of
    the full init, placed afterwards."""
    for r in range(8):
        same = json.loads((gloo / f"init.rank{r}.json").read_text())
        assert same and all(same), r


def test_elastic_restore_mesh_checkpoint_onto_one_device(gloo):
    """Saved under (2, 4) (the full arrays, written by rank 0), restored
    on one device bit for bit."""
    params = params_from_numpy(_ref(ELASTIC_ARCH).np_params, "cpu")
    back, manifest = restore_checkpoint(gloo / "ckpt_sharded",
                                        {"params": params})
    assert manifest["step"] == 1
    for a, b in zip(tree_leaves(back), tree_leaves({"params": params})):
        assert a.dtype == b.dtype and torch.equal(a, b)
