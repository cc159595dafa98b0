"""One rank of the sharding policy's gloo tier, for tests/test_torch_mesh.py:
joins a gloo process group on localhost, builds the (2, 4) ("data",
"model") mesh over it (``make_local_mesh(model_axis=4)``) and runs the
cases the test wrote into ``OUT``:

- ``ownership.json``: [{"shape", "spec"}]: ``np.arange`` of each shape
  distributed by the spec's placements; writes this rank's shards to
  ``own.rank<r>.npz``;
- ``train.json`` + ``train.<arch>.npz``: each arch's params and batches;
  the loss and gradients of the first batch, then ``steps``
  make_train_step steps, under the policy; rank 0 writes them, each
  step's loss and grad norm and the full params after the last step to
  ``train.<arch>.out.npz``; for the archs of ``mb_archs`` the same steps
  again from the same params with 2 microbatches, to
  ``train.<arch>.mb2.out.npz``;
- ``ckpt_unsharded/``: restored under the mesh's placements
  (``restore_checkpoint(shardings=)``); rank 0 writes the restored leaves'
  full arrays to ``restored.npz``, every rank its local shapes to
  ``shapes.rank<r>.json``; then the restored tree is saved to
  ``ckpt_sharded/``; every rank writes to ``init.rank<r>.json`` whether
  each leaf of ``Model.init(shardings=)`` equals the full init's, placed.

    python tests/torch_dtensor_worker.py RANK WORLD PORT OUT

Imports torch and repro_torch only.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.ft.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.launch.dryrun import _rules_for
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import sharding
from repro_torch.models.api import Model
from repro_torch.models.schema import params_from_numpy, tree_leaves, tree_map
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.train.trainer import (TrainConfig, make_train_step,
                                       place_batch, value_and_grad)

MODEL_AXIS = 4
#: The archs of the sharded train step, reduced, with their changes: query
#: heads that divide the model axis (4). internlm2's GQA KV heads (2) do
#: not, so its KV projections replicate over it as ``_rules_for`` rules;
#: rwkv6 runs its recurrence on each rank's heads; deepseek-moe routes
#: each rank's rows and shards its 4 experts over the model axis.
TRAIN_ARCHS = {"internlm2-1.8b": {"n_heads": 4, "n_kv_heads": 2},
               "rwkv6-1.6b": {},
               "deepseek-moe-16b": {"n_heads": 4, "n_kv_heads": 4}}
#: The arch of the elastic restore.
ELASTIC_ARCH = "internlm2-1.8b"


def train_model(arch: str) -> Model:
    return Model.from_config(dataclasses.replace(
        reduce_config(get_config(arch)), **TRAIN_ARCHS[arch]))


def _spec(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def ownership(mesh, out: Path, rank: int) -> None:
    cases = json.loads((out / "ownership.json").read_text())
    local = {}
    for i, case in enumerate(cases):
        full = torch.arange(int(np.prod(case["shape"]))).reshape(
            case["shape"])
        pl = sharding.placements(mesh, _spec(case["spec"]))
        local[f"c{i}"] = sharding.distribute(
            full, sharding.NamedSharding(mesh, pl, None)).to_local().numpy()
    np.savez(out / f"own.rank{rank}.npz", **local)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _flat(tree[k], f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): tree}


def _nest(flat: dict) -> dict:
    tree = {}
    for key, v in flat.items():
        *path, last = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def _run_steps(model, params, batches, spec: dict, tcfg: dict) -> tuple:
    """``make_train_step`` over ``batches`` from ``params`` (DTensors):
    each step's loss and grad norm, and the full params after the last."""
    opt = init_opt_state(params)
    step = make_train_step(model, AdamWConfig(lr=spec["lr"]),
                           TrainConfig(**tcfg))
    rows = {"loss": [], "grad_norm": []}
    for batch in batches:
        params, opt, metrics = step(params, opt, batch)
        rows["loss"].append(float(metrics["loss"]))
        rows["grad_norm"].append(float(metrics["grad_norm"]))
    return rows, params, [t.full_tensor().numpy() for t in tree_leaves(params)]


def train(mesh, out: Path, rank: int, arch: str, spec: dict) -> None:
    data = np.load(out / f"train.{arch}.npz")
    model = train_model(arch)
    params = params_from_numpy(_nest({k[7:]: data[k] for k in data.files
                                      if k.startswith("params/")}), "cpu")
    b, s = data["tokens0"].shape
    rules = _rules_for(model.cfg, ShapeSpec("t", s, b, "train"), mesh)
    runs = {"": spec["tcfg"]}
    if arch in spec["mb_archs"]:
        runs[".mb2"] = dict(spec["tcfg"], microbatches=2)
    with sharding.policy(mesh, rules):
        params = tree_map(lambda t, sh: sharding.distribute(t, sh), params,
                          model.param_shardings())
        batches = [{k: torch.from_numpy(data[f"{k}{i}"]).long()
                    for k in ("tokens", "labels")}
                   for i in range(spec["steps"])]
        loss0, grads = value_and_grad(
            lambda p, b: model.loss(p, b, attn_mode="dense"), params,
            place_batch(batches[0]))
        grads = [g.full_tensor().numpy() for g in tree_leaves(grads)]
        loss0 = float(loss0.full_tensor())
        outs = {tag: _run_steps(model, params, batches, spec, tcfg)
                for tag, tcfg in runs.items()}
    if rank == 0:
        for tag, (rows, last, full) in outs.items():
            keys = list(_flat(last))
            extra = {f"grads/{k}": a for k, a in zip(keys, grads)} \
                if not tag else {}
            np.savez(out / f"train.{arch}{tag}.out.npz",
                     loss=np.asarray(rows["loss"]),
                     grad_norm=np.asarray(rows["grad_norm"]), loss0=loss0,
                     **extra,
                     **{f"params/{k}": a for k, a in zip(keys, full)})


def elastic(mesh, out: Path, rank: int) -> None:
    model = train_model(ELASTIC_ARCH)
    with sharding.policy(mesh, None):
        p_sh = model.param_shardings()
        template = {"params": model.abstract_params()}
        back, _ = restore_checkpoint(out / "ckpt_unsharded", template,
                                     device="cpu",
                                     shardings={"params": p_sh})
        leaves = tree_leaves(back)
        full = [t.full_tensor().numpy() for t in leaves]
        shapes = {k: list(t.to_local().shape)
                  for k, t in _flat(back["params"]).items()}
        save_checkpoint(out / "ckpt_sharded", 1, back["params"])
        # init placed leaf by leaf == the full init, then placed
        drawn = model.init(0, device="cpu", shardings=p_sh)
        placed = tree_map(lambda t, sh: sharding.distribute(t, sh),
                          model.init(0, device="cpu"), p_sh)
        same = [torch.equal(x.to_local(), y.to_local()) and
                x.placements == y.placements
                for x, y in zip(tree_leaves(drawn), tree_leaves(placed))]
    (out / f"shapes.rank{rank}.json").write_text(json.dumps(shapes))
    (out / f"init.rank{rank}.json").write_text(json.dumps(same))
    if rank == 0:
        np.savez(out / "restored.npz",
                 **dict(zip(_flat(back["params"]), full)))


def main(rank: int, world: int, port: int, out: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_local_mesh(model_axis=MODEL_AXIS, device_type="cpu")
        if (out / "ownership.json").exists():
            ownership(mesh, out, rank)
        if (out / "train.json").exists():
            spec = json.loads((out / "train.json").read_text())
            for arch in spec["archs"]:
                train(mesh, out, rank, arch, spec)
        if (out / "ckpt_unsharded").exists():
            elastic(mesh, out, rank)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
         Path(sys.argv[4]))
