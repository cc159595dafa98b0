"""Training launcher: mesh + sharded params + fault-tolerant loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --preset 100m --steps 100 --mesh local [--device cpu]

Runs on the CUDA card unless ``--device`` names another device; without a
card and without ``--device`` it raises. ``--mesh local`` is the world of
the initialised ``torch.distributed`` process group (one device when no
group is initialised: no mesh); ``--mesh pod``/``--mesh multipod`` builds
the production meshes, which need a group of 256 or 512 ranks (one
process a device, each started with its rank). Params are placed by the
sharding policy as they are drawn, and a restart restores onto the
current mesh; init, checkpoint and restore hold one full leaf at a time
(on each rank's device, and on rank 0's host to write it), so the largest
leaf, not the whole state, must fit one card and one host. The loop
wires in checkpoint/restart, heartbeat and straggler bookkeeping from
``repro_torch.ft``: each process drives them with local measurements; a
real deployment feeds the same objects from per-host RPCs.
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

from ..configs import preset_config
from ..data.pipeline import TokenPipeline
from ..ft.checkpoint import latest_step, restore_checkpoint
from ..ft.heartbeat import HeartbeatMonitor
from ..ft.straggler import StragglerMitigator
from ..kernels.dispatch import resolve_device
from ..models import sharding
from ..models.api import Model
from ..optim.adamw import AdamWConfig, init_opt_state
from ..train.trainer import TrainConfig, TrainLoop
from .mesh import make_local_mesh, make_production_mesh, world_size
from .serve import device_name


def build_mesh(kind: str, dev):
    """``local``: the process group's world (None without a group: one
    device); ``pod`` / ``multipod``: the production meshes."""
    import torch.distributed as dist
    if kind == "local":
        return make_local_mesh(device_type=dev.type) \
            if dist.is_initialized() else None
    return make_production_mesh(multi_pod=kind == "multipod",
                                device_type=dev.type)


def mesh_name(mesh) -> str:
    return "local" if mesh is None else str(sharding.axis_sizes(mesh))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="local",
                    choices=["local", "pod", "multipod"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default=None, choices=[None, "full", "dots"])
    ap.add_argument("--ckpt-dir", default=str(
        Path(tempfile.gettempdir()) / "repro_torch_launch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = preset_config(args.arch, args.preset)
    model = Model.from_config(cfg)
    mesh = build_mesh(args.mesh, dev)
    print(f"mesh={mesh_name(mesh)} device={device_name(dev)} arch={cfg.name} "
          f"params={model.n_params() / 1e6:.1f}M")

    monitor = HeartbeatMonitor(n_workers=world_size(), timeout_s=300)
    strag = StragglerMitigator(n_workers=world_size())

    with sharding.policy(mesh, None):
        return _train(args, model, dev, monitor, strag)


def _train(args, model, dev, monitor, strag):
    p_sh = model.param_shardings()
    params = model.init(0, device=dev, shardings=p_sh)
    opt = init_opt_state(params)
    start = latest_step(args.ckpt_dir) or 0
    if start:
        o_sh = {"m": p_sh, "v": p_sh, "master": p_sh, "step": None}
        restored, _ = restore_checkpoint(
            args.ckpt_dir, {"params": params, "opt": opt},
            shardings={"params": p_sh, "opt": o_sh})
        params, opt = restored["params"], restored["opt"]
        print(f"restored checkpoint at step {start}")

    pipe = TokenPipeline(vocab=model.cfg.vocab, global_batch=args.batch,
                         seq_len=args.seq)
    tcfg = TrainConfig(microbatches=args.microbatches, remat=args.remat,
                       attn_mode="dense", total_steps=args.steps)
    loop = TrainLoop(model, AdamWConfig(), tcfg,
                     checkpoint_every=args.ckpt_every,
                     checkpoint_dir=args.ckpt_dir)

    def ft_hook(step, p, o, h):
        for w in monitor.healthy():
            monitor.beat(w)
            strag.record(w, h["sec"] * (1 + 0.01 * w))
        monitor.check()
        plan = strag.plan()
        if step % 10 == 0:
            print(f"step {step:5d} loss {h['loss']:.4f} "
                  f"{h['sec']:.2f}s healthy={len(monitor.healthy())} "
                  f"backups={plan['backups']}")

    batches = (pipe.batch_at(s) for s in range(start, args.steps))
    params, opt, hist = loop.run(params, batches, opt_state=opt,
                                 hooks=[ft_hook], start_step=start)
    if hist:
        print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
