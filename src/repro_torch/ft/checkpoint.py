"""Checkpoint/restart with elastic resharding.

Checkpoints are mesh-agnostic: every leaf is written as the full logical
array. Save goes leaf by leaf: a DTensor leaf is gathered (every rank of
its mesh joins) and only rank 0 takes it to the host and streams it into
the file, so a rank holds one full leaf at a time on its device and rank
0 one on its host. Restore reads one leaf at a time on the host and puts
each rank's own shard of it under the *target* mesh's placements
(``shardings=``) on the device, so the same checkpoint restores onto any
mesh shape (elastic scaling), or onto one device.

Layout, the reference's: <dir>/step_<n>/manifest.json + arrays.npz (keys
are the leaves' paths, ``params/...`` and ``opt/...``), the manifest
published last by an atomic rename, so a checkpoint without it is
incomplete and ignored. Each package reads the other's checkpoints.

bfloat16 leaves: numpy has no bfloat16; both packages store their bits as
raw 2-byte voids (``|V2``, what the reference's ``np.asarray`` of an
ml_dtypes bfloat16 array gives). Restore takes each leaf's dtype from the
template and views a 2-byte payload (``|V2``, or the uint16 of older port
files) as bfloat16, bit for bit, and only under a bfloat16 template.
"""
from __future__ import annotations

import json
import time
import zipfile
from pathlib import Path

import numpy as np
import torch

from ..models import sharding
from ..models.schema import host_bits


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and \
            not isinstance(tree, sharding.NamedSharding):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten_into(template, flat, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        vals = [_unflatten_into(v, flat, f"{prefix}{i}/")
                for i, v in enumerate(template)]
        return type(template)(vals)
    return flat[prefix.rstrip("/")](template)


def _leaf(key: str, a: np.ndarray, like=None, device=None,
          sh=None) -> torch.Tensor:
    """Stored leaf ``key`` as a tensor of ``like``'s dtype (as stored where
    ``like`` is not a tensor) on ``device`` (None: ``like``'s device, the
    CPU for a meta or non-tensor ``like``), placed by ``sh`` where given
    (only this rank's shard leaves the host). A
    2-byte payload (void or uint16) is bfloat16 bits: under a bfloat16
    ``like`` it is viewed, not converted; under any other it raises."""
    dtype = like.dtype if isinstance(like, torch.Tensor) else None
    if device is None:
        device = like.device if isinstance(like, torch.Tensor) and \
            like.device.type != "meta" else "cpu"
    a = np.asarray(a, order="C")           # keeps 0-d leaves 0-d
    if a.dtype.itemsize == 2 and a.dtype.kind in "uV":
        if dtype != torch.bfloat16:
            raise TypeError(f"checkpoint leaf {key!r} holds bfloat16 bits "
                            f"({a.dtype.str}); the template asks for "
                            f"{dtype}")
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
        if dtype is not None:
            t = t.to(dtype)
    return sharding.from_host(t, sh, device)


def save_checkpoint(ckpt_dir, step: int, params, opt_state=None,
                    extra: dict | None = None) -> Path:
    d = Path(ckpt_dir) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    tree = {"params": params}
    if opt_state is not None:
        tree["opt"] = opt_state
    flat = _flatten(tree)
    meshed = any(sharding.is_dtensor(v) for v in flat.values())
    import torch.distributed as dist
    writer = not meshed or dist.get_rank() == 0   # rank 0 writes
    # np.savez's layout (a zip of ``<key>.npy``), one leaf at a time
    z = zipfile.ZipFile(d / "arrays.npz", "w", allowZip64=True) \
        if writer else None
    try:
        for k, v in flat.items():
            full = v.full_tensor() if sharding.is_dtensor(v) else v
            if z is not None:
                with z.open(f"{k}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, host_bits(full))
            del full
    finally:
        if z is not None:
            z.close()
    if writer:
        manifest = {"step": step, "time": time.time(),
                    "keys": sorted(flat), "extra": extra or {}}
        tmp = d / "manifest.json.tmp"
        tmp.write_text(json.dumps(manifest, indent=1))
        tmp.rename(d / "manifest.json")     # atomic publish
    if meshed:
        dist.barrier()
    return d


def latest_step(ckpt_dir) -> int | None:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")
             if (p / "manifest.json").exists()]   # only complete checkpoints
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir, template: dict, step: int | None = None,
                       device=None, shardings=None):
    """-> (tree of ``template``'s structure, manifest) of ``step`` (None:
    the latest complete one). Each leaf takes its template leaf's dtype and
    goes to ``device`` (None: the template leaf's device; the CPU where that
    is ``meta`` or the leaf is not a tensor). ``shardings`` (matching
    ``template``'s structure, ``sharding.NamedSharding`` or None leaves, as
    ``Model.param_shardings`` gives them) places each leaf on the current
    mesh: every rank keeps its own shard of the full array (elastic)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    shs = _flatten(shardings) if shardings is not None else {}
    with np.load(d / "arrays.npz") as z:
        flat = {k: (lambda like, k=k: _leaf(k, z[k], like, device,
                                            shs.get(k)))
                for k in z.files}
        tree = _unflatten_into(template, flat)
    manifest = json.loads((d / "manifest.json").read_text())
    return tree, manifest
