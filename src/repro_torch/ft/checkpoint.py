"""Checkpoint/restart.

Checkpoints are mesh-agnostic: every leaf is written as the full logical
array. Layout, the reference's: <dir>/step_<n>/manifest.json + arrays.npz
(keys are the leaves' paths, ``params/...`` and ``opt/...``), the manifest
published last by an atomic rename, so a checkpoint without it is
incomplete and ignored. Each package reads the other's checkpoints.

bfloat16 leaves: numpy has no bfloat16, so the port writes their bits as
uint16, and the reference's ``np.asarray`` of an ml_dtypes bfloat16 array
lands in the npz as raw 2-byte voids (``|V2``). Restore takes each leaf's
dtype from the template and views either payload as bfloat16, bit for bit.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from ..models.schema import host_bits


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
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


def _leaf(a: np.ndarray, like=None, device=None) -> torch.Tensor:
    """A stored leaf as a tensor of ``like``'s dtype (as stored where
    ``like`` is not a tensor) on ``device`` (None: ``like``'s device, the
    CPU for a meta or non-tensor ``like``). A 2-byte payload (uint16 or
    void) under a bfloat16 ``like`` is viewed, not converted."""
    dtype = like.dtype if isinstance(like, torch.Tensor) else None
    if device is None:
        device = like.device if isinstance(like, torch.Tensor) and \
            like.device.type != "meta" else "cpu"
    a = np.asarray(a, order="C")           # keeps 0-d leaves 0-d
    if dtype == torch.bfloat16 and a.dtype.itemsize == 2 and \
            a.dtype.kind in "uV":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
        if dtype is not None:
            t = t.to(dtype)
    return t.to(device)


def save_checkpoint(ckpt_dir, step: int, params, opt_state=None,
                    extra: dict | None = None) -> Path:
    d = Path(ckpt_dir) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    tree = {"params": params}
    if opt_state is not None:
        tree["opt"] = opt_state
    flat = _flatten(tree)
    np.savez(d / "arrays.npz", **{k: host_bits(v) for k, v in flat.items()})
    manifest = {"step": step, "time": time.time(),
                "keys": sorted(flat), "extra": extra or {}}
    tmp = d / "manifest.json.tmp"
    tmp.write_text(json.dumps(manifest, indent=1))
    tmp.rename(d / "manifest.json")     # atomic publish
    return d


def latest_step(ckpt_dir) -> int | None:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")
             if (p / "manifest.json").exists()]   # only complete checkpoints
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir, template: dict, step: int | None = None,
                       device=None):
    """-> (tree of ``template``'s structure, manifest) of ``step`` (None:
    the latest complete one). Each leaf takes its template leaf's dtype and
    goes to ``device`` (None: the template leaf's device; the CPU where that
    is ``meta`` or the leaf is not a tensor)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    with np.load(d / "arrays.npz") as z:
        flat = {k: (lambda like, k=k: _leaf(z[k], like, device))
                for k in z.files}
        tree = _unflatten_into(template, flat)
    manifest = json.loads((d / "manifest.json").read_text())
    return tree, manifest
