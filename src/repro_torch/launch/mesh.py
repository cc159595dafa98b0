"""Production meshes over ``torch.distributed``: a ``DeviceMesh`` over the
initialised default process group.

Single pod: 16x16 = 256 ranks ("data", "model"); multi-pod: 2x16x16 = 512
ranks ("pod", "data", "model"), over the group's first 256 or 512 ranks.
A function, not a module-level constant, so importing this module touches
no process group. The dry-run (``launch/dryrun.py``) builds the same
shapes on the ``fake`` backend in one process.
"""
from __future__ import annotations

import math

import torch


def world_size() -> int:
    """Ranks of the default process group; 1 (this process) without one."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(device_type: str, shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = world_size()
    if have < n:
        raise RuntimeError(
            f"need {n} devices (a process group of {n} ranks; the dry-run "
            f"uses the fake backend); have {have}")
    return _mesh(device_type, shape, axes)


def make_local_mesh(model_axis: int = 1, device_type: str = "cuda"):
    """Mesh over the initialised process group's world (tests / single
    host), ``model_axis`` ranks wide."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"world size {n}")
    return _mesh(device_type, (n // model_axis, model_axis),
                 ("data", "model"))


def dp_size(mesh) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n = 1
    for a in ("pod", "data"):
        n *= sizes.get(a, 1)
    return n
