"""Logical-axis sharding policy over a ``torch.distributed`` DeviceMesh.

Model code annotates tensors with *logical* axes ("batch", "seq", "heads",
"embed", "ffn", "vocab", "expert", ...). A policy maps logical axes to mesh
axes; when no policy is active (one device) every annotation is a no-op,
so the same model code runs everywhere.

Default production rules:
  batch  -> ("pod", "data")      # DP over pods x data axis
  heads/ffn/vocab/expert -> "model"   # TP / EP
  embed  -> "data"               # FSDP/ZeRO weight dimension
  seq    -> None (or "data" for batch<dp long-context cells)

A spec is the reference's ``PartitionSpec`` as a tuple: per tensor
dimension ``None``, one mesh axis name, or a tuple of names (the dimension
split over those axes, major to minor). DTensor places per *mesh*
dimension, so :func:`placements` turns a spec around: mesh dimension j
gets ``Shard(i)`` where tensor dimension i maps to axis j, else
``Replicate()``. DTensor shards a tensor dimension that several mesh
dimensions split left to right over the mesh, which is JAX's major-to-minor
order when the axes of an entry are in mesh order (every rule here is).
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch

_state = threading.local()


DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": "data",
    "expert_embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "vocab": "model",
    "expert": "model",
    "kv_seq": None,
    "kv_hd": None,
    "layers": None,
    "head_dim": None,
    "state": None,
    "conv": None,
    "unsharded": None,
}

LONG_CONTEXT_RULES = dict(DEFAULT_RULES, seq=("pod", "data"), batch=None,
                          kv_seq=("pod", "data"))


class NamedSharding(NamedTuple):
    """Where a tensor lives under the policy: the mesh, one placement per
    mesh dimension, and the spec they came from."""
    mesh: object
    placements: tuple
    spec: tuple


def set_policy(mesh, rules: dict | None = None) -> None:
    _state.mesh = mesh
    _state.rules = dict(DEFAULT_RULES, **(rules or {})) if mesh else None


def get_policy():
    return getattr(_state, "mesh", None), getattr(_state, "rules", None)


@contextlib.contextmanager
def policy(mesh, rules: dict | None = None):
    old = get_policy()
    set_policy(mesh, rules)
    try:
        yield
    finally:
        set_policy(*old)


def is_dtensor(t) -> bool:
    """A DTensor (without importing ``torch.distributed.tensor``)."""
    return hasattr(t, "device_mesh")


def axis_sizes(mesh) -> dict:
    """{axis name: extent} of a DeviceMesh (``mesh_dim_names``, ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _resolve(rules: dict, mesh, logical_axes, shape=None) -> tuple:
    """The spec of ``logical_axes`` under ``rules`` on ``mesh``: the
    reference's rule for rule. A mesh axis maps at most one tensor
    dimension (``used``); axes the mesh lacks are skipped; with ``shape``,
    a dimension that does not divide by its axes' extent stays whole."""
    sizes = axis_sizes(mesh)
    parts = []
    used = set()
    for i, ax in enumerate(logical_axes):
        m = rules.get(ax, None) if ax is not None else None
        if m is None:
            parts.append(None)
            continue
        ms = tuple(a for a in ((m,) if isinstance(m, str) else m)
                   if a in sizes and a not in used)
        if shape is not None and ms:
            ext = 1
            for a in ms:
                ext *= sizes[a]
            if shape[i] % ext != 0:
                ms = ()
        used.update(ms)
        parts.append(ms if len(ms) > 1 else (ms[0] if ms else None))
    return tuple(parts)


def placements(mesh, spec) -> tuple:
    """A spec as DTensor placements, one per mesh dimension. A mesh
    dimension of extent 1 replicates (its one shard is the whole: DTensor
    would refuse to reshape a dimension "sharded" over it)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {names}")
        for j in dims:
            if sizes[names[j]] > 1:
                out[j] = Shard(i)
    return tuple(out)


def spec(*logical_axes) -> tuple:
    """The spec of the active policy (all ``None`` when inactive)."""
    mesh, rules = get_policy()
    if mesh is None:
        return (None,) * len(logical_axes)
    return _resolve(rules, mesh, logical_axes)


def _sharding(shape, logical_axes):
    mesh, rules = get_policy()
    if mesh is None:
        return None
    s = _resolve(rules, mesh, logical_axes, shape=shape)
    return NamedSharding(mesh, placements(mesh, s), s)


def sharding_for(*logical_axes) -> NamedSharding | None:
    """Mesh and placements of the active policy (None without one)."""
    return _sharding(None, logical_axes)


def sharding_for_shape(shape, *logical_axes) -> NamedSharding | None:
    """Like ``sharding_for``, but a dimension that does not divide by its
    axes' extent stays whole."""
    return _sharding(tuple(shape), logical_axes)


class _Constrain(torch.autograd.Function):
    """x and its gradient both redistributed to ``placements``: a sharding
    constraint holds in both directions, as JAX's does on the cotangent
    (without it, DTensor's backward carries partial sums through the
    residual stream and repeats the matmuls on every model rank)."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x.redistribute(mesh, placements).view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements), None, None


def shard(x, *logical_axes):
    """Annotate an intermediate with its logical sharding: a no-op without
    a policy or on a plain tensor; a DTensor and its gradient are
    redistributed to the resolved placements (the counterpart of
    ``with_sharding_constraint``)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    sh = sharding_for_shape(x.shape, *logical_axes)
    if sh is None:
        return x
    return _Constrain.apply(x, sh.mesh, sh.placements)


DP_AXES = ("pod", "data")


def gather_dp(tree):
    """Weights as a layer computes with them: each DTensor leaf gathered
    over the data-parallel axes (the ZeRO/FSDP all-gather; its backward
    reduce-scatters the gradient), its model-axis shards kept. Plain
    tensors are returned as they are. DTensor places each op on its own,
    so without the gather it may shard a matmul's contraction over data
    and repeat the work on every model rank."""
    from torch.distributed.tensor import DTensor, Replicate

    def leaf(t):
        if not isinstance(t, DTensor):
            return t
        names = t.device_mesh.mesh_dim_names
        want = tuple(Replicate() if n in DP_AXES else p
                     for n, p in zip(names, t.placements))
        return t if want == tuple(t.placements) else \
            t.redistribute(t.device_mesh, want)

    if isinstance(tree, dict):
        return {k: gather_dp(v) for k, v in tree.items()}
    return leaf(tree)


def distribute(t: torch.Tensor, sh: NamedSharding | None):
    """A full tensor placed by ``sh`` (unchanged for None). Every rank
    holds the same full tensor and keeps its own shard of it: no
    communication (``src_data_rank=None``)."""
    if sh is None:
        return t
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sh.mesh, sh.placements, src_data_rank=None)


def from_host(t: torch.Tensor, sh: NamedSharding | None, device):
    """A full tensor ``t`` (on the host) placed by ``sh`` on ``device``:
    only this rank's own shard is copied there, the part DTensor gives it
    (each mesh dimension in turn, major to minor, splits a dimension
    evenly). A split that does not divide goes through ``distribute``
    whole. Without ``sh``, ``t`` on ``device``."""
    if sh is None:
        return t.to(device)
    from torch.distributed.tensor import DTensor
    coord = sh.mesh.get_coordinate()
    size, off = list(t.shape), [0] * t.dim()
    for m, p in enumerate(sh.placements):
        if p.is_shard():
            n = sh.mesh.size(m)
            if size[p.dim] % n:
                return distribute(t.to(device), sh)
            size[p.dim] //= n
            off[p.dim] += coord[m] * size[p.dim]
    part = t[tuple(slice(o, o + n) for o, n in zip(off, size))]
    local = torch.empty(size, dtype=t.dtype, device=device).copy_(part)
    return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False,
                              shape=t.shape,
                              stride=torch.empty(t.shape,
                                                 device="meta").stride())
