"""Declarative parameter schemas: one source of truth per architecture for
shapes, logical sharding axes and init scales.

From a schema we derive (a) random init on a device from a
``torch.Generator``, (b) abstract params (``meta`` tensors, no allocation),
(c) each leaf's placement under the active sharding policy and (d) the
parameter count. Params are nested dicts of tensors with the
reference's keys and its stacked ``[n_periods, ...]`` leaves, so a
reference pytree carries over leaf by leaf (``params_from_numpy``,
``opt_state_from_numpy``) and back (``to_numpy``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.dispatch import resolve_device
from . import sharding


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                 # logical axes, len == len(shape)
    init: str = "normal"        # normal | zeros | ones | a_log
    scale: float | None = None  # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (keys in sorted order, as
    ``jax.tree_util`` flattens them); ``rest`` are trees of the same
    structure whose leaves are passed alongside."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(template, leaves) -> dict:
    """A tree of ``template``'s structure holding ``leaves`` in
    ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def unstack(tree) -> list:
    """The trees of a stacked tree's leading axis: one ``unbind`` a leaf,
    whose backward is one ``stack`` (indexing ``t[i]`` instead would fill
    and add into a zero tensor of the whole leaf for every slice)."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    n = len(tree_leaves(parts)[0])
    return [tree_map(lambda ts: ts[i], parts) for i in range(n)]


def init_params(schema, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, shardings=None) -> dict:
    """Random params on ``generator``'s device: ``normal`` leaves are
    N(0, 1) * scale (1/sqrt(fan_in) unless given), ``zeros``/``ones``
    constant, ``a_log`` the S4/Mamba row log(1..d_state). The reference's
    formulas; the draws are the generator's, not ``jax.random``'s.
    ``shardings`` (``param_shardings``'s tree) places each leaf as soon as
    it is drawn: a rank holds its own shards and one full leaf at a time,
    the same values as the full init's."""
    dev = generator.device

    def init(spec: ParamSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        if spec.init == "a_log":
            row = torch.log(torch.arange(1, spec.shape[-1] + 1,
                                         dtype=torch.float32, device=dev))
            return row.expand(spec.shape).to(dtype).contiguous()
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = spec.scale if spec.scale is not None else fan_in ** -0.5
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return x.mul_(scale).to(dtype)

    if shardings is None:
        return tree_map(init, schema)
    return tree_map(lambda spec, sh: sharding.distribute(init(spec), sh),
                    schema, shardings)


def abstract_params(schema, dtype: torch.dtype = torch.float32) -> dict:
    """``meta`` tensors of every leaf's shape and dtype (nothing allocated)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), schema)


def param_shardings(schema):
    """Tree of ``sharding.NamedSharding`` (None when no policy is active)."""
    return tree_map(lambda s: sharding.sharding_for_shape(s.shape, *s.axes),
                    schema)


def param_specs(schema):
    """Tree of specs (a tuple an axis) under the active policy."""
    return tree_map(lambda s: sharding.spec(*s.axes), schema)


def count_params(schema) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(schema))


def _tensor(a: np.ndarray, device, dtype) -> torch.Tensor:
    a = np.asarray(a, order="C")           # keeps 0-d leaves 0-d
    if not a.flags.writeable:               # jax hands out read-only views
        a = a.copy()
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, device=None, dtype: torch.dtype | None = None
                      ) -> dict:
    """A reference param (or cache) pytree, its leaves as numpy arrays, as
    tensors on ``device`` (None = the card), cast to ``dtype`` if given."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(np.asarray(a), dev, dtype), tree)


def opt_state_from_numpy(state, device=None) -> dict:
    """The reference's optimizer state (``{"m", "v", "master", "step"}``,
    numpy leaves) as the port's: fp32 trees and an int32 step on
    ``device`` (None = the card)."""
    if set(state) != {"m", "v", "master", "step"}:
        raise ValueError(f"not an optimizer state: keys {sorted(state)}")
    out = params_from_numpy({k: state[k] for k in ("m", "v", "master")},
                            device, torch.float32)
    out["step"] = params_from_numpy(np.asarray(state["step"]), device,
                                    torch.int32)
    return out


def host_bits(t) -> np.ndarray:
    """A tensor as a host numpy array (a DTensor as its full logical
    array, which every rank of its mesh must ask for); bfloat16 as raw
    2-byte voids (``|V2``), the bytes the reference's ``np.asarray`` of an
    ml_dtypes bfloat16 array stores (numpy has no bfloat16). Anything else
    through ``np.asarray``."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    if sharding.is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def to_numpy(tree):
    """The reverse of ``params_from_numpy``: a tree of tensors as host
    numpy arrays, bfloat16 leaves as ``ml_dtypes.bfloat16`` arrays (the
    dtype JAX uses; ml_dtypes is imported only for them)."""
    def leaf(t):
        a = host_bits(t)
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            a = a.view(ml_dtypes.bfloat16)
        return a
    return tree_map(leaf, tree)
