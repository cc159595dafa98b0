"""Int8 error-feedback gradient compression for a data-parallel all-reduce.

Each device quantizes its gradient block to int8 with one fp32 scale
before the sum over devices, which cuts the collective's bytes 4x (fp32)
or 2x (bf16); the quantization error is kept in a residual and added back
the next step (error feedback), so the scheme is unbiased over time.

It runs over the port's ``Mesh`` (``core/distributed/sharded_index.py``)
in either form: stacked, where a leaf's leading axis is split into one
block a device, all on one device; or one block a rank of a
``torch.distributed`` group. The sum over devices runs in coordinate
order, so both forms give the same bits. The trainer does not use it.
"""
from __future__ import annotations

import math

import torch

from ..core.distributed.sharded_index import (Mesh, _GroupExchange,
                                              _StackedExchange)
from ..models.schema import tree_map


def quantize_int8(x):
    """One block -> (int8 q, fp32 scale): ``max|x| * (1/127) + 1e-12``,
    q = round-half-even(x / scale) clipped to [-127, 127]. The reference
    writes ``/ 127.0``; XLA compiles that division by a constant as a
    multiply by its float32 reciprocal, which is what the reference's
    jitted all-reduce runs, so the port multiplies (its eager call can
    differ from the compiled one in the scale's last bit)."""
    q, scale = _quantize_rows(x.reshape(1, -1))
    return q.reshape(x.shape), scale.reshape(())


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def _quantize_rows(blocks):
    """``quantize_int8`` of each row of [n, k] blocks at once."""
    scale = blocks.abs().amax(1, keepdim=True) * (1.0 / 127.0) + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _residual(x, q, scale):
    """x - q * scale rounded once, as the reference's compiled program
    computes it (XLA fuses it into one FMA). float64 holds it exactly: q *
    scale needs 31 bits, and where q != 0, |x - q * scale| <= scale / 2
    keeps x and the product within a few binades of each other."""
    return (x.double() - q.double() * scale.double()).float()


def _exchange(mesh: Mesh):
    return _StackedExchange(mesh.axis_sizes, mesh.device) \
        if mesh.groups is None else _GroupExchange(mesh)


def compressed_psum_tree(grads, residual, mesh: Mesh, axis_names=("data",)):
    """Error-feedback int8 mean of a gradient tree over the devices that
    differ only along the mesh's ``axis_names`` -> (mean grads, new
    residual), both shaped as the inputs. Stacked form: a leaf's leading
    axis is the device axis, [S * k, ...], device s (row-major over the
    mesh's axes) holding rows s*k..(s+1)*k (the reference's ``P("data")``
    layout on a 1-D mesh). Process-group form: each rank's leaf is its
    block."""
    axes = [mesh.axis_names.index(a) for a in axis_names]
    n_dev = math.prod(mesh.axis_sizes[a] for a in axes)
    n_blocks = mesh.n_shards if mesh.groups is None else 1
    ex = _exchange(mesh)

    def one(g, r):
        g = g.to(torch.float32) + r
        blocks = g.reshape(n_blocks, -1)
        q, scale = _quantize_rows(blocks)
        deq = dequantize_int8(q, scale)
        new_r = _residual(blocks, q, scale)       # error feedback
        tot = deq
        for a in axes:                            # coordinate order
            parts = ex.all_gather(tot, a)         # [n_blocks, size_a, k]
            tot = parts[:, 0]
            for j in range(1, parts.shape[1]):
                tot = tot + parts[:, j]
        return (tot / n_dev).reshape(g.shape), new_r.reshape(g.shape)

    pairs = tree_map(one, grads, residual)
    return (tree_map(lambda p: p[0], pairs),
            tree_map(lambda p: p[1], pairs))


def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def make_compressed_allreduce(mesh: Mesh, axis_names=("data",)):
    """``fn(tree, residual) -> (mean tree, new residual)`` over ``mesh``."""
    def fn(tree, residual):
        return compressed_psum_tree(tree, residual, mesh, tuple(axis_names))
    return fn
