"""The remat modes of the port's LM training path: ``remat`` None /
"full" / "dots" (per layer) and ``remat_group`` (a checkpoint around each
run of g periods) change what backward keeps, not what it computes. On the
CPU every mode gives plain autograd's loss and gradients bit for bit, and
the reference's under the same mode within tests/torch_train_parity.py's
bounds. Also: which matmuls the "dots" policy keeps, and how the stacked
period leaves reach autograd.
"""
import numpy as np
import pytest
import torch

from repro_torch.models.schema import tree_leaves

from torch_train_parity import (LOSS_RTOL, assert_grads_close,
                                jax_loss_and_grads, port_params, reference,
                                torch_loss_and_grads, train_batch)


REMATS = {"full": dict(remat="full"), "dots": dict(remat="dots"),
          "group2": dict(remat_group=2),
          "group2-full": dict(remat="full", remat_group=2)}


@pytest.mark.parametrize("remat", sorted(REMATS))
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-moe-16b",
                                  "rwkv6-1.6b", "seamless-m4t-medium"])
def test_remat_keeps_loss_and_grads(arch, remat):
    """Each remat mode (and a checkpoint around each 2 periods of 4) gives
    plain autograd's loss and gradients bit for bit, and the reference's
    under the same mode within the stated bounds."""
    cfg = reference(arch).jm.cfg
    changes = {} if cfg.encoder_layers else {"n_layers": len(cfg.head) + 4 *
                                             len(cfg.period) + len(cfg.tail)}
    ref = reference(arch, **changes)
    batch = train_batch(ref.jm.cfg, seed=5)
    kw = dict(attn_mode="dense", **REMATS[remat])
    plain, pg = torch_loss_and_grads(ref.tm, port_params(ref), batch,
                                     attn_mode="dense")
    got, tg = torch_loss_and_grads(ref.tm, port_params(ref), batch, **kw)
    assert got == plain
    for a, b in zip(pg, tg):
        np.testing.assert_array_equal(a, b)
    if not cfg.encoder_layers:
        assert ref.tm.cfg.n_periods == 4
    want, jg = jax_loss_and_grads(ref, batch, **kw)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert_grads_close(jg, tg)


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(remat):
    ref = reference("internlm2-1.8b")
    params = port_params(ref)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    batch = {k: torch.from_numpy(v).long()
             for k, v in train_batch(ref.jm.cfg).items()}
    loss = ref.tm.loss(params, batch, attn_mode="dense", remat=remat)
    with _CountOps() as ops:
        torch.autograd.grad(loss, leaves)
    aten = torch.ops.aten
    return {name: ops.counts.get(op, 0) for name, op in
            (("mm", aten.mm.default), ("bmm", aten.bmm.default))}


def test_dots_policy_saves_only_matmuls_without_batch_dims():
    """Counted in backward: "full" recomputes the layer's matmuls, "dots"
    keeps the outputs of its 2-D matmuls (aten.mm: no more mm than plain
    autograd) and recomputes the batched ones (attention's aten.bmm)."""
    plain, full, dots = (_backward_ops(r) for r in (None, "full", "dots"))
    assert full["mm"] > plain["mm"] and full["bmm"] > plain["bmm"]
    assert dots["mm"] == plain["mm"]
    assert dots["bmm"] > plain["bmm"]


def test_period_leaves_reach_autograd_through_one_unbind():
    """Each stacked period leaf feeds the graph through one ``unbind``
    (whose backward is one stack), never through a slice ``t[i]`` a period
    (whose backward fills and adds a zero tensor of the whole leaf)."""
    ref = reference("internlm2-1.8b", n_layers=4)
    params = port_params(ref)
    stacked = {id(t) for t in tree_leaves(params["period"])}
    for t in tree_leaves(params):
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v).long()
             for k, v in train_batch(ref.jm.cfg).items()}
    loss = ref.tm.loss(params, batch, attn_mode="dense")
    feeders, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            var = getattr(nxt, "variable", None)
            if var is not None and id(var) in stacked:
                feeders.setdefault(id(var), []).append(node.name())
            todo.append(nxt)
    assert set(feeders) == stacked
    for names in feeders.values():
        assert names == ["UnbindBackward0"], names
