"""CPU parity of the port's LM training forward and backward with the JAX
reference: the two cross-entropy losses, and ``Model.loss`` of the ten
reduced archs with every gradient leaf (``jax.value_and_grad`` against
``torch.autograd.grad``). Inputs come from numpy
seeds and the reference's own ``init``; its params reach the port through
``params_from_numpy``.

Tolerances (float32): the losses rtol 1e-5; every gradient leaf within
1e-4 of that leaf's largest reference magnitude (``GRAD_REL``; the worst
arch measured 6.0e-06). bfloat16 (the dense and RWKV archs): per-arch
limits at ~1.2x the measured gaps (``BF16_LIMITS``). The remat modes are
held in tests/test_torch_remat.py.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import ARCHS
from repro.models import layers as jl

from repro_torch.models import layers as tl

from torch_train_parity import (LOSS_RTOL, assert_grads_close,
                                jax_loss_and_grads, port_params, reference,
                                torch_loss_and_grads, train_batch)


# ------------------------------------------------------------------ losses
def _loss_case(seed, b=2, s=13, d=16, v=40):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    head = (rng.normal(size=(d, v)) * 0.5).astype(np.float32)
    labels = rng.integers(0, v, size=(b, s)).astype(np.int32)
    return x, head, labels


@pytest.mark.parametrize("z_loss", [1e-4, 0.0])
def test_cross_entropy_loss_matches_reference(z_loss):
    x, head, labels = _loss_case(0)
    logits = (x @ head) * 3.0
    want, jg = jax.value_and_grad(
        lambda lg: jl.cross_entropy_loss(lg, jnp.asarray(labels), z_loss))(
        jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    got = tl.cross_entropy_loss(t, torch.from_numpy(labels), z_loss)
    (tg,) = torch.autograd.grad(got, [t])
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-8)


@pytest.mark.parametrize("chunk,softcap", [(4, None), (4, 2.5), (13, None),
                                           (5, 30.0), (64, None)],
                         ids=["pad3", "pad3-softcap", "whole", "pad2-cap30",
                              "chunk-past-s"])
def test_chunked_cross_entropy_matches_reference(chunk, softcap):
    """S = 13 against chunks of 4, 5 (padded and masked), 13 and 64 (one
    chunk of S); with and without softcap: the value and the gradients
    with respect to x and the head."""
    x, head, labels = _loss_case(1)
    want, (jgx, jgh) = jax.value_and_grad(
        lambda a, h: jl.chunked_cross_entropy(a, h, jnp.asarray(labels),
                                              chunk=chunk, softcap=softcap),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(head).requires_grad_(True)
    got = tl.chunked_cross_entropy(tx, th, torch.from_numpy(labels),
                                   chunk=chunk, softcap=softcap)
    tgx, tgh = torch.autograd.grad(got, [tx, th])
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    for a, b in ((jgx, tgx), (jgh, tgh)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-7)


def test_chunked_loss_equals_the_full_one():
    """Without softcap the chunked loss is the full-logits loss."""
    x, head, labels = _loss_case(2)
    tx, th = torch.from_numpy(x), torch.from_numpy(head)
    full = tl.cross_entropy_loss(tx @ th, torch.from_numpy(labels))
    chunked = tl.chunked_cross_entropy(tx, th, torch.from_numpy(labels),
                                       chunk=4)
    np.testing.assert_allclose(float(chunked), float(full), rtol=1e-6)


# ------------------------------------------------------- model loss + grads
MODES = {"dense": dict(attn_mode="dense"),
         "flash-chunked": dict(attn_mode="flash", loss_chunk=8)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_loss_and_grads_match_reference(arch, mode):
    """``Model.loss`` and every gradient leaf of the reduced arch, float32,
    the same params and batch: dense attention with full logits, and flash
    attention with the chunked loss (chunk 8 of S 16). The MoE archs carry
    the aux loss and capacity drops; pixtral its frontend slice; seamless
    the encoder-decoder loss."""
    ref = reference(arch)
    batch = train_batch(ref.jm.cfg)
    want, jg = jax_loss_and_grads(ref, batch, **MODES[mode])
    got, tg = torch_loss_and_grads(ref.tm, port_params(ref), batch,
                                   **MODES[mode])
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert_grads_close(jg, tg)


#: bfloat16 limits per arch, ~1.2x the gaps between the reference's jitted
#: value_and_grad and the port's (batch seed 0, dense attention): the loss
#: relative, and the worst gradient leaf relative to its largest
#: magnitude. The dense and RWKV archs only: jamba's MoE routing flips
#: in bfloat16 (ROADMAP §3: against float32 on the same rounded params
#: both packages are off by 0.09-0.77 on a leaf), so a gap there measures
#: the routing, not the port.
BF16_LIMITS = {"gemma3-27b": (2.2e-5, 3.0e-2),
               "internlm2-1.8b": (6.0e-5, 1.2e-2),
               "pixtral-12b": (4.0e-5, 9.0e-3),
               "qwen3-32b": (1.1e-4, 1.2e-2),
               "rwkv6-1.6b": (1.6e-4, 1.8e-2),
               "starcoder2-15b": (1.6e-4, 8.9e-3)}


@pytest.mark.parametrize("arch", sorted(BF16_LIMITS))
def test_bfloat16_loss_and_grads_match_reference(arch):
    """``Model.loss`` and every gradient leaf in bfloat16 (the reference's
    own bf16 init, carried over bit for bit), dense attention."""
    loss_rel, grad_rel = BF16_LIMITS[arch]
    ref = reference(arch, dtype="bfloat16")
    batch = train_batch(ref.jm.cfg)
    want, jg = jax_loss_and_grads(ref, batch, attn_mode="dense")
    got, tg = torch_loss_and_grads(ref.tm, port_params(ref), batch,
                                   attn_mode="dense")
    np.testing.assert_allclose(got, want, rtol=loss_rel)
    assert_grads_close(jg, tg, rel=grad_rel)


@pytest.mark.parametrize("arch,s", [("rwkv6-1.6b", 64),
                                    ("jamba-v0.1-52b", 256)])
def test_multi_chunk_scans_match_reference(arch, s):
    """Sequences of several scan chunks (RWKV's 32, Mamba's 128), where the
    chunk steps are checkpointed in both packages."""
    ref = reference(arch)
    batch = train_batch(ref.jm.cfg, seed=3, b=1, s=s)
    want, jg = jax_loss_and_grads(ref, batch, attn_mode="dense")
    got, tg = torch_loss_and_grads(ref.tm, port_params(ref), batch,
                                   attn_mode="dense")
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert_grads_close(jg, tg)
