"""Logical-axis sharding rules.

Model code annotates tensors with *logical* axes ("batch", "seq", "heads",
"embed", "ffn", "vocab", "expert", ...). A policy maps logical axes to mesh
axes. This package runs on one device: no mesh policy exists yet, so
``policy`` accepts only ``None`` and every annotation is a no-op, as in the
reference on one device. The rules are kept for the mesh that will map them.

Default production rules:
  batch  -> ("pod", "data")      # DP over pods x data axis
  heads/ffn/vocab/expert -> "model"   # TP / EP
  embed  -> "data"               # FSDP/ZeRO weight dimension
  seq    -> None (or "data" for batch<dp long-context cells)
"""
from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def policy(mesh, rules: dict | None = None):
    """The single-device policy: ``mesh`` must be ``None``."""
    if mesh is not None:
        raise NotImplementedError("no mesh sharding policy in this package "
                                  "yet; pass mesh=None")
    yield


def spec(*logical_axes) -> tuple:
    """The partition of each axis under the active policy: all ``None``."""
    return (None,) * len(logical_axes)


def shard(x, *logical_axes):
    """Annotate an intermediate with its logical sharding (a no-op)."""
    return x
