"""Assigned input shapes (one set shared by all 10 LM-family archs).

``train_*`` lowers train_step; ``prefill_*`` lowers the prefill program;
``decode_*`` / ``long_*`` lower serve_step (one token against a KV cache of
seq_len). long_500k requires a sub-quadratic arch (cfg.subquadratic).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """Cell applicability: long_500k decode needs a sub-quadratic arch."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: 500k decode requires sub-quadratic attention"
    return True, ""
