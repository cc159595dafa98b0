"""Roofline terms of a traced dry-run cell, for one NVIDIA H100.

Terms (per rank: the dry-run counts the local ops each rank runs):
    compute_s    = flops / rates.flops_per_s
    memory_s     = bytes_accessed / rates.bytes_per_s
    collective_s = collective bytes / rates.link_bytes_per_s

The rates are arguments (:class:`Rates`). ``H100_DATASHEET`` holds NVIDIA's
published figures for the SXM part at its full 700 W limit: 989 TFLOP/s
dense bf16 on the tensor cores, 3.35 TB/s of HBM3 and 450 GB/s each way
of NVLink 4. A caller that measured the card's rates (chip_smoke.py's
phase 8a: a bf16 matmul and a read of the card's memory) passes those
instead; :class:`RooflineTerms` names the rates it used.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Rates:
    flops_per_s: float
    bytes_per_s: float
    link_bytes_per_s: float
    source: str


H100_DATASHEET = Rates(
    flops_per_s=989e12, bytes_per_s=3.35e12, link_bytes_per_s=450e9,
    source="H100 SXM datasheet (dense bf16, HBM3, NVLink 4 per direction)")


@dataclass
class RooflineTerms:
    flops: float
    bytes_accessed: float
    coll_bytes: float
    coll_breakdown: dict = field(default_factory=dict)
    peak_memory_bytes: float = 0.0
    rates: Rates = H100_DATASHEET

    @property
    def compute_s(self) -> float:
        return self.flops / self.rates.flops_per_s

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / self.rates.bytes_per_s

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / self.rates.link_bytes_per_s

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower-bound step time: terms overlap, bound = max."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self, model_flops_per_device: float) -> float:
        """useful-FLOPs utilisation at the lower-bound step time (MFU-like)."""
        if self.step_time_s == 0:
            return 0.0
        return model_flops_per_device / self.rates.flops_per_s / \
            self.step_time_s

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "bytes": self.bytes_accessed,
            "coll_bytes": self.coll_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "peak_memory_gib": self.peak_memory_bytes / 2**30,
            "coll_breakdown": {k: v for k, v in self.coll_breakdown.items()
                               if v},
            "rates": self.rates.source,
        }


def combine(parts: list[tuple["RooflineTerms", float]],
            rates: Rates = H100_DATASHEET) -> RooflineTerms:
    """Weighted sum of per-program terms (e.g. a program + the optimizer)."""
    t = RooflineTerms(0.0, 0.0, 0.0, {}, 0.0, rates)
    for part, w in parts:
        t.flops += part.flops * w
        t.bytes_accessed += part.bytes_accessed * w
        t.coll_bytes += part.coll_bytes * w
        for k, v in part.coll_breakdown.items():
            t.coll_breakdown[k] = t.coll_breakdown.get(k, 0) + v * w
        t.peak_memory_bytes = max(t.peak_memory_bytes, part.peak_memory_bytes)
    return t


def model_flops(n_active_params: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference forward)."""
    per_tok = 6 if kind == "train" else 2
    return per_tok * n_active_params * tokens


def active_params(model) -> int:
    """Active (per-token) parameter count: expert tensors scaled by
    top_k/E; embeddings and the LM head excluded (6ND convention)."""
    cfg = model.cfg
    total = 0

    def walk(tree, keys):
        nonlocal total
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, keys + (k,))
            return
        n = math.prod(tree.shape)
        if "embed" in keys or "lm_head" in keys:
            return
        if cfg.moe and "expert" in tree.axes:
            n = int(n * cfg.moe.top_k / cfg.moe.n_experts)
        total += n

    walk(model.schema, ())
    return total
