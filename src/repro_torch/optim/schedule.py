"""LR schedules."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  floor: float = 0.1):
    """Multiplier in [floor, 1]: linear warmup then cosine decay; 0 at step
    0, so the first update leaves the master weights as they are. A float32
    tensor on ``step``'s device (the CPU for a Python int)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(1, warmup), max=1.0)
    t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
    return warm * cos
