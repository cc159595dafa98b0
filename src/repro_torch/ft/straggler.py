"""Straggler detection + mitigation bookkeeping.

Tracks per-worker step durations with an exponential moving average; a
worker whose EMA exceeds ``threshold`` x the fleet median is flagged. The
mitigation hook models the two production responses: (a) re-assign the
straggler's data shard to a backup worker for the next step (bounded-staleness
redundant compute), (b) demote persistent stragglers for replacement. The
train loop consumes `plan()` each step.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class StragglerMitigator:
    n_workers: int
    threshold: float = 1.8
    ema: float = 0.5
    demote_after: int = 3
    times: dict = field(default_factory=dict)
    flags: dict = field(default_factory=dict)
    demoted: set = field(default_factory=set)
    events: list = field(default_factory=list)

    def record(self, worker: int, step_time: float) -> None:
        prev = self.times.get(worker)
        self.times[worker] = step_time if prev is None else \
            self.ema * step_time + (1 - self.ema) * prev

    def stragglers(self) -> list:
        if len(self.times) < max(2, self.n_workers // 2):
            return []
        med = float(np.median(list(self.times.values())))
        out = []
        for w, t in self.times.items():
            if w in self.demoted:
                continue
            if t > self.threshold * med:
                self.flags[w] = self.flags.get(w, 0) + 1
                out.append(w)
                if self.flags[w] >= self.demote_after:
                    self.demoted.add(w)
                    self.events.append(("demote", w))
            else:
                self.flags[w] = 0
        return out

    def plan(self) -> dict:
        """Next-step work assignment: stragglers' shards get a backup copy
        on the fastest healthy workers (redundant compute; first result
        wins), demoted workers are excluded."""
        slow = set(self.stragglers())
        healthy = [w for w in range(self.n_workers)
                   if w not in self.demoted]
        fast = sorted((w for w in healthy if w not in slow),
                      key=lambda w: self.times.get(w, 0.0))
        backups = {}
        for i, w in enumerate(sorted(slow)):
            if i < len(fast):
                backups[w] = fast[i]
        return {"exclude": sorted(self.demoted), "backups": backups}
