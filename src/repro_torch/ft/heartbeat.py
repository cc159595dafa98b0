"""Worker-liveness monitoring + failure handling (control plane).

On a real cluster each host reports a heartbeat per step; the coordinator
declares a worker dead after `timeout_s` silence, triggers the recovery
callback (restore from a checkpoint onto the healthy workers), and keeps a
searchable incident log. The clock is injected, so a simulated one makes
this unit-testable without real processes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class HeartbeatMonitor:
    n_workers: int
    timeout_s: float = 30.0
    clock: callable = time.monotonic
    last_seen: dict = field(default_factory=dict)
    failed: set = field(default_factory=set)
    incidents: list = field(default_factory=list)
    on_failure: callable = None

    def beat(self, worker: int, t: float | None = None) -> None:
        if worker in self.failed:
            self.incidents.append(("rejoin", worker, self.clock()))
            self.failed.discard(worker)      # elastic rejoin
        self.last_seen[worker] = t if t is not None else self.clock()

    def check(self, now: float | None = None) -> set:
        now = now if now is not None else self.clock()
        newly = set()
        for w in range(self.n_workers):
            if w in self.failed:
                continue
            seen = self.last_seen.get(w)
            if seen is None or now - seen > self.timeout_s:
                self.failed.add(w)
                newly.add(w)
                self.incidents.append(("failed", w, now))
        if newly and self.on_failure:
            self.on_failure(sorted(newly), self.healthy())
        return newly

    def healthy(self) -> list:
        return [w for w in range(self.n_workers) if w not in self.failed]
