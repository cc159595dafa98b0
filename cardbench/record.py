"""What a run records for its per-layer readers: host spans taken by the
benchmark around its calls into each layer, counts, and the device trace
of a short steady stretch (``torch.profiler``)."""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Trace:
    """A profiled stretch: device intervals and the stretch's length."""
    window_s: float
    busy_s: float
    kernels: dict          # kernel name -> device seconds
    gaps: list             # [(label, seconds)] idle gaps, longest first

    def kernel_seconds(self, part: str) -> float:
        return sum(s for name, s in self.kernels.items() if part in name)

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in self.gaps[:10]]}


@dataclass
class Run:
    sync: object = None                           # drains the device
    counters: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)
    traces: dict = field(default_factory=dict)    # stretch name -> Trace

    def count(self, name: str, value) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def span_total(self, name: str) -> float:
        return sum(self.spans.get(name, ()))

    @staticmethod
    def label(torch, name: str):
        """Mark the block in a device trace, untimed and unsynchronised."""
        return torch.profiler.record_function(f"cardbench.{name}")

    @contextmanager
    def span(self, torch, name: str):
        """Host seconds of the block, the device drained at both ends."""
        self.sync()
        with torch.profiler.record_function(f"cardbench.{name}"):
            t0 = time.perf_counter()
            yield
            self.sync()
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)


def _short(name: str) -> str:
    """A kernel's name without its argument list."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i].rstrip()
    return name


def _union(intervals):
    """Sorted, merged [(start, end)]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(torch, fn, sync) -> Trace:
    """Run ``fn`` under ``torch.profiler`` and read its device time: the
    union of the device's kernel, copy and fill intervals within the
    stretch, the time of each kernel name, and the idle gaps labelled by
    the innermost ``cardbench.*`` span around each."""
    from torch.profiler import ProfilerActivity, profile as _profile
    sync()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with _profile(activities=activities) as prof:
        with torch.profiler.record_function("cardbench.stretch"):
            fn()
            sync()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    spans, dev = [], []
    for ev in events:
        tr = ev.time_range
        if ev.name.startswith("cardbench."):
            # a span shows on the host and again as a device annotation
            if ev.device_type != cuda:
                spans.append((ev.name[len("cardbench."):], tr.start, tr.end))
        elif ev.device_type == cuda:
            dev.append((_short(ev.name), tr.start, tr.end))
    whole = [s for s in spans if s[0] == "stretch"]
    if not whole:
        raise RuntimeError("the profiler lost the stretch's span")
    lo, hi = whole[0][1], whole[0][2]
    kernels: dict = {}
    clipped = []
    for name, s, e in dev:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            clipped.append((s, e))
            kernels[name] = kernels.get(name, 0.0) + (e - s) / 1e6
    busy = _union(clipped)
    gaps, t = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > t:
            mid = (s + t) / 2
            inner = [sp for sp in spans
                     if sp[0] != "stretch" and sp[1] <= mid <= sp[2]]
            label = min(inner, key=lambda sp: sp[2] - sp[1])[0] \
                if inner else "stretch"
            gaps.append((label, (s - t) / 1e6))
        t = max(t, e)
    merged: dict = {}
    for label, sec in gaps:
        merged[label] = merged.get(label, 0.0) + sec
    return Trace(window_s=(hi - lo) / 1e6,
                 busy_s=sum(e - s for s, e in busy) / 1e6,
                 kernels=kernels,
                 gaps=sorted(merged.items(), key=lambda kv: -kv[1]))
