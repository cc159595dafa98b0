"""One run of one cell: inputs from the seed, the program set up and
warmed, the window, the traced stretch (``--trace 1``), the check against
the plain reference, and the result line.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``,
its configuration (``cardbench/configs/<config>.json``), its traffic mix
(``cardbench/traffic/<traffic>.json``) and the generator of the mix's kind
(``cardbench/kinds/<kind>.py``) and, for each per-layer metric, its
reader (``cardbench/metrics/<metric>.py``).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import time
from pathlib import Path

from . import program, traffic
from .record import Run
from .world import make_world

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def reader(name: str):
    """The ``read(run)`` of ``cardbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cardbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_entry(spec: dict, workload: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def end_to_end(spec: dict, workload: str) -> list:
    return [m for m in spec["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer(spec: dict, workload: str) -> list:
    moves = {m["name"] for m in end_to_end(spec, workload)}
    return [m for m in spec["per_layer"]
            if workload in m["workloads"] or (
                "workloads" not in m and m["moves"] in moves)]


class Bench:
    """One cell, set up for one seed on one device."""

    def __init__(self, torch, workload: str, seed: int, device, trace: bool,
                 spec: dict | None = None, cfg: dict | None = None):
        self.torch, self.workload, self.seed = torch, workload, seed
        self.device = torch.device(device)
        self.trace = trace
        self.spec = spec or load_spec()
        entry = cell_entry(self.spec, workload)
        self.cfg = cfg or load_config(entry["config"])
        self.mix = traffic.load(entry["traffic"])
        cuda = self.device.type == "cuda"
        self.run = Run(sync=torch.cuda.synchronize if cuda else lambda: None)
        self.parts: dict = {}       # set-up part -> seconds
        self._last = time.perf_counter()

    def clock(self, part: str):
        self.run.sync()
        now = time.perf_counter()
        self.parts[part] = now - self._last
        self._last = now

    def setup(self):
        torch, cfg = self.torch, self.cfg
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        prog = program.load()
        kind = traffic.kind(self.mix["kind"])
        self.clock("start")
        world = make_world(torch, cfg, self.seed, self.device,
                           codebook=self.mix["kind"] != "restore",
                           clock=self.clock)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.cell = kind(torch, prog, cfg, self.mix, world, self.seed,
                         self.device, self.run, self.trace)
        self.cell.setup()
        # what set-up left on the heap lives as long as the process: keep
        # the collector from walking it again on every full collection
        gc.collect()
        gc.freeze()
        self.clock("program")

    def measure(self, seconds: float) -> dict:
        """The window, then (traced runs) the stretch; the program's state
        is let go once the peak has been read."""
        torch = self.torch
        got = self.cell.window(seconds)
        if self.trace:
            self.cell.stretch()
        self.run.sync()
        cuda = self.device.type == "cuda"
        got["memory_peak_bytes"] = torch.cuda.max_memory_allocated() \
            if cuda else 0
        self.cell.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        return got

    def metrics(self, got: dict, setup_s: float) -> dict:
        if not self.trace:
            out = {}
            for m in end_to_end(self.spec, self.workload):
                value = setup_s if m["name"] == "setup_s" else got[m["name"]]
                out[m["name"]] = {"value": value, "unit": m["unit"]}
            return out
        out = {}
        for m in per_layer(self.spec, self.workload):
            value = reader(m["name"])(self.run)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out

    def result(self, got: dict, setup_s: float, checks: dict) -> dict:
        torch = self.torch
        device = {"platform": "gpu" if self.device.type == "cuda" else "cpu",
                  "kind": torch.cuda.get_device_name(0)
                  if self.device.type == "cuda" else "cpu",
                  "count": 1, "memory_peak_bytes": got["memory_peak_bytes"]}
        out = {"correct": all(v <= lim for v, lim in shown(checks).values()),
               "attempted": got["attempted"], "failed": 0,
               "metrics": self.metrics(got, setup_s), "device": device}
        if self.trace:
            main = self.run.traces["main"]
            device["busy_s"] = main.busy_s
            device["window_s"] = main.window_s
            out["breakdown"] = main.breakdown()
        out["checks"] = {k: {"value": v, "limit": lim}
                         for k, (v, lim) in shown(checks).items()}
        return out


def shown(checks: dict) -> dict:
    """The compared numbers, without the informational ``_`` entries."""
    return {k: v for k, v in checks.items() if not k.startswith("_")}


def execute(torch, workload: str, seed: int, seconds: float, trace: bool,
            device="cuda", t_start: float | None = None, **kw):
    """One run -> (result dict, checks)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = Bench(torch, workload, seed, device, trace, **kw)
    bench.setup()
    setup_s = time.perf_counter() - t_start
    got = bench.measure(seconds)
    t0 = time.perf_counter()
    checks = bench.cell.check(seed)
    checks["_check_s"] = time.perf_counter() - t0
    checks["_setup_parts"] = {k: round(v, 3) for k, v in bench.parts.items()}
    return bench.result(got, setup_s, checks), checks
