"""The harness finds every cell's configuration, mix, kind and metric
readers by name, and BENCHMARK.json keeps the contract's shape."""
from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from cardbench import bench, traffic
from cardbench.bench import ROOT, HERE

SPEC = bench.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_finds_its_config_mix_and_readers(workload):
    entry = bench.cell_entry(SPEC, workload)
    cfg = bench.load_config(entry["config"])
    assert cfg["name"] == entry["config"]
    mix = traffic.load(entry["traffic"])
    assert (HERE / "kinds" / f"{mix['kind']}.py").is_file()
    assert callable(traffic.kind(mix["kind"]))
    e2e = [m["name"] for m in bench.end_to_end(SPEC, workload)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = bench.per_layer(SPEC, workload)
    assert layers
    for m in layers:
        assert callable(bench.reader(m["name"]))
        assert m["moves"] in e2e


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["cardbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("cardbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    assert len({c["source"] for c in SPEC["configs"]}) == len(names)
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(CELLS)
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith("roofline_pct"):
            assert m["unit"] == "%"


def test_run_refuses_without_a_card():
    """No card: exit code other than 0 and no result line."""
    out = subprocess.run(
        [sys.executable, "-m", "cardbench.run", "--workload", CELLS[0],
         "--seed", "2147483649", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "correct" not in out.stdout


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (HERE / "kinds").glob("*.py")))
def test_every_kind_module_has_a_cell(name):
    cell = traffic.kind(name)
    for step in ("setup", "window", "stretch", "release", "check",
                 "control"):
        assert callable(getattr(cell, step))


def test_an_unknown_kind_is_refused():
    with pytest.raises(KeyError):
        traffic.kind("no-such-kind")


def test_closed_batches_wrap_the_pool():
    gen = traffic.kind_module("closed").batches({"batch": 4}, 10)
    got = [next(gen).tolist() for _ in range(3)]
    assert got == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 0, 1]]


def test_restore_units_cover_every_row_once():
    units = traffic.kind_module("restore").units(10, 4)
    assert units == [(0, 4), (4, 8), (8, 10)]
