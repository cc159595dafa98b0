"""A run's import path loads neither JAX nor the JAX package, and nothing
of the benchmark reads the JAX package's benchmarks."""
from __future__ import annotations

import json
import subprocess
import sys

from cardbench.bench import HERE, ROOT

PROBE = """
import json, sys, torch
from cardbench import bench, program, run, survey, control, traffic
program.load()
spec = bench.load_spec()
for w in spec["workloads"]:
    entry = bench.cell_entry(spec, w["name"])
    traffic.kind(traffic.load(entry["traffic"])["kind"])
    for m in bench.per_layer(spec, w["name"]):
        bench.reader(m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_import_path_loads_no_jax_and_no_reference_package():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "cardbench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from cardbench import run
    before = run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "reprox.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlibx", sys)
    assert run.loaded_forbidden() == before
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.loaded_forbidden()


def test_no_module_reads_the_jax_benchmarks():
    for path in HERE.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "BENCH_" not in text, path
        assert "import jax" not in text and "from jax" not in text, path
        assert "import repro\n" not in text and "from repro " not in text
        assert "from repro." not in text, path
