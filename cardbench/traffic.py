"""Traffic mixes and the generators that read them, found by name.

A mix is a data file of parameters, ``cardbench/traffic/<name>.json``.
Its ``kind`` names the one generator of every mix of that kind,
``cardbench/kinds/<kind>.py``: a module whose ``Cell`` sets the program up
on the inputs, drives it through the window as the mix says, and checks
what it produced. A new mix of a kind that exists is one new data file; a
new kind is one new module. Neither edits a file that is there.

Every draw comes from the run's seed, so the same seed gives the same
traffic.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
DIR = HERE / "traffic"
KINDS = HERE / "kinds"


def load(name: str) -> dict:
    return json.loads((DIR / f"{name}.json").read_text())


def kind(name: str):
    """The ``Cell`` class of ``cardbench/kinds/<name>.py``."""
    return kind_module(name).Cell


def kind_module(name: str):
    """The module ``cardbench/kinds/<name>.py``."""
    path = KINDS / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no traffic kind {name!r} ({path} is missing)")
    spec = importlib.util.spec_from_file_location(
        f"cardbench_kind_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
