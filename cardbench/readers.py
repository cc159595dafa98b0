"""Arithmetic the per-layer readers share. Each reader takes the run's
record (``cardbench/record.py``) and returns a number, or None where the
run recorded nothing to read; it never returns 0 for a share of a
roofline or a peak."""
from __future__ import annotations

from .frozen.bounds import HBM_BYTES_PER_S


def ms_per_round(run):
    """Wall of the bare search over its traversal rounds."""
    wall, rounds = run.span_total("search.wall"), \
        run.counters.get("search.rounds", 0)
    return 1e3 * wall / rounds if wall > 0 and rounds else None


def idle_pct(run):
    """Share of the profiled stretch with nothing running on the device."""
    t = run.traces.get("main")
    return 100.0 * (1.0 - t.busy_s / t.window_s) \
        if t is not None and t.window_s > 0 else None


def ratio(run, part: str, whole: str):
    a, b = run.counters.get(part), run.counters.get(whole)
    return a / b if a and b else None


def gbs(run, moved: str, span: str):
    b, s = run.counters.get(moved), run.span_total(span)
    return b / s / 1e9 if b and s > 0 else None


def roofline_pct(run, bytes_key: str, seconds: float):
    """Least time of the counted bytes at the data sheet's HBM rate, over
    the measured time."""
    b = run.counters.get(bytes_key)
    return 100.0 * b / HBM_BYTES_PER_S / seconds \
        if b and seconds and seconds > 0 else None


def kernel_roofline_pct(run, bytes_key: str, stretch: str, kernel: str):
    t = run.traces.get(stretch)
    return roofline_pct(run, bytes_key, t.kernel_seconds(kernel)) \
        if t is not None else None
