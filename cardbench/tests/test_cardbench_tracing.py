"""The program's own spans (``repro_torch.*``, host ranges) leave every
reading of a profiled stretch as it was: the window, the busy time, the
kernels and the idle gaps' labels."""
from __future__ import annotations

import time

import torch

from cardbench import program
from cardbench.record import profile

program.load()
from repro_torch import tracing  # noqa: E402


def _stretch(with_spans: bool):
    def fn():
        with torch.profiler.record_function("cardbench.serve.search"):
            if with_spans:
                with tracing.span("serve.batch", {"batch": 1, "rows": 4}):
                    with tracing.span("search.round"):
                        time.sleep(0.02)
            else:
                time.sleep(0.02)
    return profile(torch, fn, lambda: None)


def test_program_spans_are_no_device_work_and_no_gap_label():
    plain, traced = _stretch(False), _stretch(True)
    for t in (plain, traced):
        assert t.busy_s == 0 and t.kernels == {}
        assert [label for label, _ in t.gaps] == ["serve.search"]
        assert t.window_s >= 0.02
