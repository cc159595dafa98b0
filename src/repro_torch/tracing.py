"""Spans of the port's own layers on the profiler's timeline.

``span(name, args)`` marks a block of host code as ``repro_torch.<name>``
while ``torch.profiler`` records: a host range (a ``cpu_op`` row of the
trace) on the same clock as the CUDA activity the profiler traces, so a
gap between kernels can be read against the program code the host was
running at the time. Without a profiler a span is one flag check and a
shared no-op context. ``any_set(name, flag)`` is the one blocking read of
a flag, under a ``<layer>.sync`` span ``name``.

The range is ``torch._C._profiler._RecordFunctionFast``, not
``record_function``: the profiler mirrors a ``record_function`` range onto
the device's timeline as an annotation, which a reader of device time
would take for device work, and it costs about nine times as much.
``args`` (a dict) are recorded as the range's arguments when the profiler
records shapes (``record_shapes=True``).

Names are ``<layer>.<part>``; a ``<layer>.sync`` span wraps a point where
the host blocks on the card: a read of its results (a flag, a size, a
copy back) or a copy to it from pageable memory, which drains the stream.
So an idle gap under a sync span is the host waiting for the card, and
one under any other span is the card waiting for the host. The profiler
is the recorder and ``export_chrome_trace`` the exporter
(docs/SERVING.md).
"""
from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

PREFIX = "repro_torch."

_OFF = contextlib.nullcontext()


def span(name: str, args: dict | None = None):
    """A profiler range named ``repro_torch.<name>`` while the profiler
    records; otherwise the shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if args is None:
        return _RecordFunctionFast(PREFIX + name)
    return _RecordFunctionFast(PREFIX + name, (), args)


def any_set(name: str, flag) -> bool:
    """Whether any entry of the tensor ``flag`` is set, read back to the
    host under the sync span ``name`` (a ``<layer>.sync``); a 0-d flag is
    read as it is, with no reduction launched."""
    with span(name):
        return bool(flag.any() if flag.dim() else flag)
