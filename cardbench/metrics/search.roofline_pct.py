"""Least time of the bytes the search's work needs (counted from
SearchStats and shapes) at 3.35 TB/s over the search's wall (%); moves
qps."""
from cardbench import readers


def read(run):
    return readers.roofline_pct(
        run, "search.bytes", run.span_total("search.wall"))
