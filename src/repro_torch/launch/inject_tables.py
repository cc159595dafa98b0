"""Inject the dry-run's trace matrix and single-pod roofline table into
PERF.md §8, each after its marker (``<!--DRYRUN_TABLE-->``,
``<!--ROOFLINE_TABLE-->``) up to the next marker or heading.

    PYTHONPATH=src python -m repro_torch.launch.inject_tables [--results DIR]
"""
from __future__ import annotations

import argparse
import re
from pathlib import Path

from .summarize import RESULTS, roofline_table, trace_table

ROOT = Path(__file__).resolve().parents[3]
MARKERS = ("<!--DRYRUN_TABLE-->", "<!--ROOFLINE_TABLE-->")


def inject(text: str, tables: dict) -> str:
    """``text`` with the lines after each marker replaced by its table."""
    for marker, content in tables.items():
        start = text.index(marker) + len(marker)
        nxt = re.compile(r"\n(#|<!--)").search(text, start)
        end = nxt.start() if nxt else len(text)
        text = text[:start] + "\n" + content + "\n" + text[end:]
    return text


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=str(RESULTS))
    ap.add_argument("--doc", default=str(ROOT / "PERF.md"))
    args = ap.parse_args(argv)
    p = Path(args.doc)
    p.write_text(inject(p.read_text(), {
        MARKERS[0]: ("**Trace matrix (both meshes; trace seconds on the "
                     "host, rank 0's peak live GiB)**\n\n"
                     + trace_table(args.results)),
        MARKERS[1]: ("**Single-pod roofline terms (rank 0, at the rates "
                     "each JSON names)**\n\n"
                     + roofline_table("pod16x16", args.results))}))
    print("tables injected")


if __name__ == "__main__":
    main()
