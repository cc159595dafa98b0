"""Aggregate dry-run JSONs (``results/dryrun_torch/``) into the trace
matrix and the roofline table that ``inject_tables`` writes into PERF.md.

    PYTHONPATH=src python -m repro_torch.launch.summarize [--results DIR]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def load_cells(mesh: str = "pod16x16", results=RESULTS) -> list[dict]:
    return [json.loads(f.read_text())
            for f in sorted(Path(results).glob(f"*__{mesh}.json"))]


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def roofline_table(mesh: str = "pod16x16", results=RESULTS) -> str:
    """One row an LM cell: rank 0's terms at the rates the JSON names."""
    rows = ["| arch | shape | compute | memory | collective | dominant | "
            "peak GiB | 6ND/counted | roofline frac |",
            "|---|---|---|---|---|---|---|---|---|"]
    for c in load_cells(mesh, results):
        if c.get("skipped"):
            rows.append(f"| {c['arch']} | {c['shape']} | — | — | — | "
                        f"SKIP: {c['why_skipped'][:40]} | — | — | — |")
            continue
        r = c.get("roofline") or c.get("full_program")
        if r is None:               # the ANN cell: shapes, no trace
            continue
        mfr = r.get("model_flops_ratio")
        rf = r.get("roofline_fraction")
        rows.append(
            f"| {c['arch']} | {c['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"**{r['dominant']}** | {c['memory']['peak_gib']:.1f} | "
            + (f"{mfr:.2f} | {rf:.3f} |" if mfr is not None else "— | — |"))
    return "\n".join(rows)


def _trace_cell(c: dict) -> str:
    if not c:
        return "— | —"
    if c.get("skipped"):
        return "SKIP | —"
    if "total_bytes" in c:          # the ANN cell: bytes a rank
        return f"{c['trace_s']:.2f}s | {c['total_bytes'] / 2**30:.2f}"
    return f"{c['trace_s']}s | {c['memory']['peak_gib']:.1f}"


def trace_table(results=RESULTS) -> str:
    """The reference's compile matrix, with the trace's host seconds in
    place of compile seconds (nothing is compiled) and rank 0's peak live
    GiB (the ANN cell: its shard's bytes)."""
    rows = ["| arch | shape | 16x16 trace | peak GiB | 2x16x16 trace | "
            "peak GiB |", "|---|---|---|---|---|---|"]
    single = {(c["arch"], c["shape"]): c
              for c in load_cells("pod16x16", results)}
    multi = {(c["arch"], c["shape"]): c
             for c in load_cells("pod2x16x16", results)}
    for key in sorted(set(single) | set(multi)):
        rows.append(f"| {key[0]} | {key[1]} | "
                    f"{_trace_cell(single.get(key, {}))} | "
                    f"{_trace_cell(multi.get(key, {}))} |")
    return "\n".join(rows)


def worst_cells(n=5, results=RESULTS):
    """Cells ranked by roofline fraction (hillclimb candidates)."""
    out = []
    for c in load_cells("pod16x16", results):
        if c.get("skipped") or "roofline" not in c:
            continue
        out.append((c["roofline"].get("roofline_fraction", 0), c["arch"],
                    c["shape"], c["roofline"]["dominant"]))
    out.sort()
    return out[:n], out[-n:]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=str(RESULTS))
    args = ap.parse_args(argv)
    print("## Trace matrix\n")
    print(trace_table(args.results))
    print("\n## Roofline (single pod)\n")
    print(roofline_table("pod16x16", args.results))
    lo, hi = worst_cells(results=args.results)
    print("\nworst roofline fractions:", lo)
    print("best:", hi)


if __name__ == "__main__":
    main()
