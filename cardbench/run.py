"""Run one cell of the benchmark once and print its result line.

    python3 -m cardbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error repeat the checks. Without the cards, or
if JAX or the JAX package got loaded, it prints no result and exits with
a code other than 0.
"""
from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one host thread for the math libraries: the serve tier's replay is
# Python on one core, and idle library threads only contend with it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from cardbench import bench

    spec = bench.load_spec()
    chips = bench.cell_entry(spec, args.workload)["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"cardbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    result, checks = bench.execute(torch, args.workload, args.seed,
                                   args.seconds, bool(args.trace),
                                   t_start=_T_START, spec=spec)
    bad = loaded_forbidden()
    if bad:
        print(f"cardbench: modules loaded that the run must not load: {bad}",
              file=sys.stderr)
        return 3
    info = {k: v for k, v in checks.items() if k.startswith("_")}
    print(f"cardbench: {args.workload} seed {args.seed}: {info}",
          file=sys.stderr)
    for name, limit in result["checks"].items():
        print(f"check {name}: {limit['value']} (limit {limit['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
