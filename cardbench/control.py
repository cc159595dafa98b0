"""The readings that a cell's limits are set from, on the card.

    python3 -m cardbench.control --workload <name> --seconds 5 \\
        --seeds <a> <b> <c> ...

For each seed, one process-local run of the cell at its own size and load
(set-up, a short window, the program's state let go), then two readings
of the same sample of answers: the program's (the check every run makes)
and the control's, the plain reference computed in bfloat16 (float32 rows
of a restore through bfloat16, uint8 rows cut to four bits) put in the
program's place. The benchmark's own runs never run the control. Prints
one JSON line a seed.
"""
from __future__ import annotations

import argparse
import gc
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    from cardbench.bench import Bench, shown
    for seed in args.seeds:
        bench = Bench(torch, args.workload, seed, "cuda", trace=False)
        bench.setup()
        bench.measure(args.seconds)
        program = bench.cell.check(seed)
        control = bench.cell.control(seed, torch.bfloat16)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "checked": program.get("_rows_checked"),
            "program": {k: v[0] for k, v in shown(program).items()},
            "control": {k: v[0] for k, v in shown(control).items()}}),
            flush=True)
        del bench
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
