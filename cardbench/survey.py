"""Readings taken once on the card, not in every run.

    python3 -m cardbench.survey --workload sift1b-shard.serve-1024 --seed <n>
    python3 -m cardbench.survey --config deep1b-shard --seed <n>

- the recall@10 of a search of the pool's first 1,024 queries against
  exact ground truth (a brute-force scan of the shard), and the histogram
  of the search's traversal rounds: the program's search
  (``SearchStats.iters``) for a workload's configuration, or, with
  ``--config``, the plain reference's search, for a configuration the
  program cannot search.

``--gen key=value,...`` overrides the data generator's parameters, for
trials of the data's shape. Prints one JSON line a reading.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def ground_truth(torch, vectors, queries, k: int, rows: int = 1 << 19):
    """Exact k nearest rows of each query by squared L2 -> [nq, k] ids;
    ties to the lower id."""
    q = queries.float()
    qq = (q * q).sum(1)[:, None]
    best = None
    for a in range(0, vectors.shape[0], rows):
        x = vectors[a:a + rows].float()
        d = (qq + (x * x).sum(1)[None] - 2 * q @ x.T).clamp(min=0)
        ids = torch.arange(a, a + x.shape[0], device=x.device)
        key = (d.view(torch.int32).to(torch.int64) << 25) | ids
        key = torch.topk(key, k, dim=1, largest=False).values
        best = key if best is None else torch.topk(
            torch.cat([best, key], 1), k, dim=1, largest=False).values
    return (best & ((1 << 25) - 1)).cpu().numpy()


def reading(torch, cfg, vectors, q, ids, rounds, **extra) -> dict:
    truth = ground_truth(torch, vectors, q, cfg["k"])
    got = ids.long().cpu().numpy()
    rounds = rounds.cpu().numpy()
    hist = np.bincount(rounds, minlength=cfg["max_iters"] + 1)
    return dict(extra, queries=len(got), recall_at_10=float(np.mean(
        [len(set(a) & set(b)) / cfg["k"] for a, b in zip(got, truth)])),
        iters_hist={int(i): int(c) for i, c in enumerate(hist) if c},
        at_max_iters=int((rounds >= cfg["max_iters"]).sum()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--config")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--gen", default="")
    args = ap.parse_args(argv)
    import torch
    from cardbench.bench import Bench, cell_entry, load_config, load_spec
    torch.backends.cuda.matmul.allow_tf32 = False
    name = args.config or cell_entry(load_spec(), args.workload)["config"]
    cfg = load_config(name)
    for kv in filter(None, args.gen.split(",")):
        k, v = kv.split("=")
        cfg["assumed"]["generator"][k] = type(
            cfg["assumed"]["generator"][k])(v)
    tag = dict(config=name, seed=args.seed, gen=args.gen)
    if args.config:
        from cardbench.reference import search as ref
        from cardbench.world import make_world
        w = make_world(torch, cfg, args.seed, "cuda")
        q = torch.from_numpy(w.queries[:1024]).cuda()
        ids, _, rounds = ref.search(w.vectors, w.graph, w.centroids,
                                    w.medoid, q, cfg)
        print(json.dumps(reading(torch, cfg, w.vectors, q, ids, rounds,
                                 search="reference", **tag)), flush=True)
        return 0
    bench = Bench(torch, args.workload, args.seed, "cuda", trace=False,
                  cfg=cfg)
    bench.setup()
    cell = bench.cell
    print(json.dumps({"setup_parts": bench.parts}), flush=True)
    q = torch.from_numpy(cell.pool[:1024]).cuda()
    ids, _, st = cell.prog.search(cell.index, q, cell.searcher.p)
    print(json.dumps(reading(torch, cfg, cell.world.vectors, q, ids,
                             st.iters, search="program", **tag)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
