"""One rank of the process-group form of ``make_sharded_search``, for
tests/test_torch_sharded.py: joins a gloo process group on localhost, and
for each case file holds its own shard of the stacked index, runs the
hierarchical and the flat merge (and, where the case has router
centroids, the hierarchical merge routed at 0.5) and writes its rows to
``<out>/<case>.rank<r>.npz``.

    python tests/torch_mesh_worker.py RANK WORLD PORT OUT CASE.npz [...]

Each case file holds the index's fields, ``queries``, ``per``,
``axis_sizes`` and ``axis_names`` (and ``centroids`` for routing). Imports
torch and repro_torch only.
"""
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed.sharded_index import (
    ShardRouter, make_process_mesh, make_sharded_search, place_on_mesh,
    sharded_index_from_numpy)
from repro_torch.core.search.beam import SearchParams

FIELDS = ("neighbors", "counts", "ef_slots", "pq_codes", "pq_centroids",
          "vectors", "medoid", "row_ids")


def params(per: int) -> SearchParams:
    """The search parameters of tests/test_sharded.py's mesh case."""
    return SearchParams(l_size=32, beam_width=4, k=5, rerank_batch=5,
                        r_max=16, universe=per, max_iters=64)


def main(rank: int, world: int, port: int, out: Path, cases: list) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        for case in cases:
            data = np.load(case)
            sizes = tuple(int(s) for s in data["axis_sizes"])
            names = tuple(str(n) for n in data["axis_names"])
            mesh = make_process_mesh(sizes, names, device="cpu")
            index = place_on_mesh(sharded_index_from_numpy(
                {f: data[f] for f in FIELDS}, "cpu"), mesh)
            p = params(int(data["per"]))
            rows = {}
            for merge in ("hier", "flat"):
                ids, d = make_sharded_search(mesh, p, merge=merge)(
                    index, data["queries"])
                rows[f"{merge}_ids"], rows[f"{merge}_d"] = ids, d
            if "centroids" in data:
                router = ShardRouter(torch.from_numpy(data["centroids"]))
                ids, d = make_sharded_search(mesh, p, router=router,
                                             route_frac=0.5)(
                    index, data["queries"])
                rows["routed_ids"], rows["routed_d"] = ids, d
            np.savez(out / f"{Path(case).stem}.rank{rank}.npz",
                     **{k: v.numpy() for k, v in rows.items()})
            dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
         Path(sys.argv[4]), sys.argv[5:])
