"""One rank of the process-group form of ``make_compressed_allreduce``,
for tests/test_torch_ft.py: joins a gloo process group on localhost,
holds row ``rank`` of the case's gradient ``g`` [8, k], runs two
error-feedback steps on each mesh of ``MESHES`` and writes its rows to
``<out>/compress.rank<r>.npz``.

    python tests/torch_compress_worker.py RANK WORLD PORT OUT CASE.npz

Imports torch and repro_torch only.
"""
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed.sharded_index import make_process_mesh
from repro_torch.optim.grad_compress import make_compressed_allreduce

#: (mesh axis sizes, mesh axis names, the axes the mean runs over)
MESHES = {"d8": ((8,), ("data",), ("data",)),
          "pod2x4-data": ((2, 4), ("pod", "data"), ("data",)),
          "pod2x4-both": ((2, 4), ("pod", "data"), ("pod", "data"))}


def main(rank: int, world: int, port: int, out: Path, case: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        g = {"w": torch.from_numpy(np.load(case)["g"][rank:rank + 1])}
        rows = {}
        for name, (sizes, names, axes) in MESHES.items():
            fn = make_compressed_allreduce(
                make_process_mesh(sizes, names, device="cpu"), axes)
            res = {"w": torch.zeros_like(g["w"])}
            for i in (1, 2):
                o, res = fn(g, res)
                rows[f"{name}_out{i}"] = o["w"].numpy()
                rows[f"{name}_res{i}"] = res["w"].numpy()
        np.savez(out / f"compress.rank{rank}.npz", **rows)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
         Path(sys.argv[4]), sys.argv[5])
