"""The plain reference against the program at PQ shapes past the shards':
any sub-space width in the encode, and the serve cells whose codes are 384
bytes over 768-d rows (dsub 2) or 32 bytes over 96-d rows (dsub 3), on
tiny worlds on the CPU."""
from __future__ import annotations

import pytest
import torch

from cardbench import bench, program
from cardbench.bench import Bench
from cardbench.reference import search as ref

PROG = program.load()


def _correct(checks) -> bool:
    return all(v <= lim for v, lim in bench.shown(checks).values())


@pytest.mark.parametrize("dsub", [3, 5, 6, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_reference_encode_equals_the_programs_at_any_dsub(dsub, dtype):
    """The program's encode at any sub-space width (DEEP1B's M = 32 over
    D = 96 is dsub 3) gives the reference's codes, duplicated centroids
    (ties) included, whatever the reference's chunk."""
    g = torch.Generator().manual_seed(dsub)
    m, n = 4, 500
    x = (torch.randint(0, 40, (n, m * dsub), generator=g).to(dtype)
         if dtype == torch.uint8 else torch.randn(n, m * dsub, generator=g))
    cents = torch.randn(m, 256, dsub, generator=g) * 10
    cents[:, 200:] = cents[:, :56]
    want = ref.encode(x, cents)
    assert torch.equal(PROG.encode_pq_torch(x, cents), want)
    assert torch.equal(ref.encode(x, cents, chunk=7), want)


#: The wide-PQ serve cells at their PQ shapes on a tiny world: the cohere
#: cell's 384-byte codes over 768-d rows (dsub 2) and DEEP1B's M = 32
#: over D = 96 (dsub 3).
WIDE = [("cohere768-diskann.serve-1024", 768, 384),
        ("deep1b-shard.serve-1024", 96, 32)]


@pytest.mark.parametrize("workload,dim,m", WIDE)
def test_wide_pq_serve_cells_answer_as_the_reference(workload, dim, m,
                                                 tiny_config):
    """Batches through ``BatchedSearcher`` (the cell's own kind) equal the
    reference's answers bit for bit, and the control is incorrect."""
    entry = bench.cell_entry(bench.load_spec(), workload)
    cfg = tiny_config(entry["config"], dim=dim, pq_m=m, n_vectors=6000)
    b = Bench(torch, workload, 41, "cpu", trace=False, cfg=cfg)
    b.mix = dict(b.mix, batch=64, buckets=[8, 64])
    b.setup()
    b.measure(0.2)
    checks = b.cell.check(41)
    assert _correct(checks) and checks["_rows_checked"] == 64
    assert not _correct(b.cell.control(41, torch.bfloat16))
