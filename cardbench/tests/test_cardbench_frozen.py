"""The frozen yardstick: generators that repeat bit for bit for a seed,
copies that equal their originals, and the byte and roofline arithmetic."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from cardbench import program, readers
from cardbench.frozen import bounds, colocated, traces
from cardbench.record import Run, Trace
from cardbench.world import make_world

PROG = program.load()


@pytest.mark.parametrize("name", ["sift1b-shard", "deep1b-shard"])
def test_world_repeats_bit_for_bit(name, tiny_config):
    cfg = tiny_config(name)
    a = make_world(torch, cfg, 2147483651, "cpu")
    b = make_world(torch, cfg, 2147483651, "cpu")
    assert torch.equal(a.vectors, b.vectors)
    assert torch.equal(a.graph, b.graph) and a.medoid == b.medoid
    assert torch.equal(a.centroids, b.centroids)
    assert np.array_equal(a.queries, b.queries)
    c = make_world(torch, cfg, 2147483652, "cpu")
    assert not torch.equal(a.vectors, c.vectors)


@pytest.mark.parametrize("name", ["sift1b-shard", "deep1b-shard"])
def test_world_graph_has_r_distinct_neighbours(name, tiny_config):
    cfg = tiny_config(name)
    w = make_world(torch, cfg, 7, "cpu")
    n, r = w.graph.shape
    assert r == cfg["r"]
    g = w.graph.long()
    assert bool((g >= 0).all()) and bool((g < n).all())
    assert bool((g != torch.arange(n)[:, None]).all())
    s = g.sort(1).values
    assert bool((s[:, 1:] != s[:, :-1]).all())
    if cfg["dtype"] == "float32":
        norms = torch.linalg.vector_norm(w.vectors, dim=1)
        assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
    else:
        assert float((w.vectors == 0).float().mean()) > 0.2


def test_poisson_copy_equals_the_original():
    from repro_torch.serve.admission import poisson_trace
    q = np.zeros((1, 4), np.float32)
    want = [r.arrival_us for r in poisson_trace(q, 300.0, n=500, seed=9)]
    got = traces.poisson_arrivals_us(300.0, 500, 9)
    assert np.array_equal(np.asarray(want), got)


def test_bursty_copy_equals_the_original():
    from repro_torch.serve.admission import bursty_trace
    q = np.zeros((1, 4), np.float32)
    want = [r.arrival_us for r in bursty_trace(q, 300.0, n=500, seed=9)]
    got = traces.bursty_arrivals_us(300.0, 500, 9)
    assert np.array_equal(np.asarray(want), got)


@pytest.mark.parametrize("dim,elt,want", [(128, 1, 21_333_336_064),
                                          (96, 4, 32_000_000_000)])
def test_colocated_bytes_of_the_two_shards(dim, elt, want):
    assert colocated.colocated_bytes(31_250_000, dim, elt, 128) == want


@pytest.mark.parametrize("n,dim,dtype,r", [(1000, 128, np.uint8, 128),
                                           (999, 96, np.float32, 128),
                                           (50, 1200, np.float32, 16)])
def test_colocated_copy_equals_the_program(n, dim, dtype, r):
    from repro_torch.core.storage.colocated import ColocatedStore
    store = ColocatedStore.build(np.zeros((n, dim), dtype),
                                 [np.arange(r)] * n, 0, r)
    assert colocated.colocated_bytes(n, dim, np.dtype(dtype).itemsize,
                                     r) == store.physical_bytes


@pytest.mark.parametrize("r,universe", [(128, 31_250_000), (16, 12_000),
                                        (32, 1 << 20)])
def test_ef_slot_words_equal_the_program(r, universe):
    assert bounds.ef_slot_words(r, universe) == PROG.slot_layout(
        r, universe)[3]


def test_byte_bounds():
    # one hop of the shard's batch: 1,024 queries, L 200, W*R = 512
    b = bounds.beam_step_bytes(valid=300_000, nq=1024, m=32, k=256,
                               l_size=200, e=512)
    assert b == 300_000 * 32 + 1024 * 32 * 256 * 4 + 1024 * 200 * 20 \
        + 1024 * 512 * 4
    assert bounds.beam_step_bytes(0, 4, 2, 8, 3, 5, lut_rows=1) == \
        2 * 8 * 4 + 4 * 3 * 8 + 4 * 5 * 4 + 4 * 3 * 12
    assert bounds.huffman_decode_bytes(100, 3, 4, 8) == 100 + 3 * 16 + 8
    assert bounds.ef_decode_bytes(2, 81, 128) == 2 * 324 + 8 + 2 * 129 * 4
    assert bounds.rerank_l2_bytes(2, 4, 6, 1) == 32 + 24 + 48


def test_roofline_and_shares_from_a_record():
    run = Run(sync=lambda: None)
    run.counters.update({"beam_step.bytes": 3.35e9, "queries": 10,
                         "batches": 4})
    run.traces["search"] = Trace(window_s=1.0, busy_s=0.5,
                                 kernels={"void beam_step_kernel<16>": 0.004,
                                          "other": 1.0}, gaps=[])
    run.traces["main"] = run.traces["search"]
    # 3.35e9 B at 3.35 TB/s is 1 ms; the kernel took 4 ms
    assert readers.kernel_roofline_pct(run, "beam_step.bytes", "search",
                                       "beam_step") == pytest.approx(25.0)
    assert readers.kernel_roofline_pct(run, "beam_step.bytes", "search",
                                       "huffman_decode") is None
    assert readers.idle_pct(run) == pytest.approx(50.0)
    assert readers.ratio(run, "queries", "batches") == 2.5
    assert readers.ms_per_round(run) is None
    run.spans["search.wall"] = [0.5, 0.3]
    run.counters["search.rounds"] = 128
    assert readers.ms_per_round(run) == pytest.approx(6.25)
