"""Tests of ``repro_torch`` that need a CUDA card: each hand-written kernel
against its plain PyTorch version on the card, bit for bit, a search on
the card against the same search on the CPU, and the vector store sealed
and loaded on the card (one ``huffman_decode`` launch a segment) against
the same store on the CPU. Every test is marked
``cuda`` and skips without a card. The file imports neither ``jax`` nor
``repro``, so it runs where only the port is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The seeded numpy case makers here are shared with
tests/test_torch_kernels.py and tests/test_torch_huffman_decode.py, which
hold the plain versions against the JAX reference on the same inputs.
"""
import numpy as np
import pytest
import torch

from conftest import random_graph

from repro_torch.core.codec import huffman
from repro_torch.core.codec.elias_fano import encode_slot
from repro_torch.core.graph.pq import encode_pq_torch
from repro_torch.core.index import build_device_index
from repro_torch.core.search.beam import DeviceIndex, SearchParams, search
from repro_torch.data.synthetic import make_queries, make_vector_dataset
from repro_torch.kernels import build
from repro_torch.core.storage.vector_store import (DecoupledVectorStore,
                                                   StoreConfig)
from repro_torch.kernels.beam_step.beam_step import (beam_step_cuda,
                                                     beam_step_ref,
                                                     lut_slices)
from repro_torch.kernels.byteplane.byteplane import (byteplane_decode_cuda,
                                                     byteplane_decode_ref)
from repro_torch.kernels.ef_decode.ef_decode import (ef_decode_cuda,
                                                     ef_decode_ref)
from repro_torch.kernels.huffman_decode.huffman_decode import (
    huffman_decode_cuda, huffman_decode_ref)
from repro_torch.kernels.pq_adc.pq_adc import (pq_adc_batched_cuda,
                                               pq_adc_batched_ref,
                                               pq_adc_cuda, pq_adc_ref)
from repro_torch.kernels.pq_encode.pq_encode import (pq_encode_cuda,
                                                     pq_encode_ref)
from repro_torch.kernels.rerank_l2.rerank_l2 import (rerank_l2_cuda,
                                                     rerank_l2_ref)
from repro_torch.kernels.rerank_loop.rerank_loop import (rerank_loop_cuda,
                                                         rerank_loop_ref)


def adc_case(nq, n, m, seed, equal_codes=False):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (nq, n, m), dtype=np.uint8)
    if equal_codes:
        codes[:] = 3
    luts = rng.normal(size=(nq, m, 256)).astype(np.float32)
    return codes, luts


def single_adc_case(n, m, seed, dtype=np.uint8, k=256, fill=None):
    """[n, m] codes below ``k`` and an [m, k] LUT; every code ``fill``
    where given."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, k, (n, m)).astype(dtype)
    if fill is not None:
        codes[:] = fill
    return codes, rng.normal(size=(m, k)).astype(np.float32)


# The single-LUT kernel's sweep: one row up to 2^20 + 3 (ragged warps,
# blocks and grid strides), M from 1 to 64 (rows of 1 to 64 bytes).
SINGLE_ADC_N = (1, 31, 255, 257, 4099, (1 << 20) + 3)
SINGLE_ADC_M = (1, 7, 8, 12, 16, 32, 64)


def byteplane_case(n, v, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, v), dtype=np.uint8),
            rng.integers(0, 256, v, dtype=np.uint8))


BYTEPLANE_SHAPES = [(n, v) for n in (0, 1, 255, 256, 257, 4096)
                    for v in (1, 100, 128, 512)]


def huffman_case(dist, v, planes=1, n=200, seed=0):
    """One segment's worth of Huffman records and a load of them ->
    (payload, starts, table, bases, base_of, want).

    ``dist``: "skewed" or "uniform" bytes, "prop-like" fp32 rows,
    "constant" (a single-symbol table: 1-bit codes) or "long-codes" (a
    table whose rarest symbols take the full 16 bits, drawn uniformly so
    they occur). ``planes`` > 1 codes byte j with plane table j % planes.
    The load asks for 3/4 of the rows in random order, the last record
    (it ends at the payload's last byte) among them; 3 chunk bases, each
    row XOR-ed with one or none (``base_of`` = -1) at random."""
    rng = np.random.default_rng(seed)
    if dist == "prop-like":
        data = make_vector_dataset("prop-like", n, v // 4, seed=seed
                                   ).view(np.uint8).reshape(n, v)
    elif dist == "skewed":
        data = (rng.gamma(1.0, 10.0, size=(n, v)) % 256).astype(np.uint8)
    elif dist == "uniform":
        data = rng.integers(0, 256, (n, v), dtype=np.uint8)
    elif dist == "constant":
        data = np.full((n, v), 7, dtype=np.uint8)
    elif dist == "long-codes":
        data = rng.integers(0, 30, (n, v)).astype(np.uint8)
    else:
        raise ValueError(dist)
    if dist == "long-codes":
        freqs = np.zeros(256, np.int64)
        freqs[:30] = 2 ** np.arange(30)[::-1]
        table = huffman.HuffmanTable.from_frequencies(freqs)
    elif planes > 1:
        table = huffman.PlaneTables.from_data(data, planes)
    else:
        table = huffman.HuffmanTable.from_data(data)
    payload, offsets = huffman.encode_records(data, table)
    rows = rng.permutation(n)[:max(1, 3 * n // 4)]
    if n - 1 not in rows:
        rows[0] = n - 1
    bases = rng.integers(0, 256, (3, v), dtype=np.uint8)
    base_of = rng.integers(-1, 3, len(rows)).astype(np.int32)
    want = data[rows] ^ np.where(base_of[:, None] >= 0,
                                 bases[np.maximum(base_of, 0)], 0)
    return payload, offsets[:-1][rows], table, bases, base_of, want


#: The sweep of the load path's op: one table and plane tables (P = 2, 4,
#: 8) over the row widths of the repo's datasets, and the hazards.
HUFFMAN_CASES = {
    **{f"one-table-v{v}": dict(dist="skewed", v=v) for v in (16, 100, 128,
                                                             512)},
    **{f"planes2-v{v}": dict(dist="skewed", v=v, planes=2)
       for v in (16, 100, 128, 512)},
    **{f"planes4-v{v}": dict(dist="prop-like", v=v, planes=4)
       for v in (16, 100, 128, 512)},
    "planes8-v128": dict(dist="skewed", v=128, planes=8),
    "uniform-v128": dict(dist="uniform", v=128),
    "single-symbol": dict(dist="constant", v=100),
    "16-bit-codes": dict(dist="long-codes", v=128),
    "one-row": dict(dist="skewed", v=25, n=1),
}


def ef_slots(r_max, universe, seed):
    """Slots of lists of lengths 0, 1, r_max, r_max/2, 13, 0 -> (uint32
    slots [6, W], the sorted lists)."""
    rng = np.random.default_rng(seed)
    lens = [0, 1, r_max, r_max // 2, min(13, r_max), 0]
    truth = [np.sort(rng.choice(universe, size=ln, replace=False)
                     ).astype(np.uint64) for ln in lens]
    return np.stack([encode_slot(v, r_max, universe) for v in truth]), truth


def beam_case(nq, e, l_size, m, seed, mask_p=0.85, ties=False,
              cands="sorted", ids="random"):
    """(pq_codes [n, M], luts, cand_ids, cand_d, new_ids) of one hop.

    ``cands``: "sorted" by distance (what the search passes), "unsorted",
    or "first-hop" (one finite candidate, L-1 empty at +inf). ``ids``:
    "random" rows of the table, "edges" (0, n-1 and ids past the end,
    which clip to n-1), or "repeated" (a few rows, each many times)."""
    rng = np.random.default_rng(seed)
    n = 3 * e + 5
    pq_codes = rng.integers(0, 256, (n, m), dtype=np.uint8)
    luts = rng.normal(size=(nq, m, 256)).astype(np.float32)
    if ties:   # quantize hard so merged distances collide constantly
        luts = np.round(luts)
    cand_d = rng.normal(size=(nq, l_size)).astype(np.float32) ** 2
    if ties:
        cand_d = np.round(cand_d * 2) / 2
    if cands != "unsorted":
        cand_d = np.sort(cand_d, 1)
    cand_ids = rng.integers(0, 10**6, (nq, l_size)).astype(np.int32)
    if cands == "first-hop":
        cand_d[:, 1:] = np.inf
        cand_ids[:, 1:] = -1
    if ids == "edges":
        rows = rng.choice(np.array([0, n - 1, n, n + 7, 1]), (nq, e))
    elif ids == "repeated":
        rows = rng.integers(0, 3, (nq, e))
    else:
        rows = rng.integers(0, n, (nq, e))
    new_ids = np.where(rng.random((nq, e)) < mask_p, rows, -1
                       ).astype(np.int32)
    return pq_codes, luts, cand_ids, cand_d, new_ids


BEAM_CASES = {
    "ragged-1": dict(nq=1, e=1, l_size=1, m=1, seed=1),
    "ragged-2": dict(nq=3, e=5, l_size=4, m=8, seed=2),
    "ragged-3": dict(nq=7, e=130, l_size=48, m=4, seed=3),
    "ragged-4": dict(nq=2, e=17, l_size=10, m=16, seed=4),
    "world-hop": dict(nq=8, e=96, l_size=48, m=8, seed=5),
    "shard-hop": dict(nq=16, e=512, l_size=200, m=32, seed=6),
    "ties": dict(nq=4, e=40, l_size=16, m=4, seed=7, ties=True),
    "all-masked": dict(nq=3, e=12, l_size=8, m=8, seed=11, mask_p=0.0),
    "unsorted-cands": dict(nq=5, e=64, l_size=32, m=8, seed=12,
                           cands="unsorted"),
    "unsorted-ties": dict(nq=3, e=40, l_size=20, m=4, seed=13, ties=True,
                          cands="unsorted"),
    "first-hop": dict(nq=4, e=96, l_size=48, m=8, seed=14,
                      cands="first-hop"),
    "shard-first-hop": dict(nq=2, e=512, l_size=200, m=32, seed=15,
                            cands="first-hop"),
    "id-edges": dict(nq=3, e=40, l_size=16, m=16, seed=16, ids="edges"),
    "repeated-ids": dict(nq=4, e=50, l_size=20, m=4, seed=17,
                         ids="repeated"),
    "odd-width": dict(nq=3, e=30, l_size=12, m=3, seed=18),
}


def table_ids(nq, e, n, rng, ids):
    """[nq, e] int32 row ids into a table of n rows. ``ids``: "random"
    (30% masked with -1), "edges" (0, n-1, ids past either end), "repeated"
    (rows 0..2, some -1), "masked-row" (random, row 0 all -1),
    "all-masked"."""
    if ids == "edges":
        rows = rng.choice(np.array([0, n - 1, n, n + 7, -1, -4, 1]), (nq, e))
    elif ids == "repeated":
        rows = rng.integers(-1, 3, (nq, e))
    elif ids == "all-masked":
        rows = np.full((nq, e), -1)
    else:
        rows = np.where(rng.random((nq, e)) < 0.7,
                        rng.integers(0, n, (nq, e)), -1)
        if ids == "masked-row" and nq:
            rows[0] = -1
    return rows.astype(np.int32)


def adc_ids_case(nq, e, m, seed, ids="random"):
    """(pq_codes [n, M] uint8, luts [nq, M, 256], ids [nq, E] int32): the
    by-id form of pq_adc_batched (ids as ``table_ids`` makes them)."""
    rng = np.random.default_rng(seed)
    n = 3 * e + 5
    table = rng.integers(0, 256, (n, m), dtype=np.uint8)
    luts = rng.normal(size=(nq, m, 256)).astype(np.float32)
    return table, luts, table_ids(nq, e, n, rng, ids)


#: pq_adc_batched by id: the hop and the entry (E = 1), one query, ids at
#: the table's edges and past them, repeats, masked rows, odd and wide
#: rows, more rows than one group of the kernel (512), and no rows.
ADC_ID_CASES = {
    "world-hop": dict(nq=8, e=96, m=8, seed=1),
    "shard-hop": dict(nq=4, e=512, m=32, seed=2),
    "entry": dict(nq=32, e=1, m=8, seed=3),
    "one-query": dict(nq=1, e=130, m=32, seed=4),
    "id-edges": dict(nq=3, e=40, m=16, seed=5, ids="edges"),
    "repeated-ids": dict(nq=4, e=50, m=4, seed=6, ids="repeated"),
    "masked-row": dict(nq=3, e=30, m=8, seed=7, ids="masked-row"),
    "all-masked": dict(nq=2, e=12, m=8, seed=8, ids="all-masked"),
    "odd-width": dict(nq=3, e=20, m=3, seed=9),
    "two-groups": dict(nq=2, e=700, m=8, seed=10),
    "empty": dict(nq=3, e=0, m=8, seed=11),
}


def rerank_ids_case(q, c, d, seed, dtype=np.uint8, ids="random"):
    """(queries [Q, D] f32, table [N, D] of ``dtype``, ids [Q, C] int32):
    the by-id form of rerank_l2. Every id is kept ("random" draws no -1;
    "edges" ids past either end clip)."""
    rng = np.random.default_rng(seed)
    n = 2 * q * c + 3
    queries = (rng.normal(size=(q, d)) * 20).astype(np.float32)
    table = (rng.integers(0, 256, (n, d)) if dtype == np.uint8
             else rng.normal(size=(n, d))).astype(dtype)
    rows = (rng.integers(0, n, (q, c)).astype(np.int32) if ids == "random"
            else table_ids(q, c, n, rng, ids))
    return queries, table, rows


#: rerank_l2 by id: the re-rank batch (C = 10) at the small world's and
#: the shard's widths, one query, one candidate, more than 32 candidates,
#: D not a multiple of 16, ids at the edges (clipped), repeats, no rows.
RERANK_ID_CASES = {
    "world-batch": dict(q=16, c=10, d=32, seed=1),
    "shard-batch": dict(q=8, c=10, d=128, seed=2),
    "one-query": dict(q=1, c=10, d=128, seed=3),
    "one-cand": dict(q=5, c=1, d=8, seed=4),
    "many-cands": dict(q=3, c=70, d=32, seed=5),
    "d100": dict(q=4, c=9, d=100, seed=6),
    "d129": dict(q=3, c=5, d=129, seed=7),
    "id-edges": dict(q=3, c=12, d=32, seed=8, ids="edges"),
    "repeated-ids": dict(q=4, c=20, d=16, seed=9, ids="repeated"),
    "empty": dict(q=3, c=0, d=32, seed=10),
}


def rerank_loop_case(nq, d, l_size, seed, dtype=np.uint8):
    """(queries [nq, D] f32, table [n, D] of ``dtype``, cand_ids [nq, L]
    int32, tombstone [n] bool): candidate lists as a traversal leaves them,
    each row's ids in a noisy order of their exact distance (so later
    batches still move the heap), with ties (the table's second half
    repeats its first, and rows list some ids twice), a tail of -1 on a
    third of the rows, a -1 inside one row and an id past the table's end
    (it clips); a fifth of the rows tombstoned."""
    rng = np.random.default_rng(seed)
    half = max(32, 2 * l_size)
    n = 2 * half
    base = (rng.integers(0, 256, (half, d)) if dtype == np.uint8
            else rng.normal(size=(half, d)))
    table = np.concatenate([base, base]).astype(dtype)
    queries = (rng.uniform(0, 255, (nq, d)) if dtype == np.uint8
               else rng.normal(size=(nq, d))).astype(np.float32)
    cand = np.empty((nq, l_size), np.int64)
    for i in range(nq):
        ids = rng.choice(n, l_size, replace=False)
        twice = rng.choice(l_size, l_size // 8, replace=False)
        ids[twice] = ids[rng.choice(l_size, len(twice))]
        exact = ((table[ids].astype(np.float64) - queries[i]) ** 2).sum(1)
        cand[i] = ids[np.argsort(exact * (1 + 0.3 * rng.normal(
            size=l_size)), kind="stable")]
        if i % 3 == 1:
            cand[i, rng.integers(0, l_size):] = -1
    cand[0, l_size // 2] = -1
    cand[-1, 1] = n + 5
    return queries, table, cand.astype(np.int32), rng.random(n) < 0.2


#: The re-rank's rows: the three serve cells' dtypes and widths.
RERANK_LOOP_ROWS = {"u8-d128": (np.uint8, 128), "f32-d96": (np.float32, 96),
                    "f32-d768": (np.float32, 768)}
#: Benefit thresholds: 0.1 and the float32 just above it (at B = 10 one
#: displaced entry reads exactly 0.1f, below only the second), the
#: default, half, every batch below, none below.
RERANK_LOOP_THRESHOLDS = (
    0.1, float(np.nextafter(np.float32(0.1), np.float32(1))), 0.01, 0.5,
    1.0, 0.0)


def ef_ids(n_slots):
    """Row ids into a table of ``n_slots`` slots: both edges, repeats, and
    ids past either end (they clip)."""
    return np.array([n_slots - 1, 0, 2, 2, 3, 1, 4, 0, n_slots - 1, -3,
                     n_slots + 93, 1], dtype=np.int32)


def round_case(nq, l_size, w, r_max, universe, m, bits, seed, n=4096,
               pool=None, ties=False, max_iters=64, k_b=20):
    """A traversal part-way through and the tables its rounds read ->
    (ef_slots [n, words] int32, pq_codes [n, M] uint8, luts [nq, M, 256]
    f32, state: a dict of numpy arrays in ``kernels/search_round``'s
    names).

    Lists hold 0 to r_max ids (every 7th full) drawn from ``pool`` ids of
    the universe, so a small pool puts the same id in several of a round's
    lists; each row's hash table of 2^bits slots holds a sample of the
    pool at its slots (ids already visited) and random ids elsewhere;
    with ``ties`` the candidate distances take four values, zeros of both
    signs and -inf among them. Rows start active or frozen, every 5th one
    round from ``max_iters``; ``prev_top`` is the sorted top-``k_b`` of
    the list in half the rows."""
    from repro_torch.kernels.search_round.search_round import hash_slots
    rng = np.random.default_rng(seed)
    ids_pool = rng.choice(universe, size=min(pool or universe, universe,
                                             1 << 20), replace=False)
    counts = rng.integers(0, min(r_max, len(ids_pool)) + 1, n)
    counts[::7] = min(r_max, len(ids_pool))
    slots = np.stack([encode_slot(np.sort(rng.choice(ids_pool, c,
                                                     replace=False))
                                  .astype(np.uint64), r_max, universe)
                      for c in counts]).view(np.int32)
    pq_codes = rng.integers(0, 256, (n, m), dtype=np.uint8)
    luts = rng.normal(size=(nq, m, 256)).astype(np.float32) ** 2
    if ties:
        luts = np.round(luts)
    cand_ids = np.full((nq, l_size), -1, np.int32)
    cand_d = np.full((nq, l_size), np.inf, np.float32)
    for q in range(nq):
        nv = int(rng.integers(1, l_size + 1))
        cand_ids[q, :nv] = rng.choice(n, nv, replace=False)
        d = (rng.integers(0, 4, nv) / 2 if ties
             else rng.random(nv) * 10).astype(np.float32)
        if ties:
            d[d == 0] *= rng.choice(np.float32([1, -1]), int((d == 0).sum()))
            if q % 3 == 0:
                d[0] = -np.inf
        cand_d[q, :nv] = np.sort(d)
    expanded = (rng.random((nq, l_size)) < 0.5) & (cand_ids >= 0)
    h = 1 << bits
    visited = np.full((nq, h + 1), -1, np.int32)
    for q in range(nq):
        seen = rng.choice(ids_pool, min(len(ids_pool), 64), replace=False)
        visited[q, hash_slots(torch.from_numpy(seen), bits).numpy()] = seen
        visited[q, rng.integers(0, h, 16)] = rng.integers(0, universe, 16)
    iters = rng.integers(0, max_iters, nq).astype(np.int32)
    iters[::5] = max_iters - 1
    kb = min(k_b, l_size)
    prev_top = np.sort(cand_ids[:, :kb], 1)
    prev_top[1::2] = rng.integers(-1, n, (nq // 2, kb))
    state = dict(
        cand_ids=cand_ids, cand_d=cand_d, expanded=expanded,
        active=rng.random(nq) < 0.85, visited=visited,
        fetched=rng.integers(0, 100, nq).astype(np.int32),
        pq_ct=rng.integers(0, 100, nq).astype(np.int32), iters=iters,
        stab=rng.integers(0, 12, nq).astype(np.int32),
        pf_iter=np.where(rng.random(nq) < 0.5, -1,
                         rng.integers(0, max_iters, nq)).astype(np.int32),
        prev_top=prev_top.astype(np.int32), flag=np.array(True))
    return slots, pq_codes, luts, state


#: Rounds of the traversal's bookkeeping: the small world's shapes; the
#: same id in several lists (a pool of 40 ids); a table of 8 slots (many
#: new ids to a slot); ties of distances, -0/+0 and -inf; rows that reach
#: max_iters; W = 1 and r_max = 1; the most a block takes (L 1024, W * R
#: 1024); and the serve cells' shapes (W 4, R 128, L 200, hash bits 15,
#: the EF slots of a 31.25M-vector shard) at nq 1, 8, 32 and 1,024, M 32
#: and M 384.
ROUND_CASES = {
    "world": dict(nq=9, l_size=32, w=4, r_max=12, universe=400, m=4,
                  bits=10, seed=1, n=400),
    "shared-ids": dict(nq=8, l_size=48, w=4, r_max=24, universe=5000, m=8,
                       bits=10, seed=2, pool=40),
    "one-slot-table": dict(nq=8, l_size=48, w=4, r_max=24, universe=5000,
                           m=8, bits=3, seed=3, pool=200),
    "ties": dict(nq=12, l_size=64, w=4, r_max=16, universe=5000, m=8,
                 bits=10, seed=4, ties=True),
    "max-iters": dict(nq=32, l_size=32, w=4, r_max=12, universe=400, m=4,
                      bits=10, seed=5, n=400, max_iters=3),
    "w1-r1": dict(nq=5, l_size=7, w=1, r_max=1, universe=300, m=4, bits=6,
                  seed=6, n=300),
    "block-max": dict(nq=4, l_size=1024, w=8, r_max=128, universe=100000,
                      m=8, bits=12, seed=7, pool=3000, k_b=1024),
    "serve-1": dict(nq=1, l_size=200, w=4, r_max=128, universe=31_250_000,
                    m=32, bits=15, seed=8),
    "serve-8": dict(nq=8, l_size=200, w=4, r_max=128, universe=31_250_000,
                    m=32, bits=15, seed=9),
    "serve-32": dict(nq=32, l_size=200, w=4, r_max=128,
                     universe=31_250_000, m=32, bits=15, seed=10),
    "serve-1024": dict(nq=1024, l_size=200, w=4, r_max=128,
                       universe=31_250_000, m=32, bits=15, seed=11),
    "serve-1024-m384": dict(nq=1024, l_size=200, w=4, r_max=128,
                            universe=31_250_000, m=384, bits=15, seed=12),
}


def _bits(x):
    x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_bits_equal(a, b):
    np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.fixture
def cuda():
    """The card; tests that take it skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernels)")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def _unaligned(t, shift):
    """A copy of ``t`` that starts ``shift`` elements past an allocation's
    start (off 16-byte alignment)."""
    flat = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
    return flat[shift:].view(t.shape).copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_beam_step_kernel(cuda, case):
    args = _on(cuda, *beam_case(**BEAM_CASES[case]))
    for got, want in zip(beam_step_cuda(*args), beam_step_ref(*args)):
        assert_bits_equal(got, want)


#: The fused hop beyond 32-byte rows: folded straight from the table (33,
#: 48) while the LUT fits a block, else (384 up) staged in 32-sub-space
#: slices: 16-, 8- and 1-byte slice loads (384, 392, 385), the serve
#: cell's hop (E = 512, L = 200), its first hop, all masked, and no ids.
WIDE_BEAM_CASES = {
    "m33": dict(nq=3, e=20, l_size=8, m=33, seed=33),
    "m48": dict(nq=3, e=20, l_size=8, m=48, seed=48),
    "m384": dict(nq=3, e=20, l_size=8, m=384, seed=384),
    "m392": dict(nq=3, e=20, l_size=8, m=392, seed=392),
    "m385": dict(nq=2, e=40, l_size=16, m=385, seed=385),
    "m384-hop": dict(nq=16, e=512, l_size=200, m=384, seed=6),
    "m384-first-hop": dict(nq=4, e=512, l_size=200, m=384, seed=15,
                           cands="first-hop"),
    "m384-all-masked": dict(nq=3, e=12, l_size=8, m=384, seed=11,
                            mask_p=0.0),
    "m384-no-ids": dict(nq=2, e=0, l_size=8, m=384, seed=12),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WIDE_BEAM_CASES))
def test_beam_step_kernel_wide_rows(cuda, case):
    """Rows wider than 32 bytes, and LUTs wider than a block's shared
    memory, bit for bit (no reference case: jnp's sum is a left fold only
    up to M = 32)."""
    args = _on(cuda, *beam_case(**WIDE_BEAM_CASES[case]))
    for got, want in zip(beam_step_cuda(*args), beam_step_ref(*args)):
        assert_bits_equal(got, want)


@pytest.mark.cuda
def test_beam_step_lut_slices_follow_the_cards_shared_memory(cuda):
    """The fused hop stages the whole LUT at the shards' M = 32 and in
    32-sub-space slices where M * K * 4 bytes and the block's keys pass
    what a block may take (227 KB on an H100)."""
    assert lut_slices(32, 256, 512, 200) == 1
    assert lut_slices(200, 256, 512, 200) == 1
    assert lut_slices(384, 256, 512, 200) == 12
    assert lut_slices(385, 256, 512, 200) == 13
    assert lut_slices(384, 16, 512, 200) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("m", [32, 384])
def test_beam_step_kernel_unaligned_luts(cuda, m):
    """LUTs off 16-byte alignment are staged without the bulk copy, whole
    (M = 32) or slice by slice (M = 384)."""
    args = _on(cuda, *beam_case(4, 100, 32, m, seed=m + 1))
    args[1] = _unaligned(args[1], 1)
    for got, want in zip(beam_step_cuda(*args), beam_step_ref(*args)):
        assert_bits_equal(got, want)


@pytest.mark.cuda
def test_ef_decode_kernel_reads_rows_by_id(cuda):
    """Rows by id from the shard-sized layout (R=128, U=31.25M): each
    equals the decode of its own slot, ids past either end clip."""
    slots, _ = ef_slots(128, 31_250_000, seed=4)
    (s,) = _on(cuda, slots.view(np.int32))
    ids = torch.from_numpy(ef_ids(len(slots))).to(cuda)
    got = ef_decode_cuda(s, 128, 31_250_000, ids)
    whole = ef_decode_cuda(s, 128, 31_250_000)
    rows = ids.long().clamp(0, len(slots) - 1)
    for g, w, full in zip(got, ef_decode_ref(s, 128, 31_250_000, ids),
                          whole):
        assert_bits_equal(g, w)
        assert_bits_equal(g, full[rows])


@pytest.mark.cuda
@pytest.mark.parametrize("nq,n,m,equal", [(1, 1, 8, False),
                                          (3, 130, 16, False),
                                          (8, 300, 32, False),
                                          (2, 129, 32, True)])
def test_pq_adc_batched_kernel(cuda, nq, n, m, equal):
    codes, luts = _on(cuda, *adc_case(nq, n, m, seed=n + m,
                                      equal_codes=equal))
    assert_bits_equal(pq_adc_batched_cuda(codes, luts),
                      pq_adc_batched_ref(codes, luts))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ADC_ID_CASES))
def test_pq_adc_batched_kernel_by_id(cuda, case):
    """Rows by id (+inf where masked) == the plain version, and == the
    kernel without ids on the gathered rows, masked."""
    table, luts, ids = _on(cuda, *adc_ids_case(**ADC_ID_CASES[case]))
    got = pq_adc_batched_cuda(table, luts, ids)
    assert_bits_equal(got, pq_adc_batched_ref(table, luts, ids))
    rows = table[ids.clamp(0, len(table) - 1).long()]
    assert_bits_equal(got, torch.where(ids >= 0,
                                       pq_adc_batched_cuda(rows, luts),
                                       torch.inf))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [32, 384, 385, 392])
@pytest.mark.parametrize("ids", ["random", "edges", "all-masked"])
def test_pq_adc_batched_kernel_wide_luts(cuda, m, ids):
    """M = 384 (a LUT in 12 slices), ragged and 8-byte rows, and M = 32
    (the whole LUT): by id == the plain version, and without ids on the
    gathered rows; more rows than one group of the kernel."""
    table, luts, rows = _on(cuda, *adc_ids_case(3, 600, m, seed=m, ids=ids))
    got = pq_adc_batched_cuda(table, luts, rows)
    assert_bits_equal(got, pq_adc_batched_ref(table, luts, rows))
    gathered = table[rows.clamp(0, len(table) - 1).long()]
    assert_bits_equal(pq_adc_batched_cuda(gathered, luts),
                      pq_adc_batched_ref(gathered, luts))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 16, 32, 48, 384])
@pytest.mark.parametrize("shift", [1, 4, 8])
def test_pq_adc_batched_kernel_unaligned(cuda, m, shift):
    """A table off 16-byte alignment (8-, 4- and 1-byte row loads) and
    LUTs off it (staged without the bulk copy)."""
    table, luts, ids = _on(cuda, *adc_ids_case(5, 64, m, seed=m + shift))
    table, luts = _unaligned(table, shift), _unaligned(luts, 1)
    assert_bits_equal(pq_adc_batched_cuda(table, luts, ids),
                      pq_adc_batched_ref(table, luts, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,dtype,equal", [(1, 8, np.uint8, False),
                                             (1024, 8, np.uint8, False),
                                             (4096, 8, np.int32, False),
                                             (3000, 32, np.uint8, False),
                                             (129, 32, np.uint8, True)])
def test_pq_adc_kernel(cuda, n, m, dtype, equal):
    codes, lut = _on(cuda, *single_adc_case(n, m, seed=n + m, dtype=dtype,
                                            fill=3 if equal else None))
    assert_bits_equal(pq_adc_cuda(codes, lut), pq_adc_ref(codes, lut))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("k", [16, 256])
@pytest.mark.parametrize("m", SINGLE_ADC_M)
def test_pq_adc_kernel_sweep(cuda, m, k, dtype):
    """Every n of the sweep: uint8 rows of M = 32 take the lagged path,
    the others the row path (16-, 8-, 4- or 1-byte loads, or none)."""
    for n in SINGLE_ADC_N:
        codes, lut = _on(cuda, *single_adc_case(n, m, seed=n + m + k,
                                                dtype=dtype, k=k))
        assert_bits_equal(pq_adc_cuda(codes, lut), pq_adc_ref(codes, lut))


@pytest.mark.cuda
@pytest.mark.parametrize("lut_shift", [0, 1])
@pytest.mark.parametrize("dtype,shift", [(np.uint8, 1), (np.uint8, 4),
                                         (np.uint8, 8), (np.int32, 4),
                                         (np.int32, 8)])
@pytest.mark.parametrize("m", [8, 12, 16, 32, 64])
def test_pq_adc_kernel_unaligned(cuda, m, dtype, shift, lut_shift):
    """Codes that start ``shift`` bytes past an aligned address (narrower
    row loads, no lagged path), with the LUT aligned or 4 bytes past it
    (staged without the bulk copy)."""
    codes, lut = _on(cuda, *single_adc_case(4099, m, seed=m + shift,
                                            dtype=dtype))
    codes = _unaligned(codes, shift // codes.element_size())
    lut = _unaligned(lut, lut_shift)
    assert codes.data_ptr() % 16 == shift % 16
    assert_bits_equal(pq_adc_cuda(codes, lut), pq_adc_ref(codes, lut))


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["zero", "top", "equal"])
@pytest.mark.parametrize("m,k", [(32, 256), (32, 16), (8, 256), (64, 16)])
def test_pq_adc_kernel_pinned_codes(cuda, m, k, fill):
    """Codes all 0, all K - 1 (the LUT's last column) or all equal: every
    row the same sum."""
    value = {"zero": 0, "top": k - 1, "equal": 3}[fill]
    for dtype in (np.uint8, np.int32):
        codes, lut = _on(cuda, *single_adc_case(4099, m, seed=m + k,
                                                dtype=dtype, k=k,
                                                fill=value))
        got = pq_adc_cuda(codes, lut)
        assert_bits_equal(got, pq_adc_ref(codes, lut))
        assert bool((got == got[0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,v", BYTEPLANE_SHAPES)
def test_byteplane_kernel(cuda, n, v):
    packed, base = _on(cuda, *byteplane_case(n, v, seed=n + v))
    assert_bits_equal(byteplane_decode_cuda(packed, base),
                      byteplane_decode_ref(packed, base))


@pytest.mark.cuda
def test_byteplane_kernel_on_unaligned_rows(cuda):
    """A slice that starts mid-word (100-byte rows) takes the byte-wise
    path and still equals the plain version."""
    packed, base = _on(cuda, *byteplane_case(300, 100, seed=9))
    rows = packed[1:258]
    assert rows.data_ptr() % 16
    assert_bits_equal(byteplane_decode_cuda(rows, base),
                      byteplane_decode_ref(rows, base))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(HUFFMAN_CASES))
def test_huffman_decode_kernel(cuda, case):
    """The load path's kernel against its plain version: as the case
    comes, with the payload at an odd address, with no base at all."""
    kw = HUFFMAN_CASES[case]
    payload, starts, table, bases, base_of, want = huffman_case(**kw)
    p, st, b, bo = _on(cuda, payload, starts, bases, base_of)
    odd = torch.zeros(len(payload) + 3, dtype=torch.uint8, device=cuda)[3:]
    odd.copy_(p)
    none = torch.full_like(bo, -1)
    for args in ((p, st, kw["v"], table, b, bo),
                 (odd, st, kw["v"], table, b, bo),
                 (p, st, kw["v"], table, b[:0], none)):
        got = huffman_decode_cuda(*args)
        assert_bits_equal(got, huffman_decode_ref(*args))
    assert_bits_equal(huffman_decode_cuda(p, st, kw["v"], table, b, bo), want)


@pytest.mark.cuda
def test_huffman_decode_kernel_empty_load(cuda):
    payload, starts, table, bases, base_of, _ = huffman_case("skewed", 16)
    p, st, b, bo = _on(cuda, payload, starts[:0], bases, base_of[:0])
    build.reset_launches()
    assert huffman_decode_cuda(p, st, 16, table, b, bo).shape == (0, 16)
    assert build.LAUNCHES["huffman_decode"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("codec,coresident",
                         [("auto", False), ("xor_delta_huffman", False),
                          ("plane_huffman", False), ("raw", False),
                          ("xor_delta_huffman", True)])
def test_vector_store_on_card_matches_cpu(cuda, codec, coresident):
    """Seal and load on the card (one huffman_decode launch per segment,
    none of byteplane) equal the same store on the CPU, byte for byte."""
    vecs = make_vector_dataset("prop-like", 4096, 128, seed=0)
    adj, _ = random_graph(4096, 8, seed=2)
    stores = []
    for dev in (cuda, "cpu"):
        s = DecoupledVectorStore(StoreConfig(
            dim=128, dtype=np.float32, segment_capacity=4096,
            chunk_bytes=1 << 20, vector_codec=codec, coresident=coresident,
            device=dev))
        s.set_affinity(adj)
        s.append(np.arange(4096), vecs)
        s.seal_active()
        stores.append(s)
    card, cpu = stores
    a, b = card.sealed[0], cpu.sealed[0]
    assert_bits_equal(a.packed.data, b.packed.data)
    assert [c.base is None for c in a.chunks] == \
        [c.base is None for c in b.chunks]
    build.reset_launches()
    rows = np.random.default_rng(0).permutation(4096)
    got = card.get(rows)
    assert build.LAUNCHES["huffman_decode"] == (codec != "raw")
    assert build.LAUNCHES["byteplane"] == 0
    assert_bits_equal(got, vecs[rows])
    assert_bits_equal(got, cpu.get(rows))
    assert card.io.snapshot() == cpu.io.snapshot()


@pytest.mark.cuda
@pytest.mark.parametrize("r_max,universe",
                         [(8, 64), (16, 1000), (24, 1200), (32, 10**6),
                          (1, 2), (128, 31_250_000)])
def test_ef_decode_kernel(cuda, r_max, universe):
    slots, truth = ef_slots(r_max, universe, seed=r_max)
    slots = np.concatenate([slots, np.zeros_like(slots[:1])])  # malformed
    (s,) = _on(cuda, slots.view(np.int32))
    got, want = ef_decode_cuda(s, r_max, universe), ef_decode_ref(
        s, r_max, universe)
    for g, w in zip(got, want):
        assert_bits_equal(g, w)
    ids = torch.from_numpy(ef_ids(len(slots))).to(cuda)
    for g, w in zip(ef_decode_cuda(s, r_max, universe, ids),
                    ef_decode_ref(s, r_max, universe, ids)):
        assert_bits_equal(g, w)
    for i, vals in enumerate(truth):
        np.testing.assert_array_equal(
            got[0][i, :len(vals)].cpu().numpy(), vals.astype(np.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("q,c,d", [(1, 1, 8), (7, 20, 100), (32, 10, 32),
                                   (9, 130, 128), (3, 5, 129)])
def test_rerank_l2_kernel(cuda, q, c, d, dtype):
    rng = np.random.default_rng(q + c + d)
    queries = (rng.normal(size=(q, d)) * 20).astype(np.float32)
    cands = (rng.integers(0, 256, (q, c, d)) if dtype == np.uint8
             else rng.normal(size=(q, c, d))).astype(dtype)
    qt, xt = _on(cuda, queries, cands)
    assert_bits_equal(rerank_l2_cuda(qt, xt), rerank_l2_ref(qt, xt))


#: rerank_l2 cases of the card only: rows over several of the kernel's
#: 512-byte tiles, and the 768-d float32 re-rank batch (3 KiB rows).
LONG_RERANK_CASES = {"long-rows": dict(q=3, c=6, d=1100, seed=11),
                     "d768-batch": dict(q=64, c=10, d=768, seed=12)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("case", sorted(RERANK_ID_CASES)
                         + sorted(LONG_RERANK_CASES))
def test_rerank_l2_kernel_by_id(cuda, case, dtype):
    """Rows by id (clipped) == the plain version, and == the kernel
    without ids on the gathered rows."""
    kw = RERANK_ID_CASES.get(case) or LONG_RERANK_CASES[case]
    qt, xt, ids = _on(cuda, *rerank_ids_case(dtype=dtype, **kw))
    got = rerank_l2_cuda(qt, xt, ids)
    assert_bits_equal(got, rerank_l2_ref(qt, xt, ids))
    rows = xt[ids.clamp(0, len(xt) - 1).long()]
    assert_bits_equal(got, rerank_l2_cuda(qt, rows))


def _rerank_index(vectors, tombstone):
    """A DeviceIndex holding only what the re-rank reads."""
    return DeviceIndex(None, None, None, None, None, vectors, None,
                       tombstone)


def _rerank_both(cuda, case, p, max_batches):
    """The re-rank of ``case`` on the card and on the CPU, through
    ``beam.rerank`` (p's tombstone filter) and through the op itself
    (``max_batches`` as given), held bit for bit -> the CPU's batches."""
    from repro_torch.core.search import beam
    cpu = [torch.from_numpy(x) for x in case]
    card = [x.to(cuda) for x in cpu]
    got = beam.rerank(_rerank_index(card[1], card[3]), card[0], card[2], p)
    want = beam.rerank(_rerank_index(cpu[1], cpu[3]), cpu[0], cpu[2], p)
    for a, b in zip(got[:2] + got[2], want[:2] + want[2]):
        assert_bits_equal(a, b)
    tomb = (lambda t: t[3] if p.filter_tombstones else None)
    args = (p.k, p.rerank_batch, max_batches, p.benefit_threshold)
    got = rerank_loop_cuda(*card[:3], *args, tomb(card))
    want = rerank_loop_ref(*cpu[:3], *args, tomb(cpu))
    for a, b in zip(got, want):
        assert_bits_equal(a, b)
    return want[2]


@pytest.mark.cuda
@pytest.mark.parametrize("max_batches", [0, 1, 16])
@pytest.mark.parametrize("k,b", [(10, 10), (24, 16)])
@pytest.mark.parametrize("rows", sorted(RERANK_LOOP_ROWS))
def test_rerank_loop_matches_the_plain_loop(cuda, rows, k, b, max_batches):
    """The one-launch re-rank == the plain loop on CPU copies, bit for
    bit: ids, distances, batches run and exact distance counts, at each
    benefit threshold, tombstones filtered and not; K + B = 40 also cuts
    its last batch at L (the op alone: the search never does)."""
    dtype, d = RERANK_LOOP_ROWS[rows]
    l_size = k + 16 * b - (3 if k + b > 32 else 0)
    case = rerank_loop_case(37, d, l_size, seed=d + k, dtype=dtype)
    ran = set()
    for thr in RERANK_LOOP_THRESHOLDS:
        for filt in (False, True):
            p = SearchParams(l_size=l_size, k=k, rerank_batch=b,
                             max_rerank_batches=max_batches,
                             benefit_threshold=thr, filter_tombstones=filt)
            ran |= set(_rerank_both(cuda, case, p, max_batches).tolist())
    assert ran == {max_batches} if max_batches < 2 else len(ran) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("rows", sorted(RERANK_LOOP_ROWS))
def test_rerank_loop_kernel_at_the_serve_shapes(cuda, rows):
    """1,024 queries, L = 200, K = B = 10, up to 16 batches at the default
    threshold, on an unaligned table too: card == CPU bit for bit."""
    dtype, d = RERANK_LOOP_ROWS[rows]
    case = rerank_loop_case(1024, d, 200, seed=d, dtype=dtype)
    p = SearchParams(l_size=200, k=10, rerank_batch=10)
    assert len(set(_rerank_both(cuda, case, p, 16).tolist())) > 1
    q, table, cand, _ = _on(cuda, *case)
    shifted = _unaligned(table, 1 if dtype == np.uint8 else 3)
    for a, b in zip(rerank_loop_cuda(q, shifted, cand, 10, 10, 16, 0.01),
                    rerank_loop_cuda(q, table, cand, 10, 10, 16, 0.01)):
        assert_bits_equal(a, b)


@pytest.mark.cuda
def test_search_reranks_in_one_launch_without_a_read_back(cuda):
    """One search_batched on the card: one rerank_loop launch, no
    rerank_l2 launch, no search.sync inside search.rerank (whose span says
    fused 1), and the same answers as the CPU's plain loop."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tracing
    vecs = make_vector_dataset("prop-like", 400, 16, seed=3)
    on_cpu, _, _ = build_device_index(vecs, r=12, l_build=24, pq_m=4,
                                      seed=3, device="cpu")
    on_card = DeviceIndex(*(None if t is None else t.to(cuda)
                            for t in on_cpu))
    queries = make_queries("prop-like", 37, 16)
    p = SearchParams(l_size=32, beam_width=4, k=10, rerank_batch=10,
                     r_max=12, universe=400, max_iters=64,
                     visited_hash_bits=10)
    search(on_card, queries, p)   # built and captured before the count
    build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        got = search(on_card, queries, p)
    assert build.LAUNCHES["rerank_loop"] == 1
    assert build.LAUNCHES["rerank_l2"] == 0
    spans = [(ev.name[len(tracing.PREFIX):], ev.time_range, ev.kwinputs)
             for ev in prof.events() if ev.name.startswith(tracing.PREFIX)]
    (rr, args), = [(t, a) for name, t, a in spans if name == "search.rerank"]
    assert args == {"fused": 1}
    assert not [t for name, t, _ in spans if name == "search.sync"
                and rr.start <= t.start and t.end <= rr.end]
    want = search(on_cpu, queries, p, device="cpu")
    for a, b in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        assert_bits_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [1, 2, 4, 8])
def test_rerank_l2_kernel_unaligned(cuda, shift):
    """A uint8 table off 16-byte alignment: 8-, 4- and 1-byte loads."""
    qt, xt, ids = _on(cuda, *rerank_ids_case(6, 10, 128, seed=shift))
    xt = _unaligned(xt, shift)
    assert_bits_equal(rerank_l2_cuda(qt, xt, ids),
                      rerank_l2_ref(qt, xt, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,m,dtype", [(600, 32, 8, np.float32),
                                         (3000, 128, 32, np.uint8),
                                         (50, 8, 8, np.float32),
                                         (3000, 96, 32, np.float32),
                                         (700, 96, 32, np.uint8),
                                         (700, 768, 32, np.float32),
                                         (300, 40, 8, np.float32),
                                         (300, 48, 8, np.uint8),
                                         (600, 768, 384, np.float32)])
def test_pq_encode_kernel(cuda, n, d, m, dtype):
    """Templated widths (dsub 1, 2, 3, 4) and the generic path (dsub 5, 6,
    24), duplicated centroids (ties) in every sub-space."""
    rng = np.random.default_rng(n)
    x = (rng.integers(0, 40, (n, d)) if dtype == np.uint8
         else rng.normal(size=(n, d))).astype(dtype)
    cents = (rng.normal(size=(m, 256, d // m)) * 10).astype(np.float32)
    cents[:, 200:] = cents[:, :56]                    # duplicated centroids
    xt, ct = _on(cuda, x, cents)
    assert_bits_equal(pq_encode_cuda(xt, ct), pq_encode_ref(xt, ct))


@pytest.mark.cuda
def test_pq_encode_kernel_refuses_what_a_block_cannot_hold(cuda):
    """dsub 114 at K = 256 passes a block's shared memory: the launch is
    refused with a CUDA error, and the next launch runs clean."""
    with pytest.raises(RuntimeError, match="cudaError"):
        pq_encode_cuda(torch.zeros(3, 912, device=cuda),
                       torch.zeros(8, 256, 114, device=cuda))
    x, cents = _on(cuda, np.ones((5, 96), np.float32),
                   np.zeros((32, 256, 3), np.float32))
    assert (pq_encode_cuda(x, cents) == 0).all()


def _round_state(state, dev):
    return {k: torch.from_numpy(np.array(v)).to(dev)
            for k, v in state.items()}


def _same_state(got, want, stage):
    for name in want:
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]),
                                      err_msg=f"{stage}: {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_round_kernels_match_the_plain_round(cuda, case):
    """Rounds of ``round_expand`` + the fused hop + ``round_settle`` on
    the card equal the plain round (``round_expand_ref``, ``beam_step_ref``,
    ``round_settle_ref``) on the CPU, every state tensor bit for bit after
    each half."""
    from repro_torch.kernels.search_round import search_round as sr
    c = ROUND_CASES[case]
    slots, codes, luts, state = round_case(**c)
    w, r_max, universe, bits = c["w"], c["r_max"], c["universe"], c["bits"]
    max_iters, e = c.get("max_iters", 64), c["w"] * c["r_max"]
    cpu, card = _round_state(state, "cpu"), _round_state(state, cuda)
    tables = {"cpu": _on("cpu", slots, codes, luts),
              "card": _on(cuda, slots, codes, luts)}
    build.reset_launches()
    for r in range(3):
        for st, dev, expand in ((cpu, "cpu", sr.round_expand_ref),
                                (card, cuda, sr.round_expand_cuda)):
            st["new_ids"] = torch.empty((c["nq"], e), dtype=torch.int32,
                                        device=dev)
            ef = tables["cpu" if dev == "cpu" else "card"][0]
            expand(ef, r_max, universe, st["cand_ids"], st["cand_d"],
                   st["expanded"], st["active"], st["visited"],
                   st["fetched"], st["pq_ct"], st["flag"], st["new_ids"], w,
                   bits)
        _same_state(card, cpu, f"round {r} expand")
        hops = {}
        for st, key, hop in ((cpu, "cpu", beam_step_ref),
                             (card, "card", beam_step_cuda)):
            _, pq, lt = tables[key]
            hops[key] = hop(pq, lt, st["cand_ids"], st["cand_d"],
                            st["new_ids"])
        for a, b in zip(hops["card"], hops["cpu"]):
            assert_bits_equal(a, b)
        for st, key, settle in ((cpu, "cpu", sr.round_settle_ref),
                                (card, "card", sr.round_settle_cuda)):
            settle(*hops[key], st["cand_ids"], st["cand_d"], st["expanded"],
                   st["iters"], st["stab"], st["pf_iter"], st["prev_top"],
                   st["active"], st["flag"], w, 10, max_iters)
        _same_state(card, cpu, f"round {r} settle")
    assert build.LAUNCHES["round_expand"] == build.LAUNCHES[
        "round_settle"] == 3
    assert build.LAUNCHES["ef_decode"] == 0


@pytest.mark.cuda
def test_round_kernels_state_the_shapes_they_take(cuda):
    """``search_round.fits`` is the kernel library's answer: a block holds
    every serve shape and the largest round (L 1,024, W * r_max 1,024), and
    refuses a wider one, which the wrapper then will not launch."""
    from repro_torch.kernels.search_round import search_round as sr
    for l_size, w, r_max, universe, bits in (
            (200, 4, 128, 31_250_000, 15), (1, 1, 1, 300, 1),
            (1024, 8, 128, 100_000, 12), (1024, 32, 32, 2 ** 31 - 1, 30)):
        assert sr.fits(l_size, w, r_max, universe, bits)
    for l_size, w, r_max, universe, bits in (
            (1025, 4, 128, 31_250_000, 15), (200, 8, 129, 31_250_000, 15),
            (200, 33, 4, 400, 10), (200, 4, 128, 31_250_000, 31),
            (200, 4, 128, 31_250_000, 0)):
        assert not sr.fits(l_size, w, r_max, universe, bits), (l_size, w)
    c = dict(ROUND_CASES["world"], w=40)
    slots, _, _, state = round_case(**c)
    st = {k: torch.from_numpy(np.array(v)).cuda() for k, v in state.items()}
    with pytest.raises(ValueError, match="round_expand takes no round"):
        sr.round_expand_cuda(
            torch.from_numpy(slots).cuda(), c["r_max"], c["universe"],
            st["cand_ids"], st["cand_d"], st["expanded"], st["active"],
            st["visited"], st["fetched"], st["pq_ct"], st["flag"],
            torch.empty((c["nq"], c["w"] * c["r_max"]), dtype=torch.int32,
                        device="cuda"), c["w"], c["bits"])


@pytest.mark.cuda
@pytest.mark.parametrize("nq,max_iters", [(1, 64), (8, 64), (32, 5),
                                          (1024, 64), (1024, 7)])
def test_fused_traversal_matches_the_plain_one(cuda, nq, max_iters):
    """The traversal on the card with its rounds' bookkeeping in the two
    kernels (round 1 launched, the rest a replayed graph) equals the plain
    traversal on the CPU: rows that finish at different rounds, and, at a
    small max_iters, rows stopped by it."""
    from repro_torch.core.graph.pq import build_lut_torch
    from repro_torch.core.search import beam
    vecs = make_vector_dataset("prop-like", 600, 16, seed=4)
    on_cpu, _, _ = build_device_index(vecs, r=16, l_build=32, pq_m=4,
                                      seed=4, device="cpu")
    on_card = DeviceIndex(*(None if t is None else t.to(cuda)
                            for t in on_cpu))
    p = SearchParams(l_size=48, beam_width=4, k=10, rerank_batch=10,
                     r_max=16, universe=600, max_iters=max_iters,
                     visited_hash_bits=9)
    q = torch.from_numpy(make_queries("prop-like", nq, 16))
    luts = build_lut_torch(q, on_cpu.pq_centroids)
    plain = beam.traverse(on_cpu, luts, p)
    build.reset_launches()
    graphed = beam.traverse(on_card, luts.to(cuda), p)
    iters = graphed[2][0]
    assert int(iters.max()) > 2
    if max_iters < 64:
        assert bool((iters == max_iters).any())
    if nq >= 32 and max_iters == 64:
        assert int(iters.min()) < int(iters.max())
    assert build.LAUNCHES["round_expand"] == build.LAUNCHES[
        "round_settle"] == 2
    assert build.LAUNCHES["ef_decode"] == 0
    for a, b in zip(graphed[:2] + graphed[2], plain[:2] + plain[2]):
        assert_bits_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [0, 10])
def test_search_on_card_matches_cpu(cuda, bits):
    """The whole query path on the card (every kernel launched) equals the
    plain path on the CPU: ids, distances and every SearchStats field."""
    vecs = make_vector_dataset("prop-like", 400, 16, seed=3)
    on_cpu, _, _ = build_device_index(vecs, r=12, l_build=24, pq_m=4,
                                      seed=3, device="cpu")
    on_card = DeviceIndex(*(None if t is None else t.to(cuda)
                            for t in on_cpu))
    queries = make_queries("prop-like", 9, 16)
    p = SearchParams(l_size=32, beam_width=4, k=10, rerank_batch=10,
                     r_max=12, universe=400, max_iters=64,
                     visited_hash_bits=bits, trace_fetches=True,
                     trace_hints=True)
    build.reset_launches()
    got = search(on_card, queries, p)
    assert build.LAUNCHES["ef_decode"] > 0 and build.LAUNCHES["beam_step"] > 0
    # the re-rank is one launch of its whole loop
    assert build.LAUNCHES["rerank_loop"] == 1
    assert build.LAUNCHES["rerank_l2"] == 0
    # the entry's score only: the hop is beam_step
    assert build.LAUNCHES["pq_adc_batched"] == 1
    # trace buffers keep the round's bookkeeping plain
    assert build.LAUNCHES["round_expand"] == build.LAUNCHES[
        "round_settle"] == 0
    want = search(on_cpu, queries, p, device="cpu")
    assert_bits_equal(got[0], want[0])
    assert_bits_equal(got[1], want[1])
    for name, a, b in zip(want[2]._fields, got[2], want[2]):
        assert_bits_equal(a, b)


@pytest.mark.cuda
def test_traversal_replays_a_captured_round_bit_for_bit(cuda):
    """With the hash visited set and no trace buffers, the rounds after
    the first replay a CUDA graph of one round, their bookkeeping the
    round_expand and round_settle kernels: every output equals the plain
    loop's on the CPU, bit for bit."""
    from repro_torch.core.graph.pq import build_lut_torch
    from repro_torch.core.search import beam
    vecs = make_vector_dataset("prop-like", 400, 16, seed=3)
    on_cpu, _, _ = build_device_index(vecs, r=12, l_build=24, pq_m=4,
                                      seed=3, device="cpu")
    on_card = DeviceIndex(*(None if t is None else t.to(cuda)
                            for t in on_cpu))
    p = SearchParams(l_size=32, beam_width=4, k=10, rerank_batch=10,
                     r_max=12, universe=400, max_iters=64,
                     visited_hash_bits=10)
    q = torch.from_numpy(make_queries("prop-like", 9, 16))
    luts = build_lut_torch(q, on_cpu.pq_centroids)
    plain = beam.traverse(on_cpu, luts, p)
    dev = on_card.pq_codes.device
    held = beam._GRAPHS.get(dev)
    build.reset_launches()
    graphed = beam.traverse(on_card, luts.to(dev), p)
    assert beam._GRAPHS.get(dev) is not held
    assert int(graphed[2][0].max()) > 2
    # the bookkeeping is the two round kernels, in round 1 and once in
    # the captured round; the graph holds no EF decode of its own
    assert build.LAUNCHES["round_expand"] == build.LAUNCHES[
        "round_settle"] == 2
    assert build.LAUNCHES["ef_decode"] == 0
    for a, b in zip(graphed[:2] + graphed[2], plain[:2] + plain[2]):
        assert_bits_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,m", [(768, 384), (96, 32)])
def test_wide_pq_search_on_card_matches_cpu(cuda, dim, m):
    """The serve cells' PQ shapes (M = 384 over 768-d float32 rows, the
    LUT in 12 slices; M = 32 over 96-d, dsub 3): codes encoded on each
    device, then the whole search, card == CPU bit for bit."""
    rng = np.random.default_rng(dim)
    vecs = rng.normal(size=(400, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    small, _, _ = build_device_index(vecs, r=12, l_build=24, pq_m=4,
                                     seed=3, device="cpu")
    cents = torch.from_numpy(vecs[rng.choice(400, 256, replace=False)]
                             .reshape(256, m, dim // m).transpose(1, 0, 2)
                             .copy())
    on_cpu = small._replace(pq_centroids=cents, pq_codes=encode_pq_torch(
        small.vectors, cents))
    on_card = DeviceIndex(*(None if t is None else t.to(cuda)
                            for t in on_cpu))
    build.reset_launches()
    on_card = on_card._replace(pq_codes=encode_pq_torch(on_card.vectors,
                                                        on_card.pq_centroids))
    assert_bits_equal(on_card.pq_codes, on_cpu.pq_codes)
    queries = make_queries("prop-like", 9, dim)
    p = SearchParams(l_size=32, beam_width=4, k=10, rerank_batch=10,
                     r_max=12, universe=400, max_iters=64,
                     visited_hash_bits=10)
    got = search(on_card, queries, p)
    assert build.LAUNCHES["pq_encode"] > 0 and build.LAUNCHES["beam_step"] > 0
    want = search(on_cpu, queries, p, device="cpu")
    for a, b in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        assert_bits_equal(a, b)


def _serving_world(dev_cpu):
    vecs = make_vector_dataset("prop-like", 400, 16, seed=5)
    index, graph, cb = build_device_index(vecs, r=12, l_build=24, pq_m=4,
                                          seed=5, device="cpu")
    return vecs, index, graph, cb


def _same_report(a, b):
    for f in ("n_queries", "n_padded", "buckets", "graph_ios", "vector_ios",
              "cache_hits", "pq_ops", "exact_ops", "decompressions",
              "io_rounds", "rerank_batches", "snapshot_version",
              "shard_versions", "mem_candidates", "routed_rows",
              "failed_shards", "modeled_latency_us", "modeled_p99_us",
              "per_query_latency_us", "component_io", "storage_bytes"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.cuda
def test_serving_on_card_matches_cpu(cuda):
    """BatchedSearcher on the card (ragged and padded buckets) equals the
    same searcher on the CPU: ids, distances, every report field; and the
    tier adds no kernel launch to the searches it issues."""
    from repro_torch.serve.ann import BatchedSearcher, ServeConfig
    vecs, on_cpu, _, _ = _serving_world(cuda)
    on_card = DeviceIndex(*(None if t is None else t.to(cuda)
                            for t in on_cpu))
    queries = make_queries("prop-like", 37, 16)
    p = SearchParams(l_size=32, beam_width=4, k=10, rerank_batch=10,
                     r_max=12, universe=400, max_iters=64)
    cfg = ServeConfig(buckets=(8, 32), cache_bytes=1 << 14)
    card = BatchedSearcher(on_card, p, cfg)
    cpu = BatchedSearcher(on_cpu, p, cfg, device="cpu")
    build.reset_launches()
    got = card.search(queries)
    served = dict(build.LAUNCHES)
    want = cpu.search(queries, )
    np.testing.assert_array_equal(got[0], want[0])
    assert_bits_equal(torch.from_numpy(got[1]), torch.from_numpy(want[1]))
    _same_report(got[2], want[2])
    build.reset_launches()
    for start, count, bucket in [(0, 32, 32), (32, 5, 8)]:
        q = queries[start:start + count]
        q = np.concatenate([q, np.repeat(q[-1:], bucket - count, 0)])
        search(on_card, q, card.p)
    assert served == build.LAUNCHES
    assert served["beam_step"] > 0 and served["rerank_loop"] > 0


@pytest.mark.cuda
def test_sharded_serving_on_card_matches_cpu(cuda):
    from repro_torch.core.distributed.sharded_index import (
        ShardedIndex, build_router, build_sharded_index)
    from repro_torch.serve.ann import BatchedSearcher, ServeConfig
    vecs = make_vector_dataset("prop-like", 300, 16, seed=6)
    sh_cpu, per = build_sharded_index(vecs, 4, r=12, l_build=24, pq_m=4,
                                      partition="cluster", device="cpu")
    sh_card = ShardedIndex(*(t.to(cuda) for t in sh_cpu))
    router_cpu = build_router(sh_cpu, c=3)
    router_card = build_router(sh_card, c=3)
    assert torch.equal(router_card.centroids.cpu(), router_cpu.centroids)
    queries = make_queries("prop-like", 12, 16)
    p = SearchParams(l_size=32, k=5, rerank_batch=5, r_max=12,
                     universe=per, max_iters=64)
    cfg = ServeConfig(buckets=(1, 4), route_frac=0.5)
    card = BatchedSearcher(sh_card, p, cfg, shard_size=per,
                           router=router_card)
    cpu = BatchedSearcher(sh_cpu, p, cfg, shard_size=per, router=router_cpu,
                          device="cpu")
    for failed in (None, [2]):
        got = card.search(queries, failed_shards=failed)
        want = cpu.search(queries, failed_shards=failed)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        _same_report(got[2], want[2])


@pytest.mark.cuda
def test_live_index_on_card_matches_cpu(cuda):
    """A StreamingIndex with its vector store and device views on the card
    through delete, insert (the memtable lane: rerank_l2 by id over every
    buffered row), merge and GC equals the same index on the CPU."""
    from repro_torch.core.graph.pq import encode_pq, train_pq
    from repro_torch.core.graph.vamana import build_vamana
    from repro_torch.core.update.fresh import StreamingIndex, UpdateConfig
    from repro_torch.serve.ann import BatchedSearcher, ServeConfig
    vecs = make_vector_dataset("prop-like", 300, 16, seed=7).astype(
        np.float32)
    graph = build_vamana(vecs, r=12, l_build=24, seed=0)
    cb = train_pq(vecs, m=4, seed=0)
    codes = encode_pq(vecs, cb)
    idx = {}
    for name, dev in (("card", cuda), ("cpu", "cpu")):
        vs = DecoupledVectorStore(StoreConfig(dim=16, dtype=np.float32,
                                              segment_capacity=128,
                                              device=dev))
        vs.append(np.arange(300), vecs)
        vs.seal_active()
        idx[name] = StreamingIndex(graph.adjacency, graph.medoid, vs,
                                   codes.copy(), cb,
                                   UpdateConfig(r=12, l_build=24,
                                                gc_threshold=0.1,
                                                device=dev))
    p = SearchParams(l_size=32, k=5, rerank_batch=5, max_iters=64,
                     benefit_threshold=0.0)
    searchers = {name: BatchedSearcher(x.handle, p, ServeConfig(buckets=(4,)),
                                       device=x.device)
                 for name, x in idx.items()}
    q = vecs[[10, 20, 30, 40]] + 0.001
    fresh = np.stack([vecs[10] * 1.0002 + (i % 3) * 1e-3 for i in range(40)])

    def serve():
        got, want = (searchers[n].search(q) for n in ("card", "cpu"))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        _same_report(got[2], want[2])
        return got

    serve()
    for x in idx.values():
        x.delete(list(range(0, 100, 3)))
        x.insert(np.arange(300, 340), fresh)
    build.reset_launches()
    ids, _, rep = serve()
    assert build.LAUNCHES["rerank_l2"] > 0 and rep.mem_candidates == 40
    st = {n: x.merge() for n, x in idx.items()}
    for f in ("dirty_vertices", "blocks_rewritten", "blocks_appended",
              "write_bytes", "full_rebuild", "modeled_cost_us"):
        assert getattr(st["card"], f) == getattr(st["cpu"], f), f
    for a, b in zip(idx["card"].adjacency, idx["cpu"].adjacency):
        np.testing.assert_array_equal(a, b)
    ids, _, rep = serve()
    assert rep.snapshot_version == 1
    assert idx["card"].vector_store.io.snapshot() == \
        idx["cpu"].vector_store.io.snapshot()


@pytest.mark.cuda
def test_uint8_live_merge_on_card_matches_cpu(cuda):
    """A StreamingIndex over a uint8 store (the deployment's record width)
    on the card: its delete repair and inserts give the CPU index's graph
    and merge counters, and its searches the CPU's ids and distances."""
    from repro_torch.core.graph.pq import encode_pq, train_pq
    from repro_torch.core.graph.vamana import build_vamana
    from repro_torch.core.update.fresh import StreamingIndex, UpdateConfig
    vecs = make_vector_dataset("sift-like", 400, 16, seed=5)
    graph = build_vamana(vecs.astype(np.float32), r=16, l_build=32, seed=0)
    cb = train_pq(vecs.astype(np.float32), m=4, seed=0)
    codes = encode_pq(vecs.astype(np.float32), cb)
    idx = {}
    for name, dev in (("card", cuda), ("cpu", "cpu")):
        vs = DecoupledVectorStore(StoreConfig(dim=16, dtype=np.uint8,
                                              segment_capacity=256,
                                              chunk_bytes=4096, device=dev))
        vs.append(np.arange(400), vecs)
        vs.seal_active()
        idx[name] = StreamingIndex(graph.adjacency, graph.medoid, vs,
                                   codes.copy(), cb,
                                   UpdateConfig(r=16, l_build=32,
                                                merge_threshold=10**9,
                                                device=dev))
    dead = np.random.default_rng(0).choice(400, 24, replace=False)
    for x in idx.values():
        x.delete(dead)
        x.insert(np.arange(400, 408), vecs[:8].astype(np.float32))
    st = {n: x.merge() for n, x in idx.items()}
    for f in ("deleted", "inserted", "dirty_vertices", "blocks_rewritten",
              "blocks_appended", "write_bytes", "full_rebuild"):
        assert getattr(st["card"], f) == getattr(st["cpu"], f), f
    for a, b in zip(idx["card"].adjacency, idx["cpu"].adjacency):
        np.testing.assert_array_equal(a, b)
    q = vecs[[3, 50, 99]].astype(np.float32)
    got, want = (idx[n].search_batch(q, k=5) for n in ("card", "cpu"))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("merge", ["hier", "flat"])
@pytest.mark.cuda
def test_stacked_sharded_search_on_card_matches_cpu(cuda, merge):
    """make_sharded_search's stacked form, S = 8 shards on the card,
    equals the same search on the CPU bit for bit, hier and flat alike,
    routed at 1.0 and 0.5 too; every shard's search runs the kernels."""
    from repro_torch.core.distributed.sharded_index import (
        build_router, build_sharded_index, make_mesh, make_sharded_search,
        place_on_mesh)
    vecs = make_vector_dataset("prop-like", 400, 16, seed=8)
    on_cpu, per = build_sharded_index(vecs, 8, r=12, l_build=24, pq_m=4,
                                      partition="cluster", device="cpu")
    router = build_router(on_cpu, c=3)
    queries = make_queries("prop-like", 12, 16)
    p = SearchParams(l_size=32, k=5, rerank_batch=5, r_max=12,
                     universe=per, max_iters=64)
    meshes = {"card": make_mesh((8,), device=cuda),
              "cpu": make_mesh((8,), device="cpu")}
    for kw in ({}, dict(router=router, route_frac=1.0),
               dict(router=router, route_frac=0.5)):
        build.reset_launches()
        rows = {n: make_sharded_search(m, p, merge=merge, **kw)(
            place_on_mesh(on_cpu, m), queries) for n, m in meshes.items()}
        assert build.LAUNCHES["beam_step"] > 0
        assert build.LAUNCHES["rerank_loop"] >= 8
        assert torch.equal(rows["card"][0].cpu(), rows["cpu"][0])
        assert_bits_equal(rows["card"][1].cpu(), rows["cpu"][1])


@pytest.mark.cuda
def test_admission_on_card_matches_cpu(cuda):
    """The admission queue over a BatchedSearcher on the card: the same
    schedule (cuts, reasons, admit and depart µs), reports and served rows
    as the queue over the same searcher on the CPU."""
    from repro_torch.serve.admission import (AdmissionConfig,
                                             AdmissionQueue, TenantConfig,
                                             bursty_trace,
                                             calibrate_service_model)
    from repro_torch.serve.ann import BatchedSearcher, ServeConfig
    vecs, on_cpu, _, _ = _serving_world(cuda)
    on_card = DeviceIndex(*(None if t is None else t.to(cuda)
                            for t in on_cpu))
    queries = make_queries("prop-like", 37, 16)
    p = SearchParams(l_size=32, beam_width=4, k=10, rerank_batch=10,
                     r_max=12, universe=400, max_iters=64)
    runs = {}
    for name, index, dev in (("card", on_card, None),
                             ("cpu", on_cpu, "cpu")):
        def searcher():
            return BatchedSearcher(index, p, ServeConfig(
                buckets=(1, 8, 32), shared_budget=True), device=dev)
        model = calibrate_service_model(searcher(), queries[:8])
        trace = bursty_trace(queries, rate_qps=3000, n=60,
                             tenants=("hot", "cold"), weights=(0.7, 0.3),
                             deadline_us=4_000.0, deadline_jitter_us=8_000.0,
                             seed=4)
        runs[name] = AdmissionQueue(
            searcher(), model, AdmissionConfig(max_batch=32,
                                               align_buckets=True),
            tenants={"hot": TenantConfig(rate_qps=1500, burst=4)}).run(trace)
    (got, grep), (want, wrep) = runs["card"], runs["cpu"]
    assert [(r.cut_us, r.reason, r.n, r.depart_us) for r in grep.batches] \
        == [(r.cut_us, r.reason, r.n, r.depart_us) for r in wrep.batches]
    for a, b in zip(grep.batches, wrep.batches):
        _same_report(a.report, b.report)
        assert a.report.cut_reason == b.report.cut_reason
        assert a.report.slack_min_us == b.report.slack_min_us
    assert len(got) == len(want) == 60
    for a, b in zip(got, want):
        assert (a.rid, a.admit_us, a.cut_us, a.depart_us) == \
            (b.rid, b.admit_us, b.cut_us, b.depart_us)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists.view(np.int32),
                                      b.dists.view(np.int32))


#: Card against CPU for the float32 reduced LMs: both sum in other orders
#: (cuBLAS against the CPU's GEMMs), logits are O(1-50); the H100 measured
#: at most 9.1e-06 (chip_smoke phase 6).
LM_CARD_ATOL = 1e-4


def _lm_greedy_check(model, params, tokens, gen, frontend=None):
    """Each of ``gen``'s tokens is the CPU engine's greedy pick, or within
    ``LM_CARD_ATOL`` of it (near-tie rule)."""
    from repro_torch.serve.engine import ServeEngine
    margins = ServeEngine(model, params, device="cpu").greedy_margins(
        tokens, gen, frontend)
    assert float(margins.max()) <= LM_CARD_ATOL, margins


@pytest.mark.cuda
def test_lm_serving_on_card_matches_cpu(cuda):
    """Each of the ten reduced archs (float32): prefill logits and every
    decode step's logits on the card equal the CPU's within LM_CARD_ATOL,
    and ``generate``'s greedy tokens on the card are the CPU's (near-tie
    rule)."""
    from repro_torch.configs import ARCHS, get_config, reduce_config
    from repro_torch.data.synthetic import make_token_batch
    from repro_torch.models.api import Model
    from repro_torch.models.schema import tree_map
    from repro_torch.serve.engine import ServeEngine
    for arch in sorted(ARCHS):
        model = Model.from_config(reduce_config(get_config(arch)))
        cpu = model.init(0, device="cpu")
        card = tree_map(lambda t: t.to(cuda), cpu)
        toks = make_token_batch(model.cfg.vocab, 2, 16, seed=1)
        frames = np.random.default_rng(1).normal(
            size=(2, 8, model.cfg.frontend_dim)).astype(np.float32) \
            if model.cfg.encoder_layers else None
        batch = {"tokens": torch.from_numpy(toks).long()}
        if frames is not None:
            batch["frames"] = torch.from_numpy(frames)
        with torch.no_grad():
            want, _ = model.prefill(cpu, batch, attn_mode="dense")
            got, _ = model.prefill(card, {k: v.to(cuda) for k, v in
                                          batch.items()}, attn_mode="dense")
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=LM_CARD_ATOL, err_msg=arch)
        gen = ServeEngine(model, card).generate(toks, max_new=4,
                                                frontend=frames)
        _lm_greedy_check(model, cpu, toks, gen, frames)


@pytest.mark.cuda
def test_rag_on_card_matches_cpu(cuda):
    """RAGPipeline(batch=8) on the card against the same pipeline on the
    CPU (reduced internlm2, 256 documents): retrieval ids and every integer
    BatchReport field equal, the answer's tokens the CPU's (near-tie
    rule), and retrieval ran the path's kernels."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.data.synthetic import make_token_batch
    from repro_torch.models.api import Model
    from repro_torch.models.schema import tree_map
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.rag import RAGPipeline
    model = Model.from_config(reduce_config(get_config("internlm2-1.8b")))
    cpu = model.init(0, device="cpu")
    card = tree_map(lambda t: t.to(cuda), cpu)
    docs = make_token_batch(model.cfg.vocab, 256, 12, seed=3)
    queries = make_token_batch(model.cfg.vocab, 8, 8, seed=11)
    on_card = RAGPipeline(ServeEngine(model, card), doc_tokens=docs, k=2,
                          batch=8)
    on_cpu = RAGPipeline(ServeEngine(model, cpu, device="cpu"),
                         doc_tokens=docs, k=2, batch=8)
    build.reset_launches()
    got_ids, got = on_card.retrieve(queries)
    launches = dict(build.LAUNCHES)
    want_ids, want = on_cpu.retrieve(queries)
    np.testing.assert_array_equal(got_ids, want_ids)
    _same_report(got["report"], want["report"])
    for op in ("beam_step", "ef_decode", "pq_adc_batched", "rerank_loop"):
        assert launches.get(op, 0) > 0, (op, launches)
    gen, stats = on_card.answer(queries, max_new=4)
    np.testing.assert_array_equal(stats["retrieved"], want_ids)
    prompt = np.concatenate([docs[want_ids].reshape(8, -1), queries], 1)
    _lm_greedy_check(model, cpu, prompt, gen)


#: Card against CPU, reduced archs in float32 (no TF32): every gradient
#: leaf within this fraction of the CPU leaf's largest magnitude, the loss
#: and the params after a step within LM_CARD_ATOL.
TRAIN_CARD_REL = 1e-4


def _loss_and_grads(model, params, batch):
    from repro_torch.models.schema import tree_leaves
    from repro_torch.train.trainer import value_and_grad
    loss, grads = value_and_grad(
        lambda p, b: model.loss(p, b, attn_mode="dense"), params, batch)
    return float(loss), [g.float().cpu() for g in tree_leaves(grads)]


@pytest.mark.cuda
def test_training_on_card_matches_cpu(cuda):
    """Each of the ten reduced archs (float32): ``Model.loss`` and every
    gradient leaf on the card equal the CPU's within the stated bounds,
    and so do the params after two ``make_train_step`` steps."""
    from repro_torch.configs import ARCHS, get_config, reduce_config
    from repro_torch.data.synthetic import make_token_batch
    from repro_torch.models.api import Model
    from repro_torch.models.schema import tree_leaves, tree_map
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.trainer import TrainConfig, make_train_step
    for arch in sorted(ARCHS):
        model = Model.from_config(reduce_config(get_config(arch)))
        cpu = model.init(0, device="cpu")
        card = tree_map(lambda t: t.to(cuda), cpu)
        toks = make_token_batch(model.cfg.vocab, 2, 17, seed=1)
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
                 "labels": torch.from_numpy(toks[:, 1:]).long()}
        rng = np.random.default_rng(1)
        if model.cfg.encoder_layers:
            batch["frames"] = torch.from_numpy(rng.normal(
                size=(2, 8, model.cfg.frontend_dim)).astype(np.float32))
        elif model.cfg.frontend:
            batch["frontend"] = torch.from_numpy(rng.normal(
                size=(2, model.cfg.frontend_len, model.cfg.frontend_dim)
            ).astype(np.float32))
        on_card = {k: v.to(cuda) for k, v in batch.items()}
        want, wg = _loss_and_grads(model, cpu, batch)
        got, gg = _loss_and_grads(model, card, on_card)
        assert abs(got - want) <= LM_CARD_ATOL, arch
        for a, b in zip(wg, gg):
            assert float((a - b).abs().max()) <= \
                TRAIN_CARD_REL * max(float(a.abs().max()), 1e-30), arch
        step = make_train_step(model, AdamWConfig(), TrainConfig(
            remat=None, attn_mode="dense", warmup=0))
        p_cpu, s_cpu = cpu, init_opt_state(cpu)
        p_card, s_card = card, init_opt_state(card)
        for _ in range(2):      # step 0's rate is 0: the second one moves
            p_cpu, s_cpu, _ = step(p_cpu, s_cpu, batch)
            p_card, s_card, _ = step(p_card, s_card, on_card)
        for a, b in zip(tree_leaves(p_cpu), tree_leaves(p_card)):
            assert float((a - b.cpu()).abs().max()) <= LM_CARD_ATOL, arch


@pytest.mark.cuda
def test_mesh_policy_on_card_matches_unsharded(cuda):
    """A one-rank NCCL group's (1, 1) mesh: two make_train_step steps of
    the reduced internlm2 (bf16) under ``sharding.policy`` give the loss
    and the fp32 master of the unsharded steps bit for bit (every
    collective is a one-rank copy, every local op the unsharded one)."""
    import socket
    import torch.distributed as dist
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.data.synthetic import make_token_batch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import sharding
    from repro_torch.models.api import Model
    from repro_torch.models.schema import tree_leaves
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.trainer import TrainConfig, make_train_step
    import dataclasses
    model = Model.from_config(dataclasses.replace(
        reduce_config(get_config("internlm2-1.8b")), dtype="bfloat16"))
    toks = make_token_batch(model.cfg.vocab, 4, 33, seed=2)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).long().to(cuda),
             "labels": torch.from_numpy(toks[:, 1:]).long().to(cuda)}
    step = make_train_step(model, AdamWConfig(), TrainConfig(
        remat=None, attn_mode="dense", warmup=1))
    params = model.init(0, device=cuda)
    opt = init_opt_state(params)
    want = []
    for _ in range(2):
        params, opt, m = step(params, opt, batch)
        want.append((m["loss"].clone(),
                     [w.clone() for w in tree_leaves(opt["master"])]))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_local_mesh(device_type="cuda")
        with sharding.policy(mesh):
            params = model.init(0, device=cuda,
                                shardings=model.param_shardings())
            opt = init_opt_state(params)
            for loss, master in want:
                params, opt, m = step(params, opt, batch)
                assert torch.equal(m["loss"], loss)
                for w, q in zip(tree_leaves(opt["master"]), master):
                    assert torch.equal(w.to_local(), q)
    finally:
        dist.destroy_process_group()
