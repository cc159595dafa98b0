#!/usr/bin/env python3
"""Chip smoke test of ``repro_torch`` (the PyTorch + CUDA port) on one
NVIDIA GPU: the paper's §3.4 query path, its serving tier (with its
sharded merges and its admission queue), the §3.3 storage path and the
§3.5 live update path end to end, at one shard of the repo's SIFT1B-scale deployment
(``configs/decouplevs_ann.py``: 32 shards of ~31.25M 128-dim uint8 vectors,
R=128, PQ M=32, 512 MiB segments of 4 MiB chunks).

    python3 chip_smoke.py [--seed 0] [--n 31250000] [--prop-n 31250000]
                          [--queries 1024] [--live-n 16777216]

Phases (any fault exits non-zero; there is no CPU fallback):

1. build  — compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel); print the card and its power limit.
2. parity — each kernel against its plain PyTorch version on the card, at
   the small-world and the shard's shapes, with ragged sizes, empty EF
   lists, all-equal codes, exact distance ties, fully masked rows, empty
   and unaligned byteplane rows, a SIFT and a prop-like 4 MiB chunk, one
   query's exhaustive single-LUT ADC over the shard's codes and the
   single-LUT kernel's sweep (n from 1 to 2^20 + 3, M from 1 to 64, K in
   {16, 256}, uint8 and int32 codes, tables 1, 4 and 8 bytes past an
   aligned address, codes all 0, all K - 1 and all equal), the ADC and
   the re-rank reading their rows by id (ids at and past the table's
   edges, repeats, masked rows, the entry's E = 1, C > 32, D not a
   multiple of 16, unaligned tables) and without ids, and the
   Huffman load (huffman_decode) over one table and plane tables at
   V in {16, 25, 100, 128, 512}, 1-bit and 16-bit codes, unsorted rows with
   and without bases, an odd payload address, records past 2 GiB, and one
   full 512 MiB segment of each store; and the index store's record decode
   (ef_record_decode) on records at the format's limits (counts 0, 1 and
   255, low widths 0 and 32, universes up to 2^32, a record longer than
   the kernel stages (count -1); every start alignment, positions out of
   order and past either end (count -1), the last record on the image's
   last byte, an odd image address, records past 2 GiB) and on the
   shard's first 4,194,304 lists (one sift1b-shard segment of rows); and
   the traversal round's two kernels (round_expand, round_settle) on the
   shard's EF slots at its search's round 1 and round 9 (nq 1,024, L 200,
   W 4, R 128, hash bits 15; the plain rounds drive the state there),
   every state tensor they update compared on copies; and the whole
   re-rank (rerank_loop) against its plain loop, whose distances are
   plain torch, on the shard's rows with candidate lists in a noisy order
   of their exact distance.
   Every comparison is bit-exact.
3. small world — the test suite's world (n=1200, dim=32, r=24, pq_m=8,
   32 queries) built by the port, searched on the card and on the CPU
   with the dense and the hashed visited set: identical ids, distances
   and SearchStats; with the dense set, recall@10 >= 0.971875 (the
   reference suite's golden).
4. shard — n sift-like vectors drawn on the card, a seeded random R=128
   graph (Vamana's start graph: a Vamana build of 31M vertices is out of
   reach of the host-side builder, so recall is not checked here), its EF
   slots, PQ codes encoded on the card, the medoid. Every slot is decoded
   by the ef_decode kernel and compared with the source graph; 1,024
   queries are searched twice under the production SearchParams; the
   distances equal a recompute. Launch counts are read around each
   search (the re-rank is one rerank_loop launch and no rerank_l2). A
   profile of the search fails the run if a torch row gather still reads
   the shard's PQ codes or vectors (every kernel reads its rows by id).
4c. serve — the serving tier (serve/ann.py) on the resident shard:
   BatchedSearcher with buckets (8, 32, 1024), fetch traces replayed
   through an LRU of 0.1% of n x dim bytes, serving the 1,024 queries, the
   first 1,000 (a padded bucket) and 37 (ragged buckets). Every row equals
   phase 4's search bit for bit and the 1,024-query serve launches
   exactly one search's kernels; search_vmapped of 8 queries equals
   search. Prints the I/O-model report (graph/vector I/Os, cache hits,
   modeled mean and p99 latency), the wall, QPS, the replay's share of
   the wall and the card's busy share of a profiled serve. Then the
   frozen sharded branch: the small world in 4 range shards, a router at
   route_frac 0.5, with and without a failed shard, card == CPU.
4e. mesh — make_sharded_search's stacked form: the resident shard split
   into 32 range shards of ceil(n / 32) rows (the deployment's 32 data
   shards on one card; the last shard's pad rows carry row_ids -1), each
   with its own seeded random R=128 graph in local ids, EF slots at that
   universe and phase 4's PQ codes and codebook. First the path's kernels
   on the last shard's own tensors against their plain versions, at the
   hop shapes the search gives them (ef_decode by id at R=128 and the
   shard's universe; pq_adc_batched, beam_step and rerank_l2 by id over
   its codes and vectors). The 1,024 queries are searched shard by shard
   and merged hierarchically (5 butterfly steps) and flat (one 320-row
   gather): the two merges agree bit for bit, equal a host (distance, id)
   merge of the 32 shards' rows, and no id at or past n surfaces. Routing
   at route_frac 1.0 equals no router and at 0.5 keeps every id in its
   query's routed shards, on the small world's 32-shard stack, card
   against the CPU: build_router's host k-means, timed on 2,048 rows of
   each mesh shard, would take minutes over the mesh's rows. Prints walls,
   launches, the merge's own device time and merge_comm_rows.
4f. admission — the admission queue over a BatchedSearcher on the
   resident shard (buckets (8, 32, 1024), max_batch 1024), three tenants
   weighted 0.6/0.3/0.1 with a token bucket on the hottest, the service
   model calibrated on 32 of phase 4's queries; a Poisson and a bursty
   trace of 4,096 requests at 0.8 of the modeled capacity. Every request
   is served once with phase 4's row for its query bit for bit, each batch
   pins one snapshot, the buckets conserve tokens, and the cuts include
   full, deadline and drain with deferred grants. Prints batches by
   reason, the deadline-met share, modeled p50/p95/p99, the queue runs'
   host walls and the card's busy share of the Poisson run (profiled).
4b. storage — the §3.3 path on the same shard: its vectors sealed into the
   decoupled vector store ("auto": the sampled-entropy XOR-delta test per
   chunk, one Huffman table per segment), its graph sealed into the
   Elias-Fano block index store (every record decoded back and compared,
   one ef_record_decode launch a decode_batch call),
   the bytes of the co-located baseline, of the raw decoupled stores and
   of the compressed ones, every vector loaded back (bit-exact) and
   searched again (ids and distances equal phase 4's), an exhaustive PQ
   scan of 8 queries through the single-LUT pq_adc kernel; then, with the
   shard freed, --prop-n prop-like float32 vectors drawn on the card,
   sealed (XOR-delta must win in some chunk) and loaded back. Every load
   is one huffman_decode launch per segment (decode and XOR-delta
   inverse in one kernel; byteplane launches none), bit-exact, with its
   launches counted; one more load is profiled for the card's busy share.
4d. live — the §3.5 update path after the shard is freed: a StreamingIndex
   over --live-n (2^24) uint8 vectors drawn like the shard's, the random
   R=128 graph at that n and the shard's codebook, served through
   BatchedSearcher (256 of phase 4's queries), then 64 top-1 hits deleted
   and 64 fresh vectors inserted (served through the memtable lane: one
   rerank_l2 launch by id over the 64 rows), the live path's kernels on
   the live view's tensors against their plain versions and the memtable
   side-scan on the card against the CPU's, a merge, and a last serve
   (version + 1, ids equal StreamingIndex.search_batch's). Prints each
   serve's launches, the merge's seconds and MergeStats, and the index's
   host and card bytes a vertex at its build's and its merge's peaks
   with the largest n the card holds (the cut is printed as
   ``reduced:``).
5. report — per-kernel times at the shard's shapes (CUDA events, median;
   taken before phase 4b, so the storage phase does not hold the shard's
   tables twice; the kernels that read rows by id cycle through fresh id
   sets, the round kernels through 8 copies of the round-9 state, each
   call a round on from the last), the plain version's and a library
   call's where one computes the same function, the bound, the ADC's and
   the re-rank's old compositions (torch gather + the kernel without ids)
   on the same id sets, beam_step's time by survivors, rerank_loop at
   the three serve cells' row shapes (uint8 D 128, float32 D 96 and 768;
   1,024 queries, L 200) against the host loop it replaced (~5 s), the
   load's old composition (decode_at_torch + one byteplane launch per
   chunk) on the segment huffman_decode is timed on, the single-LUT
   kernel on all-equal codes of the shard's scan (its LUT reads
   conflict-free) beside the time of reading the same 1 GB of codes once,
   ef_record_decode on one segment of rows of each restore cell's store
   (4,194,304 and 1,398,101 records: the op as decode_batch calls it,
   its one read-back included, its plain version, the bound, and the op's
   host wall; its own cases and yardstick add ~4 s to the run, printed in
   the last line), then the contract's last lines.
6. lm — after 4d, with the shard and the live index freed: the LM serving
   path (models/*, serve/engine.py, serve/rag.py). The ten archs'
   reduce_configs in float32, card == CPU (prefill logits, greedy tokens);
   internlm2-1.8b at full width in bfloat16 (1,889,110,016 params drawn
   on the card from --seed) serving the launcher's 8 x 32-token prompts x
   16 new tokens and 16 x 4,096 x 128 (the prefill_32k / decode_32k cells
   cut to one card, the batch sized from a 2-request prefill's peak
   memory): prefill and decode times, tokens/s, peak memory, the card's
   busy share of 16 profiled decode steps after each batch's prompts (and
   after 32-token prompts at the larger batch); gates: 8 decode steps equal
   a prefill over the extended sequence (float32 and bfloat16) and a
   float32 prefill on the card equals the host CPU's; then
   RAGPipeline(batch=64) over 4,096 documents embedded from the model's
   table, the four
   search kernels held against their plain versions on the RAG index's own
   tensors, 64 requests answered (retrieval ids and integer BatchReport
   fields == a CPU BatchedSearcher's). Its kernel launches join the
   report's counts.
7. train — after 6, with its model freed: the LM training path (the
   losses and remat of models/*, optim/adamw.py, train/trainer.py,
   data/pipeline.py, ft/*, launch/train.py), autograd over plain torch (no
   kernel of kernels/csrc is on it). (a) The ten reduced archs in float32:
   loss, every gradient leaf and the params after two make_train_step
   steps, card == CPU. (b) internlm2-1.8b at full width in bf16, 8 AdamW
   steps of launch/train.py's 8 x 128 traffic: the resident bytes, step ms,
   tokens/s, peak memory, the busy share of 4 profiled steps, a warm
   forward + backward and a warm adamw_update timed apart; gates: every
   loss finite, step 0 (rate 0) leaves the master bit-equal to the initial
   params, bf16 loss and grad norm against float32 on the bf16-rounded
   params. (c) remat None/full/dots x loss_chunk None/1024 on one 4 x
   1,024 batch: the same loss and grad norm, each mode's peak. (d) the
   train_4k shape (seq 4,096) cut to the card: the largest microbatch
   under remat full and loss_chunk 1024, one step of 2 microbatches. (e)
   the full-width state saved and restored bit for bit (save and restore
   seconds); the 100m preset's 2 + restore + 2 steps against 4. (f)
   python -m repro_torch.launch.train with a restart, in subprocesses.
8. mesh — after 7: the mesh slice and the dry-run. The dry-run's cells
   start with phase 8, each in a process of its own on a fake process
   group (one host core each, meta tensors), and trace while (a) and (b)
   run, so phase 8's seconds include them. (a) the card's rates: a
   warm bf16 8,192^3 torch.matmul and one read of 4 GiB, printed beside
   the card's name and power limit. (b) phase 7's first two full-width
   steps again, on a one-rank NCCL group's (1, 1) mesh under
   sharding.policy (params DTensors): the loss and every fp32 master leaf
   after each step equal phase 7's bit for bit. (c) phase 7's own cell
   dry-run on a (1, 1) mesh: its roofline bound at (a)'s rates must not
   exceed phase 7's measured warm step (a bound above it means the count
   is wrong); the ratio is printed. (d) python -m
   repro_torch.launch.dryrun for decouplevs-ann at 256 and 512 shards and
   internlm2-1.8b train_4k on pod16x16: per-rank bytes, FLOPs,
   collectives and seconds. Phase 8 prints its seconds against a 90 s
   budget, and each dry-run process's own wall beside them; no kernel of
   kernels/csrc is on its path.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SHARD_N = 31_250_000            # 1B vectors over 32 data shards
#: Rows of one 512 MiB segment of each benchmark configuration's store.
RESTORE_ROWS = {"sift1b-shard": (512 << 20) // 128,
                "deep1b-shard": (512 << 20) // (96 * 4)}
LIVE_N = 1 << 24                # phase 4d's live index (see --live-n)
GOLDEN_RECALL_AT_10 = 0.971875  # the reference suite's pinned small world
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM, fp32 outside the tensor cores

REPLACES = {
    "beam_step": "src/repro/kernels/beam_step/beam_step.py:72",
    "ef_decode": "src/repro/kernels/ef_decode/ef_decode.py:73",
    "pq_adc_batched": "src/repro/kernels/pq_adc/pq_adc.py:91",
    "rerank_l2": "src/repro/kernels/rerank_l2/rerank_l2.py:65",
    "pq_encode": "src/repro/core/graph/pq.py:62",  # host numpy encode_pq
    "byteplane": "src/repro/kernels/byteplane/byteplane.py:25",
    "pq_adc": "src/repro/kernels/pq_adc/pq_adc.py:53",
    # host numpy decode_at, then _undelta's byteplane_decode_pallas
    "huffman_decode": "src/repro/core/codec/huffman.py:205",
    # host numpy decode_record, one record at a time
    "ef_record_decode": "src/repro/core/codec/elias_fano.py:151",
    # no kernel: the plain ops of the reference's round (its while_loop's
    # step) before its hop, and after it; the port's _round ran the same
    "round_expand": "src/repro/core/search/beam.py:232",
    "round_settle": "src/repro/core/search/beam.py:310",
    # no kernel: the reference's re-rank while_loop around its rerank_l2
    "rerank_loop": "src/repro/core/search/beam.py:382",
}
#: The arguments the round kernels update in place (``kernels/search_round``):
#: round_expand's expanded, visited, fetched, pq_ct, flag and new_ids;
#: round_settle's cand_ids .. flag.
ROUND_OUT = {"round_expand": (5, 7, 8, 9, 10, 11),
             "round_settle": tuple(range(3, 12))}
# On no path: absorbed into huffman_decode, which XORs the bases back.
OFF_PATH = ("byteplane",)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=SHARD_N,
                    help="shard size (vectors); below 31,250,000 is a cut")
    ap.add_argument("--prop-n", type=int, default=SHARD_N,
                    help="prop-like store size (vectors); below 31,250,000 "
                         "is a cut")
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--live-n", type=int, default=LIVE_N,
                    help="live index size (vectors, phase 4d); below "
                         "31,250,000 is a cut")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    # ---------------------------------------------------------- 1. build
    t0 = time.time()
    build.build_all()
    log(f"build: {len(build.SOURCES)} kernels {list(build.SOURCES)} in "
        f"{time.time() - t0:.1f} s (nvcc sm_90a -> {build.BUILD_DIR})")
    for name in build.SOURCES:
        txt = (build.BUILD_DIR / f"{name}.ptxas.txt")
        if txt.exists():
            used = [ln.split("ptxas info    : ")[-1] for ln in
                    txt.read_text().splitlines() if "Used" in ln]
            log(f"ptxas {name}: {'; '.join(used)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    mesh_phase = MeshPhase(torch, args, smi)
    atexit.register(mesh_phase.stop)   # a fault in 8 leaves none behind
    parity = Parity(torch, args.seed)
    parity.run_small()                                     # 2. parity
    small_world(torch, args.seed)                          # 3. small world
    shard = Shard(torch, args)                             # 4. shard
    shard.build()
    shard.verify_slots()
    parity.run_shard(shard)
    launches = shard.search()
    add_launches(launches, Serve(torch, shard, args).run())   # 4c. serve
    added = {}                  # the phases of the ANN tier's last slice
    t1 = time.time()
    mesh = MeshSearch(torch, shard, parity, args)         # 4e. mesh
    add_launches(launches, mesh.run())
    added["4e"], t1 = time.time() - t1, time.time()
    add_launches(launches, Admission(torch, shard, args).run())   # 4f
    added["4f"] = time.time() - t1
    times = time_kernels(torch, parity)                    # 5. report: times
    storage = Storage(torch, shard, args)                  # 4b. storage
    launches.update(storage.run())
    launches["pq_encode"] = shard.build_launches["pq_encode"]
    add_launches(launches, Live(torch, shard, parity, args).run())  # 4d
    del shard
    t1 = time.time()
    add_launches(launches, LMServe(torch, parity, args, smi).run())  # 6. lm
    added["6"] = time.time() - t1
    t1 = time.time()
    train = LMTrain(torch, args, smi)
    train.run()                                            # 7. train
    added["7"] = time.time() - t1
    t1 = time.time()
    mesh_phase.run(train)                                  # 8. mesh
    added["8"] = time.time() - t1
    del train
    log(f"mesh: phase 8 {added['8']:.1f} s (budget {MESH_BUDGET_S} s), its "
        f"dry-run processes' own walls " + ", ".join(
            f"{k} {w:.1f} s" for k, w in mesh_phase.walls.items())
        + " (beside 8a and 8b)")
    kernels = report(parity, launches, times)              # 5. report

    log(f"chip_smoke: whole run {time.time() - t0:.1f} s, of which phase 4e "
        f"{added['4e']:.1f} s, 4f {added['4f']:.1f} s, ef_record_decode's "
        f"own cases and yardstick {parity.records_s:.1f} s, 6 (lm) "
        f"{added['6']:.1f} s, 7 (train) "
        f"{added['7']:.1f} s, 8 (mesh) {added['8']:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ------------------------------------------------------------------ parity
def bits_equal(torch, a, b) -> bool:
    """Bit-for-bit tensor equality (float bits compared, so inf == inf)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def in_place(fn, out):
    """``fn``, which updates its arguments at positions ``out`` in place,
    called on copies of them -> the copies, updated."""
    def call(*args):
        args = [a.clone() if i in out else a for i, a in enumerate(args)]
        fn(*args)
        return tuple(args[i] for i in out)
    return call


def max_abs_err(torch, a, b) -> float:
    if a.dtype != torch.float32:
        return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
    fin = torch.isfinite(a) & torch.isfinite(b)
    check(bool((torch.isfinite(a) == torch.isfinite(b)).all()),
          "kernel and plain version disagree on which entries are finite")
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def prop_like_chunk(torch, dev, rows=8192, dim=128, seed=7):
    """One 4 MiB chunk of prop-like float32 vectors, as bytes [rows, 512]."""
    from repro_torch.data.synthetic import prop_like_torch
    x = prop_like_torch(rows, dim, seed, dev)
    return x.view(torch.uint8).reshape(rows, dim * 4)


def hop_parity(par, label, codes, luts, ef_slots, vectors, queries, p,
               r, universe) -> str:
    """The search path's kernels on one index's own tensors, each against
    its plain version (phase 2's bit-exact rule), at the hop shapes a
    search gives them: the candidates' and the entry's ADC and the fused
    hop over ``codes`` ([n, M]), ef_decode by id over ``ef_slots`` at (r,
    universe), and the re-rank by id over ``vectors``. These launches are
    not the path's. -> a description of the cases for the log."""
    torch = par.torch
    n, nq = codes.shape[0], luts.shape[0]
    E, L = p.beam_width * r, p.l_size
    cand_ids = par.table_ids(n, nq, L, "kept")
    cand_d = par.compare("pq_adc_batched", f"{label} candidates by id",
                         codes, luts, cand_ids)[0]
    cand_d, order = cand_d.sort(1)
    cand_ids = torch.gather(cand_ids, 1, order).contiguous()
    par.compare("pq_adc_batched", f"{label} entry by id", codes, luts,
                cand_ids[:, :1].contiguous())
    par.compare("beam_step", f"{label} hop", codes, luts, cand_ids,
                cand_d.contiguous(), par.table_ids(n, nq, E))
    par.compare("ef_decode", f"{label} R={r} U={universe} by id", ef_slots,
                r, universe, par.ef_ids(n, nq * p.beam_width))
    par.compare("rerank_l2", f"{label} re-rank by id", queries, vectors,
                par.table_ids(n, nq, p.rerank_batch, "kept"))
    return (f"pq_adc_batched (candidates {nq}x{L}, entry), beam_step (hop "
            f"{nq}x{E}, L={L}, M={codes.shape[1]}), ef_decode (R={r}, "
            f"U={universe}, {nq * p.beam_width} ids) and rerank_l2 ({nq}x"
            f"{p.rerank_batch} rows of [{n}, {vectors.shape[1]}] "
            f"{str(vectors.dtype).removeprefix('torch.')})")


class Parity:
    """Each kernel wrapper against its plain version on the same CUDA
    inputs; every case must agree bit for bit."""

    COLD_SETS = 8     # id sets the by-id kernels cycle through when timed
    MID_ROUND = 8     # rounds of the shard's traversal before the timed one

    def __init__(self, torch, seed):
        from repro_torch.kernels.beam_step import beam_step as bs
        from repro_torch.kernels.byteplane import byteplane as bp
        from repro_torch.kernels.ef_decode import ef_decode as ef
        from repro_torch.kernels.ef_record_decode import ef_record_decode \
            as erd
        from repro_torch.kernels.huffman_decode import huffman_decode as hd
        from repro_torch.kernels.pq_adc import pq_adc as pa
        from repro_torch.kernels.pq_encode import pq_encode as pe
        from repro_torch.kernels.rerank_l2 import rerank_l2 as rr
        from repro_torch.kernels.rerank_loop import rerank_loop as rl
        from repro_torch.kernels.search_round import search_round as sr
        self.torch, self.seed = torch, seed
        self.dev = torch.device("cuda")
        self.g = torch.Generator(device=self.dev).manual_seed(seed + 1)
        self.ops = {
            "beam_step": (bs.beam_step_cuda, bs.beam_step_ref),
            "ef_decode": (ef.ef_decode_cuda, ef.ef_decode_ref),
            "pq_adc_batched": (pa.pq_adc_batched_cuda,
                               pa.pq_adc_batched_ref),
            "rerank_l2": (rr.rerank_l2_cuda, rr.rerank_l2_ref),
            "rerank_loop": (rl.rerank_loop_cuda, rl.rerank_loop_ref),
            "pq_encode": (pe.pq_encode_cuda, pe.pq_encode_ref),
            "byteplane": (bp.byteplane_decode_cuda,
                          bp.byteplane_decode_ref),
            "pq_adc": (pa.pq_adc_cuda, pa.pq_adc_ref),
            "huffman_decode": (hd.huffman_decode_cuda,
                               hd.huffman_decode_ref),
            "ef_record_decode": (erd.ef_record_decode_cuda,
                                 erd.ef_record_decode_ref),
        }
        # the round kernels update their state in place: compared on
        # copies (``in_place``), timed on copies made before the timing
        self.in_place = {"round_expand": (sr.round_expand_cuda,
                                          sr.round_expand_ref),
                         "round_settle": (sr.round_settle_cuda,
                                          sr.round_settle_ref)}
        for op, fns in self.in_place.items():
            self.ops[op] = tuple(in_place(f, ROUND_OUT[op]) for f in fns)
        # what a kernel's time is set beside where that is not its plain
        # version: the re-rank loop as the search ran it before the
        # rerank_loop kernel (a rerank_l2 launch and a read a batch); its
        # plain version's distances are plain torch, so the comparison
        # holds the kernel against no code it shares
        self.yardsticks = {"rerank_loop": lambda *a: rl.rerank_loop_ref(
            *a, l2=rr.rerank_l2_cuda)}
        self.records_s = 0.0     # seconds of ef_record_decode's own cases
        self.err = dict.fromkeys(self.ops, 0.0)
        self.cases = dict.fromkeys(self.ops, 0)

    def compare(self, op, label, *args):
        kern, plain = self.ops[op]
        got, want = kern(*args), plain(*args)
        self.torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            self.err[op] = max(self.err[op], max_abs_err(self.torch, g, w))
            check(bits_equal(self.torch, g, w),
                  f"{op} [{label}]: kernel != plain version")
        self.cases[op] += 1
        return got

    # -- input makers (all on the card, from the generator)
    def rand(self, *shape):
        return self.torch.randn(*shape, generator=self.g, device=self.dev)

    def randint(self, hi, *shape, dtype=None):
        t = self.torch.randint(0, hi, shape, generator=self.g,
                               device=self.dev)
        return t.to(dtype) if dtype is not None else t

    @staticmethod
    def delta_chunk(vb):
        """(XOR-delta packed rows, base) of a byte chunk, as the seal
        makes them."""
        from repro_torch.core.codec.xor_delta import build_base_torch
        base = build_base_torch(vb)
        return (vb ^ base).contiguous(), base

    def beam_case(self, nq, e, l_size, m, mask_p=0.85, ties=False, k=256,
                  table=None, cands="sorted", ids="random"):
        """(pq_codes, luts, cand_ids, cand_d, new_ids) of one hop; the
        table is drawn (3E + 5 rows) unless given. ``cands``: "sorted",
        "unsorted" or "first-hop" (one finite candidate); ``ids``:
        "random", "edges" (0, n-1 and past the end) or "repeated"."""
        torch = self.torch
        if table is None:
            table = self.randint(256, 3 * e + 5, m, dtype=torch.uint8)
        n = table.shape[0]
        luts = self.rand(nq, m, k)
        if ties:   # quantize hard so merged distances collide constantly
            luts = luts.round()
        cand_d = self.rand(nq, l_size) ** 2
        if ties:
            cand_d = (cand_d * 2).round() / 2
        if cands != "unsorted":
            cand_d = cand_d.sort(1).values
        cand_ids = self.randint(10**6, nq, l_size, dtype=torch.int32)
        if cands == "first-hop":
            cand_d[:, 1:] = torch.inf
            cand_ids[:, 1:] = -1
        if ids == "edges":
            edge = torch.tensor([0, n - 1, n, n + 7, 1], device=self.dev)
            rows = edge[self.randint(5, nq, e)]
        elif ids == "repeated":
            rows = self.randint(3, nq, e)
        else:
            rows = self.randint(n, nq, e)
        keep = torch.rand(nq, e, generator=self.g, device=self.dev) < mask_p
        new_ids = torch.where(keep, rows, -1).to(torch.int32)
        return table, luts, cand_ids, cand_d.contiguous(), new_ids

    def rerank_lists(self, queries, table, l_size, noise=0.3):
        """[nq, L] int32 candidate lists as a traversal leaves them: random
        rows in a noisy order of their exact distance (the PQ order is
        one), so later re-rank batches still move the heap."""
        torch = self.torch
        nq = queries.shape[0]
        ids = self.randint(table.shape[0], nq, l_size, dtype=torch.int32)
        d = self.ops["rerank_l2"][0](queries, table, ids)
        order = (d * (1 + noise * self.rand(nq, l_size))).argsort(
            dim=1, stable=True)
        return torch.gather(ids, 1, order).contiguous()

    def rerank_loop_args(self, queries, table, p, sets):
        """``sets`` argument tuples of the whole re-rank at ``p``'s K, B,
        batch limit and threshold, each with fresh candidate lists."""
        k, b = p.k, p.rerank_batch
        most = min(p.max_rerank_batches, max(0, (p.l_size - k) // b))
        return [(queries, table, self.rerank_lists(queries, table,
                                                   p.l_size),
                 k, b, most, p.benefit_threshold, None)
                for _ in range(sets)]

    def table_ids(self, n, nq, e, kind="random"):
        """[nq, e] int32 row ids into n rows: "random" (30% masked with
        -1), "kept" (none masked), "edges" (0, n-1, ids past either end),
        "repeated" (rows 0..2 and -1), "masked-row" (query 0 all -1) or
        "all-masked"."""
        torch = self.torch
        if kind == "edges":
            edge = torch.tensor([0, n - 1, n, n + 7, -1, -4, 1],
                                device=self.dev)
            rows = edge[self.randint(7, nq, e)]
        elif kind == "repeated":
            rows = self.randint(4, nq, e) - 1
        elif kind == "all-masked":
            rows = torch.full((nq, e), -1, device=self.dev)
        else:
            rows = self.randint(n, nq, e)
            if kind != "kept":
                rows = torch.where(torch.rand(nq, e, generator=self.g,
                                              device=self.dev) < 0.7, rows, -1)
            if kind == "masked-row" and nq:
                rows[0] = -1
        return rows.to(torch.int32).contiguous()

    def unaligned(self, t, shift):
        """A copy of ``t`` that starts ``shift`` elements past an
        allocation's start (off 16-byte alignment)."""
        flat = self.torch.empty(t.numel() + shift, dtype=t.dtype,
                                device=self.dev)
        return flat[shift:].view(t.shape).copy_(t)

    def by_id_cases(self):
        """pq_adc_batched and rerank_l2 reading their rows by id: ragged
        shapes, the entry (E = 1), one query, ids at and past the edges,
        repeats, masked rows, wide and odd rows, C > 32, D not a multiple
        of 16, several row tiles, unaligned tables, empty inputs."""
        torch = self.torch
        for nq, e, m, kind in [(32, 1, 8, "random"), (1, 130, 32, "random"),
                               (3, 40, 16, "edges"), (4, 50, 4, "repeated"),
                               (3, 30, 8, "masked-row"),
                               (2, 12, 8, "all-masked"), (3, 20, 3, "random"),
                               (3, 20, 48, "random"), (2, 700, 8, "random"),
                               (3, 0, 8, "random"), (0, 5, 8, "random")]:
            table = self.randint(256, 3 * e + 5, m, dtype=torch.uint8)
            ids = self.table_ids(len(table), nq, e, kind)
            self.compare("pq_adc_batched", f"by id {nq}x{e}x{m} {kind}",
                         table, self.rand(nq, m, 256), ids)
        for m, shift in [(8, 1), (8, 4), (16, 8), (32, 4), (32, 8), (48, 1)]:
            table = self.randint(256, 200, m, dtype=torch.uint8)
            self.compare("pq_adc_batched", f"by id M={m} table +{shift} B, "
                         f"LUTs +4 B", self.unaligned(table, shift),
                         self.unaligned(self.rand(5, m, 256), 1),
                         self.table_ids(200, 5, 64))
        for q, c, d in [(1, 1, 8), (7, 20, 100), (32, 10, 32), (9, 130, 128),
                        (3, 5, 129), (3, 6, 1100), (1, 10, 128), (3, 0, 32)]:
            for dtype in ("f32", "u8"):
                table = (self.rand(2 * q * c + 3, d) if dtype == "f32" else
                         self.randint(256, 2 * q * c + 3, d,
                                      dtype=torch.uint8))
                for kind in ("kept", "edges", "repeated"):
                    self.compare("rerank_l2", f"by id {dtype} {q}x{c}x{d} "
                                 f"{kind}", self.rand(q, d) * 20, table,
                                 self.table_ids(len(table), q, c, kind))
        for shift in (1, 2, 4, 8):
            table = self.randint(256, 100, 128, dtype=torch.uint8)
            self.compare("rerank_l2", f"by id u8 table +{shift} B",
                         self.rand(6, 128) * 20, self.unaligned(table, shift),
                         self.table_ids(100, 6, 10, "kept"))

    def beam_cases(self, label, nq, e, l_size, m, table=None):
        """The fused hop's cases at one shape: random rows, an unsorted
        candidate half, the first hop, ids at the table's edges, repeated
        ids, an all-masked hop."""
        for kw in (dict(), dict(cands="unsorted"), dict(cands="first-hop"),
                   dict(ids="edges"), dict(ids="repeated"),
                   dict(mask_p=0.0)):
            args = self.beam_case(nq, e, l_size, m, table=table, **kw)
            ids, d, ix = self.compare("beam_step", f"{label} {kw}", *args)
            if kw.get("mask_p") == 0.0:
                want = self.torch.arange(l_size, device=self.dev)
                check(bool(self.torch.equal(ids, args[2]))
                      and bool((ix == want).all()), "beam_step all-masked: "
                      "the candidate list must pass through")

    def ef_ids(self, n, b):
        """[b] row ids into n slots: random, both edges, repeats, and ids
        past either end (they clip)."""
        torch = self.torch
        ids = self.randint(n, b, dtype=torch.int32)
        edge = torch.tensor([0, n - 1, n - 1, 0, -3, n + 93, 1 % n, 1 % n],
                            dtype=torch.int32, device=self.dev)
        ids[:min(b, 8)] = edge[:min(b, 8)]
        return ids

    def ef_case(self, r_max, universe, lens):
        from repro_torch.core.codec.elias_fano import encode_slots_torch
        torch = self.torch
        lens = torch.as_tensor(lens, device=self.dev)
        b = lens.numel()
        # distinct sorted values: sorted draws in [0, U - r) plus 0..r-1
        u = self.randint(max(1, universe - r_max + 1), b, r_max).sort(1).values
        vals = u + torch.arange(r_max, device=self.dev)
        slots = encode_slots_torch(vals, lens, r_max, universe)
        nb, ct = self.compare("ef_decode", f"r={r_max} U={universe}",
                              slots, r_max, universe)
        j = torch.arange(r_max, device=self.dev)
        live = j[None, :] < lens[:, None]
        check(bool((ct == lens).all()), "ef_decode counts")
        check(bool((nb.long()[live] == vals[live]).all())
              and bool((nb[~live] == universe - 1).all()),
              f"ef_decode r={r_max} U={universe}: values not recovered")
        ids = self.ef_ids(b, 3 * b)
        nb_i, ct_i = self.compare("ef_decode", f"r={r_max} U={universe} ids",
                                  slots, r_max, universe, ids)
        rows = ids.long().clamp(0, b - 1)
        check(bool(torch.equal(nb_i, nb[rows]))
              and bool(torch.equal(ct_i, ct[rows])),
              f"ef_decode r={r_max} U={universe}: a row by id != its slot")
        return slots

    def run_small(self):
        torch = self.torch
        t0 = time.time()
        # pq_adc_batched: entry score, hop shapes, M sweep, degenerate codes
        for nq, n, m in [(32, 1, 8), (32, 96, 8), (3, 130, 16), (1, 1, 32),
                         (2, 300, 32), (7, 129, 32)]:
            self.compare("pq_adc_batched", f"{nq}x{n}x{m}",
                         self.randint(256, nq, n, m, dtype=torch.uint8),
                         self.rand(nq, m, 256))
        self.compare("pq_adc_batched", "all-equal codes",
                     torch.full((5, 129, 32), 3, dtype=torch.uint8,
                                device=self.dev), self.rand(5, 32, 256))
        self.compare("pq_adc_batched", "ties",
                     self.randint(4, 4, 200, 8, dtype=torch.uint8),
                     self.rand(4, 8, 256).round())
        # ef_decode: the (r_max, universe) grid, empty and full lists
        for r_max, universe in [(8, 64), (16, 1000), (24, 1200),
                                (24, 10**5), (32, 10**6), (1, 2),
                                (128, SHARD_N)]:
            self.ef_case(r_max, universe,
                         [0, 1, r_max, r_max // 2, min(13, r_max), 0])
        self.compare("ef_decode", "zero slots",
                     torch.zeros((3, 8), dtype=torch.int32,
                                 device=self.dev), 24, 1200)
        self.compare("ef_decode", "empty ids", self.ef_case(8, 64, [1, 2]),
                     8, 64, torch.zeros(0, dtype=torch.int32,
                                        device=self.dev))
        # beam_step: ragged, odd and wide rows, ties, the small world's hop
        for nq, e, l_size, m in [(1, 1, 1, 1), (3, 5, 4, 8), (7, 130, 48, 4),
                                 (2, 17, 10, 16), (8, 64, 32, 8),
                                 (3, 30, 12, 3), (3, 20, 8, 33),
                                 (3, 20, 8, 48), (5, 700, 40, 8),
                                 (2, 9, 300, 8)]:
            self.compare("beam_step", f"{nq}x{e}x{l_size}x{m}",
                         *self.beam_case(nq, e, l_size, m))
        for cands in ("sorted", "unsorted"):
            self.compare("beam_step", f"ties {cands}", *self.beam_case(
                4, 40, 16, 4, ties=True, cands=cands))
        # tables and LUTs off 16-byte alignment (narrower loads, no bulk)
        args = list(self.beam_case(4, 50, 20, 16))
        args[0] = self.unaligned(args[0], 4)
        args[1] = self.unaligned(args[1], 1)
        self.compare("beam_step", "unaligned table and LUTs", *args)
        # the small world's hop (n=1200, M=8, E=W*R=96, L=48)
        self.beam_cases("world", 32, 96, 48, 8, table=self.randint(
            256, 1200, 8, dtype=torch.uint8))
        # rerank_l2: D in {32, 128}, f32 and u8, equal rows
        for q, c, d in [(1, 1, 8), (7, 20, 100), (32, 10, 32), (9, 130, 128),
                        (3, 5, 129)]:
            self.compare("rerank_l2", f"f32 {q}x{c}x{d}", self.rand(q, d),
                         self.rand(q, c, d))
            self.compare("rerank_l2", f"u8 {q}x{c}x{d}",
                         self.rand(q, d) * 20,
                         self.randint(256, q, c, d, dtype=torch.uint8))
        qv = self.rand(4, 32)
        out = self.compare("rerank_l2", "equal rows", qv,
                           qv[:, None, :].expand(4, 9, 32).contiguous())[0]
        check(bool((out == 0).all()), "rerank_l2: equal rows must give 0")
        self.by_id_cases()
        # pq_encode: the small world's shapes, u8 shard shapes, ties
        for n, d, m in [(1200, 32, 8), (1000, 128, 32), (5, 8, 8)]:
            self.compare("pq_encode", f"f32 {n}x{d} M={m}", self.rand(n, d),
                         self.rand(m, 256, d // m))
        cents = self.rand(32, 256, 4)
        cents[:, 128:] = cents[:, :128]             # duplicated centroids
        self.compare("pq_encode", "u8 ties", self.randint(
            256, 777, 128, dtype=torch.uint8), cents * 30)
        # byteplane: empty, ragged and 100-byte rows, an unaligned slice
        for n in (0, 1, 255, 256, 257, 4096):
            for v in (1, 100, 128, 512):
                packed = self.randint(256, n, v, dtype=torch.uint8)
                base = self.randint(256, v, dtype=torch.uint8)
                out = self.compare("byteplane", f"{n}x{v}", packed, base)[0]
                check(bool(torch.equal(out ^ base, packed)),
                      f"byteplane {n}x{v}: XOR does not invert")
        rows = self.randint(256, 300, 100, dtype=torch.uint8)[1:258]
        check(rows.data_ptr() % 16 != 0, "unaligned byteplane case")
        self.compare("byteplane", "unaligned", rows,
                     self.randint(256, 100, dtype=torch.uint8))
        # pq_adc: bench_kernels' shapes, int32 codes, one row, equal codes
        for n, m in ((1024, 8), (4096, 8), (1, 8), (3000, 32)):
            lut = self.rand(m, 256)
            self.compare("pq_adc", f"{n}x{m}",
                         self.randint(256, n, m, dtype=torch.uint8), lut)
            self.compare("pq_adc", f"{n}x{m} i32",
                         self.randint(256, n, m, dtype=torch.int32), lut)
        self.compare("pq_adc", "all-equal codes",
                     torch.full((129, 32), 3, dtype=torch.uint8,
                                device=self.dev), self.rand(32, 256))
        self.pq_adc_cases()
        # huffman_decode: one table and plane tables over the repo's row
        # widths, 1-bit and 16-bit codes, a 25-byte row; records past 2 GiB
        for dist, v, planes in (
                [("skewed", v, 1) for v in (16, 100, 128, 512)]
                + [("skewed", v, 2) for v in (16, 100, 128, 512)]
                + [("prop-like", v, 4) for v in (16, 100, 128, 512)]
                + [("skewed", 128, 8), ("uniform", 128, 1),
                   ("constant", 100, 1), ("long-codes", 128, 1),
                   ("skewed", 25, 1)]):
            self.huffman_cases(f"{dist} V={v} P={planes}", dist, v, planes)
        self.huffman_far()
        self.record_cases()
        log(f"parity small: {dict(self.cases)} cases bit-exact "
            f"({time.time() - t0:.1f} s)")

    def pq_adc_cases(self):
        """The single-LUT kernel over every n in {1, 31, 255, 257, 4099,
        2^20 + 3}, M in {1, 7, 8, 12, 16, 32, 64}, K in {16, 256}, uint8
        and int32 codes (uint8 rows of M = 32 take the lagged path, the
        others the row path); tables 1, 4 and 8 bytes past an aligned
        address, the LUT aligned or 4 bytes past it; codes all 0, all K - 1
        and all equal."""
        torch = self.torch
        for n in (1, 31, 255, 257, 4099, (1 << 20) + 3):
            for m in (1, 7, 8, 12, 16, 32, 64):
                for k in (16, 256):
                    lut = self.rand(m, k)
                    for dt in (torch.uint8, torch.int32):
                        self.compare("pq_adc", f"{n}x{m} K={k} {dt}",
                                     self.randint(k, n, m, dtype=dt), lut)
        for m in (8, 12, 16, 32, 64):
            for dt, shift in ((torch.uint8, 1), (torch.uint8, 4),
                              (torch.uint8, 8), (torch.int32, 4),
                              (torch.int32, 8)):
                codes = self.randint(256, 4099, m, dtype=dt)
                codes = self.unaligned(codes, shift // codes.element_size())
                check(codes.data_ptr() % 16 == shift % 16,
                      "unaligned pq_adc case")
                for lut_shift in (0, 1):
                    self.compare("pq_adc", f"M={m} {dt} table +{shift} B, "
                                 f"LUT +{4 * lut_shift} B", codes,
                                 self.unaligned(self.rand(m, 256), lut_shift))
        for m, k in ((32, 256), (32, 16), (8, 256), (64, 16)):
            lut = self.rand(m, k)
            for fill in (0, k - 1, 3):
                for dt in (torch.uint8, torch.int32):
                    out = self.compare("pq_adc", f"M={m} K={k} codes all "
                                       f"{fill} {dt}", torch.full(
                                           (4099, m), fill, dtype=dt,
                                           device=self.dev), lut)[0]
                    check(bool((out == out[0]).all()),
                          "pq_adc: equal codes must give equal sums")

    def huffman_data(self, dist, n, v, planes=1):
        """[n, v] uint8 rows of ``dist`` on the card and their Huffman
        table(s): "skewed", "uniform", "prop-like" (fp32 rows), "constant"
        (one symbol: 1-bit codes) or "long-codes" (a table whose rarest
        symbols take 16 bits, drawn uniformly so that they occur)."""
        from repro_torch.core.codec import huffman
        from repro_torch.data.synthetic import prop_like_torch
        torch = self.torch
        if dist == "prop-like":
            data = prop_like_torch(n, v // 4, int(self.randint(1000, 1)),
                                   self.dev).view(torch.uint8).reshape(n, v)
        elif dist == "skewed":
            data = (self.rand(n, v) ** 2 * 20).clamp(max=255).to(torch.uint8)
        elif dist == "uniform":
            data = self.randint(256, n, v, dtype=torch.uint8)
        elif dist == "constant":
            data = torch.full((n, v), 7, dtype=torch.uint8, device=self.dev)
        else:
            data = self.randint(30, n, v, dtype=torch.uint8)
        if dist == "long-codes":
            freqs = np.zeros(256, np.int64)
            freqs[:30] = 2 ** np.arange(30)[::-1]
            table = huffman.HuffmanTable.from_frequencies(freqs)
            check(int(table.lengths.max()) == huffman.MAX_LEN,
                  "long-codes table has no 16-bit code")
        elif planes > 1:
            table = huffman.PlaneTables.from_data(data.cpu().numpy(), planes)
        else:
            table = huffman.HuffmanTable.from_data(data.cpu().numpy())
        return data, table

    def huffman_load(self, data, table, n_bases=3):
        """A load of 3/4 of the rows of ``data`` encoded on the card, in
        random order, the last record (it ends at the payload's last byte)
        first, each row with one of ``n_bases`` bases or none -> (the
        huffman_decode arguments, the rows the load must give)."""
        from repro_torch.core.codec import huffman
        torch = self.torch
        n, v = data.shape
        payload, offsets = huffman.encode_records_torch(data, table)
        rows = torch.randperm(n, generator=self.g, device=self.dev)[
            :max(1, 3 * n // 4)]
        rows[0] = n - 1
        bases = self.randint(256, n_bases, v, dtype=torch.uint8)
        base_of = (self.randint(n_bases + 1, len(rows)) - 1).to(torch.int32)
        want = data[rows] ^ torch.where(base_of[:, None] >= 0,
                                        bases[base_of.clamp(min=0).long()], 0)
        return (payload, offsets[:-1][rows].contiguous(), v, table, bases,
                base_of), want

    def huffman_cases(self, label, dist, v, planes, n=300):
        """One load as it comes (it must give the original rows), at an
        odd payload address, without bases, and empty."""
        torch = self.torch
        args, want = self.huffman_load(*self.huffman_data(dist, n, v, planes))
        got = self.compare("huffman_decode", label, *args)[0]
        check(bits_equal(torch, got, want),
              f"huffman_decode [{label}]: rows not recovered")
        payload, starts, v, table, bases, base_of = args
        odd = torch.empty(payload.numel() + 3, dtype=torch.uint8,
                          device=self.dev)[3:]
        odd.copy_(payload)
        self.compare("huffman_decode", f"{label} odd payload address", odd,
                     starts, v, table, bases, base_of)
        self.compare("huffman_decode", f"{label} no bases", payload, starts,
                     v, table, bases[:0], torch.full_like(base_of, -1))
        self.compare("huffman_decode", f"{label} empty load", payload,
                     starts[:0], v, table, bases, base_of[:0])

    def huffman_far(self):
        """Records that start past byte 2^31 of the payload."""
        torch = self.torch
        (payload, starts, v, table, bases, base_of), want = \
            self.huffman_load(*self.huffman_data("skewed", 64, 128))
        far = (1 << 31) + 5
        big = torch.zeros(far + payload.numel(), dtype=torch.uint8,
                          device=self.dev)
        big[far:] = payload
        got = self.compare("huffman_decode", "records past 2 GiB", big,
                           starts + far, v, table, bases, base_of)[0]
        check(bits_equal(torch, got, want),
              "huffman_decode past 2 GiB: rows not recovered")

    def record_cases(self):
        """ef_record_decode on records at the format's limits (counts 0, 1
        and 255, widths 0 and 32, universes up to 2^32, a record longer
        than the kernel stages), each start alignment, positions out of
        order, repeated and past either end, the last record ending on the
        image's last byte, an odd image address, and records past 2 GiB;
        every row also against a host ``decode_record`` (count -1 and a
        row of -1 past the table or the stage)."""
        from repro_torch.core.codec import elias_fano as ef
        from repro_torch.kernels.ef_record_decode.ef_record_decode import \
            MAX_RECORD_BYTES
        torch, t0 = self.torch, time.time()
        rng = np.random.default_rng(self.seed + 25)

        def forced(values, universe, lw):
            n, last = len(values), int(values[-1])
            e = ef.encode(values, universe, low_width=lw)
            return np.concatenate([
                np.asarray([n, lw], np.uint8),
                e.low_words.view(np.uint8)[:(n * lw + 7) // 8],
                e.high_words.view(np.uint8)[:(n + (last >> lw) + 7) // 8]])

        def drawn(n, universe):
            return np.sort(rng.choice(universe, n, replace=False)).astype(
                np.uint64)
        recs = [ef.encode_record(np.zeros(0, np.uint64), 1000),
                ef.encode_record(np.asarray([5], np.uint64), 1000),
                ef.encode_record(np.sort(rng.integers(0, 10**6, 255)).astype(
                    np.uint64), 10**6),
                ef.encode_record(np.arange(40, dtype=np.uint64), 1000),
                forced(drawn(255, 12_000), 12_000, 0),
                forced(np.asarray([2**32 - 1], np.uint64), 2**32, 32),
                forced(drawn(128, 2**32), 2**32, 32),
                ef.encode_record(drawn(255, 2**32), 2**32)]
        recs += [ef.encode_record(drawn(int(k), 31_250_000), 31_250_000)
                 for k in rng.integers(0, 129, 500)]
        for gap in (1, 2, 3, 4, 7):
            pads = [rng.integers(0, 256, int(rng.integers(0, gap)),
                                 dtype=np.uint8) for _ in recs]
            lens = np.asarray([len(r) for r in recs], np.int64)
            starts = np.cumsum([len(p) for p in pads]) + np.concatenate(
                [[0], np.cumsum(lens)[:-1]])
            img = np.concatenate([x for pr in zip(pads, recs) for x in pr])
            buf = torch.from_numpy(img).to(self.dev)
            st = torch.from_numpy(starts.astype(np.int64)).to(self.dev)
            ln = torch.from_numpy(lens.astype(np.int32)).to(self.dev)
            m = len(recs)
            pos = torch.cat([torch.randperm(m, generator=self.g,
                                            device=self.dev),
                             torch.tensor([0, m - 1, m - 1, -4, m + 17],
                                          device=self.dev)])
            vals, cnt = self.compare("ef_record_decode", f"edges gap<{gap}",
                                     buf, st, ln, pos)
            self.compare("ef_record_decode", f"edges gap<{gap} in order",
                         buf, st, ln, torch.arange(m, device=self.dev))
            host_vals, host_cnt = vals.cpu().numpy(), cnt.cpu().numpy()
            for i, p in enumerate(pos.tolist()):
                got = host_vals[i]
                if not 0 <= p < m or len(recs[p]) > MAX_RECORD_BYTES:
                    check(host_cnt[i] == -1 and (got == -1).all(),
                          f"ef_record_decode: row {i} (position {p}) "
                          f"decoded")
                    continue
                want = ef.decode_record(recs[p], 2**32).astype(np.int64)
                check(host_cnt[i] == len(want)
                      and np.array_equal(got[:len(want)], want)
                      and (got[len(want):] == -1).all(),
                      f"ef_record_decode: record {p} not recovered")
        odd = torch.empty(buf.numel() + 1, dtype=torch.uint8, device=self.dev)
        odd[1:] = buf
        got = self.compare("ef_record_decode", "odd image address",
                           odd[1:], st, ln, pos)
        check(all(bits_equal(torch, g, w) for g, w in zip(got, (vals, cnt))),
              "ef_record_decode: an odd image address changes the rows")
        self.compare("ef_record_decode", "no rows", buf, st, ln, pos[:0])
        far = (1 << 31) + 5
        big = torch.zeros(far + buf.numel(), dtype=torch.uint8,
                          device=self.dev)
        big[far:] = buf
        got = self.compare("ef_record_decode", "records past 2 GiB", big,
                           st + far, ln, pos)
        check(all(bits_equal(torch, g, w) for g, w in zip(got, (vals, cnt))),
              "ef_record_decode past 2 GiB: rows not recovered")
        del big
        self.records_s += time.time() - t0

    def record_segment(self, shard):
        """The index store's records of the shard's first 4,194,304 lists
        (one sift1b-shard segment of rows; deep1b-shard's segment is its
        first 1,398,101), encoded as the store encodes them, for the
        shard's comparison and the report's times."""
        from repro_torch.core.codec import elias_fano as ef
        torch, t0 = self.torch, time.time()
        rows = min(shard.n, RESTORE_ROWS["sift1b-shard"])
        parts, lens = [], []
        for a in range(0, rows, shard.CHUNK):
            b = min(a + shard.CHUNK, rows)
            v, cnt = ef.sort_lists_torch(shard.adjacency(a, b))
            payload, offsets = ef.encode_records_torch(v, cnt, shard.n)
            parts.append(payload)
            lens.append(offsets[1:] - offsets[:-1])
        buf = torch.cat(parts)
        ln = torch.cat(lens)
        st = torch.zeros_like(ln)
        torch.cumsum(ln[:-1], 0, out=st[1:])
        self.records = (buf, st, ln.to(torch.int32))
        self.shard_in["ef_record_decode"] = (
            *self.records, torch.arange(rows, device=self.dev))
        self.records_s += time.time() - t0

    def segment(self, vecs):
        """``vecs`` sealed into one full 512 MiB segment of the
        deployment's vector store ("auto") -> (the segment, the arguments
        of the load of all its rows, as ``decode_bytes`` makes them)."""
        from repro_torch.configs.decouplevs_ann import CONFIG
        from repro_torch.core.storage.vector_store import (
            DecoupledVectorStore, StoreConfig)
        torch = self.torch
        v = vecs[0].numel() * vecs.element_size()
        cap = CONFIG.segment_bytes // v
        n = min(cap, vecs.shape[0])
        vs = DecoupledVectorStore(StoreConfig(
            dim=vecs.shape[1], dtype=vecs.dtype,
            chunk_bytes=CONFIG.chunk_bytes, segment_capacity=cap,
            device=self.dev))
        vs.append(torch.arange(n, device=self.dev), vecs[:n])
        vs.seal_active()
        seg = vs.sealed[0]
        rows = torch.arange(n, device=self.dev)
        return seg, (seg.packed.data, seg.packed.rec_start, v, seg.huff,
                     seg.bases, seg.chunk_base[rows // seg.rows_per_chunk])

    def run_segments(self, shard):
        """One full segment of each store, loaded whole (bit-exact against
        the plain version and the vectors); the SIFT one also in random
        row order. Kept for the report's timings."""
        from repro_torch.data.synthetic import prop_like_torch
        torch = self.torch
        prop = prop_like_torch(Shard.SEGMENT_ROWS_F32, 128, self.seed + 5,
                               self.dev)
        self.segments = {"prop-like": self.segment(prop),
                         "SIFT": self.segment(shard.index.vectors)}
        for (name, (seg, args)), vecs in zip(self.segments.items(),
                                             (prop, shard.index.vectors)):
            got = self.compare("huffman_decode", f"full {name} segment",
                               *args)[0]
            check(bool(torch.equal(got, vecs[:got.shape[0]].view(torch.uint8)
                                   .reshape(got.shape))),
                  f"full {name} segment: rows not recovered")
        check(self.segments["prop-like"][0].bases.shape[0] > 0,
              "the prop-like segment has no chunk with a base")
        payload, starts, v, table, bases, base_of = self.segments["SIFT"][1]
        perm = torch.randperm(len(starts), generator=self.g, device=self.dev)
        self.compare("huffman_decode", "SIFT segment, rows unsorted", payload,
                     starts[perm], v, table, bases, base_of[perm])
        self.shard_in["huffman_decode"] = self.segments["prop-like"][1]

    def run_shard(self, shard):
        """The shard's own shapes and data, inputs kept for the timings."""
        torch = self.torch
        t0 = time.time()
        nq, W, R, L = shard.nq, shard.p.beam_width, shard.R, shard.p.l_size
        n = shard.n
        luts = shard.luts()
        pq_codes = shard.index.pq_codes
        cand_ids = self.randint(n, nq, L, dtype=torch.int32)
        cand_d = self.compare("pq_adc_batched", "shard candidates by id",
                              pq_codes, luts, cand_ids)[0]
        cand_d, order = cand_d.sort(1)
        cand_ids = torch.gather(cand_ids, 1, order)
        cand_d = cand_d.contiguous()

        def hop_ids():     # one hop's fresh neighbour ids, 60% kept
            sel = self.randint(n, nq, W * R)
            return torch.where(torch.rand(nq, W * R, generator=self.g,
                                          device=self.dev) < 0.6,
                               sel, -1).to(torch.int32)
        # fresh id sets, so the timed calls find their rows cold (report)
        k_re = shard.p.rerank_batch
        self.cold = {
            "beam_step": [(pq_codes, luts, cand_ids, cand_d, hop_ids())
                          for _ in range(self.COLD_SETS)],
            "ef_decode": [(shard.index.ef_slots, R, n,
                           self.randint(n, nq * W, dtype=torch.int32))
                          for _ in range(self.COLD_SETS)],
            "pq_adc_batched": [(pq_codes, luts, hop_ids())
                               for _ in range(self.COLD_SETS)],
            # one re-rank batch: k_re ids a query, every one kept
            "rerank_l2": [(shard.queries, shard.index.vectors,
                           self.table_ids(n, nq, k_re, "kept"))
                          for _ in range(self.COLD_SETS)],
            # the whole re-rank at the search's K, B and threshold
            "rerank_loop": self.rerank_loop_args(
                shard.queries, shard.index.vectors, shard.p,
                self.COLD_SETS)}
        # the search's steady state: the candidate half holds the best L
        # of 4,096 rows a query, so few new ids beat its last entry
        deep = self.randint(n, nq, 4096, dtype=torch.int32)
        deep_d, order = self.ops["pq_adc_batched"][0](pq_codes, luts,
                                                      deep).sort(1)
        steady = (torch.gather(deep, 1, order[:, :L]).contiguous(),
                  deep_d[:, :L].contiguous())
        del deep, deep_d, order
        self.beam_regimes = {
            "all masked": [(pq_codes, luts, cand_ids, cand_d,
                            torch.full((nq, W * R), -1, dtype=torch.int32,
                                       device=self.dev))],
            "steady state": [(pq_codes, luts, *steady, hop_ids())
                             for _ in range(self.COLD_SETS)],
            "timed set": self.cold["beam_step"]}
        self.shard_in = {
            "pq_adc_batched": self.cold["pq_adc_batched"][0],
            "beam_step": self.cold["beam_step"][0],
            "ef_decode": self.cold["ef_decode"][0],
            "rerank_l2": self.cold["rerank_l2"][0],
            "rerank_loop": self.cold["rerank_loop"][0],
            "pq_encode": (shard.index.vectors[:1 << 18].clone(),
                          shard.index.pq_centroids),
            # one query's exhaustive ADC over every code of the shard
            "pq_adc": (shard.index.pq_codes, luts[0].contiguous()),
            # a prop-like 4 MiB chunk, XOR-delta against its own base
            "byteplane": self.delta_chunk(prop_like_chunk(torch, self.dev)),
        }
        self.compare("byteplane", "shard SIFT chunk", *self.delta_chunk(
            shard.index.vectors[:32768]))
        self.run_segments(shard)
        self.record_segment(shard)
        # the entry by id, the hop's edge cases, and both ops without ids
        # on the rows they read
        self.compare("pq_adc_batched", "shard entry by id", pq_codes, luts,
                     cand_ids[:, :1].contiguous())
        for kind in ("edges", "repeated", "masked-row"):
            self.compare("pq_adc_batched", f"shard hop {kind}", pq_codes,
                         luts, self.table_ids(n, nq, W * R, kind))
        new_ids = self.cold["pq_adc_batched"][0][2]
        self.compare("pq_adc_batched", "shard hop gathered, no ids",
                     pq_codes[new_ids.clamp(0, n - 1)], luts)
        rr_ids = self.cold["rerank_l2"][0][2]
        for kind in ("edges", "repeated"):
            self.compare("rerank_l2", f"shard {kind}", shard.queries,
                         shard.index.vectors,
                         self.table_ids(n, nq, k_re, kind))
        self.compare("rerank_l2", "shard gathered, no ids", shard.queries,
                     shard.index.vectors[rr_ids.long()])
        # the round kernels at the search's round 1 and mid-traversal
        rounds = self.round_states(shard, luts, (0, self.MID_ROUND))
        for r, (expand_in, settle_in) in rounds.items():
            if r != self.MID_ROUND:
                self.compare("round_expand", f"shard round {r + 1}",
                             *expand_in)
                self.compare("round_settle", f"shard round {r + 1}",
                             *settle_in)
        self.shard_in["round_expand"], self.shard_in["round_settle"] = \
            rounds[self.MID_ROUND]
        del rounds
        for op, args in self.shard_in.items():
            out = self.compare(op, "shard", *args)
            if op == "pq_encode":
                check(bool(torch.equal(out[0],
                                       shard.index.pq_codes[:1 << 18])),
                      "pq_encode: codes differ from the shard's")
            if op == "ef_record_decode":
                rows = min(shard.CHUNK, n)
                check(bool((out[1] == R).all()) and bool(torch.equal(
                    out[0][:rows], shard.adjacency(0, rows))),
                    "ef_record_decode: the segment's lists not recovered")
            del out
        self.beam_cases("shard", nq, W * R, L, shard.M, table=pq_codes)
        self.compare("beam_step", "shard steady state",
                     *self.beam_regimes["steady state"][0])
        self.compare("ef_decode", "shard ids at the edges",
                     shard.index.ef_slots, R, n, self.ef_ids(n, nq * W))
        self.compare("ef_decode", "shard repeated ids",
                     shard.index.ef_slots, R, n,
                     self.randint(3, nq * W, dtype=torch.int32))
        log(f"parity shard: {dict(self.cases)} cases bit-exact "
            f"({time.time() - t0:.1f} s)")

    def round_states(self, shard, luts, at):
        """The resident shard's traversal of its nq queries, as ``traverse``
        starts it and with its rounds' plain bookkeeping around the fused
        hop -> {r: (round_expand's arguments before round r + 1,
        round_settle's after its expand and hop)} for each r in ``at``."""
        torch = self.torch
        from repro_torch.kernels.search_round import search_round as sr
        p, idx, dev = shard.p, shard.index, self.dev
        nq, L, W, R = shard.nq, p.l_size, p.beam_width, p.r_max
        bits = p.visited_hash_bits
        entry = idx.medoid.to(torch.int32).expand(nq).contiguous()
        st = dict(
            cand_ids=torch.full((nq, L), -1, dtype=torch.int32, device=dev),
            cand_d=torch.full((nq, L), torch.inf, device=dev),
            expanded=torch.zeros((nq, L), dtype=torch.bool, device=dev),
            active=torch.ones(nq, dtype=torch.bool, device=dev),
            visited=torch.full((nq, (1 << bits) + 1), -1, dtype=torch.int32,
                               device=dev),
            **{k: torch.zeros(nq, dtype=torch.int32, device=dev)
               for k in ("fetched", "pq_ct", "iters", "stab")},
            pf_iter=torch.full((nq,), -1, dtype=torch.int32, device=dev),
            prev_top=torch.full((nq, min(p.k + p.rerank_batch, L)), -1,
                                dtype=torch.int32, device=dev),
            flag=torch.zeros((), dtype=torch.bool, device=dev),
            new_ids=torch.empty((nq, W * R), dtype=torch.int32, device=dev))
        st["cand_ids"][:, 0] = entry
        st["cand_d"][:, 0] = self.ops["pq_adc_batched"][0](
            idx.pq_codes, luts, entry[:, None])[:, 0]
        st["visited"][torch.arange(nq, device=dev),
                      sr.hash_slots(entry, bits)] = entry

        def expand_in(s):
            return (idx.ef_slots, R, p.universe, s["cand_ids"], s["cand_d"],
                    s["expanded"], s["active"], s["visited"], s["fetched"],
                    s["pq_ct"], s["flag"], s["new_ids"], W, bits)

        def settle_in(top, s):
            return (*top, s["cand_ids"], s["cand_d"], s["expanded"],
                    s["iters"], s["stab"], s["pf_iter"], s["prev_top"],
                    s["active"], s["flag"], W, p.rerank_batch, p.max_iters)

        def copy(s):
            return {k: v.clone() for k, v in s.items()}
        out = {}
        for r in range(max(at) + 1):
            before = copy(st) if r in at else None
            sr.round_expand_ref(*expand_in(st))
            top_ids, top_d, top_i = self.ops["beam_step"][0](
                idx.pq_codes, luts, st["cand_ids"], st["cand_d"],
                st["new_ids"])
            top = (top_ids, top_d, top_i.to(torch.int32))
            if r in at:
                out[r] = (expand_in(before), settle_in(top, copy(st)))
            sr.round_settle_ref(*settle_in(top, st))
        log(f"round states: rounds {sorted(at)} of the shard's traversal "
            f"(nq {nq}, L {L}, W {W}, R {R}, hash bits {bits}); rows "
            f"active before each: " + ", ".join(
                str(int(e[6].sum())) for e, _ in out.values()))
        return out


# ------------------------------------------------------------- small world
def small_world(torch, seed: int) -> None:
    from repro_torch.core.index import (build_device_index, recall_at_k,
                                        verify_index_slots)
    from repro_torch.core.search.beam import DeviceIndex, SearchParams, search
    from repro_torch.data.synthetic import (ground_truth, make_queries,
                                            make_vector_dataset)
    t0 = time.time()
    vecs = make_vector_dataset("prop-like", n=1200, dim=32,
                               seed=seed).astype(np.float32)
    index, _, _ = build_device_index(vecs, r=24, l_build=48, pq_m=8,
                                     seed=seed)
    cpu_index = DeviceIndex(*(None if t is None else t.cpu() for t in index))
    queries = make_queries("prop-like", 32, 32).astype(np.float32)
    gt = ground_truth(vecs, queries, k=10)
    check(verify_index_slots(index, 24, 1200), "small world EF slots lossy")
    t_build = time.time() - t0
    recalls = {}
    for bits in (0, 10):
        p = SearchParams(l_size=48, beam_width=4, k=10, rerank_batch=10,
                         r_max=24, universe=1200, max_iters=128,
                         visited_hash_bits=bits, trace_fetches=True,
                         trace_hints=True)
        got = search(index, queries, p)
        want = search(cpu_index, queries, p, device="cpu")
        tag = f"hash_bits={bits}"
        check(bits_equal(torch, got[0].cpu(), want[0]), f"{tag}: ids")
        check(bits_equal(torch, got[1].cpu(), want[1]), f"{tag}: dists")
        for f, a, b in zip(want[2]._fields, got[2], want[2]):
            check(bits_equal(torch, a.cpu(), b), f"{tag}: stats.{f}")
        rec = recall_at_k(got[0], gt, 10)
        recalls[tag] = rec
        # the golden is the dense visited set's; 2^10 hashed slots
        # evict and re-visit, a different (cheaper) search
        check(bits or rec >= GOLDEN_RECALL_AT_10,
              f"{tag}: recall@10 {rec} < {GOLDEN_RECALL_AT_10}")
    log(f"small world: n=1200 dim=32 r=24 pq_m=8 32 queries; card == CPU "
        f"bit for bit (ids, dists, every SearchStats field) for dense/hashed;"
        f" recall@10 {recalls} (golden {GOLDEN_RECALL_AT_10} for dense); "
        f"build {t_build:.1f} s, total {time.time() - t0:.1f} s")


# ------------------------------------------------------------------- shard
def random_graph_rows(torch, n, r, seed, a, b, dev, chunk):
    """Rows a..b (within one chunk) of the seeded random r-regular graph on
    n vertices, each list sorted, distinct and without its own vertex."""
    g = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + a // chunk)
    u = torch.randint(0, n - r, (b - a, r), generator=g,
                      device=dev).sort(1).values
    v = u + torch.arange(r, device=dev)
    rows = torch.arange(a, b, device=dev)[:, None]
    return v + (v >= rows).long()


class Shard:
    """One data shard of the SIFT1B deployment, resident on the card."""

    R, M, D = 128, 32, 128
    CHUNK = 1 << 20
    SEGMENT_ROWS_F32 = (512 << 20) // (128 * 4)   # one prop-like segment

    def __init__(self, torch, args):
        from repro_torch.configs.decouplevs_ann import CONFIG
        from repro_torch.core.search.beam import SearchParams
        self.torch, self.seed = torch, args.seed
        self.dev = torch.device("cuda")
        self.n, self.nq = args.n, args.queries
        check(CONFIG.r == self.R and CONFIG.pq_m == self.M
              and CONFIG.dim == self.D, "shard shapes follow ANNConfig")
        # lower_production_search's per-shard parameters
        self.p = SearchParams(
            l_size=CONFIG.l_size, beam_width=CONFIG.beam_width, k=CONFIG.k,
            rerank_batch=CONFIG.rerank_batch, r_max=CONFIG.r,
            universe=self.n, max_iters=64, use_ef=True,
            visited_hash_bits=15)
        if self.n < SHARD_N:
            log(f"reduced: n={self.n} < {SHARD_N} vectors per shard "
                f"(set by --n)")

    def adjacency(self, a: int, b: int):
        """Rows a..b of the seeded random R-regular graph (Vamana's start
        graph)."""
        return random_graph_rows(self.torch, self.n, self.R, self.seed, a, b,
                                 self.dev, self.CHUNK)

    def build(self):
        from repro_torch.core.codec.elias_fano import (encode_slots_torch,
                                                       slot_layout)
        from repro_torch.core.graph.pq import encode_pq_torch, train_pq
        from repro_torch.core.search.beam import DeviceIndex
        from repro_torch.data.synthetic import sift_like_torch
        from repro_torch.kernels import build
        torch, n, dev = self.torch, self.n, self.dev
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.time()
        vectors = sift_like_torch(n, self.D, self.seed, dev)
        torch.cuda.synchronize()
        t_vec = time.time() - t0
        g = torch.Generator(device=dev).manual_seed(self.seed + 2)
        sample = vectors[torch.randperm(n, generator=g, device=dev)[:20_000]]
        t1 = time.time()
        cb = train_pq(sample.cpu().numpy(), m=self.M, seed=self.seed)
        t_train = time.time() - t1
        centroids = torch.from_numpy(cb.centroids).to(dev)
        self.centroids = centroids        # phase 4d reuses the codebook
        t1 = time.time()
        codes = encode_pq_torch(vectors, centroids)
        torch.cuda.synchronize()
        t_enc = time.time() - t1
        medoid = medoid_of(torch, vectors, self.CHUNK)
        t1 = time.time()
        words = slot_layout(self.R, n)[3]
        slots = torch.empty((n, words), dtype=torch.int32, device=dev)
        full = torch.full((self.CHUNK,), self.R, dtype=torch.int32,
                          device=dev)
        for a in range(0, n, self.CHUNK):
            b = min(a + self.CHUNK, n)
            slots[a:b] = encode_slots_torch(self.adjacency(a, b),
                                            full[:b - a], self.R, n)
        torch.cuda.synchronize()
        t_ef = time.time() - t1
        self.index = DeviceIndex(
            neighbors=torch.full((1, self.R), -1, dtype=torch.int32,
                                 device=dev),
            counts=torch.full((n,), self.R, dtype=torch.int32, device=dev),
            ef_slots=slots, pq_codes=codes, pq_centroids=centroids,
            vectors=vectors,
            medoid=torch.tensor(medoid, dtype=torch.int64, device=dev))
        self.build_launches = dict(build.LAUNCHES)
        check(self.build_launches["pq_encode"] > 0,
              "shard build never launched pq_encode")
        resident = torch.cuda.memory_allocated()
        log(f"shard: n={n} dim={self.D} uint8 sift-like, R={self.R} "
            f"({words} EF words = {4 * words} B a list, "
            f"{slots.numel() * 4 / 1e9:.2f} GB), PQ M={self.M} K=256 codes "
            f"{codes.numel() / 1e9:.2f} GB, vectors "
            f"{vectors.numel() / 1e9:.2f} GB, medoid {medoid}; resident "
            f"{resident / 1e9:.2f} GB of "
            f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB"
            f" (peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB); "
            f"draw {t_vec:.1f} s, PQ train (host, 20k sample) {t_train:.1f} "
            f"s, PQ encode {t_enc:.2f} s, EF encode {t_ef:.1f} s; build "
            f"launches {self.build_launches}")
        log("shard: recall not checked at this scale (random graph, "
            "no Vamana build)")

    def verify_slots(self):
        """Paper Q1: every slot decodes to its source list (ef_decode)."""
        from repro_torch.kernels import dispatch
        torch, n = self.torch, self.n
        t0 = time.time()
        for a in range(0, n, self.CHUNK):
            b = min(a + self.CHUNK, n)
            vals, cnts = dispatch.ef_decode(self.index.ef_slots[a:b], self.R,
                                            n)
            check(bool((cnts == self.R).all())
                  and bool(torch.equal(vals.long(), self.adjacency(a, b))),
                  f"EF slots {a}..{b} do not decode to their lists")
        torch.cuda.synchronize()
        log(f"shard: all {n} EF slots decode losslessly through the "
            f"ef_decode kernel ({time.time() - t0:.1f} s)")

    @property
    def queries(self):
        if not hasattr(self, "_queries"):
            from repro_torch.data.synthetic import sift_like_torch
            self._queries = sift_like_torch(self.nq, self.D,
                                            self.seed + 10_000,
                                            self.dev).float()
        return self._queries

    def luts(self):
        from repro_torch.core.graph.pq import build_lut_torch
        return build_lut_torch(self.queries, self.index.pq_centroids)

    def search(self):
        from repro_torch.kernels import build, dispatch
        from repro_torch.core.search.beam import search
        torch = self.torch
        q = self.queries
        search(self.index, q, self.p)                        # warm-up
        torch.cuda.synchronize()
        runs = []
        for _ in range(2):
            build.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, dists, stats = search(self.index, q, self.p)
            torch.cuda.synchronize()
            runs.append((ids, dists, stats, time.perf_counter() - t0,
                         dict(build.LAUNCHES)))
        (ids, dists, st, _, launches), (ids2, d2, st2, _, launches2) = runs
        walls = [r[3] for r in runs]
        check(bits_equal(torch, ids, ids2) and bits_equal(torch, dists, d2),
              "two searches of the same queries disagree")
        for f, a, b in zip(st._fields, st, st2):
            check(bits_equal(torch, a, b), f"repeated search stats.{f}")
        check(launches == launches2, "two searches launch differently")
        live = ids >= 0
        check(bool(live.all()), "a query returned fewer than k results")
        recompute = dispatch.get_impl("rerank_l2", "ref")(
            q, self.index.vectors[ids.long()])
        check(bits_equal(torch, recompute, dists),
              "returned distances != recompute of |x_id - q|^2")
        exact64 = ((self.index.vectors[ids.long()].double()
                    - q.double()[:, None]) ** 2).sum(-1)
        rel = float(((exact64 - dists.double()).abs()
                     / exact64.clamp_min(1)).max())
        check(rel < 1e-6, f"distances vs float64 recompute: rel {rel}")
        self.result = (ids, dists)
        for name in ("beam_step", "pq_adc_batched", "rerank_loop"):
            check(launches[name] > 0, f"{name} never launched on the main "
                  f"path")
        check(launches["rerank_loop"] == 1 and launches["rerank_l2"] == 0,
              "the search's re-rank is not one rerank_loop launch")
        check(lists_decoded(launches) > 0,
              "no EF list decoded on the main path")
        it = st.iters.float()
        log(f"search: {self.nq} queries, L={self.p.l_size} W="
            f"{self.p.beam_width} k={self.p.k} B={self.p.rerank_batch} "
            f"max_iters={self.p.max_iters} hash_bits=15; wall s (after a "
            f"warm-up) {walls}; QPS {[self.nq / w for w in walls]}; hops "
            f"mean {float(it.mean()):.2f} max {int(it.max())}; lists fetched "
            f"mean {float(st.lists_fetched.float().mean()):.1f}; rerank "
            f"batches mean {float(st.rerank_batches.float().mean()):.2f}; "
            f"both runs equal bit for bit (ids, dists, stats); dists == "
            f"recompute (max rel vs float64 {rel:.2e})")
        log(f"launches: {launches}")
        self.profile(walls[0])
        return {name: launches[name] for name in
                ("beam_step", "ef_decode", "pq_adc_batched", "rerank_loop",
                 "round_expand", "round_settle")}

    def profile(self, wall: float):
        """Device busy time of one search, by kernel (torch.profiler over
        CUPTI), against the search's wall time; and the device time of the
        row-gather ops by input shape."""
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.core.search.beam import search
        torch = self.torch
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            search(self.index, self.queries, self.p)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        n = self.index.pq_codes.shape[0]
        tables = ([n, self.M], [n, self.D])
        reads = [(ev.key, ev.input_shapes, ev.count) for ev in
                 prof.key_averages(group_by_input_shape=True)
                 if ev.key in ("aten::index", "aten::index_select")
                 and any(list(sh) in tables for sh in ev.input_shapes
                         if isinstance(sh, (list, tuple)))]
        check(not reads, f"search: a torch row gather still reads the "
              f"shard's PQ codes or vectors: {reads}")
        log(f"profile (search): no aten::index reads pq_codes {tables[0]}"
            f" or vectors {tables[1]}")
        if not device_busy(torch, prof, "search", wall, prof_wall):
            return
        ops = sorted(
            ((ev.device_time_total, ev.count, ev.key, ev.input_shapes)
             for ev in prof.key_averages(group_by_input_shape=True)
             if ev.key in ("aten::index", "aten::gather",
                           "aten::index_select", "aten::take")
             and ev.device_time_total > 0), reverse=True)
        log(f"profile (search): row-gather ops by input shape: "
            + "; ".join(f"{k} {sh} x{c} {us / 1e3:.2f} ms"
                        for us, c, k, sh in ops[:8]))


def device_busy(torch, prof, what, wall, prof_wall) -> bool:
    """Log the device busy time of a profiled run against its unprofiled
    (None: not run) and profiled walls, with the top kernels; False if the
    profiler saw no device time."""
    # device-side events only (kernels, memsets, copies): the CPU ops
    # that launched them carry the same time again
    rows = [(ev.self_device_time_total, ev.count, ev.key[:60])
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    if not rows:
        log(f"profile ({what}): the profiler recorded no device time: "
            f"device busy share not measured")
        return False
    busy = sum(r[0] for r in rows) / 1e6
    rows.sort(reverse=True)
    top = "; ".join(f"{k} {us / 1e3:.2f} ms x{c}" for us, c, k in rows[:8])
    share = "" if wall is None else (
        f"{100 * busy / wall:.1f}% of the unprofiled wall {wall:.3f} s (")
    log(f"profile ({what}): device busy {busy * 1e3:.2f} ms = {share}"
        f"{100 * busy / prof_wall:.1f}% of the profiled {prof_wall:.3f} s"
        f"{'' if wall is None else ')'}; top device time: {top}")
    return True


# ----------------------------------------------------------------- storage
def sync_time(torch, t0=None):
    torch.cuda.synchronize()
    return time.perf_counter() if t0 is None else time.perf_counter() - t0


class Storage:
    """Phase 4b: the §3.3 storage path on the shard, then the prop-like
    store. Launch counts are reset before each path and read after it."""

    def __init__(self, torch, shard, args):
        from repro_torch.configs.decouplevs_ann import CONFIG
        self.torch, self.shard, self.ann = torch, shard, CONFIG
        self.dev, self.seed, self.prop_n = shard.dev, args.seed, args.prop_n
        if self.prop_n < SHARD_N:
            log(f"reduced: prop-like store n={self.prop_n} < {SHARD_N} "
                f"vectors (set by --prop-n)")

    def store(self, dim, dtype):
        from repro_torch.core.storage.vector_store import (
            DecoupledVectorStore, StoreConfig)
        v_bytes = dim * dtype.itemsize
        return DecoupledVectorStore(StoreConfig(
            dim=dim, dtype=dtype, chunk_bytes=self.ann.chunk_bytes,
            segment_capacity=self.ann.segment_bytes // v_bytes,
            device=self.dev))

    @staticmethod
    def chunks(vs):
        chunks = [c for s in vs.sealed.values() for c in s.chunks]
        return len(chunks), sum(c.base is not None for c in chunks)

    def run(self) -> dict:
        launches = self.sift()
        for name, n in self.prop_like().items():
            launches[name] += n
        return launches

    def sift(self) -> dict:
        from repro_torch.core.search.beam import search
        from repro_torch.core.storage.colocated import ColocatedStore
        from repro_torch.core.storage.index_store import (
            CompressedIndexStore, RawIndexStore)
        from repro_torch.kernels import build
        torch, shard, dev = self.torch, self.shard, self.dev
        n, R, D = shard.n, shard.R, shard.D
        vectors = shard.index.vectors
        medoid = int(shard.index.medoid)
        build.reset_launches()
        # 1. the vectors, sealed under "auto"
        vs = self.store(D, torch.uint8)
        t0 = sync_time(torch)
        vs.append(torch.arange(n, device=dev), vectors)
        vs.seal_active()
        t_seal = sync_time(torch, t0)
        n_chunks, n_delta = self.chunks(vs)
        log(f"storage: SIFT vectors sealed: {n} x {D} uint8 in "
            f"{len(vs.sealed)} segments of {vs.cfg.segment_capacity}, "
            f"{n_chunks} chunks of {vs.cfg.chunk_vectors}; XOR-delta chosen "
            f"in {n_delta} chunks; {vs.physical_bytes} B in blocks + "
            f"{vs.metadata_bytes} B metadata (beta {vs.beta_actual():.6f}); "
            f"seal {t_seal:.2f} s ({n * D / t_seal / 1e9:.2f} GB/s)")
        # 2. the graph, sealed into the Elias-Fano block index store
        adj = torch.empty((n, R), dtype=torch.int32, device=dev)
        for a in range(0, n, shard.CHUNK):
            adj[a:a + shard.CHUNK] = shard.adjacency(a, min(a + shard.CHUNK,
                                                            n))
        t0 = sync_time(torch)
        ix = CompressedIndexStore.from_graph(adj, medoid, R, universe=n,
                                             device=dev)
        t_ix = sync_time(torch, t0)
        t0 = sync_time(torch)
        batches = 0
        for a in range(0, n, shard.CHUNK):
            b = min(a + shard.CHUNK, n)
            vals, cnt = ix.decode_batch(torch.arange(a, b, device=dev))
            batches += 1
            check(bool((cnt == R).all()) and bool(torch.equal(
                vals, shard.adjacency(a, b))),
                f"index store records {a}..{b} do not decode to their lists")
        t_dec = sync_time(torch, t0)
        check(build.LAUNCHES["ef_record_decode"] == batches,
              f"ef_record_decode launched {build.LAUNCHES['ef_record_decode']}"
              f" times for {batches} decode_batch calls")
        rec_mean = float(ix.rec_len.double().mean())
        log(f"storage: index store sealed: {n} EF records (mean "
            f"{rec_mean:.2f} B) in {ix.n_blocks} blocks ({n / ix.n_blocks:.2f}"
            f" a block), {ix.physical_bytes} B + sparse index "
            f"{ix.sparse_index_bytes} B; seal {t_ix:.2f} s; every record "
            f"decoded back equal to its list in {t_dec:.2f} s, "
            f"{batches} decode_batch calls of one ef_record_decode launch "
            f"each")
        # 3. space: co-located baseline, raw decoupled, compressed decoupled
        colo = ColocatedStore.build(vectors, adj, medoid, R)
        raw_ix = RawIndexStore.from_graph(adj, medoid, R).physical_bytes
        del adj
        raw = raw_ix + n * D
        comp = vs.physical_bytes + ix.physical_bytes
        meta = vs.metadata_bytes + ix.sparse_index_bytes
        log(f"space: co-located {colo.physical_bytes} B ({colo.record_bytes}"
            f" B records, {colo.records_per_block} a block); decoupled raw "
            f"{raw} B (index {raw_ix}, vectors {n * D}); decoupled "
            f"compressed {comp} B (vectors {vs.physical_bytes}, index "
            f"{ix.physical_bytes}) + in-memory metadata {meta} B; saving vs "
            f"co-located {100 * (1 - comp / colo.physical_bytes):.2f}%, vs "
            f"decoupled raw {100 * (1 - comp / raw):.2f}%")
        del colo
        # 4. every vector loaded back, the search run on them
        t0 = sync_time(torch)
        loaded = vs.get(torch.arange(n, device=dev), account=False)
        t_load = sync_time(torch, t0)
        check(bool(torch.equal(loaded, vectors)),
              "SIFT vectors loaded from the store differ from the originals")
        index = shard.index._replace(vectors=loaded)
        ids, dists, _ = search(index, shard.queries, shard.p)
        torch.cuda.synchronize()
        check(bits_equal(torch, ids, shard.result[0])
              and bits_equal(torch, dists, shard.result[1]),
              "search over the loaded vectors differs from phase 4's")
        recall = self.pq_scan(index, ids)
        launches = dict(build.LAUNCHES)
        log(f"storage: all {n} SIFT vectors loaded bit-exact in {t_load:.3f}"
            f" s ({n * D / t_load / 1e9:.2f} GB/s); fused search over them "
            f"== phase 4 (ids, dists); beam search recall@{shard.p.k} against"
            f" an exhaustive PQ scan + exact re-rank of its 100 best "
            f"(8 queries) {recall:.4f}; launches {launches}")
        for name in ("beam_step", "pq_adc_batched", "rerank_loop", "pq_adc"):
            check(launches[name] > 0, f"{name} never launched on the "
                  f"storage path")
        check(lists_decoded(launches) > 0,
              "no EF list decoded on the storage path")
        check(launches["huffman_decode"] == len(vs.sealed),
              f"huffman_decode launched {launches['huffman_decode']} times "
              f"for {len(vs.sealed)} segments")
        check(launches["byteplane"] == 0, "byteplane launched on the load")
        shard.index = None           # the shard's tensors go before prop-like
        return {name: launches[name] for name in (
            "pq_adc", "huffman_decode", "byteplane", "ef_record_decode")}

    def pq_scan(self, index, ids, nq=8, depth=100) -> float:
        """Exhaustive PQ scan of ``nq`` queries through the single-LUT
        pq_adc kernel (ADC of every code, exact re-rank of the ``depth``
        best): the beam search's recall@k against it."""
        from repro_torch.core.graph.pq import build_lut_torch
        from repro_torch.kernels import dispatch
        torch, k = self.torch, self.shard.p.k
        q = self.shard.queries[:nq]
        luts = build_lut_torch(q, index.pq_centroids)
        hits = 0
        for i in range(nq):
            d = dispatch.pq_adc(index.pq_codes, luts[i].contiguous())
            top = torch.topk(d, depth, largest=False).indices
            exact = ((index.vectors[top].float() - q[i]) ** 2).sum(1)
            best = top[torch.topk(exact, k, largest=False).indices]
            hits += len(set(best.tolist()) & set(ids[i].tolist()))
        return hits / (nq * k)

    def prop_like(self) -> dict:
        from repro_torch.data.synthetic import prop_like_torch
        from repro_torch.kernels import build
        torch, dev, n, dim = self.torch, self.dev, self.prop_n, 128
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = sync_time(torch)
        x = prop_like_torch(n, dim, self.seed + 3, dev)
        t_draw = sync_time(torch, t0)
        vs = self.store(dim, torch.float32)
        t0 = sync_time(torch)
        vs.append(torch.arange(n, device=dev), x)
        vs.seal_active()
        t_seal = sync_time(torch, t0)
        n_chunks, n_delta = self.chunks(vs)
        check(n_delta > 0, "the §3.3 test chose XOR-delta in no prop-like "
              "chunk: the load would XOR no base back")
        build.reset_launches()
        t0 = sync_time(torch)
        loaded = vs.get(torch.arange(n, device=dev), account=False)
        t_load = sync_time(torch, t0)
        launched = {name: build.LAUNCHES[name]
                    for name in ("huffman_decode", "byteplane")}
        check(bool(torch.equal(loaded.view(torch.int32), x.view(torch.int32))),
              "prop-like vectors loaded from the store differ")
        check(launched["huffman_decode"] == len(vs.sealed),
              f"huffman_decode launched {launched['huffman_decode']} times "
              f"for {len(vs.sealed)} segments")
        check(launched["byteplane"] == 0, "byteplane launched on the load")
        raw = n * dim * 4
        log(f"storage: prop-like {n} x {dim} float32 ({raw} B) drawn in "
            f"{t_draw:.2f} s, sealed in {t_seal:.2f} s "
            f"({raw / t_seal / 1e9:.2f} GB/s) into {len(vs.sealed)} segments,"
            f" {n_chunks} chunks; XOR-delta chosen in {n_delta}; "
            f"{vs.physical_bytes} B in blocks + {vs.metadata_bytes} B "
            f"metadata ({100 * (1 - vs.physical_bytes / raw):.2f}% saved); "
            f"all loaded bit-exact in {t_load:.3f} s "
            f"({raw / t_load / 1e9:.2f} GB/s) with {launched} launches; "
            f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del loaded
        self.profile_load(vs, n, t_load)
        return launched

    def profile_load(self, vs, n, wall):
        """Device busy time of one more load of every vector of ``vs``
        (torch.profiler): how much of the load's wall the card works."""
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = sync_time(torch)
            vs.get(torch.arange(n, device=self.dev), account=False)
            prof_wall = sync_time(torch, t0)
        device_busy(torch, prof, "prop-like load", wall, prof_wall)


# ------------------------------------------------------------------- serve
def add_launches(total: dict, more: dict) -> None:
    for name, n in more.items():
        total[name] = total.get(name, 0) + n


def lists_decoded(launches: dict) -> int:
    """Launches that decode a round's EF lists: ``ef_decode`` in the
    plain round, ``round_expand`` in the fused one."""
    return launches.get("ef_decode", 0) + launches.get("round_expand", 0)


def report_line(rep) -> str:
    """The I/O-model metrics of one served batch."""
    looked = rep.cache_hits + rep.graph_ios
    return (f"graph_ios {rep.graph_ios}, vector_ios {rep.vector_ios}, "
            f"cache hits {rep.cache_hits} ({100 * rep.cache_hits / max(1, looked):.2f}% "
            f"of list fetches), io_rounds {rep.io_rounds}, rerank batches "
            f"{rep.rerank_batches}, modeled_latency_us "
            f"{rep.modeled_latency_us}, modeled_p99_us {rep.modeled_p99_us}")


class Serve:
    """Phase 4c: the serving tier (serve/ann.py) on the resident shard,
    then its frozen sharded branch on the small world, card against CPU."""

    def __init__(self, torch, shard, args):
        self.torch, self.shard, self.seed = torch, shard, args.seed

    def run(self) -> dict:
        launches = self.shard_serve()
        add_launches(launches, self.sharded())
        return launches

    def searcher(self, account_io=True):
        from repro_torch.configs.decouplevs_ann import CONFIG
        from repro_torch.serve.ann import BatchedSearcher, ServeConfig
        shard = self.shard
        cache = int(CONFIG.cache_ratio * shard.n * shard.D)
        return BatchedSearcher(shard.index, shard.p, ServeConfig(
            buckets=(8, 32, 1024), account_io=account_io, cache_bytes=cache))

    def shard_serve(self) -> dict:
        from repro_torch.core.search.beam import search, search_vmapped
        from repro_torch.kernels import build
        torch, shard = self.torch, self.shard
        q = shard.queries.cpu().numpy()
        want_ids = shard.result[0].cpu().numpy()
        want_d = shard.result[1].cpu().view(torch.int32).numpy()
        searcher = self.searcher()
        # the same batches without I/O accounting: the difference of the
        # walls is what the accounting (trace copies + replay) costs
        bare = self.searcher(account_io=False)
        lines = []
        for nq, plan in ((shard.nq, "one bucket"), (1000, "padded"),
                         (37, "ragged")):
            build.reset_launches()
            t0 = sync_time(torch)
            ids, dists, rep = searcher.search(q[:nq])
            wall = sync_time(torch, t0)
            launched = dict(build.LAUNCHES)
            check(np.array_equal(ids, want_ids[:nq])
                  and np.array_equal(dists.view(np.int32), want_d[:nq]),
                  f"serve of {nq} queries != phase 4's fused search")
            t0 = sync_time(torch)
            ids, dists, _ = bare.search(q[:nq])
            wall_bare = sync_time(torch, t0)
            check(np.array_equal(ids, want_ids[:nq])
                  and np.array_equal(dists.view(np.int32), want_d[:nq]),
                  f"serve of {nq} queries without accounting != phase 4's")
            replay = wall - wall_bare
            if nq == shard.nq:
                # the same search issued directly, with the searcher's
                # parameters (its I/O accounting keeps trace buffers, so
                # its rounds are the plain, uncaptured ones)
                build.reset_launches()
                search(shard.index, shard.queries[:nq], searcher.p)
                direct = dict(build.LAUNCHES)
                check(launched == direct,
                      f"the serving tier changed the kernel launches: "
                      f"{launched} != {direct}")
                full = (launched, wall)
            lines.append(f"{nq} queries ({plan}: buckets {rep.buckets}, "
                         f"{rep.n_padded} pad rows) wall {wall:.3f} s, QPS "
                         f"{nq / wall:.1f}, without accounting "
                         f"{wall_bare:.3f} s, so the fetch-trace replay "
                         f"(trace copies + LRU replay) takes {replay:.3f} s "
                         f"({100 * replay / wall:.1f}% of the wall); "
                         f"{report_line(rep)}")
        launched, wall = full
        log(f"serve: BatchedSearcher on the {shard.n}-vector shard, "
            f"buckets (8, 32, 1024), cache {searcher.cfg.cache_bytes} B "
            f"(cache_ratio 0.1% of n x dim); every row == phase 4's fused "
            f"search bit for bit (ids, dists); " + "; ".join(lines))
        log(f"serve launches (1,024 queries) == the same search issued "
            f"directly: {launched}")
        t0 = sync_time(torch)
        ids, _, _ = search_vmapped(shard.index, shard.queries[:8], shard.p)
        t_vm = sync_time(torch, t0)
        check(bits_equal(torch, ids, shard.result[0][:8]),
              "search_vmapped ids != search's")
        log(f"search_vmapped: 8 queries one at a time in {t_vm:.3f} s, ids "
            f"== search's")
        self.profile(searcher, q, wall)
        return launched

    def profile(self, searcher, q, wall):
        """The card's busy share of one more served batch."""
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = sync_time(torch)
            searcher.search(q)
            prof_wall = sync_time(torch, t0)
        device_busy(torch, prof, "serve of 1,024 queries", wall, prof_wall)

    def sharded(self) -> dict:
        """The frozen sharded branch: the small world (n=1200) in 4 range
        shards, a router at route_frac 0.5 and one failed shard; the card
        serves what the CPU serves."""
        from repro_torch.core.distributed.sharded_index import (
            ShardedIndex, ShardRouter, build_router, build_sharded_index)
        from repro_torch.core.search.beam import SearchParams
        from repro_torch.data.synthetic import (make_queries,
                                                make_vector_dataset)
        from repro_torch.kernels import build
        from repro_torch.serve.ann import BatchedSearcher, ServeConfig
        torch, dev = self.torch, self.shard.dev
        t0 = time.time()
        vecs = make_vector_dataset("prop-like", n=1200, dim=32,
                                   seed=self.seed).astype(np.float32)
        on_cpu, per = build_sharded_index(vecs, 4, r=24, l_build=48, pq_m=8,
                                          seed=self.seed, device="cpu")
        on_card = ShardedIndex(*(t.to(dev) for t in on_cpu))
        router = build_router(on_cpu, c=4, seed=self.seed)
        queries = make_queries("prop-like", 32, 32).astype(np.float32)
        p = SearchParams(l_size=48, beam_width=4, k=10, rerank_batch=10,
                         r_max=24, universe=per, max_iters=128)
        cfg = ServeConfig(buckets=(8, 32), route_frac=0.5,
                          cache_bytes=1 << 16)
        card = BatchedSearcher(on_card, p, cfg, shard_size=per,
                               router=ShardRouter(router.centroids.to(dev)))
        cpu = BatchedSearcher(on_cpu, p, cfg, shard_size=per, router=router,
                              device="cpu")
        build.reset_launches()
        parts = []
        for failed in (None, [1]):
            got = card.search(queries, failed_shards=failed)
            want = cpu.search(queries, failed_shards=failed)
            check(np.array_equal(got[0], want[0])
                  and np.array_equal(got[1].view(np.int32),
                                     want[1].view(np.int32)),
                  f"sharded serve (failed {failed}): card != CPU")
            for f in ("graph_ios", "vector_ios", "cache_hits", "routed_rows",
                      "io_rounds", "modeled_latency_us", "failed_shards"):
                check(getattr(got[2], f) == getattr(want[2], f),
                      f"sharded serve (failed {failed}): report.{f}")
            parts.append(f"failed {failed}: fan-out "
                         f"{got[2].fanout_frac:.3f}, {report_line(got[2])}")
        launched = dict(build.LAUNCHES)
        for name in ("beam_step", "pq_adc_batched", "rerank_loop"):
            check(launched[name] > 0, f"sharded serve launched no {name}")
        check(lists_decoded(launched) > 0, "sharded serve decoded no list")
        log(f"serve (sharded): small world n=1200 in 4 range shards of "
            f"{per}, router 4 centroids a shard, route_frac 0.5; card == "
            f"CPU bit for bit (ids, dists, report) for "
            + "; ".join(parts) + f"; launches {launched}; "
            f"{time.time() - t0:.1f} s")
        return launched


# ------------------------------------------------------------------- mesh
def lex_merge_host(ids, dists, k):
    """The (distance, id) top-k of each row of [Q, C] host candidates, -1
    ids last among equal distances: a plain host merge, independent of the
    port's merges."""
    key = np.where(ids < 0, np.iinfo(np.int32).max, ids)
    out_i = np.empty((len(ids), k), ids.dtype)
    out_d = np.empty((len(ids), k), dists.dtype)
    for qi in range(len(ids)):
        order = np.lexsort((key[qi], dists[qi]))[:k]
        out_i[qi], out_d[qi] = ids[qi][order], dists[qi][order]
    return out_i, out_d


class MeshSearch:
    """Phase 4e: ``make_sharded_search``'s stacked form, the deployment's
    32 data shards on one card. The resident shard's vectors are split
    into 32 contiguous range shards of ceil(n / 32) rows (the last one
    padded with copies of its last row, row_ids -1); each shard gets its
    own seeded random R=128 graph in local ids, its EF slots at universe
    ceil(n / 32) and the shard's PQ codes under phase 4's codebook."""

    S, ROUTER_ROWS = 32, 2048

    def __init__(self, torch, shard, parity, args):
        self.torch, self.shard, self.seed = torch, shard, args.seed
        self.parity = parity

    def build(self):
        from repro_torch.core.codec.elias_fano import (encode_slots_torch,
                                                       slot_layout)
        from repro_torch.core.distributed.sharded_index import ShardedIndex
        torch, shard, S = self.torch, self.shard, self.S
        dev, R, n = shard.dev, shard.R, shard.n
        per = -(-n // S)
        t0 = sync_time(torch)
        # the pad rows (only the last shard has any) repeat its last row
        rows = torch.arange(S * per, device=dev).clamp_max(n - 1)
        row_ids = torch.arange(S * per, dtype=torch.int32, device=dev)
        row_ids = torch.where(row_ids < n, row_ids, -1).view(S, per)
        vectors = shard.index.vectors[rows.reshape(-1)].view(S, per, -1)
        codes = shard.index.pq_codes[rows.reshape(-1)].view(S, per, -1)
        del rows
        words = slot_layout(R, per)[3]
        slots = torch.empty((S, per, words), dtype=torch.int32, device=dev)
        full = torch.full((Shard.CHUNK,), R, dtype=torch.int32, device=dev)
        medoids = []
        for s in range(S):
            for a in range(0, per, Shard.CHUNK):
                b = min(a + Shard.CHUNK, per)
                adj = random_graph_rows(torch, per, R, self.seed + 101 + s,
                                        a, b, dev, Shard.CHUNK)
                slots[s, a:b] = encode_slots_torch(adj, full[:b - a], R, per)
            medoids.append(medoid_of(torch, vectors[s], Shard.CHUNK))
        cents = shard.index.pq_centroids
        self.index = ShardedIndex(
            neighbors=torch.full((S, 1, R), -1, dtype=torch.int32,
                                 device=dev),
            counts=torch.full((S, per), R, dtype=torch.int32, device=dev),
            ef_slots=slots, pq_codes=codes,
            pq_centroids=cents[None].expand((S,) + cents.shape),
            vectors=vectors,
            medoid=torch.tensor(medoids, dtype=torch.int64, device=dev),
            row_ids=row_ids)
        self.per, self.n_pad = per, S * per - n
        self.p = shard.p._replace(universe=per)
        card = sum(t.numel() * t.element_size() for t in
                   (slots, codes, vectors, row_ids))
        log(f"reduced: mesh per-shard n={per} (S={S})")
        log(f"mesh: the {n}-vector shard as {S} range shards of {per} rows "
            f"({self.n_pad} pad rows with row_ids -1 in the last), R={R} "
            f"random graph a shard in local ids, EF slots of {words} words "
            f"at universe {per}, phase 4's PQ codes and codebook; card bytes "
            f"{card / 1e9:.2f} GB (vectors {vectors.numel() / 1e9:.2f}, codes "
            f"{codes.numel() / 1e9:.2f}, EF slots {slots.numel() * 4 / 1e9:.2f}"
            f", row_ids {row_ids.numel() * 4 / 1e9:.2f}) beside the shard's "
            f"own tables; host bytes: the {S} x {shard.nq} x {shard.p.k} "
            f"rows of the host-merge check only "
            f"({S * shard.nq * shard.p.k * 8 / 1e6:.1f} MB); built in "
            f"{sync_time(torch, t0):.1f} s")

    def kernel_parity(self, s):
        """The path's kernels on mesh shard ``s``'s own tensors (its PQ
        codes, EF slots at the shard's universe, uint8 vectors) against
        their plain versions (``hop_parity``)."""
        shard, index = self.shard, self.index
        t0 = time.time()
        cases = hop_parity(self.parity, f"mesh shard {s}", index.pq_codes[s],
                           shard.luts(), index.ef_slots[s], index.vectors[s],
                           shard.queries, self.p, shard.R, self.per)
        log(f"mesh parity: on shard {s}'s own tensors {cases} bit-exact "
            f"against their plain versions ({time.time() - t0:.1f} s)")

    def run(self) -> dict:
        from repro_torch.core.distributed.sharded_index import (
            make_mesh, make_sharded_search, merge_comm_rows, merge_sharded,
            shard_topk)
        from repro_torch.kernels import build
        torch, shard, S = self.torch, self.shard, self.S
        self.build()
        self.kernel_parity(S - 1)
        index, p, k = self.index, self.p, self.p.k
        q = shard.queries
        mesh = make_mesh((S,), device=shard.dev)
        build.reset_launches()
        t0 = sync_time(torch)
        gids, d = shard_topk(index, q, p)
        wall_local = sync_time(torch, t0)
        per_shard = dict(build.LAUNCHES)
        check(all(per_shard[x] >= S for x in
                  ("beam_step", "pq_adc_batched", "rerank_loop"))
              and lists_decoded(per_shard) >= S,
              f"the {S} shard searches launched {per_shard}")
        cand_i = gids.permute(1, 0, 2).reshape(len(q), -1).cpu().numpy()
        cand_d = d.permute(1, 0, 2).reshape(len(q), -1).cpu().numpy()
        want = lex_merge_host(cand_i, cand_d, k)
        rows, walls = {}, {}
        for merge in ("hier", "flat"):
            run = make_sharded_search(mesh, p, merge=merge)
            build.reset_launches()
            t0 = sync_time(torch)
            ids, dists = run(index, q)
            walls[merge] = sync_time(torch, t0)
            check(dict(build.LAUNCHES) == per_shard,
                  f"{merge} merge: launches {dict(build.LAUNCHES)} != the "
                  f"{S} shard searches' {per_shard}")
            rows[merge] = (ids.cpu().numpy(), dists.cpu().numpy())
        (hi, hd), (fi, fd) = rows["hier"], rows["flat"]
        check(np.array_equal(hi, fi)
              and np.array_equal(hd.view(np.int32), fd.view(np.int32)),
              "mesh: hierarchical and flat merges differ")
        check(np.array_equal(hi, want[0])
              and np.array_equal(hd.view(np.int32), want[1].view(np.int32)),
              "mesh: merged rows != a host merge of the 32 shards' rows")
        check(bool((hi >= 0).all()) and int(hi.max()) < shard.n,
              f"mesh: an id outside [0, {shard.n}) surfaced "
              f"(max {int(hi.max())})")
        merge_ms = {m: cuda_ms(torch, lambda m=m: merge_sharded(
            gids, d, mesh, k, m)) for m in ("hier", "flat")}
        comm = {m: merge_comm_rows(k, [S], m) for m in ("hier", "flat")}
        log(f"mesh: {len(q)} queries over {S} shards (production SearchParams, "
            f"universe {self.per}); the {S} shard searches {wall_local:.3f} "
            f"s, launches {per_shard} ({per_shard['beam_step'] / S:.1f} "
            f"beam_step a shard); hierarchical merge ({int(np.log2(S))} "
            f"butterfly steps, merge_comm_rows {comm['hier']} a query) wall "
            f"{walls['hier']:.3f} s, merge alone {merge_ms['hier']:.4f} ms "
            f"device; flat merge (one {comm['flat']}-row gather) wall "
            f"{walls['flat']:.3f} s, merge alone {merge_ms['flat']:.4f} ms "
            f"device; hier == flat bit for bit == a host (distance, id) "
            f"merge of the {S} shards' rows; no id at or past {shard.n}, no "
            f"pad row")
        launches = dict(per_shard)
        add_launches(launches, per_shard)
        add_launches(launches, per_shard)
        add_launches(launches, self.routed())
        self.index = None
        return launches

    def routed(self) -> dict:
        """Routing at 1.0 and 0.5 through build_router(c=4) on the small
        world's 32-shard stack (n=1200, cluster partition), card against
        the CPU. build_router's host k-means is linear in rows: timed here
        on the first 2,048 rows of each mesh shard, the mesh's own rows
        would take far past what the run can spend on it."""
        from repro_torch.core.distributed.sharded_index import (
            ShardedIndex, ShardRouter, build_router, build_sharded_index,
            make_mesh, make_sharded_search, route_mask)
        from repro_torch.core.search.beam import SearchParams
        from repro_torch.data.synthetic import (make_queries,
                                                make_vector_dataset)
        from repro_torch.kernels import build
        torch, S, dev, index = self.torch, self.S, self.shard.dev, self.index
        cut = index._replace(vectors=index.vectors[:, :self.ROUTER_ROWS],
                             row_ids=index.row_ids[:, :self.ROUTER_ROWS])
        t0 = time.perf_counter()
        build_router(cut, c=4, seed=self.seed)
        t_cut = time.perf_counter() - t0
        log(f"mesh routing: build_router on the first {self.ROUTER_ROWS} "
            f"rows of each of the {S} shards took {t_cut:.2f} s (host "
            f"k-means, linear in rows), so the {self.per} rows a shard would "
            f"take ~{t_cut * self.per / self.ROUTER_ROWS:.0f} s: routing "
            f"runs on the small world's {S}-shard stack")
        vecs = make_vector_dataset("prop-like", n=1200, dim=32,
                                   seed=self.seed).astype(np.float32)
        on_cpu, per = build_sharded_index(vecs, S, r=24, l_build=48, pq_m=8,
                                          seed=self.seed, partition="cluster",
                                          device="cpu")
        t0 = time.perf_counter()
        cpu_router = build_router(on_cpu, c=4, seed=self.seed)
        t_router = time.perf_counter() - t0
        p = SearchParams(l_size=48, beam_width=4, k=10, rerank_batch=10,
                         r_max=24, universe=per, max_iters=128)
        on_card = ShardedIndex(*(t.to(dev) for t in on_cpu))
        router = ShardRouter(cpu_router.centroids.to(dev))
        q = torch.from_numpy(make_queries("prop-like", 32, 32).astype(
            np.float32)).to(dev)
        mesh, cpu_mesh = make_mesh((S,), device=dev), make_mesh(
            (S,), device="cpu")
        ids, d = make_sharded_search(mesh, p)(on_card, q)
        unrouted = (ids.cpu().numpy(), d.cpu().numpy())
        rids = on_cpu.row_ids.numpy()
        shard_of = np.full(int(rids.max()) + 1, -1)
        for s, row in enumerate(rids):
            shard_of[row[row >= 0]] = s
        launches, parts = {}, []
        for frac in (1.0, 0.5):
            run = make_sharded_search(mesh, p, router=router,
                                      route_frac=frac)
            build.reset_launches()
            t0 = sync_time(torch)
            ids, d = run(on_card, q)
            wall = sync_time(torch, t0)
            add_launches(launches, dict(build.LAUNCHES))
            ids, d = ids.cpu().numpy(), d.cpu().numpy()
            if frac == 1.0:
                check(np.array_equal(ids, unrouted[0])
                      and np.array_equal(d.view(np.int32),
                                         unrouted[1].view(np.int32)),
                      "routing at 1.0 != the unrouted search")
            else:
                mask = route_mask(router.centroids, q, frac).cpu().numpy()
                live = ids >= 0
                owner = shard_of[np.where(live, ids, 0)]
                check(bool(mask[np.nonzero(live)[0], owner[live]].all()),
                      "routing at 0.5: an id from a shard its query was not "
                      "routed to")
            want = make_sharded_search(cpu_mesh, p, router=cpu_router,
                                       route_frac=frac)(on_cpu, q.cpu())
            check(np.array_equal(ids, want[0].numpy())
                  and np.array_equal(d.view(np.int32),
                                     want[1].numpy().view(np.int32)),
                  f"routing at {frac}: card != CPU")
            parts.append(f"route_frac {frac}: wall {wall:.3f} s, "
                         f"{int((ids >= 0).sum())} ids")
        log(f"mesh routing on the small world's stack (build_router c=4 "
            f"over its 1,200 rows {t_router:.3f} s): " + "; ".join(parts)
            + "; 1.0 == unrouted bit for bit; at 0.5 every id lies in one "
            f"of its query's routed shards; card == CPU; launches {launches}")
        return launches


# -------------------------------------------------------------- admission
class Admission:
    """Phase 4f: the admission queue (serve/admission.py) over a
    BatchedSearcher on the resident shard, configured as phase 4c's
    (buckets (8, 32, 1024), LRU of 0.1% of n x dim) with per-tenant LRU
    partitions on a shared budget; three tenants weighted 0.6/0.3/0.1,
    a token bucket on the hottest. A seeded Poisson and a seeded bursty
    trace of 4,096 requests drawn from phase 4's queries (with repeats)
    at 0.8 of the modeled capacity."""

    N_REQ, MAX_BATCH = 4096, 1024
    TENANTS, WEIGHTS = ("hot", "warm", "cold"), (0.6, 0.3, 0.1)

    def __init__(self, torch, shard, args):
        self.torch, self.shard, self.seed = torch, shard, args.seed

    def searcher(self):
        from repro_torch.configs.decouplevs_ann import CONFIG
        from repro_torch.serve.ann import BatchedSearcher, ServeConfig
        shard = self.shard
        return BatchedSearcher(shard.index, shard.p, ServeConfig(
            buckets=(8, 32, 1024), shared_budget=True,
            cache_bytes=int(CONFIG.cache_ratio * shard.n * shard.D)))

    def traces(self, model):
        from repro_torch.serve.admission import bursty_trace, poisson_trace
        s_max = model.service_us(self.MAX_BATCH)
        rate = 0.8 * self.MAX_BATCH / s_max * 1e6
        q = self.shard.queries.cpu().numpy()
        # slack 2 to 3 full batches' service: a queue that fills before
        # its oldest request's slack runs out cuts full, one that does not
        # cuts on the deadline; the bursty trace's ON phases (0.2 of a
        # period of 4 full services, 4x the rate) fill it, the rest not
        kw = dict(n=self.N_REQ, tenants=self.TENANTS, weights=self.WEIGHTS,
                  deadline_us=2.0 * s_max, deadline_jitter_us=1.0 * s_max)
        return rate, {
            "poisson": poisson_trace(q, rate, seed=self.seed, **kw),
            "bursty": bursty_trace(q, rate, burst_factor=4.0, duty=0.2,
                                   period_us=4.0 * s_max,
                                   seed=self.seed + 1, **kw)}

    def queue(self, model, rate):
        from repro_torch.serve.admission import (AdmissionConfig,
                                                 AdmissionQueue, TenantConfig)
        return AdmissionQueue(
            self.searcher(), model, AdmissionConfig(max_batch=self.MAX_BATCH),
            tenants={"hot": TenantConfig(rate_qps=self.hot_qps(rate),
                                         burst=16)})

    def hot_qps(self, rate):
        """The hottest tenant's bucket refills at 1.1x its mean rate:
        bursts defer its requests, its long-run traffic is never starved."""
        return 1.1 * self.WEIGHTS[0] * rate

    def run(self) -> dict:
        from repro_torch.kernels import build
        from repro_torch.serve.admission import calibrate_service_model
        torch, shard = self.torch, self.shard
        want_ids = shard.result[0].cpu().numpy()
        want_d = shard.result[1].cpu().view(torch.int32).numpy()
        nq = len(want_ids)
        t0 = time.perf_counter()
        model = calibrate_service_model(self.searcher(),
                                        shard.queries[:32].cpu().numpy())
        t_cal = time.perf_counter() - t0
        rate, traces = self.traces(model)
        q0 = traces["poisson"][0].query
        log(f"admission: card bytes: none beyond the resident shard and "
            f"each batch's queries; host bytes: {len(traces)} traces of "
            f"{self.N_REQ} requests, each holding a {q0.nbytes} B query "
            f"copy ({len(traces) * self.N_REQ * q0.nbytes / 1e6:.1f} MB), "
            f"and each batch's ids and distances copied once")
        log(f"admission: ServiceModel from 32 of phase 4's queries: "
            f"{model.per_query_us} us a query + {model.base_us} us a cut, so "
            f"a batch of {self.MAX_BATCH} is served in "
            f"{model.service_us(self.MAX_BATCH):.0f} modeled us; offered "
            f"rate 0.8 of the modeled capacity = {rate:.3f} qps; deadlines "
            f"arrival + U[2, 3] full-batch services; hot tenant bucket "
            f"{self.hot_qps(rate):.3f} qps, burst 16; calibrated in "
            f"{t_cal:.2f} s")
        launches, reasons, deferred = {}, set(), 0
        for name, trace in traces.items():
            q = self.queue(model, rate)
            build.reset_launches()
            with self.profiled(name == "poisson") as prof:
                t0 = sync_time(torch)
                served, rep = q.run(trace)
                wall = sync_time(torch, t0)
            t_checks = time.perf_counter()
            add_launches(launches, dict(build.LAUNCHES))
            check(sorted(s.rid for s in served) == list(range(self.N_REQ)),
                  f"admission ({name}): not every request served once")
            for s in served:
                row = s.rid % nq
                check(np.array_equal(s.ids, want_ids[row])
                      and np.array_equal(s.dists.view(np.int32),
                                         want_d[row]),
                      f"admission ({name}): rid {s.rid} != phase 4's row")
                check(s.snapshot_version
                      == rep.batches[s.batch_idx].snapshot_version,
                      f"admission ({name}): a batch spans two snapshots")
            self.conservation(name, q, served)
            by = {}
            for r in rep.batches:
                by[r.reason] = by.get(r.reason, 0) + 1
            reasons |= set(by)
            late = sum(s.admit_us > s.arrival_us for s in served)
            deferred += late
            met = 1 - rep.deadline_misses / len(served)
            lat = rep.latency
            searched = sum(r.report.wall_s for r in rep.batches)
            log(f"admission ({name}): {len(rep.batches)} batches {by}, "
                f"sizes {[r.n for r in rep.batches]}; {late} grants "
                f"deferred; deadline met {met:.4f}; modeled p50 "
                f"{lat['p50']:.1f} p95 {lat['p95']:.1f} p99 {lat['p99']:.1f}"
                f" us, makespan {rep.makespan_us:.1f} us, modeled QPS "
                f"{rep.qps:.3f}; host wall of the queue run {wall:.3f} s "
                f"({'profiled; ' if prof is not None else ''}of which the "
                f"searcher's own batches {searched:.3f} s: search and "
                f"fetch-trace replay); every row == phase 4's fused search "
                f"bit for bit, "
                f"one snapshot a batch; launches {dict(build.LAUNCHES)}")
            if prof is not None:
                device_busy(torch, prof, f"admission queue ({name})", None,
                            wall)
            log(f"admission ({name}): the gates"
                f"{' and the profile' if prof is not None else ''} took "
                f"{time.perf_counter() - t_checks:.2f} s")
        check(reasons >= {"full", "deadline", "drain"},
              f"admission: cut reasons {reasons}, not all three")
        check(deferred > 0, "admission: no grant was deferred")
        return launches

    def conservation(self, name, q, served):
        """Grants in any window <= rate * dt + burst, per tenant; each
        tenant's grants equal its served requests."""
        for tenant, bucket in q.buckets.items():
            log_us = np.asarray(bucket.grant_log_us)
            check(bucket.granted == sum(s.tenant == tenant for s in served),
                  f"admission ({name}): tenant {tenant} grants != served")
            if math.isinf(bucket.rate_qps) or not len(log_us):
                continue
            for i in range(len(log_us)):
                n_win = np.arange(1, len(log_us) - i)
                dt = log_us[i + 1:] - log_us[i]
                check(bool((n_win <= bucket.rate_qps * dt / 1e6
                            + bucket.burst + 1e-3).all()),
                      f"admission ({name}): tenant {tenant} over its bucket")

    @staticmethod
    @contextlib.contextmanager
    def profiled(on: bool):
        """torch.profiler around the block when ``on`` (the card's busy
        share of that queue run: device events only, so a run of ~5,000
        hops leaves no host-op trace to process), else nothing."""
        if not on:
            yield None
            return
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            yield prof


# -------------------------------------------------------------------- live
def host_rss() -> int:
    """This process's resident host memory, in bytes."""
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmRSS:"):
                return int(ln.split()[1]) * 1024
    return 0


def host_ram() -> int:
    """The host memory this process may use: the cgroup's limit where one
    is set, else the machine's."""
    phys = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    cap = Path("/sys/fs/cgroup/memory.max")
    if cap.exists() and cap.read_text().strip().isdigit():
        return min(phys, int(cap.read_text()))
    return phys


class PeakRSS:
    """The peak of ``host_rss`` over a ``with`` block, sampled every
    20 ms by a thread that the block's end stops."""

    def __enter__(self):
        self.base = self.peak = host_rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, host_rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, host_rss())


def medoid_of(torch, vectors, chunk: int) -> int:
    """The row nearest the mean of ``vectors`` (uint8 rows, read in
    chunks so the float temporaries stay small)."""
    n, dim = vectors.shape
    mean = torch.zeros(dim, dtype=torch.float64, device=vectors.device)
    for a in range(0, n, chunk):
        mean += vectors[a:a + chunk].double().sum(0)
    mean = (mean / n).float()
    best = []
    for a in range(0, n, chunk):
        d = ((vectors[a:a + chunk].float() - mean) ** 2).sum(1)
        v, i = d.min(0)
        best.append((float(v), a + int(i)))
    return min(best)[1]


class Live:
    """Phase 4d: the §3.5 update path on the card — a StreamingIndex over
    ``--live-n`` sift-like uint8 vectors (the shard's distribution and
    record width: same seed) in the decoupled vector store, the random
    R=128 graph at that n and the shard's PQ codebook, served through
    BatchedSearcher before and after deletes + inserts, and after a merge.
    The build measures the index's host and card bytes a vertex, which
    bound n (printed beside the ``reduced:`` line)."""

    def __init__(self, torch, shard, parity, args):
        self.torch, self.seed, self.dev = torch, args.seed, shard.dev
        self.n, self.parity = args.live_n, parity
        self.R, self.D = shard.R, shard.D
        self.centroids, self.queries = shard.centroids, shard.queries

    def build(self):
        from repro_torch.configs.decouplevs_ann import CONFIG
        from repro_torch.core.graph.pq import PQCodebook, encode_pq_torch
        from repro_torch.core.storage.vector_store import (
            DecoupledVectorStore, StoreConfig)
        from repro_torch.core.update.fresh import StreamingIndex, UpdateConfig
        from repro_torch.data.synthetic import sift_like_torch
        torch, dev, n = self.torch, self.dev, self.n
        t0 = time.time()
        x = sift_like_torch(n, self.D, self.seed, dev)
        vs = DecoupledVectorStore(StoreConfig(
            dim=self.D, dtype=torch.uint8, chunk_bytes=CONFIG.chunk_bytes,
            segment_capacity=CONFIG.segment_bytes // self.D, device=dev))
        vs.append(torch.arange(n, device=dev), x)
        vs.seal_active()
        cb = PQCodebook(self.centroids.cpu().numpy(), self.D)
        codes = encode_pq_torch(x, self.centroids).cpu().numpy()
        medoid = medoid_of(torch, x, 1 << 20)
        del x
        torch.cuda.synchronize()
        t_data = time.time() - t0
        # from here on, what the index itself takes: its host graph, its
        # index store and its device view
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        card0 = torch.cuda.memory_allocated()
        t0 = time.time()
        with PeakRSS() as rss:
            chunk = 1 << 20
            adj = np.empty((n, self.R), np.int64)
            for a in range(0, n, chunk):
                b = min(a + chunk, n)
                adj[a:b] = random_graph_rows(torch, n, self.R, self.seed, a,
                                             b, dev, chunk).cpu().numpy()
            self.idx = StreamingIndex(list(adj), medoid, vs, codes, cb,
                                      UpdateConfig(r=self.R, l_build=64,
                                                   merge_threshold=1 << 30,
                                                   device=dev))
            del adj
            held = host_rss()
        t_idx = time.time() - t0
        self.card0 = card0
        self.sizing = dict(
            host_held=(held - rss.base) / n, host_peak=(rss.peak - rss.base) / n,
            card_held=(torch.cuda.memory_allocated() - card0) / n,
            card_build=(torch.cuda.max_memory_allocated() - card0) / n,
            t_build=t_idx)
        store = self.idx.handle.current().index_store
        log(f"live: {n} x {self.D} sift-like uint8 vectors sealed into "
            f"{len(vs.sealed)} segment(s), random R={self.R} graph, the "
            f"shard's PQ codebook (M={cb.n_subspaces}), medoid {medoid}; "
            f"index store {store.n_blocks} blocks, EF universe "
            f"{store.universe}; data {t_data:.1f} s, StreamingIndex (host "
            f"graph + index store + device view) {t_idx:.1f} s = "
            f"{1e6 * t_idx / n:.2f} us a vertex")

    def log_sizing(self, t_merge):
        """What bounds n: the index's bytes a vertex on the host and on the
        card (held, and at the build's and the merge's peaks: a publish
        holds the pinned snapshot's device view and the new one), and its
        seconds, each projected to the full shard."""
        torch, n, sz = self.torch, self.n, self.sizing
        ram = host_ram()
        card = torch.cuda.get_device_properties(0).total_memory
        card_peak = max(sz["card_build"], sz["card_merge"])
        fits = int((card - self.card0) / card_peak)
        log(f"live sizing: the index takes {sz['host_held']:.0f} B a vertex "
            f"on the host ({sz['host_peak']:.0f} B at its build's peak) "
            f"and {sz['card_held']:.0f} B on the card ({sz['card_build']:.0f}"
            f" B at the build's peak, {sz['card_merge']:.0f} B at the "
            f"merge's); host RAM {ram / 2**30:.1f} GiB, card "
            f"{card / 2**30:.1f} GiB ({self.card0 / 2**30:.1f} GiB held by "
            f"earlier phases); at {SHARD_N} vertices it would peak at "
            f"{sz['host_peak'] * SHARD_N / 2**30:.1f} GiB on the host and "
            f"{card_peak * SHARD_N / 2**30:.1f} GiB on the card, so the card "
            f"holds at most {fits} vertices at these peaks; the build "
            f"would take {sz['t_build'] * SHARD_N / n:.0f} s (linear in n; "
            f"this merge took {t_merge:.1f} s)")
        if n < SHARD_N:
            log(f"reduced: live n={n} < {SHARD_N} (set by --live-n: the "
                f"card holds at most {fits} vertices at the measured peak "
                f"of {card_peak:.0f} B a vertex, per the live sizing line; "
                f"n is {100 * n / fits:.0f}% of that, headroom for the "
                f"allocator)")

    def serve(self, searcher, q, tag):
        from repro_torch.kernels import build
        torch = self.torch
        build.reset_launches()
        t0 = sync_time(torch)
        ids, dists, rep = searcher.search(q)
        wall = sync_time(torch, t0)
        launched = dict(build.LAUNCHES)
        log(f"live serve ({tag}): {len(q)} queries, version "
            f"{rep.snapshot_version}, memtable rows {rep.mem_candidates}, "
            f"wall {wall:.3f} s; {report_line(rep)}; launches {launched}")
        return ids, rep, launched

    def kernel_parity(self, p, q, mem_ids):
        """The live path's kernels on the live view's own tensors (its
        codes, EF slots at the view's universe, float32 rows) against their
        plain versions (``hop_parity``), and the memtable lane (rerank_l2
        by id, every query reading every buffered row). Then the memtable
        side-scan on the card against the same scan on the CPU, on the
        same snapshot."""
        from repro_torch.core.graph.pq import build_lut_torch
        from repro_torch.core.update.consistency import memtable_topk
        torch, par = self.torch, self.parity
        snap = self.idx.handle.current()
        view, universe = snap.device, snap.index_store.universe
        nq = len(q)
        qt = torch.from_numpy(q).to(self.dev)
        cases = hop_parity(par, "live", view.pq_codes,
                           build_lut_torch(qt, view.pq_centroids),
                           view.ef_slots, view.vectors, qt, p, self.R,
                           universe)
        mem = torch.from_numpy(np.stack(
            [snap.mem_rows[int(i)] for i in mem_ids])).to(self.dev)
        every = torch.arange(len(mem), dtype=torch.int32, device=self.dev)
        par.compare("rerank_l2", f"live memtable {nq}x{len(mem)} by id",
                    qt, mem, every.expand(nq, -1).contiguous())
        got = memtable_topk(snap, q, p.k)
        want = memtable_topk(snap, q, p.k, device="cpu")
        check(np.array_equal(got[0], want[0])
              and np.array_equal(got[1].view(np.int32),
                                 want[1].view(np.int32)),
              "memtable side-scan: card != CPU")
        log(f"live parity: {cases} and the memtable lane ({nq}x{len(mem)} "
            f"by id) on the live view bit-exact; the memtable side-scan on "
            f"the card == on the CPU (ids, dists)")

    def run(self) -> dict:
        from repro_torch.core.search.beam import SearchParams
        from repro_torch.kernels import build
        from repro_torch.serve.ann import BatchedSearcher, ServeConfig
        torch, n = self.torch, self.n
        torch.cuda.empty_cache()
        self.build()
        idx = self.idx
        q = self.queries[:256].cpu().numpy()     # phase 4's first queries
        # the update tier's own search parameters, so the served ids can
        # be held against idx.search_batch
        p = SearchParams(l_size=200, k=10, benefit_threshold=0.0)
        searcher = BatchedSearcher(idx.handle, p,
                                   ServeConfig(buckets=(8, 32, 256)))
        total = {}
        ids0, rep0, l0 = self.serve(searcher, q, "before updates")
        add_launches(total, l0)
        top1 = list(dict.fromkeys(ids0[:, 0].tolist()))
        check(len(top1) >= 64, f"only {len(top1)} distinct top-1 hits")
        dead = top1[:64]
        fresh = np.arange(n, n + 64)
        idx.delete(dead)
        idx.insert(fresh, q[:64])    # integral values: uint8 records hold
        ids1, rep1, l1 = self.serve(searcher, q, "deletes + inserts buffered")
        add_launches(total, l1)
        check(not np.isin(ids1, dead).any(), "a deleted id surfaced")
        check(all(fresh[i] in ids1[i] for i in range(64)),
              "a fresh id was not found through the memtable lane")
        check(rep1.snapshot_version == rep0.snapshot_version
              and rep1.mem_candidates == 64, "the snapshot moved before "
              "the merge")
        check(l1["rerank_l2"] == l0["rerank_l2"] + 1,
              "the memtable lane is not one rerank_l2 launch")
        self.kernel_parity(p, q, fresh)
        build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = sync_time(torch)
        st = idx.merge()
        t_merge = sync_time(torch, t0)
        self.sizing["card_merge"] = (torch.cuda.max_memory_allocated()
                                     - self.card0) / n
        add_launches(total, dict(build.LAUNCHES))
        store = idx.handle.current().index_store
        log(f"live merge: {t_merge:.2f} s; MergeStats: "
            f"deleted {st.deleted}, inserted {st.inserted}, dirty vertices "
            f"{st.dirty_vertices}, blocks rewritten {st.blocks_rewritten} + "
            f"appended {st.blocks_appended} of {st.total_blocks}, write "
            f"{st.write_bytes} B, full rebuild {st.full_rebuild}; write "
            f"amplification {st.write_bytes / store.physical_bytes:.4f} of a "
            f"full rebuild ({store.physical_bytes} B), "
            f"{st.write_bytes / (st.deleted + st.inserted):.0f} B an update;"
            f" modeled cost {st.modeled_cost_us:.1f} us; launches "
            f"{dict(build.LAUNCHES)}")
        ids2, rep2, l2 = self.serve(searcher, q, "after the merge")
        add_launches(total, l2)
        check(rep2.snapshot_version == rep0.snapshot_version + 1
              and rep2.mem_candidates == 0, "the merge did not publish")
        check(not np.isin(ids2, dead).any(), "a deleted id surfaced")
        found = sum(fresh[i] in ids2[i] for i in range(64))
        check(found > 0, "no fresh id is served from the graph")
        linked = sum(any(v in idx.adjacency[int(u)] for u in idx.adjacency[v])
                     for v in fresh)
        want, _ = idx.search_batch(q, k=10, l_size=200)
        check(np.array_equal(ids2, want), "served ids != idx.search_batch's")
        log(f"live: after the merge {found} of 64 fresh ids served from the "
            f"graph ({linked} of 64 kept a back-edge from one of their "
            f"out-neighbours); served ids == idx.search_batch's; no deleted "
            f"id surfaced in any serve")
        self.log_sizing(t_merge)
        for name in ("beam_step", "pq_adc_batched", "rerank_loop",
                     "rerank_l2", "huffman_decode"):
            check(total[name] > 0, f"{name} never launched on the live path")
        check(lists_decoded(total) > 0, "no EF list decoded on the live path")
        self.idx = None
        return total


# ---------------------------------------------------------------------- lm
LM_ARCH = "internlm2-1.8b"
LM_PARAMS = 1_889_110_016       # the reference's count for LM_ARCH
RAG_DOCS = 4096                 # phase 6's corpus (drawn as the launcher's)
#: Phase 6's tolerances, from what an H100 measured (PERF.md §6). The
#: float32 ones are about 10x the readings: a float32 decode step against a
#: float32 prefill over the same tokens (1.06e-05), a float32 prefill on
#: the card against the host CPU's (9.3e-06), and the reduced float32 archs
#: card against CPU (9.1e-06; tests/test_torch_cuda.py holds the same).
#: The bfloat16 one sits between a sound decode (0.082 from the prefill)
#: and a decode into the prefill's own slots, which overwrites token 0
#: (0.375 off): about 1.8x the first, 0.4x the second.
LM_F32_ATOL = 1e-4
LM_BF16_ATOL = 0.15
LM_CARD_CPU_ATOL = 1e-4
LM_REDUCED_ATOL = 1e-4


def max_gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


class LMServe:
    """Phase 6: the LM serving path (models/*, serve/engine.py,
    serve/rag.py) on the card, after the shard and the live index are
    freed. Every reduced arch card == CPU; internlm2-1.8b at full width in
    bf16 serving the launcher's smoke traffic and a 4,096-token batch; the
    decode-versus-prefill and card-versus-CPU gates; RAG over the model's
    embeddings through BatchedSearcher, its kernels held against their
    plain versions on the RAG index's own tensors."""

    def __init__(self, torch, parity, args, smi):
        self.torch, self.parity, self.seed = torch, parity, args.seed
        self.smi = smi
        self.dev = torch.device("cuda")

    def run(self) -> dict:
        torch = self.torch
        torch.cuda.empty_cache()
        log(f"lm: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated on "
            f"the card at the phase's start; float32 matmuls without TF32 "
            f"(allow_tf32 False), so the float32 attention runs on the CUDA "
            f"cores")
        self.reduced_archs()
        from repro_torch.configs import get_config
        from repro_torch.models.api import Model
        from repro_torch.serve.engine import ServeEngine
        model = Model.from_config(get_config(LM_ARCH))
        check(model.n_params() == LM_PARAMS,
              f"{LM_ARCH}: {model.n_params()} params != {LM_PARAMS}")
        t0 = sync_time(torch)
        params = model.init(self.seed)
        log(f"lm: {LM_ARCH} at full width ({model.cfg.n_layers} layers, d "
            f"{model.cfg.d_model}, {model.cfg.n_heads}/{model.cfg.n_kv_heads}"
            f" heads, hd {model.cfg.head_dim}, d_ff {model.cfg.d_ff}, V "
            f"{model.cfg.vocab}, {model.cfg.dtype}): {model.n_params():,} "
            f"params, {torch.cuda.memory_allocated() / 1e9:.2f} GB, drawn on "
            f"the card from seed {self.seed} in {sync_time(torch, t0):.1f} s")
        engine = ServeEngine(model, params)
        self.serve(engine, 8, 32, 16, "smoke traffic (the launcher's)")
        self.big_batch(engine)
        self.gates(model, params)
        launches = self.rag(engine)
        del engine, params
        torch.cuda.empty_cache()
        return launches

    # -- every arch, reduced
    def reduced_archs(self):
        from repro_torch.configs import ARCHS, get_config, reduce_config
        from repro_torch.data.synthetic import make_token_batch
        from repro_torch.models.api import Model
        from repro_torch.models.schema import tree_map
        from repro_torch.serve.engine import ServeEngine
        torch = self.torch
        t0, errs, ties = time.perf_counter(), {}, {}
        for arch in sorted(ARCHS):
            model = Model.from_config(reduce_config(get_config(arch)))
            cpu = model.init(self.seed, device="cpu")
            card = tree_map(lambda t: t.to(self.dev), cpu)
            toks = make_token_batch(model.cfg.vocab, 2, 16, seed=1)
            frames = np.random.default_rng(1).normal(
                size=(2, 8, model.cfg.frontend_dim)).astype(np.float32) \
                if model.cfg.encoder_layers else None
            batch = {"tokens": torch.from_numpy(toks).long()}
            if frames is not None:
                batch["frames"] = torch.from_numpy(frames)
            with torch.no_grad():
                want, _ = model.prefill(cpu, batch, attn_mode="dense")
                got, _ = model.prefill(
                    card, {k: v.to(self.dev) for k, v in batch.items()},
                    attn_mode="dense")
            errs[arch] = max_gap(got.cpu(), want)
            check(errs[arch] <= LM_REDUCED_ATOL,
                  f"{arch} reduced: card prefill {errs[arch]:.3e} from the "
                  f"CPU's")
            gen = ServeEngine(model, card).generate(toks, max_new=4,
                                                    frontend=frames)
            ties[arch] = float(ServeEngine(model, cpu, device="cpu")
                               .greedy_margins(toks, gen, frames).max())
            check(ties[arch] <= LM_REDUCED_ATOL, f"{arch} reduced: a card "
                  f"greedy token {ties[arch]:.3e} below the CPU's best")
        log(f"lm reduced: all {len(errs)} archs (reduce_config, float32, "
            f"prefill 2x16 + 4 greedy decode steps) card == CPU: prefill "
            f"logits within {max(errs.values()):.3e} (atol "
            f"{LM_REDUCED_ATOL}; by arch "
            f"{ {a: float(f'{e:.2e}') for a, e in errs.items()} }), greedy "
            f"tokens the CPU's (largest accepted margin "
            f"{max(ties.values()):.2e}) in {time.perf_counter() - t0:.1f} s")

    # -- full width: traffic
    def prefill(self, engine, toks):
        """One prefill of ``toks`` [B, S] (no decode cache widened)."""
        torch = self.torch
        batch = {"tokens": torch.as_tensor(toks, device=self.dev).long()}
        with torch.no_grad():
            engine.model.prefill(engine.params, batch, attn_mode="dense")

    def serve(self, engine, b, s, new, what):
        """``b`` requests of ``s`` prompt tokens and ``new`` greedy tokens:
        the prefill alone, then ``engine.generate``; the decode's time is
        the difference. Then 16 decode steps after such a prefill,
        profiled."""
        from repro_torch.data.synthetic import make_token_batch
        torch = self.torch
        toks = make_token_batch(engine.model.cfg.vocab, b, s, seed=self.seed)
        engine.generate(toks[:, :8], max_new=2)        # warm-up
        torch.cuda.reset_peak_memory_stats()
        t0 = sync_time(torch)
        self.prefill(engine, toks)
        t_pre = sync_time(torch, t0)
        t0 = sync_time(torch)
        out = engine.generate(toks, max_new=new)
        wall = sync_time(torch, t0)
        t_dec = max(wall - t_pre, 0.0) / new
        peak = torch.cuda.max_memory_allocated()
        check(out.shape == (b, new) and ((out >= 0) &
              (out < engine.model.cfg.vocab)).all(), f"{what}: bad tokens")
        log(f"lm serve ({what}): {b} requests x {s} prompt tokens x {new} "
            f"new, greedy: prefill {t_pre * 1e3:.1f} ms "
            f"({b * s / t_pre:.0f} tokens/s), decode {t_dec * 1e3:.2f} ms a "
            f"step ({b / t_dec:.1f} tokens/s), generate wall {wall:.3f} s; "
            f"peak max_memory_allocated {peak / 1e9:.2f} GB; {self.card()}")
        self.profile_decode(engine, b, s)
        return out

    def card(self) -> str:
        return f"card {self.smi}"

    def big_batch(self, engine):
        """The prefill_32k / decode_32k cells cut to one card and the run's
        time: 4,096 prompt tokens, 128 new, the batch sized from the peak
        memory of a 2-request prefill."""
        torch = self.torch
        from repro_torch.data.synthetic import make_token_batch
        s, new, want_b = 4096, 128, 16
        toks = make_token_batch(engine.model.cfg.vocab, 2, s, seed=self.seed)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        self.prefill(engine, toks)
        per_req = (torch.cuda.max_memory_allocated() - base) / 2
        total = torch.cuda.get_device_properties(0).total_memory
        fit = int((0.85 * total - base) // per_req)
        b = max(1, min(want_b, fit))
        log(f"lm sizing: a 2 x {s} prefill peaks {per_req / 1e9:.2f} GB a "
            f"request above {base / 1e9:.2f} GB of params; {fit} requests "
            f"fit in 85% of {total / 1e9:.1f} GB -> batch {b}")
        log(f"reduced: lm prefill_32k/decode_32k cut to {b} requests x {s} "
            f"prompt tokens x {new} new (cells: 32 x 32,768 prefill, 128 x "
            f"32,768 decode) for one card and the run's time")
        if b < want_b:
            log(f"reduced: lm batch {b} < {want_b} (card memory)")
        self.serve(engine, b, s, new, f"{b} x {s}")
        self.profile_decode(engine, b, 32)     # the same batch, short context

    def profile_decode(self, engine, b, s):
        """The card's busy share of 16 decode steps after a prefill of
        ``b`` x ``s`` tokens, profiled."""
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.data.synthetic import make_token_batch
        from repro_torch.serve.engine import widen_cache
        torch, model, params = self.torch, engine.model, engine.params
        toks = torch.from_numpy(make_token_batch(model.cfg.vocab, b, s,
                                                 seed=self.seed)).to(self.dev)
        with torch.no_grad():
            logits, cache = model.prefill(params, {"tokens": toks.long()},
                                          attn_mode="dense")
            cache = widen_cache(model, cache, b, s + 16)
            tok = logits[:, -1].argmax(-1)
            pos = torch.full((b,), s, dtype=torch.long, device=self.dev)

            def steps():
                nonlocal cache, tok, pos
                for _ in range(16):
                    logits, cache = model.decode_step(params, cache,
                                                      tok[:, None], pos)
                    tok, pos = logits[:, -1].argmax(-1), pos + 1
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = sync_time(torch)
                steps()
                wall = sync_time(torch, t0)
        device_busy(torch, prof, f"16 decode steps after {b} x {s} "
                    f"prompt tokens, {LM_ARCH}", None, wall)

    # -- full width: gates
    def gates(self, model, params):
        """Gate 1: each of 8 decode steps equals a prefill over the extended
        sequence (4 prompts of 32 tokens), in float32 and in bfloat16; a
        decode into the prefill's own 32 slots (the reference's engine) is
        printed beside it. Gate 2: a float32 prefill of 2 x 32 on the card
        equals the same prefill on the host CPU."""
        from repro_torch.data.synthetic import make_token_batch
        from repro_torch.models.schema import tree_map
        from repro_torch.serve.engine import widen_cache
        torch = self.torch
        ext = torch.from_numpy(make_token_batch(model.cfg.vocab, 4, 40,
                                                seed=self.seed + 1)
                               ).long().to(self.dev)
        f32 = tree_map(lambda t: t.float(), params)
        f32_model = type(model).from_config(
            dataclasses.replace(model.cfg, dtype="float32"))
        gaps = {}
        with torch.no_grad():
            for name, m, p in (("float32", f32_model, f32),
                               ("bfloat16", model, params)):
                _, cache = m.prefill(p, {"tokens": ext[:, :32]},
                                     attn_mode="dense")
                narrow = cache
                cache = widen_cache(m, cache, 4, 40)
                pos = torch.full((4,), 32, dtype=torch.long, device=self.dev)
                worst = 0.0
                for i in range(8):
                    tok = ext[:, 32 + i:33 + i]
                    got, cache = m.decode_step(p, cache, tok, pos)
                    want, _ = m.prefill(p, {"tokens": ext[:, :33 + i]},
                                        attn_mode="dense")
                    worst = max(worst, max_gap(got, want))
                    if i == 0:
                        faulty = max_gap(m.decode_step(p, narrow, tok,
                                                       pos)[0], want)
                    pos = pos + 1
                gaps[name] = (worst, faulty)
            check(gaps["float32"][0] <= LM_F32_ATOL,
                  f"float32 decode {gaps['float32'][0]:.3e} from the prefill")
            check(gaps["bfloat16"][0] <= LM_BF16_ATOL,
                  f"bfloat16 decode {gaps['bfloat16'][0]:.3e} from the "
                  f"prefill")
            two = {"tokens": ext[:2, :32]}
            on_card, _ = f32_model.prefill(f32, two, attn_mode="dense")
            t0 = time.perf_counter()
            host = tree_map(lambda t: t.cpu(), f32)
            on_cpu, _ = f32_model.prefill(
                host, {"tokens": two["tokens"].cpu()}, attn_mode="dense")
            t_cpu = time.perf_counter() - t0
            card_cpu = max_gap(on_card.cpu(), on_cpu)
            check(card_cpu <= LM_CARD_CPU_ATOL,
                  f"float32 prefill: card {card_cpu:.3e} from the CPU")
        del f32, host
        torch.cuda.empty_cache()
        log(f"lm gates ({LM_ARCH}, full width): decode vs a prefill over the "
            f"extended sequence, 4 x 32 prompt + 8 steps: float32 max "
            f"{gaps['float32'][0]:.3e} (atol {LM_F32_ATOL}), bfloat16 max "
            f"{gaps['bfloat16'][0]:.3e} (atol {LM_BF16_ATOL}); a decode into "
            f"the prefill's own 32 slots (token 0 overwritten) is "
            f"{gaps['float32'][1]:.3e} / {gaps['bfloat16'][1]:.3e} off; "
            f"float32 prefill 2 x 32 card vs host CPU max {card_cpu:.3e} "
            f"(atol {LM_CARD_CPU_ATOL}; the CPU's copy + prefill "
            f"{t_cpu:.1f} s)")

    # -- RAG
    def rag(self, engine) -> dict:
        from repro_torch.core.graph.pq import build_lut_torch
        from repro_torch.core.search.beam import DeviceIndex
        from repro_torch.data.synthetic import make_token_batch
        from repro_torch.kernels import build
        from repro_torch.serve.ann import BatchedSearcher
        from repro_torch.serve.rag import RAGPipeline, embed_tokens
        torch, par = self.torch, self.parity
        vocab = engine.model.cfg.vocab
        docs = make_token_batch(vocab, RAG_DOCS, 12, seed=3)
        t0 = time.perf_counter()
        rag = RAGPipeline(engine, doc_tokens=docs, k=2, batch=64)
        t_build = time.perf_counter() - t0
        idx, p = rag.index, rag.searcher.p
        vs, ix = rag.vector_store, rag.index_store
        log(f"rag build: {RAG_DOCS} docs embedded from {LM_ARCH}'s "
            f"[{vocab}, {engine.model.cfg.d_model}] table in {t_build:.1f} s "
            f"({ {k: round(v, 2) for k, v in rag.build_s.items()} } s); "
            f"vector store {vs.physical_bytes} B physical of "
            f"{vs.logical_bytes} logical, index store "
            f"{ix.physical_bytes} B; float32 rows of d "
            f"{idx.vectors.shape[1]}, PQ M={idx.pq_codes.shape[1]} K=256, "
            f"R={p.r_max} EF slots at U={p.universe}")
        queries = make_token_batch(vocab, 64, 8, seed=11)
        q = torch.from_numpy(embed_tokens(engine.params, queries)).to(self.dev)
        cases = hop_parity(par, "rag", idx.pq_codes,
                           build_lut_torch(q, idx.pq_centroids), idx.ef_slots,
                           idx.vectors, q, p, p.r_max, p.universe)
        log(f"rag parity: {cases} on the RAG index's own tensors bit-exact "
            f"against their plain versions")
        t0 = sync_time(torch)
        ids, stats = rag.retrieve(queries)
        t_ret = sync_time(torch, t0)
        build.reset_launches()
        t0 = sync_time(torch)
        gen, st = rag.answer(queries, max_new=16)
        t_ans = sync_time(torch, t0)
        launches = dict(build.LAUNCHES)
        for op in ("beam_step", "pq_adc_batched", "rerank_loop"):
            check(launches.get(op, 0) > 0,
                  f"{op} never launched by RAG retrieval ({launches})")
        check(lists_decoded(launches) > 0,
              f"RAG retrieval decoded no EF list ({launches})")
        check(np.array_equal(st["retrieved"], ids), "rag: answer's ids != "
              "retrieve's")
        on_cpu = DeviceIndex(*(None if t is None else t.cpu() for t in idx))
        cpu = BatchedSearcher(on_cpu, rag.searcher.p, rag.searcher.cfg,
                              device="cpu")
        # the same two searches on the CPU: the first (retrieve's) finds the
        # LRU cold, the second (answer's) warm
        q_host = embed_tokens(engine.params, queries)
        for label, rep in (("retrieve", stats["report"]),
                           ("answer", st["report"])):
            c_ids, _, c_rep = cpu.search(q_host)
            c_ids = np.where(c_ids >= 0, c_ids, 0)[:, :2]
            check(np.array_equal(ids, c_ids), f"rag ({label}): card ids != "
                  f"CPU's")
            for f in ("n_queries", "n_padded", "buckets", "graph_ios",
                      "vector_ios", "cache_hits", "pq_ops", "exact_ops",
                      "decompressions", "io_rounds", "rerank_batches"):
                check(getattr(rep, f) == getattr(c_rep, f),
                      f"rag ({label}) BatchReport.{f}: card "
                      f"{getattr(rep, f)} != CPU {getattr(c_rep, f)}")
        rep = stats["report"]
        check(gen.shape == (64, 16) and ((gen >= 0) & (gen < vocab)).all(),
              "rag: bad tokens")
        log(f"rag serve: 64 requests of 8 query tokens, k=2, 16 new tokens "
            f"(prompt 32 tokens); retrieval ids and the integer BatchReport "
            f"fields == a CPU BatchedSearcher's on the same index; retrieve "
            f"wall {t_ret:.3f} s ({len(queries) / t_ret:.1f} QPS with "
            f"embedding; searcher {rep.wall_s:.4f} s, {rep.qps:.1f} QPS), "
            f"modeled latency {rep.modeled_latency_us:.1f} us (p99 "
            f"{rep.modeled_p99_us:.1f}), graph_ios {rep.graph_ios}, "
            f"vector_ios {rep.vector_ios}, cache hits {rep.cache_hits}; "
            f"answer wall {t_ans:.3f} s, generation {t_ans - t_ret:.3f} s, "
            f"retrieval {100 * t_ret / t_ans:.1f}% of answer's wall; "
            f"launches {launches}; {self.card()}")
        return launches


# -------------------------------------------------------------------- train
TRAIN_STEPS = 8                 # phase 7's full-width steps
TRAIN_B, TRAIN_S = 8, 128       # launch/train.py's default traffic
TRAIN_4K = 4096                 # configs/shapes.py train_4k: seq 4,096
TRAIN_4K_GLOBAL = 256           # and global batch 256
#: Phase 7's bounds. Card against CPU, reduced archs in float32 (no TF32):
#: the loss, and every gradient leaf within this fraction of the CPU
#: leaf's largest magnitude (tests/test_torch_cuda.py holds the same).
TRAIN_REDUCED_ATOL = 1e-4
TRAIN_REDUCED_REL = 1e-4
#: bfloat16 against float32 on the bf16-rounded params, one 8 x 128 batch:
#: the loss and the global grad norm, relative; about 10x what an H100
#: measured (5.6e-05 and 1.1e-03, PERF.md §6).
TRAIN_BF16_LOSS_REL = 1e-3
TRAIN_BF16_GNORM_REL = 1e-2
#: remat modes and the chunked loss against plain autograd with full
#: logits (one batch): the loss relative (float32 sums in another order
#: where the loss is chunked; remat alone recomputes the same kernels),
#: the grad norm relative (bf16 gradients from another op order).
TRAIN_REMAT_LOSS_REL = 1e-5
TRAIN_REMAT_GNORM_REL = 1e-3
#: The 100m preset's restart: the reference's own restart tolerance.
TRAIN_RESTART_RTOL = 1e-4
CKPT_CUT_S = 120                # a full-state round trip slower: cut it


def leaf_gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


class LMTrain:
    """Phase 7: the LM training path (models' losses and remat,
    optim/adamw.py, train/trainer.py, data/pipeline.py, ft/*,
    launch/train.py) on the card, after phase 6's model is freed. Every
    reduced arch card == CPU; internlm2-1.8b at full width in bf16 trained
    on launch/train.py's traffic; remat and the chunked loss; the train_4k
    shape cut to the card; checkpoint and restart; the launcher."""

    def __init__(self, torch, args, smi):
        self.torch, self.seed, self.smi = torch, args.seed, smi
        self.dev = torch.device("cuda")
        self.first_steps = []       # (loss, master leaves on the host)
        self.step_s = None          # the warm full-width step (median)

    def card(self) -> str:
        return f"card {self.smi}"

    def run(self) -> None:
        torch = self.torch
        torch.cuda.empty_cache()
        log(f"train: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
            f"on the card at the phase's start; no kernel of kernels/csrc "
            f"is on the training path (autograd over plain torch)")
        self.reduced_archs()                                       # (a)
        from repro_torch.configs import get_config
        from repro_torch.models.api import Model
        model = Model.from_config(get_config(LM_ARCH))
        check(model.n_params() == LM_PARAMS,
              f"{LM_ARCH}: {model.n_params()} params != {LM_PARAMS}")
        params, opt = self.full_width(model)                       # (b)
        self.checkpoint_full(model, params, opt)                   # (e)
        del opt
        torch.cuda.empty_cache()
        self.bf16_gate(model, params)                              # (b)
        self.remat_modes(model, params)                            # (c)
        self.train_4k(model, params)                               # (d)
        del params
        torch.cuda.empty_cache()
        self.restart_100m()                                        # (e)
        self.launcher()                                            # (f)

    # -- (a) every arch, reduced
    def reduced_archs(self):
        from repro_torch.configs import ARCHS, get_config, reduce_config
        from repro_torch.data.synthetic import make_token_batch
        from repro_torch.models.api import Model
        from repro_torch.models.schema import tree_leaves, tree_map
        from repro_torch.optim.adamw import AdamWConfig, init_opt_state
        from repro_torch.train.trainer import TrainConfig, make_train_step
        torch = self.torch
        t0, worst = time.perf_counter(), {}
        for arch in sorted(ARCHS):
            model = Model.from_config(reduce_config(get_config(arch)))
            cpu = model.init(self.seed, device="cpu")
            card = tree_map(lambda t: t.to(self.dev), cpu)
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
            on_card = {k: v.to(self.dev) for k, v in batch.items()}
            want, wg = self.loss_and_grads(model, cpu, batch)
            got, gg = self.loss_and_grads(model, card, on_card)
            loss_gap = abs(float(got) - float(want))
            rel = max(leaf_gap(a, b.cpu()) / max(float(a.abs().max()), 1e-30)
                      for a, b in zip(tree_leaves(wg), tree_leaves(gg)))
            step = make_train_step(model, AdamWConfig(), TrainConfig(
                remat=None, attn_mode="dense", warmup=0))
            p_cpu, s_cpu = cpu, init_opt_state(cpu)
            p_card, s_card = card, init_opt_state(card)
            for _ in range(2):      # step 0's rate is 0: the second moves
                p_cpu, s_cpu, _ = step(p_cpu, s_cpu, batch)
                p_card, s_card, _ = step(p_card, s_card, on_card)
            p_gap = max(leaf_gap(a, b.cpu()) for a, b in
                        zip(tree_leaves(p_cpu), tree_leaves(p_card)))
            worst[arch] = (loss_gap, rel, p_gap)
            check(loss_gap <= TRAIN_REDUCED_ATOL and
                  rel <= TRAIN_REDUCED_REL and p_gap <= TRAIN_REDUCED_ATOL,
                  f"{arch} reduced training: card vs CPU loss {loss_gap:.3e}"
                  f", grad leaf {rel:.3e} of its max, params {p_gap:.3e}")
        log(f"train reduced: all {len(worst)} archs (reduce_config, float32,"
            f" batch 2 x 16, dense attention) card == CPU: loss within "
            f"{max(w[0] for w in worst.values()):.3e} (atol "
            f"{TRAIN_REDUCED_ATOL}), every gradient leaf within "
            f"{max(w[1] for w in worst.values()):.3e} of its largest "
            f"magnitude (bound {TRAIN_REDUCED_REL}), params after 2 "
            f"make_train_step steps within "
            f"{max(w[2] for w in worst.values()):.3e} (atol "
            f"{TRAIN_REDUCED_ATOL}); by arch (loss, grad, params) "
            f"{ {a: tuple(float(f'{x:.2e}') for x in w) for a, w in worst.items()} }"
            f" in {time.perf_counter() - t0:.1f} s")

    def loss_and_grads(self, model, params, batch, **kw):
        from repro_torch.train.trainer import value_and_grad
        kw.setdefault("attn_mode", "dense")
        return value_and_grad(lambda p, b: model.loss(p, b, **kw), params,
                              batch)

    # -- (b) full width
    def resident(self, model) -> str:
        n = model.n_params()
        return (f"resident: params {2 * n / 1e9:.2f} GB bf16, gradients "
                f"{2 * n / 1e9:.2f} GB, fp32 master + m + v "
                f"{12 * n / 1e9:.2f} GB (total {16 * n / 1e9:.2f} GB before "
                f"activations)")

    def full_width(self, model):
        from repro_torch.data.pipeline import TokenPipeline
        from repro_torch.models.schema import tree_leaves
        from repro_torch.optim.adamw import AdamWConfig, init_opt_state
        from repro_torch.train.trainer import (TrainConfig, TrainLoop,
                                               batch_to, make_train_step)
        torch = self.torch
        t0 = sync_time(torch)
        params = model.init(self.seed)
        init = params                     # step 0 returns new params
        opt = init_opt_state(params)
        log(f"train: {LM_ARCH} at full width ({model.n_params():,} params, "
            f"{model.cfg.dtype}) and its AdamW state on the card in "
            f"{sync_time(torch, t0):.1f} s; {self.resident(model)}; "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        pipe = TokenPipeline(vocab=model.cfg.vocab, global_batch=TRAIN_B,
                             seq_len=TRAIN_S, seed=self.seed)
        tcfg = TrainConfig(attn_mode="dense", remat=None,
                           total_steps=TRAIN_STEPS)
        gate = {}

        def step0(step, p, o, h):
            if step < MESH_STEPS:       # phase 8b's reference: host copies
                self.first_steps.append((h["loss"], [
                    w.to("cpu", copy=True) for w in tree_leaves(o["master"])]))
            if step:
                return
            gate["master"] = all(torch.equal(w, q.float()) for w, q in zip(
                tree_leaves(o["master"]), tree_leaves(init)))
            gate["m"] = min(float(m.abs().max()) for m in tree_leaves(o["m"]))
            gate["v"] = min(float(v.abs().max()) for v in tree_leaves(o["v"]))

        torch.cuda.reset_peak_memory_stats()
        loop = TrainLoop(model, AdamWConfig(), tcfg)
        params, opt, hist = loop.run(
            params, (pipe.batch_at(s) for s in range(TRAIN_STEPS)),
            opt_state=opt, hooks=[step0])
        peak = torch.cuda.max_memory_allocated()
        del init
        losses = [h["loss"] for h in hist]
        check(all(math.isfinite(x) for x in losses),
              f"full-width training: a loss is not finite: {losses}")
        check(gate["master"] and gate["m"] > 0 and gate["v"] > 0,
              f"step 0 (warmup_cosine = 0): master unchanged "
              f"{gate['master']}, smallest leaf max |m| {gate['m']:.3e}, "
              f"|v| {gate['v']:.3e}")
        secs = sorted(h["sec"] for h in hist[2:])
        med = secs[len(secs) // 2] if len(secs) % 2 else \
            (secs[len(secs) // 2 - 1] + secs[len(secs) // 2]) / 2
        self.step_s = med
        log(f"train full width: {TRAIN_STEPS} AdamW steps of {TRAIN_B} x "
            f"{TRAIN_S} tokens (launch/train.py's traffic, TokenPipeline "
            f"seed {self.seed}, AdamWConfig() defaults, dense attention, "
            f"no remat): losses {[round(x, 4) for x in losses]}, grad norms "
            f"{[round(h['grad_norm'], 3) for h in hist]}; step 0 left the "
            f"master bit-equal to the initial params upcast with m and v "
            f"nonzero in every leaf; step {med * 1e3:.1f} ms (median of "
            f"steps 2..{TRAIN_STEPS - 1}; all {[round(h['sec'] * 1e3, 1) for h in hist]}"
            f" ms), {TRAIN_B * TRAIN_S / med:.0f} tokens/s; peak "
            f"max_memory_allocated {peak / 1e9:.2f} GB; {self.card()}")
        # the card's busy share of 4 more steps, profiled
        from torch.profiler import ProfilerActivity, profile
        step = make_train_step(model, AdamWConfig(), tcfg)
        batches = [batch_to(pipe.batch_at(TRAIN_STEPS + i), self.dev)
                   for i in range(4)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = sync_time(torch)
            for b in batches:
                params, opt, _ = step(params, opt, b)
            wall = sync_time(torch, t0)
        device_busy(torch, prof, f"4 training steps of {TRAIN_B} x "
                    f"{TRAIN_S}, {LM_ARCH} bf16", None, wall)
        # a step's two halves, each timed warm (the second of two calls),
        # the update at the schedule's rate as make_train_step's
        from repro_torch.optim.adamw import adamw_update
        from repro_torch.optim.schedule import warmup_cosine
        for _ in range(2):
            t0 = sync_time(torch)
            _, grads = self.loss_and_grads(model, params, batches[0])
            t_fb = sync_time(torch, t0)
            t0 = sync_time(torch)
            params, opt, _ = adamw_update(
                grads, opt, AdamWConfig(), model_dtype=torch.bfloat16,
                lr_scale=warmup_cosine(opt["step"], warmup=tcfg.warmup,
                                       total=tcfg.total_steps))
            t_opt = sync_time(torch, t0)
            del grads
        n = model.n_params()
        bound = 28 * n / HBM_BYTES_PER_S     # read g, m, v, w; write all
        log(f"train step halves ({TRAIN_B} x {TRAIN_S}, warm): forward + "
            f"backward {t_fb * 1e3:.1f} ms; adamw_update {t_opt * 1e3:.1f} "
            f"ms against {bound * 1e3:.1f} ms for one pass that reads the "
            f"bf16 gradients and the fp32 m, v and master and writes them "
            f"and the bf16 params ({28 * n / 1e9:.1f} GB)")
        return params, opt

    def bf16_gate(self, model, params):
        """One batch's loss and global grad norm in bf16 against the same
        in float32 on the bf16-rounded params."""
        from repro_torch.data.pipeline import TokenPipeline
        from repro_torch.models.schema import tree_map
        from repro_torch.optim.adamw import global_norm
        from repro_torch.train.trainer import batch_to
        torch = self.torch
        batch = batch_to(TokenPipeline(vocab=model.cfg.vocab,
                                       global_batch=TRAIN_B, seq_len=TRAIN_S,
                                       seed=self.seed).batch_at(0), self.dev)
        loss, grads = self.loss_and_grads(model, params, batch)
        gnorm = float(global_norm(grads))
        del grads
        f32 = tree_map(lambda t: t.float(), params)
        f32_model = type(model).from_config(
            dataclasses.replace(model.cfg, dtype="float32"))
        loss32, grads32 = self.loss_and_grads(f32_model, f32, batch)
        gnorm32 = float(global_norm(grads32))
        del grads32, f32
        torch.cuda.empty_cache()
        lrel = abs(float(loss) - float(loss32)) / abs(float(loss32))
        grel = abs(gnorm - gnorm32) / gnorm32
        check(lrel <= TRAIN_BF16_LOSS_REL and grel <= TRAIN_BF16_GNORM_REL,
              f"bf16 vs float32 training loss {lrel:.3e}, grad norm "
              f"{grel:.3e}")
        log(f"train gate ({LM_ARCH}, one {TRAIN_B} x {TRAIN_S} batch): bf16 "
            f"loss {float(loss):.6f} vs float32 on the bf16-rounded params "
            f"{float(loss32):.6f} ({lrel:.3e} relative, bound "
            f"{TRAIN_BF16_LOSS_REL}); global grad norm {gnorm:.5f} vs "
            f"{gnorm32:.5f} ({grel:.3e}, bound {TRAIN_BF16_GNORM_REL})")

    # -- (c) remat and the chunked loss
    def remat_modes(self, model, params, b=4, s=1024):
        from repro_torch.data.pipeline import TokenPipeline
        from repro_torch.optim.adamw import global_norm
        from repro_torch.train.trainer import batch_to
        torch = self.torch
        batch = batch_to(TokenPipeline(vocab=model.cfg.vocab, global_batch=b,
                                       seq_len=s, seed=self.seed
                                       ).batch_at(1), self.dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        res = {}
        for remat in (None, "full", "dots"):
            for chunk in (None, 1024):
                torch.cuda.reset_peak_memory_stats()
                t0 = sync_time(torch)
                loss, grads = self.loss_and_grads(
                    model, params, batch, remat=remat, loss_chunk=chunk)
                gn = float(global_norm(grads))
                wall = sync_time(torch, t0)
                res[(remat, chunk)] = (float(loss), gn,
                                       torch.cuda.max_memory_allocated()
                                       - base, wall)
                del grads
        l0, g0 = res[(None, None)][:2]
        worst_l = max(abs(r[0] - l0) / abs(l0) for r in res.values())
        worst_g = max(abs(r[1] - g0) / g0 for r in res.values())
        remat_bits = all(res[(r, c)][:2] == res[(None, c)][:2]
                         for r in ("full", "dots") for c in (None, 1024))
        check(worst_l <= TRAIN_REMAT_LOSS_REL and
              worst_g <= TRAIN_REMAT_GNORM_REL,
              f"remat / loss_chunk: loss {worst_l:.3e}, grad norm "
              f"{worst_g:.3e} from plain autograd")
        log(f"train remat ({LM_ARCH} full width, one {b} x {s} batch, "
            f"params resident): every remat None/full/dots x loss_chunk "
            f"None/1024 gives the loss within {worst_l:.3e} (bound "
            f"{TRAIN_REMAT_LOSS_REL}) and the grad norm within {worst_g:.3e}"
            f" (bound {TRAIN_REMAT_GNORM_REL}) of plain autograd; remat "
            f"alone bit-equal (loss, norm): {remat_bits}; peak above the "
            f"params by mode (GB, s): "
            + "; ".join(f"remat={r} chunk={c}: loss {v[0]:.6f} norm "
                        f"{v[1]:.5f} peak {v[2] / 1e9:.2f} GB {v[3]:.2f} s"
                        for (r, c), v in res.items()))

    # -- (d) train_4k, cut
    def train_4k(self, model, params):
        from repro_torch.data.pipeline import TokenPipeline
        from repro_torch.optim.adamw import AdamWConfig, init_opt_state
        from repro_torch.train.trainer import (TrainConfig, batch_to,
                                               make_train_step)
        torch = self.torch
        s = TRAIN_4K
        opt = init_opt_state(params)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        peaks = {}
        for b in (1, 2):            # the activations' peak a sequence
            batch = batch_to(TokenPipeline(vocab=model.cfg.vocab,
                                           global_batch=b, seq_len=s,
                                           seed=self.seed).batch_at(0),
                             self.dev)
            torch.cuda.reset_peak_memory_stats()
            loss, grads = self.loss_and_grads(model, params, batch,
                                              remat="full", loss_chunk=1024)
            del grads
            peaks[b] = torch.cuda.max_memory_allocated() - base
        per = max(peaks[2] - peaks[1], 1)
        fixed = peaks[1] - per
        # the step also holds an fp32 accumulator of the gradients
        acc = 4 * model.n_params()
        total = torch.cuda.get_device_properties(0).total_memory
        # 75%: the allocator's free blocks between sizes (~11 GB at 90%,
        # where a microbatch of 11 ran out of memory) need the rest
        fit = int((0.75 * total - base - acc - fixed) // per)
        mb_b = max(1, min(fit, TRAIN_4K_GLOBAL // 2))
        log(f"train_4k sizing: remat full, loss_chunk 1024, a {s}-token "
            f"sequence adds {per / 1e9:.2f} GB (batch 1 peaks "
            f"{peaks[1] / 1e9:.2f} GB, batch 2 {peaks[2] / 1e9:.2f} GB above "
            f"{base / 1e9:.2f} GB of params + AdamW state); with the "
            f"{acc / 1e9:.2f} GB fp32 gradient accumulator {fit} fit in 75% "
            f"of {total / 1e9:.1f} GB -> microbatch {mb_b}")
        log(f"reduced: train_4k global batch {TRAIN_4K_GLOBAL} -> "
            f"{2 * mb_b} (2 microbatches of {mb_b} x {s}, one card)")
        tcfg = TrainConfig(microbatches=2, remat="full", loss_chunk=1024,
                           attn_mode="dense")
        step = make_train_step(model, AdamWConfig(), tcfg)
        batch = batch_to(TokenPipeline(vocab=model.cfg.vocab,
                                       global_batch=2 * mb_b, seq_len=s,
                                       seed=self.seed).batch_at(0), self.dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = sync_time(torch)
        params2, opt, metrics = step(params, opt, batch)
        wall = sync_time(torch, t0)
        peak = torch.cuda.max_memory_allocated()
        loss = float(metrics["loss"])
        check(math.isfinite(loss), f"train_4k: loss {loss}")
        log(f"train_4k: one step of 2 x {mb_b} x {s} tokens (remat full, "
            f"loss_chunk 1024, dense attention, fp32 accumulation): loss "
            f"{loss:.4f}, grad norm {float(metrics['grad_norm']):.4f}, step "
            f"{wall:.2f} s (first call), {2 * mb_b * s / wall:.0f} tokens/s,"
            f" peak max_memory_allocated {peak / 1e9:.2f} GB; {self.card()}")
        del params2, opt, batch
        torch.cuda.empty_cache()

    # -- (e) checkpoint and restart
    def ckpt_dir(self, name) -> Path:
        d = ROOT / "build" / "chip_smoke_ckpt" / name
        import shutil
        shutil.rmtree(d, ignore_errors=True)
        return d

    def checkpoint_full(self, model, params, opt):
        """The whole training state at full width saved and restored onto
        the card, bit for bit, bf16 kept; cut to the params when the disk
        cannot hold the state or the round trip is too slow."""
        import shutil
        from repro_torch.ft.checkpoint import (restore_checkpoint,
                                               save_checkpoint)
        from repro_torch.models.schema import tree_leaves
        torch = self.torch
        d = self.ckpt_dir("full")
        d.parent.mkdir(parents=True, exist_ok=True)
        state_bytes = sum(t.numel() * t.element_size() for t in
                          tree_leaves({"params": params, "opt": opt}))
        free = shutil.disk_usage(d.parent).free
        what = {"params": params, "opt": opt}
        if free < 1.5 * state_bytes:
            what = {"params": params}
            log(f"reduced: checkpoint round trip cut to the params "
                f"({free / 1e9:.1f} GB free on disk for "
                f"{state_bytes / 1e9:.2f} GB of state)")
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(what))
        t0 = sync_time(torch)
        save_checkpoint(d, TRAIN_STEPS + 4, what.get("params"),
                        what.get("opt"))
        t_save = sync_time(torch, t0)
        t0 = sync_time(torch)
        back, manifest = restore_checkpoint(d, what)
        t_load = sync_time(torch, t0)
        same = all(a.dtype == b.dtype and a.device == b.device and
                   torch.equal(a, b) for a, b in
                   zip(tree_leaves(back), tree_leaves(what)))
        check(same and manifest["step"] == TRAIN_STEPS + 4,
              "full-width checkpoint round trip is not bit-exact")
        on_disk = sum(f.stat().st_size for f in d.rglob("*") if f.is_file())
        del back
        shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()
        log(f"train checkpoint (full width, {'params + AdamW state' if 'opt' in what else 'params'}"
            f", {nbytes / 1e9:.2f} GB, {on_disk / 1e9:.2f} GB on disk): save "
            f"{t_save:.1f} s, restore onto the card {t_load:.1f} s; every "
            f"leaf bit-equal, bf16 params restored as bf16")
        if "opt" in what and t_save + t_load > CKPT_CUT_S:
            log(f"train checkpoint: the round trip took over {CKPT_CUT_S} s; "
                f"cut it to the params in the next run")

    def restart_100m(self):
        """2 steps + checkpoint + restore + 2 steps equal 4 uninterrupted
        steps, on the 100m preset on the card."""
        from repro_torch.configs import preset_config
        from repro_torch.data.pipeline import TokenPipeline
        from repro_torch.ft.checkpoint import (restore_checkpoint,
                                               save_checkpoint)
        from repro_torch.models.api import Model
        from repro_torch.models.schema import tree_leaves
        from repro_torch.optim.adamw import AdamWConfig, init_opt_state
        from repro_torch.train.trainer import TrainConfig, TrainLoop
        torch = self.torch
        model = Model.from_config(preset_config(LM_ARCH, "100m"))
        pipe = TokenPipeline(vocab=model.cfg.vocab, global_batch=8,
                             seq_len=256, seed=self.seed)
        tcfg = TrainConfig(remat=None, attn_mode="dense", warmup=1,
                           total_steps=4)

        def run(n, params, opt, start=0):
            return TrainLoop(model, AdamWConfig(lr=1e-3), tcfg).run(
                params, [pipe.batch_at(s) for s in range(start, start + n)],
                opt_state=opt, start_step=start)

        p0 = model.init(self.seed)
        full_p, _, full = run(4, p0, init_opt_state(p0))
        p1 = model.init(self.seed)
        p1, o1, first = run(2, p1, init_opt_state(p1))
        d = self.ckpt_dir("100m")
        save_checkpoint(d, 2, p1, o1)
        back, _ = restore_checkpoint(d, {"params": p1, "opt": o1})
        res_p, _, second = run(2, back["params"], back["opt"], start=2)
        got = [h["loss"] for h in first + second]
        want = [h["loss"] for h in full]
        err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        bits = got == want
        p_gap = max(leaf_gap(a, b) for a, b in zip(tree_leaves(res_p),
                                                   tree_leaves(full_p)))
        check(err <= TRAIN_RESTART_RTOL, f"100m restart: losses {got} vs "
              f"uninterrupted {want}")
        import shutil
        shutil.rmtree(d, ignore_errors=True)
        log(f"train restart ({model.cfg.name}, {model.n_params():,} params, "
            f"{model.cfg.dtype}, 8 x 256, lr 1e-3): 2 steps + checkpoint + "
            f"restore + 2 steps, losses {[round(x, 6) for x in got]} vs 4 "
            f"uninterrupted {[round(x, 6) for x in want]}: max relative "
            f"{err:.3e} (rtol {TRAIN_RESTART_RTOL}); losses bit-equal "
            f"{bits}; final params max gap {p_gap:.3e} (0: bit-equal)")

    # -- (f) the launcher
    def launcher(self):
        d = self.ckpt_dir("launcher")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                LM_ARCH, "--preset", "smoke", "--batch", "2", "--seq", "64",
                "--ckpt-dir", str(d)]
        t0 = time.perf_counter()
        outs = []
        for steps, every in ((6, 3), (8, 100)):
            proc = subprocess.run(base + ["--steps", str(steps),
                                          "--ckpt-every", str(every)],
                                  capture_output=True, text=True, env=env,
                                  cwd=str(ROOT), timeout=300)
            check(proc.returncode == 0, f"launch.train --steps {steps}: "
                  f"{proc.stderr[-2000:]}")
            outs.append(proc.stdout)
        wall = time.perf_counter() - t0
        check("done: loss" in outs[0] and (d / "step_00000003").exists(),
              f"launch.train: {outs[0][-500:]}")
        check("restored checkpoint at step 6" in outs[1] and
              f"device={self.torch.cuda.get_device_name(0)}" in outs[1],
              f"launch.train restart: {outs[1][-500:]}")
        import shutil
        shutil.rmtree(d, ignore_errors=True)
        done = [ln for o in outs for ln in o.splitlines()
                if ln.startswith(("done:", "restored", "mesh="))]
        log(f"train launcher: python -m repro_torch.launch.train --arch "
            f"{LM_ARCH} --preset smoke --steps 6 --batch 2 --seq 64 "
            f"--ckpt-every 3, then --steps 8 (a restart), on the card, two "
            f"subprocesses in {wall:.1f} s: {done}")


# -------------------------------------------------------------------- mesh
MESH_STEPS = 2                  # phase 8b's steps under the mesh policy
MESH_BUDGET_S = 90              # phase 8's stated budget
MATMUL_N = 8192                 # 8a's bf16 yardstick: an N^3 matmul
READ_BYTES = 4 << 30            # 8a's read: 4 GiB
#: 8c's cell in a process of its own: phase 7's program (internlm2-1.8b,
#: 8 x 128, AdamWConfig(), dense attention, no remat) traced on the (1, 1)
#: mesh of a one-rank fake group; writes the cell's JSON into argv[1].
PHASE7_CELL = """
import sys
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.api import Model
from repro_torch.train.trainer import TrainConfig
dryrun.init_fake_world(1)
mesh = make_local_mesh(device_type="cpu")
model = Model.from_config(get_config(sys.argv[2]))
shape = ShapeSpec("phase7", int(sys.argv[4]), int(sys.argv[3]), "train")
cell = dryrun.lm_cell(model, shape, mesh,
                      dryrun._rules_for(model.cfg, shape, mesh),
                      tcfg=TrainConfig(attn_mode="dense", remat=None,
                                       total_steps=int(sys.argv[5])))
cell.update(arch=sys.argv[2], shape=shape.name, mesh="local1x1")
dryrun.write_cell(cell, sys.argv[1])
"""


class MeshPhase:
    """Phase 8: the mesh slice (launch/mesh.py, the sharding policy over a
    DeviceMesh, the trainer on DTensors) and the dry-run (launch/dryrun.py,
    launch/roofline.py, lower_production_search) after phase 7. The
    dry-run's cells trace on the host in processes of their own (a fake
    process group each, one core each), started with phase 8 and read
    after (8a) the card's bf16 matmul and read rates and (8b) phase 7's
    first steps again under the mesh policy on a one-rank NCCL group, bit
    for bit, which run while they trace."""

    def __init__(self, torch, args, smi):
        self.torch, self.seed, self.smi = torch, args.seed, smi
        self.dev = torch.device("cuda")
        self.out = ROOT / "build" / "dryrun_torch"
        self.procs, self.waiters, self.outs, self.walls = {}, {}, {}, {}

    def card(self) -> str:
        return f"card {self.smi}"

    def run(self, train: LMTrain) -> None:
        self.train = train
        self.start_dryruns()                                       # 8c, 8d
        rates = self.card_rates()                                  # 8a
        self.mesh_steps()                                          # 8b
        outs = {k: self.finish(k) for k in self.procs}
        self.roofline_vs_card(rates)                               # 8c
        self.production(outs)                                      # 8d

    # -- the dry-run processes
    def start_dryruns(self) -> None:
        import shutil
        shutil.rmtree(self.out, ignore_errors=True)
        self.out.mkdir(parents=True)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
        cmds = {
            "8c": [sys.executable, "-c", PHASE7_CELL, str(self.out), LM_ARCH,
                   str(TRAIN_B), str(TRAIN_S), str(TRAIN_STEPS)],
            "8d-ann": [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", "decouplevs-ann", "--both-meshes", "--out",
                       str(self.out)],
            "8d-lm": [sys.executable, "-m", "repro_torch.launch.dryrun",
                      "--arch", LM_ARCH, "--shape", "train_4k", "--out",
                      str(self.out)]}
        t0 = time.time()
        for k, c in cmds.items():
            self.procs[k] = subprocess.Popen(
                c, env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            self.waiters[k] = threading.Thread(target=self.wait,
                                               args=(k, t0), daemon=True)
            self.waiters[k].start()

    def wait(self, key, t0) -> None:
        """Reads a dry-run process to its end; its wall is its own."""
        self.outs[key] = self.procs[key].communicate()[0]
        self.walls[key] = time.time() - t0

    def stop(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def finish(self, key):
        proc = self.procs[key]
        self.waiters[key].join(timeout=600)
        if self.waiters[key].is_alive():
            proc.kill()
            self.waiters[key].join()
        out = self.outs[key]
        check(proc.returncode == 0, f"dry-run {key}: {out[-3000:]}")
        return out

    # -- 8a
    def card_rates(self):
        from repro_torch.launch.roofline import H100_DATASHEET, Rates
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(self.seed)
        a, b = (torch.randn((MATMUL_N, MATMUL_N), generator=g,
                            device=self.dev, dtype=torch.bfloat16)
                for _ in range(2))
        mm_ms = cuda_ms(torch, lambda: torch.matmul(a, b), reps=20)
        flops = 2 * MATMUL_N ** 3 / (mm_ms * 1e-3)
        del a, b
        x = torch.ones(READ_BYTES // 4, device=self.dev, dtype=torch.float32)
        rd_ms = cuda_ms(torch, lambda: x.sum(), reps=10)
        rate = READ_BYTES / (rd_ms * 1e-3)
        del x
        torch.cuda.empty_cache()
        rates = Rates(flops_per_s=flops, bytes_per_s=rate,
                      link_bytes_per_s=H100_DATASHEET.link_bytes_per_s,
                      source=f"measured on {self.smi}: bf16 matmul "
                             f"{MATMUL_N}^3, a {READ_BYTES >> 30} GiB read; "
                             f"NVLink the datasheet's")
        log(f"mesh 8a (rates): bf16 torch.matmul {MATMUL_N}^3 warm "
            f"{mm_ms:.4f} ms = {flops / 1e12:.1f} TFLOP/s (datasheet "
            f"{H100_DATASHEET.flops_per_s / 1e12:.0f}); one read of "
            f"{READ_BYTES >> 30} GiB (float32 sum) {rd_ms:.4f} ms = "
            f"{rate / 1e12:.3f} TB/s (datasheet "
            f"{H100_DATASHEET.bytes_per_s / 1e12:.2f}); NVLink "
            f"{rates.link_bytes_per_s / 1e9:.0f} GB/s a direction is the "
            f"datasheet's (one card); {self.card()}")
        return rates

    # -- 8b
    def mesh_steps(self):
        import socket
        import torch.distributed as dist
        from repro_torch.configs import get_config
        from repro_torch.data.pipeline import TokenPipeline
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import sharding
        from repro_torch.models.api import Model
        from repro_torch.models.schema import tree_leaves
        from repro_torch.optim.adamw import AdamWConfig, init_opt_state
        from repro_torch.train.trainer import TrainConfig, TrainLoop
        torch = self.torch
        check(len(self.train.first_steps) == MESH_STEPS,
              "phase 7 recorded no steps for phase 8b")
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
        try:
            mesh = make_local_mesh(device_type="cuda")
            model = Model.from_config(get_config(LM_ARCH))
            pipe = TokenPipeline(vocab=model.cfg.vocab, global_batch=TRAIN_B,
                                 seq_len=TRAIN_S, seed=self.seed)
            tcfg = TrainConfig(attn_mode="dense", remat=None,
                               total_steps=TRAIN_STEPS)
            same = []

            def compare(step, p, o, h):
                loss, master = self.train.first_steps[step]
                same.append(h["loss"] == loss and all(
                    torch.equal(w.to_local(), q.to(self.dev))
                    for w, q in zip(tree_leaves(o["master"]), master)))

            with sharding.policy(mesh):
                params = model.init(self.seed,
                                    shardings=model.param_shardings())
                placed = {str(tuple(t.placements))
                          for t in tree_leaves(params)}
                loop = TrainLoop(model, AdamWConfig(), tcfg)
                t0 = sync_time(torch)
                _, _, hist = loop.run(
                    params, (pipe.batch_at(s) for s in range(MESH_STEPS)),
                    opt_state=init_opt_state(params), hooks=[compare])
                wall = sync_time(torch, t0)
            del params, loop
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        check(len(same) == MESH_STEPS and all(same),
              f"mesh policy: steps under the (1, 1) mesh != phase 7's "
              f"unsharded steps: {same}")
        log(f"mesh 8b (policy on the card): {LM_ARCH} at full width "
            f"(bf16, {TRAIN_B} x {TRAIN_S}, AdamWConfig()) on a one-rank "
            f"NCCL group's {tuple(mesh.shape)} {mesh.mesh_dim_names} mesh, "
            f"params DTensors placed {sorted(placed)}: {MESH_STEPS} "
            f"TrainLoop steps under sharding.policy in {wall:.2f} s (steps "
            f"{[round(h['sec'] * 1e3, 1) for h in hist]} ms; phase 7's "
            f"warm step {self.train.step_s * 1e3:.1f} ms); the loss and "
            f"every fp32 master leaf after each step equal phase 7's "
            f"unsharded steps bit for bit; {self.card()}")

    # -- 8c
    def roofline_vs_card(self, rates):
        from repro_torch.launch import dryrun
        cell = json.loads((self.out / f"{LM_ARCH}__phase7__local1x1.json"
                           ).read_text())
        c = cell["counts"]
        card = dryrun.terms_of(c, rates)
        sheet = dryrun.terms_of(c)
        measured = self.train.step_s
        check(card.step_time_s <= measured,
              f"roofline: the bound {card.step_time_s * 1e3:.1f} ms of "
              f"phase 7's cell at the card's rates exceeds its measured "
              f"warm step {measured * 1e3:.1f} ms: the count is wrong")
        opt = c["by_scope"].get("optimizer", {})
        log(f"mesh 8c (roofline vs the card): phase 7's cell ({LM_ARCH}, "
            f"{TRAIN_B} x {TRAIN_S}, no remat, (1, 1) mesh) traced on meta "
            f"in {cell['trace_s']} s (a process of its own since phase 8's "
            f"start): "
            f"{c['flops']:.4e} FLOP, {c['bytes']:.4e} bytes accessed "
            f"(optimizer {opt.get('bytes', 0):.4e}), peak live "
            f"{c['peak_bytes'] / 1e9:.2f} GB, collectives "
            f"{c['coll_counts']}; at the card's rates compute "
            f"{card.compute_s * 1e3:.2f} ms, memory {card.memory_s * 1e3:.2f} "
            f"ms -> bound {card.step_time_s * 1e3:.2f} ms ({card.dominant}); "
            f"at the datasheet's {sheet.step_time_s * 1e3:.2f} ms; measured "
            f"warm step {measured * 1e3:.1f} ms: bound / measured "
            f"{card.step_time_s / measured:.3f}; model FLOPs ratio "
            f"{cell['roofline']['model_flops_ratio']:.3f}")

    # -- 8d
    def production(self, outs):
        for key, out in outs.items():
            if not key.startswith("8d"):
                continue
            log(f"mesh {key} (python -m repro_torch.launch.dryrun, "
                f"{self.walls[key]:.1f} s since phase 8's start): "
                + " | ".join(
                    ln for ln in out.splitlines()
                    if ln.startswith("[") and not ln.startswith("[rank")))
        for f in sorted(self.out.glob("decouplevs-ann__*.json")):
            c = json.loads(f.read_text())
            log(f"mesh 8d {c['mesh']}: {c['n_shards']} shards of "
                f"{c['per_shard']:,} vectors, per rank "
                f"{c['total_bytes'] / 1e9:.3f} GB ("
                + ", ".join(f"{k} {v['shape']} {v['dtype']}"
                            for k, v in c["tensors"].items())
                + f"), {c['slot_words']} slot words a vertex, merge "
                f"{c['merge']} {c['merge_comm_rows']} rows a query "
                f"({c['merge_cost_us']:.1f} us modeled); shape-only, no "
                f"trace: the traversal reads a flag each hop")
        c = json.loads((self.out / f"{LM_ARCH}__train_4k__pod16x16.json"
                        ).read_text())
        r, n = c["roofline"], c["counts"]
        log(f"mesh 8d {LM_ARCH} train_4k pod16x16 (rank 0 of 256, "
            f"{n['microbatches']} microbatches, remat full, loss_chunk "
            f"256): {n['flops']:.4e} FLOP, {n['bytes']:.4e} bytes accessed, "
            f"collectives {n['coll_counts']} "
            f"({ {k: f'{v:.3e}' for k, v in n['coll_breakdown'].items()} } "
            f"bytes), peak live {c['memory']['peak_gib']:.2f} GiB, trace "
            f"{c['trace_s']} s; at the datasheet's rates compute "
            f"{r['compute_s']:.4f} s, memory {r['memory_s']:.4f} s, "
            f"collective {r['collective_s']:.4f} s ({r['dominant']}); model "
            f"FLOPs ratio {r['model_flops_ratio']:.3f}")


# ------------------------------------------------------------------ report
def cuda_ms(torch, fns, reps=20) -> float:
    """Median device time of one call, in ms. ``fns`` is one callable, or
    a list cycled call by call (one per fresh id set, so each call finds
    its rows cold, as a hop does). The calls queue behind a device sleep of
    ~0.1 s, so the host's enqueue cost (Python, ctypes) stays out of the
    events: each pair brackets one call's device work."""
    fns = fns if isinstance(fns, list) else [fns]
    fns[-1]()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for i, (s, e) in enumerate(ev):
        s.record()
        fns[i % len(fns)]()
        e.record()
    torch.cuda.synchronize()
    ts = sorted(s.elapsed_time(e) for s, e in ev)
    return ts[len(ts) // 2]


def bounds(torch, op, args):
    """(bytes, fp32 ops) the op must move / do on these inputs."""
    if op == "pq_adc_batched":
        codes, luts, *ids = args
        if ids:     # only the rows of valid ids are read
            m = codes.shape[1]
            valid = int((ids[0] >= 0).sum())
            return (valid * m + luts.numel() * 4 + ids[0].numel() * 8,
                    valid * (m - 1))
        nq, n, m = codes.shape
        return codes.numel() + luts.numel() * 4 + nq * n * 4, nq * n * (m - 1)
    if op == "beam_step":      # only the rows of valid ids are read
        pq_codes, luts, cand_ids, cand_d, new_ids = args
        m = pq_codes.shape[1]
        valid = int((new_ids >= 0).sum())
        nq, l_size = cand_ids.shape
        return (valid * m + luts.numel() * 4 + nq * l_size * 8
                + new_ids.numel() * 4 + nq * l_size * 12), valid * (m - 1)
    if op == "ef_decode":      # only the rows of the ids are read
        slots, r_max, _, ids = args
        b = ids.numel()
        return b * slots.shape[1] * 4 + b * 4 + b * (r_max + 1) * 4, 0
    if op == "rerank_l2":      # by id: every id's row is read (clipped)
        q, x, *ids = args
        rows, d = ((ids[0].numel(), x.shape[1]) if ids
                   else (x.shape[0] * x.shape[1], x.shape[2]))
        return (q.numel() * 4 + rows * d * x.element_size()
                + rows * (8 if ids else 4)), 3 * rows * d
    if op == "rerank_loop":    # each batch's ids and rows, read once
        q, x, cand, k, b = args[:5]
        from repro_torch.kernels.rerank_loop.rerank_loop import \
            rerank_loop_ref
        ran = rerank_loop_ref(*args)[2].long()
        rows = int((k + b * ran).sum())
        d = x.shape[1]
        return (q.numel() * 4 + rows * (4 + d * x.element_size())
                + q.shape[0] * (k * 8 + 4)), 3 * rows * d
    if op == "pq_encode":
        x, cents = args
        m, k, dsub = cents.shape
        return (x.numel() * x.element_size() + cents.numel() * 4
                + x.shape[0] * m), x.shape[0] * m * k * 3 * dsub
    if op == "pq_adc":
        codes, lut = args
        n, m = codes.shape
        return (codes.numel() * codes.element_size() + lut.numel() * 4
                + n * 4), n * (m - 1)
    if op == "byteplane":          # launch/roofline.py's 2nV + V bytes
        packed, base = args
        return 2 * packed.numel() + base.numel(), packed.numel()
    if op == "ef_record_decode":   # records and table entries read once
        buf, rec_start, rec_len, pos = args
        b = pos.numel()
        r_max = int(buf[rec_start[pos]].max())     # a record's first byte
        return (int(rec_len[pos].sum()) + b * (8 + 8 + 4)
                + b * (r_max + 1) * 8), 0
    if op == "round_expand":   # round_expand.cu's note, 32-byte sectors
        from repro_torch.kernels.search_round import search_round as sr
        from repro_torch.kernels.ef_decode.ef_decode import ef_decode_cuda
        (slots, r_max, universe, cand_ids, cand_d, expanded, active, visited,
         _, _, _, new_ids, w, bits) = args
        sel, _ = sr.select(cand_ids, cand_d, sr.unexpanded(
            cand_ids, expanded, True) & active[:, None], w)
        lists = torch.sort(sr.ef_lists(ef_decode_cuda, slots, r_max,
                                       universe, sel), dim=1).values
        first = torch.ones_like(lists, dtype=torch.bool)
        first[:, 1:] = lists[:, 1:] != lists[:, :-1]
        uniq = torch.where(first, lists, -1)
        seen = torch.gather(visited, 1,
                            sr.hash_slots(uniq.clamp_min(0), bits)) == uniq
        probes = int((uniq >= 0).sum())
        news = int(((uniq >= 0) & ~seen).sum())
        nq, l_size = cand_ids.shape
        # the candidate state, the selected slots, a sector a probe and a
        # new id's write, new_ids, the counters
        return (nq * l_size * 9 + int((sel >= 0).sum()) * slots.shape[1] * 4
                + (probes + news) * 32 + new_ids.numel() * 4 + nq * 8), 0
    if op == "round_settle":   # the hop's output read, the state rewritten
        cand_ids, prev_top = args[3], args[9]
        nq, l_size = cand_ids.shape
        # top_* read, the flags read, the state written; prev_top and the
        # counters read and written
        return (nq * l_size * (12 + 1 + 9) + prev_top.numel() * 8
                + nq * 26), 0
    if op == "huffman_decode":     # the records read, the rows written
        from repro_torch.core.codec.huffman import (decode_at_torch,
                                                    record_bytes_torch)
        payload, starts, v, table, bases, base_of = args
        m = starts.numel()
        records = int(record_bytes_torch(
            decode_at_torch(payload, starts, v, table), table).sum())
        return records + m * (8 + 4 + v) + bases.numel(), 0
    raise KeyError(op)


def library_call(torch, op, args):
    """One PyTorch call computing the same function, or None."""
    if op == "pq_adc_batched":   # on the rows of the ids, gathered first
        table, luts, ids = args
        idx = table[ids.clamp(0, len(table) - 1)].long().transpose(1, 2)
        idx = idx.contiguous()
        return lambda: torch.gather(luts, 2, idx).sum(1)
    if op == "rerank_l2":        # on the rows of the ids, gathered first
        q, table, ids = args
        xf = table[ids.long()].float()
        return lambda: torch.cdist(q[:, None, :], xf)[:, 0] ** 2
    if op == "pq_adc":
        codes, lut = args
        idx = codes.long()
        ar = torch.arange(lut.shape[0], device=lut.device)[None, :]
        return lambda: lut[ar, idx].sum(-1)
    if op == "byteplane":
        packed, base = args
        return lambda: torch.bitwise_xor(packed, base)
    return None


def old_compositions(torch, parity) -> None:
    """The hop's ADC and the re-rank's distances as the search ran them
    before pq_adc_batched and rerank_l2 read their rows by id: the torch
    index op, then the kernel without ids (and the hop's mask), beside the
    kernel by id and the kernel without ids on rows gathered beforehand,
    each cycling the same fresh id sets (rows cold)."""
    adc = parity.ops["pq_adc_batched"][0]
    rr = parity.ops["rerank_l2"][0]

    def rows(table, ids):         # the torch index op as the search ran it
        return table[ids.clamp(0, table.shape[0] - 1)]

    def old_hop(table, luts, ids):
        return torch.where(ids >= 0, adc(rows(table, ids), luts), torch.inf)

    def old_rerank(q, table, ids):
        return rr(q, rows(table, ids))

    parts = []
    for op, old, kern, no_ids in (
            ("pq_adc_batched", old_hop, adc, lambda t, lu, i: (rows(t, i), lu)),
            ("rerank_l2", old_rerank, rr, lambda q, t, i: (q, rows(t, i)))):
        sets = parity.cold[op]
        check(bits_equal(torch, old(*sets[0]), kern(*sets[0])),
              f"{op}: the old composition != the kernel by id")
        gathered = [no_ids(*a) for a in sets]
        t_old = cuda_ms(torch, [lambda a=a: old(*a) for a in sets])
        t_new = cuda_ms(torch, [lambda a=a: kern(*a) for a in sets])
        t_pre = cuda_ms(torch, [lambda g=g: kern(*g) for g in gathered])
        del gathered
        parts.append(f"{op} {[tuple(a.shape) for a in sets[0]]}: old "
                     f"composition (torch index + kernel without ids) "
                     f"{t_old:.4f} ms, kernel by id {t_new:.4f} ms, kernel "
                     f"without ids on rows gathered beforehand {t_pre:.4f} "
                     f"ms")
    log(f"old compositions (cycling {Parity.COLD_SETS} fresh id sets, rows "
        f"cold): " + "; ".join(parts))


def beam_step_regimes(torch, parity) -> None:
    """beam_step's time by how many new ids survive the filter (beat the
    candidate half's last entry): none read (the LUTs and the fixed
    costs), the search's steady state, and the timed set of the report."""
    from repro_torch.kernels.pq_adc.pq_adc import pq_adc_batched_ref
    kern = parity.ops["beam_step"][0]
    parts = []
    for name, sets in parity.beam_regimes.items():
        pq_codes, luts, _, cand_d, new_ids = sets[0]
        d = pq_adc_batched_ref(pq_codes, luts, new_ids)
        live = d < cand_d[:, -1:]          # masked ids score +inf
        t = cuda_ms(torch, [lambda a=a: kern(*a) for a in sets])
        parts.append(f"{name} (~{float(live.sum(1).float().mean()):.1f} "
                     f"survivors a query) {t:.4f} ms")
    log(f"beam_step by survivors (rows cold, cycling "
        f"{Parity.COLD_SETS} id sets): " + "; ".join(parts))


def wide_pq_timings(torch, parity) -> None:
    """The serve cells' PQ shapes beside the shard's: beam_step and
    pq_adc_batched at M = 384 (768-d rows' 384-byte codes, the LUT in 12
    slices of 32 sub-spaces) into 2,000,000 code rows at the hop's shapes
    (nq 1,024, E 512 ids 60% kept, L 200), and pq_encode at DEEP1B's
    dsub 3 (262,144 x 96 float32 rows, M = 32): each bit for bit against
    its plain version, then its device time (cycling fresh id sets) beside
    its byte or operation bound."""
    from repro_torch.kernels.beam_step.beam_step import lut_slices
    n, nq, e, l_size, m, k = 2_000_000, 1024, 512, 200, 384, 256
    codes = parity.randint(256, n, m, dtype=torch.uint8)
    luts = parity.rand(nq, m, k).abs_()
    cand_ids = parity.randint(n, nq, l_size, dtype=torch.int32)
    cand_d, order = parity.ops["pq_adc_batched"][0](
        codes, luts, cand_ids).sort(1)
    cand_ids = torch.gather(cand_ids, 1, order)

    def new_ids():
        keep = torch.rand(nq, e, generator=parity.g, device=parity.dev) < 0.6
        return torch.where(keep, parity.randint(n, nq, e), -1).to(torch.int32)
    hops = [(codes, luts, cand_ids, cand_d.contiguous(), new_ids())
            for _ in range(Parity.COLD_SETS)]
    parity.compare("beam_step", f"M={m} hop, LUT in "
                   f"{lut_slices(m, k, e, l_size)} slices", *hops[0])
    parity.compare("pq_adc_batched", f"M={m} by id", codes, luts, hops[0][4])
    parts = []
    for op, sets in (("beam_step", hops),
                     ("pq_adc_batched", [(codes, luts, h[4]) for h in hops])):
        kern = parity.ops[op][0]
        ms = cuda_ms(torch, [lambda a=a: kern(*a) for a in sets])
        nbytes = bounds(torch, op, sets[0])[0]
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        parts.append(f"{op} M={m} {ms:.4f} ms, bound {bound:.4f} ms "
                     f"({nbytes / 1e6:.1f} MB, {100 * bound / ms:.1f}%)")
    x = parity.rand(1 << 18, 96)
    cents = parity.rand(32, 256, 3)
    parity.compare("pq_encode", "f32 262144x96 M=32 (dsub 3)", x, cents)
    ms = cuda_ms(torch, lambda: parity.ops["pq_encode"][0](x, cents))
    nbytes, ops = bounds(torch, "pq_encode", (x, cents))
    bound = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
    parts.append(f"pq_encode dsub 3 {ms:.4f} ms, bound {bound:.4f} ms "
                 f"(operations, {100 * bound / ms:.1f}%)")
    log("wide PQ (rows cold, cycling "
        f"{Parity.COLD_SETS} id sets): " + "; ".join(parts))


def rerank_loop_timings(torch, parity) -> None:
    """The whole re-rank at the three serve cells' row shapes (uint8 D 128
    on the shard's own rows; float32 D 96 and D 768 on 2,000,000 drawn
    rows), 1,024 queries, L 200, K = B = 10, up to 16 batches at the
    default threshold: the one rerank_loop launch bit for bit against the
    plain loop (plain torch distances), then its device time (cycling
    fresh candidate lists, rows cold) beside the byte bound and the time
    of the loop the search ran before (``parity.yardsticks``: a rerank_l2
    launch and a read a batch, the host reads inside the events)."""
    from repro_torch.core.search.beam import SearchParams
    nq, n = 1024, 2_000_000
    p = SearchParams(l_size=200, k=10, rerank_batch=10)
    shard_rows = parity.shard_in["rerank_l2"][1]
    tables = {
        "u8 D=128": (shard_rows, parity.rand(nq, 128).abs_() * 64),
        "f32 D=96": (parity.rand(n, 96), parity.rand(nq, 96)),
        "f32 D=768": (parity.rand(n, 768), parity.rand(nq, 768))}
    kern, host_loop = (parity.ops["rerank_loop"][0],
                       parity.yardsticks["rerank_loop"])
    parts = []
    for name, (table, q) in tables.items():
        sets = parity.rerank_loop_args(q, table, p, Parity.COLD_SETS)
        ran = parity.compare("rerank_loop", f"{name} serve shape",
                             *sets[0])[2].float()
        ms = cuda_ms(torch, [lambda a=a: kern(*a) for a in sets])
        host_ms = cuda_ms(torch, [lambda a=a: host_loop(*a) for a in sets],
                          reps=5)
        nbytes = bounds(torch, "rerank_loop", sets[0])[0]
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        parts.append(f"{name} {ms:.4f} ms (host loop with rerank_l2 "
                     f"launches {host_ms:.4f} ms), "
                     f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
                     f"{100 * bound / ms:.1f}%), batches mean "
                     f"{float(ran.mean()):.2f} max {int(ran.max())}")
        del sets, table, q
    log(f"rerank_loop at the serve shapes ({nq} queries, L {p.l_size}, K "
        f"{p.k}, B {p.rerank_batch}, rows cold, cycling "
        f"{Parity.COLD_SETS} candidate sets): " + "; ".join(parts))


def load_yardstick(torch, parity) -> None:
    """The load's old composition on each full segment of phase 2:
    ``decode_at_torch`` then one byteplane launch per chunk with a base,
    as ``decode_bytes`` ran before huffman_decode absorbed both; its wall
    beside the kernel's (host clock around synchronised calls, in the
    order old, kernel, kernel, old) and the kernel's device time."""
    from repro_torch.core.codec.huffman import decode_at_torch
    from repro_torch.kernels.byteplane.byteplane import byteplane_decode_cuda
    kern = parity.ops["huffman_decode"][0]
    parts = []
    for name, (seg, args) in parity.segments.items():
        payload, starts, v, table, _, _ = args
        rpc = seg.rows_per_chunk
        based = [(ci * rpc, c.base) for ci, c in enumerate(seg.chunks)
                 if c.base is not None]

        def old():
            raw = decode_at_torch(payload, starts, v, table)
            for lo, base in based:
                raw[lo:lo + rpc] = byteplane_decode_cuda(raw[lo:lo + rpc],
                                                         base)
            return raw
        check(bits_equal(torch, old(), kern(*args)),
              f"{name} segment: the old composition != huffman_decode")
        walls = {"old": [], "kernel": []}
        for which in ("old", "kernel", "kernel", "old"):
            t0 = sync_time(torch)
            old() if which == "old" else kern(*args)
            walls[which].append(sync_time(torch, t0))
        ms = cuda_ms(torch, lambda: kern(*args))
        nbytes = bounds(torch, "huffman_decode", args)[0]
        parts.append(
            f"{name} segment ({len(starts)} rows x {v} B, {len(based)} of "
            f"{len(seg.chunks)} chunks with a base): old composition wall "
            f"{walls['old']} s ({len(based)} byteplane launches each); "
            f"huffman_decode wall {walls['kernel']} s, device {ms:.4f} ms, "
            f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
            f"({nbytes / 1e6:.1f} MB)")
    log("load yardstick: " + "; ".join(parts))


def pq_adc_yardsticks(torch, parity) -> None:
    """Beside the shard's scan (one query's LUT against every code): the
    same kernel on all-equal codes of the same shape, whose LUT reads are
    conflict-free in any layout; the time of reading the same codes once
    (a torch sum of them viewed as int64: a yardstick of the card's read
    rate, not a library call for ADC); the byte bound, and the bound of
    the n*M LUT reads from shared memory at 32 a clock an SM."""
    kern = parity.ops["pq_adc"][0]
    codes, lut = parity.shard_in["pq_adc"]
    n, m = codes.shape
    equal = torch.full_like(codes, 3)
    out = kern(equal, lut)
    check(bool((out == out[0]).all()), "pq_adc: equal codes, unequal sums")
    words = codes.view(torch.int64)
    ms = {"kernel": cuda_ms(torch, lambda: kern(codes, lut)),
          "equal": cuda_ms(torch, lambda: kern(equal, lut)),
          "stream": cuda_ms(torch, lambda: words.sum())}
    del equal, out
    nbytes = bounds(torch, "pq_adc", (codes, lut))[0]
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_lut = n * m / (sms * 32 * mhz * 1e6) * 1e3
    log(f"pq_adc yardsticks ({list(codes.shape)} {codes.dtype}, one LUT "
        f"{list(lut.shape)}): kernel on the shard's codes {ms['kernel']:.4f}"
        f" ms; on all-equal codes {ms['equal']:.4f} ms (LUT reads "
        f"conflict-free); stream of the {words.numel() * 8 / 1e9:.2f} GB of "
        f"codes once (torch int64 sum, a read-rate yardstick, not an ADC "
        f"library call) {ms['stream']:.4f} ms = "
        f"{words.numel() * 8 / ms['stream'] / 1e9:.3f} TB/s, at which the "
        f"kernel's {nbytes / 1e9:.3f} GB take "
        f"{nbytes / (words.numel() * 8) * ms['stream']:.4f} ms; bounds: bytes "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes / 1e6:.1f} MB), "
        f"LUT reads {t_lut:.4f} ms ({n * m / 1e9:.2f}e9 reads, {sms} SMs x "
        f"32 a clock at {mhz:.0f} MHz)")


def record_yardstick(torch, parity) -> None:
    """ef_record_decode on one segment of rows of each restore cell's
    store (the shard's records: sift1b-shard 4,194,304, deep1b-shard its
    first 1,398,101), as decode_batch calls it (the largest count read
    back, then the launch): its device time between events, the plain
    version's (its passes and reads included), the byte bound, and its
    wall (host clock around a synchronised call, median of 5)."""
    t0 = time.time()
    kern, plain = parity.ops["ef_record_decode"]
    buf, st, ln = parity.records
    parts = []
    for name, rows in RESTORE_ROWS.items():
        pos = torch.arange(min(rows, st.numel()), device=parity.dev)
        args = (buf, st, ln, pos)
        ms = cuda_ms(torch, lambda: kern(*args))
        plain_ms = cuda_ms(torch, lambda: plain(*args), reps=3)
        walls = []
        for _ in range(5):
            w0 = sync_time(torch)
            kern(*args)
            walls.append(sync_time(torch, w0) * 1e3)
        nbytes = bounds(torch, "ef_record_decode", args)[0]
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        parts.append(
            f"{name} segment ({pos.numel()} records, {nbytes / 1e9:.3f} GB):"
            f" op {ms:.4f} ms with its read-back ({100 * bound / ms:.1f}% of"
            f" the bound, {nbytes / ms / 1e6:.1f} GB/s), bound {bound:.4f} "
            f"ms, plain {plain_ms:.4f} ms, op wall {sorted(walls)[2]:.4f} "
            f"ms")
    parity.records_s += time.time() - t0
    log("ef_record_decode yardstick: " + "; ".join(parts))


def time_kernels(torch, parity) -> dict:
    """Per-kernel device times on the shard's inputs, taken before the
    storage phase, each beside its plain version's (or its
    ``parity.yardsticks`` entry's); then the parity inputs, which hold the
    shard's tables, are let go."""
    old_compositions(torch, parity)
    beam_step_regimes(torch, parity)
    wide_pq_timings(torch, parity)
    rerank_loop_timings(torch, parity)
    load_yardstick(torch, parity)
    pq_adc_yardsticks(torch, parity)
    record_yardstick(torch, parity)
    times = {}
    for op, args in parity.shard_in.items():
        kern, plain = parity.ops[op]
        plain = parity.yardsticks.get(op, plain)
        sets = parity.cold.get(op, [args])
        k_sets = p_sets = sets
        if op in parity.in_place:
            # each call on a state of its own, copied before the timing
            # (at most 3 calls a copy, each a round on from the last)
            kern, plain = parity.in_place[op]
            k_sets, p_sets = ([[a.clone() if i in ROUND_OUT[op] else a
                                for i, a in enumerate(args)]
                               for _ in range(Parity.COLD_SETS)]
                              for _ in range(2))
            sets = k_sets
        lib = library_call(torch, op, args)
        times[op] = dict(
            ms=cuda_ms(torch, [lambda a=a: kern(*a) for a in k_sets]),
            plain_ms=cuda_ms(torch, [lambda a=a: plain(*a) for a in p_sets],
                             reps=5),
            library_ms=None if lib is None else cuda_ms(torch, lib),
            cost=bounds(torch, op, args), sets=len(sets),
            shapes=[tuple(a.shape) for a in args if hasattr(a, "shape")])
    parity.shard_in = parity.cold = parity.beam_regimes = None
    parity.segments = parity.records = None
    return times


def report(parity, launches, times):
    kernels = []
    for op, t in times.items():
        nbytes, ops = t["cost"]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        n_launch = launches[op]
        if op in OFF_PATH:
            check(n_launch == 0, f"{op} launched on the load path")
        else:
            check(n_launch > 0, f"{op} has no launches on its path")
        kernels.append({
            "name": op, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{op}.cu",
            "replaces": REPLACES[op], "launches": n_launch,
            "max_abs_err": parity.err[op], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": t["library_ms"]})
        lib_ms = t["library_ms"]
        cold = (f" (cycling {t['sets']} fresh id sets, rows cold)"
                if t["sets"] > 1 else "")
        log(f"time {op} {t['shapes']}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms{cold}, library "
            f"{lib_ms if lib_ms is None else round(lib_ms, 4)} "
            f"ms, bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, "
            f"{ops / 1e9:.3f} GFLOP); launches {n_launch}; parity cases "
            f"{parity.cases[op]} bit-exact")
    return kernels


if __name__ == "__main__":
    sys.exit(main())
