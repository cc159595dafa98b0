"""Device-side graph beam search + latency-aware re-ranking (paper §3.4),
batch-first over queries — the PyTorch port of ``repro.core.search.beam``.

- Traversal touches ONLY the auxiliary index (Elias-Fano slots or raw
  adjacency) + the device-resident PQ codes — never full-precision vectors.
- Phase 1 prefetch trigger: once the top-(K+B) candidate set survives B
  consecutive expansions unchanged, the top-K set is frozen as the
  prefetch set (§3.4 "stability"); the trigger iteration is recorded.
- Phase 2 re-rank: batches of B exact distances, early-terminated when the
  *benefit ratio* (fraction of a batch entering the top-K) drops below the
  threshold, with a one-batch lookahead.

The whole query batch advances through one loop; a finished row is frozen
by masking its updates, so each row's trajectory equals its solo (nq=1)
run. The reference's traversal ``lax.while_loop`` is a host loop here that
stops when no row is active (one device-to-host read of that flag per
round); its re-rank loop is the ``rerank_loop`` op (below). A round's
bookkeeping around the hop is ``kernels/search_round``'s: on the card two
kernel launches (``round_expand``, ``round_settle``) where the visited set
is the hash table over EF slots, else its plain PyTorch version. On the
card the traversal's rounds after the first replay a CUDA graph of one round
(``_capture``), so a round costs the host one launch, not three kernel
launches or ~50 op dispatches; ``kernels.build.LAUNCHES`` counts a
captured kernel once. Every top-k is a stable ascending sort
(``stable_smallest``): ``lax.top_k`` breaks ties to the lower index and
``torch.topk`` does not.
Scatters the reference writes with ``mode="drop"`` to index ``n`` / ``H``
write into one padding column here, which no read looks at.

The compute ops — batched PQ ADC, EF slot decode, the fused hop and the
re-rank's whole loop — go through ``kernels.dispatch``: a CUDA kernel on a
CUDA index, the plain PyTorch version on a CPU index. Each takes the
shard's table and the ids of the rows it reads, so no row gather precedes
it. On the card the re-rank is one ``rerank_loop`` launch that reads
nothing back; on the CPU its plain loop reads a flag a batch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ... import tracing
from ...kernels import dispatch
from ...kernels.beam_step.beam_step import lut_slices
from ...kernels.dispatch import resolve_device
from ...kernels.search_round import search_round
from ..graph.pq import build_lut_torch


class DeviceIndex(NamedTuple):
    """Device-resident search state (one shard), all tensors on one device."""
    neighbors: torch.Tensor     # [n, R] int32 (-1 padded) — raw variant
                                # (a 1-row stub when only EF slots are kept)
    counts: torch.Tensor        # [n] int32
    ef_slots: torch.Tensor      # [n, slot_words] int32 bit-view of uint32
    pq_codes: torch.Tensor      # [n, M] uint8
    pq_centroids: torch.Tensor  # [M, K, dsub] float32
    vectors: torch.Tensor       # [n, d] float32 or uint8 (re-rank tier)
    medoid: torch.Tensor        # 0-d int64
    tombstone: torch.Tensor | None = None  # [n] bool — §3.5 live-snapshot
                                # deletes, masked in rerank when
                                # SearchParams.filter_tombstones is set.


class SearchParams(NamedTuple):
    l_size: int = 64            # candidate list size L
    beam_width: int = 4         # W
    k: int = 10                 # result set size K
    rerank_batch: int = 10      # B (also prefetch stability threshold)
    benefit_threshold: float = 0.01
    max_iters: int = 256
    max_rerank_batches: int = 16
    use_ef: bool = True         # compressed index traversal
    r_max: int = 32
    universe: int = 0           # vector-id universe for EF slots (0 -> n)
    visited_hash_bits: int = 0  # >0: open-addressing visited set of 2^bits
                                # slots instead of [n]-bool arrays
    trace_fetches: bool = False  # record the per-round adjacency-fetch ids
    trace_hints: bool = False    # also record each round's PROVISIONAL next
                                 # frontier (top-W unexpanded candidates
                                 # before the round's neighbours merge)
    filter_tombstones: bool = False  # mask index.tombstone rows out of the
                                 # re-rank heap (id -> -1), never out of
                                 # traversal


class SearchStats(NamedTuple):
    iters: torch.Tensor            # [nq] traversal rounds (graph I/O batches)
    lists_fetched: torch.Tensor    # [nq] adjacency lists read
    prefetch_iter: torch.Tensor    # [nq] prefetch trigger iteration (-1: never)
    rerank_batches: torch.Tensor   # [nq] re-rank batches actually executed
    exact_dists: torch.Tensor      # [nq] full-precision distance computations
    pq_dists: torch.Tensor         # [nq] PQ (ADC) distance computations
    fetch_trace: torch.Tensor      # [nq, max_iters, W] fetched vertex ids
                                   # (-1 = none; empty unless trace_fetches)
    hint_trace: torch.Tensor       # [nq, max_iters, W] provisional next-
                                   # frontier ids (empty unless trace_hints)


def _gather_neighbors(index: DeviceIndex, sel_ids: torch.Tensor,
                      p: SearchParams, n: int) -> torch.Tensor:
    """[nq, W] vertex ids -> [nq, W * r_max] neighbour ids (-1 = invalid)."""
    if p.use_ef:
        # the kernel reads each slot by id, clipped to the table
        return search_round.ef_lists(dispatch.ef_decode, index.ef_slots,
                                     p.r_max, p.universe or n, sel_ids)
    nbrs = index.neighbors[sel_ids.clamp(0, n - 1)]
    return torch.where((sel_ids >= 0)[..., None], nbrs,
                       -1).reshape(sel_ids.shape[0], -1)


def _graphable(luts: torch.Tensor, p: SearchParams) -> bool:
    """A round can be captured: it runs on the card (every dispatched op a
    CUDA kernel), reads nothing back to the host (no trace buffers, whose
    writes are masked by row) and keeps its visited set in the hash table
    (the dense set's index writes are left to the plain loop)."""
    return luts.is_cuda and not (p.trace_fetches or p.trace_hints) \
        and p.visited_hash_bits > 0


def _fused(luts: torch.Tensor, p: SearchParams, n: int) -> bool:
    """A round's bookkeeping runs as the ``round_expand`` and
    ``round_settle`` kernels: the round is graphable, its lists are EF
    slots and its shapes fit a block (``search_round.fits``)."""
    return p.use_ef and _graphable(luts, p) and search_round.fits(
        p.l_size, p.beam_width, p.r_max, p.universe or n,
        p.visited_hash_bits)


#: Per device: the memory pool of the traversal's graphs and the last graph
#: captured into it, held until the next capture has taken the pool over
#: (the graphs share it one after another, never at once).
_GRAPHS: dict = {}


def _capture(step, dev: torch.device):
    """``step`` (a round, in place over the traversal's state) captured
    as one CUDA graph -> its replay."""
    held = _GRAPHS.get(dev)
    pool = held[0] if held else torch.cuda.graph_pool_handle()
    g = torch.cuda.CUDAGraph()
    here = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(here)
    with tracing.span("search.capture"), torch.cuda.stream(side):
        g.capture_begin(pool=pool, capture_error_mode="thread_local")
        step()
        g.capture_end()
    here.wait_stream(side)
    _GRAPHS[dev] = (pool, g)
    return g.replay


def traverse(index: DeviceIndex, luts: torch.Tensor, p: SearchParams):
    """Batched beam traversal: per-query LUTs [nq, M, K] ->
    (cand_ids [nq, L], cand_d [nq, L], (iters, fetched, pf_iter, pq, trace,
    hints)).

    Each round updates the traversal's state in place
    (``kernels/search_round``): expand, the hop, settle. On the card with
    the hash visited set over EF slots and no trace buffers (``_fused``)
    expand and settle are one kernel launch each around the hop; elsewhere
    they are their plain PyTorch version. On the card (where
    :func:`_graphable`) the rounds after the first replay one CUDA graph
    of a round, so the host issues one launch a round; the kernels and
    their order are the same, so are the results, bit for bit.

    A row with no unexpanded frontier (or out of iterations) is frozen: its
    frontier distances are masked to +inf so it selects nothing, fetches
    nothing, and its candidate list and counters pass through unchanged.

    Two visited-set representations:
    - dense [nq, n]-bool arrays (exact; O(n) device memory per query), or
    - a 2^visited_hash_bits open-addressing id table plus per-list-slot
      expansion flags (a hash eviction can only cause a re-visit).
    """
    dev = luts.device
    n = index.pq_codes.shape[0]
    nq = luts.shape[0]
    L, W = p.l_size, p.beam_width
    KB = min(p.k + p.rerank_batch, L)
    use_hash = p.visited_hash_bits > 0
    rows = torch.arange(nq, device=dev)
    trace_len = p.max_iters if p.trace_fetches else 0
    hint_len = p.max_iters if p.trace_hints else 0
    m, k = luts.shape[1], luts.shape[2]
    e = W * (p.r_max if p.use_ef else index.neighbors.shape[1])
    # the slices the hop's CUDA kernel stages a LUT in (1 on the CPU)
    hop_args = {"m": m, "lut_bytes": m * k * 4,
                "lut_slices": lut_slices(m, k, e, L) if luts.is_cuda else 1}

    entry = index.medoid.to(torch.int32).expand(nq).contiguous()
    e_d = dispatch.pq_adc_batched(index.pq_codes, luts,
                                  ids=entry[:, None])[:, 0]
    cand_ids = torch.full((nq, L), -1, dtype=torch.int32, device=dev)
    cand_ids[:, 0] = entry
    cand_d = torch.full((nq, L), torch.inf, dtype=torch.float32, device=dev)
    cand_d[:, 0] = e_d
    if use_hash:
        H = 1 << p.visited_hash_bits
        # column H is the "nowhere" of the reference's mode="drop" scatters
        visited = torch.full((nq, H + 1), -1, dtype=torch.int32, device=dev)
        visited[rows, search_round.hash_slots(entry,
                                              p.visited_hash_bits)] = entry
        expanded = torch.zeros((nq, L), dtype=torch.bool, device=dev)
    else:
        visited = torch.zeros((nq, n + 1), dtype=torch.bool, device=dev)
        visited[rows, entry.long()] = True
        expanded = torch.zeros((nq, n + 1), dtype=torch.bool, device=dev)
    iters, fetched, pq_ct, stab = torch.zeros((4, nq), dtype=torch.int32,
                                              device=dev).unbind(0)
    pf_iter = torch.full((nq,), -1, dtype=torch.int32, device=dev)
    prev_top = torch.full((nq, KB), -1, dtype=torch.int32, device=dev)
    trace = torch.full((nq, trace_len, W), -1, dtype=torch.int32, device=dev)
    hints = torch.full((nq, hint_len, W), -1, dtype=torch.int32, device=dev)
    active = search_round.unexpanded(cand_ids, expanded, use_hash).any(1) \
        & (iters < p.max_iters)
    flag = torch.zeros((), dtype=torch.bool, device=dev)  # any row active
    fused = _fused(luts, p, n)
    new_ids = torch.empty((nq, e), dtype=torch.int32, device=dev) \
        if fused else None

    def _record(buf, ids):
        # the reference's trace.at[rows, iters].set(ids, mode="drop")
        ok = iters < buf.shape[1]
        buf[rows[ok], iters[ok].long()] = ids[ok]

    def _hop(new_ids):
        # the fused hop reads the code rows of new_ids itself
        with tracing.span("search.hop", hop_args):
            return dispatch.beam_step(index.pq_codes, luts, cand_ids, cand_d,
                                      new_ids)

    def _plain_round():
        # one expansion of every active row, the state updated in place
        with tracing.span("search.round", {"fused": 0}):
            new_ids, sel_ids = search_round.expand(
                lambda ids: _gather_neighbors(index, ids, p, n), cand_ids,
                cand_d, expanded, active, visited, fetched, pq_ct, W,
                p.visited_hash_bits)
            if p.trace_fetches:
                _record(trace, sel_ids)
            if p.trace_hints:
                # Provisional frontier for round r+1, read BEFORE this
                # round's neighbours merge: the top-W unexpanded survivors
                # of the list.
                _record(hints, search_round.select(
                    cand_ids, cand_d,
                    search_round.unexpanded(cand_ids, expanded, use_hash)
                    & active[:, None], W)[0])
            search_round.round_settle_ref(
                *_hop(new_ids), cand_ids, cand_d, expanded, iters, stab,
                pf_iter, prev_top, active, flag, W, p.rerank_batch,
                p.max_iters, by_slot=use_hash)

    def _fused_round():
        # the same round: its bookkeeping two kernel launches around the hop
        with tracing.span("search.round", {"fused": 1}):
            search_round.round_expand_cuda(
                index.ef_slots, p.r_max, p.universe or n, cand_ids, cand_d,
                expanded, active, visited, fetched, pq_ct, flag, new_ids, W,
                p.visited_hash_bits)
            search_round.round_settle_cuda(
                *_hop(new_ids), cand_ids, cand_d, expanded, iters, stab,
                pf_iter, prev_top, active, flag, W, p.rerank_batch,
                p.max_iters)

    step = _fused_round if fused else _plain_round
    go = tracing.any_set("search.sync", active)
    if go and _graphable(luts, p):
        # the first round runs as it is written, the rest replay its
        # capture: one graph launch and one flag read a round
        step()
        go = tracing.any_set("search.sync", flag)
        if go:
            replay = _capture(step, dev)
            while go:
                with tracing.span("search.round", {"fused": int(fused)}):
                    replay()
                go = tracing.any_set("search.sync", flag)
    while go:
        step()
        go = tracing.any_set("search.sync", flag)

    return cand_ids, cand_d, (iters, fetched, pf_iter, pq_ct + 1, trace,
                              hints)


def rerank(index: DeviceIndex, queries: torch.Tensor, cand_ids: torch.Tensor,
           p: SearchParams):
    """Batched phase-2 adaptive re-ranking (§3.4) ->
    (ids [nq, K], dists [nq, K], (batches [nq], exact_ct [nq])).

    Batch 0 (the prefetched top-K) and then batches of B candidates until
    a row's benefit ratio fires (plus the one-batch lookahead): the
    ``rerank_loop`` op, so each row's executed-batch count matches a solo
    run. On the card that is one kernel launch in which every row runs its
    own loop; on the CPU the plain loop, all rows in lockstep.
    """
    K, B = p.k, p.rerank_batch
    if p.filter_tombstones and index.tombstone is None:
        raise ValueError(
            "SearchParams.filter_tombstones=True requires an index with a "
            "tombstone mask (DeviceIndex.tombstone)")
    # Candidates beyond L don't exist; bound the batch loop statically.
    max_batches = min(p.max_rerank_batches, max(0, (p.l_size - K) // B))
    ids, dists, batches = dispatch.rerank_loop(
        queries, index.vectors, cand_ids, K, B, max_batches,
        p.benefit_threshold,
        index.tombstone if p.filter_tombstones else None)
    if p.filter_tombstones:
        # A tombstoned (masked-to-inf) id must never surface: -1 = no result.
        ids = torch.where(torch.isfinite(dists), ids, -1)
    exact_ct = (K + batches * B).to(torch.int32)
    return ids, dists, (batches, exact_ct)


def _on_device(index: DeviceIndex, queries, device) -> torch.Tensor:
    dev = resolve_device(device)
    if index.pq_codes.device.type != dev.type:
        raise ValueError(f"index lives on {index.pq_codes.device}; "
                         f"the search was asked to run on {dev}")
    return torch.as_tensor(queries, device=index.pq_codes.device).contiguous()


def search_batched(index: DeviceIndex, queries, p: SearchParams,
                   device=None):
    """Batch-first search core: queries [nq, d] -> (ids [nq, K] int32,
    dists [nq, K] float32, SearchStats of [nq])."""
    with tracing.span("search.batch"):
        queries = _on_device(index, queries, device)
        with tracing.span("search.lut"):
            luts = build_lut_torch(queries, index.pq_centroids)
        with tracing.span("search.traverse"):
            cand_ids, cand_d, (iters, fetched, pf_iter, pq_ct, trace,
                               hints) = traverse(index, luts, p)
        # dispatch picks the re-rank's kernel by the table's device
        with tracing.span("search.rerank",
                          {"fused": int(index.vectors.is_cuda)}):
            ids, dists, (batches, exact_ct) = rerank(
                index, queries.to(torch.float32), cand_ids, p)
    stats = SearchStats(iters, fetched, pf_iter, batches, exact_ct,
                        pq_ct, trace, hints)
    return ids, dists, stats


def search(index: DeviceIndex, queries, p: SearchParams, device=None):
    """Batched search -> (ids [nq, K], dists [nq, K], stats of [nq] each).
    Runs on the CUDA device unless ``device`` says otherwise."""
    return search_batched(index, queries, p, device)


def search_one(index: DeviceIndex, query, p: SearchParams, device=None):
    """Single-query search: the nq=1 case of the batch-first path."""
    ids, dists, stats = search(index, torch.as_tensor(query)[None], p,
                               device)
    return ids[0], dists[0], SearchStats(*(x[0] for x in stats))


def search_candidates(index: DeviceIndex, queries, p: SearchParams,
                      device=None):
    """Batched traversal WITHOUT the re-rank phase ->
    (cand_ids [nq, L], pq_dists [nq, L]), -1 = empty slot: the §3.5 insert
    path's candidate pool. Distances are PQ (ADC) approximations."""
    queries = _on_device(index, queries, device)
    with tracing.span("search.lut"):
        luts = build_lut_torch(queries, index.pq_centroids)
    with tracing.span("search.traverse"):
        cand_ids, cand_d, _ = traverse(index, luts, p)
    return cand_ids, cand_d


def search_vmapped(index: DeviceIndex, queries, p: SearchParams,
                   device=None):
    """The per-query baseline (the reference's vmap of a solo search): one
    nq=1 ``search_batched`` call a query, results and stats stacked ->
    (ids [nq, K], dists [nq, K], SearchStats of [nq]). Each row equals the
    batched search's row, since a batch row's trajectory is its solo run."""
    queries = _on_device(index, queries, device)
    runs = [search_batched(index, queries[i:i + 1], p, device)
            for i in range(queries.shape[0])]
    ids, dists, stats = zip(*runs)
    return (torch.cat(ids), torch.cat(dists),
            SearchStats(*(torch.cat(f) for f in zip(*stats))))
