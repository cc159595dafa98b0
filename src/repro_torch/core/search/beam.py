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
run. The reference's two ``lax.while_loop``s are host loops here that stop
when no row is active (one device-to-host read of that flag per
iteration). On the card the traversal's rounds after the first replay a
CUDA graph of one round (``_capture``), so a round costs the host one
launch, not ~50 op dispatches; ``kernels.build.LAUNCHES`` counts a
captured kernel once. Every top-k is a stable ascending sort
(``stable_smallest``): ``lax.top_k`` breaks ties to the lower index and
``torch.topk`` does not.
Scatters the reference writes with ``mode="drop"`` to index ``n`` / ``H``
write into one padding column here, which no read looks at.

The compute ops — batched PQ ADC, EF slot decode, the fused hop and the
exact re-rank — go through ``kernels.dispatch``: a CUDA kernel on a CUDA
index, the plain PyTorch version on a CPU index. Each takes the shard's
table and the ids of the rows it reads, so no row gather precedes it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ... import tracing
from ...kernels import dispatch
from ...kernels.beam_step.beam_step import lut_slices, stable_smallest
from ...kernels.dispatch import (KernelConfig, resolve_backend,
                                 resolve_device)
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
    kernels: KernelConfig | None = None  # per-op request (dispatch layer);
                                 # None -> KernelConfig() (all "auto")
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


def check_kernels(p: SearchParams) -> SearchParams:
    """Fill ``p.kernels`` (None -> all ``auto``) and check its values: the
    search's own check. An ``auto-tuned`` entry raises here, since it
    resolves only at config time (:func:`resolve_kernels`)."""
    k = (p.kernels or KernelConfig()).check()
    if "auto-tuned" in k:
        raise RuntimeError(
            "unresolved 'auto-tuned' kernel request: resolve the config "
            "once at config time (resolve_kernels, KernelConfig.resolve)")
    return p if k == p.kernels else p._replace(kernels=k)


def resolve_kernels(p: SearchParams, device=None, shapes: dict | None = None,
                    cache=None) -> SearchParams:
    """Fill ``p.kernels`` (None -> all ``auto``) and check its values; an
    ``auto-tuned`` entry resolves here, once, for tensors on ``device``
    (None = the card) per (op, shape-bucket) from the autotune cache
    (``shapes``: op name -> dims dict, as the reference takes it;
    ``cache``: an ``AutotuneCache`` or its path, None = the committed
    one)."""
    k = (p.kernels or KernelConfig()).check()
    if "auto-tuned" in k:
        k = k.resolve(resolve_device(device), shapes, cache)
    return p if k == p.kernels else p._replace(kernels=k)


def _hash_slots(ids: torch.Tensor, bits: int) -> torch.Tensor:
    """Multiplicative hash of non-negative ids into ``2**bits`` slots —
    the reference's uint32 product, in int64."""
    h = (ids.to(torch.int64) * 2654435761) & 0xFFFFFFFF
    return h >> (32 - bits)


def _gather_neighbors(index: DeviceIndex, sel_ids: torch.Tensor,
                      p: SearchParams, n: int) -> torch.Tensor:
    """[nq, W] vertex ids -> [nq, W * r_max] neighbour ids (-1 = invalid)."""
    nq = sel_ids.shape[0]
    valid_sel = sel_ids >= 0
    if p.use_ef:
        universe = p.universe or n
        # the kernel reads each slot by id, clipped to the table
        vals, cnts = dispatch.ef_decode(index.ef_slots, p.r_max, universe,
                                        p.kernels, ids=sel_ids.reshape(-1))
        j = torch.arange(p.r_max, device=vals.device)
        nbrs = torch.where(j[None, :] < cnts[:, None], vals, -1)
        nbrs = nbrs.reshape(sel_ids.shape + (p.r_max,))
    else:
        nbrs = index.neighbors[sel_ids.clamp(0, n - 1)]
    nbrs = torch.where(valid_sel[..., None], nbrs, -1)
    return nbrs.reshape(nq, -1)


def _last_write_wins(slots: torch.Tensor, ok: torch.Tensor,
                     pad: int) -> torch.Tensor:
    """Mask of the ``ok`` entries that own their slot: where several ok
    entries of a row share a slot, the last one (highest column) — the
    entry XLA's sequential scatter leaves in place."""
    key = torch.where(ok, slots, pad)
    sorted_key, order = torch.sort(key, dim=1, stable=True)
    last = torch.ones_like(ok)
    last[:, :-1] = sorted_key[:, 1:] != sorted_key[:, :-1]
    return torch.zeros_like(ok).scatter_(1, order, last) & ok


def _any(flag: torch.Tensor) -> bool:
    """``flag.any()`` read back to the host: the loops' one blocking read
    a round."""
    with tracing.span("search.sync"):
        return bool(flag.any())


def _graphable(luts: torch.Tensor, p: SearchParams) -> bool:
    """A round can be captured: it runs on the card, reads nothing back to
    the host (no trace buffers, whose writes are masked by row) and keeps
    its visited set in the hash table (the dense set's index writes are
    left to the plain loop), with every dispatched op a CUDA kernel."""
    if not luts.is_cuda or p.trace_fetches or p.trace_hints \
            or p.visited_hash_bits <= 0:
        return False
    ops = [("ef_decode", p.kernels.ef_decode)] if p.use_ef else []
    ops.append(("beam_step", p.kernels.beam_step)
               if p.kernels.beam_step != "off"
               else ("pq_adc_batched", p.kernels.pq_adc))
    return all(resolve_backend(req, luts.device, op) == "cuda"
               for op, req in ops)


#: Per device: the memory pool of the traversal's graphs and the last graph
#: captured into it, held until the next capture has taken the pool over
#: (the graphs share it one after another, never at once).
_GRAPHS: dict = {}


def _capture(step, state: tuple):
    """``step`` (state -> next state, its last entry the active rows)
    captured as one CUDA graph that also writes the next state over
    ``state``'s tensors and whether any row is active into a flag ->
    (replay, flag)."""
    dev = state[0].device
    held = _GRAPHS.get(dev)
    pool = held[0] if held else torch.cuda.graph_pool_handle()
    g = torch.cuda.CUDAGraph()
    here = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(here)
    flag = torch.empty((), dtype=torch.bool, device=dev)
    with tracing.span("search.capture"), torch.cuda.stream(side):
        g.capture_begin(pool=pool, capture_error_mode="thread_local")
        out = step(*state)
        for old, new in zip(state, out):
            if new is not old:
                old.copy_(new)
        flag.copy_(out[-1].any())
        del out
        g.capture_end()
    here.wait_stream(side)
    _GRAPHS[dev] = (pool, g)
    return g.replay, flag


def traverse(index: DeviceIndex, luts: torch.Tensor, p: SearchParams):
    """Batched beam traversal: per-query LUTs [nq, M, K] ->
    (cand_ids [nq, L], cand_d [nq, L], (iters, fetched, pf_iter, pq, trace,
    hints)).

    On the card (where :func:`_graphable`) the rounds after the
    first replay one CUDA graph of a round, so the host issues one launch
    a round instead of the round's ~50 ops; the kernels and their order
    are the same, so are the results, bit for bit.

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
    # the slices the fused hop's CUDA kernel stages a LUT in (1 elsewhere)
    hop = {"m": m, "lut_bytes": m * k * 4,
           "lut_slices": (lut_slices(m, k, e, L)
                          if luts.is_cuda and p.kernels.beam_step != "off"
                          else 1)}

    entry = index.medoid.to(torch.int32).expand(nq).contiguous()
    e_d = dispatch.pq_adc_batched(index.pq_codes, luts, p.kernels,
                                  ids=entry[:, None])[:, 0]
    cand_ids = torch.full((nq, L), -1, dtype=torch.int32, device=dev)
    cand_ids[:, 0] = entry
    cand_d = torch.full((nq, L), torch.inf, dtype=torch.float32, device=dev)
    cand_d[:, 0] = e_d
    if use_hash:
        H = 1 << p.visited_hash_bits
        # column H is the "nowhere" of the reference's mode="drop" scatters
        visited = torch.full((nq, H + 1), -1, dtype=torch.int32, device=dev)
        visited[rows, _hash_slots(entry, p.visited_hash_bits)] = entry
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

    def _unexpanded(cand_ids, expanded):
        valid = cand_ids >= 0
        if use_hash:
            return valid & ~expanded
        return valid & ~torch.gather(expanded, 1,
                                     cand_ids.clamp(0, n - 1).long())

    def _frontier(cand_ids, expanded, iters):
        # (unexpanded slots, active rows) of the candidate lists
        unexp = _unexpanded(cand_ids, expanded)
        return unexp, unexp.any(1) & (iters < p.max_iters)

    def _record(buf, ids, iters):
        # the reference's trace.at[rows, iters].set(ids, mode="drop")
        ok = iters < buf.shape[1]
        buf[rows[ok], iters[ok].long()] = ids[ok]

    def _round(cand_ids, cand_d, expanded, iters, stab, pf_iter, prev_top,
               unexp, active):
        # one expansion of every active row; fetched, pq_ct, visited and
        # the trace buffers are updated in place
        with tracing.span("search.round"):
            frontier_d = torch.where(unexp & active[:, None], cand_d,
                                     torch.inf)
            sel_d, sel_slot = stable_smallest(frontier_d, W)    # [nq, W]
            sel_ids = torch.where(torch.isfinite(sel_d),
                                  torch.gather(cand_ids, 1, sel_slot), -1)
            if use_hash:
                expanded = expanded.scatter(
                    1, sel_slot, torch.gather(expanded, 1, sel_slot)
                    | (sel_ids >= 0))
            else:
                expanded[rows[:, None], torch.where(sel_ids >= 0, sel_ids,
                                                    n).long()] = True
            fetched.add_((sel_ids >= 0).sum(1, dtype=torch.int32))
            if p.trace_fetches:
                _record(trace, sel_ids, iters)
            if p.trace_hints:
                # Provisional frontier for round r+1, read BEFORE this
                # round's neighbours merge: the top-W unexpanded survivors
                # of the list.
                prov_d = torch.where(_unexpanded(cand_ids, expanded)
                                     & active[:, None], cand_d, torch.inf)
                prov_v, prov_slot = stable_smallest(prov_d, W)
                prov_ids = torch.where(
                    torch.isfinite(prov_v),
                    torch.gather(cand_ids, 1, prov_slot), -1)
                _record(hints, prov_ids, iters)

            nbrs = _gather_neighbors(index, sel_ids, p, n)        # [nq, W*R]
            # Dedupe within the round: sort + first occurrence.
            sorted_n = torch.sort(nbrs, dim=1).values
            first = torch.ones_like(sorted_n, dtype=torch.bool)
            first[:, 1:] = sorted_n[:, 1:] != sorted_n[:, :-1]
            uniq = torch.where(first, sorted_n, -1)
            if use_hash:
                slots = _hash_slots(uniq.clamp_min(0), p.visited_hash_bits)
                seen = torch.gather(visited, 1, slots) == uniq
                ok = (uniq >= 0) & ~seen
                win = _last_write_wins(slots, ok, H)
                visited.scatter_(1, torch.where(win, slots, H),
                                 torch.where(win, uniq, -1))
            else:
                seen = torch.gather(visited, 1, uniq.clamp(0, n - 1).long())
                ok = (uniq >= 0) & ~seen
                visited.scatter_(1, torch.where(ok, uniq, n).long(),
                                 torch.ones_like(ok))
            new_ids = torch.where(ok, uniq, -1)
            pq_ct.add_(ok.sum(1, dtype=torch.int32))

            with tracing.span("search.hop", hop):
                if p.kernels.beam_step != "off":
                    # the fused hop reads the code rows of new_ids itself
                    cand_ids, cand_d, top_i = dispatch.beam_step(
                        index.pq_codes, luts, cand_ids, cand_d, new_ids,
                        p.kernels)
                    top_i = top_i.long()
                else:
                    # the ADC reads the code rows of new_ids; +inf where
                    # masked
                    new_d = dispatch.pq_adc_batched(index.pq_codes, luts,
                                                    p.kernels, ids=new_ids)
                    merged_ids = torch.cat([cand_ids, new_ids], 1)
                    cand_d, top_i = stable_smallest(
                        torch.cat([cand_d, new_d], 1), L)
                    cand_ids = torch.gather(merged_ids, 1, top_i)
            if use_hash:
                merged_exp = torch.cat([expanded, torch.zeros_like(ok)], 1)
                expanded = torch.gather(merged_exp, 1, top_i)

            # §3.4 stability: top-(K+B) id set unchanged across expansions.
            top_now = torch.sort(cand_ids[:, :KB], dim=1).values
            same = (top_now == prev_top).all(1)
            stab = torch.where(active, torch.where(same, stab + W, 0),
                               stab)
            trigger = active & (stab >= p.rerank_batch) & (pf_iter < 0)
            pf_iter = torch.where(trigger, iters + 1, pf_iter)
            iters = iters + active.to(torch.int32)
            prev_top = torch.where(active[:, None], top_now, prev_top)
            unexp, active = _frontier(cand_ids, expanded, iters)
        return (cand_ids, cand_d, expanded, iters, stab, pf_iter, prev_top,
                unexp, active)

    unexp, active = _frontier(cand_ids, expanded, iters)
    state = (cand_ids, cand_d, expanded, iters, stab, pf_iter, prev_top,
             unexp, active)
    go = _any(active)
    if go and _graphable(luts, p):
        # the first round runs as it is written, the rest replay its
        # capture: one graph launch and one flag read a round
        state = _round(*state)
        go = _any(state[-1])
        if go:
            replay, flag = _capture(_round, state)
            while go:
                with tracing.span("search.round"):
                    replay()
                go = _any(flag)
    while go:
        state = _round(*state)
        go = _any(state[-1])
    cand_ids, cand_d, _, iters, _, pf_iter = state[:6]

    return cand_ids, cand_d, (iters, fetched, pf_iter, pq_ct + 1, trace,
                              hints)


def rerank(index: DeviceIndex, queries: torch.Tensor, cand_ids: torch.Tensor,
           p: SearchParams):
    """Batched phase-2 adaptive re-ranking (§3.4) ->
    (ids [nq, K], dists [nq, K], (batches [nq], exact_ct [nq])).

    All rows consume candidate batch b in lockstep; a row whose benefit
    ratio fired (plus the one-batch lookahead) drops out by masking, so its
    executed-batch count matches a solo run exactly.
    """
    n, K, B = index.vectors.shape[0], p.k, p.rerank_batch
    nq = queries.shape[0]
    dev = queries.device
    if p.filter_tombstones and index.tombstone is None:
        raise ValueError(
            "SearchParams.filter_tombstones=True requires an index with a "
            "tombstone mask (DeviceIndex.tombstone)")
    # Candidates beyond L don't exist; bound the batch loop statically.
    max_batches = min(p.max_rerank_batches, max(0, (p.l_size - K) // B))

    def exact(ids):
        safe = ids.clamp(0, n - 1)
        d = dispatch.rerank_l2(queries, index.vectors, p.kernels, ids=safe)
        if p.filter_tombstones:
            d = torch.where(index.tombstone[safe], torch.inf, d)
        return torch.where(ids >= 0, d, torch.inf)

    # Batch 0: the prefetched top-K (always re-ranked).
    heap_ids = cand_ids[:, :K]
    heap_d = exact(heap_ids)
    go = torch.ones((nq,), dtype=torch.bool, device=dev)
    pending_stop = torch.zeros((nq,), dtype=torch.bool, device=dev)
    batches = torch.zeros((nq,), dtype=torch.int32, device=dev)
    b = 0
    while b < max_batches and _any(go):
        ids = cand_ids[:, K + b * B:K + (b + 1) * B]
        d = torch.where(go[:, None], exact(ids), torch.inf)
        m_ids = torch.cat([heap_ids, ids], 1)
        new_d, top_i = stable_smallest(torch.cat([heap_d, d], 1), K)
        new_ids = torch.gather(m_ids, 1, top_i)
        displaced = (top_i >= K).sum(1).to(torch.float32)
        below = displaced / B < p.benefit_threshold
        heap_ids = torch.where(go[:, None], new_ids, heap_ids)
        heap_d = torch.where(go[:, None], new_d, heap_d)
        batches = batches + go.to(torch.int32)
        # one-batch lookahead (§3.4): the next batch is already in flight
        # when the benefit test fires, so termination lags one batch.
        go_next = go & (~pending_stop | ~below)
        pending_stop = torch.where(go, below, pending_stop)
        go = go_next
        b += 1
    dists, order = torch.sort(heap_d, dim=1, stable=True)
    ids = torch.gather(heap_ids, 1, order)
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
        p = check_kernels(p)
        with tracing.span("search.lut"):
            luts = build_lut_torch(queries, index.pq_centroids)
        with tracing.span("search.traverse"):
            cand_ids, cand_d, (iters, fetched, pf_iter, pq_ct, trace,
                               hints) = traverse(index, luts, p)
        with tracing.span("search.rerank"):
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
    p = check_kernels(p)
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
