"""Host-side search engines with block-level I/O accounting — the port of
``repro.core.search.engine`` (all numpy, over the port's stores).

These mirror the systems compared in the paper's evaluation:

- ``colocated`` + ``pipelined=False``  -> DiskANN   (blocking beam reads)
- ``colocated`` + ``pipelined=True``   -> PipeANN   (I/O-compute overlap)
- ``decoupled`` + ``latency_aware=False`` -> "Decouple(Comp)" ablation arms
- ``decoupled`` + ``latency_aware=True``  -> DecoupleVS (§3.4 search path)

The device engine in ``beam.py`` is the data-plane implementation; this
host engine is the *I/O model* that produces the paper's
hardware-independent metrics (graph I/Os, vector I/Os, cache hits, CPU ops)
plus a documented latency model for QPS-style comparisons:

    round-trip block read  T_IO   = 80 µs   (NVMe 4 KiB random read)
    PQ distance            T_PQ   = 0.05 µs
    exact distance         T_EX   = 0.10 µs
    list/vector decompress T_DEC  = 0.20 µs  (per record, paper Table 3 scale)

Blocking engines pay T_IO per beam round; pipelined engines overlap compute
with I/O (latency = max(io, cpu) per round + tail); DecoupleVS additionally
removes vector reads from the traversal critical path (§3.4) so they only
contribute if re-ranking outlasts traversal.

The port's stores return tensors where the reference's return numpy
(``DecoupledVectorStore.get``, a tensor-backed ``ColocatedStore``); the
engines bring those rows to the host once per read.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

import torch

from ..graph.pq import PQCodebook, adc_lookup_np, build_lut

T_IO = 80.0
T_IO_WRITE = 20.0    # µs per queued 4 KiB NVMe block write (merge path)

# Compute costs (µs/op) of the latency model: the paper's CPU
# implementation, the reference's ``ref`` row. The card's kernels are
# priced the same, so no modeled latency claims a speed-up nobody measured.
T_PQ = 0.05
T_EX = 0.10
T_DEC = 0.20

# Per-codec decode cost (µs/record) — the manifest-resolved replacement for
# the single hard-coded T_DEC: once the compression planner has picked a
# codec per component (StorageManifest), the latency model prices each
# tier's decompressions with ITS codec.
CODEC_DEC_US = {
    "raw": 0.0,                  # memcpy only — no decode on the critical path
    "bitpack": 0.05,             # fixed-width shifts/masks
    "elias_fano": 0.20,          # select-in-bitmap + low-bit unpack
    "huffman": 0.20,             # table-driven byte decode (paper Table 3)
    "xor_delta_huffman": 0.25,   # huffman + the XOR un-delta pass
    "plane_huffman": 0.20,       # same LUT decode, table keyed by plane
    "delta_varint": 0.10,        # byte-aligned LEB128 prefix sums
    "ans_id": 0.30,              # rANS state walk + extra-bit unpack
}


def t_dec_for(codec: str) -> float:
    """µs to decode one record of a component stored under ``codec``.
    Unknown codec names raise — a typo silently priced as raw would make
    the latency model lie."""
    if codec not in CODEC_DEC_US:
        raise ValueError(f"unknown codec {codec!r} in the cost model; "
                         f"expected {tuple(CODEC_DEC_US)}")
    return CODEC_DEC_US[codec]


def manifest_dec_costs(manifest) -> tuple[float, float]:
    """(t_dec_index, t_dec_vector) in µs from a manifest's resolved codecs
    (adjacency + vector_chunks components; a missing manifest prices both
    at the legacy T_DEC; absent components price at the layer defaults:
    elias_fano index records, xor_delta_huffman vector records)."""
    if manifest is None:
        return T_DEC, T_DEC
    return (t_dec_for(manifest.codec_for("adjacency", "elias_fano")),
            t_dec_for(manifest.codec_for("vector_chunks",
                                         "xor_delta_huffman")))


@dataclass(frozen=True)
class ServiceModel:
    """Linear modeled batch-service time — the admission tier's slack hook.

    ``service_us(n) = base_us + per_query_us * n`` where ``per_query_us`` is
    the I/O-model per-query latency (T_IO/T_PQ/T_EX/T_DEC pricing, typically
    calibrated from a probe batch via :func:`service_model_from_report`) and
    ``base_us`` is the per-cut overhead (dispatch + global merge, defaulting
    to one NVMe round trip). The admission loop (``serve/admission.py``)
    uses ``latest_cut_us`` to decide when the oldest queued request's slack
    runs out: a batch of n must be cut no later than
    ``deadline_us - service_us(n)`` to have any modeled chance of meeting
    its deadline. Pure arithmetic on the simulated clock — no wall time.
    """
    per_query_us: float
    base_us: float = T_IO

    def service_us(self, n: int) -> float:
        """Modeled service time for a batch of ``n`` queries, in µs."""
        return self.base_us + self.per_query_us * max(0, int(n))

    def latest_cut_us(self, deadline_us: float, n: int) -> float:
        """Latest simulated time a batch of ``n`` containing a request with
        this deadline can be cut and still be modeled to meet it."""
        return deadline_us - self.service_us(max(1, int(n)))

    def slack_us(self, deadline_us: float, now_us: float, n: int) -> float:
        """Remaining slack (µs, may be negative) for a request with this
        deadline if a batch of ``n`` were cut at ``now_us``."""
        return self.latest_cut_us(deadline_us, n) - now_us


def service_model_from_report(report, base_us: float = T_IO) -> ServiceModel:
    """Calibrate a :class:`ServiceModel` from a probe batch's
    ``BatchReport`` (serve/ann.py): the mean modeled per-query latency —
    already priced at the manifest's codecs — becomes the per-query coefficient. Deterministic: the modeled
    latency is a pure function of the fetch trace, not of wall time."""
    per_q = float(getattr(report, "modeled_latency_us", 0.0))
    if per_q <= 0.0:
        raise ValueError("probe report carries no modeled latency; run the "
                         "probe with ServeConfig(account_io=True)")
    return ServiceModel(per_query_us=per_q, base_us=float(base_us))


def merge_cost_us(blocks_written: int, lists_reencoded: int) -> float:
    """Model one §3.5 merge's index-store cost from its DIRTY-BLOCK count.

    The incremental path (``CompressedIndexStore.rewrite_blocks``) writes
    only the blocks whose adjacency lists changed plus fresh tail blocks, so
    merge I/O is ``blocks_written * T_IO_WRITE``; each re-encoded list is
    priced like a record (de)compression (T_DEC). A full rebuild is the same formula with every block dirty — which is exactly
    why dirty-block accounting matters for the paper's write-amp claim.
    """
    return blocks_written * T_IO_WRITE + lists_reencoded * T_DEC


# Cross-shard top-K merge pricing (the hierarchical merge of the sharded
# index): each gathered (id, dist) row is ~12 B over the interconnect,
# priced per row received; every collective stage (one ppermute step, or the
# single flat all_gather) adds a launch latency. The row counts mirror the
# reference's ``merge_comm_rows`` — flat receives K·S rows in one stage, the
# butterfly receives K·log2(axis) rows over log2(axis) stages per mesh axis,
# so flat wins at tiny S (fewer launches) and the tree wins once K·S row
# traffic dominates.
T_MERGE_ROW_US = 0.05
T_MERGE_STAGE_US = 2.0


def shard_merge_cost_us(k: int, axis_sizes, mode: str = "hier",
                        t_row: float = T_MERGE_ROW_US,
                        t_stage: float = T_MERGE_STAGE_US) -> float:
    """Modeled per-query cost (µs) of the cross-shard top-K merge over mesh
    axes of the given sizes. Mirrors ``merge_comm_rows``: non-power-of-two
    axes fall back to a flat gather for that axis."""
    sizes = [int(s) for s in (axis_sizes if np.ndim(axis_sizes) else
                              [axis_sizes])]
    if mode == "flat":
        return k * int(np.prod(sizes)) * t_row + t_stage
    if mode != "hier":
        raise ValueError(f"merge mode must be 'hier' or 'flat', got {mode!r}")
    rows = stages = 0
    for s in sizes:
        if s <= 1:
            continue
        if s & (s - 1):                 # non-pow2 axis: flat on this axis
            rows += k * s
            stages += 1
        else:
            st = int(round(np.log2(s)))
            rows += k * st
            stages += st
    return rows * t_row + stages * t_stage


def merge_topk(ids, dists, k: int):
    """[S, nq, K] per-shard globally-translated ids + dists -> global top-K
    (host-side mirror of the gather + top_k merge that runs inside
    shard_map on a mesh; also merges the §3.5 memtable side-scan "shard"
    with graph results). Stable sort: earlier shards win ties, and inf
    distances (padding / tombstone-masked rows) sink to the tail."""
    s, nq, kk = ids.shape
    flat_i = ids.transpose(1, 0, 2).reshape(nq, s * kk)
    flat_d = dists.transpose(1, 0, 2).reshape(nq, s * kk)
    order = np.argsort(flat_d, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(flat_i, order, 1),
            np.take_along_axis(flat_d, order, 1))


@dataclass
class QueryStats:
    graph_ios: int = 0              # DEMAND-equivalent graph block reads
                                    # (wasted speculative reads excluded —
                                    # reported in prefetch_wasted)
    vector_ios: int = 0
    cache_hits: int = 0
    pq_ops: int = 0
    exact_ops: int = 0
    decompressions: int = 0         # graph_decs + vector_decs
    graph_decs: int = 0             # adjacency-record decodes (index tier)
    vector_decs: int = 0            # vector-record decodes (data tier)
    traversal_rounds: int = 0
    io_rounds: int = 0              # rounds with >=1 STALLING block read
                                    # (prefetch-covered rounds excluded)
    rerank_batches: int = 0
    latency_us: float = 0.0
    blocks_per_hop: float = 0.0     # graph block reads / traversal round —
                                    # the locality metric reordering shrinks
    # Speculative multi-hop prefetch (the I/O pipeline's warm path):
    prefetch_issued: int = 0        # speculative block reads issued
    prefetch_hits: int = 0          # speculations consumed by a demand read
    prefetch_wasted: int = 0        # speculations never consumed (<= budget)
    covered_rounds: int = 0         # rounds whose every fetch was
                                    # prefetch-served (no stall: in the
                                    # blocking run these rounds pay T_IO)
    overlap_saved_us: float = 0.0   # blocking price of the same traversal
                                    # (covered rounds stall, io+cpu serial)
                                    # minus the overlapped price; >= 0


@dataclass
class EngineConfig:
    l_size: int = 100
    beam_width: int = 4
    k: int = 10
    rerank_batch: int = 10          # B
    benefit_threshold: float = 0.01
    pipelined: bool = False
    latency_aware: bool = False     # §3.4 differentiated I/O + prefetch
    compressed: bool = False        # index/vector decompression accounting
    manifest: object = None         # StorageManifest: price each tier's
                                    # T_DEC from its resolved codec
                                    # (CODEC_DEC_US) instead of one constant
    prefetch_depth: int = 0         # >0: speculative multi-hop prefetch —
                                    # issue hop k+1's provisional frontier
                                    # blocks while hop k reranks, window
                                    # bounded to this many blocks
    prefetch_budget: int = 32       # max wasted speculations per query
    pricing: str = "legacy"         # latency model: "legacy" keeps each
                                    # arm's historical formula; "blocking"
                                    # prices every stall serially
                                    # (io + cpu); "pipelined_overlap"
                                    # prices each stalled round at
                                    # max(T_IO_eff, compute) + a pipeline
                                    # fill term (see PRICING_MODES)


#: Valid EngineConfig.pricing modes (validated at search time — a typo
#: silently priced as legacy would make arm comparisons lie).
PRICING_MODES = ("legacy", "blocking", "pipelined_overlap")


def _host(x) -> np.ndarray:
    """A store's rows as a host array (tensors are copied to the host)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _CandidateList:
    """Sorted candidate list of bounded size (DiskANN search state)."""

    def __init__(self, l_size: int):
        self.l = l_size
        self.items: list[tuple[float, int]] = []   # (dist, id) sorted
        self.expanded: set[int] = set()
        self.seen: set[int] = set()

    def push(self, d: float, vid: int) -> None:
        if vid in self.seen:
            return
        self.seen.add(vid)
        lo, hi = 0, len(self.items)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.items[mid][0] < d:
                lo = mid + 1
            else:
                hi = mid
        self.items.insert(lo, (d, vid))
        del self.items[self.l:]

    def next_frontier(self, w: int) -> list[int]:
        out = []
        for d, vid in self.items:
            if vid not in self.expanded:
                out.append(vid)
                if len(out) >= w:
                    break
        return out

    def top_ids(self, k: int) -> list[int]:
        return [vid for _, vid in self.items[:k]]


def _traverse(store_get_neighbors, pq_codes: np.ndarray, lut: np.ndarray,
              medoid: int, cfg: EngineConfig, st: QueryStats,
              colocated_vectors: dict | None = None,
              store_get_record=None, io=None, store=None,
              cache=None, prefetch_hint=None) -> _CandidateList:
    # Stores exposing get_neighbors_batch (CompressedIndexStore) serve each
    # beam round as ONE batched fetch with block dedup: frontier lists that
    # share a 4 KiB block cost one read — after locality reordering that is
    # the common case (blocks-per-hop < beam width). Decode + expansion
    # accounting per vertex is unchanged either way.
    #
    # Speculative multi-hop prefetch (prefetch_hint set): at the end of hop
    # k — while its distances compute — the engine issues the blocks that
    # hop k+1's PROVISIONAL frontier (the top-W unexpanded candidates
    # *before* hop k's discoveries are pushed) would touch. Genuine
    # speculation: a vertex hop k discovers that displaces the provisional
    # frontier makes those issues waste. Prefetch only warms the residency
    # window consulted for stall accounting — traversal, ids and distances
    # are bit-identical with prefetch on or off, by construction.
    batch_fetch = getattr(store, "get_neighbors_batch", None) \
        if store_get_record is None else None
    cl = _CandidateList(cfg.l_size)
    d0 = float(adc_lookup_np(pq_codes[medoid][None, :], lut)[0])
    st.pq_ops += 1
    cl.push(d0, medoid)
    stability = 0
    prefetch_at = -1
    kb_prev: tuple = ()
    while True:
        frontier = cl.next_frontier(cfg.beam_width)
        if not frontier:
            break
        st.traversal_rounds += 1
        for vid in frontier:
            cl.expanded.add(vid)
        # Hop k+1's provisional frontier, read BEFORE this hop's pushes.
        provisional = cl.next_frontier(cfg.beam_width) \
            if prefetch_hint is not None else None
        reads_before = io.reads if io is not None else 0
        miss_before = cache.misses if cache is not None else None
        pfh_before = cache.prefetch_hits if cache is not None else 0
        fetched_lists = batch_fetch(frontier) if batch_fetch is not None \
            else None
        for vid in frontier:
            if store_get_record is not None:             # co-located read
                vec, nbrs = store_get_record(vid)
                nbrs = _host(nbrs)
                colocated_vectors[vid] = vec
            else:
                nbrs = fetched_lists[vid] if fetched_lists is not None \
                    else store_get_neighbors(vid)
                if cfg.compressed:
                    st.decompressions += 1
                    st.graph_decs += 1
            new = [v for v in nbrs if v not in cl.seen]
            if new:
                nd = adc_lookup_np(pq_codes[np.asarray(new, np.int64)], lut)
                st.pq_ops += len(new)
                for v, d in zip(new, nd):
                    cl.push(float(d), int(v))
        if prefetch_hint is not None:
            # Issued after this hop's demand reads (which entered the
            # residency window) so speculation never re-reads them.
            st.prefetch_issued += prefetch_hint(provisional)
        if cache is not None:
            # Stall-or-not per round from the cache's classification: a
            # remaining miss means a demand block read stalled the round; a
            # round whose every fetch reclassified to prefetch-hit was
            # fully covered by speculative reads already in flight.
            if cache.misses > miss_before:
                st.io_rounds += 1
            elif cache.prefetch_hits > pfh_before:
                st.covered_rounds += 1
        elif io is not None and io.reads > reads_before:
            st.io_rounds += 1       # this round stalls on at least one read
        kb_now = tuple(cl.top_ids(cfg.k + cfg.rerank_batch))
        if kb_now == kb_prev:
            stability += len(frontier)
            if stability >= cfg.rerank_batch and prefetch_at < 0:
                prefetch_at = st.traversal_rounds
        else:
            stability = 0
        kb_prev = kb_now
    st.prefetch_round = prefetch_at
    return cl


def _enable_prefetch(store, cfg: EngineConfig):
    """Resolve the store's speculative-read hook for this search: returns
    (hint_fn, queue) or (None, None) when prefetch is off or the store
    does not support it. Draining is the caller's job (end of query)."""
    if cfg.prefetch_depth <= 0:
        return None, None
    enable = getattr(store, "enable_prefetch", None)
    if enable is None:
        return None, None
    q = enable(cfg.prefetch_depth, cfg.prefetch_budget)
    return store.prefetch_hint, q


def search_decoupled(index_store, vector_store, pq_codes: np.ndarray,
                     cb: PQCodebook, query: np.ndarray, cfg: EngineConfig
                     ) -> tuple[np.ndarray, QueryStats]:
    """DecoupleVS / Decouple / DecoupleComp search paths."""
    st = QueryStats()
    _check_pricing(cfg)
    hint, pfq = _enable_prefetch(index_store, cfg)
    pf0 = pfq.snapshot() if pfq is not None else None
    io0 = index_store.io.snapshot()
    vio0 = vector_store.io.snapshot()
    h0 = index_store.cache.hits
    lut = build_lut(query, cb)
    cl = _traverse(index_store.get_neighbors, pq_codes, lut,
                   index_store.medoid, cfg, st, io=index_store.io,
                   store=index_store, cache=index_store.cache,
                   prefetch_hint=hint)
    K, B = cfg.k, cfg.rerank_batch
    cand = cl.top_ids(cfg.l_size)

    def exact(ids: list[int]) -> np.ndarray:
        vecs = _host(vector_store.get(np.asarray(ids, np.int64))
                     ).astype(np.float32)
        st.exact_ops += len(ids)
        if cfg.compressed:
            st.decompressions += len(ids)
            st.vector_decs += len(ids)
        return ((vecs - query[None].astype(np.float32)) ** 2).sum(-1)

    if cfg.latency_aware:
        # Phase 1 prefetched top-K; phase 2 adaptive batches (§3.4).
        heap = list(zip(exact(cand[:K]).tolist(), cand[:K]))
        heap.sort()
        b = 0
        stop_after = None   # §3.4: next batch is already in flight when the
        while K + (b + 1) * B <= len(cand):   # benefit test fires (lookahead)
            ids = cand[K + b * B: K + (b + 1) * B]
            d = exact(ids)
            st.rerank_batches += 1
            displaced = 0
            for dd, vid in zip(d.tolist(), ids):
                if dd < heap[-1][0]:
                    heap.append((dd, vid))
                    heap.sort()
                    heap = heap[:K]
                    displaced += 1
            b += 1
            if stop_after is not None and b >= stop_after:
                break
            if displaced / B < cfg.benefit_threshold and stop_after is None:
                stop_after = b + 1
    else:
        # Baseline (DiskANN §2.2): re-rank EVERY visited (expanded) vertex
        # with full-precision vectors, not just the final top of the list.
        ids = sorted(cl.expanded)
        d = exact(ids)
        heap = sorted(zip(d.tolist(), ids))[:K]
        st.rerank_batches = -(-len(ids) // B)

    io1 = index_store.io.snapshot()
    vio1 = vector_store.io.snapshot()
    st.graph_ios = io1["reads"] - io0["reads"]
    st.vector_ios = vio1["reads"] - vio0["reads"]
    st.cache_hits = index_store.cache.hits - h0
    if pfq is not None:
        index_store.drain_prefetch()
        pf1 = pfq.snapshot()
        st.prefetch_hits = pf1["hits"] - pf0["hits"]
        st.prefetch_wasted = pf1["wasted"] - pf0["wasted"]
        # Demand-equivalent graph I/O: a consumed speculation replaced the
        # demand read it pre-empted, so only wasted issues are extra.
        st.graph_ios -= st.prefetch_wasted
    st.blocks_per_hop = st.graph_ios / max(1, st.traversal_rounds)
    st.latency_us = _latency_decoupled(st, cfg)
    return np.asarray([vid for _, vid in heap], np.int64), st


def search_colocated(store, pq_codes: np.ndarray, cb: PQCodebook,
                     query: np.ndarray, cfg: EngineConfig
                     ) -> tuple[np.ndarray, QueryStats]:
    """DiskANN (blocking) / PipeANN (pipelined) search on co-located layout."""
    st = QueryStats()
    _check_pricing(cfg)
    hint, pfq = _enable_prefetch(store, cfg)
    pf0 = pfq.snapshot() if pfq is not None else None
    io0 = store.io.snapshot()
    h0 = store.cache.hits
    lut = build_lut(query, cb)
    fetched: dict[int, np.ndarray] = {}
    cl = _traverse(None, pq_codes, lut, store.medoid, cfg, st,
                   colocated_vectors=fetched, store_get_record=store.get_record,
                   io=store.io, cache=store.cache, prefetch_hint=hint)
    # Final re-rank over the vectors already co-fetched during traversal.
    ids = [vid for vid in cl.top_ids(cfg.l_size) if vid in fetched]
    vecs = np.stack([_host(fetched[i]) for i in ids]).astype(np.float32)
    d = ((vecs - query[None].astype(np.float32)) ** 2).sum(-1)
    st.exact_ops += len(ids)
    heap = sorted(zip(d.tolist(), ids))[:cfg.k]
    io1 = store.io.snapshot()
    st.graph_ios = io1["reads"] - io0["reads"]
    st.cache_hits = store.cache.hits - h0
    if pfq is not None:
        store.drain_prefetch()
        pf1 = pfq.snapshot()
        st.prefetch_hits = pf1["hits"] - pf0["hits"]
        st.prefetch_wasted = pf1["wasted"] - pf0["wasted"]
        # Each wasted issue read a whole page group on this layout.
        st.graph_ios -= st.prefetch_wasted * store.blocks_per_record
    st.blocks_per_hop = st.graph_ios / max(1, st.traversal_rounds)
    st.latency_us = _latency_colocated(st, cfg)
    return np.asarray([vid for _, vid in heap], np.int64), st


def _cpu_us(st: QueryStats, cfg: EngineConfig | None = None) -> float:
    if cfg is not None and cfg.manifest is not None:
        # Component-aware pricing: each tier's decodes cost what ITS
        # manifest-resolved codec costs (raw = free, EF/Huffman = T_DEC
        # scale) instead of one per-arm constant.
        t_dec_ix, t_dec_vec = manifest_dec_costs(cfg.manifest)
        dec_us = st.graph_decs * t_dec_ix + st.vector_decs * t_dec_vec
    else:
        dec_us = st.decompressions * T_DEC
    return st.pq_ops * T_PQ + st.exact_ops * T_EX + dec_us


def rerank_tail_us(rerank_batches: int) -> float:
    """§3.4 rerank tail in µs: with the next batch always in flight
    (lookahead prefetch), only the batches beyond the first outlast
    traversal, each half-overlapped with the previous batch's read. The
    ONE pricing of that term — the engine's latency model and the serving
    tier's trace replay (serve/ann.py) both call this, so the two paths
    cannot drift."""
    return max(0, int(rerank_batches) - 1) * T_IO * 0.5


def _check_pricing(cfg: EngineConfig) -> None:
    if cfg.pricing not in PRICING_MODES:
        raise ValueError(f"unknown pricing mode {cfg.pricing!r}; "
                         f"expected {PRICING_MODES}")


def _overlap_us(st: QueryStats, io: float, cpu: float) -> float:
    """"pipelined_overlap" traversal price: stalled rounds overlap with
    compute — round cost max(T_IO_eff, compute) — plus a pipeline fill
    term when any round was prefetch-covered (the first covered round's
    speculative read was issued only one hop ahead, so on average it is
    half a block read short of resident when demanded). Covered rounds
    themselves pay NO T_IO: ``io`` here already counts stalling rounds
    only. Records on ``st`` the saving vs the "blocking" price of the
    identical traversal — where covered rounds stall too (the
    io_rounds_blocking = io_rounds + covered_rounds identity) and io+cpu
    serialize — which is >= 0 by construction."""
    fill = 0.5 * T_IO if st.covered_rounds > 0 else 0.0
    out = max(io, cpu) + fill
    st.overlap_saved_us = (io + st.covered_rounds * T_IO + cpu) - out
    return out


def _latency_colocated(st: QueryStats, cfg: EngineConfig) -> float:
    # W reads per round are issued in parallel; rounds fully served by the
    # LRU cache do not stall (cache-hit fast path).
    io = st.io_rounds * T_IO
    cpu = _cpu_us(st, cfg)
    if cfg.pricing == "blocking":
        return io + cpu
    if cfg.pricing == "pipelined_overlap":
        return _overlap_us(st, io, cpu)
    return max(io, cpu) + min(io, cpu) * 0.1 if cfg.pipelined else io + cpu


def _latency_decoupled(st: QueryStats, cfg: EngineConfig) -> float:
    io = st.io_rounds * T_IO
    cpu = _cpu_us(st, cfg)
    if cfg.latency_aware:
        # Vector I/O off the critical path (§3.4): only the final rerank
        # batches that outlast traversal add latency.
        tail = rerank_tail_us(st.rerank_batches)
    else:
        # Vector reads serialize after traversal (Exp#1 "Decouple" penalty).
        tail = st.vector_ios * T_IO / max(1, cfg.beam_width)
    if cfg.pricing == "blocking":
        return io + cpu + tail
    if cfg.pricing == "pipelined_overlap":
        return _overlap_us(st, io, cpu) + tail
    return max(io, cpu) + min(io, cpu) * 0.1 + tail
