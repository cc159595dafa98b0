"""The phase-2 re-rank (§3.4), its whole benefit-ratio loop, as one op:

    queries [Q, D] float32, vectors [N, D] uint8 or float32, cand_ids
    [Q, L] int32 (-1 = none), k, b, max_batches, threshold (compared in
    float32), tombstone [N] bool or None
    -> (heap_ids [Q, K'] int32, heap_d [Q, K'] float32, batches [Q] int32),
       K' = min(k, L)

Batch 0, ``cand_ids[:, :k]``, is always re-ranked; then, while a row
goes, batch ``i < max_batches`` (``b`` candidates) is re-ranked and merged
into the heap (a stable sort, ties to the lower position); a row stops
after two batches in a row each moved fewer than ``threshold`` of ``b``
into the heap (the one-batch lookahead). An id < 0, or tombstoned, reads
+inf. The heap comes back in ascending stable order.

``rerank_loop_ref`` is the loop ``core/search/beam.py::rerank`` ran
before it became one op: all rows consume batch i in lockstep, a row that
stopped is masked, and the host reads whether any row goes before each
batch (a ``search.sync`` span). Its distances are ``l2``: by default
``rerank_l2_ref``, plain PyTorch, so the loop stays independent of the
kernel it checks (which shares ``rerank_l2``'s fold). Before this op the
search ran the loop on the card with the ``rerank_l2`` kernel as ``l2``,
which is how chip_smoke times it.
``rerank_loop_cuda`` launches ``csrc/rerank_loop.cu`` once: a warp per
row runs the row's own loop, its distances the ``rerank_l2`` fold
(``csrc/rerank_rows.cuh``), so the two are bit-identical and the host
reads nothing. It replaces no TPU kernel: the reference's re-rank is a
``lax.while_loop`` around its ``rerank_l2``.
"""
import torch

from ... import tracing
from ..beam_step.beam_step import stable_smallest
from ..build import check_cuda, launch
from ..rerank_l2.rerank_l2 import rerank_l2_ref


def rerank_loop_ref(queries, vectors, cand_ids, k: int, b: int,
                    max_batches: int, threshold: float, tombstone=None, *,
                    l2=rerank_l2_ref):
    n = vectors.shape[0]
    nq = queries.shape[0]
    dev = queries.device

    def exact(ids):
        safe = ids.clamp(0, n - 1)
        d = l2(queries, vectors, safe)
        if tombstone is not None:
            d = torch.where(tombstone[safe], torch.inf, d)
        return torch.where(ids >= 0, d, torch.inf)

    # Batch 0: the prefetched top-K (always re-ranked).
    heap_ids = cand_ids[:, :k]
    heap_d = exact(heap_ids)
    go = torch.ones((nq,), dtype=torch.bool, device=dev)
    pending_stop = torch.zeros((nq,), dtype=torch.bool, device=dev)
    batches = torch.zeros((nq,), dtype=torch.int32, device=dev)
    i = 0
    while i < max_batches and tracing.any_set("search.sync", go):
        ids = cand_ids[:, k + i * b:k + (i + 1) * b]
        d = torch.where(go[:, None], exact(ids), torch.inf)
        m_ids = torch.cat([heap_ids, ids], 1)
        new_d, top_i = stable_smallest(torch.cat([heap_d, d], 1), k)
        new_ids = torch.gather(m_ids, 1, top_i)
        displaced = (top_i >= k).sum(1).to(torch.float32)
        below = displaced / b < threshold
        heap_ids = torch.where(go[:, None], new_ids, heap_ids)
        heap_d = torch.where(go[:, None], new_d, heap_d)
        batches = batches + go.to(torch.int32)
        # one-batch lookahead (§3.4): the next batch is already in flight
        # when the benefit test fires, so termination lags one batch.
        go_next = go & (~pending_stop | ~below)
        pending_stop = torch.where(go, below, pending_stop)
        go = go_next
        i += 1
    dists, order = torch.sort(heap_d, dim=1, stable=True)
    return torch.gather(heap_ids, 1, order), dists, batches


def rerank_loop_cuda(queries, vectors, cand_ids, k: int, b: int,
                     max_batches: int, threshold: float, tombstone=None):
    (n, d), (nq, l_size) = vectors.shape, cand_ids.shape
    if cand_ids.dtype != torch.int32:
        raise TypeError("rerank_loop takes int32 candidate ids")
    if queries.dtype != torch.float32 or queries.shape != (nq, d):
        raise ValueError(f"rerank_loop takes float32 queries [{nq}, {d}], "
                         f"got {queries.dtype} {tuple(queries.shape)}")
    entry = {torch.uint8: "rerank_loop_u8",
             torch.float32: "rerank_loop_f32"}.get(vectors.dtype)
    if entry is None:
        raise TypeError(f"rerank_loop takes uint8 or float32 vectors, got "
                        f"{vectors.dtype}")
    if tombstone is not None and (tombstone.dtype != torch.bool
                                  or tombstone.shape != (n,)):
        raise ValueError(f"rerank_loop takes a [{n}] bool tombstone mask")
    if n == 0 and nq * l_size:
        raise ValueError("rerank_loop: ids into an empty table")
    if k < 0 or b < 0 or max_batches < 0:
        raise ValueError("rerank_loop takes k, b and max_batches >= 0")
    kh = min(k, l_size)
    dev = check_cuda(queries, vectors, cand_ids,
                     *(() if tombstone is None else (tombstone,)))
    heap_ids = torch.empty((nq, kh), dtype=torch.int32, device=dev)
    heap_d = torch.empty((nq, kh), dtype=torch.float32, device=dev)
    batches = torch.empty((nq,), dtype=torch.int32, device=dev)
    if nq:
        # the heap and a batch, a row a query: the kernel's own scratch
        wd = torch.empty((nq, kh + b), dtype=torch.float32, device=dev)
        wi = torch.empty((nq, kh + b), dtype=torch.int32, device=dev)
        thr = torch.tensor(threshold, dtype=torch.float32).view(
            torch.int32).item()
        launch("rerank_loop", entry, queries, vectors, tombstone, cand_ids,
               wd, wi, heap_d, heap_ids, batches, n, nq, l_size, kh, b,
               max_batches, thr, d)
    return heap_ids, heap_d, batches
