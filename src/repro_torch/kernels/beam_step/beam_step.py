"""Fused beam step: the hop's ADC + top-L merge of the candidate list.

    pq_codes [n, M]     uint8   the shard's PQ codes (read by id)
    luts     [nq, M, K] f32     per-query ADC lookup tables
    cand_ids [nq, L]    i32     current candidate list (-1 = empty slot)
    cand_d   [nq, L]    f32     current candidate PQ distances (+inf = empty)
    new_ids  [nq, E]    i32     deduped, unvisited neighbour ids (-1 = masked)
    -> (cand_ids' [nq, L], cand_d' [nq, L], top_idx [nq, L])

the L smallest of ``[cand | new]`` by (distance, merged index), with
``top_idx`` indexing that concatenation: the reference's ``beam_step`` on
``codes = pq_codes[clip(new_ids, 0, n - 1)]``. A masked entry scores +inf.
``beam_step_cuda`` launches ``csrc/beam_step.cu`` (the port of
``repro/kernels/beam_step/beam_step.py::beam_step_pallas``), which reads
each row of ``pq_codes`` itself; ``beam_step_ref`` is its plain PyTorch
version: ``pq_adc_batched_ref`` by id, then a stable top-L merge.
Where an ``[M, K]`` LUT does not fit a block's shared memory the kernel
stages it in slices (``lut_slices``); the result is the same.
``lax.top_k`` puts the lower index first on ties and ``torch.topk`` does
not, so every top-k here is a stable ascending sort (``stable_smallest``).
"""
import torch

from ..build import check_cuda, launch, query
from ..pq_adc.pq_adc import pq_adc_batched_ref


def lut_slices(m: int, k: int, e: int, l_size: int) -> int:
    """LUT slices the CUDA kernel stages at these shapes on the current
    card (1: the whole LUT; ceil(m / 32) where it does not fit a block's
    shared memory beside the block's keys), as its entry point plans."""
    return query("beam_step", "beam_step_lut_slices", m, k, e, l_size)


def stable_smallest(x: torch.Tensor, k: int):
    """The k smallest of each row, ties to the lower index ->
    (values [.., k], indices [.., k] int64) — ``lax.top_k(-x, k)``'s
    selection and order."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].contiguous()


def beam_step_ref(pq_codes, luts, cand_ids, cand_d, new_ids):
    l_size = cand_ids.shape[1]
    new_d = pq_adc_batched_ref(pq_codes, luts, new_ids)
    merged_ids = torch.cat([cand_ids, new_ids], 1)
    merged_d = torch.cat([cand_d, new_d], 1)
    top_d, top_i = stable_smallest(merged_d, l_size)
    return (torch.gather(merged_ids, 1, top_i), top_d,
            top_i.to(torch.int32))


def beam_step_cuda(pq_codes, luts, cand_ids, cand_d, new_ids):
    n, m = pq_codes.shape
    nq, e = new_ids.shape
    l_size = cand_ids.shape[1]
    if (pq_codes.dtype != torch.uint8 or luts.dtype != torch.float32
            or cand_ids.dtype != torch.int32 or new_ids.dtype != torch.int32
            or cand_d.dtype != torch.float32):
        raise TypeError("beam_step takes uint8 codes, float32 LUTs and "
                        "distances, int32 ids")
    if (luts.shape[:2] != (nq, m) or cand_d.shape != (nq, l_size)
            or cand_ids.shape != (nq, l_size) or n == 0):
        raise ValueError("beam_step input shapes disagree")
    dev = check_cuda(pq_codes, luts, cand_ids, cand_d, new_ids)
    ids = torch.empty((nq, l_size), dtype=torch.int32, device=dev)
    d = torch.empty((nq, l_size), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, l_size), dtype=torch.int32, device=dev)
    if nq * l_size:
        launch("beam_step", "beam_step", pq_codes, luts, cand_ids, cand_d,
               new_ids, ids, d, idx, n, nq, e, l_size, m, luts.shape[2])
    return ids, d, idx
