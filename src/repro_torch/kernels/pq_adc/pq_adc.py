"""PQ ADC, batched and single-LUT.

Batched, by id: the ``[N, M]`` uint8 code table x ``[nq, M, K]``
per-query LUTs, rows ``ids`` ``[nq, E]`` int32 -> ``[nq, E]`` distances:
row ``min(ids[q, e], N - 1)`` scored against LUT q, +inf where
``ids < 0`` (no row read) — ``beam_step``'s scoring contract. Without ids,
``codes`` is ``[nq, n, M]``, each query's rows scored against its own LUT
(the reference's contract). ``pq_adc_batched_cuda`` launches
``csrc/pq_adc_batched.cu`` (the port of
``repro/kernels/pq_adc/pq_adc.py::pq_adc_batched_pallas``), which reads
the rows by id itself; ``pq_adc_batched_ref`` is its plain PyTorch version
(the reference's ``pq_adc_batched_ref`` on the gathered rows, then the
mask).

Single LUT: ``[n, M]`` uint8 or int32 codes x ``[M, K]`` LUT -> ``[n]``.
``pq_adc_cuda`` launches ``csrc/pq_adc.cu`` (the port of
``pq_adc_pallas``), with its own launch counter; ``pq_adc_ref`` is the
reference's ``pq_adc_ref``.

Every version folds over m = 0..M-1 in order, which is also what jnp's
``.sum(-1)`` does for these widths, so results are bit-equal. A LUT that
does not fit a block's shared memory (M = 384 at K = 256) is staged in
slices of 32 sub-spaces, the fold carried across them in order; the
kernel's entry point asks the device which.
"""
import torch

from ..build import check_cuda, launch


def pq_adc_batched_ref(codes: torch.Tensor, luts: torch.Tensor,
                       ids: torch.Tensor | None = None) -> torch.Tensor:
    if ids is not None:
        d = pq_adc_batched_ref(codes[ids.clamp(0, codes.shape[0] - 1)], luts)
        return torch.where(ids >= 0, d, torch.inf)
    nq, n, m = codes.shape
    idx = codes.to(torch.int64)
    acc = torch.gather(luts[:, 0, :], 1, idx[:, :, 0])
    for j in range(1, m):
        acc += torch.gather(luts[:, j, :], 1, idx[:, :, j])
    return acc


def pq_adc_batched_cuda(codes: torch.Tensor, luts: torch.Tensor,
                        ids: torch.Tensor | None = None) -> torch.Tensor:
    if ids is None:
        nq, e, m = codes.shape
        n = nq * e
    else:
        (n, m), (nq, e) = codes.shape, ids.shape
        if ids.dtype != torch.int32:
            raise TypeError("pq_adc_batched takes int32 ids")
        if n == 0 and nq * e:
            raise ValueError("pq_adc_batched: ids into an empty table")
    if codes.dtype != torch.uint8 or luts.dtype != torch.float32:
        raise TypeError("pq_adc_batched takes uint8 codes and float32 LUTs")
    if luts.shape[:2] != (nq, m):
        raise ValueError(f"LUTs {tuple(luts.shape)} do not match codes "
                         f"{tuple(codes.shape)}")
    dev = check_cuda(codes, luts, *(() if ids is None else (ids,)))
    out = torch.empty((nq, e), dtype=torch.float32, device=dev)
    if nq * e:
        launch("pq_adc_batched", "pq_adc_batched", codes, luts, ids, out,
               n, nq, e, m, luts.shape[2])
    return out


def pq_adc_ref(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    acc = lut[0][codes[:, 0].to(torch.int64)]
    for j in range(1, codes.shape[1]):
        acc += lut[j][codes[:, j].to(torch.int64)]
    return acc


def pq_adc_cuda(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    if codes.dtype not in (torch.uint8, torch.int32) \
            or lut.dtype != torch.float32:
        raise TypeError("pq_adc takes uint8 or int32 codes and a float32 LUT")
    n, m = codes.shape
    if lut.dim() != 2 or lut.shape[0] != m or m == 0:
        raise ValueError(f"LUT {tuple(lut.shape)} does not match codes "
                         f"{tuple(codes.shape)}")
    dev = check_cuda(codes, lut)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        launch("pq_adc", "pq_adc", codes, lut, out, n, m, lut.shape[1],
               codes.element_size())
    return out
