"""PQ ADC, batched and single-LUT.

Batched: ``[nq, n, M]`` codes x ``[nq, M, K]`` per-query LUTs -> ``[nq, n]``
distances, each query's rows scored against its own LUT.
``pq_adc_batched_cuda`` launches ``csrc/pq_adc_batched.cu`` (the port of
``repro/kernels/pq_adc/pq_adc.py::pq_adc_batched_pallas``);
``pq_adc_batched_ref`` is its plain PyTorch version (the reference's
``pq_adc_batched_ref``).

Single LUT: ``[n, M]`` uint8 or int32 codes x ``[M, K]`` LUT -> ``[n]``.
``pq_adc_cuda`` launches ``csrc/pq_adc.cu`` (the port of
``pq_adc_pallas``), with its own launch counter; ``pq_adc_ref`` is the
reference's ``pq_adc_ref``.

Every version folds over m = 0..M-1 in order, which is also what jnp's
``.sum(-1)`` does for these widths, so results are bit-equal.
"""
import torch

from ..build import check_cuda, launch


def pq_adc_batched_ref(codes: torch.Tensor,
                       luts: torch.Tensor) -> torch.Tensor:
    nq, n, m = codes.shape
    idx = codes.to(torch.int64)
    acc = torch.gather(luts[:, 0, :], 1, idx[:, :, 0])
    for j in range(1, m):
        acc += torch.gather(luts[:, j, :], 1, idx[:, :, j])
    return acc


def pq_adc_batched_cuda(codes: torch.Tensor,
                        luts: torch.Tensor) -> torch.Tensor:
    nq, n, m = codes.shape
    if codes.dtype != torch.uint8 or luts.dtype != torch.float32:
        raise TypeError("pq_adc_batched takes uint8 codes and float32 LUTs")
    if luts.shape[:2] != (nq, m):
        raise ValueError(f"LUTs {tuple(luts.shape)} do not match codes "
                         f"{tuple(codes.shape)}")
    dev = check_cuda(codes, luts)
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    if nq * n:
        launch("pq_adc_batched", "pq_adc_batched", codes, luts, out,
               nq, n, m, luts.shape[2])
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
