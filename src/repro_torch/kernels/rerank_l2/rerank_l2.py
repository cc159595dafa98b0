"""Exact squared L2 for the phase-2 re-rank: queries ``[Q, D]`` x
candidates ``[Q, C, D]`` (uint8 or float32) -> ``[Q, C]`` float32,
``sum_d (x - q)^2`` folded over d in order.

``rerank_l2_cuda`` launches ``csrc/rerank_l2.cu`` (the port of
``repro/kernels/rerank_l2/rerank_l2.py::rerank_l2_pallas``, computing the
reference oracle's contract); ``rerank_l2_ref`` is its plain PyTorch
version. A fixed left fold, not ``.sum(-1)``: torch's reduction order
differs from jnp's even at D = 32; the fold equals jnp there and both
sides of the port equal each other bit for bit.
"""
import torch

from ..build import check_cuda, launch


def rerank_l2_ref(queries: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    q = queries.to(torch.float32)
    diff = cands.to(torch.float32) - q[:, None, :]
    sq = diff * diff
    if sq.shape[2] == 0:
        return sq.sum(-1)
    acc = sq[..., 0].clone()
    for j in range(1, sq.shape[2]):
        acc += sq[..., j]
    return acc


def rerank_l2_cuda(queries: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    nq, c, d = cands.shape
    if queries.dtype != torch.float32 or queries.shape != (nq, d):
        raise ValueError(f"rerank_l2 takes float32 queries [{nq}, {d}], got "
                         f"{queries.dtype} {tuple(queries.shape)}")
    entry = {torch.uint8: "rerank_l2_u8",
             torch.float32: "rerank_l2_f32"}.get(cands.dtype)
    if entry is None:
        raise TypeError(f"rerank_l2 takes uint8 or float32 candidates, "
                        f"got {cands.dtype}")
    dev = check_cuda(queries, cands)
    out = torch.empty((nq, c), dtype=torch.float32, device=dev)
    if nq * c:
        launch("rerank_l2", entry, queries, cands, out, nq, c, d)
    return out
