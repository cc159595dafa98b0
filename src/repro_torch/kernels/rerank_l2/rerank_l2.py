"""Exact squared L2 for the phase-2 re-rank, candidate rows by id:
queries ``[Q, D]`` x the ``[N, D]`` table (uint8 or float32), rows ``ids``
``[Q, C]`` int32 clipped to ``[0, N - 1]`` -> ``[Q, C]`` float32,
``sum_d (x - q)^2`` folded over d in order. The op masks nothing: the
re-rank masks ``ids < 0`` and tombstones itself. Without ids, ``cands`` is
``[Q, C, D]`` (the reference's contract).

``rerank_l2_cuda`` launches ``csrc/rerank_l2.cu`` (the port of
``repro/kernels/rerank_l2/rerank_l2.py::rerank_l2_pallas``, computing the
reference oracle's contract), which reads the rows by id itself;
``rerank_l2_ref`` is its plain PyTorch version. A fixed left fold, not
``.sum(-1)``: torch's reduction order differs from jnp's even at D = 32;
the fold equals jnp there and both sides of the port equal each other bit
for bit.
"""
import torch

from ..build import check_cuda, launch


def rerank_l2_ref(queries: torch.Tensor, cands: torch.Tensor,
                  ids: torch.Tensor | None = None) -> torch.Tensor:
    if ids is not None:
        cands = cands[ids.clamp(0, cands.shape[0] - 1)]
    q = queries.to(torch.float32)
    diff = cands.to(torch.float32) - q[:, None, :]
    sq = diff * diff
    if sq.shape[2] == 0:
        return sq.sum(-1)
    acc = sq[..., 0].clone()
    for j in range(1, sq.shape[2]):
        acc += sq[..., j]
    return acc


def rerank_l2_cuda(queries: torch.Tensor, cands: torch.Tensor,
                   ids: torch.Tensor | None = None) -> torch.Tensor:
    if ids is None:
        nq, c, d = cands.shape
        n = nq * c
    else:
        (n, d), (nq, c) = cands.shape, ids.shape
        if ids.dtype != torch.int32:
            raise TypeError("rerank_l2 takes int32 ids")
        if n == 0 and nq * c:
            raise ValueError("rerank_l2: ids into an empty table")
    if queries.dtype != torch.float32 or queries.shape != (nq, d):
        raise ValueError(f"rerank_l2 takes float32 queries [{nq}, {d}], got "
                         f"{queries.dtype} {tuple(queries.shape)}")
    entry = {torch.uint8: "rerank_l2_u8",
             torch.float32: "rerank_l2_f32"}.get(cands.dtype)
    if entry is None:
        raise TypeError(f"rerank_l2 takes uint8 or float32 candidates, "
                        f"got {cands.dtype}")
    dev = check_cuda(queries, cands, *(() if ids is None else (ids,)))
    out = torch.empty((nq, c), dtype=torch.float32, device=dev)
    if nq * c:
        launch("rerank_l2", entry, queries, cands, ids, out, n, nq, c, d)
    return out
