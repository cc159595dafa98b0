"""Rows of a table by id: ``[N, ...]`` x ``[B]`` int32 ids ->
``[B, ...]``, ``table[clip(ids, 0, N - 1)]``.

No path calls it. ``row_gather_cuda`` launches ``csrc/row_gather.cu``, the
plainest hand-written gather (16-byte loads where the rows allow them):
``chip_smoke.py`` times it beside ``table[ids]`` on the rows that
``beam_step`` and ``ef_decode`` read by id, to tell the cost of the torch
op from the cost of reading random rows. ``row_gather_ref`` is its plain
version.
"""
import torch

from .build import check_cuda, launch


def row_gather_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids.clamp(0, table.shape[0] - 1)]


def row_gather_cuda(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    if ids.dtype != torch.int32 or ids.dim() != 1 or table.dim() < 1:
        raise ValueError("row_gather takes a table and int32 ids [B]")
    dev = check_cuda(table, ids)
    out = torch.empty((ids.shape[0],) + table.shape[1:], dtype=table.dtype,
                      device=dev)
    if out.numel():
        if not table.shape[0]:
            raise ValueError("row_gather: ids into an empty table")
        launch("row_gather", "row_gather", table, ids, out, table.shape[0],
               ids.shape[0], out[0].numel() * out.element_size())
    return out
