"""Elias-Fano fixed-slot decode: ``[N, W]`` slots (int32 bit-view of the
uint32 words) and optional ``[B]`` int32 row ids -> ``(neighbors [B,
r_max] int32, counts [B] int32)``, the reference's ``ef_decode`` of
``slots[clip(ids, 0, N - 1)]`` (of every row in order without ids);
padding entries decode to ``universe - 1``.

``ef_decode_cuda`` launches ``csrc/ef_decode.cu`` (the port of
``repro/kernels/ef_decode/ef_decode.py::ef_decode_pallas``), which reads
each row by id itself; ``ef_decode_ref`` is its plain PyTorch version
(``core/codec/elias_fano.py::decode_slots_torch`` on the gathered rows).
Integer work: the two are bit-identical.
"""
import torch

from ...core.codec.elias_fano import decode_slots_torch, slot_layout
from ..build import check_cuda, launch


def ef_decode_ref(slots: torch.Tensor, r_max: int, universe: int,
                  ids: torch.Tensor | None = None):
    if ids is not None:
        slots = slots[ids.clamp(0, slots.shape[0] - 1)]
    return decode_slots_torch(slots, r_max, universe)


def ef_decode_cuda(slots: torch.Tensor, r_max: int, universe: int,
                   ids: torch.Tensor | None = None):
    l, lw, hb, total = slot_layout(r_max, universe)
    if slots.dtype != torch.int32 or slots.dim() != 2 \
            or slots.shape[1] != total:
        raise ValueError(f"ef_decode takes int32 slots [N, {total}], got "
                         f"{slots.dtype} {tuple(slots.shape)}")
    n = slots.shape[0]
    if ids is None:
        dev = check_cuda(slots)
        b = n
    else:
        if ids.dtype != torch.int32 or ids.dim() != 1:
            raise ValueError(f"ef_decode takes int32 ids [B], got "
                             f"{ids.dtype} {tuple(ids.shape)}")
        dev = check_cuda(slots, ids)
        b = ids.shape[0]
        if b and not n:
            raise ValueError("ef_decode: ids into an empty slot table")
    nbrs = torch.empty((b, r_max), dtype=torch.int32, device=dev)
    counts = torch.empty((b,), dtype=torch.int32, device=dev)
    if b:
        launch("ef_decode", "ef_decode", slots, ids, nbrs, counts, n, b,
               total, r_max, l, lw, hb)
    return nbrs, counts
