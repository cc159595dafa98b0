"""Elias-Fano fixed-slot decode: ``[B, W]`` slots (int32 bit-view of the
uint32 words) -> ``(neighbors [B, r_max] int32, counts [B] int32)``;
padding entries decode to ``universe - 1``.

``ef_decode_cuda`` launches ``csrc/ef_decode.cu`` (the port of
``repro/kernels/ef_decode/ef_decode.py::ef_decode_pallas``);
``ef_decode_ref`` is its plain PyTorch version
(``core/codec/elias_fano.py::decode_slots_torch``). Integer work: the two
are bit-identical.
"""
import torch

from ...core.codec.elias_fano import decode_slots_torch, slot_layout
from ..build import check_cuda, launch


def ef_decode_ref(slots: torch.Tensor, r_max: int, universe: int):
    return decode_slots_torch(slots, r_max, universe)


def ef_decode_cuda(slots: torch.Tensor, r_max: int, universe: int):
    l, lw, hb, total = slot_layout(r_max, universe)
    if slots.dtype != torch.int32 or slots.dim() != 2 \
            or slots.shape[1] != total:
        raise ValueError(f"ef_decode takes int32 slots [B, {total}], got "
                         f"{slots.dtype} {tuple(slots.shape)}")
    dev = check_cuda(slots)
    b = slots.shape[0]
    nbrs = torch.empty((b, r_max), dtype=torch.int32, device=dev)
    counts = torch.empty((b,), dtype=torch.int32, device=dev)
    if b:
        launch("ef_decode", "ef_decode", slots, nbrs, counts, b, total,
               r_max, l, lw, hb)
    return nbrs, counts
