"""Elias-Fano byte-record decode: the block index store's records read by
position from its record table.

    buf [P] uint8 (the block image), rec_start [N] int64, rec_len [N]
    int32, pos [B] int64
    -> (values [B, max count] int64, padded with -1 past each count;
        counts [B] int64): row b is ``decode_record`` of the record at
       position ``pos[b]``. A position outside [0, N), or a record longer
       than ``MAX_RECORD_BYTES``, gives count -1 and a row of -1.

``ef_record_decode_cuda`` launches ``csrc/ef_record_decode.cu`` once, which
reads each record's table entry by position itself; it replaces no TPU
kernel (the reference decodes records on the host with numpy
``decode_record``). ``ef_record_decode_ref`` is its plain version,
``core/codec/elias_fano.py::decode_records_torch`` on the gathered table
entries. Integer work: the two are bit-identical. Both read the largest
count back to the host (an ``ef.sync`` span): it sets the width. The
plain version also reads back each pass's bitmap width.
"""
import functools

import torch

from ... import tracing
from ...core.codec import elias_fano as ef
from ..build import check_cuda, launch

# the kernel stages a record in 272 words of shared memory a warp, less 3
# bytes for the record's alignment in its first word
MAX_RECORD_BYTES = 4 * 272 - 3


@functools.lru_cache(maxsize=None)
def fits_stage(r: int, universe: int) -> bool:
    """Whether every record the index store's encoder writes for lists of
    at most ``r`` ids below ``universe`` is at most ``MAX_RECORD_BYTES``:
    at each count the encoder's smallest split, at the largest last id."""
    last = max(universe - 1, 0)
    return all(ef.record_bytes_for_width(
        n, last, ef.optimal_low_width(n, last, universe)) <= MAX_RECORD_BYTES
        for n in range(r + 1))


def _refuse_empty(rec_start, pos):
    if pos.numel() and not rec_start.shape[0]:
        raise ValueError("ef_record_decode: positions into an empty table")


def _table(buf, rec_start, rec_len, pos):
    """-> (positions clipped to the table, the rows not decoded, the width:
    the largest count of the rows decoded, read back)."""
    _refuse_empty(rec_start, pos)
    n = rec_start.shape[0]
    p = pos.clamp(0, max(n - 1, 0))
    ln = rec_len[p]
    skip = (p != pos) | (ln < 0) | (ln > MAX_RECORD_BYTES)
    r_max = 0
    if pos.numel():
        with tracing.span("ef.sync"):
            r_max = int(buf[rec_start[p]].masked_fill(skip, 0).max())
    return p, skip, r_max


def ef_record_decode_ref(buf: torch.Tensor, rec_start: torch.Tensor,
                         rec_len: torch.Tensor, pos: torch.Tensor):
    p, skip, r_max = _table(buf, rec_start, rec_len, pos)
    vals, counts = ef.decode_records_torch(buf, rec_start[p], rec_len[p],
                                           r_max)
    return vals.masked_fill(skip[:, None], -1), counts.masked_fill(skip, -1)


def ef_record_decode_cuda(buf: torch.Tensor, rec_start: torch.Tensor,
                          rec_len: torch.Tensor, pos: torch.Tensor):
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError(f"ef_record_decode takes a 1-D uint8 image, got "
                         f"{buf.dtype} {tuple(buf.shape)}")
    if rec_start.dtype != torch.int64 or rec_start.dim() != 1:
        raise ValueError(f"ef_record_decode takes int64 rec_start [N], got "
                         f"{rec_start.dtype} {tuple(rec_start.shape)}")
    n = rec_start.shape[0]
    if rec_len.dtype != torch.int32 or rec_len.shape != (n,):
        raise ValueError(f"ef_record_decode takes int32 rec_len [{n}], got "
                         f"{rec_len.dtype} {tuple(rec_len.shape)}")
    if pos.dtype != torch.int64 or pos.dim() != 1:
        raise ValueError(f"ef_record_decode takes int64 positions [B], "
                         f"got {pos.dtype} {tuple(pos.shape)}")
    dev = check_cuda(buf, rec_start, rec_len, pos)
    b = pos.shape[0]
    r_max = _table(buf, rec_start, rec_len, pos)[2]
    vals = torch.empty((b, r_max), dtype=torch.int64, device=dev)
    counts = torch.empty((b,), dtype=torch.int64, device=dev)
    if b:
        launch("ef_record_decode", "ef_record_decode", buf, rec_start,
               rec_len, pos, vals, counts, buf.numel(), n, b, r_max)
    return vals, counts
