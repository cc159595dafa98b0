"""Kernel dispatch layer: one registry from (op, backend) to implementation.

The JAX reference resolves a per-op backend at config time. Here the
backend of every op is decided by where its tensors are:

    cuda   the hand-written CUDA kernel (``kernels/csrc``), for tensors on
           a CUDA device. A kernel that cannot be built or launched raises;
           nothing falls back to the plain version.
    ref    the plain PyTorch version, for tensors on the CPU.

``KernelConfig`` keeps the reference's five fields. Each field is
``"auto"`` (backend from the tensors' device); ``beam_step`` may also be
``"off"``, which selects the unfused op composition in the hot path
(``core/search/beam.py`` branches on it before calling dispatch). So no
config can put a plain version on a CUDA tensor. ``"auto-tuned"`` is
resolved once, at config time (``KernelConfig.resolve``), from the
measured autotune cache (``autotune.py``) of the device's platform: to
``"off"`` where the unfused composition measured faster (``beam_step``
only), else to ``"auto"``. An unknown request, a device with no backend, or
an unresolved backend reaching ``get_impl`` raises.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

BACKENDS = ("ref", "cuda")
REQUESTED = ("auto", "auto-tuned", "off")


class KernelConfig(NamedTuple):
    """Per-op backend request, the reference's five fields. ``pq_adc``
    drives both ADC ops (batched and single-LUT); ``ef_decode`` both
    Elias-Fano decodes (the slots and the index store's records);
    ``byteplane`` drives the vector store's XOR-delta inverse on loads,
    which runs inside ``huffman_decode`` (and the standalone
    ``byteplane_decode``)."""
    pq_adc: str = "auto"
    ef_decode: str = "auto"
    rerank_l2: str = "auto"
    byteplane: str = "auto"
    beam_step: str = "auto"

    def check(self) -> "KernelConfig":
        """Raise on a value this layer does not know; return self."""
        for op, requested in zip(self._fields, self):
            resolve_backend(requested, None, op)
        return self

    def resolve(self, device, shapes: dict | None = None,
                cache=None) -> "KernelConfig":
        """Map every ``auto-tuned`` entry to ``auto`` or ``off`` for tensors
        on ``device``, per (op, shape-bucket): ``shapes`` maps an op name to
        its dims dict (without it the op's majority-winner bucket decides).
        ``cache`` is an ``autotune.AutotuneCache`` or a path to one (None:
        the committed cache); a cache of another platform counts as empty,
        and an empty cache resolves like ``auto``. Idempotent; a config
        without ``auto-tuned`` is returned as it is."""
        self.check()
        if "auto-tuned" not in self:
            return self
        from . import autotune
        dev = torch.device(device)
        key = autotune.platform_key(dev)
        if not isinstance(cache, autotune.AutotuneCache):
            cache = autotune.AutotuneCache.load(cache, platform=key)
        elif cache.platform != key:
            cache = autotune.AutotuneCache(key)
        shapes = shapes or {}
        fallback = resolve_backend("auto", dev)
        out = []
        for op, requested in zip(self._fields, self):
            if requested == "auto-tuned":
                best = cache.best(op, shapes.get(op), fallback=fallback)
                requested = "off" if best == "off" and op == "beam_step" \
                    else "auto"
            out.append(requested)
        return KernelConfig(*out)


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device (raise if there is none); else the
    device given. Entry points run on the card unless told otherwise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def default_config() -> KernelConfig:
    """The config used when a caller passes ``kernels=None``: every op
    ``auto`` (no environment variable is read)."""
    return KernelConfig()


def resolve_backend(requested: str, device: torch.device | None,
                    op: str | None = None) -> str:
    """One op's request + its tensors' device -> concrete backend
    (``device=None`` only validates the request)."""
    if requested not in REQUESTED:
        raise ValueError(f"unknown kernel backend {requested!r}; "
                         f"expected one of {REQUESTED}")
    if requested == "off":
        if op not in (None, "beam_step"):
            raise ValueError(
                f"backend 'off' only applies to the beam_step op, not {op!r}"
                " — every other op is always on some backend")
        return "off"
    if device is None:
        return requested
    if requested == "auto-tuned":
        raise RuntimeError(
            f"unresolved 'auto-tuned' request for op {op!r}: resolve the "
            "config at config time first (KernelConfig.resolve, "
            "core/search/beam.py resolve_kernels)")
    if device.type == "cuda":
        return "cuda"
    if device.type == "cpu":
        return "ref"
    raise ValueError(f"no kernel backend for tensors on {device}")


@functools.lru_cache(maxsize=1)
def _registry() -> dict[tuple[str, str], Callable]:
    from .beam_step.beam_step import beam_step_cuda, beam_step_ref
    from .byteplane.byteplane import (byteplane_decode_cuda,
                                      byteplane_decode_ref)
    from .ef_decode.ef_decode import ef_decode_cuda, ef_decode_ref
    from .ef_record_decode.ef_record_decode import (ef_record_decode_cuda,
                                                    ef_record_decode_ref)
    from .huffman_decode.huffman_decode import (huffman_decode_cuda,
                                                huffman_decode_ref)
    from .pq_adc.pq_adc import (pq_adc_batched_cuda, pq_adc_batched_ref,
                                pq_adc_cuda, pq_adc_ref)
    from .pq_encode.pq_encode import pq_encode_cuda, pq_encode_ref
    from .rerank_l2.rerank_l2 import rerank_l2_cuda, rerank_l2_ref

    table: dict[tuple[str, str], Callable] = {}
    for op, ref, kern in (
            ("pq_adc", pq_adc_ref, pq_adc_cuda),
            ("pq_adc_batched", pq_adc_batched_ref, pq_adc_batched_cuda),
            ("ef_decode", ef_decode_ref, ef_decode_cuda),
            ("ef_record_decode", ef_record_decode_ref,
             ef_record_decode_cuda),
            ("rerank_l2", rerank_l2_ref, rerank_l2_cuda),
            ("beam_step", beam_step_ref, beam_step_cuda),
            ("byteplane", byteplane_decode_ref, byteplane_decode_cuda),
            ("huffman_decode", huffman_decode_ref, huffman_decode_cuda),
            ("pq_encode", pq_encode_ref, pq_encode_cuda)):
        table[op, "ref"] = ref
        table[op, "cuda"] = kern
    return table


def get_impl(op: str, backend: str) -> Callable:
    """(op, concrete backend) -> implementation."""
    if backend == "auto":
        raise RuntimeError(
            f"unresolved 'auto' backend reached dispatch for op {op!r}; "
            "resolve it from the tensors' device first (resolve_backend)")
    if backend == "off":
        raise RuntimeError(
            f"backend 'off' reached dispatch for op {op!r}: 'off' means "
            "the UNFUSED composition — the hot path must branch on it "
            "before calling dispatch (core/search/beam.py does)")
    try:
        return _registry()[op, backend]
    except KeyError:
        raise KeyError(f"no implementation registered for "
                       f"op={op!r} backend={backend!r}") from None


def _impl(op: str, requested: str, t: torch.Tensor) -> Callable:
    return get_impl(op, resolve_backend(requested, t.device, op))


# ------------------------------------------------------------- public ops
def pq_adc(codes, lut, cfg: KernelConfig | None = None):
    """[n, M] codes x [M, K] LUT -> [n] ADC distances."""
    cfg = cfg or KernelConfig()
    return _impl("pq_adc", cfg.pq_adc, codes)(codes, lut)


def pq_adc_batched(codes, luts, cfg: KernelConfig | None = None, ids=None):
    """[N, M] uint8 code table x [nq, M, K] per-query LUTs, rows ``ids``
    [nq, E] int32 (clipped to N - 1) -> [nq, E], +inf where ids < 0; without
    ids, [nq, n, M] codes -> [nq, n]."""
    cfg = cfg or KernelConfig()
    return _impl("pq_adc_batched", cfg.pq_adc, codes)(codes, luts, ids)


def ef_decode(slots, r_max: int, universe: int,
              cfg: KernelConfig | None = None, ids=None):
    """[N, W] int32 (uint32 bit-view) slots, rows ``ids`` [B] int32
    (clipped to the table; every row without ids) -> (neighbors
    [B, r_max], counts [B])."""
    cfg = cfg or KernelConfig()
    return _impl("ef_decode", cfg.ef_decode, slots)(slots, r_max, universe,
                                                    ids)


def ef_record_decode(buf, rec_start, rec_len, pos,
                     cfg: KernelConfig | None = None):
    """The index store's Elias-Fano records at positions ``pos`` [B] int64
    of the [N] record table (``rec_start`` int64 byte offsets, ``rec_len``
    int32 lengths) into the uint8 image ``buf`` -> (values [B, max count]
    int64, -1 past each count; counts [B] int64). A position outside
    [0, N) gives count -1 and a row of -1. Routed by ``cfg.ef_decode``,
    the field of the Elias-Fano decode."""
    cfg = cfg or KernelConfig()
    return _impl("ef_record_decode", cfg.ef_decode, buf)(buf, rec_start,
                                                        rec_len, pos)


def rerank_l2(queries, cands, cfg: KernelConfig | None = None, ids=None):
    """[Q, D] queries x the [N, D] table, rows ``ids`` [Q, C] int32
    (clipped to [0, N - 1], nothing masked) -> squared L2 [Q, C]; without
    ids, [Q, C, D] candidates."""
    cfg = cfg or KernelConfig()
    return _impl("rerank_l2", cfg.rerank_l2, cands)(queries, cands, ids)


def byteplane_decode(packed, base, cfg: KernelConfig | None = None):
    """[n, V] uint8 XOR [V] uint8 base -> [n, V] uint8 (lossless)."""
    cfg = cfg or KernelConfig()
    return _impl("byteplane", cfg.byteplane, packed)(packed, base)


def huffman_decode(payload, starts, v: int, table, bases, base_of,
                   cfg: KernelConfig | None = None):
    """The vector store's load of one segment: the Huffman records at byte
    ``starts`` [m] of ``payload`` decoded to [m, v] uint8 with ``table``
    (one table or plane tables), row i XOR ``bases[base_of[i]]`` where
    ``base_of[i] >= 0``. Routed by ``cfg.byteplane``, the field of the
    XOR-delta inverse on loads."""
    cfg = cfg or KernelConfig()
    return _impl("huffman_decode", cfg.byteplane, payload)(
        payload, starts, v, table, bases, base_of)


def beam_step(pq_codes, luts, cand_ids, cand_d, new_ids,
              cfg: KernelConfig | None = None):
    """Fused hop tail: the [n, M] code rows of ``new_ids`` [nq, E] scored
    against [nq, M, K] LUTs and merged into the [nq, L] candidate list ->
    (cand_ids', cand_d', top_idx)."""
    cfg = cfg or KernelConfig()
    return _impl("beam_step", cfg.beam_step, pq_codes)(
        pq_codes, luts, cand_ids, cand_d, new_ids)


def pq_encode(vectors, centroids):
    """[n, d] vectors x [M, K, dsub] centroids -> [n, M] uint8 PQ codes.
    Not a field of ``KernelConfig`` (offline build, no reference kernel):
    the backend follows the device alone."""
    return _impl("pq_encode", "auto", vectors)(vectors, centroids)
