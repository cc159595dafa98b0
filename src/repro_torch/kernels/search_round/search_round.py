"""The bookkeeping of one traversal round (§3.4), everything but the hop,
as two kernels around it, and its plain PyTorch version.

A round of ``core/search/beam.py::traverse`` is

    expand   the W smallest unexpanded candidates of each active row
             (ties to the lower slot) marked expanded; their adjacency
             lists read; the ids sorted, first occurrences kept; those not
             in the row's visited set are the round's new ids, written
             into it (last write wins a shared hash slot) -> new_ids
    hop      the new ids scored and merged into the candidate list (the
             fused ``beam_step``, or ``pq_adc_batched`` and a sort)
    settle   the hop's list taken over, the expansion flags carried
             through its merge, the §3.4 stability counters updated, and
             each row's and any row's activity for the next round

``expand`` and ``round_settle_ref`` are the plain versions: the CPU runs
them, and so does the card where the visited set is dense, trace buffers
are kept or the lists are raw adjacency. ``round_expand_cuda`` and
``round_settle_cuda`` launch ``csrc/round_expand.cu`` and
``csrc/round_settle.cu``, one block per row each, for the hash visited set
over Elias-Fano slots at shapes a block holds (``fits``); the two are
bit-identical to ``round_expand_ref`` and ``round_settle_ref``. They
replace no TPU kernel: the reference ran the same ops inside its
``lax.while_loop``.

State (all in place): ``cand_ids`` [nq, L] int32, ``cand_d`` [nq, L]
float32, ``expanded`` bool ([nq, L] by slot with the hash set, [nq, n + 1]
by id with the dense one), ``active`` [nq] bool, ``visited`` ([nq, H + 1]
int32 ids, column H the reference's "nowhere", or [nq, n + 1] bool),
``fetched``, ``pq_ct``, ``iters``, ``stab``, ``pf_iter`` [nq] int32,
``prev_top`` [nq, KB] int32, ``flag`` a 0-d bool: any row active.
"""
from __future__ import annotations

import torch

from ...core.codec.elias_fano import slot_layout
from ..beam_step.beam_step import stable_smallest
from ..build import check_cuda, launch, query
from ..ef_decode.ef_decode import ef_decode_ref

def fits(l_size: int, w: int, r_max: int, universe: int, bits: int) -> bool:
    """The kernels take a round of these shapes: L candidates, W lists of
    r_max ids in EF slots over ``universe``, a 2^bits hash table — as the
    kernel library states it (``round_expand_fits``; needs the built
    library, so the card's)."""
    _, _, hb, words = slot_layout(r_max, universe)
    return bool(query("round_expand", "round_expand_fits", l_size, w, r_max,
                      words, hb, bits))


def hash_slots(ids: torch.Tensor, bits: int) -> torch.Tensor:
    """Multiplicative hash of non-negative ids into ``2**bits`` slots —
    the reference's uint32 product, in int64."""
    h = (ids.to(torch.int64) * 2654435761) & 0xFFFFFFFF
    return h >> (32 - bits)


def last_write_wins(slots: torch.Tensor, ok: torch.Tensor,
                    pad: int) -> torch.Tensor:
    """Mask of the ``ok`` entries that own their slot: where several ok
    entries of a row share a slot, the last one (highest column) — the
    entry XLA's sequential scatter leaves in place."""
    key = torch.where(ok, slots, pad)
    sorted_key, order = torch.sort(key, dim=1, stable=True)
    last = torch.ones_like(ok)
    last[:, :-1] = sorted_key[:, 1:] != sorted_key[:, :-1]
    return torch.zeros_like(ok).scatter_(1, order, last) & ok


def unexpanded(cand_ids: torch.Tensor, expanded: torch.Tensor,
               by_slot: bool) -> torch.Tensor:
    """[nq, L] valid candidates not yet expanded."""
    valid = cand_ids >= 0
    if by_slot:
        return valid & ~expanded
    n = expanded.shape[1] - 1
    return valid & ~torch.gather(expanded, 1,
                                 cand_ids.clamp(0, n - 1).long())


def select(cand_ids, cand_d, open_, w: int):
    """The W smallest candidates where ``open_`` by (distance, slot) ->
    (ids [nq, W], -1 where the distance is not finite; slots [nq, W])."""
    sel_d, sel_slot = stable_smallest(torch.where(open_, cand_d, torch.inf),
                                      w)
    sel_ids = torch.where(torch.isfinite(sel_d),
                          torch.gather(cand_ids, 1, sel_slot), -1)
    return sel_ids, sel_slot


def ef_lists(decode, slots, r_max: int, universe: int,
             sel_ids: torch.Tensor) -> torch.Tensor:
    """[nq, W] vertex ids -> [nq, W * r_max] ids of their EF slots' lists,
    decoded by ``decode`` (an ``ef_decode``); -1 past each count and for a
    vertex id < 0."""
    vals, cnts = decode(slots, r_max, universe, ids=sel_ids.reshape(-1))
    j = torch.arange(r_max, device=vals.device)
    nbrs = torch.where(j[None, :] < cnts[:, None], vals, -1)
    nbrs = nbrs.reshape(sel_ids.shape + (r_max,))
    return torch.where((sel_ids >= 0)[..., None], nbrs,
                       -1).reshape(sel_ids.shape[0], -1)


def expand(neighbors, cand_ids, cand_d, expanded, active, visited, fetched,
           pq_ct, w: int, bits: int):
    """A round's first half, the plain version (hash set where ``bits`` >
    0, else dense); ``neighbors``: [nq, W] ids -> [nq, E] ids (-1 none) ->
    (new_ids [nq, E], the selected ids [nq, W])."""
    by_slot = bits > 0
    open_ = unexpanded(cand_ids, expanded, by_slot) & active[:, None]
    sel_ids, sel_slot = select(cand_ids, cand_d, open_, w)
    if by_slot:
        expanded.scatter_(1, sel_slot, torch.gather(expanded, 1, sel_slot)
                          | (sel_ids >= 0))
    else:
        rows = torch.arange(cand_ids.shape[0], device=cand_ids.device)
        expanded[rows[:, None], torch.where(
            sel_ids >= 0, sel_ids, expanded.shape[1] - 1).long()] = True
    fetched.add_((sel_ids >= 0).sum(1, dtype=torch.int32))

    # Dedupe within the round: sort + first occurrence.
    sorted_n = torch.sort(neighbors(sel_ids), dim=1).values
    first = torch.ones_like(sorted_n, dtype=torch.bool)
    first[:, 1:] = sorted_n[:, 1:] != sorted_n[:, :-1]
    uniq = torch.where(first, sorted_n, -1)
    pad = visited.shape[1] - 1
    if by_slot:
        slots = hash_slots(uniq.clamp_min(0), bits)
        seen = torch.gather(visited, 1, slots) == uniq
        ok = (uniq >= 0) & ~seen
        win = last_write_wins(slots, ok, pad)
        visited.scatter_(1, torch.where(win, slots, pad),
                         torch.where(win, uniq, -1))
    else:
        seen = torch.gather(visited, 1, uniq.clamp(0, pad - 1).long())
        ok = (uniq >= 0) & ~seen
        visited.scatter_(1, torch.where(ok, uniq, pad).long(),
                         torch.ones_like(ok))
    pq_ct.add_(ok.sum(1, dtype=torch.int32))
    return torch.where(ok, uniq, -1), sel_ids


def round_expand_ref(ef_slots, r_max: int, universe: int, cand_ids, cand_d,
                     expanded, active, visited, fetched, pq_ct, flag,
                     new_ids, w: int, bits: int) -> None:
    """``expand`` over EF slots with the hash set, written as the kernel
    writes it: into ``new_ids``, and ``flag`` cleared."""
    flag.zero_()
    got, _ = expand(lambda ids: ef_lists(ef_decode_ref, ef_slots, r_max,
                                         universe, ids),
                    cand_ids, cand_d, expanded, active, visited, fetched,
                    pq_ct, w, bits)
    new_ids.copy_(got)


def round_settle_ref(top_ids, top_d, top_i, cand_ids, cand_d, expanded,
                     iters, stab, pf_iter, prev_top, active, flag, w: int,
                     rerank_batch: int, max_iters: int,
                     by_slot: bool = True) -> None:
    """A round's second half, the plain version: the hop's output
    (``top_ids``, ``top_d``, its merge order ``top_i`` into [cand | new])
    taken over."""
    l_size = cand_ids.shape[1]
    if by_slot:
        top_i = top_i.long()
        expanded.copy_(torch.where(
            top_i < l_size,
            torch.gather(expanded, 1, top_i.clamp(max=l_size - 1)), False))
    cand_ids.copy_(top_ids)
    cand_d.copy_(top_d)
    # §3.4 stability: top-(K+B) id set unchanged across expansions.
    top_now = torch.sort(cand_ids[:, :prev_top.shape[1]], dim=1).values
    same = (top_now == prev_top).all(1)
    stab.copy_(torch.where(active, torch.where(same, stab + w, 0), stab))
    trigger = active & (stab >= rerank_batch) & (pf_iter < 0)
    pf_iter.copy_(torch.where(trigger, iters + 1, pf_iter))
    iters.add_(active.to(torch.int32))
    prev_top.copy_(torch.where(active[:, None], top_now, prev_top))
    active.copy_(unexpanded(cand_ids, expanded, by_slot).any(1)
                 & (iters < max_iters))
    flag.copy_(active.any())


def _check_state(cand_ids, cand_d, expanded, active, flag):
    nq, l_size = cand_ids.shape
    if (cand_ids.dtype != torch.int32 or cand_d.dtype != torch.float32
            or expanded.dtype != torch.bool or active.dtype != torch.bool
            or flag.dtype != torch.bool):
        raise TypeError("the round takes int32 ids, float32 distances and "
                        "bool flags")
    if (cand_d.shape != (nq, l_size) or expanded.shape != (nq, l_size)
            or active.shape != (nq,) or flag.shape != ()):
        raise ValueError("the round's state shapes disagree")
    return nq, l_size


def round_expand_cuda(ef_slots, r_max: int, universe: int, cand_ids, cand_d,
                      expanded, active, visited, fetched, pq_ct, flag,
                      new_ids, w: int, bits: int) -> None:
    nq, l_size = _check_state(cand_ids, cand_d, expanded, active, flag)
    l, lw, hb, words = slot_layout(r_max, universe)
    if (ef_slots.dtype != torch.int32 or ef_slots.dim() != 2
            or ef_slots.shape[1] != words or not ef_slots.shape[0]):
        raise ValueError(f"round_expand takes int32 EF slots [N, {words}]")
    if (visited.dtype != torch.int32
            or visited.shape != (nq, (1 << bits) + 1)
            or new_ids.dtype != torch.int32
            or new_ids.shape != (nq, w * r_max)
            or fetched.dtype != torch.int32 or pq_ct.dtype != torch.int32
            or fetched.shape != (nq,) or pq_ct.shape != (nq,)):
        raise ValueError("round_expand: visited, new_ids or counters do "
                         "not fit the state")
    check_cuda(ef_slots, cand_ids, cand_d, expanded, active, visited,
               fetched, pq_ct, flag, new_ids)
    if not fits(l_size, w, r_max, universe, bits):
        raise ValueError(f"round_expand takes no round of L={l_size}, "
                         f"W={w}, r_max={r_max} over {universe} ids and "
                         f"{bits} hash bits (round_expand_fits)")
    if nq:
        launch("round_expand", "round_expand", ef_slots, cand_ids, cand_d,
               expanded, active, visited, fetched, pq_ct, flag, new_ids,
               ef_slots.shape[0], words, r_max, l, lw, hb, nq, l_size, w,
               bits)


def round_settle_cuda(top_ids, top_d, top_i, cand_ids, cand_d, expanded,
                      iters, stab, pf_iter, prev_top, active, flag, w: int,
                      rerank_batch: int, max_iters: int) -> None:
    nq, l_size = _check_state(cand_ids, cand_d, expanded, active, flag)
    kb = prev_top.shape[1] if prev_top.dim() == 2 else -1
    if not 1 <= kb <= l_size:
        raise ValueError("round_settle takes 1 <= KB <= L")
    if (top_ids.dtype != torch.int32 or top_d.dtype != torch.float32
            or top_i.dtype != torch.int32 or prev_top.dtype != torch.int32
            or any(t.dtype != torch.int32 for t in (iters, stab, pf_iter))):
        raise TypeError("round_settle takes int32 ids, indices and "
                        "counters, float32 distances")
    if (any(t.shape != (nq, l_size) for t in (top_ids, top_d, top_i))
            or prev_top.shape[0] != nq
            or any(t.shape != (nq,) for t in (iters, stab, pf_iter))):
        raise ValueError("round_settle: the hop's output or the counters "
                         "do not fit the state")
    check_cuda(top_ids, top_d, top_i, cand_ids, cand_d, expanded, iters,
               stab, pf_iter, prev_top, active, flag)
    if nq:
        launch("round_settle", "round_settle", top_ids, top_d, top_i,
               cand_ids, cand_d, expanded, iters, stab, pf_iter, prev_top,
               active, flag, nq, l_size, kb, w, rerank_batch, max_iters)
