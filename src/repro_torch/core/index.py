"""End-to-end index construction: Vamana graph + PQ codes + compressed
device-resident structures (paper §3.1 architecture, PyTorch edition).

``build_device_index`` is the offline path: build the graph (expensive, as
in the paper, host numpy), then apply DecoupleVS's compression/layout
transform (cheap) to produce the device-resident search state.
``device_index_from_numpy`` carries a reference ``DeviceIndex`` (its fields
as numpy arrays) over to this package, so the two can be searched on the
same state.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import dispatch
from .codec.elias_fano import encode_slot, slot_layout
from .graph.pq import PQCodebook, encode_pq, train_pq
from .graph.vamana import VamanaGraph, build_vamana
from .search.beam import DeviceIndex, resolve_device


def ef_slots_from_graph(graph: VamanaGraph, universe: int | None = None
                        ) -> np.ndarray:
    """Encode every adjacency list (sorted ascending — search is
    order-independent, §3.2) into fixed-size EF slots (uint32)."""
    n = graph.n
    universe = universe or n
    _, _, _, words = slot_layout(graph.r, universe)
    slots = np.zeros((n, words), dtype=np.uint32)
    for i, adj in enumerate(graph.adjacency):
        slots[i] = encode_slot(np.sort(adj.astype(np.uint64)), graph.r, universe)
    return slots


def device_index_from_numpy(arrays: dict, device=None) -> DeviceIndex:
    """A ``DeviceIndex`` on ``device`` from numpy arrays named like its
    fields (e.g. ``{k: np.asarray(v) for k, v in ref_index._asdict().items()}``
    of a reference index). uint32 EF slots become their int32 bit-view;
    ``vectors`` keep their dtype (float32 or uint8); ``tombstone`` may be
    absent or None (``np.asarray(None)``, 0-d, included)."""
    dev = resolve_device(device)

    def t(a, dtype=None):
        a = np.array(a, copy=True, order="C")
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out = torch.from_numpy(a)
        return out.to(device=dev, dtype=dtype or out.dtype)

    tomb = arrays.get("tombstone")
    if tomb is not None and np.ndim(tomb) == 0:
        tomb = None
    return DeviceIndex(
        neighbors=t(arrays["neighbors"], torch.int32),
        counts=t(arrays["counts"], torch.int32),
        ef_slots=t(np.asarray(arrays["ef_slots"], dtype=np.uint32)),
        pq_codes=t(arrays["pq_codes"], torch.uint8),
        pq_centroids=t(arrays["pq_centroids"], torch.float32),
        vectors=t(arrays["vectors"]),
        medoid=t(np.asarray(arrays["medoid"]), torch.int64).reshape(()),
        tombstone=None if tomb is None else t(tomb, torch.bool),
    )


def device_index_from_artifacts(vectors: np.ndarray, graph: VamanaGraph,
                                cb: PQCodebook, codes: np.ndarray,
                                device=None) -> DeviceIndex:
    """Assemble the device-resident search state from pre-built offline
    artifacts (graph + PQ) — the cheap DecoupleVS transform."""
    nbrs, counts = graph.to_padded()
    return device_index_from_numpy(dict(
        neighbors=nbrs, counts=counts, ef_slots=ef_slots_from_graph(graph),
        pq_codes=codes, pq_centroids=cb.centroids,
        vectors=np.asarray(vectors, dtype=np.float32),
        medoid=np.int64(graph.medoid)), device)


def build_device_index(vectors: np.ndarray, r: int = 32, l_build: int = 64,
                       alpha: float = 1.2, pq_m: int = 8, seed: int = 0,
                       device=None
                       ) -> tuple[DeviceIndex, VamanaGraph, PQCodebook]:
    """Offline build on the host (Vamana + PQ, numpy) -> the search state
    on ``device`` (the CUDA device unless told otherwise)."""
    dev = resolve_device(device)
    vectors = np.asarray(vectors, dtype=np.float32)
    graph = build_vamana(vectors, r=r, l_build=l_build, alpha=alpha, seed=seed)
    cb = train_pq(vectors, m=pq_m, seed=seed)
    codes = encode_pq(vectors, cb)
    return (device_index_from_artifacts(vectors, graph, cb, codes, dev),
            graph, cb)


def verify_index_slots(index: DeviceIndex, r_max: int,
                       universe: int | None = None) -> bool:
    """Decode every EF slot through the kernel dispatch layer and check it
    reproduces the raw adjacency exactly (the compressed index tier is
    lossless — the paper's Q1 fidelity requirement). Slots store adjacency
    sorted ascending, so the raw lists are compared as sorted sets."""
    n, r = index.neighbors.shape
    universe = universe or n
    vals, cnts = dispatch.ef_decode(index.ef_slots, r_max, universe)
    if not bool((cnts == index.counts).all()):
        return False
    width = max(r, r_max)
    j = torch.arange(width, device=vals.device)

    def padded(a, valid_len):
        out = torch.full((a.shape[0], width), universe, dtype=torch.int64,
                         device=a.device)
        out[:, :a.shape[1]] = a
        return torch.where(j[None, :] < valid_len[:, None], out, universe)

    dec = padded(vals, cnts)
    raw = padded(index.neighbors, index.counts)
    return bool((dec.sort(1).values == raw.sort(1).values).all())


def recall_at_k(pred_ids, gt_ids, k: int) -> float:
    """Fraction of true top-k found (paper's recall@10 metric, §4.1)."""
    pred = pred_ids.cpu().numpy() if torch.is_tensor(pred_ids) \
        else np.asarray(pred_ids)
    hits = 0
    for p, g in zip(pred, np.asarray(gt_ids)):
        hits += len(set(p[:k].tolist()) & set(g[:k].tolist()))
    return hits / (len(gt_ids) * k)
