"""How one data shard is assembled on the card, frozen.

Copied from ``chip_smoke.py``: ``medoid_of`` (lines 2089-2103), the search
parameters of ``Shard.__init__`` (lines 1040-1045), the index assembly of
``Shard.build`` (lines 1058-1118: PQ codes through ``encode_pq_torch``, EF
slots through ``encode_slots_torch`` a million rows at a time, a one-row
``neighbors`` stub, counts of R), the store configuration of
``Storage.store`` (lines 1299-1307) and the index store's seal of
``Storage.sift`` (``CompressedIndexStore.from_graph``, lines 1349-1350).
What differs: the vectors, graph and codebook are the benchmark's own
(``cardbench/world.py``), handed in, where chip_smoke drew a random graph
and trained its codebook on the host; the program's modules come in as
``prog`` (``cardbench/program.py``) so that this file imports none.
"""
from __future__ import annotations

CHUNK = 1 << 20


def medoid_of(torch, vectors, chunk: int = CHUNK) -> int:
    """The row nearest the mean of ``vectors`` (read in chunks so the
    float temporaries stay small)."""
    n, dim = vectors.shape
    mean = torch.zeros(dim, dtype=torch.float64, device=vectors.device)
    for a in range(0, n, chunk):
        mean += vectors[a:a + chunk].double().sum(0)
    mean = (mean / n).float()
    best = []
    for a in range(0, n, chunk):
        d = ((vectors[a:a + chunk].float() - mean) ** 2).sum(1)
        v, i = d.min(0)
        best.append((float(v), a + int(i)))
    return min(best)[1]


def search_params(prog, cfg: dict):
    """``lower_production_search``'s per-shard parameters, as chip_smoke
    sets them: the config's L, W, k, B; r_max R; universe n; EF traversal;
    the config's ``max_iters`` and hashed visited set."""
    return prog.SearchParams(
        l_size=cfg["l_size"], beam_width=cfg["beam_width"], k=cfg["k"],
        rerank_batch=cfg["rerank_batch"], r_max=cfg["r"],
        universe=cfg["n_vectors"], max_iters=cfg["max_iters"], use_ef=True,
        visited_hash_bits=cfg["visited_hash_bits"])


def device_index(torch, prog, vectors, adjacency, centroids, medoid: int,
                 r: int):
    """The program's search state from the inputs: PQ codes and EF slots
    encoded by the program, the vectors as the re-rank tier."""
    n, dev = vectors.shape[0], vectors.device
    codes = prog.encode_pq_torch(vectors, centroids)
    words = prog.slot_layout(r, n)[3]
    slots = torch.empty((n, words), dtype=torch.int32, device=dev)
    full = torch.full((CHUNK,), r, dtype=torch.int32, device=dev)
    for a in range(0, n, CHUNK):
        b = min(a + CHUNK, n)
        slots[a:b] = prog.encode_slots_torch(adjacency[a:b], full[:b - a],
                                             r, n)
    return prog.DeviceIndex(
        neighbors=torch.full((1, r), -1, dtype=torch.int32, device=dev),
        counts=torch.full((n,), r, dtype=torch.int32, device=dev),
        ef_slots=slots, pq_codes=codes, pq_centroids=centroids,
        vectors=vectors,
        medoid=torch.tensor(medoid, dtype=torch.int64, device=dev))


def vector_store(prog, cfg: dict, dtype, device):
    """An empty vector store of the config's segments and chunks."""
    v_bytes = cfg["dim"] * dtype.itemsize
    return prog.DecoupledVectorStore(prog.StoreConfig(
        dim=cfg["dim"], dtype=dtype, chunk_bytes=cfg["chunk_bytes"],
        segment_capacity=cfg["segment_bytes"] // v_bytes,
        vector_codec=cfg["vector_codec"], device=device))


def index_store(prog, adjacency, medoid: int, r: int, device):
    """The graph sealed into the Elias-Fano block index store."""
    return prog.CompressedIndexStore.from_graph(
        adjacency, medoid, r, universe=adjacency.shape[0],
        codec="elias_fano", device=device)
