"""The system under test: the names the benchmark takes from ``repro_torch``.

This is the only module of the benchmark that imports the program. It puts
the checkout's ``src`` on ``sys.path`` and imports the port's modules, none
of which imports ``jax`` or the JAX package ``repro``.
"""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def load() -> SimpleNamespace:
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.core.codec.elias_fano import (encode_slots_torch,
                                                   slot_layout)
    from repro_torch.core.graph.pq import encode_pq_torch
    from repro_torch.core.search import beam
    from repro_torch.core.storage.index_store import CompressedIndexStore
    from repro_torch.core.storage.vector_store import (DecoupledVectorStore,
                                                       StoreConfig)
    from repro_torch.kernels import build
    from repro_torch.serve import ann
    return SimpleNamespace(
        DeviceIndex=beam.DeviceIndex, SearchParams=beam.SearchParams,
        search=beam.search, encode_pq_torch=encode_pq_torch,
        encode_slots_torch=encode_slots_torch, slot_layout=slot_layout,
        BatchedSearcher=ann.BatchedSearcher, ServeConfig=ann.ServeConfig,
        DecoupledVectorStore=DecoupledVectorStore, StoreConfig=StoreConfig,
        CompressedIndexStore=CompressedIndexStore, launches=build.LAUNCHES)
