"""Shared pieces of the benchmark's CPU tests: tiny configurations of the
benchmark's own, and a card fixture for the cases that need one."""
from __future__ import annotations

import copy

import pytest
import torch

from cardbench import bench


def tiny(name: str, **over) -> dict:
    """``name``'s configuration at a size the CPU holds in a second:
    12,000 rows in clusters of 200, R = 16, L = 32."""
    cfg = copy.deepcopy(bench.load_config(name))
    cfg.update(n_vectors=12000, dim=32 if cfg["dtype"] == "uint8" else 24,
               r=16, pq_m=8, l_size=32, segment_bytes=1 << 16,
               chunk_bytes=1 << 13, query_pool=300)
    cfg["assumed"]["generator"].update(cluster_size=200, pq_sample=4000,
                                       graph_batch_elems=1 << 22,
                                       long_links=4)
    cfg.update(over)
    return cfg


@pytest.fixture
def tiny_config():
    return tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
