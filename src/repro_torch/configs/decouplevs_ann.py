"""The paper's own workload config: a sharded DecoupleVS ANNS deployment.

Production point (SIFT1B-scale, paper §4.1): 1B vectors, 128-dim uint8,
R=128 graph degree, PQ m=32, shard the dataset over 32 data shards (each
holds ~31M vectors + its sub-graph); beam search fans out to all shards and
a global top-K merge runs over them. One H100 holds one such shard.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class ANNConfig:
    name: str = "decouplevs-ann"
    n_vectors: int = 1_000_000_000
    dim: int = 128
    dtype: str = "uint8"
    r: int = 128                      # graph degree (paper 1B setting)
    pq_m: int = 32
    l_size: int = 200                 # candidate list (paper L_b for 1B)
    beam_width: int = 4
    k: int = 10
    rerank_batch: int = 10
    segment_bytes: int = 512 << 20
    chunk_bytes: int = 4 << 20
    cache_ratio: float = 0.001        # 0.1% of dataset (paper 1B setting)
    query_batch: int = 1024           # concurrent queries per search step


CONFIG = ANNConfig()


def smoke_config() -> ANNConfig:
    return ANNConfig(name="decouplevs-ann-smoke", n_vectors=2048, dim=32,
                     r=16, pq_m=8, l_size=32, query_batch=8)
