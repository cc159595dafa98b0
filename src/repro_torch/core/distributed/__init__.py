"""Sharded indexes: partitioning, per-shard builds, query routing and the
cross-shard merges of a sharded search (``sharded_index.py``)."""
from . import sharded_index  # noqa: F401
from .sharded_index import (Mesh, ShardedIndex, ShardRouter,  # noqa: F401
                            build_router, build_sharded_index,
                            lower_production_search,
                            make_mesh, make_process_mesh,
                            make_sharded_search, merge_comm_rows,
                            merge_sharded, place_on_mesh, route_mask,
                            shard_topk)
