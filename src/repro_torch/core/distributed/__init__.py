"""Sharded indexes: partitioning, per-shard builds and query routing
(``sharded_index.py``)."""
