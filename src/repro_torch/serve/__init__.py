"""The serving tier: batched, shard-fanned ANN search with the paper's I/O
model replayed per served batch (``ann.py``)."""
