"""The §3.5 update path: snapshots with a device view and batch-visible
deletes (``consistency.py``), and the streaming index that merges buffered
inserts and deletes into the graph and the stores (``fresh.py``)."""
