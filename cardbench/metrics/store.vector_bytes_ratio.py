"""Sealed vector store bytes (block images + metadata, read from the
store's tensors) over the raw vectors; moves bytes_ratio."""
from cardbench import readers


def read(run):
    return readers.ratio(run, "store.vector_bytes", "store.vector_raw")
