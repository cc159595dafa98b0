"""Sealed index store bytes (block image + sparse index, read from the
store's tensors) over n*4*(R+1); moves bytes_ratio."""
from cardbench import readers


def read(run):
    return readers.ratio(run, "store.index_bytes", "store.index_raw")
