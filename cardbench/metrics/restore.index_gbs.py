"""Adjacency bytes restored over the seconds inside the index store's
decode_batch (GB/s); moves load_gbs."""
from cardbench import readers


def read(run):
    return readers.gbs(run, "restore.index_moved", "restore.decode")
