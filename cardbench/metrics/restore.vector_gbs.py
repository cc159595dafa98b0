"""Vector bytes restored over the seconds inside the vector store's get
(GB/s); moves load_gbs."""
from cardbench import readers


def read(run):
    return readers.gbs(run, "restore.vector_moved", "restore.get")
