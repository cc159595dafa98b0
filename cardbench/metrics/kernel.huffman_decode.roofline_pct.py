"""Byte bound of the traced restores' segment decodes at 3.35 TB/s over the
device time of kernels named huffman_decode (%); moves load_gbs."""
from cardbench import readers


def read(run):
    return readers.kernel_roofline_pct(
        run, "huffman.bytes", "main", "huffman_decode")
