"""Byte bound of a batch's fused hops at 3.35 TB/s over the device time of
kernels named beam_step (%); moves qps."""
from cardbench import readers


def read(run):
    return readers.kernel_roofline_pct(
        run, "beam_step.bytes", "search", "beam_step")
