"""Kernels: least time over device time, in %, summed over the traced
dispatch calls whose entry has a work count (portbench/kernels/)."""
from portbench.harness.roofline import share


def read(ctx):
    return share(ctx)
