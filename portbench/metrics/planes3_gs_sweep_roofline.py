"""Kernels: K17's (dispatch planes3_gs_sweep) least time over its device
time, in %, over the traced calls."""
from portbench.harness.roofline import share


def read(ctx):
    return share(ctx, "planes3_gs_sweep")
