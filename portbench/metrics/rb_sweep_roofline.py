"""Kernels: K1's (dispatch rb_sweep) least time over its device time, in
%, over the traced calls."""
from portbench.harness.roofline import share


def read(ctx):
    return share(ctx, "rb_sweep")
