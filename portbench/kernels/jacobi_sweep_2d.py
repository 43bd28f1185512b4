"""Work of one `ops.dispatch.jacobi_sweep_2d(v, df, lm, w)` call (K5, a 2D
weighted Jacobi sweep), from its argument shapes: each input read once
and each output written once, whatever the kernel reads again;
operations per point as counted from the kernel's arithmetic (the
PERF.md kernel table's counts)."""

FINE, COARSE = 3, 0   # arrays read or written, fine and coarse
OPS_FINE, OPS_COARSE = 8, 0   # operations a fine, a coarse point


def cost(args):
    n = args[0].numel
    nc = 0
    return {"bytes": (FINE * n + COARSE * nc) * args[0].itemsize,
            "flops": OPS_FINE * n + OPS_COARSE * nc}
