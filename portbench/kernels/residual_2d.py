"""Work of one `ops.dispatch.residual_2d(v, f, lm)` call (K7, the 2D
residual), from its argument shapes: each input read once and each
output written once, whatever the kernel reads again; operations per
point as counted from the kernel's arithmetic (the PERF.md kernel
table's counts)."""

FINE, COARSE = 3, 0   # arrays read or written, fine and coarse
OPS_FINE, OPS_COARSE = 6, 0   # operations a fine, a coarse point


def cost(args):
    n = args[0].numel
    nc = 0
    return {"bytes": (FINE * n + COARSE * nc) * args[0].itemsize,
            "flops": OPS_FINE * n + OPS_COARSE * nc}
