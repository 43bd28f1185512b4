"""Work of one `ops.dispatch.cheby_step(v, vp, f, lm, wc, woff, a, b)` call
(K12, a Chebyshev step: v, vp, f read, the new v written), from its
argument shapes: each input read once and each output written once,
whatever the kernel reads again; operations per point as counted from
the kernel's arithmetic (the PERF.md kernel table's counts)."""

FINE, COARSE = 4, 0   # arrays read or written, fine and coarse
OPS_FINE, OPS_COARSE = 14, 0   # operations a fine, a coarse point


def cost(args):
    n = args[0].numel
    nc = 0
    return {"bytes": (FINE * n + COARSE * nc) * args[0].itemsize,
            "flops": OPS_FINE * n + OPS_COARSE * nc}
