"""Work of one `ops.dispatch.restrict_residual_pt(v, f, lmf, lmc, wc,
woff)` call (K2, P^T (f - A v): v, f read, the coarse f written), from
its argument shapes: each input read once and each output written once,
whatever the kernel reads again; operations per point as counted from
the kernel's arithmetic (the PERF.md kernel table's counts)."""

FINE, COARSE = 2, 1   # arrays read or written, fine and coarse
OPS_FINE, OPS_COARSE = 9, 40   # operations a fine, a coarse point


def cost(args):
    n = args[0].numel
    nc = args[3].value ** 3
    return {"bytes": (FINE * n + COARSE * nc) * args[0].itemsize,
            "flops": OPS_FINE * n + OPS_COARSE * nc}
