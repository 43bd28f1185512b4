"""Work of one `ops.dispatch.restrict_pt(r, lmf, lmc)` call (K18, P^T r: r
read, the coarse r written), from its argument shapes: each input read
once and each output written once, whatever the kernel reads again;
operations per point as counted from the kernel's arithmetic (the
PERF.md kernel table's counts)."""

FINE, COARSE = 1, 1   # arrays read or written, fine and coarse
OPS_FINE, OPS_COARSE = 0, 40   # operations a fine, a coarse point


def cost(args):
    n = args[0].numel
    nc = args[2].value ** 3
    return {"bytes": (FINE * n + COARSE * nc) * args[0].itemsize,
            "flops": OPS_FINE * n + OPS_COARSE * nc}
