"""Work of one `ops.dispatch.prolong_correct_rb(c, v, f, lmf, wc, woff)`
call (K37, v + P c then a sweep: c, v, f read, v written), from its
argument shapes: each input read once and each output written once,
whatever the kernel reads again; operations per point as counted from
the kernel's arithmetic (the PERF.md kernel table's counts)."""

FINE, COARSE = 3, 1   # arrays read or written, fine and coarse
OPS_FINE, OPS_COARSE = 12, 0   # operations a fine, a coarse point


def cost(args):
    n = args[1].numel
    nc = args[0].numel
    return {"bytes": (FINE * n + COARSE * nc) * args[0].itemsize,
            "flops": OPS_FINE * n + OPS_COARSE * nc}
