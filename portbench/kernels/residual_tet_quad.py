"""Work of one `ops.dispatch.residual_tet_quad(v, f, lm, wc, woff,
diagonal)` call (K4, r = f - A v and r^T M r on the uniform P1 mass: v,
f read), from its argument shapes: each input read once and each output
written once, whatever the kernel reads again; operations per point as
counted from the kernel's arithmetic (the PERF.md kernel table's
counts)."""

FINE, COARSE = 2, 0   # arrays read or written, fine and coarse
OPS_FINE, OPS_COARSE = 63, 0   # operations a fine, a coarse point


def cost(args):
    n = args[0].numel
    nc = 0
    return {"bytes": (FINE * n + COARSE * nc) * args[0].itemsize,
            "flops": OPS_FINE * n + OPS_COARSE * nc}
