"""Work of one `ops.dispatch.rb_residual_restrict(v, f, lmf, lmc, wc,
woff)` call (K36, a sweep with the residual and P^T: v read and written,
f read, the coarse f written), from its argument shapes: each input read
once and each output written once, whatever the kernel reads again;
operations per point as counted from the kernel's arithmetic (the
PERF.md kernel table's counts)."""

FINE, COARSE = 3, 1   # arrays read or written, fine and coarse
OPS_FINE, OPS_COARSE = 17, 40   # operations a fine, a coarse point


def cost(args):
    n = args[0].numel
    nc = args[3].value ** 3
    return {"bytes": (FINE * n + COARSE * nc) * args[0].itemsize,
            "flops": OPS_FINE * n + OPS_COARSE * nc}
