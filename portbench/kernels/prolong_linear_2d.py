"""Work of one `ops.dispatch.prolong_linear_2d(c, lmf)` call (K9, 2D P c: c
read, the fine result written), from its argument shapes: each input
read once and each output written once, whatever the kernel reads again;
operations per point as counted from the kernel's arithmetic (the
PERF.md kernel table's counts)."""

OPS_FINE = 2   # operations a fine point


def cost(args):
    n = args[1].value ** 2
    nc = args[0].numel
    return {"bytes": (n + nc) * args[0].itemsize, "flops": OPS_FINE * n}
