"""Work of one `ops.dispatch.p2_jacobi_sweep(v, f, tables, offsets, w,
out=None)` call (K20, a P2 snap-Jacobi sweep), from its argument shapes:
each input read once and each output written once, whatever the kernel
reads again; operations per point as counted from the kernel's
arithmetic (the PERF.md kernel table's counts). The P2 kernels apply one
multiply and one add an offset of the stencil (len(offsets) of them) and
one more operation a point."""

FINE, COARSE = 3, 0   # arrays read or written, fine and coarse


def cost(args):
    n = args[0].numel
    nc = 0
    return {"bytes": (FINE * n + COARSE * nc) * args[0].itemsize,
            "flops": (2 * len(args[3]) + 1) * n}
