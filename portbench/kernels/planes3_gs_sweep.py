"""Work of one `ops.dispatch.planes3_gs_sweep(v, f, planes, offsets)` call
(K17, a multicolour Gauss-Seidel sweep on stored planes: the K planes
and f read, v read and written), from its argument shapes: each input
read once and each output written once, whatever the kernel reads again;
operations per point as counted from the kernel's arithmetic (the
PERF.md kernel table's counts)."""

GRID_ARRAYS = 3        # v, f and the result (or v twice)
EXTRA_OPS = 4   # operations a point beyond a multiply and an add a plane


def cost(args):
    n = args[0].numel
    planes = args[2]
    k = planes.shape[0]
    return {"bytes": (planes.numel + GRID_ARRAYS * n) * args[0].itemsize,
            "flops": (2 * k + EXTRA_OPS) * n}
