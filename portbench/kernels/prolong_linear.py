"""Work of one `ops.dispatch.prolong_linear(c, lmf, v=None)` call (K3, P c,
or v + P c where v is given: c (and v) read, the fine result written),
from its argument shapes: each input read once and each output written
once, whatever the kernel reads again; operations per point as counted
from the kernel's arithmetic (the PERF.md kernel table's counts)."""

OPS_WITHOUT_V, OPS_WITH_V = 3, 4   # operations a fine point


def cost(args):
    n = args[1].value ** 3
    nc = args[0].numel
    with_v = len(args) > 2 and getattr(args[2], "shape", None) is not None
    fine = 2 if with_v else 1
    ops = OPS_WITH_V if with_v else OPS_WITHOUT_V
    return {"bytes": (fine * n + nc) * args[0].itemsize, "flops": ops * n}
