"""Work of one `ops.dispatch.tail_up(v0, f_top, vs, fs, lms, weights, nu2)`
call (K14, the fused coarse tail's up leg: the coarse solution, f of the
top level, the down leg's v and f read, v of the top level written),
from its argument shapes: each input read once and each output written
once, whatever the kernel reads again; operations per point as counted
from the kernel's arithmetic (the PERF.md kernel table's counts)."""

OPS_CORRECT, OPS_SWEEP = 4, 8   # operations a fine point


def cost(args):
    lms = [a.value for a in args[4]]
    nu2 = args[6].value
    pts = [lm ** 3 for lm in lms]            # coarsest first
    words = (args[0].numel + 2 * args[1].numel
             + sum(a.numel for a in args[2]) + sum(a.numel for a in args[3]))
    flops = sum((OPS_CORRECT + nu2 * OPS_SWEEP) * p for p in pts[1:])
    return {"bytes": words * args[0].itemsize, "flops": flops}
