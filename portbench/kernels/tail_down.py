"""Work of one `ops.dispatch.tail_down(f_top, lms, weights, nu1)` call
(K13, the fused coarse tail's down leg: f of the top level read; v of
each level from the top to level 1 and the restricted f of each level
below the top written), from its argument shapes: each input read once
and each output written once, whatever the kernel reads again;
operations per point as counted from the kernel's arithmetic (the
PERF.md kernel table's counts)."""

OPS_SWEEP, OPS_RESIDUAL, OPS_RESTRICT = 8, 9, 40   # a fine, a coarse point


def cost(args):
    lms = [a.value for a in args[1]]
    nu1 = args[3].value
    pts = [lm ** 3 for lm in lms]            # coarsest first
    top = len(pts) - 1
    words = pts[top] + sum(pts[1:]) + sum(pts[:top])
    flops = sum((nu1 * OPS_SWEEP + OPS_RESIDUAL) * pts[l]
                + OPS_RESTRICT * pts[l - 1] for l in range(1, top + 1))
    return {"bytes": words * args[0].itemsize, "flops": flops}
