"""Coarse solve: device ms of the operations launched in
CoarseSolver.solve spans (FMG start, every cycle's coarsest level), a
request."""


def read(ctx):
    if ctx.view is None or not ctx.view.n_requests:
        return None
    ops = ctx.view.ops_where(lambda n: n == "coarse.solve")
    if not ops:
        return None
    return ctx.view.total_ms(ops) / ctx.view.n_requests
