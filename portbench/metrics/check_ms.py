"""Per-cycle check: device ms of the operations launched in check_norm
spans (the zero iterate's and one a cycle or iteration), a request."""


def read(ctx):
    if ctx.view is None or not ctx.view.n_requests:
        return None
    ops = ctx.view.ops_where(lambda n: n.endswith(".check_norm"))
    if not ops:
        return None
    return ctx.view.total_ms(ops) / ctx.view.n_requests
