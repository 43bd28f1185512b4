"""Dispatch: launches of the port's kernel wrappers a traced request, the
sum of ops.cuda.launch_counts() over the traced requests."""


def read(ctx):
    n = ctx.counters.get("requests")
    launches = ctx.counters.get("launches")
    if not n or launches is None or ctx.view is None:
        return None
    return launches / n
