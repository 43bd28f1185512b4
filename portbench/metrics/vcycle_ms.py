"""V-cycle: device ms of the operations launched in a cycle rooted at the
finest level (a vcycle span [L/L] of fmg or krylov), a cycle."""


def finest_rooted(name):
    if not name.endswith("]") or ".vcycle[" not in name:
        return False
    lidx, top = name.rsplit("[", 1)[1][:-1].split("/")
    return lidx == top


def read(ctx):
    if ctx.view is None:
        return None
    cycles = ctx.view.spans_where(finest_rooted)
    if not cycles:
        return None
    ops = ctx.view.ops_where(finest_rooted)
    return ctx.view.total_ms(ops) / len(cycles)
