"""Krylov algebra: device ms of the operations a request launches outside
the preconditioner, A p, the residual and the check (no fmg., krylov.,
coarse. or dispatch. span around them, in the pass with dispatch spans),
an MG-CG iteration of that pass."""

OWNED = ("fmg.", "krylov.", "coarse.", "dispatch.")


def read(ctx):
    v = ctx.dispatch
    if v is None:
        return None
    iters = sum(ctx.counters["cycles_dispatch"])
    if not iters:
        return None
    ops = [o for o in v.ops
           if v.request_of(o) is not None
           and not any(s.name.startswith(OWNED) for s in o.stack)]
    return v.total_ms(ops) / iters
