"""FMG ramp: ms from the first to the last device operation launched in
a request's fmg_ramp span (idle gaps inside it included), averaged over
the traced requests that ran one."""


def read(ctx):
    if ctx.view is None:
        return None
    ext = {}
    for op in ctx.view.ops_where(lambda n: n.endswith(".fmg_ramp")):
        req = ctx.view.request_of(op)
        if req is None:
            continue
        s, e = ext.get(req.idx, (op.start, op.end))
        ext[req.idx] = (min(s, op.start), max(e, op.end))
    if not ext:
        return None
    return sum(e - s for s, e in ext.values()) / len(ext) / 1e3
