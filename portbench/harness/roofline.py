"""Device time and least time of the dispatch calls in a traced window.

Read from the traced pass with dispatch spans (`ctx.dispatch`).  A call
is one dispatch span; its device time is that of the operations
whose innermost dispatch span it is.  Its least time comes from its
entry's work count (portbench/kernels/<entry>.py) and the peaks; calls of
an entry with no work count are unaccounted and stay out of the shares.
"""
from __future__ import annotations

from . import peaks, spec
from .spans import dispatch_entry


def calls(ctx):
    """{span idx: (entry, span name, device us)} of the window's calls."""
    out = {}
    for op in ctx.dispatch.ops:
        sp = ctx.dispatch.innermost(op,
                                    lambda n: dispatch_entry(n) is not None)
        if sp is None:
            continue
        entry, name, us = out.get(sp.idx, (dispatch_entry(sp.name),
                                           sp.name, 0.0))
        out[sp.idx] = (entry, name, us + op.dur)
    return out


def bound_us(entry: str, name: str, ctx):
    cost = spec.kernel_cost(entry)
    desc = ctx.calls.get(name)
    if cost is None or desc is None:
        return None
    work = cost(desc)
    itemsize = next(a.itemsize for a in desc
                    if getattr(a, "itemsize", None) is not None)
    return peaks.bound_s(work["bytes"], work["flops"], itemsize) * 1e6


def share(ctx, entry=None):
    """Sum of least times over sum of device times, in %, over the calls
    of `entry` (all accounted calls where None); None where no such call
    ran."""
    if ctx.dispatch is None:
        return None
    tb = tt = 0.0
    for e, name, us in calls(ctx).values():
        if entry is not None and e != entry:
            continue
        b = bound_us(e, name, ctx)
        if b is None or us <= 0:
            continue
        tb += b
        tt += us
    return 100.0 * tb / tt if tt > 0 else None
