"""Solver loop: V-cycles after FMG (solve) or MG-CG iterations
(solve_mgcg) a traced request, as the solve's result reports them."""


def read(ctx):
    c = ctx.counters["cycles"]
    return sum(c) / len(c) if c else None
