"""Device: % of the traced window (first request's start to the last
one's end) in which no device operation ran."""


def read(ctx):
    if ctx.view is None or ctx.view.window_us <= 0:
        return None
    return 100.0 * (1.0 - ctx.view.busy_us() / ctx.view.window_us)
