"""Hierarchy build: host-clock ms of the build (with a synchronize) in
each request of a traced run's plain pass (no profiler, no spans) of a
traffic that rebuilds, averaged."""


def read(ctx):
    b = ctx.counters["build_ms"]
    return sum(b) / len(b) if b else None
