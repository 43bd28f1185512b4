"""Hierarchy build: host-clock seconds of the set-up's one build (with a
synchronize), part of setup_s."""


def read(ctx):
    return ctx.counters.get("build_s_setup")
