"""Seconds from the start of the benchmark's script to the window: imports,
kernels loaded, the start state made, the plan, the runner, the warm-up."""


def read(ctx):
    return ctx.setup_s
