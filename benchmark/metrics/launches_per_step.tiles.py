"""Device kernels the profiler saw a step over the traced requests (tiles)."""

from benchmark.metrics import _lib


def read(ctx):
    return _lib.kernels_per_step(ctx)
