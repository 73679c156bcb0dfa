"""Particle-steps a second: N x the steps all requests of the window
completed, over the whole window (tile-engine cells)."""

from benchmark.metrics import _lib


def read(ctx):
    return _lib.rate(ctx)
