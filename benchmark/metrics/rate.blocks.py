"""Particle-steps a second in the host-paced block regime: N x the steps all
requests of the window completed, over the whole window (the host refit in
every request). A per-layer metric: its runs spread too widely for an
end-to-end bound (PERF.md)."""

from benchmark.metrics import _lib


def read(ctx):
    return _lib.rate(ctx)
