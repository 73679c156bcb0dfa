"""Force evaluations of the window's requests that fell back to the gather
engine, as the chunks returned them (tiles)."""

from benchmark.metrics import _lib


def read(ctx):
    return _lib.fallbacks(ctx)
