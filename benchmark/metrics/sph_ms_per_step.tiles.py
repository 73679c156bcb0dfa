"""Device milliseconds a step of the program's hand-written kernels
(namespace sph) (tiles)."""

from benchmark.metrics import _lib


def read(ctx):
    return _lib.device_ms_per_step(ctx, lambda o: _lib.HAND_WRITTEN in o.name)
