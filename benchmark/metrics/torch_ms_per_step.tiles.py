"""Device milliseconds a step of the operations outside the program's
namespace sph: torch's and cuFFT's kernels, copies and fills (tiles)."""

from benchmark.metrics import _lib


def read(ctx):
    return _lib.device_ms_per_step(ctx, lambda o: _lib.HAND_WRITTEN not in o.name)
