"""Host milliseconds of the pick (the cached tile config's forecast,
tile_params_still_ok, with the positions' read to the host) a request."""

from benchmark.metrics import _lib


def read(ctx):
    return _lib.span_ms(ctx, "bench.pick")
