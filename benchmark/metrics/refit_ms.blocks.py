"""Host milliseconds of the pick (the refit of the cached block spec,
block_args_for_spec, with the positions' read to the host) a request."""

from benchmark.metrics import _lib


def read(ctx):
    return _lib.span_ms(ctx, "bench.pick")
