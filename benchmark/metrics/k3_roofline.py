"""K3's share of its roofline: the least time the card could take for the
sweeps the traced requests ran (N^2 x 20 operations each, at 67 TFLOP/s in
float32; the count from the wrapper's launch counter) over the device time
of K3's kernels in the same trace, in percent."""

from benchmark.metrics import _lib


def read(ctx):
    if ctx.trace is None or not ctx.k3_traced:
        return None
    k3_us = sum(o.length for o in ctx.trace.ops
                if o.kind == "kernel" and any(k in o.name for k in _lib.K3_KERNELS))
    if not k3_us:
        return None
    return 100.0 * ctx.peaks.k3_min_seconds(ctx.n, ctx.k3_traced) / (k3_us * 1e-6)
