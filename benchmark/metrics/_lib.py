"""Arithmetic the metric readers share."""

from __future__ import annotations

HAND_WRITTEN = "sph::"  # the namespace of the program's CUDA kernels
K3_KERNELS = ("newton_sweep_kernel", "newton_reduce_kernel")


def steps_done(requests) -> int:
    """Steps of the requests that did not fail: a failed request's steps,
    whatever it returned, are not work done."""
    return sum(o.steps for o in requests if o.failure is None)


def rate(ctx) -> float:
    """Particle-steps completed by the window's sound requests over the
    window's seconds."""
    return ctx.n * steps_done(ctx.requests) / ctx.window_s


def span_ms(ctx, span: str) -> float:
    """Mean host milliseconds of a benchmark span over the window's requests
    that reached it."""
    vals = [o.span_s[span] for o in ctx.requests if span in o.span_s]
    return 1e3 * sum(vals) / len(vals) if vals else None


def traced_steps(ctx) -> int:
    return steps_done(ctx.traced)


def device_ms_per_step(ctx, keep) -> float:
    """Device milliseconds a traced step of the operations `keep` accepts."""
    if ctx.trace is None or not ctx.trace.ops or not traced_steps(ctx):
        return None
    return sum(o.length for o in ctx.trace.ops if keep(o)) * 1e-3 / traced_steps(ctx)


def kernels_per_step(ctx) -> float:
    if ctx.trace is None or not ctx.trace.ops or not traced_steps(ctx):
        return None
    return sum(o.kind == "kernel" for o in ctx.trace.ops) / traced_steps(ctx)


def idle_share(ctx) -> float:
    """100 x (1 - the device's busy time over the traced requests / the mean
    untraced request's wall x their number)."""
    from benchmark import tracing

    if ctx.trace is None or not ctx.trace.ops or not ctx.traced:
        return None
    walls = [o.wall_s for o in ctx.requests if o.failure is None]
    if not walls:
        return None
    wall_us = 1e6 * sum(walls) / len(walls) * len(ctx.traced)
    return 100.0 * (1.0 - tracing.busy_us(ctx.trace) / wall_us)


def fallbacks(ctx) -> int:
    return sum(o.fallbacks for o in ctx.requests)

