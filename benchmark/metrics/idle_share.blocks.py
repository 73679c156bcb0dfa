"""Percent of the untraced requests' wall in which no operation ran on the
device: 1 - the union of the device operations' intervals over the traced
requests / the mean untraced request's wall x their number (blocks)."""

from benchmark.metrics import _lib


def read(ctx):
    return _lib.idle_share(ctx)
