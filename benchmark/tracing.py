"""The traced requests' profile, reduced to device operations and host spans.

`torch.profiler` records the device's kernels, copies and fills with their
start and length on the host's clock, and the benchmark's own spans
(`record_function`, category `user_annotation`). The profile is exported as a
Chrome trace to a temporary file (under TMPDIR), read and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import NamedTuple

DEVICE_CATEGORIES = {"kernel", "gpu_memcpy", "gpu_memset"}


class Op(NamedTuple):
    name: str
    start: float  # microseconds
    length: float  # microseconds
    kind: str  # its trace category


class Trace(NamedTuple):
    ops: list  # device operations, by start
    spans: list  # host spans of the benchmark (name "bench.*"), by start
    window: tuple  # (start, end) of the traced requests, microseconds


def read(events: list) -> Trace:
    """A Trace from a Chrome trace's events; its window is that of the
    benchmark spans it holds."""
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATEGORIES:
            ops.append(Op(e["name"], float(e["ts"]), float(e["dur"]), cat))
        elif cat == "user_annotation" and e["name"].startswith("bench."):
            spans.append(Op(e["name"], float(e["ts"]), float(e["dur"]), cat))
    ops.sort(key=lambda o: o.start)
    spans.sort(key=lambda o: o.start)
    window = (spans[0].start, max(s.start + s.length for s in spans)) if spans else None
    return Trace(ops, spans, window)


def from_profiler(prof) -> Trace:
    """The Trace of a finished torch.profiler session."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return read(events)


def union(ops: list) -> list:
    """The intervals (start, end) covered by `ops`, merged, in order."""
    out = []
    for o in sorted(ops, key=lambda o: o.start):
        s, e = o.start, o.start + o.length
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def busy_us(trace: Trace) -> float:
    """Microseconds in which some device operation ran."""
    return sum(e - s for s, e in union(trace.ops))


def span_at(trace: Trace, t: float) -> str:
    """The innermost benchmark span open on the host at time t."""
    best = None
    for s in trace.spans:
        if s.start <= t <= s.start + s.length and (best is None or s.length < best.length):
            best = s
    return best.name if best is not None else "host"


def gaps(trace: Trace) -> list:
    """(label, microseconds) of each idle stretch of the device inside the
    window, labelled by the span open on the host at its middle; longest
    first."""
    lo, hi = trace.window
    out = []
    t = lo
    for s, e in union(trace.ops) + [(hi, hi)]:
        s, e = max(s, lo), min(e, hi)
        if s > t:
            out.append((span_at(trace, 0.5 * (t + s)), s - t))
        t = max(t, e)
    return sorted(out, key=lambda g: -g[1])


def by_name(trace: Trace) -> list:
    """(name, total microseconds) of the device operations, most time first."""
    acc = {}
    for o in trace.ops:
        acc[o.name] = acc.get(o.name, 0.0) + o.length
    return sorted(acc.items(), key=lambda r: -r[1])


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The result line's `breakdown`: the device operations that took most
    time and the longest idle gaps, in seconds."""
    return {
        "device_ops": [[name[:120], us * 1e-6] for name, us in by_name(trace)[:top]],
        "idle_gaps": [[label, us * 1e-6] for label, us in gaps(trace)[:top]],
    }
