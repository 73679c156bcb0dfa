"""Per-stage instrumentation, the counterpart of the reference's @debug
wall-clock timers (polytrope_hydroKDTree.jl:253-289, gravOctree_Single.jl:
308-317).

Two layers:
- `stage(name)` — an NVTX range when CUDA is in use, so stages show up
  with the reference's taxonomy (hydro / gravity / ...) in profiler
  timelines; a no-op context otherwise.
- `StageTimer` — host-side wall-clock accumulator for run-loop stages
  (chunk execution, snapshot I/O, rendering). Enabled with
  SPHTPU_PROFILE=1 or explicitly; prints a summary table.

For kernel-level profiling use `trace(logdir)`, which wraps
torch.profiler and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def stage(name: str):
    """Named range for a compute stage (shows up in profiler timelines)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.nvtx.range(f"sph/{name}")
    return contextlib.nullcontext()


class StageTimer:
    def __init__(self, enabled: bool | None = None):
        if enabled is None:
            enabled = bool(os.environ.get("SPHTPU_PROFILE"))
        self.enabled = enabled
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        if not self.totals:
            return ""
        width = max(len(k) for k in self.totals)
        lines = ["stage timing (wall seconds):"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"  {name:<{width}}  {total:9.3f}s  x{self.counts[name]}"
            )
        return "\n".join(lines)

    def report(self) -> None:
        if self.enabled and self.totals:
            print(self.summary())


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace (CPU + CUDA activities) written as a Chrome
    trace under logdir."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
