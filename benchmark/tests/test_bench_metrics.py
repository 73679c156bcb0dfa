"""The metric arithmetic on synthetic traces and requests."""

import pytest

from benchmark import harness, peaks, tracing
from benchmark.request import Outcome

from .conftest import ROOT


def op(name, start, length, kind="kernel"):
    return tracing.Op(name, float(start), float(length), kind)


def outcome(steps=10, wall=1.0, pick=0.01, fallbacks=0, failure=None):
    return Outcome(steps, fallbacks, failure, wall, {"bench.pick": pick}, None, None, None,
                   None, None)


def context(trace=None, traced=(), requests=(), n=1000, k3_traced=0, window_s=2.0, peak=2**30):
    return harness.Context("c", n, 10, 3.0, window_s, list(requests), peak, trace, list(traced),
                           k3_traced, peaks)


def test_union_of_overlapping_intervals():
    ops = [op("a", 0, 10), op("b", 5, 10), op("c", 20, 5), op("d", 22, 1), op("e", 25, 5)]
    assert tracing.union(ops) == [(0.0, 15.0), (20.0, 30.0)]
    tr = tracing.Trace(ops, [], (0.0, 40.0))
    assert tracing.busy_us(tr) == 25.0


def test_gaps_are_named_by_the_open_span():
    spans = [op("bench.pick", 0, 12, "user_annotation"), op("bench.chunk", 12, 30, "user_annotation")]
    tr = tracing.Trace([op("k", 2, 3), op("k", 14, 10), op("k", 30, 5)], spans, (0.0, 42.0))
    # idle: [0, 2] and [5, 14] under the pick, [24, 30] and [35, 42] under the chunk
    assert tracing.gaps(tr) == [("bench.pick", 9.0), ("bench.chunk", 7.0),
                                ("bench.chunk", 6.0), ("bench.pick", 2.0)]
    bd = tracing.breakdown(tr)
    assert bd["device_ops"] == [["k", 18e-6]]
    assert len(bd["idle_gaps"]) == 4


def test_chrome_events_are_read_by_category():
    events = [
        {"ph": "X", "cat": "kernel", "name": "void sph::newton_sweep_kernel<float>", "ts": 10, "dur": 5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 16, "dur": 1},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "bench.chunk", "ts": 9, "dur": 9},
        {"ph": "X", "cat": "user_annotation", "name": "bench.chunk", "ts": 8, "dur": 12},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 8, "dur": 1},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3},
    ]
    tr = tracing.read(events)
    assert [o.name for o in tr.ops] == ["void sph::newton_sweep_kernel<float>", "Memcpy DtoH"]
    assert [s.name for s in tr.spans] == ["bench.chunk"] and tr.window == (8.0, 20.0)


def test_rate_counts_every_step_over_the_whole_window():
    # a failed request's steps are not work done, whatever it returned
    reqs = [outcome(10), outcome(10), outcome(4, fallbacks=2), outcome(0, failure="x"),
            outcome(10, failure="the returned state is not finite")]
    ctx = context(requests=reqs, n=1000, window_s=2.0)
    assert harness.read_metric(ROOT, "particle_steps_per_s", ctx) == 1000 * 24 / 2.0
    assert harness.read_metric(ROOT, "rate.blocks", ctx) == 1000 * 24 / 2.0
    assert harness.read_metric(ROOT, "fallback_evals.tiles", ctx) == 2
    assert harness.read_metric(ROOT, "pick_ms.tiles", ctx) == pytest.approx(10.0)
    assert harness.read_metric(ROOT, "peak_device_gib", ctx) == 1.0


def test_device_metrics_per_step_and_idle_share():
    ops = [op("void sph::phase_a_kernel", 0, 400), op("void at::native::elementwise", 300, 300),
           op("Memcpy DtoH", 700, 100, "gpu_memcpy")]
    tr = tracing.Trace(ops, [], (0.0, 1000.0))
    reqs = [outcome(10, wall=2e-3)] * 3
    ctx = context(trace=tr, traced=[outcome(10, wall=3e-3)], requests=reqs)
    assert harness.read_metric(ROOT, "launches_per_step.tiles", ctx) == pytest.approx(0.2)
    assert harness.read_metric(ROOT, "sph_ms_per_step.tiles", ctx) == pytest.approx(0.04)
    assert harness.read_metric(ROOT, "torch_ms_per_step.tiles", ctx) == pytest.approx(0.04)
    # busy 700 us of the untraced request's 2 000 us
    assert harness.read_metric(ROOT, "idle_share.tiles", ctx) == pytest.approx(65.0)
    assert harness.read_metric(ROOT, "idle_share.blocks", ctx) == pytest.approx(65.0)


def test_k3_roofline_from_the_launch_count():
    n = 200_000
    assert peaks.k3_flops(n, 3) == 3 * n * n * 20
    need = peaks.k3_min_seconds(n, 4)  # 4 sweeps: 11.94 ms at 67 TFLOP/s
    assert need == pytest.approx(4 * 4e10 * 20 / 67e12)
    ops = [op("void sph::newton_sweep_kernel<float, 4, true>", 0, 1e6 * need),
           op("void sph::newton_reduce_kernel<float>", 0, 1e6 * need),
           op("void sph::phase_a_kernel", 0, 5e3)]
    tr = tracing.Trace(ops, [], (0.0, 1.0))
    ctx = context(trace=tr, traced=[outcome()], n=n, k3_traced=4)
    assert harness.read_metric(ROOT, "k3_roofline", ctx) == pytest.approx(50.0)
    assert harness.read_metric(ROOT, "k3_roofline", context(trace=tr, n=n)) is None

