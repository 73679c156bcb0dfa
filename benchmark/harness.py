"""One run of one cell: set-up, the measured window, the traced requests, the
check against the plain reference, and the result line.

Set-up (timed as setup_s, from the start of the process's script): load the
program's kernels, make the start state from the seed (`scenes/<kind>.py`),
plan the engine with the program's `plan_engine(..., **PLAN_REPAIRS)`,
build the chunk runner with `make_chunk_runner(cfg, **CHUNK_REPAIRS)` and
run the warm-up requests. The window then runs requests back to back until
`seconds` have passed and the last one has returned; every request starts
from a copy of the same start state (request.py). With `trace` a few more
requests run under torch.profiler after the window. Once the window has
closed and the memory peak is read, the program's state is freed and the
reference follows the same chunk from the same start state
(reference/plain_sph.py); the returned states of a sample of the window's
requests, drawn from the seed, are held against it (compare.py).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import os
import sys
import time
from typing import NamedTuple

import numpy as np

from . import compare, manifest, peaks, tracing
from .request import Outcome, Request, host

FOREIGN = ("jax", "jaxlib", "flax", "sphtpu")


def foreign_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not load."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FOREIGN))


class Context(NamedTuple):
    """What a metric reader reads (metrics/<name>.py: `read(ctx)`)."""

    cell: str
    n: int  # particles
    steps: int  # steps a request asks for
    setup_s: float
    window_s: float
    requests: list  # Outcome of each request of the window (states dropped)
    peak_bytes: int
    trace: object  # tracing.Trace of the traced requests, or None
    traced: list  # their Outcomes
    k3_traced: int  # K3 launches over the traced requests
    peaks: object  # the peaks module


def read_metric(root: str, name: str, ctx: Context):
    """The value `metrics/<name>.py` reads from ctx, or None."""
    path = os.path.join(manifest.bench_dir(root), "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def scene_maker(kind: str):
    return importlib.import_module(f"{__package__}.scenes.{kind}").make


def f32(x) -> float:
    return float(np.float32(x))


def _k3_launches() -> int:
    from sphtpu_torch.kernels import cuda_gravity

    return cuda_gravity.launches


def _strip(o: Outcome) -> Outcome:
    return o._replace(state=None, h=None, rho=None, stats=None, valid=None)


class Prepared(NamedTuple):
    """A cell's set-up for one seed: the inputs handed to both the program
    and the reference, the plan and the request."""

    cell: object  # manifest.Cell
    dev: object  # torch.device
    pos: np.ndarray  # float32 start state, as both sides get it
    vel: np.ndarray
    K: np.ndarray
    t0: float
    t_end: float
    phys: dict  # m, gamma, alpha, beta (float32 values)
    kh: int
    steps: int  # steps a request asks for
    cfg: object  # the planned EngineConfig
    req: Request
    stages_s: dict  # set-up stage -> seconds


def prepare(root: str, cell_name: str, seed: int, device: str, runners=None) -> Prepared:
    """Set-up steps 2-5: the kernels, the start state from `seed`, the plan
    (`plan_engine(..., **PLAN_REPAIRS)`), the chunk runner
    (`make_chunk_runner(cfg, **CHUNK_REPAIRS)`, or the one `runners` holds
    for the config) and the request."""
    stages, t = {}, time.perf_counter()

    def stage(name):
        nonlocal t
        now = time.perf_counter()
        stages[name] = now - t
        t = now

    import torch

    from sphtpu_torch.engine import driver, make_chunk_runner, params_from_numpy
    from sphtpu_torch.engine import state_from_numpy

    cell = manifest.Cell(root, cell_name)
    conf, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    stage("imports")
    if dev.type == "cuda":
        from sphtpu_torch.kernels import build

        build.load_kernels()
    stage("kernels")

    scene = scene_maker(conf["scene"])(conf, seed, root)
    stage("scene")
    pos, vel, K = (np.ascontiguousarray(a, dtype=np.float32) for a in (scene.pos, scene.vel, scene.K))
    n, kh, dtype = pos.shape[0], int(conf["Kh"]), conf["dtype"]
    if n != int(conf["N"]):
        raise ValueError(f"the scene has {n} particles, the configuration {conf['N']}")
    phys = dict(m=f32(scene.m), gamma=f32(conf["gamma"]), alpha=f32(conf["alpha"]),
                beta=f32(conf["beta"]))
    t0, t_end = f32(scene.t), f32(scene.t_end)
    params = params_from_numpy(**phys, cs0=0.0, U0=0.0, t_end=t_end, dtype=dtype, device=dev)
    start = state_from_numpy(pos, vel, K, t0, dtype=dtype, device=dev)
    stage("to_device")
    gravity = traffic["gravity"]
    if gravity == "auto":
        gravity = "p3m" if n >= driver.P3M_MIN_N else "exact"
    plan = driver.plan_engine(pos.astype(np.float64), scene.h, n=n, kh=kh, eos=conf["eos"],
                              dtype=dtype, gravity=gravity, **driver.PLAN_REPAIRS)
    if plan is None:
        raise RuntimeError("plan_engine planned no engine for the start state")
    cfg = plan[0]
    stage("plan")
    steps = traffic["steps"]
    steps = driver.ML_SUBCHUNK if steps == "ML_SUBCHUNK" else int(steps)
    runners = {} if runners is None else runners

    def runner_for(c):
        if c not in runners:
            runners[c] = make_chunk_runner(c, device=dev, **driver.CHUNK_REPAIRS)
        return runners[c]

    def replan(pos_host, h_host):
        return driver.plan_engine(pos_host, h_host, n=n, kh=kh, eos=conf["eos"], dtype=dtype,
                                  gravity=gravity, **driver.PLAN_REPAIRS)

    runner_for(cfg)
    req = Request(cfg, replan, runner_for, params, start, scene.h, steps, driver.PLAN_REPAIRS)
    stage("runner")
    return Prepared(cell, dev, pos, vel, K, t0, t_end, phys, kh, steps, cfg, req, stages)


def outputs(o: Outcome) -> dict:
    """A request's returned state and read-back on the host."""
    return dict(pos=host(o.state.pos), vel=host(o.state.vel), K=host(o.state.K),
                t=float(o.state.t), stats=o.stats, h=o.h, rho=o.rho)


def reference(p: Prepared, dtype=None) -> dict:
    """The plain reference's chunk from the same start state, in float64 (or
    `dtype`: the control's)."""
    import torch

    from .reference import plain_sph

    if p.dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return plain_sph.run_chunk(
        *(torch.from_numpy(a).to(p.dev) for a in (p.pos, p.vel, p.K)), p.t0,
        ph=plain_sph.Physics(kh=p.kh, **p.phys), t_end=p.t_end, n_steps=p.steps,
        dtype=dtype or torch.float64)


def readings(p: Prepared, out: dict, ref: dict) -> dict:
    return compare.numbers(out, ref, dict(pos=p.pos, vel=p.vel, t=p.t0), p.phys["m"])


def execute(root: str, cell_name: str, seed: int, seconds: float, trace: bool, *,
            device: str, t_start: float, log=sys.stderr) -> dict:
    """Runs the cell and returns the result line's object, `checks` last."""
    import torch

    t_prepare = time.perf_counter()
    p = prepare(root, cell_name, seed, device)
    t_warm = time.perf_counter()
    cell, dev, req, steps, traffic = p.cell, p.dev, p.req, p.steps, p.cell.traffic

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(int(traffic["warmup_requests"])):
        failure = req().failure
        if failure:
            raise RuntimeError(f"a warm-up request failed: {failure}")
    sync()
    setup_s = time.perf_counter() - t_start
    stages = dict(start=t_prepare - t_start, **p.stages_s, warmup=t_start + setup_s - t_warm)

    # the window
    rng = np.random.default_rng([abs(int(seed)), 7])
    n_check = int(traffic["checked_requests"])
    kept, sound, requests = [], 0, []
    w0 = time.perf_counter()
    deadline = w0 + seconds
    while True:
        o = req()
        requests.append(_strip(o))
        if o.failure is None and o.steps == steps:
            sound += 1
            if len(kept) < n_check:
                kept.append(o)
            else:
                j = int(rng.integers(sound))
                if j < n_check:
                    kept[j] = o
        del o
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - w0

    tr, traced, k3_traced = None, [], 0
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        k3_0 = _k3_launches()
        with profile(activities=acts) as prof:
            traced = [_strip(req()) for _ in range(int(traffic["traced_requests"]))]
            sync()
        k3_traced = _k3_launches() - k3_0
        tr = tracing.from_profiler(prof)
        del prof
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0

    # the check: the kept requests' outputs to the host, the program freed
    outs = [outputs(o) for o in kept]
    req_replans = req.replans
    cfg, n = p.cfg, p.pos.shape[0]
    prepared = p._replace(req=None)
    del kept, req, p
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference(prepared)
    reading_list = [readings(prepared, o, ref) for o in outs]
    ref_s = time.perf_counter() - t_ref
    limits = cell.spec["limits"]
    reading = compare.worst(reading_list) if reading_list else {k: float("nan") for k in limits}
    # a request that failed (raised, stopped short, or returned a state that
    # is not finite), in the window or traced, makes the run not correct
    n_failed = sum(o.failure is not None for o in requests + traced)
    correct = (bool(reading_list) and bool(ref["valid"].all()) and n_failed == 0
               and compare.judge(reading, limits))

    ctx = Context(cell_name, n, steps, setup_s, window_s, requests, peak, tr, traced,
                  k3_traced, peaks)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(kind):
        value = read_metric(root, m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "count": 1,
        "memory_peak_bytes": peak,
    }
    result = {
        "correct": correct,
        "attempted": len(requests),
        "failed": sum(o.failure is not None for o in requests),
        "metrics": metrics,
        "device": device_info,
    }
    if tr is not None:
        device_info["busy_s"] = tracing.busy_us(tr) * 1e-6
        device_info["window_s"] = (tr.window[1] - tr.window[0]) * 1e-6
        result["breakdown"] = tracing.breakdown(tr)
    spans = {}
    for o in requests:
        for k, v in o.span_s.items():
            spans.setdefault(k, []).append(v)
    result["span_ms"] = {k: 1e3 * sum(v) / len(v) for k, v in spans.items()}
    failures = sorted({o.failure for o in requests + traced if o.failure})
    print(f"cell {cell_name} seed {seed}: plan {describe(cfg)}, {steps} steps a request, "
          f"{len(requests)} requests in {window_s:.3f} s ({req_replans} picks planned afresh), "
          f"set-up {setup_s:.3f} s "
          f"({', '.join(f'{k} {v:.3f}' for k, v in stages.items())}), "
          f"reference {ref_s:.3f} s over {len(outs)} kept requests; readings {reading}"
          + (f"; failures: {failures}" if failures else ""), file=log)
    result["checks"] = {k: {"value": reading[k], "limit": v} for k, v in limits.items()}
    result["checks"]["failed_requests"] = {"value": n_failed, "limit": 0}
    return result


def describe(cfg) -> str:
    if cfg.mlevel is not None:
        return f"mlevel {cfg.mlevel!r} gravity {cfg.gravity}"
    if cfg.blocks is not None:
        return f"blocks {[list(b) for b in cfg.blocks[0]]} gravity {cfg.gravity}"
    return (f"tile {list(cfg.tile)} classes {cfg.tile_classes} budget {cfg.outlier_budget} "
            f"gravity {cfg.gravity}")
