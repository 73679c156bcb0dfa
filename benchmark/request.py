"""A request: the run loop's per-chunk path from a fixed start state.

`engine/driver.py::run_simulation` does, between two snapshots of a
single-device run: the pick (a cached tile config's forecast,
`tile_params_still_ok`, or a cached block spec's refit,
`block_args_for_spec`), one chunk of the chunk runner, and the read-back of
h, rho, the stats rows, `valid` and the fallback count. The pick is a
closure inside `run_simulation`, so the part of it that one cached config
runs is copied here, frozen: the cached config's forecast (tiles), strip
lists refreshed for its spec (`mlevel_args_still_ok`, multi-level) or refit
(blocks), and where that declines, a fresh plan (`plan_engine`) and the
runner of the config it returns; the chunk runner and the planners are the
program's. Each part runs inside a span of its own
(`torch.profiler.record_function`): `bench.start` (the device copy of the
start state), `bench.pick`, `bench.chunk`, `bench.readback`, `bench.check`
(the finiteness of the returned state).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

def host(x: torch.Tensor) -> np.ndarray:
    """The run loop's device-to-host read (driver._host)."""
    return x.detach().to("cpu", torch.float64).numpy()


class Outcome(NamedTuple):
    steps: int  # valid steps returned
    fallbacks: int  # force evaluations that fell back to the gather engine
    failure: Optional[str]  # why the request failed, None if it did not
    wall_s: float  # the request's host wall
    span_s: dict  # span name -> host seconds
    state: object  # the returned State on the device (None on failure)
    h: Optional[np.ndarray]
    rho: Optional[np.ndarray]
    stats: Optional[np.ndarray]
    valid: Optional[np.ndarray]


class Request:
    """Runs requests of `n_steps` steps from `start` (a State on the device)
    with the run loop's smoothing lengths `h_host`, on the cached config
    `cfg`. `replan(pos_host, h_host)` is the run loop's fresh plan
    ((cfg, args) or None); `runner_for(cfg)` the chunk runner of a config."""

    def __init__(self, cfg, replan, runner_for, params, start, h_host, n_steps, plan_repairs):
        self.cfg, self.replan, self.runner_for, self.params = cfg, replan, runner_for, params
        self.start, self.h_host, self.n_steps = start, h_host, n_steps
        self.plan_repairs = plan_repairs
        self.h_dev = torch.as_tensor(h_host).to(device=start.pos.device, dtype=cfg.torch_dtype)
        self.replans = 0  # picks whose forecast, refresh or refit declined the cached config

    def pick(self, state):
        """The run loop's pick: (cfg, chunk args), or None where neither
        the cached config nor a fresh plan takes the state."""
        pos_host = host(state.pos)
        cfg = self.cfg
        if cfg.tile is not None:
            from sphtpu_torch.physics.ctiles import ctile_classes_still_ok
            from sphtpu_torch.physics.tiles import tile_params_still_ok

            grid, cap = cfg.tile
            if tile_params_still_ok(pos_host, self.h_host, grid, cap, cfg.outlier_budget) and (
                cfg.tile_classes is None
                or ctile_classes_still_ok(pos_host, self.h_host, grid, cap, cfg.tile_classes)
            ):
                return cfg, None
        elif cfg.mlevel is not None:
            from sphtpu_torch.physics.mlevel import mlevel_args_still_ok

            args = mlevel_args_still_ok(pos_host, self.h_host, cfg.mlevel)
            if args is not None:
                return cfg, args
        elif cfg.blocks is not None:
            from sphtpu_torch.physics.blocks import block_args_for_spec

            args = block_args_for_spec(pos_host, self.h_host, cfg.blocks, gravity=cfg.gravity,
                                       **self.plan_repairs)
            if args is not None:
                return cfg, args
        self.replans += 1
        return self.replan(pos_host, self.h_host)

    def __call__(self) -> Outcome:
        spans = {}
        t_req = time.perf_counter()

        def timed(name, fn):
            t0 = time.perf_counter()
            with record_function(name):
                out = fn()
            spans[name] = time.perf_counter() - t0
            return out

        def failed(why):
            return Outcome(0, 0, why, time.perf_counter() - t_req, spans, None, None, None,
                           None, None)

        try:
            state = timed("bench.start", lambda: type(self.start)(
                *(x.clone() for x in self.start)))
            picked = timed("bench.pick", lambda: self.pick(state))
            if picked is None:
                return failed("no engine planned: the run loop would take the gather engine")
            cfg, args = picked
            runner = self.runner_for(cfg)
            out = timed("bench.chunk", lambda: runner(
                state, self.params, self.h_dev, self.n_steps, args))
            state, stats_d, valid_d, h_d, rho_d, nfb_d = out
            h, rho, stats, valid, nfb = timed("bench.readback", lambda: (
                host(h_d), host(rho_d), host(stats_d), valid_d.cpu().numpy(), int(nfb_d.sum())))
            finite = timed("bench.check", lambda: bool(
                torch.isfinite(state.pos).all() & torch.isfinite(state.vel).all()
                & torch.isfinite(state.K).all()))
        except Exception as e:  # noqa: BLE001 - a request that raises is counted as failed
            return failed(f"{type(e).__name__}: {e}")
        steps = int(valid.sum())
        why = None
        if not (finite and np.isfinite(h).all() and np.isfinite(rho).all()
                and np.isfinite(stats[:steps]).all()):
            why = "the returned state is not finite"
        elif steps < self.n_steps and nfb == 0:
            why = f"{steps} valid steps of {self.n_steps}"
        return Outcome(steps, nfb, why, time.perf_counter() - t_req, spans, state, h, rho,
                       stats, valid)
