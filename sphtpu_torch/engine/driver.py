"""Host-side run loop: warm restart, chunked stepping, snapshots.

The reference has two near-identical run-loop modules (polytrope_sim.jl,
isothermal_sim.jl); here one loop reads the snapshot, builds the G=1 code
unit system, runs the chunk runner between snapshot boundaries on one
device, and handles stats mmap + snapshot/figure I/O in CGS float64.

Snapshot cadence replicates the reference counter semantics
(polytrope_sim.jl:124,236,309-311): the counter starts at snapInterval so
the first step always snapshots, then every snapInterval steps; the final
step (t >= tEnd) always snapshots. keepSnaps=false suppresses all but the
final snapshot; showPlots additionally renders PNG figures.

A chunk runs to the next snapshot boundary: there is no cap on the steps
of one dispatch, except on the block-compact and the multi-level engines,
whose chunks are ML_SUBCHUNK steps long (their plans are refreshed between
them).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..device import resolve_device
from ..io import StatsFile, read_snapshot, snapshot_path, write_snapshot
from ..physics.blocks import BQ, block_args_for_spec, plan_blocks
from ..physics.ctiles import choose_tile_classes, ctile_classes_still_ok
from ..physics.mlevel import mlevel_args_still_ok, plan_mlevel
from ..physics.tiles import choose_tile_params, choose_tile_params_ml, tile_params_still_ok
from ..profiling import StageTimer
from ..units import UnitSystem
from .config import EngineConfig, params_from_numpy, state_from_numpy
from .step import make_chunk_runner

# plotN per EOS (polytrope_sim.jl:129, isothermal_sim.jl:122)
PLOT_N = {"polytropic": 10000, "isothermal": 1000}

# gravity="auto" switches the tile path to P3M at this particle count (the
# exact sweep grows as N^2, the P3M side ~linearly); the reference's
# threshold, kept as it is.
P3M_MIN_N = 150_000

# Block-compact and multi-level chunks are this many steps long: the
# plans' boxes and strip lists carry drift margins for ML_SUBCHUNK steps,
# and refreshing them between short chunks (`block_args_for_spec`,
# `mlevel_args_still_ok`) is a host pass that keeps the spec.
ML_SUBCHUNK = 2


def plan_engine(pos_host, h_host, *, n: int, kh: int, eos: str, dtype: str,
                gravity: str):
    """A fresh plan for the next chunk, the reference's ladder
    (code-unit host arrays; gravity "exact" or "p3m"):

    1. exact gravity only: the class-compacted tile engine, when its
       planner fits the state (1.5x occupancy headroom, cap <= 128);
    2. the mono-tile engine (cap <= 256), under either gravity;
    3. the block-compact engine (`plan_blocks`), under either gravity;
    4. the multi-level engine (`plan_mlevel`), under either gravity;
    5. the mono-tile engine with its outlier lane
       (`choose_tile_params_ml`: a grid for the bulk, the large-h rows in an
       exact O(B*N) lane), under either gravity;
    then None: no rung can plan; the caller runs the gather engine.

    Returns (EngineConfig, BlockArgs or MLArgs or None) or None. p3m skips
    the class engine: it needs a one-cell tail stencil, which the default
    mesh_factor does not give."""
    if gravity == "exact":
        tp_cls = choose_tile_classes(pos_host, h_host, kh, headroom=1.5)
        if tp_cls is not None:
            grid, cap, classes = tp_cls
            return EngineConfig(
                n=n, kh=kh, eos=eos, dtype=dtype, tile=(grid, cap),
                tile_classes=classes, gravity=gravity,
            ), None
    tp_mono = choose_tile_params(pos_host, h_host, kh, headroom=1.5)
    if tp_mono is not None:
        return EngineConfig(
            n=n, kh=kh, eos=eos, dtype=dtype, tile=tp_mono, gravity=gravity
        ), None
    blk = plan_blocks(pos_host, h_host, kh, gravity=gravity)
    if blk is not None:
        spec, bargs = blk
        return EngineConfig(
            n=n, kh=kh, eos=eos, dtype=dtype, blocks=spec, gravity=gravity
        ), bargs
    ml = plan_mlevel(pos_host, h_host, kh, gravity=gravity)
    if ml is not None:
        spec, mlargs = ml
        return EngineConfig(
            n=n, kh=kh, eos=eos, dtype=dtype, mlevel=spec, gravity=gravity
        ), mlargs
    tp = choose_tile_params_ml(pos_host, h_host, kh, headroom=1.5, budget_margin=2.0)
    if tp is not None:
        grid, cap, budget = tp
        return EngineConfig(
            n=n, kh=kh, eos=eos, dtype=dtype, tile=(grid, cap),
            outlier_budget=budget, gravity=gravity,
        ), None
    return None


def cfg_cost(c: EngineConfig, n: int) -> float:
    """The reference's slot-work model of a config at N = n particles:
    run_simulation's hysteresis keeps the cheapest of the cached configs
    whose forecast still certifies."""
    if c.tile is not None:
        if c.tile_classes is not None:
            # class-compacted query rows: only occupied-class slots
            # sweep pair tiles
            return sum(
                nk * float(ck) for ck, nk in c.tile_classes
            ) * 27.0 * float(c.tile[1])
        # mono tile: every cell's full capacity sweeps pair tiles; the
        # outlier lane's O(B*N) sweeps
        return (
            c.tile[0] ** 3 * float(c.tile[1]) ** 2 * 27.0
            + n * float(c.outlier_budget)
        )
    if c.blocks is not None:
        # pair slots x the reference's per-slot factor, which puts the
        # block engine on the strip engines' scale
        return 13.0 * sum(cb * nb * BQ for cb, nb in c.blocks[0])
    if c.mlevel is not None:
        levels, res_budget, _, c_buckets = c.mlevel
        cost = sum(
            (na_b + nb_b) * g * cb * 27.0 * cb
            for g, cap, buckets in levels
            for cb, na_b, nb_b in buckets
        )
        c_depth = 2 * c.c_halfwidth + 1
        cost += sum(
            nc_b * levels[0][0] * cb * float(c_depth) ** 3 * cb
            for cb, nc_b in c_buckets
        )
        return cost + n * float(res_budget) * 2.0
    return float("inf")


def engine_name(cfg: EngineConfig) -> str:
    """"classes", "mono", "outliers" (the mono-tile engine with its
    outlier lane), "blocks", "mlevel" or "gather": the engine a config runs
    (a chunk whose certificate failed ran the gather engine too)."""
    if cfg.blocks is not None:
        return "blocks"
    if cfg.mlevel is not None:
        return "mlevel"
    if cfg.tile is not None:
        if cfg.tile_classes is not None:
            return "classes"
        return "outliers" if cfg.outlier_budget else "mono"
    return "gather"


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float64).numpy()


def find_star_radius(rlin: np.ndarray, rho_radial: np.ndarray, threshold: float):
    """First radius where the profile drops below threshold
    (polytrope_sim.jl:75-80)."""
    below = np.flatnonzero(rho_radial < threshold)
    return rlin[below[0]] if below.size else rlin[-1]


def _stats_to_cgs(stats_code: np.ndarray, u: UnitSystem) -> np.ndarray:
    scale = np.array(
        [u.T, u.E, u.E, u.E, u.E, u.L, u.L, u.L, u.M * u.V, u.M * u.V * u.L]
    )
    return stats_code * scale


def run_simulation(
    eos: str,
    ic_type: str,
    snap_id: int = 1,
    snap_interval: int = 10,
    keep_snaps: bool = True,
    show_plots: bool = True,
    *,
    root: str = ".",
    dtype: str = "float32",
    engine: str = "auto",
    gravity: str = "auto",
    n_devices: int = 1,
    multihost: bool = False,
    max_steps: Optional[int] = None,
    verbose: bool = True,
    device=None,
) -> dict:
    """Run from snapshot `snap_id` until tEnd (or max_steps). Returns a
    summary dict (steps run, final time, last stats row, snapshot ids).

    engine: "auto" uses a certified fast path with fallback, re-planned per
    chunk from the evolving h (`plan_engine`): the class-compacted engine
    (exact gravity only), else the mono-tile engine, else the
    block-compact engine, else the multi-level engine, else the mono-tile
    engine with its outlier lane; "gather" forces the neighbor-list
    engine.
    gravity: "exact" runs the exact Newtonian sweep + near-field
    correction on the tile path; "p3m" the FFT mesh + the tiles' tail
    correction; "auto" is p3m at N >= P3M_MIN_N, else exact. The gather
    engine's gravity is always the exact softened all-pairs sum.
    device: None means the card ("cuda"); only an explicit "cpu" runs on
    the CPU."""
    start_wall = time.time()
    dev = resolve_device(device)
    if n_devices > 1 or multihost:
        raise NotImplementedError(
            "the multi-device layer arrives with slice 5 of the port"
        )
    snap = read_snapshot(snapshot_path(root, ic_type, str(snap_id)))
    c = dict(snap["constants"])
    n = int(c["N"])
    kh = int(c["Kh"])
    gamma = float(c.get("gamma", 5.0 / 3.0))
    u = UnitSystem.from_constants(float(c["G"]), float(c["M"]), float(c["R"]))
    if gravity not in ("auto", "exact", "p3m"):
        raise ValueError(f"unknown gravity mode {gravity!r}")
    grav = (
        "p3m"
        if gravity == "p3m" or (gravity == "auto" and n >= P3M_MIN_N)
        else "exact"
    )

    base_cfg = EngineConfig(n=n, kh=kh, eos=eos, dtype=dtype)

    if eos == "polytropic":
        if snap["K"] is None:
            raise ValueError("polytropic run requires a K column in the snapshot")
        K_code = np.asarray(snap["K"]) / u.K_entropy(gamma)
    else:
        K_code = np.zeros(n)

    params = params_from_numpy(
        m=c["m"] / u.M,
        gamma=gamma,
        cs0=float(c.get("cs", 0.0)) / u.V,
        alpha=float(c["alpha"]),
        beta=float(c["beta"]),
        U0=float(c.get("U", 0.0)) / u.E,
        t_end=float(c["tEnd"]) / u.T,
        dtype=dtype,
        device=dev,
    )
    state = state_from_numpy(
        snap["pos"] / u.L,
        snap["vel"] / u.V,
        K_code,
        float(c["t"]) / u.T,
        dtype=dtype,
        device=dev,
    )

    # chunk runners cached per EngineConfig (the tile tuple or block spec
    # changes as h evolves)
    _runner_cache = {}

    def get_chunk(cfg):
        if cfg not in _runner_cache:
            _runner_cache[cfg] = make_chunk_runner(cfg, device=dev)
        return _runner_cache[cfg]

    def pick_cfg(h_host: np.ndarray, pos_host: np.ndarray):
        """(EngineConfig, BlockArgs or MLArgs or None) for the next chunk.

        Hysteresis: prefer ANY already-used config whose host-side
        forecast still certifies (cheapest by the slot-work model) over
        planning a fresh one — for a block config, a refit of its spec to
        the current state (`block_args_for_spec`); for a multi-level
        config, its strip lists refreshed for the same spec
        (`mlevel_args_still_ok`); the in-engine certificate stays the
        safety net."""
        if engine != "auto":
            return base_cfg, None
        cached = []
        for c in _runner_cache:
            if c.tile is not None:
                if tile_params_still_ok(
                    pos_host, h_host, c.tile[0], c.tile[1], c.outlier_budget
                ) and (
                    c.tile_classes is None
                    or ctile_classes_still_ok(
                        pos_host, h_host, c.tile[0], c.tile[1], c.tile_classes
                    )
                ):
                    cached.append((c, None))
            elif c.mlevel is not None:
                args = mlevel_args_still_ok(pos_host, h_host, c.mlevel)
                if args is not None:
                    cached.append((c, args))
            elif c.blocks is not None:
                args = block_args_for_spec(pos_host, h_host, c.blocks, gravity=c.gravity)
                if args is not None:
                    cached.append((c, args))
        if cached:
            return min(cached, key=lambda ca: cfg_cost(ca[0], n))
        plan = plan_engine(
            pos_host, h_host, n=n, kh=kh, eos=eos, dtype=dtype, gravity=grav
        )
        return plan if plan is not None else (base_cfg, None)

    # bootstrap h for grid sizing (host KD-tree, code units)
    if engine == "auto":
        d_knn, _ = cKDTree(np.asarray(snap["pos"] / u.L)).query(
            np.asarray(snap["pos"] / u.L), k=kh
        )
        h_host = d_knn[:, -1] / 2.0
    else:
        h_host = np.zeros(n)
    h_dev = torch.as_tensor(h_host).to(device=dev, dtype=base_cfg.torch_dtype)

    stats_file = StatsFile(os.path.join(root, "snapshots", ic_type, "stats"))

    # Radial-profile sample line, fixed at startup (polytrope_sim.jl:131 /
    # isothermal_sim.jl:124).
    plot_n = PLOT_N[eos]
    R_cur = float(c["R"])
    if eos == "polytropic":
        rlin_code = np.linspace(0.0, 1.5 * R_cur, plot_n) / u.L
    else:
        rlin_code = np.linspace(-1.0, 1.0, plot_n) * R_cur / u.L

    iter_id = int(c["iterID"])
    counter = snap_interval
    t_end_code = float(c["tEnd"]) / u.T
    total_steps = 0
    snapshot_ids = []
    last_stats_code = None

    # Snapshot CSV writes + figure rendering run on a worker thread so
    # they overlap the next chunk's device stepping. Ordering is preserved by
    # a single worker + FIFO queue; the stats mmap is sync()'d and read
    # (up_to) on the main thread BEFORE enqueueing, so the worker only
    # touches immutable numpy copies.
    import queue as _queue
    import threading

    io_q: "_queue.Queue" = _queue.Queue()
    io_err = []

    def _io_worker():
        while True:
            item = io_q.get()
            if item is None:
                return
            try:
                item()
            except Exception as e:  # noqa: BLE001
                io_err.append(e)
            finally:
                io_q.task_done()

    io_thread = threading.Thread(target=_io_worker, daemon=True)
    io_thread.start()

    # radial-profile star radius, updated per snapshot ON THE WORKER
    # THREAD (FIFO order = snapshot order); [0] is only read/written
    # there after startup
    _R_state = [R_cur]

    def do_snapshot(
        snap_iter: int, last_row_code: np.ndarray, rho_code: Optional[np.ndarray]
    ):
        rcom = last_row_code[5:8]
        rr = np.stack(
            [
                rlin_code + rcom[0],
                np.full(plot_n, rcom[1]),
                np.full(plot_n, rcom[2]),
            ],
            axis=1,
        )
        c["iterID"] = snap_iter
        c["t"] = float(state.t) * u.T
        c["N"] = n
        stats_file.sync()
        pos_code = _host(state.pos)
        pos_cgs = pos_code * u.L
        vel_cgs = _host(state.vel) * u.V
        k_out = (
            _host(state.K) * u.K_entropy(gamma)
            if eos == "polytropic"
            else None
        )
        constants_copy = dict(c)
        stats_hist = stats_file.up_to(snap_iter) if show_plots else None
        rho_cgs = rho_code * u.RHO if rho_code is not None else None
        m_code = float(params.m)

        def _density_write_and_render():
            # radial kNN density entirely off the device and off the
            # main thread: the card keeps stepping the next chunk while
            # this samples the snapshot's immutable host copy
            # (polytrope_sim.jl:241)
            from ..scenes.setup import host_density_at

            rho_radial_code = host_density_at(m_code, rr, pos_code, kh)
            if eos == "polytropic":
                r_new = find_star_radius(
                    rlin_code, rho_radial_code, 0.01 * rho_radial_code[0]
                )
                _R_state[0] = float(r_new * u.L)
            constants_copy["R"] = _R_state[0]
            write_snapshot(
                str(snap_iter),
                ic_type,
                pos_cgs,
                vel_cgs,
                K=k_out,
                constants=constants_copy,
                rlin=rlin_code * u.L,
                rho_radial=rho_radial_code * u.RHO,
                root=root,
            )
            if show_plots:
                from ..viz import render_snapshot_figures

                render_snapshot_figures(
                    root=root,
                    ic_type=ic_type,
                    snap_id=str(snap_iter),
                    pos_cgs=pos_cgs,
                    rho_cgs=rho_cgs,
                    R=constants_copy["R"],
                    rlin_cgs=rlin_code * u.L,
                    rho_radial_cgs=rho_radial_code * u.RHO,
                    stats_cgs=stats_hist,
                    eos=eos,
                )

        io_q.put(_density_write_and_render)
        if verbose:
            print(f"Saving snapshot with ID: {snap_iter}")
        snapshot_ids.append(snap_iter)


    timer = StageTimer()
    total_fallbacks = 0
    picked = []  # distinct configs in the order they were first used
    chunk_walls = []  # (steps run, wall seconds, fallback evals) per chunk
    pick_walls = []  # host planning (plan or refit) wall seconds before each chunk
    chunk_engines = []  # the engine that ran each chunk (`engine_name`)
    chunk_configs = []  # the config of each chunk
    while float(state.t) < t_end_code:
        if max_steps is not None and total_steps >= max_steps:
            break
        # steps until the next snapshot boundary (see module docstring)
        if keep_snaps:
            n_steps_full = snap_interval - counter + 1
        else:
            n_steps_full = max(snap_interval, 1)
        n_steps = n_steps_full
        if max_steps is not None:
            n_steps = min(n_steps, max_steps - total_steps)

        with timer("pick_grid"):
            t_pick = time.perf_counter()
            cfg, mlargs = pick_cfg(h_host, _host(state.pos))
            chunk = get_chunk(cfg)
            if cfg not in picked:
                picked.append(cfg)
            pick_walls.append(time.perf_counter() - t_pick)
        if cfg.blocks is not None or cfg.mlevel is not None:
            # the plan's boxes or strip lists drift with the state: short
            # chunks keep them fresh (a host refit, same spec)
            n_steps = min(n_steps, ML_SUBCHUNK)
        with timer("chunk_steps"):
            t_chunk = time.perf_counter()
            state, stats_code, valid, h_dev, rho_dev, nfb = chunk(
                state, params, h_dev, n_steps, mlargs
            )
            h_host = _host(h_dev)  # device -> host: the chunk has finished
            rho_host = _host(rho_dev)
            t_chunk = time.perf_counter() - t_chunk
        n_fb = int(nfb.sum())
        total_fallbacks += n_fb
        if n_fb:
            # a plan the engine itself rejected is planned afresh
            _runner_cache.pop(cfg, None)
            if verbose:
                print(
                    f"[neighbors] {n_fb} force evals fell back to the gather engine"
                )
        stats_code = _host(stats_code)
        valid = valid.cpu().numpy()
        n_valid = int(valid.sum())
        chunk_walls.append((n_valid, t_chunk, n_fb))
        chunk_engines.append(engine_name(cfg))
        chunk_configs.append(cfg)
        if n_valid == 0:
            break
        stats_cgs = _stats_to_cgs(stats_code[:n_valid], u)
        for j in range(n_valid):
            stats_file.update_row(iter_id + j, stats_cgs[j])
            if verbose:
                row = stats_cgs[j]
                if eos == "polytropic":
                    # the reference prints the virial ratio only in the
                    # polytropic loop (polytrope_sim.jl:190)
                    with np.errstate(divide="ignore", invalid="ignore"):
                        vir = abs(row[2] / row[3]) if row[3] != 0 else np.inf
                    print(f"Virial Ratio {vir}")
                print(f"Time: {row[0]}")
        last_stats_code = stats_code[n_valid - 1]
        total_steps += n_valid
        last_iter = iter_id + n_valid - 1
        iter_id += n_valid

        at_end = float(state.t) >= t_end_code or (
            max_steps is not None and total_steps >= max_steps
        )
        # a chunk clipped by --max-steps ends mid-interval: advance the
        # counter instead of snapshotting early, so a later resume stays on
        # the reference cadence (snapshot only on true boundaries / at end)
        on_boundary = keep_snaps and n_valid == n_steps_full
        counter = 1 if on_boundary else counter + n_valid
        if on_boundary or at_end:
            with timer("snapshot_io"):
                do_snapshot(last_iter, last_stats_code, rho_host)

    with timer("snapshot_io_drain"):
        io_q.join()
    io_q.put(None)
    io_thread.join()
    if io_err:
        raise io_err[0]
    stats_file.close()
    runtime = time.time() - start_wall
    timer.report()
    if verbose:
        print(
            f"Engine on {dev}: cell-tiles for Pressure/AV + "
            f"{'P3M mesh' if grav == 'p3m' else 'all-pairs'} gravity. "
            f"Runtime: {runtime} seconds"
        )
    return {
        "steps": total_steps,
        "fallback_evals": total_fallbacks,
        "shard_replans": 0,
        "sharded_chunks": 0,
        "configs": picked,
        "chunk_walls": chunk_walls,
        "pick_walls": pick_walls,
        "chunk_engines": chunk_engines,
        "chunk_configs": chunk_configs,
        "params": params,
        "h_last": h_dev,
        "t_cgs": float(state.t) * u.T,
        "iter_id": iter_id,
        "snapshot_ids": snapshot_ids,
        "last_stats_cgs": _stats_to_cgs(last_stats_code, u)
        if last_stats_code is not None
        else None,
        "runtime_s": runtime,
        "state": state,
        "units": u,
    }
