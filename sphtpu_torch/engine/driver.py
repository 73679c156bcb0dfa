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
them), and on the sharded path (n_devices > 1), whose chunks are at most
MAX_SCAN_STEPS long and sized by `_wall_cap` as the reference's are. A
single-device chunk also ends at its first step that fell back to the
gather engine (ROADMAP D20), and the next chunk is planned afresh.

n_devices > 1 runs the multi-device layer (sphtpu_torch/shard/) over a mesh
of shards in one process: the z-slab tile engine when a slab plan
certifies, else the work-sharded block engine, else the work-sharded
multi-level engine, else the chunk runs on one device
(`run_chunk_sharded`). multihost=True runs one mesh across processes
(shard/multihost.py): the work-sharded engines only, and only rank 0
writes files.
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
from ..physics.blocks import BQ, R_TAIL_MARGIN, block_args_for_spec, plan_blocks
from ..physics.ctiles import choose_tile_classes, ctile_classes_still_ok
from ..physics.mlevel import mlevel_args_still_ok, plan_mlevel
from ..physics.tiles import choose_tile_params, choose_tile_params_ml, tile_params_still_ok
from ..profiling import StageTimer
from ..units import UnitSystem
from ..shard.collectives import local_devices, particle_mesh
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

# The sharded path's dispatch limits, the reference's: at most
# MAX_SCAN_STEPS steps a chunk (the slab plan's halo is sized for the
# chunk's length: plan_slabs(chunk_steps=...)), and chunks sized under
# DISPATCH_WALL_BUDGET_S of wall from the measured s/step (`_wall_cap`).
MAX_SCAN_STEPS = 10
DISPATCH_WALL_BUDGET_S = 40.0
# slab plans kept for reuse (hysteresis), most recent first
MAX_SLAB_PLANS = 8

# The run loop's repairs of the reference's recorded faults (ROADMAP
# D19-D21), by the keywords of the functions that take them; each
# keyword's default reproduces the reference. Code that means to run what
# the run loop runs passes these rather than restating the values.
# plan_engine, plan_blocks, block_args_for_spec: the tail radius's drift
# margin (D19)
PLAN_REPAIRS = {"tail_margin": R_TAIL_MARGIN}
# force_eval, make_step, make_slab_force_eval, make_slab_chunk_runner,
# make_ml_chunk_runner: a close pair's two gravity corrections as one
# float64 term in float32 (D21)
EVAL_REPAIRS = {"joint_gravity": True}
# make_chunk_runner: both, and the chunk ends at its first fallback (D20)
CHUNK_REPAIRS = {**EVAL_REPAIRS, "stop_at_fallback": True}


def plan_engine(pos_host, h_host, *, n: int, kh: int, eos: str, dtype: str,
                gravity: str, tail_margin: float = 1.0):
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
    mesh_factor does not give. tail_margin: plan_blocks' (1.0 plans as the
    reference does; run_simulation passes PLAN_REPAIRS, ROADMAP D19)."""
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
    blk = plan_blocks(pos_host, h_host, kh, gravity=gravity, tail_margin=tail_margin)
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
    devices=None,
    shards_per_process: int = 1,
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
    the CPU.

    n_devices > 1 runs the sharded engines over a mesh of n_devices shards
    in this process (sphtpu_torch/shard/): with devices=None the first
    n_devices CUDA devices (ValueError when fewer are visible), or
    n_devices CPU shards when device="cpu"; an explicit `devices` list
    (four "cuda:0", say: shards may share a device) sets the mesh itself.
    The result counts `sharded_chunks`, `shard_replans` (chunks whose
    collective certificate failed and froze) and `single_chunks` (chunks
    no sharded engine planned, run on one device).

    multihost=True runs under an initialised torch.distributed process
    group (shard/multihost.initialize) of two or more ranks: the mesh spans
    every rank's shards, rank-major (this rank's: `devices`, else
    `shards_per_process` shards of cuda:<local rank mod visible cards>, or
    of the CPU with device="cpu"; n_devices becomes the global shard
    count). Every rank runs the same deterministic host planning from the
    same replicated state; the work-sharded engines carry the chunks (the
    z-slab path is skipped, as in the reference); only rank 0 writes
    snapshots, stats and figures. The result's `primary` says which."""
    start_wall = time.time()
    mesh = None
    primary = True
    if multihost:
        from ..shard import multihost as mh

        if mh.process_count() < 2:
            raise ValueError(
                "multihost=True requires torch.distributed initialised across > 1 "
                "processes (sphtpu_torch.shard.multihost.initialize)"
            )
        primary = mh.is_primary()
        verbose = verbose and primary
        local = devices if devices is not None else mh.shard_devices(shards_per_process, device)
        for d in local:
            resolve_device(d)
        mesh = mh.global_mesh(local)
        n_devices = len(mesh)
    elif devices is not None:
        mesh = particle_mesh(devices)
        if len(mesh) != n_devices:
            raise ValueError(f"n_devices={n_devices} but {len(mesh)} devices given")
        for d in mesh:
            resolve_device(d)
        if len({d.type for d in mesh}) != 1:
            raise ValueError("the shards of one mesh must be of one device type")
    elif n_devices > 1:
        if device is not None and torch.device(device).type == "cpu":
            mesh = particle_mesh(["cpu"] * n_devices)
        else:
            visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if visible < n_devices:
                raise ValueError(
                    f"n_devices={n_devices} but only {visible} devices visible"
                )
            mesh = particle_mesh([f"cuda:{i}" for i in range(n_devices)])
    if mesh is not None and len(mesh) < 2:
        mesh = None
    dev = local_devices(mesh)[0] if mesh is not None else resolve_device(device)
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
            # a chunk ends at its first fallback, so the next one is
            # planned afresh (ROADMAP D20); a close pair's two gravity
            # corrections are one float64 term in float32 (D21)
            _runner_cache[cfg] = make_chunk_runner(cfg, device=dev, **CHUNK_REPAIRS)
        return _runner_cache[cfg]

    def pick_cfg(h_host: np.ndarray, pos_host: np.ndarray):
        """(EngineConfig, BlockArgs or MLArgs or None) for the next chunk.

        Hysteresis: prefer ANY already-used config whose host-side
        forecast still certifies (cheapest by the slot-work model) over
        planning a fresh one — for a block config, a refit of its spec to
        the current state (`block_args_for_spec`); for a multi-level
        config, its strip lists refreshed for the same spec
        (`mlevel_args_still_ok`); the in-engine certificate stays the
        safety net. The cached configs are tried cheapest first and the
        first that certifies is taken, so a pick refits no more specs than
        it must (the same pick as refitting all and taking the cheapest). A
        block config whose refit declines is dropped: the state has moved
        out of its spec, and a declined refit runs the whole margin ladder,
        so it is not retried at every later pick."""
        if engine != "auto":
            return base_cfg, None
        for c in sorted(_runner_cache, key=lambda c: cfg_cost(c, n)):
            if c.tile is not None:
                if tile_params_still_ok(
                    pos_host, h_host, c.tile[0], c.tile[1], c.outlier_budget
                ) and (
                    c.tile_classes is None
                    or ctile_classes_still_ok(
                        pos_host, h_host, c.tile[0], c.tile[1], c.tile_classes
                    )
                ):
                    return c, None
            elif c.mlevel is not None:
                args = mlevel_args_still_ok(pos_host, h_host, c.mlevel)
                if args is not None:
                    return c, args
            elif c.blocks is not None:
                args = block_args_for_spec(pos_host, h_host, c.blocks, gravity=c.gravity,
                                           **PLAN_REPAIRS)
                if args is not None:
                    return c, args
                del _runner_cache[c]
        plan = plan_engine(
            pos_host, h_host, n=n, kh=kh, eos=eos, dtype=dtype, gravity=grav, **PLAN_REPAIRS
        )
        return plan if plan is not None else (base_cfg, None)

    if mesh is not None:
        from ..shard.blocks import make_blocks_chunk_runner
        from ..shard.mlevel import make_ml_chunk_runner
        from ..shard.tiles import (
            make_slab_chunk_runner,
            pack_state,
            plan_slabs,
            slab_plan_still_ok,
            unpack_rows,
            unpack_state,
        )

        # the sharded engines (sphtpu_torch/shard/): slab plans kept for
        # reuse as [(cfg, plan, runner)], most recent first; block and
        # multi-level runners by config
        _slab_plans = []
        _blk_cache = {}
        _ml_cache = {}

    def _fresh_h(state2):
        """A failed certificate leaves h/rho at pre-freeze values: recompute
        the planning h on the host so the re-plan sees the real state."""
        pos2 = _host(state2.pos)
        d_knn, _ = cKDTree(pos2).query(pos2, k=kh)
        return d_knn[:, -1] / 2.0

    def run_chunk_sharded(state, h_host, n_steps):
        """One sharded chunk: (state', stats, valid, h_host', rho_host,
        cert_fired, cfg, engine name), or None when neither a slab plan
        (the z-slab tile engine) nor a work-sharded plan (block engine,
        then multi-level engine) certifies; the caller then runs the chunk
        on one device. Hysteresis: a kept slab plan, or a cached block or
        multi-level spec, that still certifies on the current state (host
        forecast) is reused before a fresh one is planned."""
        pos_host = _host(state.pos)
        hit = None
        for entry in _slab_plans:
            if entry[0].gravity == grav and slab_plan_still_ok(entry[1], pos_host, h_host):
                hit = entry
                break
        if hit is None and not multihost:
            plan = plan_slabs(pos_host, h_host, kh, n_devices, chunk_steps=n_steps)
            if plan is not None:
                cfg_s = EngineConfig(
                    n=n, kh=kh, eos=eos, dtype=dtype, tile=(plan.grid, plan.cap),
                    gravity=grav,
                )
                hit = (cfg_s, plan, make_slab_chunk_runner(cfg_s, plan, mesh, **EVAL_REPAIRS))
                _slab_plans.insert(0, hit)
                del _slab_plans[MAX_SLAB_PLANS:]
        if hit is not None:
            cfg_s, plan, chunk = hit
            states, stats, valid, cert, h_rows, rho_rows = chunk(
                pack_state(state, plan, mesh), params, n_steps
            )
            state2 = unpack_state(states, plan, n)
            h2 = unpack_rows(np.concatenate([_host(h) for h in h_rows]), plan, n)
            rho2 = unpack_rows(np.concatenate([_host(r) for r in rho_rows]), plan, n)
            cert_fired = bool(cert.any())
            if cert_fired:
                h2 = _fresh_h(state2)
                # a geometry the engine itself rejected is not re-picked
                _slab_plans[:] = [e for e in _slab_plans if e is not hit]
            return state2, stats, valid, h2, rho2, cert_fired, cfg_s, "slabs"

        # no certifiable slab decomposition (deep collapse): the
        # work-sharded engines, block-compact first, multi-level next
        cfg_w = args = chunk = None
        for c_ in [c for c in _blk_cache if c.gravity == grav]:
            a = block_args_for_spec(pos_host, h_host, c_.blocks, gravity=grav,
                                    **PLAN_REPAIRS)
            if a is not None:
                cfg_w, args, chunk = c_, a, _blk_cache[c_]
                break
            del _blk_cache[c_]  # declined: not refit again (as pick_cfg does)
        if cfg_w is None:
            blk = plan_blocks(pos_host, h_host, kh, gravity=grav, shards=n_devices,
                              **PLAN_REPAIRS)
            if blk is not None:
                spec, args = blk
                cfg_w = EngineConfig(
                    n=n, kh=kh, eos=eos, dtype=dtype, blocks=spec, gravity=grav
                )
                if cfg_w not in _blk_cache:
                    _blk_cache[cfg_w] = make_blocks_chunk_runner(cfg_w, mesh)
                chunk = _blk_cache[cfg_w]
        if cfg_w is None:
            for c_, ch in _ml_cache.items():
                if c_.gravity == grav:
                    a = mlevel_args_still_ok(pos_host, h_host, c_.mlevel)
                    if a is not None:
                        cfg_w, args, chunk = c_, a, ch
                        break
        if cfg_w is None:
            ml = plan_mlevel(pos_host, h_host, kh, gravity=grav, shards=n_devices)
            if ml is None:
                return None
            spec, args = ml
            cfg_w = EngineConfig(n=n, kh=kh, eos=eos, dtype=dtype, mlevel=spec, gravity=grav)
            if cfg_w not in _ml_cache:
                _ml_cache[cfg_w] = make_ml_chunk_runner(cfg_w, mesh, **EVAL_REPAIRS)
            chunk = _ml_cache[cfg_w]
        # short sub-chunks keep the plan's boxes and strip lists fresh
        state2, stats, valid, cert, h_rows, rho_rows = chunk(
            state, params, torch.as_tensor(h_host).to(device=dev, dtype=state.pos.dtype),
            args, min(n_steps, ML_SUBCHUNK),
        )
        h2, rho2 = _host(h_rows), _host(rho_rows)
        cert_fired = bool(cert.any())
        if cert_fired:
            h2 = _fresh_h(state2)
        name = "blocks_sharded" if cfg_w.blocks is not None else "mlevel_sharded"
        return state2, stats, valid, h2, rho2, cert_fired, cfg_w, name

    # bootstrap h for grid sizing (host KD-tree, code units)
    if engine == "auto":
        d_knn, _ = cKDTree(np.asarray(snap["pos"] / u.L)).query(
            np.asarray(snap["pos"] / u.L), k=kh
        )
        h_host = d_knn[:, -1] / 2.0
    else:
        h_host = np.zeros(n)
    h_dev = torch.as_tensor(h_host).to(device=dev, dtype=base_cfg.torch_dtype)

    # multi-process runs: only the primary rank owns the files
    stats_file = (
        StatsFile(os.path.join(root, "snapshots", ic_type, "stats")) if primary else None
    )

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
    total_replans = 0  # sharded chunks whose collective certificate failed
    total_sharded = 0  # chunks run by a sharded engine
    total_single = 0  # chunks of a sharded run that ran on one device
    consec_fail = 0
    force_single = 0  # chunks to force onto the single-device path
    # measured s/step of the sharded path: sizes its dispatches under
    # DISPATCH_WALL_BUDGET_S (the first probe is stored as 0.0)
    step_wall: dict = {}

    def _wall_cap(key, n_steps):
        """An unmeasured path is probed twice at ML_SUBCHUNK steps (the
        first probe's wall is set-up dominated and stored as 0.0), then
        the dispatch is sized from the measured s/step."""
        sps = step_wall.get(key)
        if sps is None or sps == 0.0:
            return min(n_steps, ML_SUBCHUNK)
        return max(min(n_steps, int(DISPATCH_WALL_BUDGET_S / sps)), 1)

    def _wall_record(key, wall, n_steps):
        step_wall[key] = 0.0 if key not in step_wall else wall / max(n_steps, 1)
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

        res = None
        cert_fired = False
        n_fb = 0
        if mesh is not None and not force_single:
            n_steps = _wall_cap("sharded", min(n_steps, MAX_SCAN_STEPS))
            if multihost:  # sized from this rank's walls: the ranks agree first
                n_steps = mh.agree_min(n_steps)
            with timer("chunk_steps_sharded"):
                t_chunk = time.perf_counter()
                res = run_chunk_sharded(state, h_host, n_steps)
                t_chunk = time.perf_counter() - t_chunk
            if res is not None:
                _wall_record("sharded", t_chunk, n_steps)
        if res is not None:
            state, stats_code, valid, h_host, rho_host, cert_fired, cfg, eng = res
            h_dev = torch.as_tensor(h_host).to(device=dev, dtype=base_cfg.torch_dtype)
            total_sharded += 1
            if cert_fired:
                total_replans += 1
                if verbose:
                    print("[shard] certification tripped; re-planning")
        else:
            if mesh is not None:
                # no sharded plan (or forced off): this chunk runs on one
                # device, correctness first
                force_single = max(force_single - 1, 0)
                total_single += 1
            with timer("pick_grid"):
                t_pick = time.perf_counter()
                cfg, mlargs = pick_cfg(h_host, _host(state.pos))
                chunk = get_chunk(cfg)
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
            eng = engine_name(cfg)
        if cfg not in picked:
            picked.append(cfg)
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
        chunk_engines.append(eng)
        chunk_configs.append(cfg)
        if n_valid == 0:
            if cert_fired:
                # no progress from a failed sharded chunk: the re-plan has
                # fresh h; a second failure in a row sends the next chunk
                # to the single-device path
                consec_fail += 1
                if consec_fail >= 2:
                    force_single = 1
                continue
            break
        consec_fail = 0
        stats_cgs = _stats_to_cgs(stats_code[:n_valid], u)
        for j in range(n_valid):
            if primary:
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
        if (on_boundary or at_end) and primary:
            with timer("snapshot_io"):
                do_snapshot(last_iter, last_stats_code, rho_host)

    with timer("snapshot_io_drain"):
        io_q.join()
    io_q.put(None)
    io_thread.join()
    if io_err:
        raise io_err[0]
    if primary:
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
        "shard_replans": total_replans,
        "sharded_chunks": total_sharded,
        "single_chunks": total_single,
        "n_devices": len(mesh) if mesh is not None else 1,
        "primary": primary,
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
