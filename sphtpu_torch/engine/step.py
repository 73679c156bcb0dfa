"""The simulation step: force eval + adaptive dt + diagnostics + KDK.

Two full force evaluations per step, exactly like the reference loop
(polytrope_sim.jl:158-313 / isothermal_sim.jl:152-288). A chunk is a host
loop over steps; dt is data-dependent and stays on the device. Snapshot
cadence is step-count based, so run_simulation slices chunks at snapshot
boundaries.

Neighbor engines: when cfg.tile is set, a tile engine runs first — the
class-compacted one (sphtpu_torch.physics.ctiles) when cfg.tile_classes is
set, else the mono-tile one (sphtpu_torch.physics.tiles, with its outlier
lane when cfg.outlier_budget is set); when cfg.blocks
is set, the block-compact engine (sphtpu_torch.physics.blocks) with the
chunk's BlockArgs (`mlargs`) and candidate tables (`aux`, built once a
chunk); when cfg.mlevel is set, the multi-level engine
(sphtpu_torch.physics.mlevel) with the chunk's MLArgs (`mlargs`). The engine's per-evaluation exactness certificate gates the
fallback to the gather engine: a stale plan costs speed, never
correctness. Gravity on a tile
path is the exact Newtonian sweep or, under p3m, the FFT mesh; either way
plus the tiles' near-field corrections. Reading that certificate is the one
host synchronisation of a force evaluation (the outlier lane adds its row
count and, per block of its two gravity sweeps, the block's kept-pair count:
about 140 at N = 1e5 with 26 921 outliers). The smoothing lengths ride the loop as the grid-sizing hint for
the next evaluation and as the outlier lane's species hint.

Stats row layout matches polytrope_sim.jl:202:
  [t, T, V, U, Etot, com_x, com_y, com_z, |p|, |L|]  (code units here;
  run_simulation converts to CGS when writing the mmap).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..device import require_on, resolve_device
from ..physics import (
    evolve_K,
    gravity_allpairs,
    gravity_newton_allpairs,
    sph_forces,
)
from ..physics.blocks import block_args_to_device, block_sph_forces, build_cand_tables
from ..physics.ctiles import ctile_sph_forces
from ..physics.mesh_gravity import greens_hat, p3m_mesh_force
from ..physics.mlevel import mlevel_args_to_device, mlevel_sph_forces
from ..physics.tiles import ReducedForces, tile_sph_forces
from ..profiling import stage
from .config import EngineConfig, Params, State


def _gather_reduced(cfg: EngineConfig, p: Params, pos, vel, K) -> ReducedForces:
    sf = sph_forces(
        pos,
        vel,
        p.m,
        K,
        eos=cfg.eos,
        gamma=p.gamma,
        cs0=p.cs0,
        alpha=p.alpha,
        beta=p.beta,
        kh=cfg.kh,
    )
    return ReducedForces(
        sf.acc, sf.rho, sf.h, sf.cs, sf.mu_max, sf.div_sum, sf.visc_dk
    )


def force_eval(
    cfg: EngineConfig, p: Params, pos, vel, K, h_hint, ghat=None, mlargs=None,
    aux=None, *, device=None, grouped=True, joint_gravity=False,
):
    """Hydro + gravity acceleration (getAcc, polytrope_sim.jl:17-51).

    ghat: the Green's function of cfg's mesh, `greens_hat(cfg.mesh_pad,
    cfg.sigma_cells, dtype, device)`; required when the config is p3m (the
    chunk runner computes it once). mlargs: the plan's BlockArgs when
    cfg.blocks is set, its MLArgs when cfg.mlevel is set (required for
    either); aux: the block plan's candidate tables
    (`build_cand_tables`; None rebuilds them in the call); grouped=False
    runs the block engine's phase B per bucket (kernel K6) instead of in one
    launch (K5), as the reference's SPHTPU_BLOCKS_GROUPED=0 does;
    joint_gravity=True takes a close pair's two gravity corrections as one
    float64 term in float32 under P3M on the tile and multi-level engines
    (ROADMAP D21; `tile_sph_forces`), the default two sweeps as the
    reference does. Returns
    (acc, reduced, phi, fell_back); fell_back is a python bool (the
    certificate is read back here). device=None means the card."""
    dev = resolve_device(device)
    require_on(dev, pos, vel, K)
    if cfg.blocks is not None and mlargs is None:
        raise ValueError("cfg.blocks requires BlockArgs via mlargs")
    if cfg.mlevel is not None and mlargs is None:
        raise ValueError("cfg.mlevel requires mlargs")
    if cfg.gravity == "p3m" and ghat is None:
        raise ValueError(
            "a p3m config needs ghat = greens_hat(cfg.mesh_pad, cfg.sigma_cells, ...)"
        )

    if cfg.blocks is not None:
        with stage("hydro_blocks"):
            tf, gcorr, ok = block_sph_forces(
                pos, vel, p.m, K, h_hint, mlargs, eos=cfg.eos, gamma=p.gamma,
                cs0=p.cs0, alpha=p.alpha, beta=p.beta, kh=cfg.kh, spec=cfg.blocks,
                gravity=cfg.gravity, mesh_factor=cfg.mesh_factor,
                sigma_cells=cfg.sigma_cells, grouped=grouped, idx_tables=aux,
            )
        return _certified_or_gather(cfg, p, pos, vel, K, tf, gcorr, ok, ghat, dev)

    if cfg.mlevel is not None:
        # phase A per level x bucket on kernel K1 (on a CUDA tensor at every
        # dtype and size: ROADMAP D11); phases B, C and the residual lane
        # are torch
        with stage("hydro_mlevel"):
            tf, gcorr, ok = mlevel_sph_forces(
                pos, vel, p.m, K, h_hint, mlargs, eos=cfg.eos, gamma=p.gamma,
                cs0=p.cs0, alpha=p.alpha, beta=p.beta, kh=cfg.kh, spec=cfg.mlevel,
                mesh_factor=cfg.mesh_factor, sigma_cells=cfg.sigma_cells,
                joint_gravity=joint_gravity,
            )
        return _certified_or_gather(cfg, p, pos, vel, K, tf, gcorr, ok, ghat, dev)

    if cfg.tile is not None:
        grid, cap = cfg.tile
        p3m = cfg.gravity == "p3m"
        kw = dict(
            eos=cfg.eos,
            gamma=p.gamma,
            cs0=p.cs0,
            alpha=p.alpha,
            beta=p.beta,
            kh=cfg.kh,
            grid=grid,
            cap=cap,
            mesh_factor=cfg.mesh_factor if p3m else 0,
            sigma_cells=cfg.sigma_cells,
            device=dev,
        )
        if cfg.tile_classes is not None:
            # occupancy-class-compacted tile path (physics/ctiles.py):
            # padded query rows are not swept; candidates stay the full
            # 27-cell prestack so certification equals the mono engine's
            with stage("hydro_ctiles"):
                tf, gcorr, ok = ctile_sph_forces(
                    pos, vel, p.m, K, h_hint, classes=cfg.tile_classes, **kw
                )
        else:
            # mono-tile path (physics/tiles.py): every cell at the full
            # capacity; under p3m its phase C adds the (2W+1)^3 tail; with
            # an outlier budget, h_hint selects the outlier lane's rows
            with stage("hydro_tiles"):
                tf, gcorr, ok = tile_sph_forces(
                    pos, vel, p.m, K, h_hint, outlier_budget=cfg.outlier_budget,
                    joint_gravity=joint_gravity, **kw
                )
        return _certified_or_gather(cfg, p, pos, vel, K, tf, gcorr, ok, ghat, dev)

    with stage("hydro_gather"):
        red = _gather_reduced(cfg, p, pos, vel, K)
    with stage("gravity"):
        g, phi = gravity_allpairs(pos, red.h, p.m)
    acc = red.acc - g  # G = 1 in code units (the caller applies -G*g)
    return acc, red, phi, False


def _certified_or_gather(cfg, p, pos, vel, K, tf, gcorr, ok, ghat, dev):
    """The far field and the result of an engine's evaluation whose
    certificate is `ok`, or the gather engine's evaluation where it failed
    (under fallback="none" the failed evaluation is returned as it is, for
    make_step to discard)."""
    ok = bool(ok)  # the one host synchronisation of this evaluation
    if ok or cfg.fallback == "none":
        with stage("gravity"):
            if cfg.gravity == "p3m":
                # FFT mesh far field + the engine's (softened - mesh shape)
                # corrections
                gfar, phifar = p3m_mesh_force(
                    pos, p.m, ghat, gm=cfg.mesh_gm, pad=cfg.mesh_pad
                )
            else:
                # pure-Newtonian global sweep + the engine's near-field
                # softening correction == the reference's softened gravity
                gfar, phifar = gravity_newton_allpairs(pos, p.m, device=dev)
        g = gfar + torch.stack(gcorr[:3], dim=1)
        return tf.acc - g, tf, phifar + gcorr[3], not ok
    with stage("hydro_gather"):
        red = _gather_reduced(cfg, p, pos, vel, K)
    with stage("gravity"):
        g, phi = gravity_allpairs(pos, red.h, p.m)
    return red.acc - g, red, phi, True


def _adaptive_dt(p: Params, sf: ReducedForces, acc, vel):
    """4-criterion timestep (polytrope_sim.jl:165-174)."""
    vel_r = torch.sqrt(torch.sum(vel * vel, dim=1))
    a_r = torch.sqrt(torch.sum(acc * acc, dim=1))
    abs_div_v = torch.abs(-sf.div_sum / sf.rho)
    c1 = torch.min(1.0 / abs_div_v)
    c2 = torch.min(sf.h / vel_r)
    c3 = torch.min(torch.sqrt(sf.h / a_r))
    c4 = torch.min(sf.h / (sf.cs + 1.2 * (p.alpha * sf.cs + p.beta * sf.mu_max)))
    return 0.3 * torch.minimum(torch.minimum(c1, c2), torch.minimum(c3, c4))


def _diagnostics(cfg: EngineConfig, p: Params, state: State, sf, phi, vel_r2):
    """The 10-field stats vector (polytrope_sim.jl:177-202)."""
    pos, vel = state.pos, state.vel
    n = pos.shape[0]
    T = 0.5 * p.m * torch.sum(vel_r2)
    V = 0.5 * p.m * torch.sum(phi)  # G = 1
    if cfg.eos == "polytropic":
        U = p.m * torch.sum(state.K / (p.gamma - 1.0) * sf.rho ** (p.gamma - 1.0))
        Etot = T + V + U
    else:
        U = p.U0
        Etot = T + V + 2.0 * U  # isothermal_sim.jl:177
    r_com = torch.sum(pos, dim=0) / n
    p_lin = p.m * torch.sum(vel, dim=0)
    lin_mom = torch.sqrt(torch.sum(p_lin**2))
    rel = pos - r_com
    ang = p.m * torch.sum(torch.linalg.cross(rel, vel), dim=0)
    ang_mom = torch.sqrt(torch.sum(ang**2))
    return torch.stack(
        [state.t, T, V, U, Etot, r_com[0], r_com[1], r_com[2], lin_mom, ang_mom]
    )


def kdk_body(cfg: EngineConfig, p: Params, state: State, h_hint, force):
    """One step as a generator body (shard/collectives.py): force(pos, vel,
    K, h_hint) is a generator body that returns (acc, reduced, phi,
    fell_back), or None when the evaluation failed its certificate and the
    step must not be taken. Returns (state', stats_row, h_new, rho_new,
    n_fallbacks), or None after such a failure. make_step runs it on one
    device, the work-sharded chunk runner (shard/mlevel.py) on every shard."""
    pos, vel, K = state.pos, state.vel, state.K
    out = yield from force(pos, vel, K, h_hint)
    if out is None:
        return None
    acc, sf, phi, fb1 = out
    dt = _adaptive_dt(p, sf, acc, vel)
    vel_r2 = torch.sum(vel * vel, dim=1)
    stats = _diagnostics(cfg, p, state, sf, phi, vel_r2)

    # Leapfrog KDK with predictor-corrector (polytrope_sim.jl:208-227)
    pos_half = pos + vel * (dt / 2.0)
    vel_half = vel + acc * (dt / 2.0)
    if cfg.eos == "polytropic":
        K = evolve_K(K, sf.visc_dk, p.gamma, sf.rho, dt)
    out2 = yield from force(pos_half, vel_half, K, sf.h)
    if out2 is None:
        return None
    acc2, sf2, _, fb2 = out2
    if cfg.eos == "polytropic":
        K = evolve_K(K, sf2.visc_dk, p.gamma, sf2.rho, dt)
    vel_new = vel + acc2 * dt
    pos_new = pos + vel_new * dt - 0.5 * acc2 * dt**2
    return State(pos_new, vel_new, K, state.t + dt), stats, sf2.h, sf2.rho, int(fb1) + int(fb2)


def make_step(cfg: EngineConfig, *, device=None, grouped=True, joint_gravity=False):
    """Returns step(state, params, h_hint, ghat=None, mlargs=None, aux=None)
    -> (state', stats_row, h_new, rho_new, n_fallbacks). n_fallbacks is a
    python int; ghat, mlargs, aux, grouped and joint_gravity are
    force_eval's. device=None means the card."""
    from ..shard.collectives import run_local

    dev = resolve_device(device)

    def step(state: State, p: Params, h_hint, ghat=None, mlargs=None, aux=None) -> Tuple:
        def force(pos, vel, K, h):
            return force_eval(
                cfg, p, pos, vel, K, h, ghat, mlargs, aux, device=dev, grouped=grouped,
                joint_gravity=joint_gravity,
            )
            yield  # a body with no collective

        new, stats, h, rho, n_fb = run_local(kdk_body(cfg, p, state, h_hint, force))
        if cfg.fallback == "none" and n_fb:
            # a failed certificate means the (uncertified) forces above
            # are not trusted: DISCARD the step — state unchanged, stats
            # zeroed, n_fb tells the caller to replan and re-dispatch.
            return state, torch.zeros_like(stats), h_hint, torch.zeros_like(rho), n_fb
        return new, stats, h, rho, n_fb

    return step


def make_chunk_runner(cfg: EngineConfig, *, device=None, grouped=True,
                      stop_at_fallback=False, joint_gravity=False):
    """Returns chunk(state, params, h0, n_steps, mlargs=None, *,
    scan_length=None): runs up to n_steps steps, freezing once t >= t_end. Outputs (state,
    stats (S,10), valid (S,), h_last, rho_last, fallbacks (S,)); rho_last
    is the last half-step density, which run_simulation threads into the
    snapshot figures (the reference colors its star scatter by rho,
    polytrope_sim.jl:265).

    scan_length is the output length S (default n_steps); steps beyond
    n_steps, like steps at t >= t_end, leave the state untouched and report
    valid=False with a zero stats row. One host read of `t < t_end` per
    step and one of the certificate per force evaluation are the only
    synchronisations. Under p3m the mesh's Green's function is computed
    once, with the runner, not per evaluation. mlargs: the BlockArgs of a
    cfg.blocks config or the MLArgs of a cfg.mlevel config (required then),
    fresh each chunk; they go to the device once a chunk (and a block
    plan's candidate tables are built then); grouped and joint_gravity are
    force_eval's. device=None means the card.

    stop_at_fallback=True ends the chunk after its first step with a
    fallback (ROADMAP D20): under fallback="gather" that step stands (the
    gather engine's forces are exact) and is valid; under "none" it was
    discarded and reports valid=False. The
    default runs every step and reports each valid, as the reference does
    (its fault F1)."""
    dev = resolve_device(device)
    step = make_step(cfg, device=dev, grouped=grouped, joint_gravity=joint_gravity)
    ghat = (
        greens_hat(cfg.mesh_pad, cfg.sigma_cells, cfg.torch_dtype, dev)
        if cfg.gravity == "p3m"
        else None
    )

    def chunk(state: State, p: Params, h0, n_steps, mlargs=None, *, scan_length=None):
        require_on(dev, *state, h0)
        aux = None
        if cfg.blocks is not None and mlargs is not None:
            mlargs = block_args_to_device(mlargs, cfg.torch_dtype, dev)
            aux = build_cand_tables(mlargs, cfg.blocks, cfg.n)
        elif cfg.mlevel is not None and mlargs is not None:
            mlargs = mlevel_args_to_device(mlargs, dev)
        n_steps = int(n_steps)
        if scan_length is None:
            scan_length = n_steps
        if n_steps > scan_length:
            raise ValueError(f"n_steps {n_steps} > scan_length {scan_length}")
        dtype = state.pos.dtype
        stats = torch.zeros((scan_length, 10), dtype=dtype, device=dev)
        valid = torch.zeros((scan_length,), dtype=torch.bool, device=dev)
        nfb = torch.zeros((scan_length,), dtype=torch.int32, device=dev)
        h, rho = h0, torch.zeros_like(h0)
        for i in range(n_steps):
            if not bool(state.t < p.t_end):
                break
            state, stats_i, h, rho, n_fb = step(state, p, h, ghat, mlargs, aux)
            stats[i] = stats_i
            valid[i] = not (stop_at_fallback and n_fb and cfg.fallback == "none")
            nfb[i] = n_fb
            if stop_at_fallback and n_fb:
                break
        return state, stats, valid, h, rho, nfb

    return chunk
