"""Particle-sharded step in its all-gather form (over a mesh of shards).

Port of sphtpu/shard/step.py. run_simulation does not call it: it is the
correctness oracle of the z-slab engine (shard/tiles.py). Each shard owns a
contiguous block of N/P rows; every force evaluation all-gathers the
candidate positions, velocities, h and rho, sweeps its rows against all N
(kNN, pair forces, gravity), and hands the pair scatter back with one
reduce-scatter. The diagnostics and the global dt are psum/pmin reductions.
The bodies are generators (shard/collectives.py): each collective is a
yielded request, and `run_spmd` runs the shards in lock step.

Plain torch throughout (`knn`, `gravity_sweep`), as in the port's gather
engine. Physics formulas are the single-device engine's.
"""

from __future__ import annotations

import torch

from ..engine.config import EngineConfig, Params, State
from ..kernels import W, grad_W_over_r
from ..neighbors import knn
from ..physics.gravity import gravity_sweep
from .collectives import request, run_spmd


def replicate(tree, mesh):
    """One copy of a tensor tuple (State, Params, ...) on each shard's device."""
    return [type(tree)(*(t.to(d) for t in tree)) for d in mesh]


def _local_force_eval(cfg: EngineConfig, p: Params, pos_l, vel_l, K_l, row0: int):
    """Force evaluation for the local row block against the gathered set
    (a generator body: yields its collectives)."""
    n_local = pos_l.shape[0]
    dtype, dev = pos_l.dtype, pos_l.device
    pos_g, vel_g = yield request("all_gather", (pos_l, vel_l))

    idx, _ = knn(pos_l, pos_g, cfg.kh)  # (nl, K) global indices
    dx = pos_l[:, 0:1] - pos_g[:, 0][idx]
    dy = pos_l[:, 1:2] - pos_g[:, 1][idx]
    dz = pos_l[:, 2:3] - pos_g[:, 2][idx]
    r = torch.sqrt(dx * dx + dy * dy + dz * dz)
    h_l = torch.max(r, dim=1).values / 2.0
    hcol = h_l[:, None]
    q = r / hcol
    w = W(q, hcol)
    rho_l = p.m * torch.sum(w, dim=1)

    if cfg.eos == "polytropic":
        h_g, rho_g, K_g = yield request("all_gather", (h_l, rho_l, K_l))
        cs_l = torch.sqrt(p.gamma * K_l * rho_l ** (p.gamma - 1.0))
        por2_g = K_g * rho_g ** (p.gamma - 2.0)  # P/rho^2 = K rho^(g-2)
        por2_l = K_l * rho_l ** (p.gamma - 2.0)
    else:
        h_g, rho_g = yield request("all_gather", (h_l, rho_l))
        cs_l = torch.zeros_like(rho_l) + p.cs0
        por2_g = p.cs0**2 / rho_g
        por2_l = p.cs0**2 / rho_l

    gid = row0 + torch.arange(n_local, device=dev)
    self_mask = idx == gid[:, None]

    h_avg = 0.5 * (hcol + h_g[idx])
    rho_avg = 0.5 * (rho_l[:, None] + rho_g[idx])
    vij_x = vel_l[:, 0:1] - vel_g[:, 0][idx]
    vij_y = vel_l[:, 1:2] - vel_g[:, 1][idx]
    vij_z = vel_l[:, 2:3] - vel_g[:, 2][idx]
    v_dot_r = vij_x * dx + vij_y * dy + vij_z * dz
    mu = torch.clamp_max(h_avg * v_dot_r / (r * r + 0.01 * h_avg**2), 0.0)
    Pi = (-p.alpha * cs_l[:, None] * mu + p.beta * mu**2) / rho_avg

    dWdr = grad_W_over_r(q, r, hcol)
    zero = torch.zeros((), dtype=dtype, device=dev)
    if cfg.eos == "polytropic":
        ct = p.m * (por2_l[:, None] + por2_g[idx] + Pi) / 2.0
    else:
        ct = p.m * (por2_l[:, None] + Pi / 2.0)
    ct = torch.where(self_mask, zero, ct)

    n_global = pos_g.shape[0]
    flat_idx = idx.reshape(-1)
    coeff = ct * dWdr
    v_dot_dW = v_dot_r * dWdr
    # the evolve_K pair sum reduce-scatters its remote contributions just
    # like the pair force does
    ct_k = torch.where(self_mask, zero, p.m * Pi * v_dot_dW / 2.0)
    bufs, sums = [], []
    for contrib in (coeff * dx, coeff * dy, coeff * dz, ct_k):
        sums.append(torch.sum(contrib, dim=1))
        bufs.append(
            torch.zeros((n_global,), dtype=dtype, device=dev).index_add_(
                0, flat_idx, contrib.reshape(-1)
            )
        )
    back = yield request("psum_scatter", tuple(bufs))
    acc_l = torch.stack([-sums[a] + back[a] for a in range(3)], dim=1)
    dk_l = sums[3] + back[3]

    # gravity: local rows against the gathered global column set
    g, phi = gravity_sweep(pos_l, h_l, gid, pos_g, h_g)
    acc_l = acc_l - p.m * g  # G = 1
    phi_l = p.m * phi - p.m * 1.4 / h_l

    return acc_l, dict(
        rho=rho_l,
        h=h_l,
        cs=cs_l,
        mu_max=torch.max(mu, dim=1).values,
        div_sum=torch.sum(p.m * v_dot_dW, dim=1),
        visc_dk=dk_l,
        phi=phi_l,
    )


def make_sharded_step(cfg: EngineConfig, mesh):
    """step(state_l, p, shard) -> generator body of one KDK step on shard
    `shard`'s row block; returns (state_l', stats)."""
    n_dev = len(mesh)
    if cfg.n % n_dev:
        raise ValueError(f"N={cfg.n} not divisible by mesh size {n_dev}")
    n_local = cfg.n // n_dev

    def step(state: State, p: Params, shard: int):
        pos_l, vel_l, K_l = state.pos, state.vel, state.K
        row0 = shard * n_local
        acc, aux = yield from _local_force_eval(cfg, p, pos_l, vel_l, K_l, row0)

        # ---- adaptive dt (global min over the mesh) ----
        vel_r2 = torch.sum(vel_l * vel_l, dim=1)
        a_r = torch.sqrt(torch.sum(acc * acc, dim=1))
        abs_div_v = torch.abs(-aux["div_sum"] / aux["rho"])
        mu_max = aux["mu_max"]
        local_min = torch.minimum(
            torch.minimum(
                torch.min(1.0 / abs_div_v), torch.min(aux["h"] / torch.sqrt(vel_r2))
            ),
            torch.minimum(
                torch.min(torch.sqrt(aux["h"] / a_r)),
                torch.min(
                    aux["h"]
                    / (aux["cs"] + 1.2 * (p.alpha * aux["cs"] + p.beta * mu_max))
                ),
            ),
        )
        dt = 0.3 * (yield request("pmin", local_min))

        # ---- diagnostics (psum -> replicated stats row) ----
        if cfg.eos == "polytropic":
            u_l = torch.sum(K_l / (p.gamma - 1.0) * aux["rho"] ** (p.gamma - 1.0))
        else:
            u_l = torch.zeros_like(local_min)
        sums = yield request("psum", (
            torch.sum(vel_r2), torch.sum(aux["phi"]), u_l,
            torch.sum(pos_l, dim=0), torch.sum(vel_l, dim=0),
        ))
        T = 0.5 * p.m * sums[0]
        V = 0.5 * p.m * sums[1]
        if cfg.eos == "polytropic":
            U = p.m * sums[2]
            Etot = T + V + U
        else:
            U = p.U0
            Etot = T + V + 2.0 * U
        r_com = sums[3] / cfg.n
        p_lin = p.m * sums[4]
        lin_mom = torch.sqrt(torch.sum(p_lin**2))
        ang = p.m * (yield request(
            "psum", torch.sum(torch.linalg.cross(pos_l - r_com, vel_l), dim=0)
        ))
        ang_mom = torch.sqrt(torch.sum(ang**2))
        stats = torch.stack(
            [state.t, T, V, U, Etot, r_com[0], r_com[1], r_com[2], lin_mom, ang_mom]
        )

        # ---- KDK ----
        pos_half = pos_l + vel_l * (dt / 2.0)
        vel_half = vel_l + acc * (dt / 2.0)
        if cfg.eos == "polytropic":
            K_l = K_l + (
                0.5 * (p.gamma - 1.0) / aux["rho"] ** (p.gamma - 1.0) * aux["visc_dk"]
            ) * (dt / 2.0)
        acc2, aux2 = yield from _local_force_eval(cfg, p, pos_half, vel_half, K_l, row0)
        if cfg.eos == "polytropic":
            K_l = K_l + (
                0.5 * (p.gamma - 1.0) / aux2["rho"] ** (p.gamma - 1.0) * aux2["visc_dk"]
            ) * (dt / 2.0)
        vel_new = vel_l + acc2 * dt
        pos_new = pos_l + vel_new * dt - 0.5 * acc2 * dt**2
        return State(pos_new, vel_new, K_l, state.t + dt), stats

    return step


def make_sharded_chunk_runner(cfg: EngineConfig, mesh):
    """chunk(states, p, n_steps) -> (states', stats (S, 10), valid (S,)):
    states is the per-shard list of row-block States (`shard_state`), p
    replicated by the runner. A step runs while t < t_end (one host read a
    step); stats and valid come back on shard 0's device."""
    step = make_sharded_step(cfg, mesh)

    def chunk(states, p: Params, n_steps: int):
        ps = replicate(p, mesh)
        dtype, dev = states[0].pos.dtype, states[0].pos.device
        stats = torch.zeros((n_steps, 10), dtype=dtype, device=dev)
        valid = torch.zeros((n_steps,), dtype=torch.bool, device=dev)
        for i in range(n_steps):
            if not bool(states[0].t < ps[0].t_end):
                break
            out = run_spmd([step(st, pp, k) for k, (st, pp) in enumerate(zip(states, ps))])
            states = [o[0] for o in out]
            stats[i] = out[0][1]
            valid[i] = True
        return states, stats, valid

    return chunk


def shard_state(state: State, mesh) -> list:
    """Split a State's rows into len(mesh) contiguous blocks, one on each
    shard's device (t replicated)."""
    n_dev = len(mesh)
    n = state.pos.shape[0]
    if n % n_dev:
        raise ValueError(f"N={n} not divisible by mesh size {n_dev}")
    k = n // n_dev
    return [
        State(
            state.pos[i * k : (i + 1) * k].to(d),
            state.vel[i * k : (i + 1) * k].to(d),
            state.K[i * k : (i + 1) * k].to(d),
            state.t.to(d),
        )
        for i, d in enumerate(mesh)
    ]


def unshard_state(states) -> State:
    """The row blocks back into one State on shard 0's device."""
    dev = states[0].pos.device
    return State(
        torch.cat([s.pos.to(dev) for s in states]),
        torch.cat([s.vel.to(dev) for s in states]),
        torch.cat([s.K.to(dev) for s in states]),
        states[0].t,
    )
