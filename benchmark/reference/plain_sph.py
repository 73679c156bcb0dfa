"""One chunk of the simulation in plain PyTorch: the reference a request's
outputs are held against.

Written from the reference simulation's equations, not from the program:

*   neighbours: the Kh nearest particles, self included (on a grid of
    cells sized from the last evaluation's h, each row certified exact by
    its Kh-th distance, else a scipy KD-tree); h = the farthest one's
    distance over 2 (polytrope_hydroKDTree.jl:118-163);
*   density with the self term, the polytropic EOS P = K rho^gamma and
    c = sqrt(gamma K rho^(gamma-1)) (:166-178);
*   the artificial viscosity mu = min(h_ij v.r / (r^2 + 0.01 h_ij^2), 0),
    Pi = (-alpha c_i mu + beta mu^2) / rho_ij (:181-204);
*   the pair force m ((P_i/rho_i^2 + P_j/rho_j^2) + Pi) / 2 grad W(r; h_i)
    on each row's neighbour list, applied to both members (:229-245), and
    the entropy rate from viscous heating (:296-341);
*   self-gravity of every pair with the cubic-spline softened kernel at
    h_ij = (h_i + h_j) / 2, the self-softening -(7/5) m / h_i on the
    potential (gravOctree_Single.jl:5-29, 239-304 at theta -> 0): distant
    pairs are plain Newtonian and are summed over the whole matrix in
    blocks, the close ones are evaluated one by one from the exact
    separation; the potential only where the diagnostics row needs it;
*   the 4-criterion time step, the diagnostics row and the kick-drift-kick
    step with its two force evaluations (polytrope_sim.jl:158-313).

Everything runs in `dtype` (float64 for the reference; the control runs it
in bfloat16) on the device of the inputs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from scipy.spatial import cKDTree

# elements of one (rows, columns) block of the gravity sweep
BLOCK_ELEMS = 1 << 29
# the neighbour grid's limits: cells, candidates a row, and candidate pairs
# a pass
GRID_CELLS = 1 << 23
GRID_CANDIDATES = 4096
GRID_PAIRS = 1 << 24


class Physics(NamedTuple):
    m: float
    gamma: float
    alpha: float
    beta: float
    kh: int


def tree_neighbours(pos: torch.Tensor, kh: int, rows=None) -> torch.Tensor:
    """(R, kh) indices of the kh nearest particles (self included) of each
    of `rows` (all by default), from a KD-tree on the host."""
    p = pos.detach().to("cpu", torch.float64).numpy()
    q = p if rows is None else p[rows.cpu().numpy()]
    _, idx = cKDTree(p).query(q, k=kh, workers=-1)
    return torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int64)).to(pos.device)


def grid_neighbours(pos: torch.Tensor, kh: int, edge: float, rows=None):
    """The kh nearest of each particle of `rows` (all by default) among the
    particles of the 27 cells around its own, on a grid of cells `edge`
    wide: (idx (R, kh), ok (R,)). A row is exact (ok) when its kh-th
    distance is under the cell edge: every particle outside those 27 cells
    is at least an edge away. None where the grid or its candidate rows
    would be too large."""
    n, dev = pos.shape[0], pos.device
    lo = pos.min(dim=0).values
    c = torch.floor((pos - lo) / edge).to(torch.int64)
    dims = c.max(dim=0).values + 1
    gx, gy, gz = (int(v) for v in dims)
    if gx * gy * gz > GRID_CELLS:
        return None
    cell = (c[:, 2] * gy + c[:, 1]) * gx + c[:, 0]
    order = torch.argsort(cell)
    cell_sorted = cell[order]
    counts = torch.bincount(cell_sorted, minlength=gx * gy * gz)
    cap = int(counts.max())
    if 27 * cap > GRID_CANDIDATES:
        return None
    starts = torch.cumsum(counts, 0) - counts
    table = torch.full((gx * gy * gz, cap), -1, dtype=torch.int64, device=dev)
    table[cell_sorted, torch.arange(n, device=dev) - starts[cell_sorted]] = order
    steps = torch.tensor([-1, 0, 1], device=dev)
    offsets = torch.cartesian_prod(steps, steps, steps)  # (27, 3): x, y, z
    rows = torch.arange(n, device=dev) if rows is None else rows
    m = rows.shape[0]
    idx = torch.empty((m, kh), dtype=torch.int64, device=dev)
    ok = torch.empty((m,), dtype=torch.bool, device=dev)
    step = max(1, GRID_PAIRS // (27 * cap))
    for r0 in range(0, m, step):
        r1 = min(r0 + step, m)
        q = rows[r0:r1]
        cc = c[q, None, :] + offsets[None]
        inside = ((cc >= 0) & (cc < dims)).all(dim=-1)
        nid = torch.where(inside, (cc[..., 2] * gy + cc[..., 1]) * gx + cc[..., 0], 0)
        cand = torch.where(inside[..., None], table[nid], -1).reshape(r1 - r0, -1)
        d = pos[cand.clamp_min(0)] - pos[q, None, :]
        d2 = torch.where(cand >= 0, (d * d).sum(-1), math.inf)
        best, which = torch.topk(d2, kh, dim=1, largest=False)
        idx[r0:r1] = torch.gather(cand, 1, which)
        ok[r0:r1] = best[:, -1] < (0.999 * edge) ** 2
    return idx, ok


def neighbours(pos: torch.Tensor, kh: int, h_hint=None) -> torch.Tensor:
    """(N, kh) indices of each particle's kh nearest, self included: on a
    grid sized from the hinted smoothing lengths where it is exact, the rows
    it does not certify on a grid twice as coarse, what is left from a
    KD-tree (everything without a hint)."""
    if h_hint is None:
        return tree_neighbours(pos, kh)
    p64 = pos.double()
    edge = 2.2 * float(torch.quantile(h_hint.double(), 0.9))
    got = grid_neighbours(p64, kh, edge)
    if got is None:
        return tree_neighbours(pos, kh)
    idx, ok = got
    bad = torch.nonzero(~ok).flatten()
    if bad.numel():
        got = grid_neighbours(p64, kh, 2.0 * edge, bad)
        if got is not None:
            idx[bad[got[1]]] = got[0][got[1]]
            bad = bad[~got[1]]
    if bad.numel():
        idx[bad] = tree_neighbours(pos, kh, bad)
    return idx


def kernel_w(q, h):
    """Cubic-spline W(r; h) at q = r / h."""
    w1 = 1.0 - 1.5 * q**2 + 0.75 * q**3
    w2 = 0.25 * (2.0 - q) ** 3
    w = torch.where(q <= 1.0, w1, torch.where(q <= 2.0, w2, torch.zeros_like(q)))
    return w / (math.pi * h**3)


def kernel_dw_over_r(q, r, h):
    """(dW/dr) / r; the inner branch is the polynomial, finite at r = 0."""
    g1 = 2.25 * r / h**2 - 3.0 / h
    g2 = -0.75 * (2.0 - q) ** 2 / torch.where(r > 0, r, torch.ones_like(r))
    g = torch.where(q <= 1.0, g1, torch.where(q <= 2.0, g2, torch.zeros_like(q)))
    return g / (math.pi * h**4)


def soft_gphi_over_r(r, h):
    """Softened (d phi / dr) / r per unit mass: 1/r^3 beyond q = 2."""
    q = r / h
    rs = torch.where(r > 0, r, torch.ones_like(r))
    qs = torch.where(q > 0, q, torch.ones_like(q))
    inner = (4.0 / 3.0 / h - 1.2 * r**2 / h**3 + 0.5 * r**3 / h**4) / h**2
    mid = (8.0 / 3.0 * q - 3.0 * q**2 + 1.2 * q**3 - q**4 / 6.0 - 1.0 / 15.0 / qs**2) / (h**2 * rs)
    outer = 1.0 / rs**3
    return torch.where(q <= 1.0, inner, torch.where(q <= 2.0, mid, outer))


def soft_phi(r, h):
    """Softened potential per unit mass: -1/r beyond q = 2."""
    q = r / h
    rs = torch.where(r > 0, r, torch.ones_like(r))
    qs = torch.where(q > 0, q, torch.ones_like(q))
    inner = (2.0 / 3.0 * q**2 - 0.3 * q**4 + 0.1 * q**5 - 1.4) / h
    mid = (4.0 / 3.0 * q**2 - q**3 + 0.3 * q**4 - q**5 / 30.0 - 1.6 + 1.0 / 15.0 / qs) / h
    return torch.where(q <= 1.0, inner, torch.where(q <= 2.0, mid, -1.0 / rs))


def hydro(pos, vel, K, idx, ph: Physics):
    """Hydro accelerations and the per-particle sums of one evaluation."""
    n = pos.shape[0]
    d = pos[:, None, :] - pos[idx]
    r = torch.sqrt((d * d).sum(-1))
    h = r.max(dim=1).values / 2.0
    q = r / h[:, None]
    rho = ph.m * kernel_w(q, h[:, None]).sum(1)
    cs = torch.sqrt(ph.gamma * K * rho ** (ph.gamma - 1.0))
    p_over_rho2 = K * rho**ph.gamma / rho**2
    h_ij = 0.5 * (h[:, None] + h[idx])
    rho_ij = 0.5 * (rho[:, None] + rho[idx])
    v = vel[:, None, :] - vel[idx]
    v_dot_r = (v * d).sum(-1)
    mu = torch.clamp_max(h_ij * v_dot_r / (r * r + 0.01 * h_ij**2), 0.0)
    visc = (-ph.alpha * cs[:, None] * mu + ph.beta * mu**2) / rho_ij
    dw = kernel_dw_over_r(q, r, h[:, None])
    is_self = idx == torch.arange(n, device=idx.device)[:, None]
    coeff = ph.m * (p_over_rho2[:, None] + p_over_rho2[idx] + visc) / 2.0
    coeff = torch.where(is_self, torch.zeros_like(coeff), coeff) * dw
    pair = coeff[..., None] * d
    acc = -pair.sum(1)
    acc.index_add_(0, idx.reshape(-1), pair.reshape(-1, 3))
    v_dot_dw = v_dot_r * dw
    heat = torch.where(is_self, torch.zeros_like(visc), ph.m * visc * v_dot_dw / 2.0)
    visc_dk = heat.sum(1)
    visc_dk.index_add_(0, idx.reshape(-1), heat.reshape(-1))
    return {
        "acc": acc, "rho": rho, "h": h, "cs": cs,
        "mu_max": mu.max(dim=1).values,
        "div_sum": (ph.m * v_dot_dw).sum(1),
        "visc_dk": visc_dk,
    }


def gravity(pos, h, m: float, *, potential: bool = True, block_elems: int = BLOCK_ELEMS):
    """(g, phi_sum): g_i = sum_j m gphi(r_ij; h_ij)/r (x_i - x_j) over
    j != i, and the sum over i of phi_i = sum_j m phi(r_ij; h_ij) -
    (7/5) m / h_i (None unless `potential`).

    Each block of rows meets the columns from its own first row on, so every
    pair is formed once and given to both members. A pair closer than
    h_i + max h (by the block's distances, |x_i|^2 + |x_j|^2 - 2 x_i.x_j)
    is evaluated one by one from its exact separation with the softened
    kernel, which is Newtonian beyond h_i + h_j; every other pair is
    Newtonian and summed over the block."""
    n = pos.shape[0]
    g = torch.zeros_like(pos)
    phi_sum = torch.zeros((), dtype=pos.dtype, device=pos.device)
    sq = (pos * pos).sum(1)
    one = torch.ones_like(sq)
    left = torch.stack([pos[:, 0], pos[:, 1], pos[:, 2], sq, one], dim=1)
    right = torch.stack([-2.0 * pos[:, 0], -2.0 * pos[:, 1], -2.0 * pos[:, 2], one, sq], dim=1)
    with_one = torch.cat([pos, one[:, None]], dim=1)
    twice = torch.full_like(sq, 2.0)
    reach2 = (h + h.max()) ** 2
    rows = max(64, min(n, block_elems // max(n, 1)))
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        b = r1 - r0
        r2 = left[r0:r1] @ right[r0:].T
        near = r2 < reach2[r0:r1, None]
        inv = r2.masked_fill_(near, math.inf).rsqrt_()
        if potential:
            # the block's own columns hold both orders of a pair, the rest one
            weights = twice[r0:].clone()
            weights[:b] = 1.0
            phi_sum -= (inv @ weights).sum()
        inv3 = inv.pow_(3)
        rows_sum = inv3 @ with_one[r0:]
        g[r0:r1] += pos[r0:r1] * rows_sum[:, 3:] - rows_sum[:, :3]
        cols_sum = inv3[:, b:].T @ with_one[r0:r1]
        g[r1:] += pos[r1:] * cols_sum[:, 3:] - cols_sum[:, :3]
        del r2, inv, inv3, rows_sum, cols_sum
        ii, jj = near.nonzero(as_tuple=True)
        del near
        ii, jj = ii + r0, jj + r0
        keep = ii != jj
        ii, jj = ii[keep], jj[keep]
        d = pos[ii] - pos[jj]
        r = torch.sqrt((d * d).sum(1))
        h_ij = 0.5 * (h[ii] + h[jj])
        gp = soft_gphi_over_r(r, h_ij)[:, None] * d
        g.index_add_(0, ii, gp)
        both = jj >= r1
        g.index_add_(0, jj[both], -gp[both])
        if potential:
            pp = soft_phi(r, h_ij)
            phi_sum += pp.sum() + pp[both].sum()
    if not potential:
        return m * g, None
    return m * g, m * phi_sum - 1.4 * m * (1.0 / h).sum()


def forces(pos, vel, K, ph: Physics, h_hint=None, potential: bool = True):
    """One force evaluation: hydro minus gravity (G = 1), with its sums."""
    f = hydro(pos, vel, K, neighbours(pos, ph.kh, h_hint), ph)
    g, phi_sum = gravity(pos, f["h"], ph.m, potential=potential)
    f["acc"] = f["acc"] - g
    f["phi_sum"] = phi_sum
    return f


def time_step(f, vel, ph: Physics):
    """0.3 x the least of the four criteria (polytrope_sim.jl:165-174)."""
    speed = torch.sqrt((vel * vel).sum(1))
    acc = torch.sqrt((f["acc"] * f["acc"]).sum(1))
    c1 = torch.min(1.0 / torch.abs(f["div_sum"] / f["rho"]))
    c2 = torch.min(f["h"] / speed)
    c3 = torch.min(torch.sqrt(f["h"] / acc))
    c4 = torch.min(f["h"] / (f["cs"] + 1.2 * (ph.alpha * f["cs"] + ph.beta * f["mu_max"])))
    return 0.3 * torch.min(torch.stack([c1, c2, c3, c4]))


def diagnostics(pos, vel, K, t, f, ph: Physics):
    """[t, T, V, U, E, com_x, com_y, com_z, |p|, |L|] (polytrope_sim.jl:177-202)."""
    n = pos.shape[0]
    kin = 0.5 * ph.m * (vel * vel).sum()
    pot = 0.5 * ph.m * f["phi_sum"]
    internal = ph.m * (K / (ph.gamma - 1.0) * f["rho"] ** (ph.gamma - 1.0)).sum()
    com = pos.sum(0) / n
    p_lin = ph.m * vel.sum(0)
    ang = ph.m * torch.linalg.cross(pos - com, vel).sum(0)
    return torch.stack([
        t, kin, pot, internal, kin + pot + internal, com[0], com[1], com[2],
        torch.sqrt((p_lin * p_lin).sum()), torch.sqrt((ang * ang).sum()),
    ])


def entropy_kick(K, f, ph: Physics, dt):
    return K + (0.5 * (ph.gamma - 1.0) / f["rho"] ** (ph.gamma - 1.0) * f["visc_dk"]) * (dt / 2.0)


def run_chunk(pos, vel, K, t, *, ph: Physics, t_end: float, n_steps: int,
              dtype=torch.float64):
    """Up to n_steps steps from (pos, vel, K, t), stopping at t >= t_end.
    Returns dict(pos, vel, K, t, stats (n_steps, 10), valid (n_steps,), h,
    rho): h and rho of the last step's second evaluation."""
    pos, vel, K = (x.to(dtype) for x in (pos, vel, K))
    t = torch.as_tensor(t, dtype=dtype, device=pos.device)
    stats = torch.zeros((n_steps, 10), dtype=dtype, device=pos.device)
    valid = torch.zeros((n_steps,), dtype=torch.bool, device=pos.device)
    h = rho = None
    for i in range(n_steps):
        if not bool(t < t_end):
            break
        f1 = forces(pos, vel, K, ph, h)
        dt = time_step(f1, vel, ph)
        stats[i] = diagnostics(pos, vel, K, t, f1, ph)
        pos_half = pos + vel * (dt / 2.0)
        vel_half = vel + f1["acc"] * (dt / 2.0)
        K = entropy_kick(K, f1, ph, dt)
        f2 = forces(pos_half, vel_half, K, ph, f1["h"], potential=False)
        K = entropy_kick(K, f2, ph, dt)
        vel_new = vel + f2["acc"] * dt
        pos = pos + vel_new * dt - 0.5 * f2["acc"] * dt**2
        vel = vel_new
        t = t + dt
        valid[i] = True
        h, rho = f2["h"], f2["rho"]
    return {"pos": pos, "vel": vel, "K": K, "t": t, "stats": stats, "valid": valid,
            "h": h, "rho": rho}
