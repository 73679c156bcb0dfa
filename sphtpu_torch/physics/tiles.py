"""Masked cell-tile machinery and the mono-tile engine.

Particles are binned into a dense mono-level grid (edge >= safety * 2*max
h, chosen by run_simulation from the previous step's h) and scattered ONCE
per field into padded slot planes of shape (G+2, G+2, (G+2)*cap) — z, y,
x*cap with a one-cell halo — and from there into a 27-cell candidate
prestack (field, cell, 27*cap). `_tile_stack`, `_stack_sph_fields` and
`_extract` build and read that layout for both tile engines: the
class-compacted engine (physics/ctiles.py) and `tile_sph_forces` here.

`tile_sph_forces` is the mono-tile engine, the planner's rung for states
the class engine does not take and the engine of the P3M path. Every cell
sweeps all `cap` query slots:

*   phase A — kernels/cuda_knn.phase_a_tile (exact k-th distance by count
    bisection, density, certificate r_k <= cell edge), the queries being
    the centre cell of each candidate row;
*   phase B — kernels/cuda_tile_pairs.phase_b_tiles, the class engine's
    pair kernel (forward/reverse masked pair forces + the softened minus
    Newtonian near-field term) driven over every cell row;
*   phase C (P3M only) — kernels/cuda_p3m_tail.p3m_tail, (Newtonian minus
    mesh shape) over the (2W+1)^3-cell stencil, W = the tail half-width.

With an outlier budget (`outlier_budget > 0`, planned by
`choose_tile_params_ml`) the grid is sized for the bulk of the h
distribution, and the rows whose hinted h cannot certify on it take the
exact outlier lane of physics/outliers.py: their kNN, h and rho replace
phase A's, phase B leaves them out of its forward mask (as queries) and its
reverse mask (as candidates), and the lane adds their pair forces, their
scatter and the gravity corrections beyond the 27-cell stencil.

Exactness is certified per evaluation (slot-capacity overflow, k found,
r_k <= cell edge, outliers within the budget); the engine layer falls back
to the gather engine when certification fails, so a bad grid choice
degrades speed, never physics. Each stage runs inside `profiling.stage`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import require_on, resolve_device
from ..kernels.cuda_knn import phase_a_tile
from ..kernels.cuda_p3m_tail import p3m_tail
from ..kernels.cuda_tile_pairs import phase_b_tiles
from ..profiling import stage
from .mesh_gravity import _domain_half, tail_halfwidth
from .outliers import (
    OUTLIER_CUT,
    outlier_forces,
    outlier_gravity_corr,
    outlier_knn,
)

# field planes of the slot layout, in the order the pair kernel takes them
X, Y, Z, VX, VY, VZ, MASK, H, RHO, POR2, CS = range(11)


class ReducedForces(NamedTuple):
    acc: torch.Tensor  # (N, 3) hydro acceleration
    rho: torch.Tensor  # (N,)
    h: torch.Tensor  # (N,)
    cs: torch.Tensor  # (N,)
    mu_max: torch.Tensor  # (N,)
    div_sum: torch.Tensor  # (N,)
    visc_dk: torch.Tensor  # (N,)


def choose_tile_params(
    pos_code,
    h,
    kh: int,
    *,
    safety: float = 1.05,
    cap_max: int = 256,
    headroom: float = 1.25,
):
    """Host-side grid sizing from the current positions and smoothing
    lengths (numpy, runs between chunks).

    Cell edge must be >= safety * 2 * max(h) for mono-level certification
    (rounded down: coarser = safe for the r_k bound) and the slot capacity
    comes from the *measured* max cell occupancy plus drift headroom.
    Returns (grid, cap) — or None when the density contrast needs more
    capacity than cap_max (caller stays on the gather engine).
    """
    import numpy as np

    pos_code = np.asarray(pos_code)
    h = np.asarray(h)
    half = float(np.abs(pos_code).max()) * (1 + 1e-6)
    grid = max(int(2.0 * half / (safety * 2.0 * float(h.max()))), 2)
    s_eff = 2.0 * half / grid
    c = np.clip((pos_code + half) // s_eff, 0, grid - 1).astype(np.int64)
    cells = (c[:, 2] * grid + c[:, 1]) * grid + c[:, 0]
    cmax = int(np.bincount(cells, minlength=grid**3).max())
    # 32-slot granularity keeps candidate widths lane-friendly
    cap = max(32, int(-(-headroom * cmax // 32)) * 32)
    if cap > cap_max:
        return None
    return grid, cap


def choose_tile_params_ml(
    pos_code,
    h,
    kh: int,
    *,
    safety: float = 1.05,
    cap_max: int = 256,
    headroom: float = 1.25,
    budget_margin: float = 1.3,
    slots_max: int = 12_000_000,
    budgets=(256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536),
):
    """Host-side grid sizing with the outlier lane: (grid, cap, budget) or
    None (numpy; the reference's planner, bit-equal).

    Scans candidate grids from the mono-level choice (budget 0, identical
    to choose_tile_params) down to cells sized for the dense bulk, routing
    the large-h tail through the exact outlier lane (physics/outliers.py),
    and picks the candidate with the lowest modeled cost

        cost ~ grid^3 * cap^2 * 27 * C_TILE  +  N * budget * C_SWEEP

    (pair work over padded tile slots vs the O(B*N) outlier sweeps).
    Feasibility: occupancy cap <= cap_max, an available budget, and
    grid^3 * cap <= slots_max. Returns None only when no candidate is
    feasible — the caller stays on the exact gather engine."""
    import numpy as np

    C_TILE = 70.0  # ops per slot-pair (17 bisection compares + force)
    C_SWEEP = 60.0  # ops per outlier-sweep pair (two sweeps)

    pos_code = np.asarray(pos_code)
    h = np.asarray(h)
    n = h.shape[0]
    half = float(np.abs(pos_code).max()) * (1 + 1e-6)

    g0 = max(int(2.0 * half / (safety * 2.0 * float(h.max()))), 2)
    g_hi = max(
        int(2.0 * half / (safety * 2.0 * float(np.quantile(h, 0.3)))), g0
    )
    grids = []
    g_c = g0
    while g_c <= min(g_hi, 128):
        grids.append(g_c)
        g_c = max(g_c + 1, int(g_c * 1.25))

    best = None
    for grid in grids:
        s_eff = 2.0 * half / grid
        n_out = int(np.sum(h * OUTLIER_CUT > s_eff))
        if n_out == 0:
            budget = 0
        else:
            budget = next(
                (b for b in budgets if b >= n_out * budget_margin + 64), None
            )
            if budget is None:
                continue
        c = np.clip((pos_code + half) // s_eff, 0, grid - 1).astype(np.int64)
        cells = (c[:, 2] * grid + c[:, 1]) * grid + c[:, 0]
        cmax = int(np.bincount(cells, minlength=grid**3).max())
        cap = max(32, int(-(-headroom * cmax // 32)) * 32)
        if cap > cap_max or grid**3 * cap > slots_max:
            continue
        cost = (
            grid**3 * float(cap) ** 2 * 27.0 * C_TILE
            + n * float(budget) * C_SWEEP
        )
        if best is None or cost < best[0]:
            best = (cost, grid, cap, budget)
    if best is None:
        return None
    return best[1], best[2], best[3]


def tile_params_still_ok(
    pos_code,
    h,
    grid: int,
    cap: int,
    budget: int,
    *,
    occ_slack: float = 1.1,
    budget_slack: float = 1.25,
    slots_max: int = 12_000_000,
):
    """Host-side forecast: can the ALREADY-COMPILED (grid, cap, budget)
    config still certify on the current state?

    run_simulation keeps the previous chunk's config as long as this cheap
    check passes (hysteresis) instead of re-planning every chunk as h
    drifts. The engine's per-evaluation certificate remains the
    safety net: a wrong forecast costs a fallback, never physics.

    Bulk rows (h * OUTLIER_CUT <= cell edge) automatically satisfy the
    r_k <= s certification bound; the checks are occupancy-with-slack,
    outlier count within budget-with-slack, and the slot-memory cap.
    """
    import numpy as np

    pos_code = np.asarray(pos_code)
    h = np.asarray(h)
    half = float(np.abs(pos_code).max()) * (1 + 1e-6)
    s_eff = 2.0 * half / grid
    n_out = int(np.sum(h * OUTLIER_CUT > s_eff))
    if n_out > budget / budget_slack:
        return False
    if grid**3 * cap > slots_max:
        return False
    c = np.clip((pos_code + half) // s_eff, 0, grid - 1).astype(np.int64)
    cells = (c[:, 2] * grid + c[:, 1]) * grid + c[:, 0]
    cmax = int(np.bincount(cells, minlength=grid**3).max())
    return cmax * occ_slack <= cap



def _bin_particles(pos, grid, cap, half):
    """Cell coords, in-cell ranks and the padded-plane slot index."""
    n = pos.shape[0]
    g = grid
    s = 2.0 * half / g
    c = torch.clamp(torch.floor((pos + half) / s).to(torch.int64), 0, g - 1)
    cell = (c[:, 2] * g + c[:, 1]) * g + c[:, 0]
    # stable: in-cell ranks follow particle order, as the reference's
    order = torch.argsort(cell, stable=True)
    cell_s = cell[order]
    iota = torch.arange(n, dtype=torch.int64, device=pos.device)
    newseg = torch.cat(
        [
            torch.ones((1,), dtype=torch.bool, device=pos.device),
            cell_s[1:] != cell_s[:-1],
        ]
    )
    seg_start = torch.cummax(
        torch.where(newseg, iota, torch.zeros_like(iota)), dim=0
    ).values
    rank_s = iota - seg_start
    # back to original particle order
    rank = torch.empty((n,), dtype=torch.int64, device=pos.device)
    rank[order] = rank_s
    overflow = torch.max(rank) >= cap
    # padded-plane indices (one-cell halo on every axis)
    pz = c[:, 2] + 1
    py = c[:, 1] + 1
    px = (c[:, 0] + 1) * cap + torch.clamp_max(rank, cap - 1)
    return c, rank, (pz, py, px), overflow, s


class TileStack(NamedTuple):
    """The slot layout of one evaluation (see `_tile_stack`)."""

    cell_row: torch.Tensor  # (N,) flat cell of each particle
    rank: torch.Tensor  # (N,) slot within the cell, clamped to cap - 1
    pz: torch.Tensor  # (N,) padded-plane indices (one-cell halo)
    py: torch.Tensor
    px: torch.Tensor
    overflow: torch.Tensor  # device bool: a cell holds more than cap
    s: torch.Tensor  # cell edge
    planes: torch.Tensor  # (11, G+2, G+2, (G+2)*cap)
    pre: torch.Tensor  # (11, G^3 + 1, 27, cap) candidate prestack
    qpl: torch.Tensor  # (11, G^3 + 1, cap) query slots
    grid: int
    cap: int

    @property
    def pre_rows(self) -> torch.Tensor:
        """(11, G^3 + 1, 27*cap) view of the prestack: one candidate row
        per cell."""
        return self.pre.view(11, self.grid**3 + 1, 27 * self.cap)


def _tile_stack(pos, vel, grid: int, cap: int) -> TileStack:
    """Bin the particles, scatter the kinematic fields (x y z vx vy vz mask)
    into the slot planes and from there into the candidate prestack and
    the query-slot view. Row G^3 of both is an all-padding sentinel (the
    class engine pads its class lists with it). No host synchronisation."""
    n = pos.shape[0]
    dtype, dev = pos.dtype, pos.device
    g = grid
    half = _domain_half(pos)
    coords, rank, (pz, py, px), overflow, s = _bin_particles(pos, g, cap, half)
    cell_row = (coords[:, 2] * g + coords[:, 1]) * g + coords[:, 0]
    # out-of-capacity ranks fail the certificate (`overflow`); clamp them
    # so the slot gathers/scatters stay in bounds meanwhile
    rank = torch.clamp_max(rank, cap - 1)
    gp = g + 2
    n_cells = g**3
    planes = torch.zeros((11, gp, gp, gp * cap), dtype=dtype, device=dev)
    planes[: MASK + 1, pz, py, px] = torch.cat(
        [pos.T, vel.T.to(dtype), torch.ones((1, n), dtype=dtype, device=dev)]
    )
    pre = torch.zeros((11, n_cells + 1, 27, cap), dtype=dtype, device=dev)
    qpl = torch.zeros((11, n_cells + 1, cap), dtype=dtype, device=dev)
    st = TileStack(cell_row, rank, pz, py, px, overflow, s, planes, pre, qpl, g, cap)
    _fill(st, X, MASK + 1)
    return st


def _fill(st: TileStack, lo: int, hi: int) -> None:
    """Copy fields lo..hi-1 of the slot planes into the prestack (27
    neighbour cells in (dz, dy, dx) order) and the query-slot view."""
    fill_stack(st.planes, st.pre, st.qpl, lo, hi, st.grid, st.grid, st.cap)


def fill_stack(planes, pre, qpl, lo: int, hi: int, nz: int, g: int, cap: int) -> None:
    """Fields lo..hi-1 of padded slot planes (F, nz + 2, g + 2, (g + 2) *
    cap; the query cells are the nz x g x g interior) into the first
    nz g^2 rows of the prestack (F, rows, 27, cap: the 27 neighbour cells
    in (dz, dy, dx) order, the centre at 13) and of the query-slot view
    (F, rows, cap). The mono-tile engine's cube has nz = g; the z-slab
    engine (shard/tiles.py) stacks its slab's query layers."""
    n_cells = nz * g * g
    i = 0
    for dz in range(3):
        for dy in range(3):
            for dxs in range(3):
                blk = planes[lo:hi, dz : dz + nz, dy : dy + g, dxs * cap : (dxs + g) * cap]
                pre[lo:hi, :n_cells, i] = blk.reshape(hi - lo, n_cells, cap)
                i += 1
    qpl[lo:hi, :n_cells] = planes[
        lo:hi, 1 : nz + 1, 1 : g + 1, cap : (g + 1) * cap
    ].reshape(hi - lo, n_cells, cap)


def _stack_sph_fields(st: TileStack, Hq, RHOq, K, *, eos, gamma, cs0):
    """P/rho^2 and cs per query slot from phase A's (G^3, cap) h and rho,
    and all four fields (h, rho, P/rho^2, cs) into the planes, the
    prestack and the query-slot view. Returns cs per slot."""
    g, cap = st.grid, st.cap
    n_cells = g**3
    dtype, dev = Hq.dtype, Hq.device
    rho_safe = torch.where(RHOq > 0, RHOq, torch.ones_like(RHOq))
    occ_mask = st.qpl[MASK, :n_cells] > 0
    zero = torch.zeros((), dtype=dtype, device=dev)
    if eos == "polytropic":
        Kq = torch.zeros((n_cells, cap), dtype=dtype, device=dev)
        Kq[st.cell_row, st.rank] = K.to(dtype)
        POR2q = torch.where(occ_mask, Kq * rho_safe ** (gamma - 2.0), zero)
        CSq = torch.where(
            occ_mask, torch.sqrt(gamma * Kq * rho_safe ** (gamma - 1.0)), zero
        )
    else:
        POR2q = torch.where(occ_mask, cs0**2 / rho_safe, zero)
        CSq = torch.where(occ_mask, torch.zeros_like(rho_safe) + cs0, zero)
    interior = st.planes[H:, 1 : g + 1, 1 : g + 1, cap : (g + 1) * cap]
    interior.copy_(torch.stack([Hq, RHOq, POR2q, CSq]).view(4, g, g, g * cap))
    _fill(st, H, CS + 1)
    return CSq


def _extract(st: TileStack, outs, Hq, RHOq, CSq, *, eos, cs0):
    """Per-particle results from the (10, rows, cap) pair outputs (ax ay az
    div mu_max visc ggx ggy ggz gphi) and phase A's slot fields:
    (ReducedForces, (gx, gy, gz, phi) near-gravity corrections)."""
    n = st.cell_row.shape[0]
    AX, AY, AZ, DIV, MU, VISC, GX, GY, GZ, GP = outs[:, st.cell_row, st.rank]
    red = ReducedForces(
        acc=torch.stack([AX, AY, AZ], dim=1),
        rho=RHOq[st.cell_row, st.rank],
        h=Hq[st.cell_row, st.rank],
        cs=CSq[st.cell_row, st.rank]
        if eos == "polytropic"
        else torch.zeros((n,), dtype=Hq.dtype, device=Hq.device) + cs0,
        mu_max=MU,
        div_sum=DIV,
        visc_dk=VISC,
    )
    return red, (GX, GY, GZ, GP)


def _tail_planes(pos, st: TileStack, w: int, h=None) -> torch.Tensor:
    """x, y, z, mask (and h, when given: the skip mode's fifth plane) at
    the particles' slots with a w-cell halo: the input layout of
    kernels/cuda_p3m_tail (gpc = G + 2w)."""
    n = pos.shape[0]
    g, cap = st.grid, st.cap
    gpc = g + 2 * w
    rows = [pos.T, torch.ones((1, n), dtype=pos.dtype, device=pos.device)]
    if h is not None:
        rows.append(h[None].to(pos.dtype))
    rows = torch.cat(rows)
    out = torch.zeros((rows.shape[0], gpc, gpc, gpc * cap), dtype=pos.dtype, device=pos.device)
    out[:, st.pz + (w - 1), st.py + (w - 1), st.px + (w - 1) * cap] = rows
    return out


def tile_sph_forces(
    pos: torch.Tensor,
    vel: torch.Tensor,
    m,
    K,
    h_hint: torch.Tensor,
    *,
    eos: str,
    gamma,
    cs0,
    alpha,
    beta,
    kh: int,
    grid: int,
    cap: int,
    mesh_factor: int = 0,
    sigma_cells: float = 2.2,
    outlier_budget: int = 0,
    joint_gravity: bool = False,
    device=None,
):
    """(ReducedForces, (gx, gy, gz, phi) near-gravity corrections, ok).
    ok False => result invalid, the caller falls back.

    mesh_factor == 0 (exact mode): the corrections turn a pure-Newtonian
    all-pairs sweep into the reference's softened gravity — for pairs with
    q = r/h_avg <= 2 the 27-cell pass adds (softened - Newtonian).
    mesh_factor > 0 (P3M mode): phase C adds (Newtonian - mesh shape) over
    the (2W+1)^3 stencil, W = tail_halfwidth(mesh_factor, sigma_cells), so
    mesh + corrections is the softened interaction up to the ~1e-4
    Gaussian tail beyond W cells.

    outlier_budget > 0: the two-species split of the reference. Rows with
    h_hint * OUTLIER_CUT > cell edge are outliers; ok also needs their
    count <= outlier_budget. The lane runs on the real rows only, so the
    host reads that count, and then, in each block of the two gravity
    sweeps (physics/outliers.py), the block's kept-pair count; with no
    outlier row the evaluation is the one without a budget. Without a
    budget there is no host synchronisation: ok is a device scalar.

    joint_gravity=True (what the run loop passes; ROADMAP D21): in float32
    under P3M, K2 takes a close pair's (r <= 2 h_avg) term 1 and term 2 as
    one term summed in float64 (`phase_b_tiles(joint=True)`) and the tail
    leaves those pairs out (`p3m_tail(skip_joint=True)`); the default, and
    float64 always, add them in two sweeps, as the reference does (F8).
    device=None means the card."""
    require_on(resolve_device(device), pos, vel)
    dtype = pos.dtype
    n_cells = grid**3
    joint = joint_gravity and mesh_factor > 0 and dtype == torch.float32
    with stage("tiles_bin"):
        st = _tile_stack(pos, vel, grid, cap)

    # two-species split (physics/outliers.py): rows whose hinted h cannot
    # certify on this grid take the exact outlier lane. The hint only
    # SELECTS the species; bulk-row exactness is still certified from the
    # found r_k <= s, and the lane is exact regardless.
    out_rows, budget_ok = None, True
    if outlier_budget > 0:
        out_mask = h_hint.to(dtype) * OUTLIER_CUT > st.s
        rows = torch.nonzero(out_mask).flatten()  # the host read of n_out
        if rows.numel() > 0:
            budget_ok = rows.numel() <= outlier_budget
            out_rows = rows[:outlier_budget]  # the reference's padded rows, real ones only
            # a mask of 2 marks an outlier's slot for phase B's outlier masks
            st.planes[MASK, st.pz, st.py, st.px] += out_mask.to(dtype)
            _fill(st, MASK, MASK + 1)

    # phase A: exact k-th distance + density, queries = each row's centre cell
    with stage("phase_a"):
        cands = tuple(st.pre_rows[f, :n_cells] for f in (X, Y, Z, MASK))
        Hq, RHOq, OKq = phase_a_tile(cands, st.s * st.s, m, kh=kh, cap=cap)
    if out_rows is not None:
        # the outlier rows' exact kNN pass overwrites their slots, so that
        # P/rho^2, cs and the prestack see the merged values; outlier rows
        # are exempt from phase A's certificate
        with stage("outlier_knn"):
            out_idx, h_out, rho_out = outlier_knn(pos, out_rows, m, kh)
            oc, orank = st.cell_row[out_rows], st.rank[out_rows]
            Hq[oc, orank] = h_out.to(dtype)
            RHOq[oc, orank] = rho_out.to(dtype)
            OKq[oc, orank] = 1.0
    rows_ok = torch.all(OKq > 0) & budget_ok
    sigma = (st.s / mesh_factor) * sigma_cells if mesh_factor > 0 else None
    with stage("phase_b"):
        CSq = _stack_sph_fields(st, Hq, RHOq, K, eos=eos, gamma=gamma, cs0=cs0)
        # phase B: the pair kernel over every cell row at the full capacity;
        # with the lane, outlier queries leave its forward mask and outlier
        # candidates its reverse mask; joint: a close pair's term 2 too
        outs = torch.stack(
            phase_b_tiles(
                tuple(st.qpl[f, :n_cells] for f in range(11)),
                tuple(st.pre_rows[f, :n_cells] for f in range(11)),
                m, alpha, beta, sigma if joint else None, eos=eos, p3m=False, cap=cap,
                outlier=out_rows is not None, joint=joint,
            )
        )

    if mesh_factor > 0:
        # phase C: the P3M tail, term 2 (Newtonian - mesh shape); joint:
        # without the pairs phase B took it for
        with stage("phase_c"):
            w = tail_halfwidth(mesh_factor, sigma_cells)
            h_slot = Hq[st.cell_row, st.rank] if joint else None
            outs[6:] += p3m_tail(
                _tail_planes(pos, st, w, h_slot), m, sigma, grid=grid, cap=cap,
                halfwidth=w, skip_joint=joint,
            )

    red, gcorr = _extract(st, outs, Hq, RHOq, CSq, eos=eos, cs0=cs0)
    if out_rows is not None:
        red, gcorr = _add_outlier_lane(
            pos, vel, m, K, red, gcorr, out_rows, out_idx, st,
            eos=eos, gamma=gamma, cs0=cs0, alpha=alpha, beta=beta,
        )
    return red, gcorr, (~st.overflow) & rows_ok


def _add_outlier_lane(
    pos, vel, m, K, red, gcorr, out_rows, out_idx, st,
    *, eos, gamma, cs0, alpha, beta,
):
    """The outlier rows' exact pair forces (the reference's scatter
    semantics) and the softened-gravity corrections their long reach needs
    beyond the 27-cell stencil, added to the tile engine's per-particle
    results as the reference adds them."""
    rho_p = red.rho
    rho_safe = torch.where(rho_p > 0, rho_p, torch.ones_like(rho_p))
    if eos == "polytropic":
        por2_p = K.to(pos.dtype) * rho_safe ** (gamma - 2.0)
    else:
        por2_p = cs0**2 / rho_safe
    with stage("outlier_forces"):
        row, scat = outlier_forces(
            pos, vel, out_rows, out_idx, red.h, rho_p, por2_p, red.cs, m,
            eos=eos, alpha=alpha, beta=beta,
        )
        # additive: outlier slots keep their in-tile reverse terms (their
        # dropped forward terms are the lane's); the forward-only
        # reductions (mu_max, div) are replaced
        acc = red.acc.index_add(0, out_rows, row["acc"])
        visc = red.visc_dk.index_add(0, out_rows, row["visc_dk"])
        mu = red.mu_max.index_copy(0, out_rows, row["mu_max"])
        div = red.div_sum.index_copy(0, out_rows, row["div_sum"])
        acc = acc + torch.stack([scat["ax"], scat["ay"], scat["az"]], dim=1)
        visc = visc + scat["visc"]
    with stage("outlier_gravity"):
        half = _domain_half(pos)
        dg, dphi = outlier_gravity_corr(pos, red.h, out_rows, m, half, st.s, st.grid)
        gcorr = (gcorr[0] + dg[:, 0], gcorr[1] + dg[:, 1], gcorr[2] + dg[:, 2],
                 gcorr[3] + dphi)
    red = red._replace(acc=acc, visc_dk=visc, mu_max=mu, div_sum=div)
    return red, gcorr
