"""Masked cell-tile machinery shared by the tile engines.

Only what the class-compacted engine (physics/ctiles.py) needs is here:
`ReducedForces`, the particle binning `_bin_particles`, and the host-side
planners `choose_tile_params` / `tile_params_still_ok`. The mono-tile
engine itself (`tile_sph_forces`) and `choose_tile_params_ml` are not
ported yet.

Particles are binned into a dense mono-level grid (edge >= safety * 2*max
h, chosen by run_simulation from the previous step's h) and scattered ONCE per
field into padded slot planes of shape (G+2, G+2, (G+2)*cap) — z, y, x*cap
with a one-cell halo. Exactness is certified per evaluation (slot-capacity
overflow, k found, r_k <= cell edge); the engine layer falls back to the
gather engine when certification fails, so a bad grid choice degrades
speed, never physics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# rows with h * OUTLIER_CUT > cell edge need the outlier lane (its engine is
# not ported yet; the constant is part of tile_params_still_ok's forecast)
OUTLIER_CUT = 2.0 * 1.07


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
