"""SPH hydrodynamics: density, EOS, artificial viscosity, pair forces.

The gather (neighbor-list) engine: always correct, used as the fallback
when a tile certificate fails and as the in-package oracle. One
parameterized engine covering both of the reference's near-duplicate
hydro files (polytrope_hydroKDTree.jl / isothermal_hydroKDTree.jl) — the
EOS is a config string. Semantics mirrored exactly:

- kNN neighbor lists of size Kh including self; h = (distance to the
  farthest of the Kh)/2 (polytrope_hydroKDTree.jl:151)
- density includes the self term (getDensity, :166-178)
- artificial viscosity mu = min(h_avg v.r / (r^2 + 0.01 h_avg^2), 0),
  Pi = (-alpha cs_i mu + beta mu^2)/rho_avg (:181-204); the polytrope path
  uses the *row* particle's sound speed (cs broadcast over rows), the
  isothermal path the global scalar cs
- pair force coefficients (hydroCalculation):
    polytropic: ct = m ((P_i/rho_i^2 + P_j/rho_j^2) + Pi_ij)/2   (:235)
    isothermal: ct = m (P_i/rho_i^2 + Pi_ij/2)                   (isothermal_hydroKDTree.jl:232)
  scattered symmetrically: a_i -= ct dW_ij, a_j += ct dW_ij, self pair
  skipped (:229-245)
- entropy evolution dK/dt from viscous heating (evolve_K!, :296-341)

Separations are recomputed exactly from gathered positions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import W, grad_W_over_r
from ..neighbors import knn


class SphForces(NamedTuple):
    acc: torch.Tensor  # (N, 3) hydro-only acceleration
    rho: torch.Tensor  # (N,)
    h: torch.Tensor  # (N,)
    cs: torch.Tensor  # (N,) sound speed (broadcast scalar for isothermal)
    # reduced per-particle quantities (all the step loop actually needs)
    mu_max: torch.Tensor  # (N,) max_j mu_ij, for the dt criterion
    div_sum: torch.Tensor  # (N,) sum_j m v_ij . dW_ij (m * divergence term)
    visc_dk: torch.Tensor  # (N,) viscous-heating pair sum for evolve_K
    mu: torch.Tensor  # (N, K) AV mu_ij
    Pi: torch.Tensor  # (N, K) AV Pi_ij
    v_dot_dW: torch.Tensor  # (N, K) v_ij . grad W_ij
    idx: torch.Tensor  # (N, K) neighbor indices (self included)
    self_mask: torch.Tensor  # (N, K) True where idx == own row


def sph_forces(
    pos: torch.Tensor,
    vel: torch.Tensor,
    m,
    K: Optional[torch.Tensor],
    *,
    eos: str,
    gamma,
    cs0,
    alpha,
    beta,
    kh: int,
) -> SphForces:
    """Full hydro force evaluation (HJL.hydrodynamics equivalent,
    polytrope_hydroKDTree.jl:251-292). Runs on the device of `pos`."""
    n = pos.shape[0]
    idx, _ = knn(pos, pos, kh)
    dx = pos[:, 0:1] - pos[:, 0][idx]
    dy = pos[:, 1:2] - pos[:, 1][idx]
    dz = pos[:, 2:3] - pos[:, 2][idx]
    r = torch.sqrt(dx * dx + dy * dy + dz * dz)
    h = torch.max(r, dim=1).values / 2.0
    hcol = h[:, None]
    q = r / hcol

    w = W(q, hcol)
    rho = m * torch.sum(w, dim=1)

    if eos == "polytropic":
        cs = torch.sqrt(gamma * K * rho ** (gamma - 1.0))
        P = K * rho**gamma
    elif eos == "isothermal":
        cs = torch.zeros_like(rho) + cs0
        P = cs0**2 * rho
    else:
        raise ValueError(f"unknown EOS {eos!r}")

    h_avg = 0.5 * (hcol + h[idx])
    rho_avg = 0.5 * (rho[:, None] + rho[idx])
    vij_x = vel[:, 0:1] - vel[:, 0][idx]
    vij_y = vel[:, 1:2] - vel[:, 1][idx]
    vij_z = vel[:, 2:3] - vel[:, 2][idx]
    v_dot_r = vij_x * dx + vij_y * dy + vij_z * dz
    mu = torch.clamp_max(h_avg * v_dot_r / (r * r + 0.01 * h_avg**2), 0.0)
    Pi = (-alpha * cs[:, None] * mu + beta * mu**2) / rho_avg

    dWdr = grad_W_over_r(q, r, hcol)

    p_over_rho2 = P / rho**2
    if eos == "polytropic":
        ct = m * (p_over_rho2[:, None] + p_over_rho2[idx] + Pi) / 2.0
    else:
        ct = m * (p_over_rho2[:, None] + Pi / 2.0)

    self_mask = idx == torch.arange(n, dtype=idx.dtype, device=idx.device)[:, None]
    ct = torch.where(self_mask, torch.zeros_like(ct), ct)

    flat_idx = idx.reshape(-1)
    coeff = ct * dWdr
    acc_axes = []
    for dax in (dx, dy, dz):
        contrib = coeff * dax
        a = -torch.sum(contrib, dim=1)
        acc_axes.append(a.index_add(0, flat_idx, contrib.reshape(-1)))
    acc = torch.stack(acc_axes, dim=1)

    v_dot_dW = v_dot_r * dWdr

    # reductions consumed by the step loop (adaptive dt + evolve_K)
    mu_max = torch.max(mu, dim=1).values
    div_sum = torch.sum(m * v_dot_dW, dim=1)
    ct_k = torch.where(
        self_mask, torch.zeros_like(Pi), m * Pi * v_dot_dW / 2.0
    )
    visc_dk = torch.sum(ct_k, dim=1)
    visc_dk = visc_dk.index_add(0, flat_idx, ct_k.reshape(-1))

    return SphForces(
        acc, rho, h, cs, mu_max, div_sum, visc_dk, mu, Pi, v_dot_dW, idx,
        self_mask,
    )


def evolve_K(
    Kv: torch.Tensor,
    visc_dk: torch.Tensor,
    gamma,
    rho: torch.Tensor,
    dt,
) -> torch.Tensor:
    """Half-step entropy update from viscous heating (evolve_K!,
    polytrope_hydroKDTree.jl:296-341). visc_dk is the symmetrized pair sum
    sum_j m Pi_ij (v_ij . dW_ij)/2 accumulated to both pair members, as
    returned by the force evaluation. Note the reference multiplies by dt/2
    internally and is called once per half step."""
    return Kv + (0.5 * (gamma - 1.0) / rho ** (gamma - 1.0) * visc_dk) * (
        dt / 2.0
    )
