"""Softened point-mass gravity kernels (cubic-spline softened potential).

The reference's piecewise forms live in GJL.Kernels
(gravOctree_Single.jl:5-29). With q = r/h:

  q <= 1 : gphi/r = (1/h^2)(4/3/h - 6/5 r^2/h^3 + 1/2 r^3/h^4)
  1<q<=2 : gphi/r = (1/h^2)(8/3 q - 3q^2 + 6/5 q^3 - 1/6 q^4 - 1/15 q^-2)/r
  q > 2  : gphi/r = 1/r^3                       (plain Newtonian)

  phi(q<=1)  = (1/h)(2/3 q^2 - 3/10 q^4 + 1/10 q^5 - 7/5)
  phi(1<q<=2)= (1/h)(4/3 q^2 - q^3 + 3/10 q^4 - 1/30 q^5 - 8/5 + 1/15/q)
  phi(q>2)   = -1/r

Acceleration on particle i from mass m at separation d = x_i - x_j is
``a_i = -G m (gphi/r) d`` (the step applies the -G factor,
polytrope_sim.jl:43-45).
"""

from __future__ import annotations

import torch


def softened_gphi_over_r(r: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """gphi/r such that grad phi = result * (dx, dy, dz).

    Safe at r == 0 (returns the finite q<=1 polynomial limit, which
    multiplies a zero separation vector anyway).
    """
    q = r / h
    inner = (1.0 / h**2) * (
        4.0 / 3.0 / h - 1.2 * (r**2 / h**3) + 0.5 * (r**3 / h**4)
    )
    r_safe = torch.where(r > 0.0, r, torch.ones_like(r))
    q_safe = torch.where(q > 0.0, q, torch.ones_like(q))
    mid = (
        (1.0 / h**2)
        * (
            8.0 / 3.0 * q
            - 3.0 * q**2
            + 1.2 * q**3
            - q**4 / 6.0
            - 1.0 / 15.0 / q_safe**2
        )
        / r_safe
    )
    outer = 1.0 / r_safe**3
    return torch.where(q <= 1.0, inner, torch.where(q <= 2.0, mid, outer))


def softened_phi(r: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Softened potential phi(r; h) (per unit G and source mass)."""
    q = r / h
    inner = (1.0 / h) * (
        2.0 / 3.0 * q**2 - 0.3 * q**4 + 0.1 * q**5 - 1.4
    )
    q_safe = torch.where(q > 0.0, q, torch.ones_like(q))
    mid = (1.0 / h) * (
        4.0 / 3.0 * q**2
        - q**3
        + 0.3 * q**4
        - q**5 / 30.0
        - 1.6
        + 1.0 / 15.0 / q_safe
    )
    r_safe = torch.where(r > 0.0, r, torch.ones_like(r))
    outer = -1.0 / r_safe
    return torch.where(q <= 1.0, inner, torch.where(q <= 2.0, mid, outer))
