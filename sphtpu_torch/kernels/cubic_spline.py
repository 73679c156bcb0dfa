"""Cubic-spline SPH kernel W and its gradient, as branchless torch.

Normalization (3D): W(r, h) = 1/(pi h^3) * { 1 - 3/2 q^2 + 3/4 q^3   q <= 1
                                              1/4 (2 - q)^3           1 < q <= 2
                                              0                       q > 2 }
with q = r/h. The reference's polytrope path writes mask2 = !mask1
(no q<=2 upper bound, polytrope_hydroKDTree.jl:158) but q <= 2 always holds
there by construction (h = r_kmax/2), so the explicit q<=2 form used here is
equivalent on the kNN path and also correct for dense/all-pairs use.
"""

from __future__ import annotations

import math

import torch


def W(q: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Kernel value. q: (..., K) ratios r/h; h broadcastable against q
    (typically (..., 1))."""
    ct = 1.0 / (math.pi * h**3)
    w1 = 1.0 - 1.5 * q**2 + 0.75 * q**3
    w2 = 0.25 * (2.0 - q) ** 3
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    return ct * torch.where(q <= 1.0, w1, torch.where(q <= 2.0, w2, zero))


def grad_W_over_r(q: torch.Tensor, r: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(dW/dr)/r, so grad W = result * (dx, dy, dz).

    Matches gradW (polytrope_hydroKDTree.jl:38-73): the q<=1 branch is the
    polynomial ct*(9/4 r/h^2 - 3/h) which is finite at r=0 (no division), so
    self-pairs contribute exactly zero gradient; the outer branch divides by
    r and is guarded against r=0.
    """
    ct = 1.0 / (math.pi * h**4)
    g1 = ct * (2.25 * r / h**2 - 3.0 / h)
    r_safe = torch.where(r > 0.0, r, torch.ones_like(r))
    g2 = ct * (-0.75 * (2.0 - q) ** 2) / r_safe
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    return torch.where(q <= 1.0, g1, torch.where(q <= 2.0, g2, zero))
