"""Analytic mesh-shape pair terms of the P3M split.

Only the pair terms that the tile engines' phase B needs are here:
`newton_minus_mesh` (the short-range complement the `p3m=True` branch of
kernels/cuda_tile_pairs.py adds) and the `mesh_gphi_over_r` / `mesh_phi`
shapes it is the complement of. The FFT mesh solve itself (Green's
function, CIC deposit, interpolation) is not ported yet.

All quantities are code units, per unit G.
"""

from __future__ import annotations

import math

import torch

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def mesh_gphi_over_r(r: torch.Tensor, sigma) -> torch.Tensor:
    """d(phi_mesh)/dr / r for the Gaussian-smoothed pair interaction
    phi_mesh(r) = -erf(r/(sqrt2 sigma))/r, safe at r = 0 (finite limit
    sqrt(2/pi)/(3 sigma^3))."""
    t = r / sigma
    r_safe = torch.where(r > 0, r, torch.zeros_like(r) + sigma)
    core = torch.erf(t / math.sqrt(2.0)) - _SQRT_2_OVER_PI * t * torch.exp(
        -0.5 * t * t
    )
    val = core / r_safe**3
    # series limit for tiny r (cancellation kills the closed form there)
    lim = torch.zeros_like(r) + _SQRT_2_OVER_PI / (3.0 * sigma**3)
    return torch.where(t > 1e-2, val, lim)


def mesh_phi(r: torch.Tensor, sigma) -> torch.Tensor:
    """phi_mesh(r) = -erf(r/(sqrt2 sigma))/r, safe at r = 0 (limit
    -sqrt(2/pi)/sigma)."""
    t = r / sigma
    r_safe = torch.where(r > 0, r, torch.zeros_like(r) + sigma)
    val = -torch.erf(t / math.sqrt(2.0)) / r_safe
    lim = torch.zeros_like(r) - _SQRT_2_OVER_PI / sigma
    return torch.where(t > 1e-2, val, lim)


# degree-8 fit of erfcx(z) = erfc(z) exp(z^2) in u = z/(1+z), z in [0, 9]
# (max abs err 4.7e-6); lets the tail-correction pass evaluate erfc-class
# kernels with one exp + one divide + a short Horner chain instead of
# erf + exp + divides per pair
_ERFCX_COEFFS = (
    2.3849380332e-01, -9.3397713762e-01, 1.2579923862e+00,
    -8.1740263321e-01, 4.6001262975e-01, 4.3301822784e-02,
    -1.1974394197e-01, -1.1287916483e+00, 1.0000047021e+00,
)


def newton_minus_mesh(d2: torch.Tensor, inv_r: torch.Tensor, sigma):
    """(gphi_over_r, phi) of the SHORT-RANGE complement (Newtonian minus
    mesh shape), the radial h-free tail the tile engine's correction pass
    adds on top of the mesh:

      gphi/r = [erfc(z) + sqrt(2/pi) t exp(-t^2/2)] / r^3
      phi    = -erfc(z)/r                      (z = t/sqrt2, t = r/sigma)

    Evaluated as exp(-z^2) * erfcx-poly — one exp, no erf. Decays like
    exp(-t^2/2). inv_r must be rsqrt(d2) with d2 > 0 masked by the caller;
    at the self slot (d2 = 0) the returned phi is +sqrt(2/pi)/sigma (the
    Newtonian self term is excluded while the mesh's smoothed
    self-interaction must still be cancelled) and the force term is zero.
    """
    t = d2 * inv_r / sigma
    z = t * 0.7071067811865476
    u = z / (1.0 + z)
    p = torch.zeros_like(u) + _ERFCX_COEFFS[0]
    for c in _ERFCX_COEFFS[1:]:
        p = p * u + c
    e = torch.exp(-z * z)
    erfc_z = e * p
    f = erfc_z + 0.7978845608028654 * t * e
    inv_r3 = inv_r * inv_r * inv_r
    zero = torch.zeros_like(d2)
    gphi_over_r = torch.where(d2 > 0, f * inv_r3, zero)
    phi = torch.where(d2 > 0, -erfc_z * inv_r, zero + 0.7978845608028654 / sigma)
    return gphi_over_r, phi
