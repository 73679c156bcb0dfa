"""Dense O(N^2) reference engine — the in-package numerical oracle.

The reference keeps its first-generation dense engine
(baseline/adiabatic_forces.jl, SURVEY.md C13) alongside the fast path as a
validation ancestor; this module plays the same role here. Every pair is
evaluated with the 3-zone kernel masks (q<=1, 1<q<=2, q>2 — the dense
analogue of adiabatic_forces.jl:211-247) and the antisymmetrized force sum,
with h still defined by the kNN rule. Useful as a drop-in oracle for the
neighbor-list engines at small N.

Not a performance path: O(N^2) memory and time, meant for N up to a few
thousand. The engine and the run loop never call it.
"""

from __future__ import annotations

import torch

from ..kernels import W, grad_W_over_r, softened_gphi_over_r, softened_phi
from ..neighbors import knn
from .sph import SphForces


def dense_forces(
    pos: torch.Tensor,
    vel: torch.Tensor,
    m,
    K,
    *,
    eos: str,
    gamma,
    cs0,
    alpha,
    beta,
    kh: int,
    G=None,
):
    """Fused dense hydro (+ optional direct-sum gravity when G is given).

    Returns (SphForces, phi) where phi is None unless G is provided; the
    hydro acceleration excludes gravity like sph_forces. Mirrors FJL.Accs
    (baseline/adiabatic_forces.jl:320-359) with the parameterized EOS.
    """
    n = pos.shape[0]
    dtype, dev = pos.dtype, pos.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    # h from the kNN rule (baseline also takes h from a kNN pass,
    # adiabatic_forces.jl:325)
    idx, _ = knn(pos, pos, kh)
    d_k = pos[:, None, :] - pos[idx]
    h = torch.max(torch.sqrt(torch.sum(d_k * d_k, dim=-1)), dim=1).values / 2.0

    dx = pos[:, None, 0] - pos[None, :, 0]
    dy = pos[:, None, 1] - pos[None, :, 1]
    dz = pos[:, None, 2] - pos[None, :, 2]
    r = torch.sqrt(dx * dx + dy * dy + dz * dz)
    hcol = h[:, None]
    q = r / hcol

    w = W(q, hcol)
    rho = m * torch.sum(w, dim=1)

    if eos == "polytropic":
        cs = torch.sqrt(gamma * K * rho ** (gamma - 1.0))
        P = K * rho**gamma
    else:
        cs = torch.zeros_like(rho) + cs0
        P = cs0**2 * rho

    h_avg = 0.5 * (hcol + h[None, :])
    rho_avg = 0.5 * (rho[:, None] + rho[None, :])
    vij_x = vel[:, None, 0] - vel[None, :, 0]
    vij_y = vel[:, None, 1] - vel[None, :, 1]
    vij_z = vel[:, None, 2] - vel[None, :, 2]
    v_dot_r = vij_x * dx + vij_y * dy + vij_z * dz
    mu = torch.clamp_max(h_avg * v_dot_r / (r * r + 0.01 * h_avg**2), 0.0)
    Pi = (-alpha * cs[:, None] * mu + beta * mu**2) / rho_avg

    dWdr = grad_W_over_r(q, r, hcol)
    dWx, dWy, dWz = dWdr * dx, dWdr * dy, dWdr * dz

    # antisymmetrized pair force (baseline Acc, adiabatic_forces.jl:303-317)
    por2 = P / rho**2
    ct = por2[:, None] + por2[None, :] + Pi
    ax = -m * torch.sum(ct * (dWx - dWx.T) / 2.0, dim=1)
    ay = -m * torch.sum(ct * (dWy - dWy.T) / 2.0, dim=1)
    az = -m * torch.sum(ct * (dWz - dWz.T) / 2.0, dim=1)
    acc = torch.stack([ax, ay, az], dim=1)

    v_dot_dW = vij_x * dWx + vij_y * dWy + vij_z * dWz
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    ct_k = torch.where(eye, zero, m * Pi * v_dot_dW / 2.0)
    visc_dk = torch.sum(ct_k, dim=1) + torch.sum(ct_k, dim=0)
    mu_max = torch.max(mu, dim=1).values
    div_sum = torch.sum(m * v_dot_dW, dim=1)

    phi = None
    if G is not None:
        gphi = torch.where(eye, zero, softened_gphi_over_r(r, h_avg))
        gx = m * torch.sum(gphi * dx, dim=1)
        gy = m * torch.sum(gphi * dy, dim=1)
        gz = m * torch.sum(gphi * dz, dim=1)
        acc = acc - G * torch.stack([gx, gy, gz], dim=1)
        phi = m * torch.sum(torch.where(eye, zero, softened_phi(r, h_avg)), dim=1) - m * 1.4 / h

    forces = SphForces(
        acc=acc,
        rho=rho,
        h=h,
        cs=cs,
        mu_max=mu_max,
        div_sum=div_sum,
        visc_dk=visc_dk,
        mu=mu,
        Pi=Pi,
        v_dot_dW=v_dot_dW,
        idx=idx,
        self_mask=idx == torch.arange(n, dtype=idx.dtype, device=dev)[:, None],
    )
    return forces, phi
