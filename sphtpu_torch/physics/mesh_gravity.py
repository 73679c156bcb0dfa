"""P3M far-field gravity: FFT particle-mesh + the analytic mesh-shape pair
terms the tile engines' in-tile correction subtracts.

  total = mesh(smoothed, all pairs, via FFT) + near(exact - mesh_shape)

*   Every particle's mass is Gaussian-smoothed (width sigma = sigma_cells
    mesh cells) and deposited on a mesh with CIC weights; one forward real
    FFT, a multiply with the isolated-boundary Green's function, and
    spectral-gradient inverse FFTs give the smoothed potential and force
    fields, interpolated back with the same CIC weights (`p3m_mesh_force`,
    on torch.fft — cuFFT on the card).
*   Isolated (non-periodic) boundaries use the Hockney-Eastwood doubled
    grid: the Green's function is sampled in real space on a >= 2x padded
    grid in cell units (`greens_hat`), so it depends only on the static
    (pad, sigma_cells) and is computed once per chunk runner.
*   Deposit and interpolation share the CIC window and the spectral
    gradient is antisymmetric, so the mesh pair force is antisymmetric and
    total momentum is conserved to rounding.
*   `newton_minus_mesh` is the short-range complement (Newtonian minus
    mesh shape) that the tile engines add per pair inside their stencil
    (kernels/cuda_p3m_tail.py for the mono engine's (2W+1)^3 pass, the
    p3m branch of kernels/cuda_tile_pairs.py for the class engine).

All quantities are code units, per unit G. Returned (g, phi) include the
particle mass m.
"""

from __future__ import annotations

import math

import torch

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def good_fft_size(n: int) -> int:
    """Smallest 5-smooth integer >= n (FFT libraries like {2,3,5} factors)."""
    best = None
    p2 = 1
    while p2 < 8 * n:
        p3 = p2
        while p3 < 8 * n:
            p5 = p3
            while p5 < n:
                p5 *= 5
            if best is None or p5 < best:
                best = p5
            p3 *= 3
        p2 *= 2
    return best


def tail_halfwidth(mesh_factor: int, sigma_cells: float) -> int:
    """P3M tail-correction stencil half-width in tile cells: the smallest W
    with W * s >= 4.4 sigma (sigma = sigma_cells * s / mesh_factor), beyond
    which the Newtonian-minus-mesh complement is ~1e-4."""
    return max(1, math.ceil(4.4 * sigma_cells / mesh_factor - 1e-9))


def _domain_half(pos: torch.Tensor) -> torch.Tensor:
    """Half-edge of the particle bounding cube. The tile engines size their
    grid with this same function, so sigma = s / mesh_factor * sigma_cells
    holds bit for bit between the mesh and the in-tile pair correction."""
    return torch.max(torch.abs(pos)) * (1.0 + 1e-6) + 1e-30


def greens_hat(pad: int, sigma_cells: float, dtype=torch.float32, device=None):
    """rfftn of the isolated-BC smoothed potential kernel, in mesh-cell
    units: K_phi(r) = -erf(r / (sqrt2 sigma)) / r, K_phi(0) = -sqrt(2/pi)/sigma,
    sampled with minimum-image displacements on the padded grid, with the
    CIC window deconvolved twice (deposit + interpolation): dividing by
    What^2 = prod sinc^4(k_i/2) restores the analytic erf shape the
    in-tile correction subtracts (Hockney & Eastwood ch. 8). Physical
    scaling is the single factor 1/a applied at use (a = mesh cell edge).
    Built in `dtype` (complex of that precision out)."""
    ax = torch.arange(pad, device=device)
    ax = torch.where(ax <= pad // 2, ax, ax - pad).to(dtype)
    r = torch.sqrt(
        ax[:, None, None] ** 2 + ax[None, :, None] ** 2 + ax[None, None, :] ** 2
    )
    r_safe = torch.where(r > 0, r, torch.ones_like(r))
    sqrt2 = torch.sqrt(torch.tensor(2.0, dtype=dtype, device=device))
    k = torch.where(
        r > 0,
        -torch.erf(r / (sqrt2 * sigma_cells)) / r_safe,
        -torch.sqrt(torch.tensor(2.0 / math.pi, dtype=dtype, device=device))
        / sigma_cells,
    )
    khat = torch.fft.rfftn(k)

    kf, krf = _kfreqs(pad, dtype, device)

    def sinc2(kk):
        x = kk / 2.0
        x_safe = torch.where(x != 0, x, torch.ones_like(x))
        return torch.where(x != 0, (torch.sin(x_safe) / x_safe) ** 2, torch.ones_like(x))

    w2 = (
        sinc2(kf)[:, None, None]
        * sinc2(kf)[None, :, None]
        * sinc2(krf)[None, None, :]
    )
    return khat / (w2 * w2)


def _kfreqs(pad: int, dtype, device):
    """Angular frequencies of the full and the real (last) FFT axis, in
    cell units, rounded once from float64 into `dtype`."""
    kf = (2.0 * math.pi) * torch.fft.fftfreq(pad, dtype=torch.float64).to(
        device=device, dtype=dtype
    )
    krf = (2.0 * math.pi) * torch.fft.rfftfreq(pad, dtype=torch.float64).to(
        device=device, dtype=dtype
    )
    return kf, krf


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


def _cic(pos: torch.Tensor, half, a, pad: int):
    """CIC cell indices and weights: (idx (N,8) flat int64 into the padded
    pad^3 grid, w (N,8)). Mesh cell centers sit at (i+0.5-1) a - half (one
    ghost cell of offset keeps all 8 deposit corners in range without
    wrapping)."""
    u = (pos + half) / a - 0.5 + 1.0  # +1: ghost-cell offset
    i0 = torch.floor(u).to(torch.int64)
    f = (u - i0).to(pos.dtype)
    idx_list = []
    w_list = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                iz = i0[:, 2] + dz
                iy = i0[:, 1] + dy
                ix = i0[:, 0] + dx
                idx_list.append((iz * pad + iy) * pad + ix)
                wz = f[:, 2] if dz else 1.0 - f[:, 2]
                wy = f[:, 1] if dy else 1.0 - f[:, 1]
                wx = f[:, 0] if dx else 1.0 - f[:, 0]
                w_list.append(wz * wy * wx)
    return torch.stack(idx_list, dim=1), torch.stack(w_list, dim=1)


def p3m_mesh_force(pos: torch.Tensor, m, greens_hat: torch.Tensor, *, gm: int, pad: int):
    """Smoothed-interaction (g, phi) at every particle from the mesh.

    gm: live mesh cells per edge (mesh_factor * tile grid); pad: padded FFT
    edge (>= 2*(gm+2), from good_fft_size). greens_hat: `greens_hat(pad,
    sigma_cells, dtype)` on pos's device. Self-interaction is included
    (the in-tile correction subtracts its analytic value). Returns g (N,3)
    with g_i = grad phi_mesh(x_i), phi (N,), both including the source
    mass m (per unit G)."""
    half = _domain_half(pos)
    rho, idx, w, a = mesh_deposit(pos, m, half, gm=gm, pad=pad)
    return mesh_solve(rho, idx, w, a, greens_hat, pad=pad, dtype=pos.dtype)


def mesh_deposit(pos: torch.Tensor, w_mass, half, *, gm: int, pad: int):
    """CIC deposit of masses w_mass (a scalar or one a row) on the padded
    mesh of the domain [-half, half]^3: (rho (pad^3,), idx, w, a), the last
    three for `mesh_solve`'s interpolation at the same rows. The sharded
    engines deposit each shard's rows and sum the meshes."""
    a = 2.0 * half / gm
    idx, w = _cic(pos, half, a, pad)
    if isinstance(w_mass, torch.Tensor) and w_mass.dim() == 1:
        w_mass = w_mass[:, None]
    rho = torch.zeros((pad * pad * pad,), dtype=pos.dtype, device=pos.device)
    rho.index_add_(0, idx.reshape(-1), (w_mass * w).reshape(-1))
    return rho, idx, w, a


def mesh_solve(rho, idx, w, a, greens_hat: torch.Tensor, *, pad: int, dtype):
    """The mesh potential and its spectral gradient from the deposited
    rho, interpolated at the rows of (idx, w): (g (rows, 3), phi (rows,))."""
    rho_hat = torch.fft.rfftn(rho.reshape(pad, pad, pad))
    phi_hat = rho_hat * greens_hat  # cell-unit kernel; 1/a applied below

    # spectral gradient: k in cell units (the extra 1/a folds into scale)
    kfreq, krfreq = _kfreqs(pad, dtype, rho.device)
    kz = kfreq[:, None, None]
    ky = kfreq[None, :, None]
    kx = krfreq[None, None, :]

    shape = (pad, pad, pad)
    phi_grid = torch.fft.irfftn(phi_hat, s=shape).reshape(-1)
    gx_grid = torch.fft.irfftn(1j * kx * phi_hat, s=shape).reshape(-1)
    gy_grid = torch.fft.irfftn(1j * ky * phi_hat, s=shape).reshape(-1)
    gz_grid = torch.fft.irfftn(1j * kz * phi_hat, s=shape).reshape(-1)

    def interp(grid):
        return torch.sum(grid[idx] * w, dim=1)

    inv_a = 1.0 / a
    phi = interp(phi_grid) * inv_a
    g = torch.stack([interp(gx_grid), interp(gy_grid), interp(gz_grid)], dim=1) * (
        inv_a * inv_a
    )
    return g.to(dtype), phi.to(dtype)
