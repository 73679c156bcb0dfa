"""The 8 initial-condition generators.

Same sampling semantics as the reference suite (fastv1_kd&single_oc/
iniconds.jl:16-525), re-implemented as vectorized host-side numpy/scipy
float64 (setup-time code, never jitted). Each generator cites the reference
lines it mirrors. RNG streams differ from Julia's MersenneTwister — the
distributions, not the bits, are the contract.
"""

from __future__ import annotations

import numpy as np
from scipy.integrate import solve_ivp

from ..constants import G_CGS


def _isotropic_directions(rng: np.random.Generator, n: int):
    """theta = acos(2u-1), phi = 2 pi u — the reference's angular sampling."""
    theta = np.arccos(2.0 * rng.random(n) - 1.0)
    phi = 2.0 * np.pi * rng.random(n)
    st = np.sin(theta)
    return np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)], axis=1)


def _uniform_sphere(rng: np.random.Generator, n: int, radius: float) -> np.ndarray:
    """Rejection-sample n points uniformly in a ball (iniconds.jl:204-214)."""
    out = np.empty((n, 3))
    filled = 0
    while filled < n:
        batch = max(2 * (n - filled), 128)
        cand = 2.0 * radius * (rng.random((batch, 3)) - 0.5)
        keep = cand[np.linalg.norm(cand, axis=1) <= radius]
        take = min(len(keep), n - filled)
        out[filled : filled + take] = keep[:take]
        filled += take
    return out


def sample_isothermal_sphere(N: int, R: float, cs: float, rng: np.random.Generator):
    """Gaussian-density sphere with Maxwell-Boltzmann velocities
    (iniconds.jl:16-40)."""
    sigma = R / 3.0
    radii = np.clip(np.abs(sigma * rng.standard_normal(N)), 0.0, R)
    pos = radii[:, None] * _isotropic_directions(rng, N)
    vel = cs * rng.standard_normal((N, 3))
    return pos, vel


def sample_plummer_sphere(N: int, M: float, a: float, rng: np.random.Generator):
    """Plummer model: inverse-CDF radii + rejection-sampled velocities
    (iniconds.jl:42-95)."""
    xi = rng.random(N)
    r = a * (xi ** (-2.0 / 3.0) - 1.0) ** (-0.5)
    pos = r[:, None] * _isotropic_directions(rng, N)

    psi = -G_CGS * M / np.sqrt(r**2 + a**2)
    v_esc = np.sqrt(-2.0 * psi)
    v = np.empty(N)
    pending = np.arange(N)
    while pending.size:
        x1 = rng.random(pending.size)
        x2 = rng.random(pending.size)
        vcand = x1**2 * v_esc[pending]
        g = vcand**2 * (1.0 - vcand**2 / v_esc[pending] ** 2) ** 3.5
        ok = 0.1 * x2 < g
        v[pending[ok]] = vcand[ok]
        pending = pending[~ok]
    vel = v[:, None] * _isotropic_directions(rng, N)
    return pos, vel


def _lane_emden_isothermal(xi_max: float):
    """Isothermal Lane-Emden psi(xi) on a dense grid (iniconds.jl:110-125)."""

    def rhs(xi, y):
        return [y[1], -2.0 / xi * y[1] + np.exp(-y[0])]

    xs = np.linspace(1e-8, xi_max, 4096)
    sol = solve_ivp(
        rhs, (1e-8, xi_max), [0.0, 0.0], t_eval=xs, rtol=1e-8, atol=1e-8
    )
    return sol.t, sol.y[0]


def bonnor_ebert_sphere(
    N: int,
    cs: float,
    rho_c: float,
    xi_max: float,
    *,
    velocity_mode: str = "none",
    mach_number: float = 1.0,
    alpha_vir: float = 1.0,
    rng: np.random.Generator,
):
    """Bonnor-Ebert sphere from the isothermal Lane-Emden solution with
    :none/:mach/:virial velocity presets (iniconds.jl:98-194)."""
    xs, psi = _lane_emden_isothermal(xi_max)
    a = cs / np.sqrt(4.0 * np.pi * G_CGS * rho_c)

    # Cumulative mass M(xi) = 4 pi a^3 rho_c Int xi^2 exp(-psi) dxi
    # (iniconds.jl:131-135); inverse-CDF sampling replaces the reference's
    # 40-iteration bisection-per-particle with interpolation on the same
    # monotone profile.
    integrand = xs**2 * np.exp(-psi)
    m_cum = 4.0 * np.pi * a**3 * rho_c * _cumtrapz(integrand, xs)
    m_tot = m_cum[-1]
    y = rng.random(N) * m_tot
    xi_samples = np.interp(y, m_cum, xs)
    r_samples = a * xi_samples

    pos = r_samples[:, None] * _isotropic_directions(rng, N)
    vel = np.zeros((N, 3))

    if velocity_mode == "mach":
        vel = rng.standard_normal((N, 3)) * (mach_number * cs / np.sqrt(3.0))
        vel -= vel.mean(axis=0)
    elif velocity_mode == "virial":
        vel = rng.standard_normal((N, 3))
        m_part = m_tot / N
        cur_ekin = 0.5 * m_part * np.sum(vel**2)
        r_eff = np.linalg.norm(pos, axis=1).max()
        egrav_est = -(3.0 / 5.0) * G_CGS * m_tot**2 / r_eff
        desired = 0.5 * alpha_vir * abs(egrav_est)
        vel *= np.sqrt(desired / cur_ekin)
        vel -= vel.mean(axis=0)
    elif velocity_mode != "none":
        raise ValueError("velocity_mode must be none, mach, or virial")

    return pos, vel


def _cumtrapz(y, x):
    out = np.zeros_like(y)
    out[1:] = np.cumsum(0.5 * (y[1:] + y[:-1]) * np.diff(x))
    return out


def turbulent_molecular_cloud(
    N: int,
    R_cloud: float,
    M_cloud: float,
    spectrum: str,
    cs: float,
    seed: int,
):
    """Uniform sphere + k-space turbulent velocity field on a 32^3 grid
    (iniconds.jl:198-282). spectrum: "burgers" (k^-2) or kolmogorov (k^-11/3).
    Returns (pos, vel, rho_vec)."""
    rng = np.random.default_rng(seed)
    rho_cloud = M_cloud / ((4.0 / 3.0) * np.pi * R_cloud**3)
    pos = _uniform_sphere(rng, N, R_cloud)

    grid = 32
    box = 2.0 * R_cloud
    power = -2.0 if spectrum == "burgers" else -11.0 / 3.0

    # Per-mode random amplitude ~ randn * |k|^power with a random direction
    # (iniconds.jl:228-248). The reference loops i,j,k in column-major order
    # drawing randn/rand per mode; we draw the same quantities vectorized.
    k1 = np.arange(1, grid + 1)
    kshift = np.where(k1 <= grid // 2, k1, k1 - grid).astype(np.float64)
    kx, ky, kz = np.meshgrid(kshift, kshift, kshift, indexing="ij")
    kmag = np.sqrt(kx**2 + ky**2 + kz**2)
    nonzero = kmag > 0

    amp = np.zeros((grid, grid, grid))
    amp[nonzero] = rng.standard_normal(nonzero.sum()) * kmag[nonzero] ** power
    phase = 2.0 * np.pi * rng.random((grid, grid, grid))
    direction = rng.standard_normal((grid, grid, grid, 3))
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    field = (amp * np.cos(phase))[..., None] * direction
    field[~nonzero] = 0.0

    # Trilinear interpolation of the grid field at particle positions
    # (iniconds.jl:250-276), grid cell size dx = box/grid.
    dx = box / grid
    f = (pos + R_cloud) / dx
    i0 = np.clip(np.floor(f).astype(int), 0, grid - 2)
    w = f - i0
    vel = np.zeros((N, 3))
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                wgt = (
                    (w[:, 0] if cx else 1 - w[:, 0])
                    * (w[:, 1] if cy else 1 - w[:, 1])
                    * (w[:, 2] if cz else 1 - w[:, 2])
                )
                vel += wgt[:, None] * field[i0[:, 0] + cx, i0[:, 1] + cy, i0[:, 2] + cz]

    vel -= vel.mean(axis=0)
    speeds = np.linalg.norm(vel, axis=1)
    vel *= cs / np.std(speeds)
    return pos, vel, np.full(N, rho_cloud)


def rotating_cloud(
    N: int,
    *,
    Mtot: float = 1.99e33,
    Rcloud: float = 3e17,
    rho_c: float = 1e-18,
    Omega_frac: float = 0.5,
    add_turbulence: bool = False,
    turb_frac: float = 0.1,
    rng: np.random.Generator,
):
    """Plummer-like rejection-sampled cloud with solid-ish rotation about z
    (iniconds.jl:285-340)."""
    r0 = Rcloud / 3.0
    r = np.empty(N)
    pending = N
    filled = 0
    while pending:
        batch = max(2 * pending, 128)
        cand = Rcloud * rng.random(batch) ** (1.0 / 3.0)
        rho = rho_c / (1.0 + (cand / r0) ** 2) ** 2.5
        keep = cand[rng.random(batch) < rho / rho_c]
        take = min(len(keep), pending)
        r[filled : filled + take] = keep[:take]
        filled += take
        pending -= take

    pos = r[:, None] * _isotropic_directions(rng, N)
    x, y = pos[:, 0], pos[:, 1]
    R_cyl = np.sqrt(x**2 + y**2)
    v_circ = np.sqrt(G_CGS * Mtot * R_cyl / Rcloud**3)
    v_rot = Omega_frac * v_circ
    with np.errstate(divide="ignore", invalid="ignore"):
        vx = -v_rot * y / R_cyl
        vy = v_rot * x / R_cyl
    vx = np.nan_to_num(vx)
    vy = np.nan_to_num(vy)
    vel = np.stack([vx, vy, np.zeros(N)], axis=1)

    if add_turbulence:
        rms = turb_frac * np.mean(np.linalg.norm(vel, axis=1))
        vel += rms * rng.standard_normal((N, 3)) / np.sqrt(3.0)
    return pos, vel


def polytropic_sphere(
    N: int, n: float, K: float, rho_c: float, xi_max: float, rng: np.random.Generator
):
    """Index-n polytrope from the Lane-Emden equation, mass-profile sampled
    (iniconds.jl:342-415). Returns (pos, vel, Mtot).

    Deviation (documented): theta is clamped at 0 past its first zero, where
    the reference evaluates theta^n on (possibly negative) raw values
    (iniconds.jl:369); for the default n=3, xi_max=7.5 the mass difference
    is negligible and clamping avoids NaNs for non-integer n.
    """

    def rhs(xi, y):
        return [y[1], -2.0 / xi * y[1] - np.sign(y[0]) * np.abs(y[0]) ** n]

    xs = np.linspace(1e-8, xi_max, 4096)
    sol = solve_ivp(rhs, (1e-8, xi_max), [1.0, 0.0], t_eval=xs, rtol=1e-8, atol=1e-10)
    theta = np.clip(sol.y[0], 0.0, None)

    a = np.sqrt((n + 1.0) * K / (4.0 * np.pi * G_CGS) * rho_c ** (1.0 / n - 1.0))
    integrand = xs**2 * theta**n
    m_cum = 4.0 * np.pi * a**3 * rho_c * _cumtrapz(integrand, xs)
    m_tot = m_cum[-1]

    y = rng.random(N) * m_tot
    # m_cum plateaus past the first zero of theta; keep the inverse CDF
    # well-defined by interpolating on the strictly increasing prefix.
    inc = np.concatenate([[True], np.diff(m_cum) > 0])
    xi_samples = np.interp(y, m_cum[inc], xs[inc])
    r_samples = a * xi_samples

    pos = r_samples[:, None] * _isotropic_directions(rng, N)
    vel = np.zeros((N, 3))
    return pos, vel, m_tot


def gaussian_sphere(
    N: int,
    R: float,
    *,
    axis=None,
    Omega_frac: float = 0.0,
    rng: np.random.Generator,
):
    """Gaussian blob with optional solid-body rotation about an arbitrary
    axis (iniconds.jl:418-454)."""
    pos = rng.standard_normal((N, 3)) * R
    pos -= pos.mean(axis=0)
    vel = np.zeros((N, 3))
    if axis is not None and Omega_frac != 0.0:
        ax = np.asarray(axis, dtype=np.float64)
        ax = ax / np.linalg.norm(ax)
        vel = Omega_frac * np.cross(np.broadcast_to(ax, pos.shape), pos)
    return pos, vel


def boss_bodenheimer(
    N: int,
    R_cloud: float,
    M_cloud: float,
    *,
    A: float = 0.1,
    beta: float = 0.26,
    rng: np.random.Generator,
):
    """Boss-Bodenheimer test: uniform sphere + m=2 azimuthal perturbation
    (Newton solve) + beta-parameterized solid-body rotation
    (iniconds.jl:457-525). Returns (pos, vel, rho_vec)."""
    rho_cloud = M_cloud / ((4.0 / 3.0) * np.pi * R_cloud**3)
    pos = _uniform_sphere(rng, N, R_cloud)
    pos -= pos.mean(axis=0)

    # Invert phi = (phi* + A sin 2 phi*)/2 by Newton iteration
    # (iniconds.jl:484-506).
    phi = np.arctan2(pos[:, 1], pos[:, 0])
    r_xy = np.sqrt(pos[:, 0] ** 2 + pos[:, 1] ** 2)
    phis = phi.copy()
    for _ in range(50):
        f = (phis + A * np.sin(2.0 * phis)) / 2.0 - phi
        fp = (1.0 + 2.0 * A * np.cos(2.0 * phis)) / 2.0
        step = f / fp
        phis = phis - step
        if np.max(np.abs(step)) < 1e-12:
            break
    pos[:, 0] = r_xy * np.cos(phis)
    pos[:, 1] = r_xy * np.sin(phis)

    inertia = 0.4 * M_cloud * R_cloud**2
    egrav = -3.0 / 5.0 * G_CGS * M_cloud**2 / R_cloud
    erot = beta * abs(egrav)
    omega = np.sqrt(2.0 * erot / inertia)
    vel = np.stack([-omega * pos[:, 1], omega * pos[:, 0], np.zeros(N)], axis=1)
    vel -= vel.mean(axis=0)
    return pos, vel, np.full(N, rho_cloud)
