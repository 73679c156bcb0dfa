"""Scene setup: defaults table, derived constants, generator dispatch.

Mirrors INICONDS.iniconds_setup (fastv1_kd&single_oc/iniconds.jl:528-696):
merge kwargs over defaults, derive gas constants, dispatch to a generator,
compute per-particle entropy K where the EOS needs it, and write snapshot
"1" through the CSV codec. All host-side float64 CGS.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from .. import constants as C
from ..io import write_snapshot
from . import generators as gen

# Defaults table (iniconds.jl:536-566). :rng => MersenneTwister(42) becomes
# an integer seed; "axis" may be a list like [1,0,0].
DEFAULTS = {
    "N": 10000,
    "R": 2.0 * C.R0_PC,
    "Kh": 50,
    # Kgr is the reference's octree leaf/bucket size (iniconds.jl:539); our
    # gravity has no octree (blocked sweep / P3M), so nothing consumes it.
    # It stays in DEFAULTS and the constants row purely for snapshot
    # format compatibility (a reference run restarted here round-trips).
    "Kgr": 20,
    "t": 0,
    "tEnd": 5e12,
    "alpha": 1.0,
    "beta": 2.0,
    "G": C.G_CGS,
    "theta": 0.576,
    "M": 1 * C.M0_SUN,
    "rho_c": 150.0,
    "xi_max": 7.5,
    "Omega_frac": 0.5,
    "gamma": 5.0 / 3.0,
    "mu": 0.61,
    "T": 15_000_000,
    "a": 0.01,  # Plummer scale radius
    "velocity_mode": "virial",  # Bonnor-Ebert
    "mach_number": 1.0,
    "alpha_vir": 1.0,
    "rng": 42,
    "spectrum": "burgers",  # Turbulent cloud
    "add_turbulence": False,  # Rotating cloud
    "turb_frac": 0.1,
    "n": 3.0,  # Polytropic index
    "axis": None,
    "beta_rot": 0.26,  # iniconds.jl uses :β
    "A": 0.1,
    "K": None,  # polytropic_sphere entropy constant (required there)
}

# Unicode kwarg names the reference accepts (e.g. --kwargs "Ω_frac=0.25").
KWARG_ALIASES = {
    "Ω_frac": "Omega_frac",
    "ξ_max": "xi_max",
    "β": "beta_rot",
}

IC_TYPES = (
    "sample_isothermal_sphere",
    "sample_plummer_sphere",
    "bonnor_ebert_sphere",
    "turbulent_molecular_cloud",
    "rotating_cloud",
    "polytropic_sphere",
    "gaussian_sphere",
    "boss_bodenheimer",
)


def host_density_at(m: float, rr: np.ndarray, pos: np.ndarray, Kh: int) -> np.ndarray:
    """Host-side float64 SPH density at sample points rr against particle
    set pos — this module's equivalent of HJL.density_plot
    (polytrope_hydroKDTree.jl:344-350): kNN of the samples, h = (distance to
    the Kh-th neighbor)/2, cubic-spline sum.

    CGS magnitudes (W ~ 1/h^3 ~ 1e-48) require float64, hence scipy on host
    rather than the device engine.
    """
    tree = cKDTree(pos)
    r, _ = tree.query(rr, k=Kh)
    r = np.atleast_2d(r)
    h = r[:, -1] / 2.0
    q = r / h[:, None]
    ct = 1.0 / (np.pi * h**3)
    w = np.where(
        q <= 1.0,
        1.0 - 1.5 * q**2 + 0.75 * q**3,
        np.where(q <= 2.0, 0.25 * (2.0 - q) ** 3, 0.0),
    ) * ct[:, None]
    return m * w.sum(axis=1)


def iniconds_setup(EOS: str, ic_type: str, root: str = ".", **kwargs) -> str:
    """Generate initial conditions and write snapshot "1"; returns the path.

    EOS: "isothermal" | "polytropic"; ic_type: one of IC_TYPES.
    kwargs merge over DEFAULTS (iniconds.jl:569).
    """
    for uni, ascii_name in KWARG_ALIASES.items():
        if uni in kwargs:
            kwargs[ascii_name] = kwargs.pop(uni)
    unknown = set(kwargs) - set(DEFAULTS)
    if unknown:
        raise ValueError(f"Unknown kwargs for {ic_type}: {sorted(unknown)}")
    p = {**DEFAULTS, **kwargs}
    N = int(p["N"])
    rng = np.random.default_rng(int(p["rng"]))

    # Derived quantities (iniconds.jl:576-578)
    cs = np.sqrt(C.KB * p["T"] / (p["mu"] * C.MH))
    m = p["M"] / N
    U = 1.5 * p["M"] * cs**2

    K = None
    if ic_type == "sample_isothermal_sphere":
        pos, vel = gen.sample_isothermal_sphere(N, float(p["R"]), cs, rng)
    elif ic_type == "sample_plummer_sphere":
        pos, vel = gen.sample_plummer_sphere(N, float(p["M"]), float(p["a"]), rng)
    elif ic_type == "bonnor_ebert_sphere":
        pos, vel = gen.bonnor_ebert_sphere(
            N,
            cs,
            float(p["rho_c"]),
            float(p["xi_max"]),
            velocity_mode=str(p["velocity_mode"]).lstrip(":"),
            mach_number=float(p["mach_number"]),
            alpha_vir=float(p["alpha_vir"]),
            rng=rng,
        )
    elif ic_type == "turbulent_molecular_cloud":
        pos, vel, rho_vec = gen.turbulent_molecular_cloud(
            N, float(p["R"]), float(p["M"]), str(p["spectrum"]), cs, int(p["rng"])
        )
        # K = cs^2/gamma * rho^(1-gamma) (iniconds.jl:611)
        K = cs**2 / p["gamma"] * rho_vec ** (1.0 - p["gamma"])
    elif ic_type == "rotating_cloud":
        pos, vel = gen.rotating_cloud(
            N,
            Mtot=float(p["M"]),
            Rcloud=float(p["R"]),
            rho_c=float(p["rho_c"]),
            Omega_frac=float(p["Omega_frac"]),
            add_turbulence=bool(p["add_turbulence"]),
            turb_frac=float(p["turb_frac"]),
            rng=rng,
        )
        # K from T at central density (iniconds.jl:624)
        K = np.full(
            N, C.KB * p["T"] / (p["mu"] * C.MH * p["rho_c"] ** (p["gamma"] - 1.0))
        )
    elif ic_type == "polytropic_sphere":
        if p["K"] is None:
            raise ValueError(
                "Missing required arguments for polytropic_sphere: [:K]"
            )  # mirrors check_args (iniconds.jl:627)
        K_scalar = float(p["K"])
        pos, vel, M_actual = gen.polytropic_sphere(
            N, float(p["n"]), K_scalar, float(p["rho_c"]), float(p["xi_max"]), rng
        )
        K = np.full(N, K_scalar)
        m = M_actual / N
        p["M"] = M_actual
    elif ic_type == "gaussian_sphere":
        axis = p["axis"]
        pos, vel = gen.gaussian_sphere(
            N, float(p["R"]), axis=axis, Omega_frac=float(p["Omega_frac"]), rng=rng
        )
        r_com = pos.mean(axis=0, keepdims=True)
        # Central density measured through the hydro layer (iniconds.jl:637)
        rho0 = host_density_at(m, r_com, pos, int(p["Kh"]))[0]
        K = np.full(N, C.KB * p["T"] / (p["mu"] * C.MH * rho0 ** (p["gamma"] - 1.0)))
    elif ic_type == "boss_bodenheimer":
        pos, vel, rho_vec = gen.boss_bodenheimer(
            N,
            float(p["R"]),
            float(p["M"]),
            A=float(p["A"]),
            beta=float(p["beta_rot"]),
            rng=rng,
        )
        K = np.full(
            N, C.KB * p["T"] / (p["mu"] * C.MH * rho_vec[0] ** (p["gamma"] - 1.0))
        )
    else:
        raise ValueError(f"Invalid ic_type: {ic_type}")

    # R_max from COM (iniconds.jl:650-651)
    r_com = pos.mean(axis=0)
    R_max = float(np.linalg.norm(pos - r_com, axis=1).max())

    base = {
        "iterID": 1,
        "N": N,
        "Kh": int(p["Kh"]),
        "Kgr": int(p["Kgr"]),
        "t": p["t"],
        "tEnd": p["tEnd"],
        "M": p["M"],
        "R": R_max,
        "alpha": p["alpha"],
        "beta": p["beta"],
        "G": p["G"],
        "theta": p["theta"],
        "m": m,
    }
    if EOS == "isothermal":
        consts = {**base, "cs": cs, "U": U}
        path = write_snapshot("1", ic_type, pos, vel, constants=consts, root=root)
        print(f"Initial conditions for an isothermal {ic_type} have been produced.")
    elif EOS == "polytropic":
        if K is None:
            # ICs with no natural K (e.g. sample_plummer_sphere) fall back to
            # the T-based entropy at the measured central density, keeping the
            # polytropic engine runnable on any generator.
            r_com2 = pos.mean(axis=0, keepdims=True)
            rho0 = host_density_at(m, r_com2, pos, int(p["Kh"]))[0]
            K = np.full(
                N, C.KB * p["T"] / (p["mu"] * C.MH * rho0 ** (p["gamma"] - 1.0))
            )
        consts = {**base, "gamma": p["gamma"]}
        path = write_snapshot("1", ic_type, pos, vel, K=K, constants=consts, root=root)
        print(f"Initial conditions for a polytropic {ic_type} have been produced.")
    else:
        raise ValueError(
            f"Invalid EOS: {EOS}. Available options: 'isothermal' or 'polytropic'"
        )
    return path
