"""A Boss-Bodenheimer cloud at t = 0, turned by the run's seed.

The cloud is generated from the configuration's own generator seed (`rng`,
the CLI's default 42), and the run's seed permutes and rotates it
(`scenes.turned`): a cloud drawn from each run's seed would be planned on
another grid and capacity for about a third of the seeds (grid 18-20, cap
128-192 at N = 200 000), which changes the work of a request by up to 2x.
Since the run's seed only turns it, the cloud can be made once and committed:

    python3 -m benchmark.scenes.generated_cloud <config.json> <state.npz>

writes the unturned cloud in the form `npz_state` reads (pos, vel and K in
float32, as the benchmark hands them to both sides; h, the planning h, in
float64; t; m), so that a run loads it instead of generating it.

A frozen numpy copy of the scene the CLI's `--generate --EOS polytropic
--ic_type boss_bodenheimer --kwargs N=<N>` writes (the generator of
iniconds.jl:457-525 and the setup of iniconds.jl:528-696: uniform sphere,
m = 2 azimuthal perturbation by Newton solve, solid-body rotation with
beta = 0.26, K from T at the cloud density, R = the largest radius from the
centre of mass), put into the run loop's code units (G = 1, unit length R,
unit mass M), and the run loop's bootstrap of h (the Kh-th neighbour's
distance over 2, from a KD-tree). No snapshot file is written or read.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.spatial import cKDTree

from . import Scene, turned

# CGS constants of the reference (iniconds.jl:532-573)
G_CGS = 6.67430e-8
R0_PC = 5.38552341e16
M0_SUN = 1.9891e33
KB = 1.380649e-16
MH = 1.6735575e-24


def uniform_sphere(rng: np.random.Generator, n: int, radius: float) -> np.ndarray:
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


def boss_bodenheimer(n: int, r_cloud: float, m_cloud: float, *, A: float, beta: float,
                     rng: np.random.Generator):
    """(pos, vel, rho) in CGS (iniconds.jl:457-525)."""
    rho_cloud = m_cloud / ((4.0 / 3.0) * np.pi * r_cloud**3)
    pos = uniform_sphere(rng, n, r_cloud)
    pos -= pos.mean(axis=0)
    # invert phi = (phi* + A sin 2 phi*) / 2 by Newton iteration
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
    inertia = 0.4 * m_cloud * r_cloud**2
    egrav = -3.0 / 5.0 * G_CGS * m_cloud**2 / r_cloud
    omega = np.sqrt(2.0 * beta * abs(egrav) / inertia)
    vel = np.stack([-omega * pos[:, 1], omega * pos[:, 0], np.zeros(n)], axis=1)
    vel -= vel.mean(axis=0)
    return pos, vel, np.full(n, rho_cloud)


def kh_bootstrap_h(pos: np.ndarray, kh: int) -> np.ndarray:
    """The run loop's h before its first evaluation: the Kh-th neighbour's
    distance (self included) over 2."""
    d, _ = cKDTree(pos).query(pos, k=kh, workers=-1)
    return d[:, -1] / 2.0


def cloud(config: dict) -> Scene:
    """The cloud of `config` (keys rng, N, Kh, R_pc, M_sun, T, mu, gamma,
    A, beta_rot, tEnd) in code units, as generated."""
    n, kh, gamma = int(config["N"]), int(config["Kh"]), float(config["gamma"])
    r_cgs = float(config["R_pc"]) * R0_PC
    m_cgs = float(config["M_sun"]) * M0_SUN
    pos, vel, rho = boss_bodenheimer(n, r_cgs, m_cgs, A=float(config["A"]),
                                     beta=float(config["beta_rot"]),
                                     rng=np.random.default_rng(int(config["rng"])))
    k_cgs = KB * float(config["T"]) / (float(config["mu"]) * MH * rho[0] ** (gamma - 1.0))
    # the run loop's unit system: L = R_max about the centre of mass, M, G = 1
    r_max = float(np.linalg.norm(pos - pos.mean(axis=0), axis=1).max())
    unit_t = math.sqrt(r_max**3 / (G_CGS * m_cgs))
    unit_v = r_max / unit_t
    unit_k = (m_cgs / (r_max * unit_t**2)) / (m_cgs / r_max**3) ** gamma
    pos_code = pos / r_max
    return Scene(
        pos=pos_code,
        vel=vel / unit_v,
        K=np.full(n, k_cgs / unit_k),
        t=0.0,
        m=1.0 / n,
        t_end=float(config["tEnd"]) / unit_t,
        h=kh_bootstrap_h(pos_code, kh),
    )


def make(config: dict, seed: int, root: str) -> Scene:
    """The cloud of `config`, turned by `seed`."""
    return turned(cloud(config), seed)


def write_state(config: dict, path: str) -> Scene:
    """Writes the cloud of `config` to `path` in `npz_state`'s form."""
    s = cloud(config)
    f32 = np.float32
    np.savez_compressed(path, pos=s.pos.astype(f32), vel=s.vel.astype(f32), K=s.K.astype(f32),
                        h=s.h, t=np.float64(s.t), m=np.float64(s.m))
    return s


if __name__ == "__main__":
    import json
    import sys

    with open(sys.argv[1]) as f:
        made = write_state(json.load(f), sys.argv[2])
    print(f"wrote {sys.argv[2]}: N = {made.pos.shape[0]}, t_end = {made.t_end!r} (code units)")
