"""Class-compacted tile engine: port vs the JAX package, on the CPU.

The port runs with CPU tensors (plain versions of phase A / phase B); the
reference runs its Pallas kernels in interpret mode. Tolerances are those
of tests/test_ctiles.py (f64, reduction-order roundoff)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from sphtpu.physics.ctiles import choose_tile_classes as choose_ref
from sphtpu.physics.ctiles import ctile_classes_still_ok as still_ok_ref
from sphtpu.physics.ctiles import ctile_sph_forces as ctile_ref
from sphtpu.physics.tiles import choose_tile_params as choose_tp_ref
from sphtpu.physics.tiles import tile_params_still_ok as tp_ok_ref
from sphtpu_torch.physics import gravity_allpairs, gravity_newton_allpairs, sph_forces
from sphtpu_torch.physics.ctiles import (
    choose_tile_classes,
    ctile_classes_still_ok,
    ctile_sph_forces,
)
from sphtpu_torch.physics.tiles import choose_tile_params, tile_params_still_ok

# the suite runs several pytest workers per machine: keep torch's intra-op
# pool from oversubscribing the cores they share
torch.set_num_threads(2)



def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _two_scale_ball(n, seed=0):
    """Mildly contrasted ball so the occupancy classes are non-trivial
    (the fixture of tests/test_ctiles.py)."""
    rng = np.random.default_rng(seed)
    n_core = n // 3
    u = rng.random(n) ** (1 / 3)
    u[:n_core] *= 0.6  # denser core: several occupancy classes
    dirs = rng.standard_normal((n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pos = u[:, None] * dirs
    vel = 0.3 * rng.standard_normal((n, 3))
    return pos, vel


def _h_true(pos, kh):
    d, _ = cKDTree(pos).query(pos, k=kh)
    return d[:, -1] / 2


def test_planners_match_reference():
    n, kh = 4000, 16
    pos, _ = _two_scale_ball(n)
    h = _h_true(pos, kh)
    plan = choose_tile_classes(pos, h, kh)
    assert plan == choose_ref(pos, h, kh)
    assert choose_tile_params(pos, h, kh) == choose_tp_ref(pos, h, kh)
    g, cap, classes = plan
    assert ctile_classes_still_ok(pos, h, g, cap, classes) == still_ok_ref(
        pos, h, g, cap, classes
    )
    starved = tuple((ck, 8) for ck, _ in classes)
    assert not ctile_classes_still_ok(pos, h, g, cap, starved)
    assert tile_params_still_ok(pos, h, g, cap, 0) == tp_ok_ref(pos, h, g, cap, 0)
    assert not tile_params_still_ok(pos, h, g, 8, 0)


@pytest.mark.parametrize("eos", ["polytropic", "isothermal"])
def test_ctiles_match_reference_and_gather(eos):
    n, kh = 4000, 16
    pos, vel = _two_scale_ball(n)
    h_true = _h_true(pos, kh)
    g, cap, classes = choose_tile_classes(pos, h_true, kh)
    assert len(classes) >= 2, "fixture must exercise several classes"
    K = 1.0 + 0.2 * np.random.default_rng(1).random(n)
    kw = dict(gamma=5 / 3, cs0=0.6, alpha=1.0, beta=2.0, kh=kh)
    m = 1.0 / n

    ref, gcorr_r, ok_r = ctile_ref(
        jnp.asarray(pos), jnp.asarray(vel), m, jnp.asarray(K),
        jnp.asarray(h_true), eos=eos, grid=g, cap=cap, classes=classes,
        interpret=True, **kw,
    )
    out, gcorr, ok = ctile_sph_forces(
        t(pos), t(vel), m, t(K), t(h_true), eos=eos, grid=g, cap=cap,
        classes=classes, device="cpu", **kw,
    )
    assert bool(ok_r) and bool(ok), f"certification failed at grid={g}"
    gather = sph_forces(t(pos), t(vel), m, t(K), eos=eos, **kw)

    tol = dict(
        h=(1e-12, 0), rho=(1e-12, 0), cs=(1e-12, 0), acc=(1e-8, 1e-12),
        mu_max=(1e-10, 1e-14), div_sum=(1e-9, 1e-14), visc_dk=(1e-8, 1e-15),
    )
    for name, (rtol, atol) in tol.items():
        a = getattr(out, name).numpy()
        np.testing.assert_allclose(
            a, np.asarray(getattr(ref, name)), rtol=rtol, atol=atol,
            err_msg=f"{name} vs the JAX class engine",
        )
        np.testing.assert_allclose(
            a, getattr(gather, name).numpy(), rtol=rtol, atol=atol,
            err_msg=f"{name} vs the port's gather engine",
        )
    for a, b in zip(gcorr, gcorr_r):
        b = np.asarray(b)
        np.testing.assert_allclose(
            a.numpy(), b, rtol=1e-9, atol=1e-12 * np.abs(b).max()
        )

    # gravity split: Newtonian sweep + class-tile correction == softened
    g_soft, phi_soft = gravity_allpairs(t(pos), out.h, m)
    g_newt, phi_newt = gravity_newton_allpairs(t(pos), m, device="cpu")
    g_split = g_newt + torch.stack(gcorr[:3], 1)
    np.testing.assert_allclose(
        g_split.numpy(), g_soft.numpy(), rtol=1e-9,
        atol=1e-11 * g_soft.abs().max().item(),
    )
    np.testing.assert_allclose(
        (phi_newt + gcorr[3]).numpy(), phi_soft.numpy(), rtol=1e-10
    )


def test_ctiles_p3m_matches_reference():
    """The p3m branch (explicit mesh_factor >= ceil(4.4 sigma_cells))."""
    n, kh = 1500, 12
    pos, vel = _two_scale_ball(n, seed=3)
    h_true = _h_true(pos, kh)
    g, cap, classes = choose_tile_classes(pos, h_true, kh)
    kw = dict(
        eos="polytropic", gamma=5 / 3, cs0=0.0, alpha=1.0, beta=2.0, kh=kh,
        grid=g, cap=cap, classes=classes, mesh_factor=10, sigma_cells=2.2,
    )
    _, gcorr_r, ok_r = ctile_ref(
        jnp.asarray(pos), jnp.asarray(vel), 1.0 / n, jnp.ones(n),
        jnp.asarray(h_true), interpret=True, **kw,
    )
    _, gcorr, ok = ctile_sph_forces(
        t(pos), t(vel), 1.0 / n, torch.ones(n, dtype=torch.float64),
        t(h_true), device="cpu", **kw,
    )
    assert bool(ok) == bool(ok_r)
    for a, b in zip(gcorr, gcorr_r):
        b = np.asarray(b)
        np.testing.assert_allclose(
            a.numpy(), b, rtol=1e-9, atol=1e-12 * np.abs(b).max()
        )


@pytest.mark.parametrize("starve", ["counts", "cap"])
def test_ctiles_overflow_fails_cert(starve):
    """A plan whose class counts (or slot capacity) no longer fit the
    state must report ok=False, never raise or corrupt memory."""
    n, kh = 1500, 12
    pos, vel = _two_scale_ball(n, seed=2)
    h_true = _h_true(pos, kh)
    g, cap, classes = choose_tile_classes(pos, h_true, kh)
    if starve == "counts":
        # strangle every class list to the minimum: counts cannot fit
        classes = tuple((ck, 8) for ck, _ in classes)
    else:
        cap, classes = 8, ((8, classes[0][1]),)
    _, _, ok = ctile_sph_forces(
        t(pos), t(vel), 1.0 / n, torch.ones(n, dtype=torch.float64),
        t(h_true), eos="polytropic", gamma=5 / 3, cs0=0.0, alpha=1.0,
        beta=2.0, kh=kh, grid=g, cap=cap, classes=classes, device="cpu",
    )
    assert not bool(ok)
