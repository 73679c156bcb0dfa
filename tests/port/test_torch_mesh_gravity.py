"""P3M mesh: port vs the JAX package, and the accuracy bar, on the CPU.

`good_fft_size`, `greens_hat` and `p3m_mesh_force` of the port against
`sphtpu.physics.mesh_gravity` on the same numpy inputs (f64 to FFT
roundoff, f32 to f32 FFT roundoff); then the port's whole P3M force
evaluation held to the bars of
tests/test_mesh_gravity.py::test_p3m_beats_reference_octree against the
exact softened sum and the reference's own theta = 0.576 octree walk
(the port's `physics/oracle_bh`, host C, held bit-equal to
`sphtpu.physics.oracle_bh`)."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from sphtpu.physics.mesh_gravity import good_fft_size as good_fft_size_ref
from sphtpu.physics.mesh_gravity import greens_hat as greens_hat_ref
from sphtpu.physics.mesh_gravity import p3m_mesh_force as p3m_mesh_force_ref
from sphtpu.physics.oracle_bh import bh_gravity as bh_gravity_ref
from sphtpu.physics.oracle_bh import exact_gravity as exact_gravity_ref
from sphtpu.scenes.generators import boss_bodenheimer
from sphtpu_torch.engine import EngineConfig, params_from_numpy
from sphtpu_torch.engine.step import force_eval
from sphtpu_torch.physics.mesh_gravity import (
    good_fft_size,
    greens_hat,
    mesh_gphi_over_r,
    mesh_phi,
    p3m_mesh_force,
)
from sphtpu_torch.physics.oracle_bh import bh_gravity, exact_gravity
from sphtpu_torch.physics.tiles import choose_tile_params

# the suite runs several pytest workers per machine: keep torch's intra-op
# pool from oversubscribing the cores they share
torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _free_reference_caches():
    """When the module is done, drop its cached JAX results and compiled
    programs, so that the test worker does not carry them into the tests it
    runs next."""
    yield
    jax.clear_caches()
    gc.collect()


TORCH = {"float64": torch.float64, "float32": torch.float32}


def _cloud(n, seed=3, kh=32):
    """tests/test_mesh_gravity.py's fixture: boss_bodenheimer in f32."""
    rng = np.random.default_rng(seed)
    pos, _, _ = boss_bodenheimer(n, 1.0, 1.0, rng=rng)
    pos = pos.astype(np.float32)
    d, _ = cKDTree(pos).query(pos, k=kh)
    return pos, (d[:, -1] / 2).astype(np.float32)


def _rms(v):
    return np.sqrt((np.linalg.norm(v, axis=1) ** 2).mean())


def test_good_fft_size_matches_reference():
    for n in range(1, 400):
        assert good_fft_size(n) == good_fft_size_ref(n)
    assert good_fft_size(2 * (95 + 2)) == 200  # the N = 2e5 plan's mesh


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_greens_hat_matches_reference(dtype):
    pad, sigc = 40, 2.2
    ref = np.asarray(greens_hat_ref(pad, sigc, getattr(jnp, dtype)))
    out = greens_hat(pad, sigc, TORCH[dtype], "cpu")
    assert out.dtype == (torch.complex128 if dtype == "float64" else torch.complex64)
    tol = 1e-12 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_p3m_mesh_force_matches_reference(dtype):
    n, gm, sigc = 2048, 30, 2.2
    pad = good_fft_size(2 * (gm + 2))
    pos, _ = _cloud(n)
    pos = pos.astype(dtype)
    m = 1.0 / n
    g_r, p_r = p3m_mesh_force_ref(
        jnp.asarray(pos), m, greens_hat_ref(pad, sigc, getattr(jnp, dtype)),
        gm=gm, pad=pad,
    )
    g, p = p3m_mesh_force(
        torch.from_numpy(pos), m, greens_hat(pad, sigc, TORCH[dtype], "cpu"),
        gm=gm, pad=pad,
    )
    assert g.dtype == TORCH[dtype] and g.shape == (n, 3) and p.shape == (n,)
    tol = 1e-10 if dtype == "float64" else 2e-5
    g_r, p_r = np.asarray(g_r), np.asarray(p_r)
    np.testing.assert_allclose(g.numpy(), g_r, rtol=0, atol=tol * np.abs(g_r).max())
    np.testing.assert_allclose(p.numpy(), p_r, rtol=0, atol=tol * np.abs(p_r).max())


def test_p3m_mesh_matches_analytic_shape():
    """Mesh-only output vs the analytic smoothed pair interaction it is
    deconvolved to represent (tests/test_mesh_gravity.py's budget)."""
    n, gm, sigc = 2048, 30, 2.2
    pad = good_fft_size(2 * (gm + 2))
    pos, _ = _cloud(n)
    P = torch.from_numpy(pos)
    m = np.float32(1.0 / n)
    g_mesh, phi_mesh = p3m_mesh_force(
        P, m, greens_hat(pad, sigc, torch.float32, "cpu"), gm=gm, pad=pad
    )
    half = float(np.abs(pos).max()) * (1 + 1e-6) + 1e-30
    sigma = np.float32(2 * half / gm * sigc)
    dx = P[:, None, :] - P[None, :, :]
    r = torch.sqrt(torch.sum(dx * dx, dim=-1))
    g_an = (m * torch.sum(mesh_gphi_over_r(r, sigma)[..., None] * dx, dim=1)).numpy()
    p_an = (m * torch.sum(mesh_phi(r, sigma), dim=1)).numpy()
    assert _rms(g_mesh.numpy() - g_an) / _rms(g_an) < 2e-2
    rel = (phi_mesh.numpy() - p_an) / p_an
    assert np.sqrt((rel**2).mean()) < 1e-2


def test_p3m_beats_reference_octree():
    """The port's full P3M force evaluation (mono-tile engine + mesh + tail)
    against its exact one on the same state: the gravity difference must
    stay under the reference's theta = 0.576 octree error and 2e-3 RMS,
    phi under 1e-3 relative RMS, and conserve momentum."""
    n, kh = 4096, 32
    pos, h0 = _cloud(n, kh=kh)
    tile = choose_tile_params(pos, h0, kh)
    assert tile is not None
    m = 1.0 / n
    params = params_from_numpy(m, 5 / 3, 0.0, 1.0, 2.0, 0.0, 1e9, device="cpu")
    rng = np.random.default_rng(0)
    K = torch.tensor(1.0 + 0.1 * rng.random(n), dtype=torch.float32)
    V = torch.tensor(0.1 * rng.standard_normal((n, 3)), dtype=torch.float32)
    P, H = torch.from_numpy(pos), torch.from_numpy(h0)

    out = {}
    for grav in ("exact", "p3m"):
        cfg = EngineConfig(n=n, kh=kh, eos="polytropic", tile=tile, gravity=grav)
        ghat = (greens_hat(cfg.mesh_pad, cfg.sigma_cells, torch.float32, "cpu")
                if grav == "p3m" else None)
        acc, red, phi, fell_back = force_eval(cfg, params, P, V, K, H, ghat, device="cpu")
        assert not fell_back
        out[grav] = (acc.numpy().astype(np.float64), red, phi.numpy())

    # the acc difference isolates the gravity difference (hydro is identical)
    dg = out["p3m"][0] - out["exact"][0]
    h = out["exact"][1].h.numpy()
    ge, _ = exact_gravity(pos, h, m)
    gb, _ = bh_gravity(pos, h, m, theta=0.576)
    rms = _rms(ge)
    err_p3m = _rms(dg) / rms
    err_bh = _rms(gb - ge) / rms
    assert err_p3m < err_bh, (err_p3m, err_bh)
    assert err_p3m < 2e-3, err_p3m
    relp = np.abs(out["p3m"][2] - out["exact"][2]) / np.abs(out["exact"][2])
    assert np.sqrt((relp**2).mean()) < 1e-3
    assert np.abs(m * dg.sum(0)).max() < 1e-5 * rms


@pytest.mark.parametrize("theta", [0.576, 0.3])
def test_oracle_bh_bit_equal_reference(theta):
    """The port's Barnes-Hut oracle and exact softened sum (its own copy of
    oracle_bh.c, built into build/) give the reference's bits on the same
    input: a two-scale cloud with spread smoothing lengths."""
    rng = np.random.default_rng(5)
    pos = np.concatenate([0.2 * rng.standard_normal((600, 3)), rng.standard_normal((400, 3))])
    h = 0.05 + 0.05 * rng.random(1000)
    m = 1.0 / 1000
    for port, ref in (
        (bh_gravity(pos, h, m, theta=theta), bh_gravity_ref(pos, h, m, theta=theta)),
        (exact_gravity(pos, h, m), exact_gravity_ref(pos, h, m)),
    ):
        assert port is not None and ref is not None
        np.testing.assert_array_equal(port[0], ref[0])
        np.testing.assert_array_equal(port[1], ref[1])


def test_force_eval_p3m_needs_greens_function():
    """The mesh's Green's function is computed once per chunk runner; a
    p3m force evaluation given none refuses instead of building its own."""
    n, kh = 64, 8
    cfg = EngineConfig(n=n, kh=kh, eos="polytropic", tile=(4, 32), gravity="p3m")
    params = params_from_numpy(1.0 / n, 5 / 3, 0.0, 1.0, 2.0, 0.0, 1e9, device="cpu")
    z = torch.zeros((n, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="ghat"):
        force_eval(cfg, params, z, z, z[:, 0], z[:, 0], device="cpu")
