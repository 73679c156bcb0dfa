"""Port vs reference, kernel-bearing modules and the plain physics.

The same numpy inputs go through the JAX function (Pallas kernels in
interpret mode, as the reference's own CPU tests run them) and through the
port with CPU tensors, where every kernel wrapper takes its plain PyTorch
version. No CUDA kernel runs here: kernel-vs-plain on the card is
chip_smoke.py's job.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphtpu.kernels import W as W_ref
from sphtpu.kernels import grad_W_over_r as gradW_ref
from sphtpu.kernels import softened_gphi_over_r as gphi_ref
from sphtpu.kernels import softened_phi as phi_ref
from sphtpu.kernels.pallas_gravity import newton_sweep_pallas
from sphtpu.kernels.pallas_strip_knn import phase_a_cells as phase_a_ref
from sphtpu.kernels.pallas_tile_pairs import phase_b_tiles as phase_b_ref
from sphtpu.neighbors import knn as knn_ref
from sphtpu.physics import gravity_allpairs as gravity_allpairs_ref
from sphtpu.physics import gravity_newton_allpairs as newton_ref
from sphtpu.physics import sph_forces as sph_forces_ref
from sphtpu.physics.mesh_gravity import mesh_gphi_over_r as mesh_g_ref
from sphtpu.physics.mesh_gravity import mesh_phi as mesh_p_ref
from sphtpu_torch.kernels import W, grad_W_over_r, softened_gphi_over_r, softened_phi
from sphtpu_torch.kernels import cuda_gravity, cuda_strip_knn, cuda_tile_pairs
from sphtpu_torch.neighbors import knn
from sphtpu_torch.physics import (
    gravity_allpairs,
    gravity_newton_allpairs,
    sph_forces,
)
from sphtpu_torch.physics.mesh_gravity import mesh_gphi_over_r, mesh_phi

# the suite runs several pytest workers per machine: keep torch's intra-op
# pool from oversubscribing the cores they share
torch.set_num_threads(2)


NP = {"float64": np.float64, "float32": np.float32}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cell_rows(dtype, n_cells=16, cap=32, seed=0):
    """Cell rows with cw = 27 * cap candidate slots, ~40% occupied; the
    queries are the 14th stencil cell's slots, as the tile engines stack
    them. Row 1 gets a reach too small to certify, row 2 is masked off."""
    rng = np.random.default_rng(seed)
    cw = 27 * cap
    cm = (rng.random((n_cells, cw)) < 0.4).astype(dtype)
    cpos = [(rng.random((n_cells, cw)) * cm).astype(dtype) for _ in range(3)]
    sl = slice(13 * cap, 14 * cap)
    qm = cm[:, sl].copy()
    qm[2] = 0.0
    reach2 = np.full((n_cells, cap), 0.35**2, dtype)
    reach2[1] = 0.05**2
    queries = [c[:, sl].copy() for c in cpos] + [qm]
    return queries, reach2, cpos + [cm], cw


# ---------------------------------------------------------------- (a) K1
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_phase_a_cells_matches_reference(dtype):
    cap, kh = 32, 16
    queries, reach2, cands, _ = _cell_rows(NP[dtype])
    m = 1.0 / 4000
    h_r, rho_r, ok_r = phase_a_ref(
        tuple(jnp.asarray(a) for a in queries), jnp.asarray(reach2),
        tuple(jnp.asarray(a) for a in cands), m, kh=kh, cap=cap,
        interpret=True,
    )
    before = cuda_strip_knn.launches
    h, rho, ok = cuda_strip_knn.phase_a_cells(
        tuple(t(a) for a in queries), t(reach2), tuple(t(a) for a in cands),
        m, kh=kh, cap=cap,
    )
    assert cuda_strip_knn.launches == before, "no kernel launch on CPU tensors"
    assert h.dtype == getattr(torch, dtype)
    ok_r = np.asarray(ok_r)
    np.testing.assert_array_equal(ok.numpy(), ok_r)
    # f64: reduction-order roundoff only; f32: W evaluated per pair in f32
    h_tol, rho_tol = (1e-12, 1e-12) if dtype == "float64" else (1e-6, 2e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), rtol=h_tol)
    np.testing.assert_allclose(rho.numpy(), np.asarray(rho_r), rtol=rho_tol)
    # the fixture exercises all three row kinds
    qm = queries[3]
    assert (ok_r[1][qm[1] > 0] == 0).all(), "undersized reach must not certify"
    assert (ok_r[2] == 1).all() and (h.numpy()[2] == 0).all()
    assert (rho.numpy()[2] == 0).all()
    assert ok_r[3:][qm[3:] > 0].mean() > 0.9, "most plain rows certify"


def test_phase_a_cells_plain_is_generic_in_shape():
    """cap, cw and n_bisect are free: cw need not be 27 * cap."""
    rng = np.random.default_rng(3)
    n_cells, cap, cw, kh = 5, 24, 200, 8
    cm = (rng.random((n_cells, cw)) < 0.7).astype(np.float64)
    cands = [rng.random((n_cells, cw)) for _ in range(3)] + [cm]
    queries = [c[:, :cap].copy() for c in cands]
    reach2 = np.full((n_cells, cap), 3.0)
    out_r = phase_a_ref(
        tuple(jnp.asarray(a) for a in queries), jnp.asarray(reach2),
        tuple(jnp.asarray(a) for a in cands), 0.01, kh=kh, cap=cap,
        interpret=True, n_bisect=50,
    )
    out = cuda_strip_knn.phase_a_cells(
        tuple(t(a) for a in queries), t(reach2), tuple(t(a) for a in cands),
        0.01, kh=kh, cap=cap, n_bisect=50,
    )
    for a, b in zip(out, out_r):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


def test_phase_a_cells_shared_memory_covers_every_plannable_row():
    """The kernel keeps a row's candidates in shared memory: the widest row
    the run loop can plan (the mono-tile planner's ceiling; its phase A,
    phase_a_tile, is the same kernel) fits in both dtypes, a wider one is
    refused."""
    import inspect

    from sphtpu_torch.physics.tiles import choose_tile_params

    cw = 27 * inspect.signature(choose_tile_params).parameters["cap_max"].default
    assert cuda_strip_knn.shared_bytes(cw, torch.float32) == 12 * cw
    assert cuda_strip_knn.shared_bytes(cw, torch.float64) == 24 * cw
    with pytest.raises(ValueError, match="shared memory"):
        cuda_strip_knn.shared_bytes(27 * 512, torch.float64)


# ---------------------------------------------------------------- (b) K2
def _phase_b_inputs(dtype, seed=1):
    cap, kh = 32, 16
    queries, reach2, cands, cw = _cell_rows(dtype, seed=seed)
    reach2[1] = 0.35**2
    rng = np.random.default_rng(seed + 10)
    n_cells = reach2.shape[0]
    h, rho, _ = cuda_strip_knn.phase_a_cells_plain(
        tuple(t(a) for a in queries), t(reach2), tuple(t(a) for a in cands),
        1.0 / 4000, kh=kh, cap=cap,
    )
    cm = cands[3]
    sl = slice(13 * cap, 14 * cap)
    # candidate-side h/rho: the query cell's own values where it is the
    # centre cell, plausible random ones elsewhere
    ch = (0.08 + 0.1 * rng.random((n_cells, cw))).astype(dtype) * cm
    crho = (0.5 + rng.random((n_cells, cw))).astype(dtype) * cm
    ch[:, sl] = h.numpy()
    crho[:, sl] = rho.numpy()
    cvel = [(0.3 * rng.standard_normal((n_cells, cw))).astype(dtype) * cm for _ in range(3)]
    cpor2 = (0.5 + rng.random((n_cells, cw))).astype(dtype) * cm
    ccs = (0.8 + 0.4 * rng.random((n_cells, cw))).astype(dtype) * cm
    cfields = cands[:3] + cvel + [cm, ch, crho, cpor2, ccs]
    qfields = [c[:, sl].copy() for c in cfields]
    qfields[6] = queries[3]
    return qfields, cfields, cap


@pytest.mark.parametrize("p3m", [False, True])
@pytest.mark.parametrize("eos", ["polytropic", "isothermal"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_phase_b_tiles_matches_reference(dtype, eos, p3m):
    qfields, cfields, cap = _phase_b_inputs(NP[dtype])
    m, alpha, beta = 1.0 / 4000, 1.0, 2.0
    sigma = 0.35 / 10 * 2.2 if p3m else None  # mesh_factor = 10
    ref = phase_b_ref(
        tuple(jnp.asarray(a) for a in qfields),
        tuple(jnp.asarray(a) for a in cfields),
        m, alpha, beta, sigma, eos=eos, p3m=p3m, cap=cap, interpret=True,
    )
    before = cuda_tile_pairs.launches
    out = cuda_tile_pairs.phase_b_tiles(
        tuple(t(a) for a in qfields), tuple(t(a) for a in cfields),
        m, alpha, beta, sigma, eos=eos, p3m=p3m, cap=cap,
    )
    assert cuda_tile_pairs.launches == before
    names = "ax ay az div mu_max visc ggx ggy ggz gphi".split()
    for name, a, b in zip(names, out, ref):
        a, b = a.numpy(), np.asarray(b)
        if dtype == "float64":
            if name == "mu_max":
                np.testing.assert_allclose(a, b, rtol=1e-10, err_msg=name)
            else:
                np.testing.assert_allclose(
                    a, b, rtol=1e-9, atol=1e-13 * max(1.0, np.abs(b).max()),
                    err_msg=name,
                )
        else:
            # f32: sums of signed pair terms; roundoff scales with the
            # row's magnitude, not with the (possibly cancelled) result
            scale = np.abs(b).max(axis=1, keepdims=True)
            assert (np.abs(a - b) <= 2e-4 * np.abs(b) + 2e-5 * scale).all(), name
    masked = qfields[6][2]
    assert (out[0].numpy()[2][masked <= 0] == 0).all()
    assert (out[4].numpy()[2] == -np.finfo(NP[dtype]).max).all()


# ---------------------------------------------------------------- (c) K3
def test_newton_sweep_matches_reference():
    rng = np.random.default_rng(0)
    n = 700  # not a multiple of any tile
    pos = rng.standard_normal((n, 3))
    m = 1.0 / n
    g_p, p_p = newton_sweep_pallas(jnp.asarray(pos), m, interpret=True)
    g_x, p_x = newton_ref(jnp.asarray(pos), m)
    before = cuda_gravity.launches
    g, p = gravity_newton_allpairs(t(pos), m, device="cpu")
    assert cuda_gravity.launches == before
    for gr, pr in ((g_p, p_p), (g_x, p_x)):
        np.testing.assert_allclose(g.numpy(), np.asarray(gr), rtol=1e-10)
        np.testing.assert_allclose(p.numpy(), np.asarray(pr), rtol=1e-10)
    assert np.abs(g.numpy().sum(axis=0)).max() < 1e-10  # Newton's third law
    # small blocks walk the ragged edges of the plain version
    g2, p2 = cuda_gravity.newton_sweep_plain(t(pos), m, block_q=64, block_c=96)
    np.testing.assert_allclose(g2.numpy(), g.numpy(), rtol=1e-10)
    np.testing.assert_allclose(p2.numpy(), p.numpy(), rtol=1e-12)


def test_entry_points_default_to_the_card():
    """device=None means cuda: without one the entry points raise instead
    of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    pos = torch.zeros((4, 3), dtype=torch.float64)
    with pytest.raises(RuntimeError, match="cuda|CUDA"):
        gravity_newton_allpairs(pos, 1.0)


# ------------------------------------------------- (e) plain physics, f64
def test_kernel_functions_match_reference():
    rng = np.random.default_rng(5)
    q = np.concatenate([rng.random(200) * 2.5, [0.0, 1.0, 2.0]])
    h = 0.3 + rng.random(q.shape[0])
    r = q * h
    pairs = [
        (W(t(q), t(h)), W_ref(jnp.asarray(q), jnp.asarray(h))),
        (grad_W_over_r(t(q), t(r), t(h)),
         gradW_ref(jnp.asarray(q), jnp.asarray(r), jnp.asarray(h))),
        (softened_gphi_over_r(t(r), t(h)), gphi_ref(jnp.asarray(r), jnp.asarray(h))),
        (softened_phi(t(r), t(h)), phi_ref(jnp.asarray(r), jnp.asarray(h))),
        (mesh_gphi_over_r(t(r), 0.4), mesh_g_ref(jnp.asarray(r), 0.4)),
        (mesh_phi(t(r), 0.4), mesh_p_ref(jnp.asarray(r), 0.4)),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13, atol=1e-300)
    # phi(0) = -7/5h
    np.testing.assert_allclose(
        softened_phi(torch.zeros(1, dtype=torch.float64), t(h[:1])).numpy(),
        -1.4 / h[:1], rtol=1e-15,
    )


def test_knn_matches_reference():
    rng = np.random.default_rng(6)
    pos = rng.standard_normal((900, 3))
    idx_r, d2_r = knn_ref(jnp.asarray(pos), jnp.asarray(pos), 12)
    idx, d2 = knn(t(pos), t(pos), 12, block_q=128, block_c=256)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_r))
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2_r), rtol=1e-14, atol=0)
    with pytest.raises(ValueError):
        knn(t(pos[:5]), t(pos[:5]), 6)


@pytest.mark.parametrize("eos", ["polytropic", "isothermal"])
def test_sph_forces_match_reference(eos):
    rng = np.random.default_rng(7)
    n, kh = 800, 16
    pos = rng.standard_normal((n, 3))
    vel = 0.3 * rng.standard_normal((n, 3))
    K = 1.0 + 0.2 * rng.random(n)
    kw = dict(eos=eos, gamma=5 / 3, cs0=0.6, alpha=1.0, beta=2.0, kh=kh)
    ref = sph_forces_ref(jnp.asarray(pos), jnp.asarray(vel), 1.0 / n, jnp.asarray(K), **kw)
    out = sph_forces(t(pos), t(vel), 1.0 / n, t(K), **kw)
    for name in ("rho", "h", "cs", "mu_max", "div_sum", "visc_dk", "acc"):
        b = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(
            getattr(out, name).numpy(), b, rtol=1e-10,
            atol=1e-13 * np.abs(b).max(), err_msg=name,
        )


def test_gravity_allpairs_matches_reference():
    rng = np.random.default_rng(8)
    n = 700
    pos = rng.standard_normal((n, 3))
    h = 0.05 + 0.3 * rng.random(n)
    g_r, p_r = gravity_allpairs_ref(jnp.asarray(pos), jnp.asarray(h), 1.0 / n)
    g, p = gravity_allpairs(t(pos), t(h), 1.0 / n, block_q=128, block_c=256)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_r), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_r), rtol=1e-11)
