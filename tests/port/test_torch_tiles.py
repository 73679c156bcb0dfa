"""Mono-tile engine: port vs the JAX package, on the CPU.

The same numpy scene goes through `sphtpu.physics.tiles.tile_sph_forces`
(phase A as the Pallas kernel in interpret mode or as its XLA form) and
through `sphtpu_torch.physics.tiles.tile_sph_forces` with CPU tensors, where
every kernel wrapper takes its plain PyTorch version: K4 `phase_a_tile`,
K2 `phase_b_tiles` and the P3M tail `p3m_tail`. No CUDA kernel runs here.

Tolerances: f64 to reduction-order roundoff (those of tests/test_tiles.py
and tests/test_torch_ctiles.py); f32 to f32 roundoff of the same sums.
h agrees to the last ulp, not bit for bit: XLA may contract the squared
distance into FMAs on the CPU, the port never does.
"""

import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from sphtpu.kernels.pallas_knn import phase_a_pallas
from sphtpu.physics.tiles import tile_sph_forces as tile_ref
from sphtpu.scenes.generators import boss_bodenheimer
from sphtpu_torch.kernels import cuda_knn
from sphtpu_torch.kernels.cuda_p3m_tail import p3m_tail_plain
from sphtpu_torch.physics import gravity_allpairs, gravity_newton_allpairs, sph_forces
from sphtpu_torch.physics.tiles import (
    MASK,
    X,
    Y,
    Z,
    _tail_planes,
    _tile_stack,
    choose_tile_params,
    tile_sph_forces,
)

# the suite runs several pytest workers per machine: keep torch's intra-op
# pool from oversubscribing the cores they share
torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _free_reference_caches():
    """When the module is done, drop its cached JAX results and compiled
    programs, so that the test worker does not carry them into the tests it
    runs next."""
    yield
    _ref.cache_clear()
    _scene.cache_clear()
    jax.clear_caches()
    gc.collect()


N, KH = 1500, 12
NP = {"float64": np.float64, "float32": np.float32}
MESH = {"exact": 0, "p3m_w2": 5, "p3m_w1": 10}  # mesh_factor; W = 2 and 1
PHYS = dict(gamma=5 / 3, cs0=0.6, alpha=1.0, beta=2.0, kh=KH)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _scene(dtype="float64"):
    rng = np.random.default_rng(5)
    pos, _, _ = boss_bodenheimer(N, 1.0, 1.0, rng=rng)
    vel = 0.1 * rng.standard_normal((N, 3))
    K = 1.0 + 0.1 * rng.random(N)
    d, _ = cKDTree(pos).query(pos, k=KH)
    h0 = d[:, -1] / 2
    tile = choose_tile_params(pos, h0, KH, headroom=1.5)
    f = NP[dtype]
    return pos.astype(f), vel.astype(f), K.astype(f), h0.astype(f), tile


@functools.lru_cache(maxsize=None)
def _ref(dtype, eos, mode, pallas_a):
    """JAX tile_sph_forces on the scene, as numpy (cached: one compile a
    case, shared by the tests of one process)."""
    pos, vel, K, h0, (g, cap) = _scene(dtype)
    out, gcorr, ok = tile_ref(
        jnp.asarray(pos), jnp.asarray(vel), NP[dtype](1.0 / N), jnp.asarray(K),
        jnp.asarray(h0), eos=eos, grid=g, cap=cap, mesh_factor=MESH[mode],
        pallas_a=pallas_a, pallas_interpret=True, **PHYS,
    )
    return (
        {k: np.asarray(v) for k, v in out._asdict().items()},
        [np.asarray(x) for x in gcorr],
        bool(ok),
    )


def _port(dtype, eos, mode):
    pos, vel, K, h0, (g, cap) = _scene(dtype)
    return tile_sph_forces(
        t(pos), t(vel), NP[dtype](1.0 / N), t(K), t(h0), eos=eos, grid=g,
        cap=cap, mesh_factor=MESH[mode], device="cpu", **PHYS,
    )


def _cands(dtype, grid_factor=1, max_rows=160):
    """The port's 27-cell prestack rows of x, y, z, mask for the first
    max_rows cells with an occupied centre (phase A is row by row), their
    cell edge squared and (grid, cap)."""
    pos, vel, _, _, (g, cap) = _scene(dtype)
    g *= grid_factor
    st = _tile_stack(t(pos), t(vel), g, cap)
    rows = torch.nonzero(st.qpl[MASK, : g**3, 0] > 0).flatten()[:max_rows]
    cands = tuple(st.pre_rows[f, rows].contiguous() for f in (X, Y, Z, MASK))
    return cands, st.s * st.s, g, cap


# ---------------------------------------------------------------- K4
@pytest.mark.parametrize("grid_factor", [1, 2])
def test_phase_a_tile_matches_pallas(grid_factor):
    """K4's plain version vs phase_a_pallas (interpret mode) on the same
    prestack rows, f64 (f32: through the Pallas case of
    test_tile_sph_forces_matches_reference). grid_factor 2 is an undersized
    grid, as in tests/test_pallas_knn.py: r_k exceeds the cell edge and
    rows must fail to certify in both."""
    cands, s2, _, cap = _cands("float64", grid_factor)
    m = 1.0 / N
    h_r, rho_r, ok_r = (
        np.asarray(a)
        for a in phase_a_pallas(
            tuple(jnp.asarray(c.numpy()) for c in cands), float(s2), m,
            kh=KH, cap=cap, interpret=True,
        )
    )
    before = cuda_knn.launches
    h, rho, ok = cuda_knn.phase_a_tile(cands, s2, m, kh=KH, cap=cap)
    assert cuda_knn.launches == before, "no kernel launch on CPU tensors"
    assert h.dtype == torch.float64 and h.shape == h_r.shape
    np.testing.assert_array_equal(ok.numpy(), ok_r)
    np.testing.assert_allclose(h.numpy(), h_r, rtol=1e-12, atol=0)
    np.testing.assert_allclose(rho.numpy(), rho_r, rtol=1e-12)
    occ = cands[3].numpy()[:, 13 * cap : 14 * cap] > 0
    if grid_factor == 1:
        assert ok_r[occ].all(), "the planned grid certifies every row"
    else:
        assert not ok_r[occ].all(), "the undersized grid must not certify"
    assert (ok_r[~occ] == 1).all() and (h.numpy()[~occ] == 0).all()


# ------------------------------------------------------ tile_sph_forces
CASES = [
    # dtype, eos, mode, phase A of the reference (Pallas K4 or its XLA form)
    ("float64", "polytropic", "exact", True),
    ("float64", "isothermal", "p3m_w2", False),
    ("float64", "polytropic", "p3m_w1", False),
    ("float32", "isothermal", "p3m_w2", True),
]


@pytest.mark.parametrize("dtype,eos,mode,pallas_a", CASES)
def test_tile_sph_forces_matches_reference(dtype, eos, mode, pallas_a):
    ref, gcorr_r, ok_r = _ref(dtype, eos, mode, pallas_a)
    out, gcorr, ok = _port(dtype, eos, mode)
    assert ok_r and bool(ok), "the planned grid must certify"
    if dtype == "float64":
        tol = dict(
            h=(1e-12, 0), rho=(1e-12, 0), cs=(1e-12, 0), acc=(1e-8, 1e-12),
            mu_max=(1e-10, 1e-14), div_sum=(1e-9, 1e-14), visc_dk=(1e-8, 1e-15),
        )
        g_rtol, g_atol = 1e-9, 1e-12
    else:
        # f32: relative to each output's largest value (sums of signed pair
        # terms cancel; roundoff scales with the terms)
        tol = dict(
            h=(2.4e-7, 0), rho=(2e-5, 0), cs=(2e-5, 0), acc=(2e-4, 2e-5),
            mu_max=(2e-4, 2e-5), div_sum=(2e-4, 2e-5), visc_dk=(2e-4, 2e-5),
        )
        g_rtol, g_atol = 2e-4, 2e-5
    for name, (rtol, atol) in tol.items():
        b = ref[name]
        np.testing.assert_allclose(
            getattr(out, name).numpy(), b, rtol=rtol,
            atol=atol * np.abs(b).max(), err_msg=name,
        )
    for a, b in zip(gcorr, gcorr_r):
        np.testing.assert_allclose(
            a.numpy(), b, rtol=g_rtol, atol=g_atol * np.abs(b).max()
        )


@pytest.mark.parametrize("mode", ["p3m_w2", "p3m_w1"])
def test_p3m_tail_plain_matches_reference_phase_c(mode):
    """The tail pass alone: the reference's phase C is what its p3m
    corrections add to its exact ones (phase B's gravity term depends on
    positions and h only, not on the EOS)."""
    _, g_exact, _ = _ref("float64", "polytropic", "exact", True)
    case = next(c for c in CASES if c[0] == "float64" and c[2] == mode)
    _, g_p3m, _ = _ref(*case)
    pos, vel, _, _, (g, cap) = _scene("float64")
    st = _tile_stack(t(pos), t(vel), g, cap)
    w = {"p3m_w2": 2, "p3m_w1": 1}[mode]
    sigma = (st.s / MESH[mode]) * 2.2
    tail = p3m_tail_plain(
        _tail_planes(t(pos), st, w), 1.0 / N, sigma, grid=g, cap=cap, halfwidth=w
    )
    for k in range(4):
        b = g_p3m[k] - g_exact[k]
        a = tail[k][st.cell_row, st.rank].numpy()
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12 * np.abs(b).max())


@pytest.mark.parametrize("eos", ["polytropic", "isothermal"])
def test_tile_sph_forces_is_the_gather_engine(eos):
    """Exact mode, f64: hydro equals the port's gather engine and the
    Newtonian sweep + tile corrections equal the softened all-pairs sum
    (tests/test_tiles.py::test_tiles_match_gather_engine)."""
    pos, vel, K, _, _ = _scene("float64")
    out, gcorr, ok = _port("float64", eos, "exact")
    assert bool(ok)
    ref = sph_forces(t(pos), t(vel), 1.0 / N, t(K), eos=eos, **PHYS)
    for name in ("h", "rho", "acc", "mu_max", "div_sum", "visc_dk"):
        b = getattr(ref, name).numpy()
        np.testing.assert_allclose(
            getattr(out, name).numpy(), b, rtol=1e-8,
            atol=1e-12 * np.abs(b).max(), err_msg=name,
        )
    g_soft, phi_soft = gravity_allpairs(t(pos), out.h, 1.0 / N)
    g_newt, phi_newt = gravity_newton_allpairs(t(pos), 1.0 / N, device="cpu")
    np.testing.assert_allclose(
        (g_newt + torch.stack(gcorr[:3], 1)).numpy(), g_soft.numpy(),
        rtol=1e-9, atol=1e-11 * g_soft.abs().max().item(),
    )
    np.testing.assert_allclose(
        (phi_newt + gcorr[3]).numpy(), phi_soft.numpy(), rtol=1e-10
    )


@pytest.mark.parametrize("grid,cap", [(24, 8), (4, 8)])
def test_tile_certification_fails_on_bad_grid(grid, cap):
    """Far too fine (r_k > cell edge) or far too coarse (slot overflow):
    ok=False, never an exception (tests/test_tiles.py)."""
    pos, vel, K, h0, _ = _scene("float64")
    _, _, ok = tile_sph_forces(
        t(pos), t(vel), 1.0 / N, t(K), t(h0), eos="polytropic", grid=grid,
        cap=cap, device="cpu", **PHYS,
    )
    assert not bool(ok)

