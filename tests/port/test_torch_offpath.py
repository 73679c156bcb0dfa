"""The modules off the production path: `physics/density.py::density_at`,
`physics/dense.py::dense_forces` and `neighbors/celllist.py`
(`knn_celllist`, `morton3`), port vs the JAX package on the CPU in float64
(tests/test_dense.py and tests/test_celllist.py, mirrored). None of them
reaches a Pallas kernel: they are torch ops in the port."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from sphtpu.neighbors import knn_celllist as celllist_ref
from sphtpu.neighbors.celllist import morton3 as morton3_ref
from sphtpu.physics import density_at as density_ref
from sphtpu.physics.dense import dense_forces as dense_ref
from sphtpu_torch.neighbors import NeighborInfo, knn_celllist
from sphtpu_torch.neighbors.celllist import morton3
from sphtpu_torch.physics import density_at, gravity_allpairs, sph_forces
from sphtpu_torch.physics.dense import dense_forces

# the suite runs several pytest workers per machine: keep torch's intra-op
# pool from oversubscribing the cores they share
torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _free_reference_caches():
    """Drop the module's compiled JAX programs when it is done."""
    yield
    jax.clear_caches()
    gc.collect()


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_density_at_matches_reference():
    """The radial-profile probe: 300 points on a line through a cloud of
    2 000 particles, Kh = 32, against the reference to 1e-12."""
    rng = np.random.default_rng(0)
    pos = rng.standard_normal((2000, 3))
    rr = np.stack([np.linspace(0.0, 2.5, 300), np.zeros(300), np.zeros(300)], axis=1)
    ref = np.asarray(density_ref(jnp.asarray(rr), jnp.asarray(pos), 1.0 / 2000, 32))
    got = density_at(t(rr), t(pos), 1.0 / 2000, 32).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12)


@pytest.mark.parametrize("case", ["full_k_no_av", "momentum"])
def test_dense_forces_match_reference(case):
    """tests/test_dense.py's two cases: with kh = N and no viscosity the
    dense engine is the gather engine plus softened gravity; pressure and
    gravity conserve momentum. Every output also matches the reference's
    dense engine to 1e-10 of its scale."""
    seed, n, kh = (0, 96, 96) if case == "full_k_no_av" else (1, 128, 32)
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n, 3))
    vel = 0.2 * rng.standard_normal((n, 3))
    K = 1.0 + rng.random(n) if case == "full_k_no_av" else np.ones(n)
    kw = dict(eos="polytropic", gamma=5 / 3, cs0=0.0, alpha=0.0, beta=0.0, kh=kh)
    m = 1.0 / n
    dense, phi = dense_forces(t(pos), t(vel), m, t(K), **kw, G=1.0)
    ref, phi_r = jax.jit(dense_ref, static_argnames=("eos", "kh"))(
        jnp.asarray(pos), jnp.asarray(vel), m, jnp.asarray(K), **kw, G=1.0)
    for name in ("acc", "rho", "h", "cs", "mu_max", "div_sum", "visc_dk", "mu", "Pi",
                 "v_dot_dW"):
        b = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(dense, name).numpy(), b, rtol=1e-10,
                                   atol=1e-10 * np.abs(b).max(), err_msg=name)
    np.testing.assert_array_equal(dense.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(dense.self_mask.numpy(), np.asarray(ref.self_mask))
    np.testing.assert_allclose(phi.numpy(), np.asarray(phi_r), rtol=1e-12)
    if case == "full_k_no_av":
        fast = sph_forces(t(pos), t(vel), m, t(K), **kw)
        np.testing.assert_allclose(dense.rho.numpy(), fast.rho.numpy(), rtol=1e-12)
        g, phi_ref = gravity_allpairs(t(pos), fast.h, m)
        np.testing.assert_allclose(dense.acc.numpy(), (fast.acc - g).numpy(), rtol=1e-8,
                                   atol=1e-12)
        np.testing.assert_allclose(phi.numpy(), phi_ref.numpy(), rtol=1e-10)
    else:
        assert np.abs(dense.acc.numpy().sum(axis=0)).max() < 1e-12


def _celllist_both(pos, k, h_hint, **kw):
    """The port's and the reference's knn_celllist on the same input, and
    the KD-tree's neighbour sets."""
    idx, info = knn_celllist(t(pos), k, t(h_hint), **kw)
    idx_r, info_r = celllist_ref(jnp.asarray(pos), k, jnp.asarray(h_hint), **kw)
    assert isinstance(info, NeighborInfo)
    for a, b in zip(info, info_r):
        assert a.item() == np.asarray(b).item()
    _, idx_kd = cKDTree(pos).query(pos, k=k)
    idx, idx_r = idx.numpy(), np.asarray(idx_r)
    for i in range(len(pos)):
        assert set(idx[i]) == set(idx_kd[i]), i
    # the reference's order too, up to ties in distance
    d = np.linalg.norm(pos[:, None, :] - pos[idx], axis=-1)
    d_r = np.linalg.norm(pos[:, None, :] - pos[idx_r], axis=-1)
    np.testing.assert_allclose(d, d_r, rtol=1e-12)
    return idx, info


# one shape for the four cases: the reference compiles its program once
N_CL, K_CL = 2500, 16


@pytest.mark.parametrize("case", ["uniform", "bad_hint", "clustered", "self_first"])
def test_knn_celllist_matches_reference(case):
    """tests/test_celllist.py's four cases, at N = 2 500 and k = 16 each:
    exact neighbour sets against the KD-tree, the reference's NeighborInfo
    and its neighbours in the same distance order."""
    rng = np.random.default_rng({"uniform": 0, "bad_hint": 1, "clustered": 2,
                                 "self_first": 3}[case])
    if case == "bad_hint":
        pos = rng.standard_normal((N_CL, 3))
        _, info = _celllist_both(pos, K_CL, np.full(N_CL, 1e-4), row_block=512)
        assert not bool(info.certified)
        return
    if case == "clustered":
        pos = rng.standard_normal((N_CL, 3))
        pos[: N_CL // 2] *= 0.05
    else:
        pos = rng.random((N_CL, 3))
    h = cKDTree(pos).query(pos, k=K_CL)[0][:, -1] / 2
    idx, info = _celllist_both(pos, K_CL, h, row_block=512)
    if case == "uniform":
        assert bool(info.certified) and not bool(info.fell_back)
    elif case == "clustered":
        assert int(info.n_residual) > 0
    else:
        assert (idx[:, 0] == np.arange(N_CL)).all()
        dmat = np.linalg.norm(pos[:, None, :] - pos[idx], axis=-1)
        assert (np.diff(dmat, axis=1) >= -1e-12).all()


def test_morton3_matches_reference():
    """Morton keys of every 10-bit coordinate triple's corners and of random
    triples: bit-equal int32."""
    rng = np.random.default_rng(4)
    c = np.concatenate([rng.integers(0, 1024, (5000, 3)),
                        np.array([[0, 0, 0], [1023, 1023, 1023], [1023, 0, 511]])])
    got = morton3(*(t(c[:, a].astype(np.int32)) for a in range(3)))
    ref = morton3_ref(*(jnp.asarray(c[:, a], jnp.uint32) for a in range(3)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
