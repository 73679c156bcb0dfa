"""Multi-level engine: port vs the JAX package, on the CPU.

The same numpy states go through `sphtpu.physics.mlevel` (its XLA phase A,
pallas_a=False) and through `sphtpu_torch.physics.mlevel` with CPU tensors,
where phase A is kernel K1's plain version (68 binary bisection passes in
float64). No CUDA kernel runs here.

Tolerances: the host planner is integer/host arithmetic and must agree bit
for bit; float64 forces are held to the bars of
tests/test_mlevel.py::_assert_parity (h rtol 1e-12, rho 1e-11, the pair
sums and gravity corrections rtol 1e-9 with 1e-11 of their scale). The
states are the reference's two-scale form at n = 1 200 (its tests take
n <= 4 000) and strided subsamples of the committed collapse fixtures.
"""

import functools
import gc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import sphtpu.physics.mlevel as RM
from sphtpu.engine import EngineConfig as RefConfig
from sphtpu.engine import Params as RefParams
from sphtpu.engine import State as RefState
from sphtpu.engine.step import make_chunk_runner as ref_chunk_runner
import sphtpu_torch.engine.driver as driver
import sphtpu_torch.physics.mlevel as TM
from sphtpu_torch.engine import (
    EngineConfig,
    make_chunk_runner,
    params_from_numpy,
    state_from_numpy,
)
from sphtpu_torch.engine.step import force_eval
from sphtpu_torch.physics import gravity_allpairs, sph_forces
from sphtpu_torch.physics.mesh_gravity import greens_hat

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "..", "..", "bench_data")
PHYS = dict(gamma=5 / 3, alpha=1.0, beta=2.0)
N_SCENE, KH_SCENE = 1200, 16


@pytest.fixture(scope="module", autouse=True)
def _free_reference_caches():
    """When the module is done, drop its cached JAX results and compiled
    programs."""
    yield
    _ref_forces.cache_clear()
    _ref_chunk.cache_clear()
    _plan.cache_clear()
    jax.clear_caches()
    gc.collect()


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _two_scale(n=N_SCENE, kh=KH_SCENE, seed=5):
    """tests/test_mlevel.py::_two_scale: a dense core in a sparse halo."""
    rng = np.random.default_rng(seed)
    n_core = int(0.6 * n)

    def ball(count, radius):
        u = rng.random(count) ** (1 / 3)
        d = rng.standard_normal((count, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return d * (radius * u)[:, None]

    pos = np.concatenate([ball(n_core, 0.25), ball(n - n_core, 1.0)])
    vel = 0.1 * rng.standard_normal((n, 3))
    d, _ = cKDTree(pos).query(pos, k=kh)
    return pos, vel, 1.0 + 0.1 * rng.random(n), d[:, -1] / 2.0


def _fixture_state(name, step, kh):
    """Every `step`-th row of a committed collapse state, h from a k = kh
    KD-tree (tests/test_mlevel.py::test_mlevel_collapse_fixture_parity's
    subsample takes every 5th row at kh = 32), or the whole state with the
    h it stores (step 1)."""
    d = np.load(os.path.join(DATA, name))
    pos = d["pos"][::step].astype(np.float64)
    if step == 1:
        return pos, d["h"].astype(np.float64), kh
    dk, _ = cKDTree(pos).query(pos, k=kh)
    return pos, dk[:, -1] / 2.0, kh


PLAN_STATES = {
    "two_scale": lambda: (*_two_scale()[::3], KH_SCENE),
    "contrast395_every5": lambda: _fixture_state("bb_collapsed.npz", 5, 32),
    "contrast1001_every5": lambda: _fixture_state("bb_collapsed_deep.npz", 5, 32),
    "contrast1001_full": lambda: _fixture_state("bb_collapsed_deep.npz", 1, 50),
}


def _assert_args_equal(a, b):
    def walk(x, y, name):
        if isinstance(x, tuple) or x is None:
            assert (x is None) == (y is None), name
            for u, v in zip(x or (), y or ()):
                walk(u, v, name)
            return
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)

    for name in a._fields:
        walk(getattr(a, name), getattr(b, name), name)


@pytest.mark.parametrize(
    "source,gravity",
    [
        ("two_scale", "exact"),
        ("two_scale", "p3m"),
        ("contrast395_every5", "exact"),
        ("contrast395_every5", "p3m"),
        ("contrast1001_every5", "exact"),
        ("contrast1001_every5", "p3m"),
        ("contrast1001_full", "exact"),
    ],
)
def test_planner_matches_reference(source, gravity):
    """plan_mlevel: the same spec and the same MLArgs, bit for bit."""
    pos, h, kh = PLAN_STATES[source]()
    ref = RM.plan_mlevel(pos, h, kh, gravity=gravity)
    port = TM.plan_mlevel(pos, h, kh, gravity=gravity)
    assert (ref is None) == (port is None)
    assert port is not None, "the state must plan"
    assert port[0] == ref[0]
    _assert_args_equal(port[1], ref[1])
    if source == "contrast1001_full":
        # N = 100 000 at Kh = 50: two levels and a residual lane
        assert len(port[0][0]) == 2 and port[0][1] > 0


@functools.lru_cache(maxsize=None)
def _plan(gravity):
    pos, vel, K, h0 = _two_scale()
    spec, args = RM.plan_mlevel(pos, h0, KH_SCENE, gravity=gravity)
    return pos, vel, K, h0, spec, args


@pytest.mark.parametrize("drift", [0.02, 0.3])
@pytest.mark.parametrize("gravity", ["exact", "p3m"])
def test_args_still_ok_matches_reference(gravity, drift):
    """mlevel_args_still_ok on a drifted state: the same answer (refreshed
    MLArgs bit for bit, or None) as the reference's."""
    pos, vel, K, h0, spec, _ = _plan(gravity)
    rng = np.random.default_rng(3)
    pos2 = pos + drift * h0[:, None] * rng.standard_normal(pos.shape)
    h2 = h0 * (1.0 + drift * rng.random(h0.shape))
    ref = RM.mlevel_args_still_ok(pos2, h2, spec)
    port = TM.mlevel_args_still_ok(pos2, h2, spec)
    assert (ref is None) == (port is None)
    if ref is not None:
        _assert_args_equal(port, ref)


def _ref_args(a):
    return RM.MLArgs(
        act_a=tuple(tuple(jnp.asarray(b) for b in lvl) for lvl in a.act_a),
        act_b=tuple(tuple(jnp.asarray(b) for b in lvl) for lvl in a.act_b),
        act_c=None if a.act_c is None else tuple(jnp.asarray(b) for b in a.act_c),
        species=jnp.asarray(a.species),
    )


def _inputs(eos):
    cs0 = 0.5 if eos == "isothermal" else 0.0
    return cs0, dict(eos=eos, cs0=cs0, kh=KH_SCENE, **PHYS)


@functools.lru_cache(maxsize=None)
def _ref_forces(gravity, eos):
    pos, vel, K, h0, spec, args = _plan(gravity)
    cs0, kw = _inputs(eos)
    Kx = K if eos == "polytropic" else np.zeros_like(K)
    red, gcorr, ok = RM.mlevel_sph_forces(
        jnp.asarray(pos), jnp.asarray(vel), 1.0 / N_SCENE, jnp.asarray(Kx),
        jnp.asarray(h0), _ref_args(args), spec=spec, **kw,
    )
    return (
        {f: np.asarray(getattr(red, f)) for f in red._fields},
        [np.asarray(g) for g in gcorr],
        bool(ok),
    )


def _assert_parity(red, gcorr, ref, ref_gcorr):
    """tests/test_mlevel.py::_assert_parity's bars, port against reference."""
    np.testing.assert_allclose(red.h.numpy(), ref["h"], rtol=1e-12)
    np.testing.assert_allclose(red.rho.numpy(), ref["rho"], rtol=1e-11)
    for f in ("acc", "div_sum", "visc_dk"):
        scale = np.abs(ref[f]).max()
        np.testing.assert_allclose(
            getattr(red, f).numpy(), ref[f], rtol=1e-9, atol=1e-11 * scale, err_msg=f
        )
    np.testing.assert_allclose(red.mu_max.numpy(), ref["mu_max"], rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(red.cs.numpy(), ref["cs"], rtol=1e-12)
    for a, b in zip(gcorr, ref_gcorr):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-11 * np.abs(b).max())


@pytest.mark.parametrize(
    "gravity,eos",
    [("exact", "polytropic"), ("p3m", "polytropic"), ("exact", "isothermal")],
)
def test_forces_match_reference(gravity, eos):
    """mlevel_sph_forces (phase A on K1's plain version, phases B/C and the
    residual lane in torch) against the reference's XLA evaluation: both
    certify, the outputs within _assert_parity's float64 bars."""
    pos, vel, K, h0, spec, args = _plan(gravity)
    assert len(spec[0]) >= 1 and spec[1] > 0, "the state needs the residual lane"
    _, kw = _inputs(eos)
    Kx = K if eos == "polytropic" else np.zeros_like(K)
    red, gcorr, ok = TM.mlevel_sph_forces(
        t(pos), t(vel), 1.0 / N_SCENE, t(Kx), t(h0), args, spec=spec, **kw
    )
    ref, ref_gcorr, ref_ok = _ref_forces(gravity, eos)
    assert ref_ok and bool(ok)
    _assert_parity(red, gcorr, ref, ref_gcorr)


def test_stale_args_fail_certificate():
    """MLArgs planned for another state leave the in-engine certificate
    False: the caller falls back, it never uses the result."""
    pos, vel, K, h0, spec, args = _plan("exact")
    moved = pos[::-1].copy()  # every row now sits where another was planned
    _, kw = _inputs("polytropic")
    _, _, ok = TM.mlevel_sph_forces(
        t(moved), t(vel), 1.0 / N_SCENE, t(K), t(h0), args, spec=spec, **kw
    )
    assert not bool(ok)


def _ref_params(m):
    jd = jnp.float64
    return RefParams(
        m=jnp.asarray(m, jd), gamma=jnp.asarray(5 / 3, jd), cs0=jnp.asarray(0.0, jd),
        alpha=jnp.asarray(1.0, jd), beta=jnp.asarray(2.0, jd), U0=jnp.asarray(0.0, jd),
        t_end=jnp.asarray(1e9, jd),
    )


@functools.lru_cache(maxsize=None)
def _ref_chunk():
    """The reference's chunk runner on the exact plan's state: its gather
    engine (the oracle of tests/test_mlevel.py's chunk test) for
    ML_SUBCHUNK steps, as numpy (state.pos, stats, h_last); one compile a
    module, shared by the chunk tests."""
    pos, vel, K, h0, _, _ = _plan("exact")
    n = N_SCENE
    st = RefState(pos=jnp.asarray(pos), vel=jnp.asarray(vel), K=jnp.asarray(K),
                  t=jnp.asarray(0.0))
    out_r = ref_chunk_runner(RefConfig(n=n, kh=KH_SCENE, eos="polytropic", dtype="float64"))(
        st, _ref_params(1.0 / n), jnp.asarray(h0), n_steps=driver.ML_SUBCHUNK
    )
    return np.asarray(out_r[0].pos), np.asarray(out_r[1]), np.asarray(out_r[3])


def test_chunk_matches_reference_and_refreshes_args():
    """A 2-step chunk (ML_SUBCHUNK) through the port's chunk runner on the
    multi-level engine against the reference's chunk runner (its gather
    engine, the oracle of tests/test_mlevel.py's chunk test, with its bars):
    no fallbacks, the same state and stats rows. Then the port's
    mlevel_args_still_ok refreshes the lists for the drifted state (the
    reference's answer, bit for bit) and they certify."""
    pos, vel, K, h0, spec, args = _plan("exact")
    n = N_SCENE
    m = 1.0 / n
    steps = driver.ML_SUBCHUNK
    cfg = EngineConfig(n=n, kh=KH_SCENE, eos="polytropic", dtype="float64", mlevel=spec)
    par = dict(m=m, cs0=0.0, U0=0.0, t_end=1e9, **PHYS)
    out = make_chunk_runner(cfg, device="cpu")(
        state_from_numpy(pos, vel, K, 0.0, dtype="float64", device="cpu"),
        params_from_numpy(**par, dtype="float64", device="cpu"),
        t(h0), steps, args,
    )
    pos_r, stats_r, h_r = _ref_chunk()
    assert int(out[5].sum()) == 0, "no fallbacks expected"
    assert bool(out[2].all())
    np.testing.assert_allclose(
        out[0].pos.numpy(), pos_r, rtol=1e-8, atol=1e-10 * np.abs(pos_r).max()
    )
    np.testing.assert_allclose(out[1].numpy(), stats_r, rtol=1e-7)
    np.testing.assert_allclose(out[3].numpy(), h_r, rtol=1e-12)

    pos2, h2 = out[0].pos.numpy(), out[3].numpy()
    args2 = TM.mlevel_args_still_ok(pos2, h2, spec)
    assert args2 is not None
    _assert_args_equal(args2, RM.mlevel_args_still_ok(pos2, h2, spec))
    _, _, ok2 = TM.mlevel_sph_forces(
        out[0].pos, out[0].vel, m, out[0].K, out[3], args2, spec=spec,
        **_inputs("polytropic")[1],
    )
    assert bool(ok2)


def test_force_eval_p3m_tracks_exact():
    """force_eval's mlevel branch under p3m: the FFT mesh, phase C and the
    per-level corrections give the exact softened acceleration to mesh
    accuracy (tests/test_mlevel.py's p3m bars: RMS error < 2e-3 of the
    RMS |g|, phi < 1e-3), and without MLArgs it raises as the reference
    does."""
    pos, vel, K, h0, spec, args = _plan("p3m")
    n = N_SCENE
    cfg = EngineConfig(n=n, kh=KH_SCENE, eos="polytropic", dtype="float64", mlevel=spec,
                       gravity="p3m")
    p = params_from_numpy(m=1.0 / n, cs0=0.0, U0=0.0, t_end=1e9, **PHYS, dtype="float64",
                          device="cpu")
    ghat = greens_hat(cfg.mesh_pad, cfg.sigma_cells, torch.float64, "cpu")
    acc, red, phi, fb = force_eval(cfg, p, t(pos), t(vel), t(K), t(h0), ghat, args,
                                   device="cpu")
    assert not fb
    # the oracle: the gather engine's hydro + exact softened gravity
    sf = sph_forces(t(pos), t(vel), 1.0 / n, t(K), eos="polytropic", cs0=0.0, kh=KH_SCENE,
                    **PHYS)
    g_soft, phi_soft = (a.numpy() for a in gravity_allpairs(t(pos), sf.h, 1.0 / n))
    acc_or = sf.acc.numpy() - g_soft
    rms = np.sqrt((g_soft**2).sum(1).mean())
    err = np.sqrt(((acc.numpy() - acc_or) ** 2).sum(1))
    assert np.sqrt((err**2).mean()) < 2e-3 * rms
    relp = (phi.numpy() - phi_soft) / phi_soft
    assert np.sqrt((relp**2).mean()) < 1e-3
    with pytest.raises(ValueError, match="mlargs"):
        force_eval(cfg, p, t(pos), t(vel), t(K), t(h0), ghat, None, device="cpu")


@pytest.mark.parametrize("gravity", ["exact", "p3m"])
def test_plan_engine_reaches_mlevel_when_blocks_decline(gravity, monkeypatch):
    """plan_engine's ladder: where the tile engines and plan_blocks decline,
    the multi-level rung plans, with the reference's spec and MLArgs."""
    monkeypatch.setattr(driver, "choose_tile_classes", lambda *a, **k: None)
    monkeypatch.setattr(driver, "choose_tile_params", lambda *a, **k: None)
    monkeypatch.setattr(driver, "plan_blocks", lambda *a, **k: None)
    pos, _, _, h0, spec, args = _plan(gravity)
    cfg, mlargs = driver.plan_engine(pos, h0, n=N_SCENE, kh=KH_SCENE, eos="polytropic",
                                     dtype="float64", gravity=gravity)
    assert cfg.mlevel == spec and cfg.blocks is None and cfg.tile is None
    assert cfg.gravity == gravity and driver.engine_name(cfg) == "mlevel"
    _assert_args_equal(mlargs, args)


@pytest.mark.parametrize("n_shards", [2])
def test_workshard_chunk_matches_reference(n_shards):
    """A 2-step chunk (ML_SUBCHUNK) of the multi-level engine work-sharded
    over two CPU shards (shard/mlevel.make_ml_chunk_runner, the plan made
    with plan_mlevel(shards=2)) against the reference's chunk runner on the
    same state (the module's cached call: its gather engine, the oracle of
    the reference's own multi-level chunk test) with
    test_chunk_matches_reference_and_refreshes_args' bars: no certificate
    fails, every step is valid."""
    from sphtpu_torch.shard.collectives import particle_mesh
    from sphtpu_torch.shard.mlevel import make_ml_chunk_runner

    pos, vel, K, h0, _, _ = _plan("exact")
    n = N_SCENE
    spec, args = TM.plan_mlevel(pos, h0, KH_SCENE, gravity="exact", shards=n_shards)
    cfg = EngineConfig(n=n, kh=KH_SCENE, eos="polytropic", dtype="float64", mlevel=spec)
    par = dict(m=1.0 / n, cs0=0.0, U0=0.0, t_end=1e9, **PHYS)
    st, stats, valid, cert, h_last, _ = make_ml_chunk_runner(
        cfg, particle_mesh(["cpu"] * n_shards))(
        state_from_numpy(pos, vel, K, 0.0, dtype="float64", device="cpu"),
        params_from_numpy(**par, dtype="float64", device="cpu"), t(h0), args,
        driver.ML_SUBCHUNK)
    pos_r, stats_r, h_r = _ref_chunk()
    assert not bool(cert.any()) and bool(valid.all())
    np.testing.assert_allclose(st.pos.numpy(), pos_r, rtol=1e-8,
                               atol=1e-10 * np.abs(pos_r).max())
    np.testing.assert_allclose(stats.numpy(), stats_r, rtol=1e-7)
    np.testing.assert_allclose(h_last.numpy(), h_r, rtol=1e-12)


def test_joint_gravity_float32_within_the_float64_bar():
    """mlevel_sph_forces under p3m in float32 with joint_gravity=True (what
    the run loop passes; ROADMAP D21: phase B takes a close pair's term 1
    and term 2 as one float64 term, phase C leaves that pair out) against
    the reference's float64 evaluation (the module's cached call): the
    gravity corrections within 2e-5 of their scale, h within 1e-6 and rho
    1e-5 relative."""
    pos, vel, K, h0, spec, args = _plan("p3m")
    ref, ref_gcorr, ref_ok = _ref_forces("p3m", "polytropic")
    _, kw = _inputs("polytropic")
    red, gcorr, ok = TM.mlevel_sph_forces(
        *(t(a).float() for a in (pos, vel)), 1.0 / N_SCENE, t(K).float(), t(h0).float(), args,
        spec=spec, joint_gravity=True, **kw)
    assert ref_ok and bool(ok)
    np.testing.assert_allclose(red.h.double().numpy(), ref["h"], rtol=1e-6)
    np.testing.assert_allclose(red.rho.double().numpy(), ref["rho"], rtol=1e-5)
    for a, b in zip(gcorr, ref_gcorr):
        assert np.abs(a.double().numpy() - b).max() <= 2e-5 * np.abs(b).max()
