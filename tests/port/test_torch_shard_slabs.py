"""The z-slab tile engine and the all-gather step over CPU shards.

The port's slab engine (kernels K4, K2 and the P3M tail in their plain
versions on the CPU, the far field on K3's rows x columns entry's) runs
float64 chunks of the sphere of tests/test_shard_tiles.py at N = 1 200,
Kh 16 (grid 5, cap 32) at 2 shards (hops 1) and 4 shards (hops 3), held
to the reference's single-device tile chunk (sphtpu.engine.make_chunk_runner,
the plan's (grid, cap)) at rtol 1e-9, atol 1e-13 on pos, stats and h: the
bar of tests/test_shard_tiles.py. Polytropic: 2 steps at 2 and 4 shards;
isothermal: 1 step at 2 shards. One reference chunk per EOS (a module
fixture) is shared by the cases: their compiles are most of this file's
time.

Under P3M the slab engine puts the mesh on the global half-width and bins
the tail with the plan's frozen cells (ROADMAP D14), so it is not the
reference's slab engine bit for bit, nor the single-device engine: one
evaluation at 2 and 4 shards is held to itself across the shard counts at
the bar, and its gravity to the exact softened direct sum
(physics/oracle_bh.exact_gravity) at the bars of the reference's
tests/test_shard_tiles.py::test_sharded_p3m_matches_softened_oracle.

shard/step.py (the all-gather form, the slab engine's oracle) runs the
same 2-step chunk at 2 and 4 shards against the same reference output.
Then the freeze protocol: a plan whose halo budget is too small fails its
certificate, reports cert_fail, and leaves the state where it was."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from sphtpu.engine import EngineConfig as EngineConfigRef
from sphtpu.engine import Params as ParamsRef
from sphtpu.engine import State as StateRef
from sphtpu.engine import make_chunk_runner as make_chunk_runner_ref
from sphtpu_torch.engine.config import EngineConfig, params_from_numpy, state_from_numpy
from sphtpu_torch.physics.mesh_gravity import greens_hat
from sphtpu_torch.physics.oracle_bh import exact_gravity
from sphtpu_torch.shard.collectives import particle_mesh, run_spmd
from sphtpu_torch.shard.step import make_sharded_chunk_runner, shard_state, unshard_state
from sphtpu_torch.shard.tiles import (
    make_slab_chunk_runner,
    make_slab_force_eval,
    pack_state,
    plan_slabs,
    unpack_rows,
    unpack_state,
)

torch.set_num_threads(2)

N, KH, STEPS = 1200, 16, 2
PARAMS = dict(m=1.0 / 10000, gamma=5.0 / 3.0, cs0=0.08, alpha=1.0, beta=2.0, U0=0.0, t_end=1e9)
BAR = dict(rtol=1e-9, atol=1e-13)


def _sphere():
    rng = np.random.default_rng(7)
    u = rng.random((N, 3))
    r = u[:, 0] ** (1 / 3)
    costh = 2 * u[:, 1] - 1
    phi = 2 * np.pi * u[:, 2]
    sinth = np.sqrt(1 - costh**2)
    pos = np.stack([r * sinth * np.cos(phi), r * sinth * np.sin(phi), r * costh], axis=1)
    vel = 0.05 * rng.standard_normal((N, 3))
    K = 0.02 + 0.002 * rng.random(N)
    d, _ = cKDTree(pos).query(pos, k=KH)
    return pos, vel, K, d[:, -1] / 2.0


POS, VEL, K, H0 = _sphere()


def _state():
    return state_from_numpy(POS, VEL, K, 0.0, dtype="float64", device="cpu")


def _params():
    return params_from_numpy(**PARAMS, dtype="float64", device="cpu")


def _cfg(eos="polytropic", gravity="exact"):
    plan = plan_slabs(POS, H0, KH, 2)
    return EngineConfig(n=N, kh=KH, eos=eos, dtype="float64", tile=(plan.grid, plan.cap),
                        gravity=gravity)


def _slab_chunk(n_dev, cfg, steps=STEPS):
    plan = plan_slabs(POS, H0, KH, n_dev)
    assert (plan.grid, plan.cap) == cfg.tile
    mesh = particle_mesh(["cpu"] * n_dev)
    states, stats, valid, cert, h_rows, _ = make_slab_chunk_runner(cfg, plan, mesh)(
        pack_state(_state(), plan, mesh), _params(), steps
    )
    assert bool(valid.all()) and not bool(cert.any())
    h = unpack_rows(torch.cat(h_rows).numpy(), plan, N)
    return unpack_state(states, plan, N).pos.numpy(), stats.numpy(), h, plan


def _reference_chunk(eos, steps):
    """The reference's single-device tile chunk, exact gravity: (pos,
    stats, h)."""
    plan = plan_slabs(POS, H0, KH, 2)
    cfg = EngineConfigRef(n=N, kh=KH, eos=eos, dtype="float64", tile=(plan.grid, plan.cap))
    jd = jnp.float64
    st = StateRef(jnp.asarray(POS, jd), jnp.asarray(VEL, jd), jnp.asarray(K, jd),
                  jnp.asarray(0.0, jd))
    p = ParamsRef(**{k: jnp.asarray(v, jd) for k, v in PARAMS.items()})
    st2, stats, valid, h, _, nfb = make_chunk_runner_ref(cfg)(st, p, jnp.asarray(H0),
                                                              n_steps=steps)
    assert int(np.asarray(nfb).sum()) == 0 and bool(np.asarray(valid).all())
    return np.asarray(st2.pos), np.asarray(stats), np.asarray(h)


@pytest.fixture(scope="module")
def reference_exact():
    """The reference's single-device tile chunk, exact gravity, polytropic."""
    return _reference_chunk("polytropic", STEPS)


@pytest.mark.parametrize("n_dev,hops", [(2, 1), (4, 3)])
def test_slab_chunk_exact_matches_reference(reference_exact, n_dev, hops):
    pos, stats, h, plan = _slab_chunk(n_dev, _cfg())
    assert plan.hops == hops
    pos_r, stats_r, h_r = reference_exact
    np.testing.assert_allclose(stats, stats_r, **BAR)
    np.testing.assert_allclose(pos, pos_r, **BAR)
    np.testing.assert_allclose(h, h_r, **BAR)


def _slab_eval(cfg, n_dev, ghat):
    """One evaluation over n_dev shards: acc, h, g, phi as row arrays."""
    plan = plan_slabs(POS, H0, KH, n_dev)
    mesh = particle_mesh(["cpu"] * n_dev)
    ev = make_slab_force_eval(cfg, plan)
    p = _params()
    res = run_spmd([ev(p, k, s.pos, s.vel, s.K, s.valid, ghat)
                    for k, s in enumerate(pack_state(_state(), plan, mesh))])
    assert all(bool(r[2]) for r in res)
    return [unpack_rows(torch.cat(x).numpy(), plan, N) for x in (
        [r[0] for r in res], [r[1]["h"] for r in res], [r[1]["g"] for r in res],
        [r[1]["phi"] for r in res],
    )]


def test_slab_chunk_isothermal_matches_reference():
    """The isothermal EOS: a 1-step chunk on 2 shards against the
    reference's single-device isothermal tile chunk."""
    pos, stats, h, _ = _slab_chunk(2, _cfg("isothermal"), steps=1)
    for a, b, name in zip((pos, stats, h), _reference_chunk("isothermal", 1),
                          ("pos", "stats", "h")):
        np.testing.assert_allclose(a, b, **BAR, err_msg=name)


def test_slab_force_eval_p3m_force_level():
    """One P3M evaluation: 2 and 4 shards agree at the bar (the mesh and the
    tail follow the global half-width and the plan's cells, not the shard
    count), and the gravity that acc subtracts tracks the exact softened
    direct sum at the evaluation's own h: the RMS force error under 2e-3
    of the RMS |g|, phi within 2e-3 of the largest |phi|."""
    cfg = _cfg("polytropic", "p3m")
    ghat = greens_hat(cfg.mesh_pad, cfg.sigma_cells, torch.float64, "cpu")
    s2, s4 = _slab_eval(cfg, 2, ghat), _slab_eval(cfg, 4, ghat)
    for a, b in zip(s2, s4):
        np.testing.assert_allclose(a, b, **BAR)
    _, h, g, phi = s4
    ge, phie = exact_gravity(POS, h, PARAMS["m"])
    rms = np.sqrt((ge**2).sum(1).mean())
    assert np.sqrt(((g - ge) ** 2).sum(1).mean()) < 2e-3 * rms
    assert np.abs(phi - phie).max() < 2e-3 * np.abs(phie).max()


@pytest.mark.parametrize("n_dev", [2, 4])
def test_allgather_step_matches_reference(reference_exact, n_dev):
    """shard/step.py: every shard sweeps its N/P rows against the gathered
    set (kNN, pair forces, softened gravity), the pair scatter comes back
    by reduce-scatter."""
    cfg = EngineConfig(n=N, kh=KH, eos="polytropic", dtype="float64")
    mesh = particle_mesh(["cpu"] * n_dev)
    states, stats, valid = make_sharded_chunk_runner(cfg, mesh)(
        shard_state(_state(), mesh), _params(), STEPS
    )
    assert bool(valid.all())
    pos_r, stats_r, _ = reference_exact
    np.testing.assert_allclose(stats.numpy(), stats_r, **BAR)
    np.testing.assert_allclose(unshard_state(states).pos.numpy(), pos_r, **BAR)


def test_slab_cert_fail_freezes_state():
    """An under-budgeted plan must freeze the chunk (no state change) and
    report cert_fail, never commit a step."""
    plan = plan_slabs(POS, H0, KH, 4)
    assert plan.budget > 256
    bad = dataclasses.replace(plan, budget=256)
    mesh = particle_mesh(["cpu"] * 4)
    sl = pack_state(_state(), bad, mesh)
    sl2, stats, valid, cert, _, _ = make_slab_chunk_runner(_cfg(), bad, mesh)(sl, _params(), 2)
    assert bool(cert[0]) and not bool(valid.any())
    for a, b in zip(sl, sl2):
        assert torch.equal(a.pos, b.pos) and torch.equal(a.K, b.K)


def _slab_gcorr(dtype, joint_gravity, n_dev=2):
    """One P3M evaluation over n_dev shards at `dtype` with the far field
    left out (the mesh solve runs, its result is dropped): g and phi are
    then the near-field corrections that K2 and the tail sum, as row
    arrays (gx, gy, gz, phi)."""
    import sphtpu_torch.shard.tiles as shard_tiles

    cfg = dataclasses.replace(_cfg("polytropic", "p3m"),
                              dtype={torch.float32: "float32", torch.float64: "float64"}[dtype])
    plan = plan_slabs(POS, H0, KH, n_dev)
    mesh = particle_mesh(["cpu"] * n_dev)
    ev = make_slab_force_eval(cfg, plan, joint_gravity=joint_gravity)
    p = params_from_numpy(**PARAMS, dtype=cfg.dtype, device="cpu")
    ghat = greens_hat(cfg.mesh_pad, cfg.sigma_cells, dtype, "cpu")
    mesh_far = shard_tiles._p3m_mesh_sharded

    def near_only(*a, **kw):
        g, phi = yield from mesh_far(*a, **kw)
        return torch.zeros_like(g), torch.zeros_like(phi)

    shard_tiles._p3m_mesh_sharded = near_only
    try:
        st = state_from_numpy(POS, VEL, K, 0.0, dtype=cfg.dtype, device="cpu")
        res = run_spmd([ev(p, k, s.pos, s.vel, s.K, s.valid, ghat)
                        for k, s in enumerate(pack_state(st, plan, mesh))])
    finally:
        shard_tiles._p3m_mesh_sharded = mesh_far
    assert all(bool(r[2]) for r in res)
    g = unpack_rows(torch.cat([r[1]["g"] for r in res]).double().numpy(), plan, N)
    phi = unpack_rows(torch.cat([r[1]["phi"] for r in res]).double().numpy(), plan, N)
    return [g[:, 0], g[:, 1], g[:, 2], phi]


def test_slab_joint_gravity_float32_within_the_float64_bar():
    """ROADMAP D21 on the slab engine: one P3M evaluation over 2 shards in
    float32 with joint_gravity=True (what the run loop passes: K2's joint
    mode, the tail's skip mode, with the halo rows' h from the exchange)
    against the same evaluation in float64 (the two sweeps, as the
    reference adds them; its force level is
    test_slab_force_eval_p3m_force_level's): the near-field gravity
    corrections within 2e-5 of their scale, the bar of the mono and
    multi-level engines' cases. A pair counted in both kernels or in
    neither would miss it by orders of magnitude (its term 1 and term 2
    each carry the pair's 1/r^2)."""
    ref = _slab_gcorr(torch.float64, False)
    for a, b in zip(_slab_gcorr(torch.float32, True), ref):
        assert np.abs(a - b).max() <= 2e-5 * np.abs(b).max()
