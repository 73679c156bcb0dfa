"""The work-sharded block and multi-level engines and the sharded run loop
over CPU shards.

Each engine runs work-sharded over 2 and 4 CPU shards (state replicated,
1/P of every work list a shard, per-row outputs psum-combined; K1, K5 and
K3's rows x columns entry in their plain versions). The plans are the
single-device ones: their lists are already multiples of the 2- and
4-shard granularity (BLK_GRAN 8, ACT_GRAN 32, the residual budget 256).

Against the reference's single-device engines at rtol 1e-9, atol 1e-13
(the bar of tests/test_shard_blocks.py and tests/test_shard_mlevel.py),
one module fixture a reference result:
- the block engine's 1-step chunk (exact gravity; pos, stats, h) against
  the reference's block chunk on a 1-in-100 subsample of
  bench_data/bb_collapsed.npz (Kh 16, h contrast cubed ~100);
- one evaluation of the multi-level engine (exact gravity, with its
  residual lane; every per-row output and the gravity corrections)
  against the reference's on the two-scale cloud of
  tests/port/test_torch_mlevel.py (N = 1 200, Kh 16), the call of that
  file's _ref_forces("exact", "polytropic");
- one P3M evaluation of the multi-level engine over 4 shards: its hydro
  outputs against the same reference evaluation (they do not depend on the
  gravity mode), its gravity against the exact softened direct sum
  (physics/oracle_bh.exact_gravity) at the bars of tests/test_mlevel.py's
  P3M test.

The block engine under P3M: one evaluation over 2 shards against the
port's single-device engine at the same bar, on the inputs on which
tests/port/test_torch_blocks.py::test_forces_f64_match_reference_and_gather
[core_halo-p3m-polytropic] holds that engine against the reference's (the
two-scale cloud N = 1 500, Kh 16, seed 17).

Then the freeze protocol of the work-sharded runner (a stale plan reports
cert_fail and the state stops), and run_simulation over four CPU shards on
boss_bodenheimer: sharded chunks, no fallback, snapshots the reference's
reader reads back, the refusals of n_devices > the visible cards and of
multihost without a process group."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import sphtpu.engine as ref_engine
import sphtpu.physics.blocks as RB
import sphtpu.physics.mlevel as RM
from sphtpu.io import read_snapshot as read_snapshot_ref
from sphtpu.io import snapshot_path as snapshot_path_ref
from sphtpu_torch.engine.config import EngineConfig, params_from_numpy, state_from_numpy
from sphtpu_torch.engine.driver import run_simulation
from sphtpu_torch.physics.blocks import block_args_to_device, block_forces_body, plan_blocks
from sphtpu_torch.physics.mesh_gravity import greens_hat, p3m_mesh_force
from sphtpu_torch.physics.mlevel import mlevel_args_to_device, mlevel_forces_body, plan_mlevel
from sphtpu_torch.physics.oracle_bh import exact_gravity
from sphtpu_torch.scenes import iniconds_setup
from sphtpu_torch.shard.blocks import make_blocks_chunk_runner
from sphtpu_torch.shard.collectives import particle_mesh, run_spmd

torch.set_num_threads(2)

BAR = dict(rtol=1e-9, atol=1e-13)
FIXTURE = os.path.join(os.path.dirname(__file__), "..", "..", "bench_data", "bb_collapsed.npz")
PHYS = dict(gamma=5 / 3, cs0=0.0, alpha=1.0, beta=2.0, U0=0.0, t_end=1e9)


def _two_scale(n, kh, seed, core_r=0.25):
    """tests/test_shard_blocks.py::_two_scale (as the sibling files draw it)."""
    rng = np.random.default_rng(seed)
    n_core = int(0.6 * n)

    def ball(count, radius):
        u = rng.random(count) ** (1 / 3)
        d = rng.standard_normal((count, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return d * (radius * u)[:, None]

    pos = np.concatenate([ball(n_core, core_r), ball(n - n_core, 1.0)])
    vel = 0.1 * rng.standard_normal((n, 3))
    d, _ = cKDTree(pos).query(pos, k=kh)
    return pos, vel, 1.0 + 0.1 * rng.random(n), d[:, -1] / 2.0, kh, 1.0 / n


def _collapse_subsample(step=100, kh=16):
    d = np.load(FIXTURE)
    pos = d["pos"][::step].astype(np.float64)
    dk, _ = cKDTree(pos).query(pos, k=kh)
    return (pos, d["vel"][::step].astype(np.float64), d["K"][::step].astype(np.float64),
            dk[:, -1] / 2.0, kh, float(d["m"]) * step)


# (state, engine) -> the state; "two_scale" is each engine's sibling file's cloud
STATES = {
    ("two_scale", "blocks"): lambda: _two_scale(1500, 16, 17),
    ("two_scale", "mlevel"): lambda: _two_scale(1200, 16, 5),
    ("collapse", "blocks"): _collapse_subsample,
}


def _inputs(state):
    pos, vel, K, h0, kh, m = state
    st = state_from_numpy(pos, vel, K, 0.0, dtype="float64", device="cpu")
    p = params_from_numpy(m, **PHYS, dtype="float64", device="cpu")
    return st, p, torch.as_tensor(h0)


def _plan(state, engine, gravity):
    pos, vel, K, h0, kh, m = state
    planner = plan_blocks if engine == "blocks" else plan_mlevel
    res = planner(pos, h0, kh, gravity=gravity)
    assert res is not None
    spec, args = res
    cfg = EngineConfig(n=len(pos), kh=kh, eos="polytropic", dtype="float64", gravity=gravity,
                       **{engine: spec})
    return cfg, args


def _ref_mlargs(args):
    return RM.MLArgs(
        act_a=tuple(tuple(jnp.asarray(b) for b in lvl) for lvl in args.act_a),
        act_b=tuple(tuple(jnp.asarray(b) for b in lvl) for lvl in args.act_b),
        act_c=None if args.act_c is None else tuple(jnp.asarray(b) for b in args.act_c),
        species=jnp.asarray(args.species),
    )


def _ref_chunk(state, args, spec):
    """The reference's single-device block chunk runner, 1 step, exact
    gravity: (pos, stats, h)."""
    pos, vel, K, h0, kh, m = state
    rargs = RB.BlockArgs(**{
        f: (tuple(jnp.asarray(b) for b in v) if isinstance(v, tuple) else jnp.asarray(v))
        for f, v in args._asdict().items()})
    cfg = ref_engine.EngineConfig(n=len(pos), kh=kh, eos="polytropic", dtype="float64",
                                  blocks=spec)
    jd = jnp.float64
    st, stats, valid, h, _, nfb = ref_engine.make_chunk_runner(cfg)(
        ref_engine.State(pos=jnp.asarray(pos), vel=jnp.asarray(vel), K=jnp.asarray(K),
                         t=jnp.asarray(0.0, jd)),
        ref_engine.Params(m=jnp.asarray(m, jd),
                          **{k: jnp.asarray(v, jd) for k, v in PHYS.items()}),
        jnp.asarray(h0), n_steps=1, mlargs=rargs,
    )
    assert int(np.asarray(nfb).sum()) == 0 and bool(np.asarray(valid).all())
    return np.asarray(st.pos), np.asarray(stats), np.asarray(h)


@pytest.fixture(scope="module")
def block_chunks():
    """The reference's 1-step block chunk on the collapse subsample and the
    work-sharded one over 2 and 4 CPU shards, exact gravity, on the same
    plan."""
    state = STATES[("collapse", "blocks")]()
    cfg, args = _plan(state, "blocks", "exact")
    ref = _ref_chunk(state, args, cfg.blocks)
    st, p, h = _inputs(state)
    out = {}
    for n_dev in (2, 4):
        o = make_blocks_chunk_runner(cfg, particle_mesh(["cpu"] * n_dev))(st, p, h, args, 1)
        assert bool(o[2].all()) and not bool(o[3].any())
        out[n_dev] = (o[0].pos.numpy(), o[1].numpy(), o[4].numpy())
    return ref, out


@pytest.mark.parametrize("n_dev", [2, 4])
def test_blocks_sharded_chunk_matches_single(block_chunks, n_dev):
    """The work-sharded block chunk (two evaluations, the KDK, dt and the
    diagnostics) on the collapse subsample against the reference's
    single-device block chunk."""
    ref, out = block_chunks
    for a, b, name in zip(out[n_dev], ref, ("pos", "stats", "h")):
        np.testing.assert_allclose(a, b, **BAR, err_msg=name)


def _engine_eval(state, engine, gravity, n_dev):
    """One force evaluation of the engine body: (acc, h, rho, visc, mu,
    div, gcorr) on one device (n_dev = 1) or combined over n_dev CPU
    shards."""
    cfg, args = _plan(state, engine, gravity)
    st, p, h = _inputs(state)
    args = (block_args_to_device(args, torch.float64, "cpu") if engine == "blocks"
            else mlevel_args_to_device(args, "cpu"))
    body = block_forces_body if engine == "blocks" else mlevel_forces_body
    kw = dict(eos=cfg.eos, gamma=p.gamma, cs0=p.cs0, alpha=p.alpha, beta=p.beta, kh=cfg.kh,
              spec=getattr(cfg, engine), mesh_factor=cfg.mesh_factor,
              sigma_cells=cfg.sigma_cells)
    if engine == "blocks":
        kw["gravity"] = gravity
    outs = run_spmd([
        body(st.pos, st.vel, p.m, st.K, h, args, shard=k, n_shards=n_dev, **kw)
        for k in range(n_dev)
    ])
    red, gcorr, ok = outs[0]
    assert all(bool(o[2]) for o in outs)
    return (red.acc, red.h, red.rho, red.visc_dk, red.mu_max, red.div_sum,
            torch.stack(gcorr))


HYDRO = ("acc", "h", "rho", "visc_dk", "mu_max", "div_sum")


@pytest.fixture(scope="module")
def mlevel_reference():
    """The reference's single-device multi-level evaluation (exact gravity)
    of the two-scale cloud: the call of
    tests/port/test_torch_mlevel.py::_ref_forces("exact", "polytropic")."""
    pos, vel, K, h0, kh, m = STATES[("two_scale", "mlevel")]()
    spec, args = RM.plan_mlevel(pos, h0, kh, gravity="exact")
    red, gcorr, ok = RM.mlevel_sph_forces(
        jnp.asarray(pos), jnp.asarray(vel), m, jnp.asarray(K), jnp.asarray(h0),
        _ref_mlargs(args), spec=spec, eos="polytropic", kh=kh,
        **{k: PHYS[k] for k in ("gamma", "cs0", "alpha", "beta")},
    )
    assert bool(ok)
    return ([np.asarray(getattr(red, f)) for f in HYDRO]
            + [np.stack([np.asarray(g) for g in gcorr])])


@pytest.mark.parametrize("n_dev", [2, 4])
def test_mlevel_sharded_eval_matches_reference(mlevel_reference, n_dev):
    """One evaluation of the work-sharded multi-level engine (exact gravity;
    phase A on K1's plain version, phases B and C and the residual lane on
    each shard's slice) against the reference's single-device engine."""
    out = _engine_eval(STATES[("two_scale", "mlevel")](), "mlevel", "exact", n_dev)
    for a, b, name in zip(out, mlevel_reference, HYDRO + ("gcorr",)):
        np.testing.assert_allclose(a.numpy(), b, **BAR, err_msg=name)


@pytest.mark.parametrize("n_dev", [4])
def test_mlevel_sharded_p3m_eval_tracks_reference(mlevel_reference, n_dev):
    """One P3M evaluation of the work-sharded multi-level engine: the hydro
    outputs do not depend on the gravity mode, so they equal the
    reference's exact-gravity evaluation at the bar; the gravity (the
    mesh and the engine's near-field corrections) tracks the exact
    softened direct sum (physics/oracle_bh.exact_gravity) to the bars of
    tests/test_mlevel.py's P3M test: the RMS force error under 2e-3 of
    the RMS |g|, phi under 1e-3 RMS relative."""
    state = STATES[("two_scale", "mlevel")]()
    cfg, _ = _plan(state, "mlevel", "p3m")
    out = _engine_eval(state, "mlevel", "p3m", n_dev)
    for a, b, name in zip(out, mlevel_reference, HYDRO):
        np.testing.assert_allclose(a.numpy(), b, **BAR, err_msg=name)
    pos, m = torch.as_tensor(state[0]), state[5]
    ghat = greens_hat(cfg.mesh_pad, cfg.sigma_cells, torch.float64, "cpu")
    gfar, phifar = p3m_mesh_force(pos, m, ghat, gm=cfg.mesh_gm, pad=cfg.mesh_pad)
    g = (gfar + out[6][:3].T).numpy()
    phi = (phifar + out[6][3]).numpy()
    ge, phie = exact_gravity(state[0], out[1].numpy(), m)
    rms = np.sqrt((ge**2).sum(1).mean())
    assert np.sqrt(((g - ge) ** 2).sum(1).mean()) < 2e-3 * rms
    assert np.sqrt((((phi - phie) / phie) ** 2).mean()) < 1e-3


@pytest.fixture(scope="module")
def single_evals():
    cache = {}

    def get(state, engine, gravity):
        if (state, engine, gravity) not in cache:
            cache[(state, engine, gravity)] = _engine_eval(
                STATES[(state, engine)](), engine, gravity, 1)
        return cache[(state, engine, gravity)]

    return get


@pytest.mark.parametrize("n_dev", [2])
@pytest.mark.parametrize("state,engine,gravity", [("two_scale", "blocks", "p3m")])
def test_workshard_eval_matches_single(single_evals, state, engine, gravity, n_dev):
    """One P3M evaluation of the work-sharded block engine (K1 and K5 on
    each shard's slice of every bucket, psum-combined) against the same
    engine on one device, on the inputs on which
    tests/port/test_torch_blocks.py holds that engine against the
    reference's (its core_halo cloud under P3M)."""
    one = single_evals(state, engine, gravity)
    sharded = _engine_eval(STATES[(state, engine)](), engine, gravity, n_dev)
    for a, b in zip(sharded, one):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **BAR)


def test_workshard_stale_plan_freezes():
    """A block plan made for another state fails its collective
    certificate: the step reports cert_fail and the state stays."""
    pos, vel, K, h0, kh, m = _two_scale(1000, 16, 11)
    spec, args = plan_blocks(pos, h0, kh, gravity="exact", shards=4)
    cfg = EngineConfig(n=len(pos), kh=kh, eos="polytropic", dtype="float64", blocks=spec)
    st, p, h = _inputs((pos * 1.6, vel, K, h0, kh, m))
    out = make_blocks_chunk_runner(cfg, particle_mesh(["cpu"] * 2))(st, p, h, args, 2)
    assert bool(out[3][0]) and not bool(out[2].any())
    assert torch.equal(out[0].pos, st.pos)


@pytest.fixture(scope="module")
def bb_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bb"))
    iniconds_setup("polytropic", "boss_bodenheimer", root=root, N=1200, Kh=16)
    return root


def test_run_simulation_four_cpu_shards(bb_root):
    res = run_simulation(
        "polytropic", "boss_bodenheimer", snap_interval=2, keep_snaps=False,
        show_plots=False, root=bb_root, dtype="float64", n_devices=4, max_steps=2,
        verbose=False, device="cpu",
    )
    assert res["steps"] == 2
    assert res["sharded_chunks"] >= 1 and res["single_chunks"] == 0
    assert res["fallback_evals"] == 0 and res["n_devices"] == 4
    assert set(res["chunk_engines"]) == {"slabs"}
    assert np.isfinite(res["last_stats_cgs"]).all()
    snap = read_snapshot_ref(snapshot_path_ref(bb_root, "boss_bodenheimer",
                                               str(res["snapshot_ids"][-1])))
    assert snap["pos"].shape == (1200, 3) and np.isfinite(snap["pos"]).all()
    assert snap["K"] is not None
    np.testing.assert_allclose(snap["pos"] / res["units"].L, res["state"].pos.numpy(),
                               rtol=1e-6, atol=1e-9)


def test_run_simulation_refusals(bb_root):
    kw = dict(snap_interval=2, keep_snaps=False, show_plots=False, root=bb_root,
              max_steps=1, verbose=False)
    with pytest.raises(ValueError, match="visible"):
        run_simulation("polytropic", "boss_bodenheimer", n_devices=64, **kw)
    with pytest.raises(ValueError, match="torch.distributed"):  # no process group formed
        run_simulation("polytropic", "boss_bodenheimer", multihost=True, device="cpu", **kw)
    with pytest.raises(ValueError):
        run_simulation("polytropic", "boss_bodenheimer", n_devices=3,
                       devices=["cpu", "cpu"], **kw)
