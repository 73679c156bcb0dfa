"""The slice as a whole: chunk runner of the port vs the JAX package.

Same numpy state through `sphtpu.engine.make_chunk_runner` (Pallas kernels
interpreted on the CPU) and `sphtpu_torch.engine.make_chunk_runner` with
device="cpu". f64, rtol 1e-8: the two differ by reduction order only."""

import dataclasses
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import sphtpu.engine as ref_engine
from sphtpu.physics.ctiles import choose_tile_classes
from sphtpu_torch import cli
from sphtpu.physics.tiles import choose_tile_params
from sphtpu.scenes.generators import boss_bodenheimer
from sphtpu_torch.engine import (
    EngineConfig,
    config_from_reference,
    make_chunk_runner,
    params_from_numpy,
    state_from_numpy,
)
from sphtpu_torch.engine.step import force_eval

# the suite runs several pytest workers per machine: keep torch's intra-op
# pool from oversubscribing the cores they share
torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _free_reference_caches():
    """When the module is done, drop its cached JAX results and compiled
    programs, so that the test worker does not carry them into the tests it
    runs next."""
    yield
    _ref_runner.cache_clear()
    jax.clear_caches()
    gc.collect()


N, KH, STEPS = 1500, 12, 3
PARAMS = dict(m=1.0 / N, gamma=5 / 3, cs0=0.6, alpha=1.0, beta=2.0, U0=0.3, t_end=1e9)


def _two_scale_ball(n, seed=4):
    rng = np.random.default_rng(seed)
    n_core = n // 3
    u = rng.random(n) ** (1 / 3)
    u[:n_core] *= 0.6
    dirs = rng.standard_normal((n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return u[:, None] * dirs, 0.3 * rng.standard_normal((n, 3))


@pytest.fixture(scope="module")
def scene():
    pos, vel = _two_scale_ball(N)
    d, _ = cKDTree(pos).query(pos, k=KH)
    h0 = d[:, -1] / 2
    K = 1.0 + 0.2 * np.random.default_rng(1).random(N)
    return pos, vel, K, h0, choose_tile_classes(pos, h0, KH)


def _ref_cfg(scene, eos, engine, fallback="gather", starve=False):
    g, cap, classes = scene[4]
    if starve:
        classes = tuple((ck, 8) for ck, _ in classes)
    tile = dict(tile=(g, cap), tile_classes=classes) if engine == "ctiles" else {}
    return ref_engine.EngineConfig(
        n=N, kh=KH, eos=eos, dtype="float64", gravity="exact",
        fallback=fallback, **tile,
    )


@functools.lru_cache(maxsize=None)
def _ref_runner(cfg_ref):
    """One jitted reference runner per config: a second compile of the
    same program would cost more than every port-side run here."""
    return ref_engine.make_chunk_runner(cfg_ref)


def _run_both(scene, cfg_ref, steps=STEPS, t_end=1e9):
    pos, vel, K, h0, _ = scene
    par = dict(PARAMS, t_end=t_end)
    jd = jnp.float64
    out_r = _ref_runner(cfg_ref)(
        ref_engine.State(
            pos=jnp.asarray(pos, jd), vel=jnp.asarray(vel, jd),
            K=jnp.asarray(K, jd), t=jnp.asarray(0.0, jd),
        ),
        ref_engine.Params(**{k: jnp.asarray(v, jd) for k, v in par.items()}),
        jnp.asarray(h0, jd), n_steps=steps,
    )
    cfg = config_from_reference(dataclasses.asdict(cfg_ref))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_ref)
    out = make_chunk_runner(cfg, device="cpu")(
        state_from_numpy(pos, vel, K, 0.0, dtype="float64", device="cpu"),
        params_from_numpy(**par, dtype="float64", device="cpu"),
        torch.from_numpy(h0), steps,
    )
    return out, out_r


def _assert_chunks_equal(out, out_r, rtol=1e-8):
    state, stats, valid, h_last, rho_last, nfb = out
    state_r, stats_r, valid_r, h_r, rho_r, nfb_r = out_r
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_r))
    np.testing.assert_array_equal(nfb.numpy(), np.asarray(nfb_r))
    for name in ("pos", "vel", "K", "t"):
        b = np.asarray(getattr(state_r, name))
        np.testing.assert_allclose(
            getattr(state, name).numpy(), b, rtol=rtol,
            atol=1e-11 * max(np.abs(b).max(), 1e-300), err_msg=name,
        )
    stats_r = np.asarray(stats_r)
    assert stats.shape == stats_r.shape == (len(valid), 10)
    # |p| and |L| of a near-symmetric ball are cancellation residues:
    # compare every column on the scale of the row's energies
    scale = np.abs(stats_r[:, 1:5]).max() + 1e-300
    np.testing.assert_allclose(stats.numpy(), stats_r, rtol=rtol, atol=1e-10 * scale)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(h_r), rtol=rtol)
    np.testing.assert_allclose(rho_last.numpy(), np.asarray(rho_r), rtol=rtol)


@pytest.mark.parametrize(
    "eos,engine",
    [("polytropic", "ctiles"), ("isothermal", "gather"), ("polytropic", "gather")],
)
def test_chunk_matches_reference(scene, eos, engine):
    out, out_r = _run_both(scene, _ref_cfg(scene, eos, engine))
    assert out[2].all() and int(out[5].sum()) == 0
    _assert_chunks_equal(out, out_r)


def _run_port(scene, cfg_ref, steps, **kw):
    pos, vel, K, h0, _ = scene
    cfg = config_from_reference(dataclasses.asdict(cfg_ref))
    return make_chunk_runner(cfg, device="cpu")(
        state_from_numpy(pos, vel, K, 0.0, dtype="float64", device="cpu"),
        params_from_numpy(**PARAMS, dtype="float64", device="cpu"),
        torch.from_numpy(h0), steps, **kw,
    )


def test_chunk_fallback_gather_is_the_gather_engine(scene):
    """A starved class list fails `fits`: every evaluation falls back and
    the trajectory is the gather engine's own (whose parity with the
    reference is pinned above) — the certificate costs speed, never
    physics."""
    out = _run_port(scene, _ref_cfg(scene, "polytropic", "ctiles", starve=True), 2)
    out_g = _run_port(scene, _ref_cfg(scene, "polytropic", "gather"), 2)
    assert out[5].tolist() == [2, 2] and out_g[5].tolist() == [0, 0]
    assert out[2].tolist() == [True, True]
    for a, b in zip(out[0], out_g[0]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(out[1].numpy(), out_g[1].numpy())


def test_chunk_fallback_none_matches_reference(scene):
    """fallback="none" with a failing certificate: the step is discarded
    (state unchanged, stats zeroed, rho zeroed, h = the hint) and — as the
    reference does — still reported valid."""
    out, out_r = _run_both(
        scene,
        _ref_cfg(scene, "polytropic", "ctiles", fallback="none", starve=True),
        steps=2,
    )
    _assert_chunks_equal(out, out_r)
    state, stats, valid, h_last, rho_last, nfb = out
    assert nfb.tolist() == [2, 2] and valid.tolist() == [True, True]
    assert float(state.t) == 0.0 and not stats.any() and not rho_last.any()
    np.testing.assert_array_equal(state.pos.numpy(), scene[0])
    np.testing.assert_array_equal(h_last.numpy(), scene[3])


def test_chunk_freezes_at_t_end_and_pads_scan_length(scene):
    out, out_r = _run_both(
        scene, _ref_cfg(scene, "polytropic", "gather"), steps=3, t_end=1e-4
    )
    _assert_chunks_equal(out, out_r)
    assert out[2].tolist() == [True, False, False]
    pos, vel, K, h0, _ = scene
    cfg = EngineConfig(n=N, kh=KH, eos="polytropic", dtype="float64")
    chunk = make_chunk_runner(cfg, device="cpu")
    res = chunk(
        state_from_numpy(pos, vel, K, 0.0, dtype="float64", device="cpu"),
        params_from_numpy(**PARAMS, dtype="float64", device="cpu"),
        torch.from_numpy(h0), 1, scan_length=4,
    )
    assert res[1].shape == (4, 10) and res[2].tolist() == [True, False, False, False]
    with pytest.raises(ValueError):
        chunk(res[0], params_from_numpy(**PARAMS, dtype="float64", device="cpu"),
              res[3], 5, scan_length=4)


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(blocks=((), (), (), 8)), "mlargs"),
        (dict(mlevel=((), 0, 0, ())), "mlargs"),
    ],
)
def test_unported_engines_raise(kw, match):
    """Every engine of the single-device path is ported, the outlier lane
    included: the block and multi-level engines without their BlockArgs or
    MLArgs (mlargs) make force_eval raise ValueError, as the reference
    does."""
    cfg = EngineConfig(n=8, kh=4, eos="polytropic", dtype="float64", **kw)
    z = torch.zeros((8, 3), dtype=torch.float64)
    p = params_from_numpy(**PARAMS, dtype="float64", device="cpu")
    with pytest.raises(ValueError, match=match):
        force_eval(cfg, p, z, z, z[:, 0], z[:, 0], device="cpu")


@pytest.mark.parametrize(
    "kw",
    [
        dict(eos="adiabatic"),
        dict(fallback="maybe"),
        dict(gravity="tree"),
        dict(gravity="p3m"),
        dict(tile=(4, 32), mlevel=((), 0, 0, ())),
        dict(tile_classes=((32, 8),)),
        dict(tile=(4, 32), tile_classes=((32, 8),), outlier_budget=64),
        dict(tile=(4, 32), tile_classes=((32, 8),), gravity="p3m"),
    ],
)
def test_config_rules_match_reference(kw):
    base = dict(n=8, kh=4, eos="polytropic")
    with pytest.raises(ValueError):
        ref_engine.EngineConfig(**{**base, **kw})
    with pytest.raises(ValueError):
        EngineConfig(**{**base, **kw})


def test_config_p3m_classes_need_one_cell_stencil():
    ok = EngineConfig(
        n=8, kh=4, eos="polytropic", tile=(4, 32), tile_classes=((32, 8),),
        gravity="p3m", mesh_factor=10,
    )
    assert ok.c_halfwidth == 1 and ok.mesh_gm == 40
    assert EngineConfig(n=8, kh=4, eos="polytropic").c_halfwidth == 2
    assert ok.torch_dtype == torch.float32


def test_f64_host_values_round_once_to_f32():
    x = np.array([[0.1, 1.0 / 3.0, 2.0 / 3.0]])
    st = state_from_numpy(x, x, x[0], 0.1, dtype="float32", device="cpu")
    np.testing.assert_array_equal(st.pos.numpy(), np.asarray(jnp.asarray(x, jnp.float32)))
    assert st.t.dtype == torch.float32 and st.t.shape == ()


def test_p3m_mono_chunk_matches_reference():
    """The P3M path as a whole: three steps of the mono-tile engine with the
    FFT mesh and the W = 2 tail (the default mesh_factor 5), f64, against
    the reference's chunk runner on a boss_bodenheimer cloud of 2000
    particles. The two differ by reduction order only."""
    n, kh = 2000, 12
    rng = np.random.default_rng(7)
    pos, vel, _ = boss_bodenheimer(n, 1.0, 1.0, rng=rng)
    K = 1.0 + 0.1 * rng.random(n)
    d, _ = cKDTree(pos).query(pos, k=kh)
    h0 = d[:, -1] / 2
    tile = choose_tile_params(pos, h0, kh, headroom=1.5)
    cfg_ref = ref_engine.EngineConfig(
        n=n, kh=kh, eos="polytropic", dtype="float64", tile=tile, gravity="p3m"
    )
    assert cfg_ref.c_halfwidth == 2 and cfg_ref.tile_classes is None
    par = dict(PARAMS, m=1.0 / n)
    jd = jnp.float64
    out_r = ref_engine.make_chunk_runner(cfg_ref)(
        ref_engine.State(
            pos=jnp.asarray(pos, jd), vel=jnp.asarray(vel, jd),
            K=jnp.asarray(K, jd), t=jnp.asarray(0.0, jd),
        ),
        ref_engine.Params(**{k: jnp.asarray(v, jd) for k, v in par.items()}),
        jnp.asarray(h0, jd), n_steps=STEPS,
    )
    cfg = config_from_reference(dataclasses.asdict(cfg_ref))
    assert cfg.mesh_pad == cfg_ref.mesh_pad and cfg.mesh_gm == cfg_ref.mesh_gm
    out = make_chunk_runner(cfg, device="cpu")(
        state_from_numpy(pos, vel, K, 0.0, dtype="float64", device="cpu"),
        params_from_numpy(**par, dtype="float64", device="cpu"),
        torch.from_numpy(h0), STEPS,
    )
    assert out[2].all() and int(out[5].sum()) == 0
    _assert_chunks_equal(out, out_r)


@pytest.mark.parametrize("gravity", ["exact", "p3m"])
@pytest.mark.parametrize("kh", [12, 24, 40])
def test_plan_engine_follows_the_reference_ladder(scene, gravity, kh):
    """run_simulation's fresh plan: the class-compacted engine (exact gravity
    only, the reference's cap <= 128) when its planner fits, else the
    mono-tile engine (cap <= 256), else the block-compact engine — the
    reference's rungs, planned by its own host planners. On this ball kh 12
    plans classes, kh 24 needs cap 160, kh 40 more than 256 (blocks)."""
    from sphtpu.physics.blocks import plan_blocks as blocks_ref
    from sphtpu.physics.ctiles import choose_tile_classes as classes_ref
    from sphtpu_torch.engine.driver import plan_engine

    pos = scene[0]
    d, _ = cKDTree(pos).query(pos, k=kh)
    h = d[:, -1] / 2
    cfg, bargs = plan_engine(pos, h, n=N, kh=kh, eos="polytropic", dtype="float64",
                             gravity=gravity)
    cls = classes_ref(pos, h, kh, headroom=1.5) if gravity == "exact" else None
    mono = choose_tile_params(pos, h, kh, headroom=1.5)
    assert (cls is not None) == (kh == 12 and gravity == "exact")
    assert (mono is None) == (kh == 40)
    if cls is not None:
        assert (cfg.tile, cfg.tile_classes) == ((cls[0], cls[1]), cls[2])
    elif mono is not None:
        assert cfg.tile == mono and cfg.tile_classes is None
    else:
        blk = blocks_ref(pos, h, kh, gravity=gravity)
        assert cfg.blocks == blk[0] and cfg.tile is None
        np.testing.assert_array_equal(bargs.order_q, blk[1].order_q)
    assert (bargs is None) == (cfg.blocks is None)
    assert cfg.gravity == gravity


# ------------------------------------------- a chunk ends at its first fallback
def _stale_after_first_step(scene, monkeypatch):
    """From the third force evaluation on (the second step), the class
    engine is given the starved class list of `_ref_cfg(starve=True)`: a
    stale plan whose certificate fails."""
    import sphtpu_torch.engine.step as step_mod

    starved = _ref_cfg(scene, "polytropic", "ctiles", starve=True).tile_classes
    orig = step_mod.ctile_sph_forces
    calls = []

    def stale(*a, classes, **kw):
        calls.append(classes)
        return orig(*a, classes=starved if len(calls) > 2 else classes, **kw)

    monkeypatch.setattr(step_mod, "ctile_sph_forces", stale)


@pytest.mark.parametrize("fallback", ["gather", "none"])
def test_chunk_stops_at_first_fallback(scene, monkeypatch, fallback):
    """stop_at_fallback=True (ROADMAP D20): a 4-step chunk whose plan goes
    stale after step 1 ends at step 2, the step that fell back. It equals
    the reference's chunk cut there, to _assert_chunks_equal's bars: under
    "gather" its first 2 steps (the certified step and the step the
    fallback computes are both the gather engine's function: the
    reference's gather config, its runner of STEPS steps run for 2), valid;
    under "none" its first step, then the discarded step (state and h those
    of step 1, stats and rho zeroed), which alone is not valid. Steps 3 and
    4 do not run."""
    pos, vel, K, h0, _ = scene
    _stale_after_first_step(scene, monkeypatch)
    cfg_ref = _ref_cfg(scene, "polytropic", "ctiles", fallback=fallback)
    out = make_chunk_runner(config_from_reference(dataclasses.asdict(cfg_ref)), device="cpu",
                            stop_at_fallback=True)(
        state_from_numpy(pos, vel, K, 0.0, dtype="float64", device="cpu"),
        params_from_numpy(**PARAMS, dtype="float64", device="cpu"), torch.from_numpy(h0), 4)
    assert out[5].tolist() == [0, 2, 0, 0]
    assert out[2].tolist() == [True, fallback == "gather", False, False]
    assert not out[1][2:].any()

    jd = jnp.float64
    k = 2 if fallback == "gather" else 1
    ref = _ref_runner(_ref_cfg(scene, "polytropic", "gather"))(
        ref_engine.State(pos=jnp.asarray(pos, jd), vel=jnp.asarray(vel, jd),
                         K=jnp.asarray(K, jd), t=jnp.asarray(0.0, jd)),
        ref_engine.Params(**{k_: jnp.asarray(v, jd) for k_, v in PARAMS.items()}),
        jnp.asarray(h0, jd), n_steps=k, scan_length=STEPS)
    stats = np.zeros((4, 10))
    stats[:k] = np.asarray(ref[1])[:k]
    rho = np.asarray(ref[4]) if fallback == "gather" else np.zeros(N)
    _assert_chunks_equal(out, (ref[0], stats, out[2].numpy(), ref[3], rho,
                               np.array([0, 2, 0, 0])))


def test_run_simulation_replans_after_a_fallback(tmp_path, monkeypatch):
    """run_simulation on the CPU with the second chunk's plan starved (its
    cached config is made to look stale once, and the fresh plan is a class
    list far too small): that chunk ends at its first step, whose two
    evaluations fell back, and the next chunk takes the run loop's own plan
    again; the run reaches max_steps = 5 with 2 fallback evaluations and the
    snapshots of the cadence (1, then every 3 steps, then the last: the
    ids of a run without the repair, whose second chunk would run all 3 of
    its steps on the gather engine)."""
    from sphtpu_torch.engine import driver

    root = str(tmp_path)
    common = ["--EOS", "polytropic", "--ic_type", "boss_bodenheimer", "--root", root]
    assert cli.main(["--generate", *common, "--kwargs", "N=1000,Kh=24"]) == 0
    starved, checks = [], []
    real_plan, real_ok = driver.plan_engine, driver.tile_params_still_ok

    def plan(*a, **kw):
        got = real_plan(*a, **kw)
        assert got is not None and got[0].tile is not None, "the scene plans a tile engine"
        if not starved and checks:  # the second chunk's plan
            c = got[0]
            starved.append(EngineConfig(n=c.n, kh=c.kh, eos=c.eos, dtype=c.dtype,
                                        tile=(3, 32), tile_classes=((32, 8),)))
            return starved[0], None
        return got

    def still_ok(*a, **kw):
        checks.append(1)
        return real_ok(*a, **kw) and len(checks) > 1

    monkeypatch.setattr(driver, "plan_engine", plan)
    monkeypatch.setattr(driver, "tile_params_still_ok", still_ok)
    assert cli.main(["--run", *common, "--snapID", "1", "--snapInterval", "3", "--keepSnaps",
                     "true", "--showPlots", "false", "--max-steps", "5", "--quiet",
                     "--device", "cpu"]) == 0
    res = cli.LAST_RUN
    assert starved and res["steps"] == 5
    assert [c[0] for c in res["chunk_walls"]] == [1, 1, 2, 1]
    assert [c[2] for c in res["chunk_walls"]] == [0, 2, 0, 0]
    assert res["fallback_evals"] == 2
    cfgs = res["chunk_configs"]
    assert cfgs[1] == starved[0] and cfgs[2] != starved[0] and cfgs[3] != starved[0]
    assert res["snapshot_ids"] == [1, 4, 5]


def test_run_simulation_drops_a_declined_block_spec(tmp_path, monkeypatch):
    """run_simulation's pick on the block engine (the chunk itself stubbed:
    it advances t and reports every step valid): each chunk tries the
    cached block configs; one whose refit declines is dropped and a fresh
    plan taken, and the dropped config is not refit at any later pick. Each
    fresh plan's config is made distinct (its mesh_factor, which exact
    gravity does not use), and each refits once and then declines (the
    second and fourth refits). The state does not move, so a config kept
    after its decline would refit at the next pick and be taken again."""
    from sphtpu_torch.engine import State, driver
    from sphtpu_torch.physics.blocks import plan_blocks

    root = str(tmp_path)
    common = ["--EOS", "polytropic", "--ic_type", "boss_bodenheimer", "--root", root]
    assert cli.main(["--generate", *common, "--kwargs", "N=1000,Kh=24"]) == 0
    plans, refits = [], []
    real_refit = driver.block_args_for_spec

    def plan(pos, h, *, n, kh, eos, dtype, gravity, **kw):
        spec, args = plan_blocks(pos, h, kh, gravity=gravity, **kw)
        plans.append(EngineConfig(n=n, kh=kh, eos=eos, dtype=dtype, blocks=spec,
                                  mesh_factor=5 + len(plans)))
        return plans[-1], args

    def refit(pos, h, spec, **kw):
        refits.append(spec)
        return None if len(refits) in (2, 4) else real_refit(pos, h, spec, **kw)

    def stub(cfg, **kw):
        def chunk(state, p, h, n_steps, mlargs=None):
            z = torch.zeros(n_steps, dtype=torch.int64)
            return (State(state.pos, state.vel, state.K, state.t + 1e-9 * n_steps),
                    torch.zeros((n_steps, 10), dtype=state.pos.dtype), z == 0, h,
                    torch.ones_like(h), z)
        return chunk

    monkeypatch.setattr(driver, "plan_engine", plan)
    monkeypatch.setattr(driver, "block_args_for_spec", refit)
    monkeypatch.setattr(driver, "make_chunk_runner", stub)
    assert cli.main(["--run", *common, "--snapID", "1", "--keepSnaps", "false",
                     "--showPlots", "false", "--max-steps", "12", "--quiet",
                     "--device", "cpu"]) == 0
    res = cli.LAST_RUN
    assert res["steps"] == 12 and [c[0] for c in res["chunk_walls"]] == [2] * 6
    # chunk 2 refits plan 0; chunk 3's refit of it declines: plan 1, which
    # chunk 4 refits alone; chunk 5's refit of it declines: plan 2
    assert len(plans) == 3 and len(refits) == 5
    assert res["chunk_configs"] == [plans[0], plans[0], plans[1], plans[1], plans[2], plans[2]]
