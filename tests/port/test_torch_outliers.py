"""The outlier lane (physics/outliers.py, the mono-tile engine with an
outlier budget, K2's outlier masks, the ladder's last rung): port vs the
JAX package, on the CPU.

The scene is a two-scale ball, a core of radius 0.6 holding 60 % of the
particles in a sparse halo of radius 1 (tests/test_outliers.py::_two_scale
with a wider core, so that the reference's XLA engine plans a grid cheap
enough for this suite: grid 8, cap 32, budget 1 024, 406 outlier rows at
N = 1 200, kh = 24). The mono-tile planner declines it and
`choose_tile_params_ml` splits it. Each reference evaluation (its XLA phases,
pallas_a=False) runs once a module and is shared by the cases.

Bars: float64 to reassociation roundoff (h and rho 1e-12 relative; every
other output within 1e-11 of its largest value); float32 against the
reference's float64 on the same (float32-valued) inputs: h 1e-6 and rho
1e-5 relative, every other output within 2e-5 of its largest value, but
the P3M gravity corrections within 6e-5: a close pair's two corrections
(K2's and the tail's) cancel in float32 (ROADMAP F8); here the reference's
own float32 evaluation is 5.9e-5 from its float64, the port's 2.6e-5."""

import functools
import gc
import inspect
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import sphtpu.engine as ref_engine
import sphtpu.engine.driver as ref_driver
from sphtpu.physics import outliers as ref_out
from sphtpu.physics.tiles import choose_tile_params_ml as ml_ref
from sphtpu.physics.tiles import tile_sph_forces as tile_ref
from sphtpu_torch import cli
from sphtpu_torch.engine import EngineConfig, driver, params_from_numpy
from sphtpu_torch.engine.step import force_eval
from sphtpu_torch.kernels.cuda_tile_pairs import (
    K2_PIECE,
    k2_shared_bytes,
    phase_b_tiles_plain,
)
from sphtpu_torch.physics import outliers
from sphtpu_torch.physics.tiles import (
    MASK,
    _fill,
    _tile_stack,
    choose_tile_params,
    choose_tile_params_ml,
    tile_sph_forces,
)

# the suite runs several pytest workers per machine: keep torch's intra-op
# pool from oversubscribing the cores they share
torch.set_num_threads(2)

N, KH = 1200, 24
PHYS = dict(gamma=5 / 3, cs0=0.5, alpha=1.0, beta=2.0, kh=KH)
MESH = {"exact": 0, "p3m": 10}  # mesh_factor (the tail's W = 1)
DATA = os.path.join(os.path.dirname(__file__), "..", "..", "bench_data")
NP = {"float64": np.float64, "float32": np.float32}


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


def t(a):
    return torch.from_numpy(np.array(a))


def _ball(rng, count, radius):
    u = rng.random(count) ** (1 / 3)
    d = rng.standard_normal((count, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return d * (radius * u)[:, None]


def two_scale(n=N, kh=KH, seed=11, core=0.6, r_core=0.6):
    """A dense core (share `core` of the particles, radius r_core) in a
    sparse unit halo, float32 values: (pos, vel, K, h0 from a k = kh
    KD-tree)."""
    rng = np.random.default_rng(seed)
    n_core = int(core * n)
    pos = np.concatenate([_ball(rng, n_core, r_core), _ball(rng, n - n_core, 1.0)])
    pos = pos.astype(np.float32)
    vel = (0.1 * rng.standard_normal((n, 3))).astype(np.float32)
    K = (1.0 + 0.1 * rng.random(n)).astype(np.float32)
    d, _ = cKDTree(pos).query(pos, k=kh)
    return pos, vel, K, (d[:, -1] / 2).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _scene():
    pos, vel, K, h0 = two_scale()
    return pos, vel, K, h0, choose_tile_params_ml(pos, h0, KH)


def _split(pos, h0, grid):
    """The engine's species split in float64: (half, s, out_mask, rows)."""
    half = np.abs(pos.astype(np.float64)).max() * (1.0 + 1e-6) + 1e-30
    s = 2.0 * half / grid
    mask = h0.astype(np.float64) * outliers.OUTLIER_CUT > s
    return half, s, mask, np.flatnonzero(mask)


@functools.lru_cache(maxsize=None)
def _ref(eos, mode, hint=1.0):
    """The reference's tile_sph_forces with its outlier lane, float64, as
    numpy; h_hint is the KD-tree h times `hint`."""
    pos, vel, K, h0, (g, cap, budget) = _scene()
    out, gcorr, ok = tile_ref(
        *(jnp.asarray(a, jnp.float64) for a in (pos, vel)), 1.0 / N,
        jnp.asarray(K, jnp.float64), jnp.asarray(hint * h0, jnp.float64), eos=eos, grid=g,
        cap=cap, mesh_factor=MESH[mode], outlier_budget=budget, pallas_a=False, **PHYS,
    )
    return (
        {k: np.asarray(v) for k, v in out._asdict().items()},
        [np.asarray(x) for x in gcorr],
        bool(ok),
    )


def _port(dtype, eos, mode, hint=1.0, budget=None):
    pos, vel, K, h0, (g, cap, plan_budget) = _scene()
    f = NP[dtype]
    return tile_sph_forces(
        *(t(a.astype(f)) for a in (pos, vel)), f(1.0 / N), t(K.astype(f)),
        t((hint * h0).astype(f)), eos=eos, grid=g, cap=cap, mesh_factor=MESH[mode],
        outlier_budget=plan_budget if budget is None else budget, device="cpu", **PHYS,
    )


def _close(a, b, rtol=0.0, scale_tol=0.0, name=""):
    np.testing.assert_allclose(
        a, b, rtol=rtol, atol=scale_tol * np.abs(b).max(), err_msg=name
    )


# ------------------------------------------------------------ the planner
PLAN_STATES = {
    "two_scale": lambda: _scene()[0:4:3],
    "two_scale_6000": lambda: two_scale(6000, core=0.6, r_core=0.25)[0:4:3],
    "contrast395": lambda: tuple(np.load(os.path.join(DATA, "bb_collapsed.npz"))[k]
                                 for k in ("pos", "h")),
    "contrast1001": lambda: tuple(np.load(os.path.join(DATA, "bb_collapsed_deep.npz"))[k]
                                  for k in ("pos", "h")),
}


@pytest.mark.parametrize("args", ["defaults", "driver"])
@pytest.mark.parametrize("state", sorted(PLAN_STATES))
def test_choose_tile_params_ml_matches_reference(state, args):
    """The same (grid, cap, budget) as the reference's planner, with its
    defaults and with the driver's arguments (headroom 1.5, budget margin
    2). On bb_collapsed.npz the driver's plan is grid 27, cap 160, budget
    65 536; the mono-tile planner declines every one of these states."""
    pos, h = PLAN_STATES[state]()
    kw = {} if args == "defaults" else dict(headroom=1.5, budget_margin=2.0)
    kh = 50 if state.startswith("contrast") else KH
    got = choose_tile_params_ml(pos, h, kh, **kw)
    assert got == ml_ref(pos, h, kh, **kw)
    assert choose_tile_params(pos, h, kh) is None
    if state == "contrast395" and args == "driver":
        assert got == (27, 160, 65536)
    if state == "two_scale":
        assert got is not None and got[2] > 0


# ------------------------------------------------------ the lane's parts
def test_outlier_knn_matches_reference():
    """The outlier rows' kNN: the reference's padded rows (budget slots,
    fill N) against the port's real rows: equal indices, h and rho to
    1e-12."""
    pos, _, _, h0, (g, _, budget) = _scene()
    _, _, mask, rows = _split(pos, h0, g)
    padded = jnp.nonzero(jnp.asarray(mask), size=budget, fill_value=N)[0].astype(jnp.int32)
    idx_r, h_r, rho_r = (np.asarray(a) for a in ref_out.outlier_knn(
        jnp.asarray(pos, jnp.float64), padded, 1.0 / N, KH))
    idx, h, rho = outliers.outlier_knn(t(pos.astype(np.float64)), t(rows), 1.0 / N, KH)
    b = rows.size
    assert 0 < b <= budget
    np.testing.assert_array_equal(idx.numpy(), idx_r[:b])
    _close(h.numpy(), h_r[:b], rtol=1e-12, name="h")
    _close(rho.numpy(), rho_r[:b], rtol=1e-12, name="rho")


@pytest.mark.parametrize("eos", ["polytropic", "isothermal"])
def test_outlier_forces_matches_reference(eos):
    """Pair forces and the scatter of the outlier rows on the merged fields
    of the reference's evaluation; the port runs the real rows and, once
    more, the padded rows (their pads must add nothing)."""
    pos, vel, K, h0, (g, _, budget) = _scene()
    ref, _, _ = _ref("polytropic", "exact")
    _, _, mask, rows = _split(pos, h0, g)
    padded = np.full(budget, N, np.int64)
    padded[: rows.size] = rows
    h, rho = ref["h"], ref["rho"]
    por2 = K * rho ** (5 / 3 - 2.0) if eos == "polytropic" else 0.5**2 / rho
    cs = ref["cs"] if eos == "polytropic" else np.full(N, 0.5)
    p64 = pos.astype(np.float64)
    idx = np.asarray(ref_out.outlier_knn(jnp.asarray(p64), jnp.asarray(padded, jnp.int32),
                                         1.0 / N, KH)[0])
    kw = dict(eos=eos, alpha=1.0, beta=2.0)
    row_r, scat_r = ref_out.outlier_forces(
        jnp.asarray(p64), jnp.asarray(vel, jnp.float64), jnp.asarray(padded, jnp.int32),
        jnp.asarray(idx), *(jnp.asarray(a, jnp.float64) for a in (h, rho, por2, cs)),
        1.0 / N, **kw,
    )
    b = rows.size
    for rr, form in ((rows, "real"), (padded, "padded")):
        row, scat = outliers.outlier_forces(
            t(p64), t(vel.astype(np.float64)), t(rr), t(idx[: rr.size].astype(np.int64)),
            *(t(np.asarray(a, np.float64)) for a in (h, rho, por2, cs)), 1.0 / N, **kw,
        )
        for k in ("acc", "mu_max", "div_sum", "visc_dk"):
            _close(row[k].numpy()[:b], np.asarray(row_r[k])[:b], scale_tol=1e-10,
                   name=f"{form} {k}")
        for k in ("ax", "ay", "az", "visc"):
            _close(scat[k].numpy(), np.asarray(scat_r[k]), scale_tol=1e-10, name=f"{form} {k}")


def test_outlier_gravity_corr_matches_reference():
    """The far-pair gravity corrections (both sweeps), the reference's
    padded rows against the port's real rows."""
    pos, _, _, h0, (g, _, budget) = _scene()
    ref, _, _ = _ref("polytropic", "exact")
    half, s, mask, rows = _split(pos, h0, g)
    p64 = pos.astype(np.float64)
    padded = jnp.nonzero(jnp.asarray(mask), size=budget, fill_value=N)[0].astype(jnp.int32)
    dg_r, dphi_r = (np.asarray(a) for a in jax.jit(ref_out.outlier_gravity_corr,
                                                      static_argnums=7)(
        jnp.asarray(p64), jnp.asarray(ref["h"]), padded, jnp.asarray(mask), 1.0 / N,
        jnp.asarray(half), jnp.asarray(s), g))
    assert np.abs(dg_r).max() > 0
    dg, dphi = outliers.outlier_gravity_corr(
        t(p64), t(ref["h"]), t(rows), 1.0 / N, torch.tensor(half), torch.tensor(s), g
    )
    _close(dg.numpy(), dg_r, scale_tol=1e-10, name="dg")
    _close(dphi.numpy(), dphi_r, scale_tol=1e-10, name="dphi")


# ------------------------------------------------------------ the engine
@pytest.mark.parametrize(
    "dtype,eos,mode",
    [
        ("float64", "polytropic", "exact"),
        ("float64", "isothermal", "p3m"),
        ("float32", "polytropic", "exact"),
        ("float32", "isothermal", "p3m"),
    ],
)
def test_tile_sph_forces_with_outliers_matches_reference(dtype, eos, mode):
    """tile_sph_forces with outlier_budget > 0: every ReducedForces field,
    the four gravity corrections and ok, against the reference's float64
    evaluation (the module's bars)."""
    ref, gcorr_r, ok_r = _ref(eos, mode)
    out, gcorr, ok = _port(dtype, eos, mode)
    assert ok_r and bool(ok), "the planned split must certify"
    if dtype == "float64":
        rel, scale, g_scale = 1e-12, 1e-11, 1e-11
    else:
        rel, scale, g_scale = None, 2e-5, 6e-5 if mode == "p3m" else 2e-5
    for name, b in ref.items():
        a = getattr(out, name).numpy()
        if name in ("h", "rho"):
            _close(a, b, rtol=rel or {"h": 1e-6, "rho": 1e-5}[name], name=name)
        else:
            _close(a, b, scale_tol=scale, name=name)
    for a, b in zip(gcorr, gcorr_r):
        _close(a.numpy(), b, scale_tol=g_scale, name="gcorr")


@pytest.mark.parametrize("eos", ["polytropic", "isothermal"])
def test_outlier_engine_matches_gather_oracle(eos):
    """force_eval on the outlier config against the port's gather engine
    (tests/test_outliers.py::test_outlier_engine_matches_gather_oracle),
    float64: both are exact, so they agree to roundoff."""
    pos, vel, K, h0, (g, cap, budget) = _scene()
    p = params_from_numpy(m=1.0 / N, cs0=0.5, U0=0.0, t_end=1e9, dtype="float64",
                          device="cpu", **{k: v for k, v in PHYS.items() if k not in ("kh", "cs0")})
    args = [t(a.astype(np.float64)) for a in (pos, vel, K, h0)]
    base = dict(n=N, kh=KH, eos=eos, dtype="float64")
    acc_t, red_t, phi_t, fb_t = force_eval(
        EngineConfig(**base, tile=(g, cap), outlier_budget=budget), p, *args, device="cpu")
    acc_g, red_g, phi_g, _ = force_eval(EngineConfig(**base), p, *args, device="cpu")
    assert not fb_t, "the outlier engine must certify, not fall back"
    _close(red_t.h.numpy(), red_g.h.numpy(), rtol=1e-12, name="h")
    _close(red_t.rho.numpy(), red_g.rho.numpy(), rtol=1e-11, name="rho")
    for name, a, b in (("acc", acc_t, acc_g), ("phi", phi_t, phi_g),
                       ("visc_dk", red_t.visc_dk, red_g.visc_dk),
                       ("div_sum", red_t.div_sum, red_g.div_sum),
                       ("mu_max", red_t.mu_max, red_g.mu_max)):
        _close(a.numpy(), b.numpy(), rtol=1e-9, scale_tol=1e-11, name=name)


@pytest.mark.parametrize("eos", ["polytropic", "isothermal"])
def test_phase_b_plain_zero_flags_are_no_flags(eos):
    """K2's plain version with its outlier masks on, where no slot is marked
    an outlier (mask 2), gives the bits of a call with them off; with the
    scene's outlier slots marked it differs (the masks drop pairs) but for
    the gravity corrections."""
    pos, vel, _, h0, (g, cap, _) = _scene()
    st = _tile_stack(t(pos.astype(np.float64)), t(vel.astype(np.float64)), g, cap)
    rng = np.random.default_rng(2)
    for f in range(7, 11):  # h, rho, P/rho^2, cs at the occupied slots
        v = st.planes.new_tensor(0.05 + 0.1 * rng.random(st.planes[f].shape))
        st.planes[f] = torch.where(st.planes[MASK] > 0, v, 0.0)
    _fill(st, 7, 11)
    _, _, mask, _ = _split(pos, h0, g)
    kw = dict(eos=eos, p3m=False, cap=cap)

    def fields(rows):
        return (tuple(st.qpl[f, rows] for f in range(11)),
                tuple(st.pre_rows[f, rows] for f in range(11)))

    plain = {}
    for marked in (False, True):
        if marked:
            st.planes[MASK, st.pz, st.py, st.px] += t(mask).to(st.planes.dtype)
            _fill(st, MASK, MASK + 1)
            # the first 160 rows holding an outlier query
            rows = torch.nonzero((st.qpl[MASK, : g**3] > 1).any(1)).flatten()[:160]
        else:
            rows = torch.arange(160)
        q, c = fields(rows)
        plain[marked] = phase_b_tiles_plain(q, c, 1.0 / N, 1.0, 2.0, None, **kw)
        masked = phase_b_tiles_plain(q, c, 1.0 / N, 1.0, 2.0, None, outlier=True, **kw)
        if not marked:
            assert all(torch.equal(a, b) for a, b in zip(plain[marked], masked))
        else:
            assert not torch.equal(plain[marked][0], masked[0])
            assert torch.equal(plain[marked][6], masked[6]), "the gravity mask is unchanged"


@pytest.mark.parametrize("eos,mode", [("polytropic", "exact"), ("isothermal", "p3m")])
def test_budget_without_outlier_rows_is_the_run_without_budget(eos, mode):
    """An outlier budget where no row passes the species cut (the hint
    scaled down, as a cached config's may be within a chunk): the lane
    does not run, so the evaluation gives the bits of the one without a
    budget, and matches the reference's padded form (every row padding) in
    float64 (the engine cases' compiled programs: only the hint differs)."""
    pos, _, _, h0, (g, _, _) = _scene()
    assert not _split(pos, 0.1 * h0, g)[2].any(), "no row may pass the species cut"
    ref, gcorr_r, ok_r = _ref(eos, mode, 0.1)
    out, gcorr, ok = _port("float64", eos, mode, hint=0.1)
    base, gcorr_b, ok_b = _port("float64", eos, mode, hint=0.1, budget=0)
    assert all(torch.equal(getattr(out, k), getattr(base, k)) for k in ref)
    assert all(torch.equal(a, b) for a, b in zip(gcorr, gcorr_b))
    assert bool(ok) == bool(ok_b) == ok_r
    for name, b in ref.items():
        a = getattr(out, name).numpy()
        if name in ("h", "rho"):
            _close(a, b, rtol=1e-12, name=name)
        else:
            _close(a, b, scale_tol=1e-11, name=name)
    for a, b in zip(gcorr, gcorr_r):
        _close(a.numpy(), b, scale_tol=1e-11, name="gcorr")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_outlier_variant_fits_the_mono_rows(dtype):
    """K2's shared memory with the outlier plane at every mono capacity up
    to 256 at its default piece fits the H100's opt-in 227 KiB."""
    for cap in range(32, 257, 32):
        need = k2_shared_bytes(cap, 27 * cap, K2_PIECE[dtype], dtype, outlier=True)
        assert k2_shared_bytes(cap, 27 * cap, K2_PIECE[dtype], dtype) < need <= 227 * 1024


# ------------------------------------------------------------- the driver
def _decline(monkeypatch):
    for name in ("choose_tile_classes", "choose_tile_params", "plan_blocks", "plan_mlevel"):
        monkeypatch.setattr(driver, name, lambda *a, **k: None)


def _ref_cfg_cost(n):
    """The reference's `_cfg_cost` (a closure of its run_simulation),
    lifted out of its source with n bound."""
    src = inspect.getsource(ref_driver.run_simulation)
    body = src[src.index("    def _cfg_cost"): src.index("    def pick_cfg")]
    body = textwrap.dedent(body).replace(
        "from ..physics.blocks import BQ", "from sphtpu.physics.blocks import BQ")
    ns = {"n": n, "EngineConfig": ref_engine.EngineConfig}
    exec(body, ns)
    return ns["_cfg_cost"]


@pytest.mark.parametrize("gravity", ["exact", "p3m"])
def test_plan_engine_reaches_the_outlier_rung(gravity, monkeypatch):
    """Where the tile planners, plan_blocks and plan_mlevel decline, the
    ladder's last rung plans the reference's outlier config
    (driver.py:529-541), and its cost is the reference's."""
    _decline(monkeypatch)
    pos, _, _, h0, _ = _scene()
    cfg, args = driver.plan_engine(pos, h0, n=N, kh=KH, eos="polytropic", dtype="float32",
                                   gravity=gravity)
    grid, cap, budget = ml_ref(pos, h0, KH, headroom=1.5, budget_margin=2.0)
    assert args is None and budget > 0
    assert (cfg.tile, cfg.outlier_budget, cfg.gravity) == ((grid, cap), budget, gravity)
    assert cfg.tile_classes is None and driver.engine_name(cfg) == "outliers"
    ref_cfg = ref_engine.EngineConfig(n=N, kh=KH, eos="polytropic", tile=(grid, cap),
                                      outlier_budget=budget, gravity=gravity)
    assert driver.cfg_cost(cfg, N) == _ref_cfg_cost(N)(ref_cfg)


@pytest.mark.parametrize("budget", [512, 65536])
def test_cfg_cost_ranks_outlier_and_block_configs_as_reference(budget):
    """A cached outlier config and a cached block config: the port's cost
    of each equals the reference's, so the run loop keeps the one the
    reference keeps (the budget's n * B term decides at 65 536)."""
    n = 100_000
    ref_cost = _ref_cfg_cost(n)
    spec = (((16384, 400), (32768, 112)), (8, 16), (), 16)
    pairs = []
    for mod in (ref_engine, None):
        make = ref_engine.EngineConfig if mod else EngineConfig
        pairs.append((
            make(n=n, kh=50, eos="polytropic", tile=(27, 160), outlier_budget=budget),
            make(n=n, kh=50, eos="polytropic", blocks=spec),
        ))
    (ro, rb), (po, pb) = pairs
    assert driver.cfg_cost(po, n) == ref_cost(ro)
    assert driver.cfg_cost(pb, n) == ref_cost(rb)
    assert (driver.cfg_cost(po, n) < driver.cfg_cost(pb, n)) == (ref_cost(ro) < ref_cost(rb))
    assert (ref_cost(ro) < ref_cost(rb)) == (budget == 512)


def _write_scene_snapshot(root):
    """The two-scale scene as snapshot 1 of boss_bodenheimer (Kh = 24),
    through the port's writer, in CGS."""
    from sphtpu_torch import constants as C
    from sphtpu_torch.io import write_snapshot
    from sphtpu_torch.scenes.setup import DEFAULTS
    from sphtpu_torch.units import UnitSystem

    pos, vel, K, _, _ = _scene()
    M, R = 1.989e33, 1.0e17
    u = UnitSystem.from_constants(C.G_CGS, M, R)
    gamma = 5.0 / 3.0
    consts = {
        "iterID": 1, "N": N, "Kh": KH, "Kgr": DEFAULTS["Kgr"], "t": 0.0,
        "tEnd": DEFAULTS["tEnd"], "M": M, "R": R, "alpha": 1.0, "beta": 2.0, "G": C.G_CGS,
        "theta": DEFAULTS["theta"], "m": M / N, "gamma": gamma,
    }
    write_snapshot("1", "boss_bodenheimer", pos.astype(np.float64) * u.L,
                   vel.astype(np.float64) * u.V,
                   K=K.astype(np.float64) * u.K_entropy(gamma), constants=consts, root=root)


def test_cli_steps_run_on_the_outlier_rung(tmp_path, monkeypatch):
    """Two CLI steps of the two-scale snapshot on the CPU, with the tile
    planners, plan_blocks and plan_mlevel declining: the run loop's own
    ladder plans the outlier rung, every chunk runs on it, no evaluation
    falls back, and the stats stay finite."""
    _decline(monkeypatch)
    root = str(tmp_path)
    _write_scene_snapshot(root)
    rc = cli.main(
        ["--run", "--EOS", "polytropic", "--ic_type", "boss_bodenheimer", "--root", root,
         "--snapID", "1", "--snapInterval", "2", "--keepSnaps", "true", "--showPlots",
         "false", "--max-steps", "2", "--quiet", "--device", "cpu"]
    )
    res = cli.LAST_RUN
    assert rc == 0 and res["steps"] == 2
    assert set(res["chunk_engines"]) == {"outliers"}
    assert res["fallback_evals"] == 0
    assert all(c.outlier_budget > 0 for c in res["chunk_configs"])
    assert np.isfinite(res["last_stats_cgs"]).all()


# ------------------------------------ a close pair's two corrections, joint
@pytest.mark.parametrize("mesh_factor,outlier", [(10, True), (5, False)])
def test_joint_and_skip_plain_equal_the_two_sweeps(mesh_factor, outlier):
    """ROADMAP D21 in float64: K2's joint mode (a pair inside the gravity
    mask takes term 1 and term 2 as one term) plus the tail's skip mode
    (those pairs left out), as plain versions on the scene's slot layout
    with its KD-tree h (tail W = 1 and 2; K2 with and without its outlier
    masks), equal K2's term 1 plus the tail over every pair — the
    reference's two sweeps, which the module's and test_torch_tiles'
    tests hold against the reference — within 1e-12 of each output's
    scale; each pair of the 27-cell stencil lies in exactly one of the
    two."""
    from sphtpu_torch.kernels.cuda_p3m_tail import p3m_tail_plain
    from sphtpu_torch.physics.mesh_gravity import tail_halfwidth
    from sphtpu_torch.physics.tiles import H, _tail_planes

    pos, vel, _, h0, (g, cap, _) = _scene()
    p64 = t(pos.astype(np.float64))
    st = _tile_stack(p64, t(vel.astype(np.float64)), g, cap)
    rng = np.random.default_rng(4)
    h_row = t(h0.astype(np.float64))
    st.planes[H, st.pz, st.py, st.px] = h_row
    for f in range(H + 1, 11):  # rho, P/rho^2, cs at the occupied slots
        v = st.planes.new_tensor(0.5 + rng.random(st.planes[f].shape))
        st.planes[f] = torch.where(st.planes[MASK] > 0, v, 0.0)
    if outlier:  # the scene's outlier slots marked, as the lane marks them
        _, _, mask, _ = _split(pos, h0, g)
        st.planes[MASK, st.pz, st.py, st.px] += t(mask.astype(np.float64))
    _fill(st, MASK, 11)
    n_cells = g**3
    qf = tuple(st.qpl[f, :n_cells] for f in range(11))
    cf = tuple(st.pre_rows[f, :n_cells] for f in range(11))
    w = tail_halfwidth(mesh_factor, 2.2)
    sigma = float(st.s) / mesh_factor * 2.2
    m = 1.0 / N
    kw = dict(eos="polytropic", p3m=False, cap=cap, outlier=outlier)
    split = torch.stack(phase_b_tiles_plain(qf, cf, m, 1.0, 2.0, None, **kw)[6:])
    joint = torch.stack(phase_b_tiles_plain(qf, cf, m, 1.0, 2.0, sigma, joint=True, **kw)[6:])
    tkw = dict(grid=g, cap=cap, halfwidth=w)
    tail_all = p3m_tail_plain(_tail_planes(p64, st, w), m, sigma, **tkw)
    tail_skip = p3m_tail_plain(_tail_planes(p64, st, w, h_row), m, sigma, skip_joint=True,
                               **tkw)
    assert not torch.equal(tail_all, tail_skip), "the layout has pairs inside the mask"
    for a, b in zip(joint + tail_skip, split + tail_all):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("eos", ["polytropic", "isothermal"])
def test_joint_gravity_float32_within_the_float64_bar(eos):
    """tile_sph_forces with its outlier budget under p3m in float32 with
    joint_gravity=True (what the run loop passes; ROADMAP D21) against the
    reference's float64 evaluation: the gravity corrections within 2e-5 of
    their scale, the bar of every other output (the module's float32 case
    without it needs 6e-5: F8), and every other output within the module's
    float32 bars."""
    ref, gcorr_r, ok_r = _ref(eos, "p3m")
    pos, vel, K, h0, (g, cap, budget) = _scene()
    f = np.float32
    out, gcorr, ok = tile_sph_forces(
        *(t(a.astype(f)) for a in (pos, vel)), f(1.0 / N), t(K.astype(f)), t(h0.astype(f)),
        eos=eos, grid=g, cap=cap, mesh_factor=MESH["p3m"], outlier_budget=budget,
        joint_gravity=True, device="cpu", **PHYS,
    )
    assert ok_r and bool(ok)
    for name, b in ref.items():
        a = getattr(out, name).numpy()
        if name in ("h", "rho"):
            _close(a, b, rtol={"h": 1e-6, "rho": 1e-5}[name], name=name)
        else:
            _close(a, b, scale_tol=2e-5, name=name)
    for a, b in zip(gcorr, gcorr_r):
        _close(a.numpy(), b, scale_tol=2e-5, name="gcorr")
