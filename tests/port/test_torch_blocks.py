"""Block-compact engine: port vs the JAX package, on the CPU.

The same numpy states go through `sphtpu.physics.blocks` (its XLA phase A
and phase B, or its Pallas kernels K1/K5/K6 in interpret mode) and through
`sphtpu_torch.physics.blocks` with CPU tensors, where every kernel wrapper
takes its plain PyTorch version. No CUDA kernel runs here.

Tolerances: the planner and the candidate tables are integer/host
arithmetic and must agree bit for bit; float64 forces to reduction-order
roundoff (the bars of tests/test_blocks.py::_assert_parity); float32 h to
one ulp and the other outputs within 6e-6 of each output's scale (the bar
of tests/test_blocks.py::test_blocks_pallas_phase_b_matches_xla).
"""

import dataclasses
import functools
import gc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import sphtpu.engine as ref_engine
import sphtpu.physics.blocks as RB
from sphtpu.kernels.pallas_block_pairs import phase_b_blocks as k6_ref
from sphtpu.kernels.pallas_grouped_pairs import phase_b_grouped as k5_ref
from sphtpu.kernels.pallas_strip_knn import phase_a_cells as k1_ref
from sphtpu.physics import sph_forces as sph_forces_ref
from sphtpu.physics.gravity import gravity_allpairs as gravity_allpairs_ref
import sphtpu_torch.physics.blocks as TB
from sphtpu_torch.engine import (
    EngineConfig,
    config_from_reference,
    make_chunk_runner,
    params_from_numpy,
    state_from_numpy,
)
from sphtpu_torch.engine.step import force_eval
from sphtpu_torch.kernels import cuda_block_pairs, cuda_grouped_pairs, cuda_strip_knn
from sphtpu_torch.physics import gravity_newton_allpairs
from sphtpu_torch.physics.mesh_gravity import greens_hat

# the suite runs several pytest workers per machine: keep torch's intra-op
# pool from oversubscribing the cores they share
torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "..", "..", "bench_data")
FIXTURES = {
    "contrast395": os.path.join(DATA, "bb_collapsed.npz"),
    "contrast1001": os.path.join(DATA, "bb_collapsed_deep.npz"),
}
PHYS = dict(gamma=5 / 3, alpha=1.0, beta=2.0)


@pytest.fixture(scope="module", autouse=True)
def _free_reference_caches():
    """When the module is done, drop its cached JAX results and compiled
    programs, so that the test worker does not carry them into the tests it
    runs next."""
    yield
    _ref_forces.cache_clear()
    _plan.cache_clear()
    jax.clear_caches()
    gc.collect()


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _two_scale(n, kh, seed):
    """A dense core in a sparse halo (h contrast ~4, so several octaves)."""
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


SCENES = {  # name -> (n, kh, seed)
    "core_halo": (1500, 16, 17),
    "core_halo_iso": (1200, 16, 7),
}


@functools.lru_cache(maxsize=None)
def _plan(scene, gravity):
    pos, vel, K, h0 = _two_scale(*SCENES[scene])
    res = RB.plan_blocks(pos, h0, SCENES[scene][1], gravity=gravity)
    assert res is not None
    return pos, vel, K, h0, res[0], res[1]


def _ref_args(a, dtype=jnp.float64):
    return RB.BlockArgs(
        order_q=jnp.asarray(a.order_q), order_c=jnp.asarray(a.order_c),
        pos_ref=jnp.asarray(a.pos_ref, dtype), half_ref=jnp.asarray(a.half_ref, dtype),
        boxes=tuple(jnp.asarray(b) for b in a.boxes),
        starts=tuple(jnp.asarray(s) for s in a.starts),
    )


def _assert_args_equal(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, tuple):
            assert len(x) == len(y), name
            for u, v in zip(x, y):
                assert u.dtype == v.dtype, name
                np.testing.assert_array_equal(u, v, err_msg=name)
        else:
            assert np.asarray(x).dtype == np.asarray(y).dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


# ------------------------------------------------------------ (1) planner
def _planner_state(source):
    if source in FIXTURES:
        d = np.load(FIXTURES[source])
        pos = d["pos"].astype(np.float64)
        return pos, d["h"].astype(np.float64), 50
    n, kh, seed = SCENES[source]
    pos, _, _, h0 = _two_scale(n, kh, seed)
    return pos, h0, kh


@pytest.mark.parametrize("gravity", ["exact", "p3m"])
@pytest.mark.parametrize("source", ["contrast395", "contrast1001", "core_halo"])
def test_planner_matches_reference(source, gravity):
    """plan_blocks and the refit into the planned spec (block_args_for_spec,
    after a 10 % uniform growth of h) equal the JAX package's: the spec ==,
    every BlockArgs array bit-equal, the same refit verdict and reason."""
    pos, h, kh = _planner_state(source)
    ref = RB.plan_blocks(pos, h, kh, gravity=gravity)
    out = TB.plan_blocks(pos, h, kh, gravity=gravity)
    assert ref is not None and out is not None
    assert out[0] == ref[0]
    _assert_args_equal(out[1], ref[1])
    spec = ref[0]
    # h grown 3x does not fit the planned buckets: the refit refuses it, for
    # the same reason (the fixtures take the first case only, for time)
    for grow in (1.1,) if source in FIXTURES else (1.1, 3.0):
        a_ref = RB.block_args_for_spec(pos, h * grow, spec, gravity=gravity)
        a_out = TB.block_args_for_spec(pos, h * grow, spec, gravity=gravity)
        assert (a_ref is None) == (a_out is None)
        assert TB.last_refit_fail() == RB.last_refit_fail()
        if a_ref is not None:
            _assert_args_equal(a_out, a_ref)


# ---------------------------------------------------- (2) candidate tables
@pytest.mark.parametrize("gravity", ["exact", "p3m"])
def test_cand_tables_match_reference(gravity):
    pos, vel, K, h0, spec, args = _plan("core_halo", gravity)
    n = pos.shape[0]
    ref = RB.build_cand_tables(_ref_args(args), spec, n)
    out = TB.build_cand_tables(TB.block_args_to_device(args, torch.float64, "cpu"), spec, n)
    for a, b in zip(ref.idx + ref.rows, out.idx + out.rows):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(out.inv_oq.numpy(), np.asarray(ref.inv_oq))


# --------------------------------------------------- (3), (4) forces
def _kw(scene, gravity, eos):
    kh = SCENES[scene][1]
    return dict(PHYS, eos=eos, cs0=0.5 if eos == "isothermal" else 0.0, kh=kh,
                gravity=gravity)


@functools.lru_cache(maxsize=None)
def _ref_forces(scene, gravity, eos, dtype, variant, rounded=False):
    """The JAX package's block_sph_forces as numpy: variant "xla" (its
    default path on the CPU), "grouped" / "per_bucket" (Pallas K1 with K5 /
    K6, interpreted); and the gather oracle's at float64. rounded: the
    inputs rounded to float32 first."""
    pos, vel, K, h0, spec, args = _plan(scene, gravity)
    if eos == "isothermal":
        K = np.zeros_like(K)
    jd = {"float64": jnp.float64, "float32": jnp.float32}[dtype]
    rnd = (lambda x: x.astype(np.float32)) if rounded else (lambda x: x)
    P, V, Kj, H = (jnp.asarray(rnd(x), jd) for x in (pos, vel, K, h0))
    m = 1.0 / pos.shape[0]
    kw = _kw(scene, gravity, eos)
    if variant == "gather":
        sf = sph_forces_ref(P, V, m, Kj, eos=eos, gamma=kw["gamma"], cs0=kw["cs0"],
                            alpha=1.0, beta=2.0, kh=kw["kh"])
        g, phi = gravity_allpairs_ref(P, sf.h, m)
        return {k: np.asarray(getattr(sf, k)) for k in ("acc", "rho", "h", "mu_max",
                                                         "div_sum", "visc_dk")} | {
            "g": np.asarray(g), "phi": np.asarray(phi)}
    extra = {} if variant == "xla" else dict(
        pallas_a=True, pallas_interpret=True, grouped=variant == "grouped")
    red, gc_, ok = RB.block_sph_forces(P, V, m, Kj, H, _ref_args(args, jd), spec=spec,
                                       **kw, **extra)
    out = {k: np.asarray(v) for k, v in red._asdict().items()}
    out["gcorr"] = np.stack([np.asarray(x) for x in gc_])
    out["ok"] = bool(ok)
    return out


def _port_forces(scene, gravity, eos, dtype, grouped=True):
    pos, vel, K, h0, spec, args = _plan(scene, gravity)
    if eos == "isothermal":
        K = np.zeros_like(K)
    td = {"float64": torch.float64, "float32": torch.float32}[dtype]
    nd = {"float64": np.float64, "float32": np.float32}[dtype]
    P, V, Kt, H = (t(x.astype(nd)) for x in (pos, vel, K, h0))
    m = 1.0 / pos.shape[0]
    kw = _kw(scene, gravity, eos)
    args_t = TB.block_args_to_device(args, td, "cpu")
    red, gc_, ok = TB.block_sph_forces(P, V, m, Kt, H, args_t, spec=spec, grouped=grouped,
                                       **{k: (torch.tensor(v, dtype=td) if isinstance(v, float)
                                              else v) for k, v in kw.items()})
    out = {k: v.numpy() for k, v in red._asdict().items()}
    out["gcorr"] = torch.stack(gc_).numpy()
    out["ok"] = bool(ok)
    return out, (P, m)


@pytest.mark.parametrize(
    "scene,gravity,eos",
    [("core_halo", "exact", "polytropic"), ("core_halo_iso", "exact", "isothermal"),
     ("core_halo", "p3m", "polytropic")],
)
def test_forces_f64_match_reference_and_gather(scene, gravity, eos):
    """Plain versions at float64 against the JAX package's default path
    (its XLA phases: the port's h takes 68 binary passes for the
    reference's 34 four-way ones, ROADMAP D8) and, under exact gravity,
    against the gather oracle with tests/test_blocks.py's bars."""
    out, (P, m) = _port_forces(scene, gravity, eos, "float64")
    ref = _ref_forces(scene, gravity, eos, "float64", "xla")
    assert out["ok"] and ref["ok"]
    np.testing.assert_allclose(out["h"], ref["h"], rtol=1e-12)
    np.testing.assert_allclose(out["rho"], ref["rho"], rtol=1e-11)
    for k in ("acc", "div_sum", "visc_dk", "mu_max", "cs"):
        sc = np.abs(ref[k]).max()
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-9, atol=1e-11 * sc, err_msg=k)
    # Under p3m every pair inside a row's visibility radius carries the tail
    # term, and the pair at the row's own ball edge (its kh-th neighbour,
    # r = 2h to the last bit) takes its ownership weight from r <= 2h with r
    # = d2 * rsqrt(d2): where the two libraries' rsqrt round apart, that one
    # pair's weight differs (1e-8 of the scale at most here). Exact gravity
    # has no term at that radius.
    g_atol = 1e-7 if gravity == "p3m" else 1e-11
    for a, b in zip(out["gcorr"], ref["gcorr"]):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=g_atol * np.abs(b).max())
    if gravity == "p3m":
        return
    # the gather oracle: softened all-pairs gravity = Newtonian sweep + corrections
    orc = _ref_forces(scene, gravity, eos, "float64", "gather")
    gn, phin = gravity_newton_allpairs(P, m, device="cpu")
    g_blk = (gn + torch.from_numpy(out["gcorr"][:3].T)).numpy()
    phi_blk = (phin + torch.from_numpy(out["gcorr"][3])).numpy()
    np.testing.assert_allclose(out["h"], orc["h"], rtol=1e-12)
    np.testing.assert_allclose(out["rho"], orc["rho"], rtol=1e-11)
    for k in ("acc", "div_sum", "visc_dk"):
        np.testing.assert_allclose(out[k], orc[k], rtol=1e-9,
                                   atol=1e-11 * np.abs(orc[k]).max(), err_msg=k)
    np.testing.assert_allclose(out["mu_max"], orc["mu_max"], rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(g_blk, orc["g"], rtol=1e-9, atol=1e-11 * np.abs(orc["g"]).max())
    np.testing.assert_allclose(phi_blk, orc["phi"], rtol=1e-10)


def test_p3m_force_eval_tracks_exact():
    """force_eval on a p3m block config: the mesh + the in-sweep tail
    corrections reproduce the softened interaction to the bars of
    tests/test_blocks.py::test_blocks_p3m_tracks_exact."""
    pos, vel, K, h0, spec, args = _plan("core_halo", "p3m")
    n, kh = pos.shape[0], SCENES["core_halo"][1]
    cfg = EngineConfig(n=n, kh=kh, eos="polytropic", dtype="float64", blocks=spec,
                       gravity="p3m")
    p = params_from_numpy(m=1.0 / n, gamma=5 / 3, cs0=0.0, alpha=1.0, beta=2.0, U0=0.0,
                          t_end=1e9, dtype="float64", device="cpu")
    ghat = greens_hat(cfg.mesh_pad, cfg.sigma_cells, torch.float64, "cpu")
    acc, red, phi, fb = force_eval(cfg, p, t(pos), t(vel), t(K), t(h0), ghat, args,
                                   device="cpu")
    assert not fb
    orc = _ref_forces("core_halo", "exact", "polytropic", "float64", "gather")
    acc_or = orc["acc"] - orc["g"]
    rms = np.sqrt((orc["g"] ** 2).sum(1).mean())
    err = np.sqrt(((acc.numpy() - acc_or) ** 2).sum(1))
    assert np.sqrt((err**2).mean()) < 2e-3 * rms
    relp = (phi.numpy() - orc["phi"]) / orc["phi"]
    assert np.sqrt((relp**2).mean()) < 1e-3


@pytest.mark.parametrize(
    "gravity,variant", [("exact", "grouped"), ("exact", "per_bucket"), ("p3m", "grouped")]
)
def test_forces_f32_match_pallas_interpret(gravity, variant):
    """Plain versions at float32 against the JAX package's Pallas path (K1
    and K5, or K1 and K6 per bucket) in interpret mode: h within one ulp,
    the certificate identical, every other output within 6e-6 of its
    scale. Under p3m a pair inside its softening radius takes its two
    gravity corrections, whose 1/r^3 parts cancel, summed in float64
    (ROADMAP F7), where the reference sums them in float32 (its gcorr is
    1.6e-5 of the scale off its own float64 one here): the port's gcorr is
    held against the reference's path in float64 on the same
    float32-rounded inputs."""
    out, _ = _port_forces("core_halo", gravity, "polytropic", "float32",
                          grouped=variant == "grouped")
    ref = _ref_forces("core_halo", gravity, "polytropic", "float32", variant)
    assert out["ok"] == ref["ok"] is True
    np.testing.assert_allclose(out["h"], ref["h"], rtol=1.2e-7)
    for k in ("rho", "acc", "visc_dk", "div_sum", "mu_max", "cs"):
        sc = np.abs(ref[k]).max() + 1e-30
        assert np.abs(out[k] - ref[k]).max() / sc < 6e-6, k
    if gravity == "p3m":
        ref = _ref_forces("core_halo", gravity, "polytropic", "float64", variant, rounded=True)
    for a, b in zip(out["gcorr"], ref["gcorr"]):
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-30) < 6e-6


# ------------------------------------------------ (5) the kernels directly
def _block_rows(rng, nb, cap, cw, dtype, n_occ):
    """Synthetic block rows: queries in the unit cube, each block's
    candidates a superset spread over [-0.25, 1.25]^3, the first n_occ
    candidate slots of each block occupied, one query row masked off."""
    nd = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    q = [rng.random((nb, cap)) for _ in range(3)]
    c = [rng.random((nb, cw)) * 1.5 - 0.25 for _ in range(3)]
    for a in range(3):
        c[a][:, :cap] = q[a]  # each query is also a candidate (self pair)
    cm = (np.arange(cw)[None, :] < n_occ).astype(np.float64).repeat(nb, 0)
    qm = np.ones((nb, cap))
    qm[0, 3] = 0.0
    return [x.astype(nd) for x in (*q, qm)], [x.astype(nd) for x in (*c, cm)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k1_block_shape_matches_pallas(dtype):
    """K1 at the block call shape (nb, BQ) x (nb, C_b), hint-seeded reach2,
    the block engine's pass count (28 at float32, the reference's own; 68 at
    float64): the plain version against the Pallas kernel interpreted with
    the same passes. h and ok bit-equal, rho to roundoff."""
    td = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    nb, cap, cw, kh = 2, TB.BQ, 1536, 32
    queries, cands = _block_rows(rng, nb, cap, cw, td, 1300)
    reach2 = (0.12 + 0.1 * rng.random((nb, cap))).astype(queries[0].dtype)
    reach2[1, :8] = 1e-4  # rows whose reach cannot hold kh neighbours
    nbis = TB.N_BISECT_HINT if td == torch.float32 else TB.N_BISECT_F64
    m = 1e-3
    h, rho, ok = cuda_strip_knn.phase_a_cells(
        tuple(map(t, queries)), t(reach2), tuple(map(t, cands)), m, kh=kh, cap=cap,
        n_bisect=nbis,
    )
    hr, rhor, okr = k1_ref(tuple(map(jnp.asarray, queries)), jnp.asarray(reach2),
                           tuple(map(jnp.asarray, cands)), m, kh=kh, cap=cap,
                           interpret=True, n_bisect=nbis)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okr))
    assert (ok.numpy() == 0).sum() >= 8 and (ok.numpy() == 1).sum() > 100
    # XLA may contract d2 into FMAs on the CPU: h to the last ulp
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), rtol=np.finfo(queries[0].dtype).eps)
    rtol = 2e-6 if td == torch.float32 else 1e-13
    np.testing.assert_allclose(rho.numpy(), np.asarray(rhor), rtol=rtol)


def _pair_inputs(rng, nb, cap, cw, dtype, n_occ):
    queries, cands = _block_rows(rng, nb, cap, cw, dtype, n_occ)
    nd = queries[0].dtype

    def plane(shape, lo, hi):
        return (lo + (hi - lo) * rng.random(shape)).astype(nd)

    qv = [plane((nb, cap), -0.3, 0.3) for _ in range(3)]
    cv = [plane((nb, cw), -0.3, 0.3) for _ in range(3)]
    for a in range(3):
        cv[a][:, :cap] = qv[a]
    qh, ch = plane((nb, cap), 0.08, 0.12), plane((nb, cw), 0.08, 0.12)
    ch[:, :cap] = qh
    qrho, crho = plane((nb, cap), 0.5, 1.5), plane((nb, cw), 0.5, 1.5)
    qpor2, cpor2 = plane((nb, cap), 0.5, 1.0), plane((nb, cw), 0.5, 1.0)
    qcs = plane((nb, cap), 0.8, 1.2)
    x, y, z, qm = queries
    cx, cy, cz, cm = cands
    qf = [x, y, z, *qv, qm, qh, qrho, qpor2, qcs]
    cf = [cx, cy, cz, *cv, cm, ch, crho, cpor2]  # the K6 order
    return qf, cf


def _assert_close_of_scale(outs, refs, bar):
    for i, (a, b) in enumerate(zip(outs, refs)):
        a, b = np.asarray(a), np.asarray(b)
        live = b > -np.finfo(b.dtype).max
        sc = np.abs(b[live]).max() + 1e-30
        assert np.array_equal(live, a > -np.finfo(a.dtype).max), i
        assert np.abs(np.where(live, a - b, 0)).max() / sc < bar, i


@pytest.mark.parametrize("p3m", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k5_k6_match_pallas(dtype, p3m):
    """K5 (two buckets in one flat chunk list) and K6 (one bucket of
    C_b = 2560, which the reference's wrapper splits into two 1280-wide
    launches) as plain versions against the Pallas kernels interpreted:
    every query- and candidate-side output within 6e-6 (float32) / 1e-12
    (float64) of its scale, mu_max's masked rows identical. In float32
    under p3m the Pallas kernels run in float64 on the same float32-rounded
    inputs: the port takes a close pair's two gravity corrections summed in
    float64, the reference in float32 (ROADMAP F7)."""
    td = getattr(torch, dtype)
    rng = np.random.default_rng(11 + p3m)
    cap = TB.BQ
    sigma, r_c = (0.05, 0.22) if p3m else (None, 0.0)
    bar = 6e-6 if td == torch.float32 else 1e-12
    kw = dict(eos="polytropic", p3m=p3m, cap=cap)
    args = (1e-3, 1.0, 2.0, sigma, r_c)
    jd = jnp.float64 if p3m else None

    def j(a):
        return jnp.asarray(a, jd)

    # K6
    qf, cf = _pair_inputs(rng, 2, cap, 2560, td, 2200)
    qo, co = cuda_block_pairs.phase_b_blocks(list(map(t, qf)), list(map(t, cf)), *args, **kw)
    qo_r, co_r = k6_ref(tuple(map(j, qf)), tuple(map(j, cf)), *args, **kw, interpret=True)
    _assert_close_of_scale(qo, qo_r, bar)
    _assert_close_of_scale(co, co_r, bar)

    # K5: bucket (512, 1 block) then (1024, 2 blocks): five chunks
    qf, cf = _pair_inputs(rng, 3, cap, 1024, td, 900)
    cf[6][0, 512:] = 0.0  # block 0 is a 512-slot bucket
    order = (0, 1, 2, 3, 4, 5, 7, 8, 9, 6)
    flat = np.concatenate([np.stack([cf[k][0, :512] for k in order])[None]] + [
        np.stack([cf[k][b, j * 512:(j + 1) * 512] for k in order])[None]
        for b in (1, 2) for j in (0, 1)
    ])  # (5, 10, 512)
    qblk, first = (0, 1, 1, 2, 2), (1, 1, 0, 1, 0)
    kw5 = dict(kw, qblk=qblk, first=first)
    qo, co = cuda_grouped_pairs.phase_b_grouped(list(map(t, qf)), t(flat), *args, **kw5)
    qo_r, co_r = k5_ref(tuple(map(j, qf)), j(flat), *args, **kw5, interpret=True)
    _assert_close_of_scale(qo, qo_r, bar)
    _assert_close_of_scale(co, co_r, bar)


@pytest.mark.parametrize("p3m", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k6_legacy_width_matches_pallas(dtype, p3m):
    """K6's plain version at a legacy plan's C_b = 768 (not a multiple of
    the grouped layout's 512-slot chunk; one launch of the reference's
    wrapper) against the Pallas kernel interpreted, with
    test_k5_k6_match_pallas' bars and its float64 reference for float32
    under p3m."""
    td = getattr(torch, dtype)
    rng = np.random.default_rng(41 + p3m)
    cap = TB.BQ
    sigma, r_c = (0.05, 0.22) if p3m else (None, 0.0)
    bar = 6e-6 if td == torch.float32 else 1e-12
    kw = dict(eos="polytropic", p3m=p3m, cap=cap)
    args = (1e-3, 1.0, 2.0, sigma, r_c)
    jd = jnp.float64 if p3m else None
    qf, cf = _pair_inputs(rng, 2, cap, 768, td, 700)
    qo, co = cuda_block_pairs.phase_b_blocks(list(map(t, qf)), list(map(t, cf)), *args, **kw)
    qo_r, co_r = k6_ref(tuple(jnp.asarray(a, jd) for a in qf),
                        tuple(jnp.asarray(a, jd) for a in cf), *args, **kw, interpret=True)
    assert co[0].shape == (2, 768)
    _assert_close_of_scale(qo, qo_r, bar)
    _assert_close_of_scale(co, co_r, bar)


@pytest.mark.parametrize("eos", ["polytropic", "isothermal"])
def test_close_pairs_p3m_float32_near_float64(eos):
    """Rows holding a partner 1e-4 from every query (z = r / (sqrt2 sigma)
    ~ 1.4e-3, well inside the softening radius), under P3M: a pair there
    takes softened - Newtonian plus Newtonian - mesh, whose 1/r^3 parts
    cancel (ROADMAP F7). The float64 pair sums are the reference's
    (Pallas kernel interpreted) within 1e-12 of each output's scale, and
    the float32 ones, which take such a pair's two corrections in float64,
    within chip_smoke's check_phase_b bar (2e-5 of the scale) of the
    float64 ones (3.4e-7 when written); the reference's float32 sums, which
    add the two corrections in float32, are 1.4e-2 of the scale off there."""
    rng = np.random.default_rng(5)
    qf, cf = _block_rows(rng, 2, TB.BQ, 1024, torch.float64, 900)
    qh = np.full((2, TB.BQ), 0.06)
    ch = np.full((2, 1024), 0.06)
    for a in range(3):  # a partner 1e-4 from every query
        cf[a][:, TB.BQ : 2 * TB.BQ] = qf[a] + (1e-4 if a == 0 else 0.0)
    vq = [0.1 * rng.standard_normal((2, TB.BQ)) for _ in range(3)]
    vc = [0.1 * rng.standard_normal((2, 1024)) for _ in range(3)]
    ones_q, ones_c = np.ones((2, TB.BQ)), np.ones((2, 1024))
    # rounded to float32 once: every evaluation below sees the same inputs
    qfields = [a.astype(np.float32).astype(np.float64)
               for a in (*qf[:3], *vq, qf[3], qh, ones_q, 0.3 * ones_q, ones_q)]
    cfields = [a.astype(np.float32).astype(np.float64)
               for a in (*cf[:3], *vc, cf[3], ch, ones_c, 0.3 * ones_c)]
    args = (1e-5, 1.0, 2.0, 0.05, 0.22)
    kw = dict(eos=eos, p3m=True, cap=TB.BQ)
    q64, c64 = cuda_block_pairs.phase_b_blocks(list(map(t, qfields)), list(map(t, cfields)),
                                               *args, **kw)
    q_r, c_r = k6_ref(tuple(map(jnp.asarray, qfields)), tuple(map(jnp.asarray, cfields)), *args,
                      **kw, interpret=True)
    _assert_close_of_scale(q64, q_r, 1e-12)
    _assert_close_of_scale(c64, c_r, 1e-12)
    q32, c32 = cuda_block_pairs.phase_b_blocks(
        [t(a).float() for a in qfields], [t(a).float() for a in cfields], *args, **kw)
    for a, b in zip(q32 + c32, q64 + c64):
        live = b > -torch.finfo(torch.float64).max
        scale = float(b[live].abs().max())
        err = (a.double() - b).abs()[live]
        assert float(err.max()) <= 2e-5 * scale


# ------------------------------------------------- (5b) K5's work units
@functools.lru_cache(maxsize=None)
def _fixture_plan(source, gravity):
    pos, h, kh = _planner_state(source)
    spec, args = TB.plan_blocks(pos, h, kh, gravity=gravity)
    return pos, h, spec, args


@pytest.mark.parametrize("unit_slots", [512, 2048, 8192])
@pytest.mark.parametrize("source", ["contrast395", "contrast1001"])
def test_unit_table_covers_every_slot_once(source, unit_slots):
    """K5's work units on a committed fixture's chunk layout: read in unit
    order, their chunk runs are the chunks 0 .. n_chunks - 1, each once and
    in order; a unit's chunks are its block's, no unit holds more than
    unit_slots slots, a block's units differ by at most one chunk, and
    ustart delimits each block's units."""
    _, _, spec, _ = _fixture_plan(source, "exact")
    buckets = spec[0]
    qblk, first = TB._grouped_chunks(tuple(buckets))
    nb = sum(n for _, n in buckets)
    units, ustart = cuda_grouped_pairs.unit_table(qblk, first, nb, unit_slots)
    assert units.dtype == np.int32 and ustart.dtype == np.int32
    blk, c0, cnt = (units[:, i].astype(np.int64) for i in range(3))
    covered = np.concatenate([np.arange(a, a + c) for a, c in zip(c0, cnt)])
    np.testing.assert_array_equal(covered, np.arange(len(qblk)))
    np.testing.assert_array_equal(np.asarray(qblk)[covered], np.repeat(blk, cnt))
    assert (cnt >= 1).all() and (cnt * cuda_grouped_pairs.CW <= unit_slots).all()
    assert ustart[0] == 0 and ustart[-1] == len(units) and len(ustart) == nb + 1
    for b in range(nb):
        mine = cnt[ustart[b] : ustart[b + 1]]
        assert (blk[ustart[b] : ustart[b + 1]] == b).all()
        assert mine.size and mine.max() - mine.min() <= 1
    with pytest.raises(ValueError, match="multiple"):
        cuda_grouped_pairs.unit_table(qblk, first, nb, 700)


def _fixture_layout(gravity, n_buckets=4):
    """The committed contrast-395 fixture's plan, cut to the first block of
    each of its n_buckets narrowest buckets: the phase-B inputs of those
    blocks (the fixture's positions and h, seeded velocities and EOS
    fields) in the grouped layout, with (qblk, first), sigma and r_c."""
    pos, h, spec, args = _fixture_plan("contrast395", gravity)
    n = pos.shape[0]
    rng = np.random.default_rng(23)
    vel = 0.1 * rng.standard_normal((n, 3))
    rho = 0.5 + rng.random(n)
    por2, cs = 0.5 + rng.random(n), 0.8 + 0.4 * rng.random(n)
    rows_f = np.concatenate([pos.T, vel.T, [h, rho, por2, cs]])  # (10, n)
    rows_f = np.concatenate([rows_f, np.zeros((10, 1))], axis=1)  # sentinel row n
    bargs = TB.block_args_to_device(args, torch.float64, "cpu")
    oc = np.append(np.asarray(args.order_c, np.int64), n)
    oq = np.asarray(args.order_q, np.int64)
    qf, chunks, qblk, first = [], [], [], []
    b0 = 0
    for k, ((C_b, nb), bx, rz) in enumerate(zip(spec[0], bargs.boxes, spec[2])):
        if k == n_buckets:
            break
        idx = TB._cand_indices(bx[:1], bargs.starts, rz, n, C_b).numpy()[0]
        rows = oc[idx]
        c = rows_f[[0, 1, 2, 3, 4, 5, 6, 7, 8]][:, rows]
        c = np.concatenate([c, (rows < n)[None].astype(np.float64)])  # (10, C_b)
        chunks += [c[:, j : j + cuda_grouped_pairs.CW]
                   for j in range(0, C_b, cuda_grouped_pairs.CW)]
        qblk += [k] * (C_b // cuda_grouped_pairs.CW)
        first += [1] + [0] * (C_b // cuda_grouped_pairs.CW - 1)
        q = oq[b0 * TB.BQ : (b0 + 1) * TB.BQ]
        qrows = rows_f[:, np.minimum(q, n)]
        qf.append(np.concatenate([qrows[:6], (q < n)[None].astype(np.float64),
                                  qrows[6:]]))  # x y z vx vy vz mask h rho por2 cs
        b0 += nb
    qfields = tuple(t(np.ascontiguousarray(np.stack(qf)[:, f])) for f in range(11))
    half = float(np.abs(pos).max())
    sigma = 2.2 * 2.0 * half / (5 * spec[3]) if gravity == "p3m" else None
    r_c = 4.4 * sigma if gravity == "p3m" else 0.0
    return qfields, t(np.stack(chunks)), tuple(qblk), tuple(first), sigma, r_c


@pytest.mark.parametrize("unit_slots", [512, 1024])
@pytest.mark.parametrize("gravity", ["exact", "p3m"])
def test_unit_partials_in_order_match_plain(gravity, unit_slots):
    """K5's form on the committed fixture's layout (the first block of its
    four narrowest buckets, 512 to 2048 slots): each work unit's query-side
    partials and candidate-side sums from its own chunks, the partials of a
    block's units combined in unit order (mu_max by max), equal
    phase_b_grouped_plain over the whole layout: mu_max bit for bit, every
    sum within 1e-13 of its output's scale (float64 reassociation)."""
    qfields, cstack, qblk, first, sigma, r_c = _fixture_layout(gravity)
    nb = qfields[0].shape[0]
    args = (1e-5, 1.0, 2.0, sigma, r_c)
    kw = dict(eos="polytropic", p3m=gravity == "p3m", cap=TB.BQ)
    q_p, c_p = cuda_grouped_pairs.phase_b_grouped_plain(qfields, cstack, *args, **kw,
                                                        qblk=qblk, first=first)
    units, ustart = cuda_grouped_pairs.unit_table(qblk, first, nb, unit_slots)
    assert len(units) > nb  # some block is split
    q_m = [torch.zeros_like(q_p[0]) for _ in range(10)]
    q_m[4].fill_(-torch.finfo(torch.float64).max)
    c_m = torch.empty_like(c_p)
    for b, c0, cnt in units.tolist():
        qs, cs = cuda_grouped_pairs.phase_b_grouped_plain(
            tuple(f[b : b + 1] for f in qfields), cstack[c0 : c0 + cnt], *args, **kw,
            qblk=(0,) * cnt, first=(1,) + (0,) * (cnt - 1))
        for i in range(10):
            q_m[i][b] = torch.maximum(q_m[i][b], qs[i][0]) if i == 4 else q_m[i][b] + qs[i][0]
        c_m[c0 : c0 + cnt] = cs
    assert torch.equal(q_m[4], q_p[4])
    live = q_p[6] != 0
    assert bool(live.any()), "the layout has pairs inside the visibility radius"
    for a, b in [*zip(q_m, q_p), *zip(c_m.unbind(1), c_p.unbind(1))]:
        scale = float(b[b > -torch.finfo(b.dtype).max].abs().max()) + 1e-300
        assert float((a - b).abs().max()) <= 1e-13 * scale


# ------------------------------------------------------ (5c) K6's work units
@pytest.mark.parametrize("gravity", ["exact", "p3m"])
@pytest.mark.parametrize("cw", [256, 300, 700, 768, 1300, 2049, 3072, 5000])
def test_block_unit_partials_in_order_match_plain(cw, gravity):
    """K6's form on the CPU: each work unit of a block (one staged piece of
    256 slots, [j 256, min((j + 1) 256, cw)), the last one partial where
    256 does not divide cw) summed on its own slots, the units' query-side
    partials combined in unit order (mu_max by max), equal
    phase_b_blocks_plain over the whole row: mu_max and the candidate-side
    sums bit for bit (each slot lies in one unit), the query-side sums
    within 1e-13 of their output's scale (float64 reassociation)."""
    rng = np.random.default_rng(31)
    piece = 256
    qf, cf = _pair_inputs(rng, 2, TB.BQ, cw, torch.float64, cw - cw // 8)
    qf, cf = [t(a) for a in qf], [t(a) for a in cf]
    sigma, r_c = (0.05, 0.22) if gravity == "p3m" else (None, 0.0)
    args = (1e-3, 1.0, 2.0, sigma, r_c)
    kw = dict(eos="polytropic", p3m=gravity == "p3m", cap=TB.BQ)
    q_p, c_p = cuda_block_pairs.phase_b_blocks_plain(qf, cf, *args, **kw)
    q_m = [torch.zeros_like(q_p[0]) for _ in range(10)]
    q_m[4].fill_(-torch.finfo(torch.float64).max)
    c_m = [torch.empty_like(c) for c in c_p]
    for lo in range(0, cw, piece):
        hi = min(lo + piece, cw)
        qs, cs = cuda_block_pairs.phase_b_blocks_plain(
            qf, [c[:, lo:hi].contiguous() for c in cf], *args, **kw)
        for i in range(10):
            q_m[i] = torch.maximum(q_m[i], qs[i]) if i == 4 else q_m[i] + qs[i]
        for a, b in zip(c_m, cs):
            a[:, lo:hi] = b
    assert torch.equal(q_m[4], q_p[4])
    for a, b in zip(c_m, c_p):
        assert torch.equal(a, b)
    assert bool((q_p[0] != 0).any()), "the rows have pairs inside the forward ball"
    for a, b in zip(q_m, q_p):
        scale = float(b[b > -torch.finfo(b.dtype).max].abs().max()) + 1e-300
        assert float((a - b).abs().max()) <= 1e-13 * scale


# ------------------------------------------------------- (6) certificate
def test_stale_args_fail_certificate():
    """BlockArgs built for a different state (a coherent shift of ~20
    typical balls) must fail the in-engine certificate."""
    pos, vel, K, h0, spec, args = _plan("core_halo", "exact")
    shift = np.array([20.0 * float(np.median(h0)), 0.0, 0.0])
    red, _, ok = TB.block_sph_forces(
        t(pos + shift), t(vel), 1.0 / pos.shape[0], t(K), t(h0), args, spec=spec,
        **{k: v for k, v in _kw("core_halo", "exact", "polytropic").items()},
    )
    assert not bool(ok)
    _, _, ok2 = TB.block_sph_forces(
        t(pos), t(vel), 1.0 / pos.shape[0], t(K), t(h0), args, spec=spec,
        **_kw("core_halo", "exact", "polytropic"),
    )
    assert bool(ok2)


@pytest.mark.parametrize("gravity", ["exact", "p3m"])
def test_certificate_under_drift_matches_reference(gravity):
    """The plan of a state evaluated after a 1 % homologous expansion: the
    port's certificate gives the reference's verdict. Under exact gravity
    it holds; under p3m it fails, as the reference's does — the tail radius
    r_c is covered with no drift margin (ROADMAP F6)."""
    pos, vel, K, h0, spec, args = _plan("core_halo", gravity)
    p1 = 1.01 * pos
    kw = _kw("core_halo", gravity, "polytropic")
    _, _, ok_ref = RB.block_sph_forces(
        jnp.asarray(p1), jnp.asarray(vel), 1.0 / pos.shape[0], jnp.asarray(K),
        jnp.asarray(h0), _ref_args(args), spec=spec, **kw)
    _, _, ok = TB.block_sph_forces(t(p1), t(vel), 1.0 / pos.shape[0], t(K), t(h0), args,
                                   spec=spec, **kw)
    assert bool(ok) == bool(ok_ref) == (gravity == "exact")


# ---------------------------------------------------- (7) chunk runner
PARAMS = dict(gamma=5 / 3, cs0=0.0, alpha=1.0, beta=2.0, U0=0.0, t_end=1e9)


def _chunk_inputs(scene):
    pos, vel, K, h0, spec, args = _plan(scene, "exact")
    n = pos.shape[0]
    return pos, vel, K, h0, spec, args, dict(PARAMS, m=1.0 / n)


def test_chunk_matches_gather_and_reference():
    """Three KDK steps on cfg.blocks: the JAX package's block chunk runner
    and the port's gather trajectory agree with the port's block chunk,
    with 0 fallbacks; the refit of the final state keeps the spec and
    still certifies."""
    pos, vel, K, h0, spec, args, par = _chunk_inputs("core_halo")
    n, kh = pos.shape[0], SCENES["core_halo"][1]
    cfg_ref = ref_engine.EngineConfig(n=n, kh=kh, eos="polytropic", dtype="float64",
                                      blocks=spec)
    cfg = config_from_reference(dataclasses.asdict(cfg_ref))
    assert cfg == EngineConfig(n=n, kh=kh, eos="polytropic", dtype="float64", blocks=spec)
    st = state_from_numpy(pos, vel, K, 0.0, dtype="float64", device="cpu")
    p = params_from_numpy(**par, dtype="float64", device="cpu")
    out = make_chunk_runner(cfg, device="cpu")(st, p, t(h0), 3, args)
    gat = make_chunk_runner(EngineConfig(n=n, kh=kh, eos="polytropic", dtype="float64"),
                            device="cpu")(st, p, t(h0), 3)
    jd = jnp.float64
    ref = ref_engine.make_chunk_runner(cfg_ref)(
        ref_engine.State(pos=jnp.asarray(pos), vel=jnp.asarray(vel), K=jnp.asarray(K),
                         t=jnp.asarray(0.0, jd)),
        ref_engine.Params(**{k: jnp.asarray(v, jd) for k, v in par.items()}),
        jnp.asarray(h0), n_steps=3, mlargs=_ref_args(args),
    )
    assert out[5].tolist() == [0, 0, 0] and out[2].all()
    assert np.asarray(ref[5]).sum() == 0
    scale = np.abs(pos).max()
    for other in (gat[0].pos.numpy(), np.asarray(ref[0].pos)):
        np.testing.assert_allclose(out[0].pos.numpy(), other, rtol=1e-8, atol=1e-10 * scale)
    np.testing.assert_allclose(out[1].numpy(), gat[1].numpy(), rtol=1e-7)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), rtol=1e-8)
    np.testing.assert_allclose(out[3].numpy(), np.asarray(ref[3]), rtol=1e-12)

    pos2, h2 = out[0].pos.numpy(), out[3].numpy()
    args2 = TB.block_args_for_spec(pos2, h2, spec)
    assert args2 is not None
    _, _, ok2 = TB.block_sph_forces(
        out[0].pos, out[0].vel, 1.0 / n, out[0].K, out[3], args2, spec=spec,
        **_kw("core_halo", "exact", "polytropic"),
    )
    assert bool(ok2)


# ---------------------------------------------------------- (8) planner rung
@pytest.mark.parametrize("gravity", ["exact", "p3m"])
def test_plan_engine_plans_blocks_where_tiles_refuse(gravity):
    """On a subsample of the contrast-395 collapse state neither tile planner
    can plan; plan_engine returns the block config the reference's planner
    gives, with its BlockArgs."""
    from sphtpu.physics.ctiles import choose_tile_classes
    from sphtpu.physics.tiles import choose_tile_params
    from sphtpu_torch.engine.driver import plan_engine

    d = np.load(FIXTURES["contrast395"])
    pos = d["pos"][::10].astype(np.float64)
    kh = 32
    dk, _ = cKDTree(pos).query(pos, k=kh)
    h = dk[:, -1] / 2
    assert choose_tile_params(pos, h, kh, headroom=1.5) is None
    assert choose_tile_classes(pos, h, kh, headroom=1.5) is None
    cfg, bargs = plan_engine(pos, h, n=pos.shape[0], kh=kh, eos="polytropic",
                             dtype="float32", gravity=gravity)
    ref = RB.plan_blocks(pos, h, kh, gravity=gravity)
    assert cfg.blocks == ref[0] and cfg.gravity == gravity and cfg.tile is None
    _assert_args_equal(bargs, ref[1])


# ------------------------------------------------------ (9) fallback none
def test_fallback_none_discards_failed_steps():
    """fallback="none" on a block config whose BlockArgs are stale: as the
    reference does, every step is discarded (state and h unchanged, stats
    and rho zeroed, 2 fallbacks a step) and — the reference's fault F1,
    kept — still reported valid."""
    pos, vel, K, h0, spec, args, par = _chunk_inputs("core_halo")
    n, kh = pos.shape[0], SCENES["core_halo"][1]
    p = params_from_numpy(**par, dtype="float64", device="cpu")
    cfg = EngineConfig(n=n, kh=kh, eos="polytropic", dtype="float64", blocks=spec,
                       fallback="none")
    shifted = pos + np.array([20.0 * float(np.median(h0)), 0.0, 0.0])
    st = state_from_numpy(shifted, vel, K, 0.0, dtype="float64", device="cpu")
    state, stats, valid, h_last, rho_last, nfb = make_chunk_runner(cfg, device="cpu")(
        st, p, t(h0), 2, args)
    assert nfb.tolist() == [2, 2] and valid.tolist() == [True, True]
    assert float(state.t) == 0.0 and not stats.any() and not rho_last.any()
    np.testing.assert_array_equal(state.pos.numpy(), shifted)
    np.testing.assert_array_equal(h_last.numpy(), h0)


# ------------------------------------------- (10) the tail radius's margin
def test_tail_margin_certifies_under_drift():
    """ROADMAP D19 (the repair of F6): core_halo planned under p3m with
    the drift margin on the tail radius (tail_margin=R_TAIL_MARGIN, what
    the run loop passes), then expanded by 1 % and moved by a drift of
    0.05 h a row (seeded): the port's certificate holds, where the plan
    without the margin fails (the reference's, kept by the default: its
    plan still equals the reference planner's), and the forces equal the
    port's gather engine within
    test_forces_f64_match_reference_and_gather's bars. The gravity
    corrections, which carry the tail radius that the margin covers, equal
    two evaluations of the moved state on a fresh plan of it (no margin):
    the port's, at that test's exact-gravity bars (a pair the margin plan
    left out, even one at the tail radius, would show), and the
    reference's, at 2e-6 of the scale: one pair sits at a row's ball edge
    (r = 2 h to the last bit) where the two libraries' rsqrt round apart,
    so its ownership weight differs (that test's note; 1.4e-6 of the
    scale here)."""
    from sphtpu_torch.physics import sph_forces

    pos, vel, K, h0, spec_ref, args_ref = _plan("core_halo", "p3m")
    kh = SCENES["core_halo"][1]
    spec0, args0 = TB.plan_blocks(pos, h0, kh, gravity="p3m")
    assert spec0 == spec_ref
    _assert_args_equal(args0, args_ref)
    spec, args = TB.plan_blocks(pos, h0, kh, gravity="p3m", tail_margin=TB.R_TAIL_MARGIN)
    rng = np.random.default_rng(29)
    p1 = 1.01 * pos + 0.05 * h0[:, None] * rng.standard_normal(pos.shape)
    kw = _kw("core_halo", "p3m", "polytropic")
    m = 1.0 / pos.shape[0]
    _, _, ok0 = TB.block_sph_forces(t(p1), t(vel), m, t(K), t(h0), args0, spec=spec0, **kw)
    red, gcorr, ok = TB.block_sph_forces(t(p1), t(vel), m, t(K), t(h0), args, spec=spec, **kw)
    assert bool(ok) and not bool(ok0)
    spec1, args1 = TB.plan_blocks(p1, h0, kh, gravity="p3m")
    _, gcorr1, ok1 = TB.block_sph_forces(t(p1), t(vel), m, t(K), t(h0), args1, spec=spec1, **kw)
    jd = jnp.float64
    _, gcorr_r, ok_r = RB.block_sph_forces(
        *(jnp.asarray(x, jd) for x in (p1, vel)), m, *(jnp.asarray(x, jd) for x in (K, h0)),
        _ref_args(args1, jd), spec=spec1, **kw)
    assert bool(ok1) and bool(ok_r)
    for a, b, c in zip(gcorr, gcorr1, gcorr_r):
        b, c = b.numpy(), np.asarray(c)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-11 * np.abs(b).max())
        np.testing.assert_allclose(a.numpy(), c, rtol=1e-9, atol=2e-6 * np.abs(c).max())
    orc = sph_forces(t(p1), t(vel), m, t(K), eos="polytropic", kh=kh, cs0=0.0, **PHYS)
    np.testing.assert_allclose(red.h.numpy(), orc.h.numpy(), rtol=1e-12)
    np.testing.assert_allclose(red.rho.numpy(), orc.rho.numpy(), rtol=1e-11)
    for k in ("acc", "div_sum", "visc_dk"):
        b = getattr(orc, k).numpy()
        np.testing.assert_allclose(getattr(red, k).numpy(), b, rtol=1e-9,
                                   atol=1e-11 * np.abs(b).max(), err_msg=k)
    np.testing.assert_allclose(red.mu_max.numpy(), orc.mu_max.numpy(), rtol=1e-9, atol=1e-13)


# ------------------------------- (11) the work-sharded engine under p3m
def test_workshard_p3m_eval_matches_reference():
    """The block engine's evaluation work-sharded over two CPU shards
    (physics/blocks.block_forces_body with its shard arguments, run in
    lock step) under p3m against the reference's single-device XLA
    evaluation of the same plan (the module's cached call): the bars of
    test_forces_f64_match_reference_and_gather under p3m."""
    from sphtpu_torch.shard.collectives import run_spmd

    pos, vel, K, h0, spec, args = _plan("core_halo", "p3m")
    kw = _kw("core_halo", "p3m", "polytropic")
    bargs = TB.block_args_to_device(args, torch.float64, "cpu")
    outs = run_spmd([
        TB.block_forces_body(t(pos), t(vel), 1.0 / pos.shape[0], t(K), t(h0), bargs,
                             spec=spec, shard=k, n_shards=2, **kw)
        for k in range(2)
    ])
    red, gcorr, ok = outs[0]
    assert all(bool(o[2]) for o in outs)
    ref = _ref_forces("core_halo", "p3m", "polytropic", "float64", "xla")
    assert ref["ok"]
    np.testing.assert_allclose(red.h.numpy(), ref["h"], rtol=1e-12)
    np.testing.assert_allclose(red.rho.numpy(), ref["rho"], rtol=1e-11)
    for k in ("acc", "div_sum", "visc_dk", "mu_max", "cs"):
        sc = np.abs(ref[k]).max()
        np.testing.assert_allclose(getattr(red, k).numpy(), ref[k], rtol=1e-9,
                                   atol=1e-11 * sc, err_msg=k)
    for a, b in zip(torch.stack(gcorr).numpy(), ref["gcorr"]):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-7 * np.abs(b).max())
