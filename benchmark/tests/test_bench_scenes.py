"""The frozen scene makers: determinism, the turn by the seed, and agreement
with the program's own generator (this test may import the program; the
benchmark's scene makers do not)."""

import math

import numpy as np

from benchmark.manifest import read_json
from benchmark.scenes import generated_cloud, npz_state, rotations, turned

from .conftest import BENCH, ROOT


def small_cloud(n=2000):
    conf = read_json(f"{BENCH}/configs/bb_cloud_2e5.json")
    conf["N"] = n
    return conf


def test_same_seed_same_scene_and_seeds_turn_one_cloud():
    conf = small_cloud()
    a, b, c = (generated_cloud.make(conf, s, ROOT) for s in (7, 7, 2**31 + 11))
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    assert not np.array_equal(a.pos, c.pos)
    # the same cloud, turned: radii, speeds and entropies agree as sets
    for f in (lambda s: np.linalg.norm(s.pos, axis=1), lambda s: np.linalg.norm(s.vel, axis=1),
              lambda s: s.K, lambda s: s.h):
        assert np.allclose(np.sort(f(a)), np.sort(f(c)), rtol=0, atol=1e-15)


def test_a_turn_is_a_rotation_of_the_cube_and_a_permutation():
    rots = rotations()
    assert len({r.tobytes() for r in rots}) == 24
    assert all(round(np.linalg.det(r)) == 1 and (r @ r.T == np.eye(3)).all() for r in rots)
    s = npz_state.make({"state": "benchmark/data/bb_collapsed.npz", "t_end": 1e30}, 0, ROOT)
    t = turned(s, 5)
    rng = np.random.default_rng(5)
    rot = rots[int(rng.integers(24))]
    order = rng.permutation(s.pos.shape[0])
    assert np.array_equal(t.pos, s.pos[order] @ rot.T) and np.array_equal(t.h, s.h[order])
    d_new = np.linalg.norm(t.pos[:500] - t.pos[500:1000], axis=1)
    d_old = np.linalg.norm(s.pos[order[:500]] - s.pos[order[500:1000]], axis=1)
    assert np.allclose(d_new, d_old, rtol=1e-15, atol=0)


def test_the_frozen_generator_agrees_with_the_program():
    from sphtpu_torch import constants as C
    from sphtpu_torch.scenes import generators
    from sphtpu_torch.scenes.setup import DEFAULTS
    from sphtpu_torch.units import UnitSystem

    conf = small_cloud(3000)
    n = conf["N"]
    ours = generated_cloud.boss_bodenheimer(
        n, conf["R_pc"] * generated_cloud.R0_PC, conf["M_sun"] * generated_cloud.M0_SUN,
        A=conf["A"], beta=conf["beta_rot"], rng=np.random.default_rng(conf["rng"]))
    theirs = generators.boss_bodenheimer(
        n, DEFAULTS["R"], DEFAULTS["M"], A=DEFAULTS["A"], beta=DEFAULTS["beta_rot"],
        rng=np.random.default_rng(DEFAULTS["rng"]))
    for x, y in zip(ours, theirs):
        assert np.array_equal(x, y)
    assert (generated_cloud.G_CGS, generated_cloud.KB, generated_cloud.MH) == (C.G_CGS, C.KB, C.MH)
    # the run loop's code units from the setup's constants (R = R_max about the centre)
    scene = generated_cloud.make(conf, 0, ROOT)
    pos = theirs[0]
    r_max = float(np.linalg.norm(pos - pos.mean(axis=0), axis=1).max())
    u = UnitSystem.from_constants(C.G_CGS, DEFAULTS["M"], r_max)
    k_cgs = C.KB * conf["T"] / (DEFAULTS["mu"] * C.MH * theirs[2][0] ** (2.0 / 3.0))
    assert np.allclose(np.sort(np.linalg.norm(scene.pos, axis=1)),
                       np.sort(np.linalg.norm(pos / u.L, axis=1)), rtol=1e-14, atol=0)
    assert math.isclose(scene.K[0], k_cgs / u.K_entropy(5.0 / 3.0), rel_tol=1e-12)
    assert math.isclose(scene.m, 1.0 / n) and scene.t == 0.0
    assert math.isclose(scene.t_end, DEFAULTS["tEnd"] / u.T, rel_tol=1e-12)


def test_the_committed_cloud_is_the_generators_and_loads_turned():
    conf = read_json(f"{BENCH}/configs/bb_cloud_2e5.json")
    made = generated_cloud.cloud(conf)
    d = np.load(f"{ROOT}/{conf['state']}")
    for k in ("pos", "vel", "K"):
        assert d[k].dtype == np.float32
        assert np.array_equal(d[k], getattr(made, k).astype(np.float32)), k
    assert np.allclose(d["h"], made.h, rtol=1e-12, atol=0)
    assert float(d["t"]) == made.t and math.isclose(float(d["m"]), made.m)
    assert math.isclose(conf["t_end"], made.t_end, rel_tol=1e-12)
    # a run's start state: the committed cloud turned by the seed, as the
    # generator's own turn gives it (pos, vel and K as both sides get them)
    seed = 2**31 + 11
    loaded, generated = npz_state.make(conf, seed, ROOT), turned(made, seed)
    for k in ("pos", "vel", "K"):
        assert np.array_equal(getattr(loaded, k).astype(np.float32),
                              getattr(generated, k).astype(np.float32)), k
    assert np.allclose(loaded.h, generated.h, rtol=1e-12, atol=0)
