"""The multi-device layer's host planners, collectives and far field, on
the CPU.

The slab planner (`plan_slabs`, `plan_slabs_from_hists`,
`slab_plan_still_ok`) and the pack permutation (`pack_state`,
`unpack_rows`) are numpy and must equal sphtpu.shard.tiles' bit for bit:
on the N = 4 000 sphere of tests/test_shard_tiles.py (Kh 16) at 2, 3, 4
and 8 shards, where the reference plans hops 1, 2 and 3 and then None, and
on the committed collapse states (k = 50 KD-tree h), where it plans None.
The collectives are held against numpy on three shards, and the sharded
engines' far fields (the slab engine's ring, the work-sharded engines' row
split; K3's rows x columns entry's plain version on the CPU) against the
reference's gravity_newton_allpairs in float64 (rtol 1e-12)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from scipy.spatial import cKDTree

import jax
from sphtpu.physics.gravity import gravity_newton_allpairs as newton_ref
from sphtpu.shard.tiles import AXIS
from sphtpu.shard.tiles import pack_state as pack_state_ref
from sphtpu.shard.tiles import plan_slabs as plan_slabs_ref
from sphtpu.shard.tiles import plan_slabs_from_hists as hists_ref
from sphtpu.shard.tiles import slab_plan_still_ok as still_ok_ref
from sphtpu.shard.tiles import unpack_rows as unpack_rows_ref
from sphtpu_torch.engine.config import State, state_from_numpy
from sphtpu_torch.kernels.cuda_gravity_rc import newton_rows_cols
from sphtpu_torch.shard import collectives as C
from sphtpu_torch.shard.mlevel import _newton_rows_sharded
from sphtpu_torch.shard.tiles import (
    _newton_ring,
    pack_state,
    plan_slabs,
    plan_slabs_from_hists,
    real_rows,
    slab_plan_still_ok,
    unpack_rows,
    unpack_state,
)

torch.set_num_threads(2)

BENCH = os.path.join(os.path.dirname(__file__), "..", "..", "bench_data")


def sphere_state(n, seed=7, vel_scale=0.05):
    """tests/test_shard_tiles.py::_sphere_state, in numpy."""
    rng = np.random.default_rng(seed)
    u = rng.random((n, 3))
    r = u[:, 0] ** (1 / 3)
    costh = 2 * u[:, 1] - 1
    phi = 2 * np.pi * u[:, 2]
    sinth = np.sqrt(1 - costh**2)
    pos = np.stack([r * sinth * np.cos(phi), r * sinth * np.sin(phi), r * costh], axis=1)
    vel = vel_scale * rng.standard_normal((n, 3))
    K = 0.02 + 0.002 * rng.random(n)
    return pos, vel, K


def kd_h(pos, kh):
    d, _ = cKDTree(pos).query(pos, k=kh)
    return d[:, -1] / 2.0


@pytest.fixture(scope="module")
def sphere():
    pos, vel, K = sphere_state(4000)
    return pos, vel, K, kd_h(pos, 16)


def _assert_plans_equal(p, r):
    if r is None:
        assert p is None
        return
    assert p is not None
    for f in ("grid", "cap", "lz_max", "halo", "hops", "budget", "n_loc", "n_dev", "half"):
        assert getattr(p, f) == getattr(r, f), f
    np.testing.assert_array_equal(p.z0s, r.z0s)
    np.testing.assert_array_equal(p.order, r.order)


@pytest.mark.parametrize("n_dev,hops", [(2, 1), (3, 2), (4, 3), (8, None)])
def test_plan_slabs_bit_equal_sphere(sphere, n_dev, hops):
    pos, _, _, h = sphere
    p = plan_slabs(pos, h, 16, n_dev)
    _assert_plans_equal(p, plan_slabs_ref(pos, h, 16, n_dev))
    assert (p.hops if p is not None else None) == hops


@pytest.mark.parametrize("n_dev", [2, 3, 4])
@pytest.mark.parametrize("chunk_steps", [2, 4])
def test_plan_slabs_bit_equal_short_chunks(sphere, n_dev, chunk_steps):
    """The driver plans a chunk's slabs for its own length
    (plan_slabs(chunk_steps=n_steps)): a shorter chunk drifts less, so the
    halo and the rings it needs shrink; the plans stay the reference's."""
    pos, _, _, h = sphere
    p = plan_slabs(pos, h, 16, n_dev, chunk_steps=chunk_steps)
    _assert_plans_equal(p, plan_slabs_ref(pos, h, 16, n_dev, chunk_steps=chunk_steps))
    assert p is not None and p.halo <= plan_slabs(pos, h, 16, n_dev).halo


@pytest.mark.parametrize("name", ["bb_collapsed.npz", "bb_collapsed_deep.npz"])
def test_plan_slabs_declines_collapse_states(name):
    """The committed collapse states plan no slabs at 2 and 4 shards (the
    work-sharded engines carry them), as the reference's planner says."""
    pos = np.load(os.path.join(BENCH, name))["pos"].astype(np.float64)
    h = kd_h(pos, 50)
    for n_dev in (2, 4):
        assert plan_slabs_ref(pos, h, 50, n_dev) is None
        assert plan_slabs(pos, h, 50, n_dev) is None


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("chunk_steps", [2, 10])
def test_plan_slabs_from_hists_bit_equal(sphere, n_dev, chunk_steps):
    pos, _, _, h = sphere
    g = 9
    half = float(np.abs(pos).max()) * 1.02
    c = np.clip((pos + half) // (2 * half / g), 0, g - 1).astype(np.int64)
    hist = np.bincount(c[:, 2], minlength=g)
    cmax = int(np.bincount((c[:, 2] * g + c[:, 1]) * g + c[:, 0]).max())
    a = plan_slabs_from_hists(len(pos), half, g, hist, cmax, n_dev, chunk_steps=chunk_steps)
    b = hists_ref(len(pos), half, g, hist, cmax, n_dev, chunk_steps=chunk_steps)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _still_ok_cases(pos, h):
    rng = np.random.default_rng(0)
    flipped = pos.copy()
    flipped[:, 2] = -flipped[:, 2]
    return {
        "same": (pos, h),
        "mild_drift": (pos + 0.05 * np.min(h) * rng.standard_normal(pos.shape), h),
        "escape": (pos * 1.5, h),
        "h_outgrows_cells": (pos, h * 10.0),
        "ownership_torn": (flipped, h),
    }


@pytest.mark.parametrize(
    "case", ["same", "mild_drift", "escape", "h_outgrows_cells", "ownership_torn"]
)
def test_slab_plan_still_ok_matches_reference(sphere, case):
    pos, _, _, h = sphere
    plan = plan_slabs(pos, h, 16, 4)
    plan_r = plan_slabs_ref(pos, h, 16, 4)
    p2, h2 = _still_ok_cases(pos, h)[case]
    got = slab_plan_still_ok(plan, p2, h2)
    assert got == still_ok_ref(plan_r, p2, h2)
    assert got == (case in ("same", "mild_drift"))


@pytest.mark.parametrize("n_dev", [2, 4])
def test_pack_and_unpack_match_reference(sphere, n_dev):
    """The port's per-shard padded rows are the reference's sharded layout
    (8 virtual CPU devices there, CPU shards here), and the unpack inverts
    it (unpack_rows and unpack_state)."""
    pos, vel, K, h = sphere
    n = len(pos)
    plan = plan_slabs(pos, h, 16, n_dev)
    plan_r = plan_slabs_ref(pos, h, 16, n_dev)
    st = state_from_numpy(pos, vel, K, 0.25, dtype="float64", device="cpu")
    mesh = C.particle_mesh(["cpu"] * n_dev)
    sl = pack_state(st, plan, mesh)
    st_r = State(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(K), jnp.asarray(0.25))
    sl_r = pack_state_ref(st_r, plan_r, Mesh(np.array(jax.devices()[:n_dev]), (AXIS,)))
    for f in ("pos", "vel", "K", "valid"):
        got = np.concatenate([getattr(s, f).numpy() for s in sl])
        np.testing.assert_array_equal(got, np.asarray(getattr(sl_r, f)))
    assert [int(s.valid.sum()) for s in sl] == real_rows(plan)
    # each shard's real rows come first (the far field sweeps a prefix)
    for s, k in zip(sl, real_rows(plan)):
        assert bool(s.valid[:k].all()) and not bool(s.valid[k:].any())
    arr = np.concatenate([s.pos.numpy() for s in sl])
    np.testing.assert_array_equal(unpack_rows(arr, plan, n), unpack_rows_ref(arr, plan_r, n))
    back = unpack_state(sl, plan, n)
    np.testing.assert_array_equal(back.pos.numpy(), pos)
    np.testing.assert_array_equal(back.K.numpy(), K)


def _shards(seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((6, 2)) for _ in range(n)]


@pytest.mark.parametrize(
    "op", ["psum", "pmax", "pmin", "all_gather", "psum_scatter", "ppermute"]
)
def test_collectives_match_numpy(op):
    """Each collective over three CPU shards against numpy: shard i's
    result is element i, on shard i's device; tuples go through as one
    value."""
    xs = _shards()
    ts = [torch.from_numpy(x) for x in xs]
    want = {
        "psum": [xs[0] + xs[1] + xs[2]] * 3,
        "pmax": [np.maximum(np.maximum(xs[0], xs[1]), xs[2])] * 3,
        "pmin": [np.minimum(np.minimum(xs[0], xs[1]), xs[2])] * 3,
        "all_gather": [np.concatenate(xs)] * 3,
        "psum_scatter": [(xs[0] + xs[1] + xs[2])[2 * i : 2 * i + 2] for i in range(3)],
        "ppermute": [np.zeros((6, 2)), xs[0], xs[1]],
    }[op]
    kw = {"perm": [(0, 1), (1, 2)]} if op == "ppermute" else {}
    got = C.OPS[op](ts, **kw)
    pair = C.OPS[op]([(t, 2 * t) for t in ts], **kw)
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(), want[i], rtol=1e-15, atol=0)
        np.testing.assert_allclose(pair[i][1].numpy(), 2 * want[i], rtol=1e-15, atol=0)
        assert got[i].device == ts[i].device


def test_run_spmd_lock_step_and_mismatch():
    """run_spmd resumes each body with its share and refuses bodies that
    disagree on the collective; run_local makes every collective the
    identity."""

    def body(x, op):
        y = yield C.request(op, x)
        return y * 2

    out = C.run_spmd([body(torch.tensor(1.0), "psum"), body(torch.tensor(2.0), "psum")])
    assert [float(o) for o in out] == [6.0, 6.0]
    assert float(C.run_local(body(torch.tensor(5.0), "pmax"))) == 10.0
    with pytest.raises(RuntimeError):
        C.run_spmd([body(torch.tensor(1.0), "psum"), body(torch.tensor(2.0), "pmax")])


@pytest.fixture(scope="module")
def newton_reference(sphere):
    pos = sphere[0]
    m = 1.0 / len(pos)
    g, phi = newton_ref(jnp.asarray(pos), m)
    return m, np.asarray(g), np.asarray(phi)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_newton_ring_matches_reference(sphere, newton_reference, n_dev):
    """The slab engine's exact far field (each shard's real rows against
    the blocks rotating around the ring, the rows x columns entry's plain
    version) is the all-pairs Newtonian sweep."""
    pos, vel, K, h = sphere
    n = len(pos)
    m, g_ref, phi_ref = newton_reference
    plan = plan_slabs(pos, h, 16, n_dev)
    mesh = C.particle_mesh(["cpu"] * n_dev)
    sl = pack_state(state_from_numpy(pos, vel, K, 0.0, dtype="float64", device="cpu"), plan, mesh)
    counts = real_rows(plan)
    out = C.run_spmd([
        _newton_ring(s.pos, s.valid, m, k, n_dev, counts) for k, s in enumerate(sl)
    ])
    g = unpack_rows(torch.cat([o[0] for o in out]).numpy(), plan, n)
    phi = unpack_rows(torch.cat([o[1] for o in out]).numpy(), plan, n)
    np.testing.assert_allclose(g, g_ref, rtol=1e-12, atol=1e-12 * np.abs(g_ref).max())
    np.testing.assert_allclose(phi, phi_ref, rtol=1e-12)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_newton_rows_sharded_matches_reference(sphere, newton_reference, n_dev):
    """The work-sharded engines' exact far field (1/P of the rows against
    all N on each shard, then a psum) is the all-pairs Newtonian sweep."""
    m, g_ref, phi_ref = newton_reference
    pos = torch.from_numpy(sphere[0])
    out = C.run_spmd([_newton_rows_sharded(pos, m, k, n_dev) for k in range(n_dev)])
    for g, phi in out:
        np.testing.assert_allclose(
            g.numpy(), g_ref, rtol=1e-12, atol=1e-12 * np.abs(g_ref).max()
        )
        np.testing.assert_allclose(phi.numpy(), phi_ref, rtol=1e-12)


def test_newton_rows_cols_counts_and_weights():
    """The rows x columns entry sweeps the first n_cols columns whose weight
    is > 0, leaves the rows past n_rows at zero, and skips r^2 = 0."""
    rng = np.random.default_rng(1)
    rows = rng.standard_normal((50, 3))
    cols = np.concatenate([rows[:10], rng.standard_normal((70, 3))])
    w = (rng.random(80) > 0.3).astype(np.float64)
    g, phi = newton_rows_cols(
        torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(w), 0.5,
        n_rows=40, n_cols=60,
    )
    d = rows[:40, None, :] - cols[None, :60, :]
    r2 = (d**2).sum(-1)
    keep = (r2 > 0) & (w[None, :60] > 0)
    inv = np.where(keep, 1.0 / np.sqrt(np.where(keep, r2, 1.0)), 0.0)
    np.testing.assert_allclose(g.numpy()[:40], 0.5 * (inv[..., None] ** 3 * d).sum(1), rtol=1e-12)
    np.testing.assert_allclose(phi.numpy()[:40], -0.5 * inv.sum(1), rtol=1e-12)
    assert not g[40:].any() and not phi[40:].any()
