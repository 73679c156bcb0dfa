"""The multi-process layer over torch.distributed: 2 ranks x 2 CPU shards.

Each test starts two rank processes (this file run as a script, the rank
code below `if __name__ == "__main__"`; gloo over a file rendezvous in the
test's tmp_path, `init_process_group` with a 60 s timeout, the ranks killed
at LIMIT_S) and, while they run, computes its references in this process.
The ranks import neither jax nor sphtpu. Everything is float64 on the CPU,
the ranks at this process's torch thread count.

- Each collective of `OPS`: `run_dist` over 2 ranks equals `run_spmd` over
  the same 4 shards bit for bit (the values made from a seed here and in
  the ranks).
- The work-sharded block chunk (2 steps) on tests/multihost_worker.py's
  fixture (n = 768, seed 7): both ranks identical, bit-equal to the port's
  one-process four-shard chunk, and within the bars of tests/
  test_multihost.py (pos/vel atol 1e-9, K rtol 1e-12, stats rtol 1e-9) of
  the reference's chunk over four devices in this process.
- run_simulation(multihost=True) on gaussian_sphere N = 512, 4 steps, each
  rank on its own copy of the snapshot tree: rank 0 adds snapshots and the
  stats file, rank 1's tree is left as it was; both ranks agree, equal the
  port's one-process four-shard run bit for bit, and the reference's
  run_simulation(n_devices=4) at atol 1e-9.
- The state-sharded slab chunk (shard/mh_slabs.py) on fixture_slabs
  (n = 4096, kh = 8): each rank bootstraps from a contiguous half of the
  rows; both derive the plan of `plan_slabs` on the whole state; the gid
  sets are disjoint and complete; the reassembled state (and rank 0's
  gather_to_primary) equals the port's one-process slab chunk bit for bit
  and the reference's (tests/multihost_worker.run_slabs_reference, four
  devices) at the same bars.
- `mh_plan_slabs` with one rank against the reference's with one process.
"""

import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(HERE)
REPO = os.path.dirname(TESTS)
RANKS, SHARDS = 2, 2  # ranks, shards a rank
LIMIT_S = 120.0  # hard limit of a rank process
THREADS = 2  # torch threads here and in the ranks (float sums depend on it)
PHYS = dict(gamma=5 / 3, cs0=0.0, alpha=1.0, beta=2.0, U0=0.0, t_end=1e9)

if REPO not in sys.path:
    sys.path.insert(0, REPO)
if TESTS not in sys.path:
    sys.path.insert(0, TESTS)  # tests/multihost_worker.py: the fixtures (numpy only)

torch.set_num_threads(THREADS)


# ---------------------------------------------------------------------------
# shared by the ranks and this process (torch only)
# ---------------------------------------------------------------------------


def _op_values(op):
    """(4 shards' values, kw) of one collective, made from a seed."""
    rng = np.random.default_rng(11 + list(OPS_ORDER).index(op))

    def f64(*shape):
        return torch.from_numpy(rng.standard_normal(shape))

    def i64(*shape):
        return torch.from_numpy(rng.integers(-50, 50, shape))

    if op in ("psum", "pmax", "pmin"):
        return [(f64(5, 3), i64(7), f64()) for _ in range(4)], {}
    if op == "all_gather":
        return [(f64(3, 2), torch.from_numpy(rng.random(3) < 0.5)) for _ in range(4)], {"dim": 0}
    if op == "psum_scatter":
        return [(f64(8, 2), f64(4)) for _ in range(4)], {"dim": 0}
    return [(f64(6, 3), i64(6)) for _ in range(4)], {"perm": [(0, 1), (1, 2), (2, 0)]}


OPS_ORDER = ("psum", "pmax", "pmin", "all_gather", "psum_scatter", "ppermute")


def _op_body(value, op, kw):
    """A body of two requests: the op, then a psum of its result's first leaf
    (so the second request depends on the first)."""
    out = yield _request(op, value, **kw)
    first = out[0]
    total = yield _request("psum", first.sum().reshape(1))
    return tuple(out) + (total,)


def _request(op, value, **kw):
    from sphtpu_torch.shard.collectives import request

    return request(op, value, **kw)


def _force_chunk(mesh):
    """The work-sharded block chunk (2 steps) of multihost_worker.fixture
    over `mesh`: (pos, vel, K, t, stats, valid, cert) as float64 numpy."""
    from multihost_worker import KH, fixture
    from sphtpu_torch.engine.config import EngineConfig, params_from_numpy, state_from_numpy
    from sphtpu_torch.physics.blocks import plan_blocks
    from sphtpu_torch.shard.blocks import make_blocks_chunk_runner

    pos, vel, K, h0 = fixture()
    n = pos.shape[0]
    spec, args = plan_blocks(pos, h0, KH, gravity="exact", shards=len(mesh))
    cfg = EngineConfig(n=n, kh=KH, eos="polytropic", dtype="float64", blocks=spec,
                       gravity="exact")
    p = params_from_numpy(m=1.0 / n, **PHYS, dtype="float64", device="cpu")
    st = state_from_numpy(pos, vel, K, 0.0, dtype="float64", device="cpu")
    st2, stats, valid, cert, _, _ = make_blocks_chunk_runner(cfg, mesh)(
        st, p, torch.as_tensor(h0), args, 2)
    return {"pos": st2.pos.numpy(), "vel": st2.vel.numpy(), "K": st2.K.numpy(),
            "t": st2.t.numpy(), "stats": stats.numpy(), "valid": valid.numpy(),
            "cert": cert.numpy()}


def _slab_cfg(plan, n):
    from multihost_worker import SLABS_KH
    from sphtpu_torch.engine.config import EngineConfig, params_from_numpy

    cfg = EngineConfig(n=n, kh=SLABS_KH, eos="polytropic", dtype="float64",
                       tile=(plan.grid, plan.cap), gravity="exact")
    return cfg, params_from_numpy(m=1.0 / n, **PHYS, dtype="float64", device="cpu")


def _run_kw(root):
    return dict(snap_id=1, snap_interval=2, keep_snaps=True, show_plots=False, root=root,
                dtype="float64", max_steps=4, verbose=False)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _rank_ops(rank, out):
    from sphtpu_torch.shard.dist import run_dist
    from sphtpu_torch.shard.multihost import global_mesh

    mesh = global_mesh(["cpu"] * SHARDS)
    res = {}
    for op in OPS_ORDER:
        values, kw = _op_values(op)
        outs = run_dist([_op_body(values[k], op, kw) for k in mesh.local], mesh)
        for k, o in zip(mesh.local, outs):
            for j, t in enumerate(o):
                res[f"{op}_{k}_{j}"] = t.numpy()
    return res


def _rank_force(rank, out):
    from sphtpu_torch.shard import multihost as mh

    mesh = mh.global_mesh(["cpu"] * SHARDS)
    res = _force_chunk(mesh)
    res["primary"] = mh.is_primary()
    return res


def _rank_driver(rank, out, root):
    from sphtpu_torch.engine.driver import run_simulation

    res = run_simulation("polytropic", "gaussian_sphere", **_run_kw(root), multihost=True,
                         shards_per_process=SHARDS, device="cpu")
    st = res["state"]
    return {"steps": res["steps"], "snapshot_ids": np.asarray(res["snapshot_ids"], np.int64),
            "last_stats": res["last_stats_cgs"], "pos": st.pos.numpy(),
            "vel": st.vel.numpy(), "K": st.K.numpy(), "primary": res["primary"],
            "n_devices": res["n_devices"], "engines": np.asarray(res["chunk_engines"])}


def _rank_slabs(rank, out):
    from multihost_worker import SLABS_KH, fixture_slabs
    from sphtpu_torch.shard import multihost as mh
    from sphtpu_torch.shard.mh_slabs import (
        LocalRows, _dev_of_rows, gather_to_primary, mh_local_rows, mh_migrate, mh_pack,
        mh_plan_slabs,
    )
    from sphtpu_torch.shard.tiles import make_slab_chunk_runner

    pos, vel, K, h0 = fixture_slabs()
    n = pos.shape[0]
    # arbitrary bootstrap ownership: rank r starts with the r-th contiguous
    # slice of the rows (not slab-aligned; the migration re-homes them)
    lo, hi = rank * n // RANKS, (rank + 1) * n // RANKS
    local = LocalRows(pos[lo:hi], vel[lo:hi], K[lo:hi], h0[lo:hi], np.arange(lo, hi))
    del pos, vel, K, h0  # nothing global past this point

    mesh = mh.global_mesh(["cpu"] * SHARDS)
    plan = mh_plan_slabs(local, SLABS_KH, len(mesh))
    assert plan is not None, "the slab plan must certify on the uniform ball"
    local = mh_migrate(local, plan, mesh)
    owner = _dev_of_rows(local.pos, plan)
    states, layout = mh_pack(local, plan, mesh, torch.float64, t=0.0)
    assert len(states) == SHARDS and (layout.d0, layout.d1) == (mesh.local.start, mesh.local.stop)
    cfg, p = _slab_cfg(plan, n)
    st2, stats, valid, cert, h_rows, _ = make_slab_chunk_runner(cfg, plan, mesh)(states, p, 2)
    rows = mh_local_rows(st2, h_rows, layout)
    full = gather_to_primary(rows, n)
    res = {"pos": rows.pos, "vel": rows.vel, "K": rows.K, "h": rows.h, "gid": rows.gid,
           "stats": stats.numpy(), "valid": valid.numpy(), "cert": cert.numpy(),
           "static_key": np.asarray(plan.static_key, np.int64), "z0s": plan.z0s,
           "half": plan.half, "rows": np.asarray(plan.rows), "owner": owner,
           "d0": layout.d0, "d1": layout.d1, "primary": mh.is_primary(),
           "gathered": full is not None}
    if full is not None:
        res.update({f"full_{k}": v for k, v in full.items()})
    return res


def _slabs_one_process():
    """The port's one-process four-shard slab chunk on fixture_slabs:
    (pos, vel, K, h in particle order, stats, valid, cert, the plan's
    static key, z0s, half and real rows)."""
    from multihost_worker import SLABS_KH, fixture_slabs
    from sphtpu_torch.engine.config import state_from_numpy
    from sphtpu_torch.shard.tiles import (
        make_slab_chunk_runner, pack_state, plan_slabs, real_rows, unpack_rows, unpack_state,
    )

    pos, vel, K, h0 = fixture_slabs()
    n = pos.shape[0]
    mesh = _one_process_mesh()
    plan = plan_slabs(pos, h0, SLABS_KH, len(mesh))
    cfg, p = _slab_cfg(plan, n)
    st = state_from_numpy(pos, vel, K, 0.0, dtype="float64", device="cpu")
    st2, stats, valid, cert, h_rows, _ = make_slab_chunk_runner(cfg, plan, mesh)(
        pack_state(st, plan, mesh), p, 2)
    one = unpack_state(st2, plan, n)
    return {"pos": one.pos.numpy(), "vel": one.vel.numpy(), "K": one.K.numpy(),
            "h": unpack_rows(np.concatenate([h.numpy() for h in h_rows]), plan, n),
            "stats": stats.numpy(), "valid": valid.numpy(), "cert": cert.numpy(),
            "static_key": np.asarray(plan.static_key, np.int64), "z0s": plan.z0s,
            "half": plan.half, "rows": np.asarray(real_rows(plan))}


RANK_MODES = {"ops": _rank_ops, "force": _rank_force, "driver": _rank_driver,
              "slabs": _rank_slabs}


def _rank_main(argv):
    mode, rank, n_ranks, out = argv[0], int(argv[1]), int(argv[2]), argv[3]
    # the process ends itself at LIMIT_S, even if the test that started it
    # failed before collecting it
    watchdog = threading.Timer(LIMIT_S, os._exit, args=(124,))
    watchdog.daemon = True
    watchdog.start()
    if mode == "slabs_one":  # a process of its own, beside the ranks: no process group
        np.savez(os.path.join(out, "one.npz"), **_slabs_one_process())
        return
    from sphtpu_torch.shard import multihost as mh

    mh.initialize(init_method=f"file://{out}/rdv", num_processes=n_ranks, process_id=rank,
                  backend="gloo", timeout_s=60)
    try:
        res = RANK_MODES[mode](rank, out, *argv[4:])
    finally:
        mh.shutdown()
    np.savez(os.path.join(out, f"r{rank}.npz"), **res)


# ---------------------------------------------------------------------------
# this process: start the ranks, compute the references, collect
# ---------------------------------------------------------------------------


class Ranks:
    """The rank processes of one test, started at once; `results()` waits
    for them (LIMIT_S in all), kills any still running, and raises with
    their logs' tails if one failed."""

    def __init__(self, mode, out, per_rank=lambda r: (), n=RANKS):
        self.out = str(out)
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + TESTS, OMP_NUM_THREADS=str(THREADS))
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks talk over loopback only
        self.logs = [open(os.path.join(self.out, f"{mode}{r}.log"), "w") for r in range(n)]
        self.procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), mode, str(r), str(RANKS), self.out,
                 *map(str, per_rank(r))],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO,
            )
            for r, log in enumerate(self.logs)
        ]
        self.deadline = time.monotonic() + LIMIT_S

    def results(self, files=None):
        """The processes' saved results: files (default r<k>.npz) in out."""
        files = files or [f"r{r}.npz" for r in range(len(self.procs))]
        try:
            for p in self.procs:
                try:
                    p.wait(timeout=max(self.deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in self.logs:
                log.close()
        bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if bad:
            tails = []
            for r in bad:
                with open(self.logs[r].name) as f:
                    tails.append(f"rank {r} (exit {self.procs[r].returncode}):\n{f.read()[-3000:]}")
            raise AssertionError("\n".join(tails))
        return [dict(np.load(os.path.join(self.out, f))) for f in files]


def _one_process_mesh():
    from sphtpu_torch.shard.collectives import particle_mesh

    return particle_mesh(["cpu"] * (RANKS * SHARDS))


def _ref_mesh():
    import jax
    from jax.sharding import Mesh

    from sphtpu.shard.tiles import AXIS

    return Mesh(np.array(jax.devices()[: RANKS * SHARDS]), (AXIS,))


def _assert_ranks_equal(outs, keys):
    for k in keys:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)


@pytest.fixture(scope="module")
def op_ranks(tmp_path_factory):
    return Ranks("ops", tmp_path_factory.mktemp("ops")).results()


@pytest.mark.parametrize("op", OPS_ORDER)
def test_run_dist_equals_run_spmd(op_ranks, op):
    from sphtpu_torch.shard.collectives import run_spmd

    values, kw = _op_values(op)
    ref = run_spmd([_op_body(v, op, kw) for v in values])
    for r, got in enumerate(op_ranks):
        for k in range(r * SHARDS, (r + 1) * SHARDS):
            for j, t in enumerate(ref[k]):
                a = got[f"{op}_{k}_{j}"]
                assert a.dtype == t.numpy().dtype and a.shape == tuple(t.shape)
                np.testing.assert_array_equal(a, t.numpy(), err_msg=f"{op} shard {k} leaf {j}")


def test_multihost_blocks_chunk(tmp_path):
    from multihost_worker import run_force_chunk

    ranks = Ranks("force", tmp_path)
    one = _force_chunk(_one_process_mesh())
    pos_r, vel_r, K_r, _, stats_r = run_force_chunk(_ref_mesh())
    o0, o1 = ranks.results()

    _assert_ranks_equal((o0, o1), ("pos", "vel", "K", "t", "stats", "valid", "cert"))
    assert bool(o0["primary"]) and not bool(o1["primary"])
    assert o0["valid"].all() and not o0["cert"].any()
    for k in one:  # bit-equal to the one-process four-shard chunk
        np.testing.assert_array_equal(o0[k], one[k], err_msg=k)
    np.testing.assert_allclose(o0["pos"], pos_r, rtol=0, atol=1e-9)
    np.testing.assert_allclose(o0["vel"], vel_r, rtol=0, atol=1e-9)
    np.testing.assert_allclose(o0["K"], K_r, rtol=1e-12)
    np.testing.assert_allclose(o0["stats"], stats_r, rtol=1e-9, atol=1e-12)


def _tree(root):
    return sorted(
        (os.path.relpath(os.path.join(d, f), root), os.path.getsize(os.path.join(d, f)),
         os.path.getmtime(os.path.join(d, f)))
        for d, _, fs in os.walk(root) for f in fs
    )


def test_multihost_driver(tmp_path):
    from sphtpu.engine import run_simulation as run_simulation_ref
    from sphtpu.scenes import iniconds_setup as iniconds_setup_ref
    from sphtpu_torch.engine.driver import run_simulation

    roots = {k: str(tmp_path / k) for k in ("r0", "r1", "one", "ref")}
    iniconds_setup_ref("polytropic", "gaussian_sphere", root=roots["r0"], N=512, rng=3)
    for k in ("r1", "one", "ref"):
        shutil.copytree(roots["r0"], roots[k])
    before0, before1 = _tree(roots["r0"]), _tree(roots["r1"])
    out = tmp_path / "out"
    out.mkdir()
    # each rank gets its own tree: rank 0's takes the run's files, rank 1's
    # must stay as it was
    ranks = Ranks("driver", out, lambda r: (roots[f"r{r}"],))

    one = run_simulation("polytropic", "gaussian_sphere", **_run_kw(roots["one"]), n_devices=4,
                         device="cpu")
    ref = run_simulation_ref("polytropic", "gaussian_sphere", **_run_kw(roots["ref"]),
                             n_devices=4)
    o0, o1 = ranks.results()

    assert bool(o0["primary"]) and not bool(o1["primary"])
    assert int(o0["n_devices"]) == int(o1["n_devices"]) == RANKS * SHARDS
    assert set(o0["engines"].tolist()) == {"blocks_sharded"}
    assert o0["snapshot_ids"].size > 0 and o1["snapshot_ids"].size == 0
    names0 = {f for f, _, _ in _tree(roots["r0"])}
    assert names0 > {f for f, _, _ in before0}, "rank 0 must have written snapshots"
    assert any(f.endswith("stats") for f in names0)
    assert _tree(roots["r1"]) == before1, "rank 1 must write no file"
    assert int(o0["steps"]) == int(o1["steps"]) == 4
    _assert_ranks_equal((o0, o1), ("pos", "vel", "K", "last_stats"))

    assert one["chunk_engines"] == o0["engines"].tolist()
    np.testing.assert_array_equal(o0["pos"], one["state"].pos.numpy())
    np.testing.assert_array_equal(o0["vel"], one["state"].vel.numpy())
    np.testing.assert_array_equal(o0["K"], one["state"].K.numpy())
    np.testing.assert_array_equal(o0["last_stats"], one["last_stats_cgs"])
    np.testing.assert_array_equal(o0["snapshot_ids"], one["snapshot_ids"])
    assert int(ref["steps"]) == 4
    np.testing.assert_allclose(o0["pos"], np.asarray(ref["state"].pos, np.float64),
                               rtol=0, atol=1e-9)


def test_multihost_state_sharded_slabs(tmp_path):
    from multihost_worker import run_slabs_reference

    # the ranks and the one-process chunk run in processes of their own
    # while the reference runs here
    ranks = Ranks("slabs", tmp_path)
    one_proc = Ranks("slabs_one", tmp_path, n=1)
    pos_r, vel_r, K_r, stats_r, key_r = run_slabs_reference(_ref_mesh())
    n = pos_r.shape[0]
    o0, o1 = ranks.results()
    (one,) = one_proc.results(["one.npz"])

    # both ranks derive the one-process plan from their summed histograms
    assert one["valid"].all() and not one["cert"].any()
    for o in (o0, o1):
        assert tuple(o["static_key"].tolist()) == tuple(one["static_key"].tolist()) == key_r
        np.testing.assert_array_equal(o["z0s"], one["z0s"])
        assert float(o["half"]) == float(one["half"])
        np.testing.assert_array_equal(o["rows"], one["rows"])
        assert o["valid"].all() and not o["cert"].any()
        # locality: a rank holds only rows its own shards own
        assert ((o["owner"] >= int(o["d0"])) & (o["owner"] < int(o["d1"]))).all()
    assert (int(o0["d0"]), int(o0["d1"]), int(o1["d0"]), int(o1["d1"])) == (0, 2, 2, 4)
    g0, g1 = set(o0["gid"].tolist()), set(o1["gid"].tolist())
    assert not (g0 & g1) and g0 | g1 == set(range(n))
    _assert_ranks_equal((o0, o1), ("stats",))
    assert bool(o0["gathered"]) and not bool(o1["gathered"])

    full = {k: np.zeros((n, 3) if k in ("pos", "vel") else n) for k in ("pos", "vel", "K", "h")}
    for o in (o0, o1):
        for k in full:
            full[k][o["gid"]] = o[k]
    for k in full:
        np.testing.assert_array_equal(o0[f"full_{k}"], full[k], err_msg=k)
    for k in full:  # bit-equal to the one-process four-shard chunk
        np.testing.assert_array_equal(full[k], one[k], err_msg=k)
    np.testing.assert_array_equal(o0["stats"], one["stats"])
    np.testing.assert_allclose(full["pos"], pos_r, rtol=0, atol=1e-9)
    np.testing.assert_allclose(full["vel"], vel_r, rtol=0, atol=1e-9)
    np.testing.assert_allclose(full["K"], K_r, rtol=1e-12)
    np.testing.assert_allclose(o0["stats"], stats_r, rtol=1e-9, atol=1e-12)


def test_mh_plan_slabs_one_rank_matches_reference():
    from multihost_worker import SLABS_KH, fixture_slabs
    from sphtpu.shard.mh_slabs import LocalRows as LocalRowsRef
    from sphtpu.shard.mh_slabs import mh_plan_slabs as mh_plan_slabs_ref
    from sphtpu_torch.shard.mh_slabs import LocalRows, mh_plan_slabs
    from sphtpu_torch.shard.tiles import plan_slabs, real_rows

    pos, vel, K, h0 = fixture_slabs()
    rows = (pos, vel, K, h0, np.arange(pos.shape[0]))
    for n_dev in (2, 4):
        a = mh_plan_slabs(LocalRows(*rows), SLABS_KH, n_dev)
        r = mh_plan_slabs_ref(LocalRowsRef(*rows), SLABS_KH, n_dev)
        assert a.static_key == r.static_key and a.half == r.half
        np.testing.assert_array_equal(a.z0s, r.z0s)
        assert a.order is None and r.order is None
        assert list(a.rows) == real_rows(plan_slabs(pos, h0, SLABS_KH, n_dev))


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
