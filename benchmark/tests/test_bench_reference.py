"""The plain reference: its parts against plainer forms, and against one
small request of the program on the CPU."""

import numpy as np
import pytest
import torch

from benchmark import compare, harness
from benchmark.reference import plain_sph as ps

from .conftest import BENCH, ROOT


def cloud(n=1200, seed=4):
    from benchmark.manifest import read_json
    from benchmark.scenes import generated_cloud

    conf = read_json(f"{BENCH}/configs/bb_cloud_2e5.json")
    conf["N"] = n
    s = generated_cloud.make(conf, seed, ROOT)
    return s, ps.Physics(s.m, 5.0 / 3.0, 1.0, 2.0, 50)


def test_grid_neighbours_match_the_tree():
    s, ph = cloud(3000)
    pos = torch.tensor(s.pos)
    tree = ps.tree_neighbours(pos, 50)
    f = ps.hydro(pos, torch.tensor(s.vel), torch.tensor(s.K), tree, ph)
    for h in (f["h"], 0.3 * f["h"], 3.0 * f["h"]):
        grid = ps.neighbours(pos, 50, h)
        assert torch.equal(torch.sort(grid, 1).values, torch.sort(tree, 1).values)


def test_gravity_split_matches_every_pair_softened():
    s, ph = cloud(900)
    pos = torch.tensor(s.pos)
    h = torch.tensor(s.h)
    d = pos[:, None, :] - pos[None, :, :]
    r = torch.sqrt((d * d).sum(-1))
    h_ij = 0.5 * (h[:, None] + h[None, :])
    off = ~torch.eye(pos.shape[0], dtype=torch.bool)
    gp = torch.where(off, ps.soft_gphi_over_r(r, h_ij), 0.0)
    g_ref = ph.m * (gp[..., None] * d).sum(1)
    phi_ref = ph.m * torch.where(off, ps.soft_phi(r, h_ij), 0.0).sum() - 1.4 * ph.m * (1 / h).sum()
    for block in (1 << 14, 1 << 17, 1 << 22):
        g, phi_sum = ps.gravity(pos, h, ph.m, block_elems=block)
        assert float((g - g_ref).norm(dim=1).max() / g_ref.norm(dim=1).max()) < 1e-12
        assert abs(float(phi_sum - phi_ref) / float(phi_ref)) < 1e-13


def test_hydro_conserves_momentum_and_is_symmetric():
    s, ph = cloud(1500)
    pos, vel, K = (torch.tensor(a) for a in (s.pos, s.vel, s.K))
    f = ps.hydro(pos, vel, K, ps.tree_neighbours(pos, 50), ph)
    total = f["acc"].sum(0).norm() / f["acc"].norm(dim=1).sum()
    assert float(total) < 1e-12
    assert torch.all(f["h"] > 0) and torch.all(f["rho"] > 0)


@pytest.mark.parametrize("cell", ["tiny.tiles", "tiny.blocks"])
def test_the_reference_against_a_small_request_of_the_program(small_root, cell):
    p = harness.prepare(small_root, cell, 17, "cpu")
    o = p.req()
    assert o.failure is None and o.steps == p.steps
    out = harness.outputs(o)
    ref = harness.reference(p._replace(req=None))
    reading = harness.readings(p, out, ref)
    assert set(reading) == set(compare.NAMES)
    # float32 against float64: rounding only
    assert max(reading.values()) < 1e-4, reading
    assert compare.judge(reading, p.cell.spec["limits"])
    ctl = harness.readings(p, ps.run_chunk(
        *(torch.from_numpy(a) for a in (p.pos, p.vel, p.K)), p.t0,
        ph=ps.Physics(kh=p.kh, **p.phys), t_end=p.t_end, n_steps=p.steps, dtype=torch.bfloat16),
        ref)
    # the control, the reference in bfloat16, fails the cell's limits
    assert not compare.judge(ctl, p.cell.spec["limits"]), ctl
    assert np.isfinite(list(ctl.values())).all()
