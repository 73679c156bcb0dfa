"""Port vs reference, kernel-bearing modules and the plain physics.

The same numpy inputs go through the JAX function (Pallas kernels in
interpret mode, as the reference's own CPU tests run them) and through the
port with CPU tensors, where every kernel wrapper takes its plain PyTorch
version. No CUDA kernel runs here: kernel-vs-plain on the card is
chip_smoke.py's job.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphtpu.kernels import W as W_ref
from sphtpu.kernels import grad_W_over_r as gradW_ref
from sphtpu.kernels import softened_gphi_over_r as gphi_ref
from sphtpu.kernels import softened_phi as phi_ref
from sphtpu.kernels.pallas_gravity import newton_sweep_pallas
from sphtpu.kernels.pallas_knn import phase_a_pallas as phase_a_tile_ref
from sphtpu.kernels.pallas_strip_knn import phase_a_cells as phase_a_ref
from sphtpu.kernels.pallas_tile_pairs import phase_b_tiles as phase_b_ref
from sphtpu.neighbors import knn as knn_ref
from sphtpu.physics import gravity_allpairs as gravity_allpairs_ref
from sphtpu.physics import gravity_newton_allpairs as newton_ref
from sphtpu.physics import sph_forces as sph_forces_ref
from sphtpu.physics.mesh_gravity import mesh_gphi_over_r as mesh_g_ref
from sphtpu.physics.mesh_gravity import mesh_phi as mesh_p_ref
from sphtpu_torch.kernels import W, grad_W_over_r, softened_gphi_over_r, softened_phi
from sphtpu_torch.kernels import cuda_gravity, cuda_knn, cuda_strip_knn, cuda_tile_pairs
from sphtpu_torch.neighbors import knn
from sphtpu_torch.physics import (
    gravity_allpairs,
    gravity_newton_allpairs,
    sph_forces,
)
from sphtpu_torch.physics.mesh_gravity import mesh_gphi_over_r, mesh_phi

# the suite runs several pytest workers per machine: keep torch's intra-op
# pool from oversubscribing the cores they share
torch.set_num_threads(2)


NP = {"float64": np.float64, "float32": np.float32}
H100_SMEM_OPTIN = 227 * 1024  # shared memory a block may opt into on an H100
H100_SMS = 132


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cell_rows(dtype, n_cells=16, cap=32, seed=0):
    """Cell rows with cw = 27 * cap candidate slots, ~40% occupied; the
    queries are the 14th stencil cell's slots, as the tile engines stack
    them. Row 1 gets a reach too small to certify, row 2 is masked off."""
    rng = np.random.default_rng(seed)
    cw = 27 * cap
    cm = (rng.random((n_cells, cw)) < 0.4).astype(dtype)
    cpos = [(rng.random((n_cells, cw)) * cm).astype(dtype) for _ in range(3)]
    sl = slice(13 * cap, 14 * cap)
    qm = cm[:, sl].copy()
    qm[2] = 0.0
    reach2 = np.full((n_cells, cap), 0.35**2, dtype)
    reach2[1] = 0.05**2
    queries = [c[:, sl].copy() for c in cpos] + [qm]
    return queries, reach2, cpos + [cm], cw


# ---------------------------------------------------------------- (a) K1
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_phase_a_cells_matches_reference(dtype):
    cap, kh = 32, 16
    queries, reach2, cands, _ = _cell_rows(NP[dtype])
    m = 1.0 / 4000
    h_r, rho_r, ok_r = phase_a_ref(
        tuple(jnp.asarray(a) for a in queries), jnp.asarray(reach2),
        tuple(jnp.asarray(a) for a in cands), m, kh=kh, cap=cap,
        interpret=True,
    )
    before = cuda_strip_knn.launches
    h, rho, ok = cuda_strip_knn.phase_a_cells(
        tuple(t(a) for a in queries), t(reach2), tuple(t(a) for a in cands),
        m, kh=kh, cap=cap,
    )
    assert cuda_strip_knn.launches == before, "no kernel launch on CPU tensors"
    assert h.dtype == getattr(torch, dtype)
    ok_r = np.asarray(ok_r)
    np.testing.assert_array_equal(ok.numpy(), ok_r)
    # f64: reduction-order roundoff only; f32: W evaluated per pair in f32
    h_tol, rho_tol = (1e-12, 1e-12) if dtype == "float64" else (1e-6, 2e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), rtol=h_tol)
    np.testing.assert_allclose(rho.numpy(), np.asarray(rho_r), rtol=rho_tol)
    # the fixture exercises all three row kinds
    qm = queries[3]
    assert (ok_r[1][qm[1] > 0] == 0).all(), "undersized reach must not certify"
    assert (ok_r[2] == 1).all() and (h.numpy()[2] == 0).all()
    assert (rho.numpy()[2] == 0).all()
    assert ok_r[3:][qm[3:] > 0].mean() > 0.9, "most plain rows certify"


def test_phase_a_cells_plain_is_generic_in_shape():
    """cap, cw and n_bisect are free: cw need not be 27 * cap."""
    rng = np.random.default_rng(3)
    n_cells, cap, cw, kh = 5, 24, 200, 8
    cm = (rng.random((n_cells, cw)) < 0.7).astype(np.float64)
    cands = [rng.random((n_cells, cw)) for _ in range(3)] + [cm]
    queries = [c[:, :cap].copy() for c in cands]
    reach2 = np.full((n_cells, cap), 3.0)
    out_r = phase_a_ref(
        tuple(jnp.asarray(a) for a in queries), jnp.asarray(reach2),
        tuple(jnp.asarray(a) for a in cands), 0.01, kh=kh, cap=cap,
        interpret=True, n_bisect=50,
    )
    out = cuda_strip_knn.phase_a_cells(
        tuple(t(a) for a in queries), t(reach2), tuple(t(a) for a in cands),
        0.01, kh=kh, cap=cap, n_bisect=50,
    )
    for a, b in zip(out, out_r):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


def test_phase_a_cells_shared_memory_covers_every_plannable_row():
    """The kernel streams a row through shared memory and keeps each
    query's list there: the widest row the run loop can plan (the mono-tile
    planner's ceiling; its phase A, phase_a_tile, is the same kernel) gets
    a staging width and a list in both dtypes, and a card whose blocks have
    too little shared memory for any list is refused."""
    import inspect

    from sphtpu_torch.physics.tiles import choose_tile_params

    cap = inspect.signature(choose_tile_params).parameters["cap_max"].default
    for td in (torch.float32, torch.float64):
        list_len, stage = cuda_strip_knn.list_budget(cap, 27 * cap, td, H100_SMEM_OPTIN)
        need = cuda_strip_knn.k1_shared_bytes(cap, list_len, stage, td)
        assert 0 < stage < 27 * cap and list_len >= 32
        assert need + cuda_strip_knn.CTA_RESERVED <= H100_SMEM_OPTIN
    with pytest.raises(ValueError, match="shared memory"):
        cuda_strip_knn.list_budget(cap, 27 * cap, torch.float64, 48 * 1024)


def _phase_a_list_form(queries, reach2, cands, m, *, kh, cap, n_bisect, list_len):
    """K1's algorithm on the card, in torch: each query's in-radius squared
    distances (d2 <= 1.001 * reach2) in candidate order form its list of at
    most list_len entries; the bisection, rk2, nfound and rho run over the
    list; a query with more in-radius candidates takes the full-row form.
    Returns (h, rho, ok, overflowed)."""
    qx, qy, qz, qm = queries
    cx, cy, cz, cm = cands
    dtype = cx.dtype
    big = torch.finfo(dtype).max
    dx = qx[:, :, None] - cx[:, None, :]
    dy = qy[:, :, None] - cy[:, None, :]
    dz = qz[:, :, None] - cz[:, None, :]
    d2 = dx * dx + dy * dy + dz * dz
    valid_q = qm > 0
    hi0 = 1.001 * reach2
    inr = (cm[:, None, :] > 0) & valid_q[:, :, None] & (d2 <= hi0[:, :, None])
    over = inr.sum(-1) > list_len
    # in-radius entries first, candidate order kept; +max pads the list
    order = torch.argsort((~inr).to(torch.int8), dim=-1, stable=True)
    lst = torch.gather(torch.where(inr, d2, torch.full_like(d2, big)), -1, order)
    lst = lst[..., :list_len]
    lo, hi = torch.zeros_like(hi0), hi0
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        ge = (lst <= mid[..., None]).sum(-1) >= kh
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
    zero = torch.zeros((), dtype=dtype)
    rk2 = torch.where(lst <= hi[..., None], lst, zero).max(-1).values
    within = lst <= rk2[..., None]
    nfound = within.sum(-1)
    h = torch.sqrt(rk2) / 2.0
    h_safe = torch.where(h > 0, h, torch.ones((), dtype=dtype))[..., None]
    w = W(torch.sqrt(torch.where(within, lst, zero)) / h_safe, h_safe)
    rho = m * torch.where(within, w, zero).sum(-1)
    ok = (~valid_q | ((nfound >= kh) & (rk2 <= reach2))).to(dtype)
    h, rho = torch.where(valid_q, h, zero), torch.where(valid_q, rho, zero)
    if bool(over.any()):
        full = cuda_strip_knn.phase_a_cells_plain(
            queries, reach2, cands, m, kh=kh, cap=cap, n_bisect=n_bisect
        )
        h, rho, ok = (torch.where(over, f, x) for f, x in zip(full, (h, rho, ok)))
    return h, rho, ok, over


def _block_like_rows(dtype, nb=2, cap=128, cw=2048, kh=32, seed=5):
    """Rows shaped like the block engine's: nb blocks of cap queries in the
    unit cube against cw candidate slots over [-0.25, 1.25]^3, 85 %
    occupied, each query also a candidate; reach2 = (1.5 r_k)^2 for the
    candidates' mean density, as the h-hint cap gives, and 8 rows whose
    reach cannot hold kh neighbours; one query slot masked off."""
    rng = np.random.default_rng(seed)
    n_occ = int(0.85 * cw)
    q = [rng.random((nb, cap)).astype(dtype) for _ in range(3)]
    c = [(rng.random((nb, cw)) * 1.5 - 0.25).astype(dtype) for _ in range(3)]
    for a in range(3):
        c[a][:, :cap] = q[a]
    cm = np.broadcast_to((np.arange(cw) < n_occ).astype(dtype), (nb, cw)).copy()
    qm = np.ones((nb, cap), dtype)
    qm[0, 3] = 0.0
    r_k = (3.0 * kh * 1.5**3 / (4.0 * np.pi * n_occ)) ** (1 / 3)
    reach2 = np.full((nb, cap), (1.5 * r_k) ** 2, dtype)
    reach2[1, :8] = (0.3 * r_k) ** 2
    return q + [qm], reach2, c + [cm], kh


def _mono_rows(dtype, n_cells=4, cap=32, seed=9):
    """Rows shaped like the mono-tile engine's: a 3^3 block of unit cells,
    cw = 27 * cap slots, each cell holding between half its fill and its
    fill of particles in its first slots (fill 24, and 3 in row 1, whose
    queries cannot find kh neighbours within one cell edge); the queries
    are the centre cell's slots and s2 = 1, the cell edge squared.
    Returns (cands, s2)."""
    rng = np.random.default_rng(seed)
    cw = 27 * cap
    fill = np.full((n_cells, 1, 1), 24)
    fill[1] = 3
    n_in = rng.integers(fill // 2, fill + 1, size=(n_cells, 27, 1))
    cm = (np.arange(cap)[None, None, :] < n_in).astype(dtype)
    cell = np.arange(27)
    off = np.stack([cell % 3, (cell // 3) % 3, cell // 9])
    pos = [((rng.random((n_cells, 27, cap)) + off[a][None, :, None]) * cm).astype(dtype)
           for a in range(3)]
    return [p.reshape(n_cells, cw) for p in pos] + [cm.reshape(n_cells, cw)], 1.0


@pytest.mark.parametrize("rows", ["class", "block", "overflow", "mono", "mono_overflow"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_phase_a_only_in_radius_candidates_matter(dtype, rows):
    """K1's and K4's list form (bisection over each query's in-radius
    candidates, the full row where they overflow L) gives the full-row
    form's h and ok bit for bit and the reference's within its tolerances:
    on class-like rows (cw = 27 cap, uniform reach), block-like rows (C_b =
    2048, a hint-capped reach), mono-tile rows (K4: the centre cell's
    slots as the queries, one uniform s2) and rows where some queries
    overflow a small L."""
    td = getattr(torch, dtype)
    if rows == "block":
        queries, reach2, cands, kh = _block_like_rows(NP[dtype])
        cap = queries[0].shape[1]
        n_bisect = 28 if dtype == "float32" else 68
    elif rows.startswith("mono"):
        cands, s2 = _mono_rows(NP[dtype])
        cap, kh, n_bisect = 32, 16, cuda_strip_knn.N_BISECT
        queries = [c[:, 13 * cap : 14 * cap].copy() for c in cands]
        reach2 = np.full(queries[0].shape, s2, NP[dtype])
    else:
        queries, reach2, cands, _ = _cell_rows(NP[dtype])
        cap, kh, n_bisect = 32, 16, cuda_strip_knn.N_BISECT
    cw = cands[0].shape[1]
    list_len = (64 if rows.endswith("overflow")
                else cuda_strip_knn.list_budget(cap, cw, td, H100_SMEM_OPTIN)[0])
    m = 1.0 / 4000
    args = (tuple(t(a) for a in queries), t(reach2), tuple(t(a) for a in cands), m)
    kw = dict(kh=kh, cap=cap, n_bisect=n_bisect)
    h, rho, ok, over = _phase_a_list_form(*args, **kw, list_len=list_len)
    if rows.startswith("mono"):
        h_p, rho_p, ok_p = cuda_knn.phase_a_tile_plain(args[2], s2, m, **kw)
    else:
        h_p, rho_p, ok_p = cuda_strip_knn.phase_a_cells_plain(*args, **kw)
    assert torch.equal(h, h_p) and torch.equal(ok, ok_p)
    rho_tol = 1e-12 if dtype == "float64" else 2e-5
    np.testing.assert_allclose(rho.numpy(), rho_p.numpy(), rtol=rho_tol)
    valid = queries[3] > 0
    if rows.endswith("overflow"):
        assert over.numpy()[valid].any() and (~over.numpy())[valid].any()
    else:
        assert not over.any()
    if rows.startswith("mono"):
        h_r, rho_r, ok_r = phase_a_tile_ref(
            tuple(jnp.asarray(a) for a in cands), s2, m, kh=kh, cap=cap, interpret=True,
        )
    else:
        h_r, rho_r, ok_r = phase_a_ref(
            tuple(jnp.asarray(a) for a in queries), jnp.asarray(reach2),
            tuple(jnp.asarray(a) for a in cands), m, **kw, interpret=True,
        )
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    h_tol = 1e-12 if dtype == "float64" else 1e-6
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), rtol=h_tol)
    np.testing.assert_allclose(rho.numpy(), np.asarray(rho_r), rtol=rho_tol)
    assert (ok.numpy()[valid] == 0).any() and (ok.numpy()[valid] == 1).any()


@pytest.mark.parametrize("engine", ["class", "block", "mono", "mlevel"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_list_budget_fits_every_plannable_row(dtype, engine):
    """At every (cap, cw) the class, block, mono-tile and multi-level
    planners emit (the last: every bucket capacity of CAP_MENU), the
    phase-A kernel's staged planes and lists (K1's; K4's on the mono rows)
    fit the H100's 227 KB with room for two CTAs an SM (228 KB), and L
    holds at least 4 kh at kh = 50."""
    import inspect

    from sphtpu_torch.physics.blocks import BQ, C_MENU
    from sphtpu_torch.physics.ctiles import CLASS_MENU
    from sphtpu_torch.physics.tiles import choose_tile_params

    td = getattr(torch, dtype)
    if engine == "class":  # the class planner's ceiling is cap 128
        shapes = [(cap_k, 27 * cap) for cap in CLASS_MENU for cap_k in CLASS_MENU
                  if cap_k <= cap]
    elif engine == "mono":  # multiples of 32 up to the mono planner's ceiling
        cap_max = inspect.signature(choose_tile_params).parameters["cap_max"].default
        shapes = [(cap, 27 * cap) for cap in range(32, cap_max + 1, 32)]
    elif engine == "mlevel":
        from sphtpu_torch.physics.mlevel import CAP_MENU

        shapes = [(cap_b, 27 * cap_b) for cap_b in CAP_MENU]
    else:
        shapes = [(BQ, cw) for cw in C_MENU]
    for cap, cw in shapes:
        list_len, stage = cuda_strip_knn.list_budget(cap, cw, td, H100_SMEM_OPTIN)
        need = cuda_strip_knn.k1_shared_bytes(cap, list_len, stage, td)
        assert need + cuda_strip_knn.CTA_RESERVED <= H100_SMEM_OPTIN
        assert 2 * (need + cuda_strip_knn.CTA_RESERVED) <= 228 * 1024
        assert list_len >= 4 * 50 and list_len % 32 == 0
        assert 0 < stage <= cw
        assert cuda_strip_knn.list_stride(list_len) % 32 == 8


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", [1, 700, 2047, 4100, 20_000, 100_000, 1_000_003])
def test_split_plan_covers_every_column_once(n, dtype):
    """K3's column slices tile [0, n) exactly: S slices of whole staged
    tiles, the last cut at n and none empty; S = 1 at small n."""
    td = getattr(torch, dtype)
    rows, threads, n_slices = cuda_gravity.split_plan(n, H100_SMS, td)
    cols = cuda_gravity.column_slices(n, n_slices, threads)
    assert rows in (1, 2, 4) and threads % 32 == 0 and threads <= 256
    assert cols % threads == 0
    bounds = [(s * cols, min(n, (s + 1) * cols)) for s in range(n_slices)]
    covered = np.zeros(n, int)
    for c0, c1 in bounds:
        assert c1 > c0
        covered[c0:c1] += 1
    assert (covered == 1).all()
    if n < 2 * cuda_gravity.MIN_SLICE_COLS:
        assert n_slices == 1


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_split_plan_fills_the_card(dtype):
    """At the headline's N = 1e5 on 132 SMs the sweep's grid holds at least
    2 CTAs an SM."""
    td = getattr(torch, dtype)
    n = 100_000
    rows, threads, n_slices = cuda_gravity.split_plan(n, H100_SMS, td)
    ctas = -(-n // (threads * rows)) * n_slices
    assert n_slices > 1 and ctas >= 2 * H100_SMS


def test_split_plan_partials_in_order_match_plain():
    """The sweep's form: per column slice a partial sum, the S partials
    added in the order s = 0 .. S - 1, then m applied, matches
    newton_sweep_plain to 1e-13 of the largest |g| (float64)."""
    rng = np.random.default_rng(4)
    n = 2100
    pos = t(rng.standard_normal((n, 3)))
    m = 1.0 / n
    rows, threads, n_slices = cuda_gravity.split_plan(n, H100_SMS, torch.float64)
    cols = cuda_gravity.column_slices(n, n_slices, threads)
    assert n_slices > 1
    acc = torch.zeros((n, 4), dtype=torch.float64)
    for s in range(n_slices):
        c = pos[s * cols : (s + 1) * cols]
        d = pos[:, None, :] - c[None, :, :]
        r2 = (d * d).sum(-1)
        inv = torch.where(r2 > 0, torch.rsqrt(torch.where(r2 > 0, r2, 1.0)), 0.0)
        part = torch.cat([((inv**3)[..., None] * d).sum(1), -inv.sum(1, keepdim=True)], 1)
        acc = acc + part
    g_p, p_p = cuda_gravity.newton_sweep_plain(pos, m)
    scale = float(g_p.abs().max())
    assert float((m * acc[:, :3] - g_p).abs().max()) <= 1e-13 * scale
    assert float((m * acc[:, 3] - p_p).abs().max()) <= 1e-13 * float(p_p.abs().max())


# ---------------------------------------------------------------- (b) K2
def _phase_b_inputs(dtype, seed=1):
    cap, kh = 32, 16
    queries, reach2, cands, cw = _cell_rows(dtype, seed=seed)
    reach2[1] = 0.35**2
    rng = np.random.default_rng(seed + 10)
    n_cells = reach2.shape[0]
    h, rho, _ = cuda_strip_knn.phase_a_cells_plain(
        tuple(t(a) for a in queries), t(reach2), tuple(t(a) for a in cands),
        1.0 / 4000, kh=kh, cap=cap,
    )
    cm = cands[3]
    sl = slice(13 * cap, 14 * cap)
    # candidate-side h/rho: the query cell's own values where it is the
    # centre cell, plausible random ones elsewhere
    ch = (0.08 + 0.1 * rng.random((n_cells, cw))).astype(dtype) * cm
    crho = (0.5 + rng.random((n_cells, cw))).astype(dtype) * cm
    ch[:, sl] = h.numpy()
    crho[:, sl] = rho.numpy()
    cvel = [(0.3 * rng.standard_normal((n_cells, cw))).astype(dtype) * cm for _ in range(3)]
    cpor2 = (0.5 + rng.random((n_cells, cw))).astype(dtype) * cm
    ccs = (0.8 + 0.4 * rng.random((n_cells, cw))).astype(dtype) * cm
    cfields = cands[:3] + cvel + [cm, ch, crho, cpor2, ccs]
    qfields = [c[:, sl].copy() for c in cfields]
    qfields[6] = queries[3]
    return qfields, cfields, cap


@pytest.mark.parametrize("p3m", [False, True])
@pytest.mark.parametrize("eos", ["polytropic", "isothermal"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_phase_b_tiles_matches_reference(dtype, eos, p3m):
    qfields, cfields, cap = _phase_b_inputs(NP[dtype])
    m, alpha, beta = 1.0 / 4000, 1.0, 2.0
    sigma = 0.35 / 10 * 2.2 if p3m else None  # mesh_factor = 10
    ref = phase_b_ref(
        tuple(jnp.asarray(a) for a in qfields),
        tuple(jnp.asarray(a) for a in cfields),
        m, alpha, beta, sigma, eos=eos, p3m=p3m, cap=cap, interpret=True,
    )
    before = cuda_tile_pairs.launches
    out = cuda_tile_pairs.phase_b_tiles(
        tuple(t(a) for a in qfields), tuple(t(a) for a in cfields),
        m, alpha, beta, sigma, eos=eos, p3m=p3m, cap=cap,
    )
    assert cuda_tile_pairs.launches == before
    names = "ax ay az div mu_max visc ggx ggy ggz gphi".split()
    for name, a, b in zip(names, out, ref):
        a, b = a.numpy(), np.asarray(b)
        if dtype == "float64":
            if name == "mu_max":
                np.testing.assert_allclose(a, b, rtol=1e-10, err_msg=name)
            else:
                np.testing.assert_allclose(
                    a, b, rtol=1e-9, atol=1e-13 * max(1.0, np.abs(b).max()),
                    err_msg=name,
                )
        else:
            # f32: sums of signed pair terms; roundoff scales with the
            # row's magnitude, not with the (possibly cancelled) result
            scale = np.abs(b).max(axis=1, keepdims=True)
            assert (np.abs(a - b) <= 2e-4 * np.abs(b) + 2e-5 * scale).all(), name
    masked = qfields[6][2]
    assert (out[0].numpy()[2][masked <= 0] == 0).all()
    assert (out[4].numpy()[2] == -np.finfo(NP[dtype]).max).all()


# ---------------------------------------------------------------- (c) K3
def test_newton_sweep_matches_reference():
    rng = np.random.default_rng(0)
    n = 700  # not a multiple of any tile
    pos = rng.standard_normal((n, 3))
    m = 1.0 / n
    g_p, p_p = newton_sweep_pallas(jnp.asarray(pos), m, interpret=True)
    g_x, p_x = newton_ref(jnp.asarray(pos), m)
    before = cuda_gravity.launches
    g, p = gravity_newton_allpairs(t(pos), m, device="cpu")
    assert cuda_gravity.launches == before
    for gr, pr in ((g_p, p_p), (g_x, p_x)):
        np.testing.assert_allclose(g.numpy(), np.asarray(gr), rtol=1e-10)
        np.testing.assert_allclose(p.numpy(), np.asarray(pr), rtol=1e-10)
    assert np.abs(g.numpy().sum(axis=0)).max() < 1e-10  # Newton's third law
    # small blocks walk the ragged edges of the plain version
    g2, p2 = cuda_gravity.newton_sweep_plain(t(pos), m, block_q=64, block_c=96)
    np.testing.assert_allclose(g2.numpy(), g.numpy(), rtol=1e-10)
    np.testing.assert_allclose(p2.numpy(), p.numpy(), rtol=1e-12)


def test_entry_points_default_to_the_card():
    """device=None means cuda: without one the entry points raise instead
    of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    pos = torch.zeros((4, 3), dtype=torch.float64)
    with pytest.raises(RuntimeError, match="cuda|CUDA"):
        gravity_newton_allpairs(pos, 1.0)


# ------------------------------------------------- (e) plain physics, f64
def test_kernel_functions_match_reference():
    rng = np.random.default_rng(5)
    q = np.concatenate([rng.random(200) * 2.5, [0.0, 1.0, 2.0]])
    h = 0.3 + rng.random(q.shape[0])
    r = q * h
    pairs = [
        (W(t(q), t(h)), W_ref(jnp.asarray(q), jnp.asarray(h))),
        (grad_W_over_r(t(q), t(r), t(h)),
         gradW_ref(jnp.asarray(q), jnp.asarray(r), jnp.asarray(h))),
        (softened_gphi_over_r(t(r), t(h)), gphi_ref(jnp.asarray(r), jnp.asarray(h))),
        (softened_phi(t(r), t(h)), phi_ref(jnp.asarray(r), jnp.asarray(h))),
        (mesh_gphi_over_r(t(r), 0.4), mesh_g_ref(jnp.asarray(r), 0.4)),
        (mesh_phi(t(r), 0.4), mesh_p_ref(jnp.asarray(r), 0.4)),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13, atol=1e-300)
    # phi(0) = -7/5h
    np.testing.assert_allclose(
        softened_phi(torch.zeros(1, dtype=torch.float64), t(h[:1])).numpy(),
        -1.4 / h[:1], rtol=1e-15,
    )


def test_knn_matches_reference():
    rng = np.random.default_rng(6)
    pos = rng.standard_normal((900, 3))
    idx_r, d2_r = knn_ref(jnp.asarray(pos), jnp.asarray(pos), 12)
    idx, d2 = knn(t(pos), t(pos), 12, block_q=128, block_c=256)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_r))
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2_r), rtol=1e-14, atol=0)
    with pytest.raises(ValueError):
        knn(t(pos[:5]), t(pos[:5]), 6)


@pytest.mark.parametrize("eos", ["polytropic", "isothermal"])
def test_sph_forces_match_reference(eos):
    rng = np.random.default_rng(7)
    n, kh = 800, 16
    pos = rng.standard_normal((n, 3))
    vel = 0.3 * rng.standard_normal((n, 3))
    K = 1.0 + 0.2 * rng.random(n)
    kw = dict(eos=eos, gamma=5 / 3, cs0=0.6, alpha=1.0, beta=2.0, kh=kh)
    ref = sph_forces_ref(jnp.asarray(pos), jnp.asarray(vel), 1.0 / n, jnp.asarray(K), **kw)
    out = sph_forces(t(pos), t(vel), 1.0 / n, t(K), **kw)
    for name in ("rho", "h", "cs", "mu_max", "div_sum", "visc_dk", "acc"):
        b = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(
            getattr(out, name).numpy(), b, rtol=1e-10,
            atol=1e-13 * np.abs(b).max(), err_msg=name,
        )


def test_gravity_allpairs_matches_reference():
    rng = np.random.default_rng(8)
    n = 700
    pos = rng.standard_normal((n, 3))
    h = 0.05 + 0.3 * rng.random(n)
    g_r, p_r = gravity_allpairs_ref(jnp.asarray(pos), jnp.asarray(h), 1.0 / n)
    g, p = gravity_allpairs(t(pos), t(h), 1.0 / n, block_q=128, block_c=256)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_r), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_r), rtol=1e-11)
