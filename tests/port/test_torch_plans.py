"""The launch plans of the P3M tail kernel and K2 (`phase_b_tiles`), on the CPU.

What the two kernels decide on the host or in integer arithmetic is checked
here against the JAX package or exhaustively: the tail's thread plan (R
queries a thread, S slices of the candidates) and its shared-memory
budget; K2's record numbering, pieces, cull radius and
budget. Where a plan orders floating-point sums, the plan is emulated in
float64 and held against `sphtpu` (the tail's stencil sums against the
reference's `newton_minus_mesh`, K2's pieces against its Pallas kernel in
interpret mode). No CUDA kernel runs here.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphtpu.kernels.pallas_tile_pairs import phase_b_tiles as phase_b_ref
from sphtpu.physics.mesh_gravity import newton_minus_mesh as nmm_ref
from sphtpu_torch.kernels import cuda_p3m_tail, cuda_strip_knn, cuda_tile_pairs
from sphtpu_torch.physics.ctiles import CLASS_MENU
from sphtpu_torch.physics.mesh_gravity import newton_minus_mesh, tail_halfwidth
from sphtpu_torch.physics.tiles import choose_tile_params

torch.set_num_threads(2)

H100_SMEM_OPTIN = 227 * 1024  # shared memory a block may opt into on an H100
CTA_RESERVED = cuda_strip_knn.CTA_RESERVED
NQ = [1, 2, 3, 7, 20, 31, 32, 33, 47, 56, 64, 100, 107, 128, 129, 160, 200, 255, 256]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def plannable_halfwidths():
    """Every W that tail_halfwidth gives at the default sigma_cells for a
    mesh_factor from 1 up to where W stays 1."""
    return sorted({tail_halfwidth(mf, 2.2) for mf in range(1, 41)})


def mono_caps():
    cap_max = inspect.signature(choose_tile_params).parameters["cap_max"].default
    return sorted(set(range(32, cap_max + 1, 32)) | {160})


# ------------------------------------------------------------ the tail


@pytest.mark.parametrize("nq", NQ)
def test_tail_thread_plan_covers_each_query_once(nq):
    """Each slice of the plan holds every query exactly once; the slices
    split a staged chunk's candidates exactly once; the threads fit the CTA
    and the slice partials fit the staged records' space; R is the one with
    the fewest candidate sweeps a thread."""
    threads = cuda_p3m_tail.TAIL_THREADS
    r, qt, s = cuda_p3m_tail.thread_plan(nq)
    assert r in (1, 2, 4) and qt == -(-nq // r) and s == threads // qt
    assert 1 <= qt * s <= threads
    seen = np.zeros((s, nq), int)
    for tid in range(qt * s):
        for k in range(r):
            q = tid % qt + k * qt
            if q < nq:
                seen[tid // qt, q] += 1
    assert (seen == 1).all()
    n_here = 1000
    cover = np.zeros(n_here, int)
    for sl in range(s):
        cover[sl::s] += 1
    assert (cover == 1).all()
    assert 4 * s * qt * r <= 4 * cuda_p3m_tail.TAIL_CHUNK
    sweeps = {rr: rr / (threads // -(-nq // rr)) for rr in (1, 2, 4)}
    assert sweeps[r] == min(sweeps.values())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_tail_budget_fits_every_plannable_stencil(dtype):
    """At every cap the mono planner emits and every W tail_halfwidth gives,
    the tail kernel's shared memory fits the H100's 227 KB."""
    td = getattr(torch, dtype)
    ws = plannable_halfwidths()
    assert {1, 2, 3} <= set(ws)
    for cap in mono_caps():
        for w in ws:
            chunk = cuda_p3m_tail.tail_budget(cap, w, td, H100_SMEM_OPTIN)
            need = cuda_p3m_tail.tail_shared_bytes(w, chunk, td)
            assert need + CTA_RESERVED <= H100_SMEM_OPTIN
    with pytest.raises(ValueError):
        cuda_p3m_tail.tail_budget(cuda_p3m_tail.MAX_CAP + 1, 2, td, H100_SMEM_OPTIN)


def _tail_planes(rng, grid, cap, w):
    """Padded planes with a w-cell halo of zeros, each cell's occupied slots
    scattered over its cap slots (no prefix)."""
    gpc = grid + 2 * w
    planes = np.zeros((4, gpc, gpc, gpc, cap))
    inner = (slice(w, w + grid),) * 3
    fill = rng.integers(0, cap + 1, size=(grid, grid, grid))
    fill.reshape(-1)[:2] = (cap, 0)
    occ = np.zeros((grid, grid, grid, cap), bool)
    for idx in np.ndindex(grid, grid, grid):
        occ[idx + (rng.permutation(cap)[: fill[idx]],)] = True
    cell = np.indices((grid, grid, grid))  # z, y, x
    for k, a in enumerate((2, 1, 0)):
        coord = cell[a][..., None] + rng.random((grid, grid, grid, cap))
        planes[k][inner] = np.where(occ, coord, 0.0)
    planes[3][inner] = occ
    return planes.reshape(4, gpc, gpc, gpc * cap)


def _pack_cells(planes, cap: int):
    """The kernel's packing pass: (count (n_pad,), slots (n_pad, cap)), each
    padded cell's occupied slot numbers in slot order first (the rest -1)."""
    occ = planes[3].reshape(-1, cap) > 0
    slots = np.full(occ.shape, -1)
    for c, row in enumerate(occ):
        listed = np.flatnonzero(row)
        slots[c, : listed.size] = listed
    return occ.sum(1), slots


def _tail_emulated(planes, m, sigma, grid, cap, w, chunk):
    """The tail kernel's plan in float64 numpy: per cell row, its packed
    queries, the stencil's packed records in (dz, dy, dx) cell order, staged
    `chunk` at a time; thread (query, slice) sums its records of each chunk
    in order, the slice partials added in slice order, times m."""
    gpc = grid + 2 * w
    span = 2 * w + 1
    flat = planes.reshape(4, -1)
    count, slots = _pack_cells(planes, cap)
    out = np.zeros((4, grid**3, cap))
    for row in range(grid**3):
        ix, iy, iz = row % grid, (row // grid) % grid, row // (grid * grid)
        own = ((iz + w) * gpc + (iy + w)) * gpc + (ix + w)
        nq = count[own]
        if nq == 0:
            continue
        qi = own * cap + slots[own, :nq]
        cells = [((iz + dz) * gpc + (iy + dy)) * gpc + (ix + dx)
                 for dz in range(span) for dy in range(span) for dx in range(span)]
        ci = np.concatenate([c * cap + slots[c, : count[c]] for c in cells])
        d = [flat[k][qi][:, None] - flat[k][ci][None, :] for k in range(3)]
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        inv_r = torch.rsqrt(torch.where(t(d2) > 0, t(d2), torch.ones(())))
        cgp, cpp = (a.numpy() for a in newton_minus_mesh(t(d2), inv_r, sigma))
        terms = [cgp * d[0], cgp * d[1], cgp * d[2], cpp]
        _, qt, s = cuda_p3m_tail.thread_plan(nq)
        partial = np.zeros((4, s, nq))
        for c0 in range(0, ci.size, chunk):
            for sl in range(s):
                cols = np.arange(c0 + sl, min(c0 + chunk, ci.size), s)
                if cols.size:
                    for f in range(4):
                        partial[f, sl] = np.cumsum(
                            np.concatenate([partial[f, sl][:, None], terms[f][:, cols]], 1),
                            axis=1)[:, -1]
        for f in range(4):
            out[f, row, slots[own, :nq]] = m * np.cumsum(partial[f], axis=0)[-1]
    return out


@pytest.mark.parametrize("w", [1, 2, 3])
def test_tail_plan_matches_reference(w):
    """The tail kernel's plan (each cell's occupied slots packed in slot
    order, stencil order, chunks, thread slices, partials in slice order),
    emulated in float64 with a chunk smaller than
    a stencil's records, equals the stencil sums of the reference's
    newton_minus_mesh to reassociation roundoff, on a mask that is no
    prefix of its cells; the plain version agrees too."""
    rng = np.random.default_rng(10 + w)
    grid, cap, m = 3, 8, 1.0 / 500
    sigma = 2.2 / {1: 10, 2: 5, 3: 4}[w]
    planes = _tail_planes(rng, grid, cap, w)
    got = _tail_emulated(planes, m, sigma, grid, cap, w, chunk=64)

    gpc = grid + 2 * w
    pos = planes[:3].reshape(3, gpc, gpc, gpc, cap)
    occ = planes[3].reshape(gpc, gpc, gpc, cap) > 0
    want = np.zeros_like(got)
    rows = []  # (row, own mask, d (3, nq, nc)): every row's pairs, then one reference call
    for row in range(grid**3):
        ix, iy, iz = row % grid, (row // grid) % grid, row // (grid * grid)
        box = (slice(iz, iz + 2 * w + 1), slice(iy, iy + 2 * w + 1), slice(ix, ix + 2 * w + 1))
        own = occ[iz + w, iy + w, ix + w]
        if own.any():
            q = pos[:, iz + w, iy + w, ix + w][:, own]
            rows.append((row, own, q[:, :, None] - pos[(slice(None),) + box][:, occ[box]][:, None]))
    d2 = np.concatenate([(d * d).sum(0).ravel() for _, _, d in rows])
    inv_r = 1.0 / np.sqrt(np.where(d2 > 0, d2, 1.0))
    cgp, cpp = (np.asarray(a) for a in nmm_ref(jnp.asarray(d2), jnp.asarray(inv_r), sigma))
    at = 0
    for row, own, d in rows:
        n = d[0].size
        g, p = cgp[at : at + n].reshape(d[0].shape), cpp[at : at + n].reshape(d[0].shape)
        at += n
        for f, v in enumerate((g * d[0], g * d[1], g * d[2], p)):
            want[f, row, own] = m * v.sum(1)
    plain = cuda_p3m_tail.p3m_tail_plain(t(planes), m, sigma, grid=grid, cap=cap,
                                         halfwidth=w).numpy()
    for f in range(4):
        scale = np.abs(want[f]).max()
        assert scale > 0
        np.testing.assert_allclose(got[f], want[f], rtol=1e-11, atol=1e-13 * scale)
        np.testing.assert_allclose(plain[f], want[f], rtol=1e-11, atol=1e-13 * scale)


# ------------------------------------------------------------ K2


def k2_rows():
    """Every (cap, cw) the class and mono-tile planners emit."""
    shapes = [(cap_k, 27 * cap) for cap in CLASS_MENU for cap_k in CLASS_MENU if cap_k <= cap]
    return shapes + [(cap, 27 * cap) for cap in mono_caps()]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_k2_budget_fits_every_plannable_row(dtype):
    """At every (cap, cw) of the class and mono engines, up to cap 256 in
    float64 too, K2's shared memory at its default piece fits the H100 with
    room for two CTAs an SM; float32 mono rows at cap 160 leave room for
    four."""
    td = getattr(torch, dtype)
    for cap, cw in k2_rows():
        piece = cuda_tile_pairs.k2_budget(cap, cw, td, H100_SMEM_OPTIN)
        assert piece % 64 == 0
        need = cuda_tile_pairs.k2_shared_bytes(cap, cw, piece, td)
        assert 2 * (need + CTA_RESERVED) <= 228 * 1024
    if td == torch.float32:
        need = cuda_tile_pairs.k2_shared_bytes(160, 27 * 160, cuda_tile_pairs.K2_PIECE[td], td)
        assert 4 * (need + CTA_RESERVED) <= 228 * 1024
    with pytest.raises(ValueError):
        cuda_tile_pairs.k2_budget(cuda_tile_pairs.MAX_CAP + 1, 27 * 257, td, H100_SMEM_OPTIN)


def _k2_numbering(mask_row, piece):
    """K2's record numbering of one candidate row: occupancy words, their
    exclusive prefix, and for each piece the word range [w_lo, w_end) the
    kernel stages it from; returns {slot: record} and the pieces' records."""
    cw = mask_row.size
    n_words = -(-cw // 32)
    bits = np.zeros(n_words * 32, bool)
    bits[:cw] = mask_row > 0
    words = bits.reshape(n_words, 32)
    wpre = np.concatenate([[0], np.cumsum(words.sum(1))])
    nc = int(wpre[-1])

    def upper(v):  # the first word w with wpre[w] > v
        return int(np.searchsorted(wpre, v, side="right"))

    record, pieces = {}, []
    for p0 in range(0, nc, piece):
        n_here = min(piece, nc - p0)
        w_lo, w_end = upper(p0) - 1, upper(p0 + n_here - 1)
        got = []
        for j in range(32 * w_lo, 32 * w_end):
            w, b = divmod(j, 32)
            rec = wpre[w] + words[w, :b].sum() - p0
            if words[w, b] and 0 <= rec < n_here:
                assert j not in record
                record[j] = p0 + rec
                got.append(p0 + rec)
        pieces.append(sorted(got))
    return record, pieces, nc


@pytest.mark.parametrize("piece", [64, 128, 512])
@pytest.mark.parametrize("occupancy", [0.0, 0.05, 0.4, 1.0])
def test_k2_records_cover_each_occupied_slot_once(occupancy, piece):
    """Every occupied candidate slot of a row gets exactly one record, in
    slot order; the pieces partition the records in order, each staged
    from its word range."""
    rng = np.random.default_rng(int(100 * occupancy) + piece)
    for cw in (27 * 16, 27 * 160, 27 * 150):
        mask = (rng.random(cw) < occupancy).astype(float)
        record, pieces, nc = _k2_numbering(mask, piece)
        occupied = np.flatnonzero(mask)
        assert sorted(record) == occupied.tolist()
        assert [record[j] for j in occupied] == list(range(nc))
        assert sum(pieces, []) == list(range(nc))
        assert all(len(p) == min(piece, nc - i * piece) for i, p in enumerate(pieces))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_k2_cull_keeps_every_masked_pair(dtype):
    """Every pair in the forward, reverse or gravity mask, as the plain
    version computes them (f32 and f64 rounding, pairs placed on the masks'
    edges, h <= 0 slots), passes the cull d2 <= max(cull_r2(h_q),
    cull_r2(h_c)) with room for the test's d2 to round otherwise."""
    td = getattr(torch, dtype)
    rng = np.random.default_rng(7)
    n = 200_000
    hq = rng.uniform(0.01, 1.0, n)
    hc = hq * rng.uniform(0.3, 3.0, n)
    hq[:50], hc[50:100] = 0.0, -0.4  # masked-off and odd slots
    edge = np.concatenate([2 * hq[: n // 3], 2 * hc[n // 3 : 2 * n // 3],
                           hq[2 * n // 3 :] + hc[2 * n // 3 :]])
    r = np.abs(edge) * rng.uniform(0.999, 1.001, n)
    u = rng.standard_normal((3, n))
    u /= np.linalg.norm(u, axis=0)
    d = t(r * u).to(td)
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    hq_t, hc_t = t(hq).to(td), t(hc).to(td)
    fwd = d2 <= (2.0 * hq_t) * (2.0 * hq_t)
    rev = d2 <= (2.0 * hc_t) * (2.0 * hc_t)
    one = torch.ones((), dtype=td)
    rr = d2 * torch.rsqrt(torch.where(d2 > 0, d2, one))
    h_avg = 0.5 * (torch.where(hq_t > 0, hq_t, one) + torch.where(hc_t > 0, hc_t, one))
    gmask = rr <= 2.0 * h_avg
    masked = fwd | rev | gmask
    cull = torch.maximum(cuda_tile_pairs.cull_r2(hq_t), cuda_tile_pairs.cull_r2(hc_t))
    assert int(masked.sum()) > n // 4
    assert bool((d2[masked] * (1.0 + 2.0**-16) <= cull[masked]).all())


def _k2_inputs(seed=3, n_cells=6, cap=32):
    """Cell rows with cw = 27 * cap, ~40 % occupied in scattered slots, the
    queries the centre cell's slots (one row with none)."""
    rng = np.random.default_rng(seed)
    cw = 27 * cap
    cm = (rng.random((n_cells, cw)) < 0.4).astype(float)
    pos = [rng.random((n_cells, cw)) * cm for _ in range(3)]
    vel = [0.3 * rng.standard_normal((n_cells, cw)) * cm for _ in range(3)]
    ch = (0.05 + 0.1 * rng.random((n_cells, cw))) * cm
    crho = (0.5 + rng.random((n_cells, cw))) * cm
    cpor2 = (0.5 + rng.random((n_cells, cw))) * cm
    ccs = (0.8 + 0.4 * rng.random((n_cells, cw))) * cm
    cfields = pos + vel + [cm, ch, crho, cpor2, ccs]
    sl = slice(13 * cap, 14 * cap)
    qfields = [c[:, sl].copy() for c in cfields]
    qfields[6][2] = 0.0
    return qfields, cfields, cap


@pytest.mark.parametrize("p3m", [False, True])
@pytest.mark.parametrize("eos", ["polytropic", "isothermal"])
def test_k2_pieces_match_reference(eos, p3m):
    """K2's plan splits a row's occupied candidates into pieces of records
    in slot order and adds each query's terms piece after piece (mu_max by
    max). The plain version run piece by piece on the record numbering of
    `_k2_numbering` (64 records a piece), its outputs combined in piece
    order, equals the reference's Pallas kernel (interpret mode) to float64
    roundoff."""
    qfields, cfields, cap = _k2_inputs()
    m, alpha, beta = 1.0 / 4000, 1.0, 2.0
    sigma = 0.35 / 10 * 2.2 if p3m else None
    ref = phase_b_ref(tuple(jnp.asarray(a) for a in qfields),
                      tuple(jnp.asarray(a) for a in cfields),
                      m, alpha, beta, sigma, eos=eos, p3m=p3m, cap=cap, interpret=True)
    n_cells, cw = cfields[0].shape
    big = np.finfo(np.float64).max
    got = [np.zeros((n_cells, cap)) for _ in range(10)]
    got[4][:] = -big
    pieces_by_row = [_k2_numbering(cfields[6][r], 64) for r in range(n_cells)]
    n_pieces = max(len(p[1]) for p in pieces_by_row)
    assert n_pieces >= 3
    for i in range(n_pieces):
        keep = np.zeros((n_cells, cw), bool)
        for r, (record, pieces, _) in enumerate(pieces_by_row):
            if i < len(pieces):
                keep[r, [j for j, rec in record.items() if rec in set(pieces[i])]] = True
        cf = [np.where(keep, c, 0.0) for c in cfields]
        outs = cuda_tile_pairs.phase_b_tiles_plain(
            tuple(t(a) for a in qfields), tuple(t(a) for a in cf), m, alpha, beta, sigma,
            eos=eos, p3m=p3m, cap=cap)
        for f, o in enumerate(outs):
            o = o.numpy()
            got[f] = np.maximum(got[f], o) if f == 4 else got[f] + o
    for f, (a, b) in enumerate(zip(got, ref)):
        b = np.asarray(b)
        if f == 4:
            np.testing.assert_allclose(a, b, rtol=1e-10)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-13 * max(1.0, np.abs(b).max()))
