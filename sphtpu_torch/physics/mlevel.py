"""Multi-level masked cell-tile SPH engine: tile-shaped work at every h scale.

Port of sphtpu/physics/mlevel.py, one device. The reference's module
docstring describes the engine; in short:

*   L independent grids, fine -> coarse. Every particle is binned into
    every level's slot planes (it is a candidate everywhere) but is a
    QUERY only at its species level: the finest level l with
    ROUTE_CUT * h_hint <= s_l. Rows too big for the coarsest level, or
    grazing an opaque cell, go to the residual lane (exact, O(B_res * N)).
*   Work runs only over ACTIVE (z, x) strips, passed per chunk as index
    lists (MLArgs) of planned lengths, and each level's strips are split
    into capacity buckets: a strip whose stencil cells fit cap_b slots
    sweeps cap_b of each cell's slots.
*   Phase A per level x bucket: kernel K1 (kernels/cuda_strip_knn.py) on
    the bucket's prestacked rows, queries (na_b * g, cap_b) against
    candidates (na_b * g, 27 * cap_b), one reach^2 a query (its
    guaranteed stencil reach), exactly the reference's Pallas form. On a
    CUDA tensor K1 runs for every level, bucket and dtype (the reference
    runs its Pallas phase A only on a TPU in float32: ROADMAP D11); on a
    CPU tensor its plain version does.
*   Phase B per level (forward + reverse masked pair sums, the near-field
    gravity correction at the pair's coarser species), phase C (the P3M
    tail on the level-0 planes) and the residual lane are the reference's
    XLA, here torch ops chunked so that a pair temporary holds at most
    PAIR_CHUNK elements.

Certification is one collective `ok` with the tile engines' contract:
False => the caller discards the result and falls back to the gather
engine. The host planner (`plan_mlevel`, `mlevel_args_still_ok`) is the
reference's numpy code without its multi-device arguments.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from scipy.ndimage import binary_dilation

from ..kernels import W, grad_W_over_r, softened_gphi_over_r, softened_phi
from ..kernels.cuda_grouped_pairs import joint_near, joint_term
from ..kernels.cuda_strip_knn import N_BISECT, phase_a_cells
from ..profiling import stage
from .blocks import N_BISECT_F64
from .mesh_gravity import _domain_half, newton_minus_mesh
from ..shard.collectives import request
from .tiles import ReducedForces

# snapped menus keep distinct compiled configurations rare across a run
GRID_MENU = (2, 3, 4, 5, 6, 8, 10, 13, 16, 20, 26, 32, 40, 52, 64, 80, 104, 128)
CAP_MENU = (32, 48, 64, 96, 128, 192, 256, 384, 512)
ACT_GRAN = 32  # active-strip list length granularity

# Species routing margin — deliberately wider than the mono tile engine's
# OUTLIER_CUT (2.0 * 1.07). h drifts up to ~10% per step (the dt ladder's
# c1 = 0.3/|div v| bound on relative density change), and the last force
# eval of an ML_SUBCHUNK=2-step sub-chunk runs against strip lists / a
# species routing planned ~1.5 steps of drift earlier — with only 7%
# headroom those rows tripped the r_k certificate on the real collapse
# state (measured: 1% of L0 rows under 7.6% margin on the committed
# fixture, nfb 2-3 per 2-step chunk). 22% routing headroom plus the
# per-query guaranteed-reach certificate (see phase_a) absorbs the drift;
# the in-engine certificate stays exact, so the margin costs slot work,
# never correctness.
ROUTE_CUT = 2.0 * 1.22
# Opacity-graze pre-routing cushions, mirroring the same drift window:
# h can grow ~1.2x and positions move ~0.25 cell before the lists are
# refreshed, so the host routes to the residual lane anything the engine
# MIGHT see grazing an opaque cell during the sub-chunk.
_GRAZE_H_FACTOR = 1.25
_GRAZE_POS_CELLS = 0.3


def _occ_margin(cap: int) -> int:
    """Occupancy drift headroom per sub-chunk: how many rows can
    plausibly cross into one cell before the traced lists are refreshed
    (measured on the collapse fixture: a handful per half-step at the
    densest cells)."""
    return max(4, cap // 16)


def _opaque_forecast(occ, cap):
    """Cells the engine might see as opaque during the sub-chunk. The
    engine recomputes occupancy from the CURRENT positions every eval, so
    a cell sitting at the cap boundary flips opaque when a few rows drift
    in — measured on the collapse fixture: 2 cells flipped per half-step,
    and 100% of the hard-regime cert failures were grazes against such
    NEWLY-opaque cells (the distance/h cushions alone cannot see them).
    The forecast therefore treats nearly-full cells as opaque when
    graze-routing; the in-engine certificate stays exact."""
    return occ > cap - _occ_margin(cap)


def _strip_req_host(occ3, cap, g, *, forecast, window=3):
    """(g*g,) per-strip sweep-capacity requirement: the max, over the
    strip's window x window (z, x) neighborhood at every y, of per-cell
    occupancy — the smallest bucket capacity whose slot slices lose no
    candidate a sweep at this strip can reach. Opaque cells are excluded
    (the graze certificates keep every certified query clear of their
    contents). window=3 for the 3^3 hydro stencil; 2*c_halfwidth+1 for
    the P3M tail pass.

    forecast=True upper-bounds the engine's exact check over one
    sub-chunk of drift: non-opaque cells get the occupancy margin, and
    boundary cells (within the margin of the cap, which may flip either
    way) pin to the full level cap."""
    m = _occ_margin(cap)
    if forecast:
        eff = np.where(occ3 > cap + m, 0, np.minimum(occ3 + m, cap))
    else:
        eff = np.where(occ3 > cap, 0, occ3)
    col = eff.max(axis=1)  # (z, x): max over all y
    w = window // 2
    colp = np.pad(col, w)
    req = np.zeros_like(col)
    for dz in range(window):
        for dx in range(window):
            req = np.maximum(req, colp[dz : dz + g, dx : dx + g])
    return req.reshape(-1)


def _bucketize(ids, req, bucket_caps):
    """Partition strip ids into len(bucket_caps) lists: each strip goes
    to the smallest bucket whose capacity covers its requirement.
    bucket_caps is ascending and ends at the level cap (req <= cap by
    construction, so every strip lands somewhere)."""
    out = []
    lo = -1
    for cb in bucket_caps:
        r = req[ids]
        out.append(ids[(r > lo) & (r <= cb)])
        lo = cb
    return out


class MLArgs(NamedTuple):
    """Per-chunk arguments. Lengths are fixed by the MLSpec; contents
    refresh every chunk (`mlevel_args_still_ok`). The planner returns
    numpy arrays; `mlevel_args_to_device` puts them on a device.

    species is the host's ROUTING decision (finest admissible level per
    row, with opaque-cell grazers demoted to the residual lane). It is a
    hint, never a correctness input: every species-l row is certified
    in-engine on FOUND values (r_k <= s_l, opacity clearance), and the
    residual lane is exact regardless of membership."""

    act_a: tuple  # per level: per bucket: (na_b,) int32, sentinel-padded
    act_b: tuple  # per level: per bucket: (nb_b,) int32
    act_c: tuple | None  # per bucket: (nc_b,) int32 mesh-level strips (p3m)
    species: object = None  # (N,) int32 in [0, L]; L = residual


# MLSpec is carried inside EngineConfig as a plain nested tuple (hashable):
#   ( ((grid, cap, buckets), ...per level...),
#     res_budget, mesh_level, c_buckets )
# buckets = ((cap_b, na_b, nb_b), ...) ascending, ending at cap: per-strip
# capacity classes — a strip whose reachable stencil cells fit cap_b slots
# sweeps (cap_b)^2 pair slots instead of cap^2 (the level cap only shapes
# the slot planes and the scatter targets).
# mesh_level = -1 for exact gravity; c_buckets = () then. In p3m mode
# c_buckets = ((cap_b, nc_b), ...) buckets the tail pass the same way
# (requirement window = the (2 c_halfwidth + 1)^2 tail stencil).


def _snap_up(menu, v):
    for m in menu:
        if m >= v:
            return m
    return menu[-1]


def _ceil_to(x: int, m: int) -> int:
    return -(-max(x, 1) // m) * m


def _species_of(h, s_edges, cut=ROUTE_CUT):
    """Finest level l with cut*h <= s_l; len(s_edges) = residual."""
    sp = np.full(h.shape[0], len(s_edges), np.int32)
    for l in range(len(s_edges) - 1, -1, -1):
        sp[cut * h <= s_edges[l]] = l
    return sp


def _host_layout(pos, h, levels, half, cache=None):
    """Shared host-side geometry: species, per-level cells/occupancy.
    cache (optional dict keyed by grid) amortizes the binning across the
    planner's many candidate evaluations."""
    s_edges = [2.0 * half / g for g, _ in levels]
    sp = _species_of(h, s_edges)
    cells = []
    occ = []
    for (g, _), s in zip(levels, s_edges):
        hit = cache.get(g) if cache is not None else None
        if hit is None:
            c = np.clip((pos + half) // s, 0, g - 1).astype(np.int64)
            o = np.bincount(
                (c[:, 2] * g + c[:, 1]) * g + c[:, 0], minlength=g**3
            ).reshape(g, g, g)
            if cache is not None:
                cache[g] = (c, o)
        else:
            c, o = hit
        cells.append(c)
        occ.append(o)
    return s_edges, sp, cells, occ


def _graze_rcut(h_rows, s):
    """Host forecast of the engine's opacity-clearance radius over one
    sub-chunk of drift: the engine requires dmin > max(h + s/2, 2h) on
    FOUND h; h may grow _GRAZE_H_FACTOR x and the row may move
    _GRAZE_POS_CELLS cells toward the opaque cell before the lists are
    refreshed."""
    hf = _GRAZE_H_FACTOR * h_rows
    return np.maximum(hf + 0.5 * s, 2.0 * hf) + _GRAZE_POS_CELLS * s


def _graze(pos, half, rows, rcut, cell, opaque3, s, g):
    """rows (indices into pos) whose ball of radius rcut touches an opaque
    stencil cell. Host numpy; pos in centered coords, cells in [0,g)."""
    if rows.size == 0 or not opaque3.any():
        return np.zeros(rows.shape[0], bool)
    p = pos[rows] + half  # box coords
    cc = cell[rows]
    graze = np.zeros(rows.shape[0], bool)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                zz = cc[:, 2] + dz
                yy = cc[:, 1] + dy
                xx = cc[:, 0] + dx
                inb = (
                    (zz >= 0) & (zz < g) & (yy >= 0) & (yy < g)
                    & (xx >= 0) & (xx < g)
                )
                op = np.zeros(rows.shape[0], bool)
                op[inb] = opaque3[zz[inb], yy[inb], xx[inb]]
                box_lo = np.stack([xx, yy, zz], 1).astype(p.dtype) * s
                d = np.maximum(np.maximum(box_lo - p, p - (box_lo + s)), 0.0)
                dmin = np.sqrt((d * d).sum(1))
                graze |= op & (dmin <= rcut)
    return graze


def _strip_sets(cells, sp_mask, g):
    """(active-A, active-B, active-C) strip ids for one level.

    The lists are traced chunk constants while the state DRIFTS under
    them: per-step motion is CFL-bounded by 0.3 h <= 0.15 s, so over a
    short chunk a row near a strip boundary can cross into a neighboring
    (z, x) strip. Each list is therefore DILATED one cell beyond its
    minimal set — A: strips holding species-l rows +1 (phase-A coverage
    of drifted queries); B: +1 beyond A (reverse receivers one cell from
    any drifted query); C: nonempty strips +1 (every particle must stay
    covered by the mesh-tail pass). The in-engine coverage certificates
    compare the CURRENT need against these provisions, so a drift that
    outruns the dilation still fails safe (fallback, never physics)."""
    a2d = np.zeros((g, g), bool)
    src = cells[sp_mask]
    a2d[src[:, 2], src[:, 0]] = True
    nonempty = np.zeros((g, g), bool)
    nonempty[cells[:, 2], cells[:, 0]] = True
    k3 = np.ones((3, 3), bool)
    a_dil = binary_dilation(a2d, k3)
    b2d = binary_dilation(a_dil, k3)
    ne_dil = binary_dilation(nonempty, k3)
    act_a = np.flatnonzero(a_dil.reshape(-1)).astype(np.int32)
    act_b = np.flatnonzero(b2d.reshape(-1)).astype(np.int32)
    return act_a, act_b, np.flatnonzero(ne_dil.reshape(-1)).astype(np.int32)


def _pad_act(ids, n_pad, n_tiles):
    """Pad an active list with the out-of-range sentinel `n_tiles` (= g*g).
    Sentinel strips compute a clamped-garbage tile whose outputs scatter
    out of bounds and drop — so padding is harmless on one device AND
    never double-counts when the list is sharded across devices (a
    repeated real id would be computed — and set/psum-merged — twice)."""
    out = np.full(n_pad, n_tiles, np.int32)
    if ids.size:
        out[: ids.size] = ids[:n_pad]
    return out


# ---------------------------------------------------------------------------
# Host planner
# ---------------------------------------------------------------------------

# cost-model constants (ops per candidate slot scanned / per residual pair),
# calibrated against measured v5e pass times (BASELINE.md)
_OPS_A = 117.0
_OPS_B = 70.0
_OPS_C = 12.0
_OPS_RES = 390.0
_RATE = 7.0e11  # effective ops/s, only ratios matter


def plan_mlevel(
    pos_code,
    h,
    kh: int,
    *,
    gravity: str = "exact",
    max_levels: int = 4,
    cap_max: int = 512,
    res_budget_max: int = 16384,
    headroom: float = 1.25,
    act_slack: float = 1.3,
    slots_max: int = 12_000_000,
    mesh_factor: int = 5,
    sigma_cells: float = 2.2,
    shards: int = 1,
):
    """Choose a multi-level spec for the current state.

    mesh_factor/sigma_cells MUST match the EngineConfig the spec is run
    with (both sides derive the tail-stencil half-width from them).

    Returns (spec_tuple, MLArgs-as-numpy dict) or None when no feasible
    multi-level configuration exists (caller keeps mono-level/gather).
    spec_tuple = (levels, res_budget, mesh_level, c_buckets) with
    levels = ((grid, cap, ((cap_b, na_b, nb_b), ...)), ...) — per-strip
    capacity buckets, smallest feasible class per strip.

    shards > 1 sizes every active list and the residual budget to a
    multiple of `shards`, so the work-sharded engine (shard/mlevel.py) can
    split them evenly across the shards.
    """
    pos_code = np.asarray(pos_code)
    h = np.asarray(h)
    n = h.shape[0]
    half = float(np.abs(pos_code).max()) * (1 + 1e-6)

    # fine grid from the dense bulk (30th h-quantile), snapped; coarser
    # levels roughly 2x apart. Candidates: every ladder PREFIX (the
    # residual lane absorbs whatever the coarsest kept level misses) x a
    # generous and a tight capacity strategy (tight caps make more cells
    # opaque and graze-route more rows to the residual lane; the cost
    # model arbitrates).
    g_fine = max(int(2.0 * half / (ROUTE_CUT * float(np.quantile(h, 0.3)))), 2)
    h_max = float(h.max())

    # candidate ladders: from each starting grid, descend the snapped
    # menu by 2 slots (ratio ~1.6 — tighter level spacing shrinks coarse
    # caps) or 3 slots (ratio ~2); every PREFIX of every ladder is a
    # candidate and the cost model arbitrates. layout_cache amortizes the
    # per-grid host binning across all of them.
    menu_idx = {g: i for i, g in enumerate(GRID_MENU)}

    def build_ladder(g0, step):
        lad = [g0]
        while (
            2.0 * half / lad[-1] < ROUTE_CUT * h_max
            and len(lad) < max_levels
            and lad[-1] > 2
        ):
            i = menu_idx.get(lad[-1])
            nxt = (
                GRID_MENU[max(i - step, 0)]
                if i is not None
                else max(lad[-1] // 2, 2)
            )
            if nxt >= lad[-1]:
                if lad[-1] // 2 < 2:
                    break
                nxt = lad[-1] // 2
            lad.append(nxt)
        return tuple(lad)

    prefixes = set()
    for g0 in {
        _snap_up(GRID_MENU, max(g_fine // 2, 2)),
        _snap_up(GRID_MENU, max(int(g_fine / 1.4), 2)),
        _snap_up(GRID_MENU, g_fine),
    }:
        for step in (2, 3):
            lad = build_ladder(g0, step)
            for n_keep in range(1, len(lad) + 1):
                prefixes.add(lad[:n_keep])

    best = None
    layout_cache = {}
    for lad in sorted(prefixes):
        for cap_q in (0.985, 0.9):
            cand = _plan_for_grids(
                pos_code, h, kh, list(lad), half,
                gravity=gravity, cap_max=cap_max,
                res_budget_max=res_budget_max, headroom=headroom,
                act_slack=act_slack, slots_max=slots_max,
                mesh_factor=mesh_factor, sigma_cells=sigma_cells,
                cap_quantile=cap_q,
                layout_cache=layout_cache, shards=shards,
            )
            if cand is not None and (best is None or cand[0] < best[0]):
                best = cand
    if best is None:
        return None
    return best[1], best[2]


def _plan_for_grids(
    pos_code, h, kh, grids, half, *,
    gravity, cap_max, res_budget_max, headroom, act_slack, slots_max,
    mesh_factor, sigma_cells=2.2, cap_quantile=0.985, layout_cache=None,
    shards=1,
):
    gran = math.lcm(ACT_GRAN, shards)
    res_gran = math.lcm(256, shards)
    n = h.shape[0]
    levels0 = [(g, 0) for g in grids]
    s_edges, sp, cells, occ = _host_layout(
        pos_code, h, levels0, half, cache=layout_cache
    )

    caps = []
    for l, g in enumerate(grids):
        rows_l = sp == l
        if rows_l.any():
            # capacity covering the cells species-l rows interact with
            # (their own stencil occupancy, tail-quantile with headroom);
            # denser cells go opaque and graze-routing handles the rest
            c = cells[l]
            sid = (c[:, 2] * g + c[:, 1]) * g + c[:, 0]
            occ_flat = occ[l].reshape(-1)
            # occupancy of cells within the 27-stencil of species-l rows
            stencil_occ = []
            cc = c[rows_l]
            if cc.shape[0] > 20000:  # quantile is statistical: subsample
                cc = cc[:: cc.shape[0] // 20000 + 1]
            for dz in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        zz = np.clip(cc[:, 2] + dz, 0, g - 1)
                        yy = np.clip(cc[:, 1] + dy, 0, g - 1)
                        xx = np.clip(cc[:, 0] + dx, 0, g - 1)
                        stencil_occ.append(occ[l][zz, yy, xx])
            so = np.concatenate(stencil_occ)
            need = float(np.quantile(so, cap_quantile)) * headroom
        else:
            need = 32
        if l == 0 and gravity == "p3m":
            # phase C (geometric mesh-tail pass) runs on level 0 and
            # needs every particle present: no opaque cells allowed —
            # with occupancy-drift headroom (a max-occupancy cell must
            # not flip opaque mid-chunk; see _opaque_forecast)
            mx = int(occ[0].max())
            need = float(mx + max(4, mx // 16))
        cap = _snap_up(CAP_MENU, int(need))
        if cap > cap_max:
            if l == 0 and gravity == "p3m":
                return None
            cap = cap_max
        caps.append(cap)

    # route grazing rows to the residual lane; iterate once (routing can
    # only shrink the species sets)
    res = sp == len(grids)
    for l, (g, cap) in enumerate(zip(grids, caps)):
        opaque3 = _opaque_forecast(occ[l], cap)
        rows = np.flatnonzero(sp == l)
        rcut = _graze_rcut(h[rows], s_edges[l])
        gz = _graze(pos_code, half, rows, rcut, cells[l], opaque3, s_edges[l], g)
        res[rows[gz]] = True
        sp[rows[gz]] = len(grids)

    n_res = int(res.sum())
    if n_res > res_budget_max:
        return None
    res_budget = _ceil_to(int(n_res * 1.5 + 64), res_gran) if n_res else 0

    # species-l rows must fit their own cells' capacity (they have slot
    # priority, but > cap own-species rows in one cell cannot certify)
    for l, (g, cap) in enumerate(zip(grids, caps)):
        rows_l = sp == l
        if not rows_l.any():
            continue
        c = cells[l][rows_l]
        cnt = np.bincount(
            (c[:, 2] * g + c[:, 1]) * g + c[:, 0], minlength=g**3
        ).max()
        if cnt > cap:
            return None

    levels = []
    acts_a, acts_b, nonempties, reqs = [], [], [], []
    cost = 0.0
    for l, (g, cap) in enumerate(zip(grids, caps)):
        if g**3 * cap > slots_max:
            return None
        act_a, act_b, nonempty = _strip_sets(cells[l], sp == l, g)
        req = _strip_req_host(occ[l], cap, g, forecast=True)

        def list_len(count):
            return max(
                min(
                    _ceil_to(int(count * act_slack), gran),
                    _ceil_to(g * g, gran),
                ),
                gran,
            )

        # per-strip capacity buckets: a strip whose stencil occupancy
        # fits a smaller capacity sweeps (cap_b)^2 pair slots instead of
        # cap^2 — measured 3x fewer pair slots on the collapse fixture.
        # Try single-bucket and every (small, cap) split; cost arbitrates.
        best = None
        for opt in [(cap,)] + [
            (cb, cap) for cb in CAP_MENU if cb < cap
        ]:
            bks = []
            c_cost = 0.0
            a_parts = _bucketize(act_a, req, opt)
            b_parts = _bucketize(act_b, req, opt)
            for cb, ap, bp in zip(opt, a_parts, b_parts):
                na_b = list_len(ap.size)
                nb_b = list_len(bp.size)
                bks.append((cb, na_b, nb_b))
                c_cost += na_b * g * cb * 27 * cb * _OPS_A
                c_cost += nb_b * g * cb * 27 * cb * _OPS_B
            if best is None or c_cost < best[0]:
                best = (c_cost, tuple(bks))
        levels.append((g, cap, best[1]))
        acts_a.append(act_a)
        acts_b.append(act_b)
        nonempties.append(nonempty)
        reqs.append(req)
        cost += best[0]
    cost += float(n_res) * n * _OPS_RES

    mesh_level = -1
    c_buckets = ()
    reqc = None
    if gravity == "p3m":
        # the mesh anchors to level 0 (as in tiles.py): sigma is tied to
        # the fine cell edge and the geometric tail pass needs every
        # particle present, which only level 0 (opacity-free) guarantees
        mesh_level = 0
        gml, capml = levels[0][0], levels[0][1]
        c_hw = _c_halfwidth(mesh_factor, sigma_cells)
        c_depth = 2 * c_hw + 1
        reqc = _strip_req_host(
            occ[0], capml, gml, forecast=True, window=c_depth
        )
        ne = nonempties[0]

        def c_list_len(count):
            return max(
                min(
                    _ceil_to(int(count * act_slack), gran),
                    _ceil_to(gml * gml, gran),
                ),
                gran,
            )

        best_c = None
        for opt in [(capml,)] + [
            (cb, capml) for cb in CAP_MENU if cb < capml
        ]:
            bks = []
            c_cost = 0.0
            for cb, cp in zip(opt, _bucketize(ne, reqc, opt)):
                nc_b = c_list_len(cp.size)
                bks.append((cb, nc_b))
                c_cost += nc_b * gml * cb * c_depth**3 * cb * _OPS_C
            if best_c is None or c_cost < best_c[0]:
                best_c = (c_cost, tuple(bks))
        c_buckets = best_c[1]
        cost += best_c[0]

    spec = (tuple(levels), res_budget, mesh_level, c_buckets)
    args = _args_for_spec(spec, acts_a, acts_b, nonempties, sp, reqs, reqc)
    if args is None:
        return None
    return cost, spec, args


def _c_halfwidth(mesh_factor, sigma_cells=2.2):
    """Tail-stencil half-width in tile cells (must mirror
    EngineConfig.c_halfwidth): smallest w with w tile cells >= 4.4 sigma."""
    return max(1, math.ceil(4.4 * sigma_cells / mesh_factor - 1e-9))


def _args_for_spec(spec, acts_a, acts_b, nonempties, species, reqs, reqc):
    levels, res_budget, mesh_level, c_buckets = spec
    pa, pb = [], []
    for (g, cap, buckets), aa, ab, req in zip(levels, acts_a, acts_b, reqs):
        bucket_caps = [bk[0] for bk in buckets]
        a_parts = _bucketize(aa, req, bucket_caps)
        b_parts = _bucketize(ab, req, bucket_caps)
        la, lb = [], []
        for (cb, na_b, nb_b), ap, bp in zip(buckets, a_parts, b_parts):
            if ap.size > na_b or bp.size > nb_b:
                return None
            la.append(_pad_act(ap, na_b, g * g))
            lb.append(_pad_act(bp, nb_b, g * g))
        pa.append(tuple(la))
        pb.append(tuple(lb))
    ac = None
    if mesh_level >= 0:
        ne = nonempties[mesh_level]
        gml = levels[mesh_level][0]
        c_parts = _bucketize(ne, reqc, [bk[0] for bk in c_buckets])
        lc = []
        for (cb, nc_b), cp in zip(c_buckets, c_parts):
            if cp.size > nc_b:
                return None
            lc.append(_pad_act(cp, nc_b, gml * gml))
        ac = tuple(lc)
    return MLArgs(
        act_a=tuple(pa), act_b=tuple(pb), act_c=ac,
        species=species.astype(np.int32),
    )


def mlevel_args_still_ok(pos_code, h, spec, *, mesh_factor=5,
                         sigma_cells=2.2):
    """Hysteresis: refresh MLArgs for an ALREADY-COMPILED spec from the
    current state, or None when the spec cannot certify anymore (species
    overflow a cap / an active list / the residual budget). Cheap host
    forecast; the in-engine certificate remains the safety net.
    mesh_factor/sigma_cells must match the EngineConfig (they set the
    tail-stencil window); a mismatch is caught by the in-engine cert."""
    pos_code = np.asarray(pos_code)
    h = np.asarray(h)
    levels, res_budget, mesh_level, c_buckets = spec
    half = float(np.abs(pos_code).max()) * (1 + 1e-6)
    grids = [lv[0] for lv in levels]
    caps = [lv[1] for lv in levels]
    s_edges, sp, cells, occ = _host_layout(
        pos_code, h, [(g, 0) for g in grids], half
    )
    res = sp == len(grids)
    for l, (g, cap) in enumerate(zip(grids, caps)):
        opaque3 = _opaque_forecast(occ[l], cap)
        rows = np.flatnonzero(sp == l)
        rcut = _graze_rcut(h[rows], s_edges[l])
        gz = _graze(pos_code, half, rows, rcut, cells[l], opaque3, s_edges[l], g)
        res[rows[gz]] = True
        sp[rows[gz]] = len(grids)
    if int(res.sum()) > res_budget:
        return None
    if mesh_level == 0 and _opaque_forecast(occ[0], caps[0]).any():
        # p3m phase C needs level 0 opaque-free; a max-occupancy cell
        # within drift headroom of the cap could flip opaque mid-chunk
        return None
    acts_a, acts_b, nonempties, reqs = [], [], [], []
    for l, (g, cap) in enumerate(zip(grids, caps)):
        rows_l = sp == l
        if rows_l.any():
            c = cells[l][rows_l]
            cnt = np.bincount(
                (c[:, 2] * g + c[:, 1]) * g + c[:, 0], minlength=g**3
            ).max()
            if cnt > cap:
                return None
        aa, ab, ne = _strip_sets(cells[l], rows_l, g)
        acts_a.append(aa)
        acts_b.append(ab)
        nonempties.append(ne)
        reqs.append(_strip_req_host(occ[l], cap, g, forecast=True))
    reqc = None
    if mesh_level >= 0:
        c_depth = 2 * _c_halfwidth(mesh_factor, sigma_cells) + 1
        reqc = _strip_req_host(
            occ[mesh_level], caps[mesh_level], grids[mesh_level],
            forecast=True, window=c_depth,
        )
    return _args_for_spec(spec, acts_a, acts_b, nonempties, sp, reqs, reqc)


# ---------------------------------------------------------------------------
# Device-side force evaluation
# ---------------------------------------------------------------------------

# pair slots a torch chunk of phase B, phase C or the residual lane
# evaluates at a time: each pair temporary holds at most this many elements
# (32 MB in float32)
PAIR_CHUNK = 1 << 23


def mlevel_args_to_device(args: MLArgs, device) -> MLArgs:
    """MLArgs with every list as an int64 tensor on `device` (lists already
    there are kept as they are)."""

    def t(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=torch.long)
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)

    return MLArgs(
        act_a=tuple(tuple(t(b) for b in lvl) for lvl in args.act_a),
        act_b=tuple(tuple(t(b) for b in lvl) for lvl in args.act_b),
        act_c=None if args.act_c is None else tuple(t(b) for b in args.act_c),
        species=t(args.species),
    )


def _stack_index(strips, g, gp, cap, cap_b, depth):
    """Flat indices into a (gp, gp, gp, cap) slot plane (padded by
    depth // 2 cells) for the strips (k,) (ids z * g + x of real strips):
    the query slots (k * g, cap_b), the centre cell's first cap_b slots of
    each (z, y, x) cell, and the stacked candidate slots
    (k * g, depth^3 * cap_b) in (dz, dy, dx, slot) order — the rows of the
    reference's strip views and of its phase-A prestack."""
    dev = strips.device
    d2o = depth // 2
    base = ((strips // g) * gp * gp + strips % g) * cap
    rows = (base[:, None] + (torch.arange(g, device=dev) * gp * cap)[None, :]).reshape(-1, 1)
    d = torch.arange(depth, device=dev)
    off = ((d[:, None, None] * gp + d[None, :, None]) * gp + d[None, None, :]) * cap
    slot = torch.arange(cap_b, device=dev)
    cand = (off.reshape(-1, 1) + slot[None, :]).reshape(1, -1)
    query = (((d2o * gp + d2o) * gp + d2o) * cap + slot)[None, :]
    return rows + query, rows + cand


def _level_planes(vals, fills, slot, total):
    """(F, total) slot planes of the row fields vals (F, N): each row's
    value at its flat slot, `fills` elsewhere; rows whose slot is `total`
    (dropped) fall off."""
    planes = torch.empty((vals.shape[0], total + 1), dtype=vals.dtype, device=vals.device)
    planes[:] = torch.as_tensor(fills, dtype=vals.dtype, device=vals.device)[:, None]
    planes[:, slot] = vals
    return planes[:, :total]


def _check_prestack_fits(n_slots, n_fields, dtype, device):
    """Raise where a phase-A prestack of n_slots candidate slots (n_fields
    planes and one int64 index each) would not fit the card's free memory."""
    if device.type != "cuda":
        return
    need = n_slots * (n_fields * dtype.itemsize + 8)
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    if need > free:
        raise RuntimeError(
            f"mlevel phase A: a bucket's prestack needs {need} B, the card has {free} B free"
        )


def _phase_a_bucket(PA, act, g, gp, cap, cap_b, s, half, m, kh, n_bisect):
    """Phase A of one level x bucket on kernel K1: h, rho, ok (k, g, cap_b)
    of the strips `act` (k,), sentinel ids included (clamped to a real
    strip; the caller drops their outputs). PA (6, gp^3 * cap): the
    level's X, Y, Z, MASK, species-l query mask and SPECP planes."""
    dtype = PA.dtype
    strips = torch.clamp(act, max=g * g - 1)
    k = strips.shape[0]
    _check_prestack_fits(k * g * 27 * cap_b, 4, dtype, PA.device)
    iq, ic = _stack_index(strips, g, gp, cap, cap_b, 3)
    qx, qy, qz = (PA[a][iq] for a in range(3))
    qm = PA[4][iq]
    cands = tuple(PA[a][ic] for a in range(4))
    del ic
    # per-query GUARANTEED search reach: s + the distance from the query
    # to its own cell's nearest face (the 3^3 stencil holds everything
    # within it)
    zi = torch.repeat_interleave(strips // g, g)[:, None].to(dtype)
    xi = torch.repeat_interleave(strips % g, g)[:, None].to(dtype)
    yi = torch.arange(g, device=PA.device).repeat(k)[:, None].to(dtype)
    lox = xi * s - half
    loy = yi * s - half
    loz = zi * s - half
    face = torch.minimum(
        torch.minimum(qx - lox, lox + s - qx),
        torch.minimum(
            torch.minimum(qy - loy, loy + s - qy),
            torch.minimum(qz - loz, loz + s - qz),
        ),
    )
    reach = s + torch.minimum(torch.clamp_min(face, 0.0), 0.5 * s)
    h, rho, ok = phase_a_cells(
        (qx, qy, qz, qm), (reach * reach).contiguous(), cands, m,
        kh=kh, cap=cap_b, n_bisect=n_bisect,
    )
    return (a.reshape(k, g, cap_b) for a in (h, rho, ok))


def _pairs_b(q, c, lf, m, eos, alpha, beta, big, sigma=None):
    """The reference's phase-B pair sums for query fields q (13 of
    (R, cap_b, 1)) against candidate fields c (13 of (R, 1, W)) in
    level_planes order: (ax, ay, az, div, mu_max, visc, gx, gy, gz, gphi),
    each (R, cap_b). sigma (joint mode, ROADMAP D21): a pair of the
    gravity mask, then `joint_near`, takes its term 1 and the tail's term 2
    as one float64 term (`joint_term`); phase C leaves it out."""
    qx, qy, qz, qvx, qvy, qvz, qm, qs, qh, qrk2, qrho, qpor2, qcs = q
    cx, cy, cz, cvx, cvy, cvz, cm, cspec, ch, crk2, crho, cpor2, ccs = c
    zero = torch.zeros((), dtype=qx.dtype, device=qx.device)
    one = torch.ones((), dtype=qx.dtype, device=qx.device)
    dx = qx - cx
    dy = qy - cy
    dz = qz - cz
    d2 = dx * dx + dy * dy + dz * dz
    r = torch.sqrt(d2)
    valid = (cm > 0) & (qm > 0)
    fwd = valid & (qs == lf) & (d2 <= qrk2)
    rev = valid & (cspec == lf) & (d2 <= crk2)

    h_q = torch.where(qh > 0, qh, one)
    h_c = torch.where(ch > 0, ch, one)
    h_avg = 0.5 * (h_q + h_c)
    rho_avg = torch.where(valid, 0.5 * (qrho + crho), one)

    v_dot_r = (qvx - cvx) * dx + (qvy - cvy) * dy + (qvz - cvz) * dz
    mu = torch.clamp_max(h_avg * v_dot_r / (d2 + 0.01 * h_avg**2), 0.0)
    pi_fwd = (-alpha * qcs * mu + beta * mu * mu) / rho_avg
    pi_rev = (-alpha * ccs * mu + beta * mu * mu) / rho_avg

    dwdr_q = grad_W_over_r(r / h_q, r, h_q)
    dwdr_c = grad_W_over_r(r / h_c, r, h_c)

    if eos == "polytropic":
        psum = qpor2 + cpor2
        ct_fwd = m * (psum + pi_fwd) / 2.0
        ct_rev = m * (psum + pi_rev) / 2.0
    else:
        ct_fwd = m * (qpor2 + pi_fwd / 2.0)
        ct_rev = m * (cpor2 + pi_rev / 2.0)

    coeff = -torch.where(fwd, ct_fwd * dwdr_q, zero) - torch.where(rev, ct_rev * dwdr_c, zero)
    ax = torch.sum(coeff * dx, dim=-1)
    ay = torch.sum(coeff * dy, dim=-1)
    az = torch.sum(coeff * dz, dim=-1)
    del coeff

    v_dot_dw_q = v_dot_r * dwdr_q
    v_dot_dw_c = v_dot_r * dwdr_c
    div_t = m * torch.sum(torch.where(fwd, v_dot_dw_q, zero), dim=-1)
    mu_max_t = torch.max(torch.where(fwd, mu, -big), dim=-1).values
    visc_t = torch.sum(
        torch.where(fwd, m * pi_fwd * v_dot_dw_q / 2.0, zero)
        + torch.where(rev, m * pi_rev * v_dot_dw_c / 2.0, zero),
        dim=-1,
    )

    # near-field gravity correction: pairs whose coarser member is species
    # l (residual pairs excluded: their species is L)
    if sigma is not None:
        gmask = valid & (torch.maximum(qs, cspec) == lf) & joint_near(d2, h_q, h_c)
        jg, jp = joint_term(d2, h_avg, sigma)
        cgp = torch.where(gmask, jg, zero)
        cpp = torch.where(gmask, jp, zero)
    else:
        r_safe = torch.where(d2 > 0, r, one)
        newt_g = torch.where(d2 > 0, 1.0 / r_safe**3, zero)
        newt_p = torch.where(d2 > 0, -1.0 / r_safe, zero)
        gmask = valid & (torch.maximum(qs, cspec) == lf) & (r <= 2.0 * h_avg)
        cgp = torch.where(gmask, softened_gphi_over_r(r, h_avg) - newt_g, zero)
        cpp = torch.where(gmask, softened_phi(r, h_avg) - newt_p, zero)
    return (
        ax, ay, az, div_t, mu_max_t, visc_t,
        m * torch.sum(cgp * dx, dim=-1),
        m * torch.sum(cgp * dy, dim=-1),
        m * torch.sum(cgp * dz, dim=-1),
        m * torch.sum(cpp, dim=-1),
    )


def _pairs_c(q, c, m, sigma, n_levels=0):
    """The reference's phase-C (Newtonian - mesh shape) sums for query
    fields q (x, y, z, mask of (R, cap_b, 1)) against candidates c (of
    (R, 1, W)): (gx, gy, gz, gphi), each (R, cap_b). n_levels > 0 (joint
    mode, ROADMAP D21): the fields go on with h, the species and, per level,
    the row's cell (x, y, z; NaN where the level dropped the row), and a
    pair that phase B took jointly is left out: not residual, both rows
    binned at the level of the coarser species and one cell apart there at
    most, and `joint_near` (phase B's own test on the same values)."""
    qx, qy, qz, qm = q[:4]
    cx, cy, cz, cm = c[:4]
    zero = torch.zeros((), dtype=qx.dtype, device=qx.device)
    dx = qx - cx
    dy = qy - cy
    dz = qz - cz
    d2 = dx * dx + dy * dy + dz * dz
    valid = (cm > 0) & (qm > 0)
    if n_levels:
        one = torch.ones((), dtype=qx.dtype, device=qx.device)
        hq, hc = q[4], c[4]
        lmax = torch.maximum(q[5], c[5])
        took = torch.zeros_like(valid)
        for lv in range(n_levels):
            near = lmax == lv
            for a in range(3):
                k = 6 + 3 * lv + a
                near = near & ((q[k] - c[k]).abs() <= 1.0)
            took = took | near
        took = took & joint_near(d2, torch.where(hq > 0, hq, one), torch.where(hc > 0, hc, one))
        valid = valid & ~took
    inv_r = torch.rsqrt(torch.where(d2 > 0, d2, torch.ones_like(d2)))
    cgp, cpp = newton_minus_mesh(d2, inv_r, sigma)
    cgp = torch.where(valid, cgp, zero)
    cpp = torch.where(valid, cpp, zero)
    return (
        m * torch.sum(cgp * dx, dim=-1),
        m * torch.sum(cgp * dy, dim=-1),
        m * torch.sum(cgp * dz, dim=-1),
        m * torch.sum(cpp, dim=-1),
    )


def _sweep_strips(planes, act, g, gp, cap, cap_b, depth, mask_field, n_out, body, grids):
    """Evaluate `body` over the strips `act` (k,) of one bucket and write
    its n_out outputs into grids (n_out, g * g + 1, g, cap) at each strip's
    query slots (sentinel ids into the last, dropped, strip). planes
    (F, gp^3 * cap), read at the query and the candidate slots; a slot is
    occupied where plane `mask_field` is > 0.

    The pair sums run over occupied slots only (the empty ones add exact
    zeros): a cell's occupied slots are its first ones, so a row's queries
    are its first nq slots, and its occupied candidates are moved to its
    front in (dz, dy, dx, slot) order (nc of them). Rows with work go in
    order of decreasing nc, in pieces as wide as their widest row, so that
    a pair temporary holds at most PAIR_CHUNK elements."""
    width = depth**3 * cap_b
    strips = torch.clamp(act, max=g * g - 1)
    ks = max(1, PAIR_CHUNK // (g * width))
    for s0 in range(0, strips.shape[0], ks):
        st = strips[s0 : s0 + ks]
        iq, ic = _stack_index(st, g, gp, cap, cap_b, depth)
        occ_c = planes[mask_field][ic] > 0  # (k * g, W)
        nq = (planes[mask_field][iq] > 0).sum(1)
        nc = occ_c.sum(1)
        rows = torch.argsort(nc * (nq > 0), descending=True, stable=True)
        nq_h = nq[rows].tolist()
        nc_h = nc[rows].tolist()
        live = sum(1 for a, b in zip(nq_h, nc_h) if a > 0 and b > 0)
        order = torch.argsort((~occ_c).to(torch.uint8), dim=1, stable=True)
        del occ_c
        r0 = 0
        while r0 < live:
            wc = nc_h[r0]
            wq = nq_h[r0]
            r1 = r0 + 1
            while r1 < live and (r1 + 1 - r0) * max(wq, nq_h[r1]) * wc <= PAIR_CHUNK:
                wq = max(wq, nq_h[r1])
                r1 += 1
            sel = rows[r0:r1]
            qv = planes[:, iq[sel, :wq]]  # (F, r, wq)
            cv = planes[:, torch.gather(ic[sel], 1, order[sel, :wc])]  # (F, r, wc)
            out = torch.stack(body(tuple(v[:, :, None] for v in qv),
                                   tuple(v[:, None, :] for v in cv)), dim=0)
            grids[:, act[s0 + sel // g], sel % g, :wq] = out
            r0 = r1
    return grids


def mlevel_sph_forces(pos, vel, m, K, h_hint, mlargs: MLArgs, **kw):
    """Multi-level force evaluation on one device: `mlevel_forces_body`
    with every collective the identity (keywords are its own, without
    shard / n_shards)."""
    from ..shard.collectives import run_local

    return run_local(mlevel_forces_body(pos, vel, m, K, h_hint, mlargs, **kw))


def mlevel_forces_body(
    pos,
    vel,
    m,
    K,
    h_hint,
    mlargs: MLArgs,
    *,
    eos: str,
    gamma,
    cs0,
    alpha,
    beta,
    kh: int,
    spec: tuple,
    mesh_factor: int = 5,
    sigma_cells: float = 2.2,
    joint_gravity: bool = False,
    shard: int = 0,
    n_shards: int = 1,
):
    """Multi-level force evaluation as a generator body
    (shard/collectives.py). Work-sharding (n_shards > 1): the inputs are
    replicated, shard `shard` sweeps its contiguous slice of every active
    strip list and of the residual budget (plan with
    plan_mlevel(shards=n_shards) so the lengths divide), and the per-row
    outputs are psum-combined; the coverage certificates use the full
    lists. Same contract as tile_sph_forces:
    returns (ReducedForces, (gx, gy, gz, phi) near-gravity corrections,
    ok); ok is a 0-d bool tensor, False => discard, the caller falls back
    to the gather engine.

    In "exact" mode (spec mesh_level == -1) the corrections turn a global
    pure-Newtonian sweep into the reference's softened gravity; in p3m
    mode (mesh_level == 0) they complete the FFT mesh force, with phase C
    on the level-0 planes (level 0 is certified opacity-free). mlargs:
    numpy (the planner's) or device MLArgs. Each stage runs inside
    profiling.stage (NVTX): "phase_a", "phase_b", "phase_c",
    "residual_knn", "residual_forces".

    joint_gravity=True (what the run loop passes; ROADMAP D21): in float32
    under P3M, phase B takes a close pair's term 1 and term 2 as one
    float64 term and phase C leaves that pair out; the default, and float64
    always, add them in the two phases, as the reference does (F8)."""
    levels, res_budget, mesh_level, c_buckets = spec
    c_hw = _c_halfwidth(mesh_factor, sigma_cells)
    L = len(levels)
    n = pos.shape[0]
    dtype = pos.dtype
    dev = pos.device
    big = torch.finfo(dtype).max
    mlargs = mlevel_args_to_device(mlargs, dev)
    half = _domain_half(pos)
    # binary bisection passes of phase A: float32 keeps K1's 34, the
    # interval bits of the reference's 17 four-way passes; float64 takes the
    # block engine's 68 (ROADMAP D8, D11)
    n_bisect = N_BISECT if dtype == torch.float32 else N_BISECT_F64

    # ---- routed species (host hint; certified on found values) ----
    species = mlargs.species
    spec_f = species.to(dtype)
    s_l = [2.0 * half / levels[l][0] for l in range(L)]

    def shard_ids(ids):
        """This shard's contiguous slice of a padded work list."""
        k = ids.shape[0] // n_shards
        if k * n_shards != ids.shape[0]:
            raise ValueError(
                f"active list length {ids.shape[0]} not divisible by "
                f"{n_shards} shards; plan with plan_mlevel(shards=...)"
            )
        return ids[shard * k : (shard + 1) * k]

    # ---- residual selection (this shard's slice of the padded budget) ----
    if res_budget > 0:
        res_mask = species == L
        res_ok = torch.sum(res_mask) <= res_budget
        res_rows = torch.nonzero(res_mask).flatten()[:res_budget]
        if n_shards > 1:
            k = res_budget // n_shards
            res_rows = res_rows[shard * k : (shard + 1) * k]
        if res_rows.numel() == 0:
            res_rows = None
    else:
        res_ok = torch.all(species < L)
        res_rows = None

    with stage("phase_a"):
        # ---- per-level binning (species-priority slots) + coverage certs ----
        binfo = []
        cov_ok = torch.ones((), dtype=torch.bool, device=dev)
        iota = torch.arange(n, device=dev)
        for l, (g, cap, buckets) in enumerate(levels):
            s = s_l[l]
            c = torch.clamp(torch.floor((pos + half) / s).to(torch.long), 0, g - 1)
            cell = (c[:, 2] * g + c[:, 1]) * g + c[:, 0]
            key = cell * 2 + (species != l).to(torch.long)
            order = torch.argsort(key, stable=True)
            cell_s = cell[order]
            newseg = torch.ones((n,), dtype=torch.bool, device=dev)
            newseg[1:] = cell_s[1:] != cell_s[:-1]
            seg_start = torch.cummax(torch.where(newseg, iota, 0), dim=0).values
            rank = torch.empty_like(iota).scatter_(0, order, iota - seg_start)
            dropped = rank >= cap
            occ = torch.bincount(cell, minlength=g**3)
            opaque = (occ > cap).reshape(g, g, g)
            # species-l rows always hold a slot (priority + this cert)
            cov_ok = cov_ok & ~torch.any((species == l) & dropped)
            if mesh_level == 0 and l == 0:
                cov_ok = cov_ok & ~torch.any(opaque)  # phase C needs everyone

            # strip coverage: species-l strips in act_a; their one-cell
            # dilation (nonempty) in act_b — the union of the level's
            # bucket lists (sentinel ids fall into the extra entry)
            sid = c[:, 2] * g + c[:, 0]
            is_l = (species == l).to(torch.long)

            def provided(lists):
                p = torch.zeros((g * g + 1,), dtype=torch.long, device=dev)
                p[torch.cat(lists)] = 1
                return p[: g * g]

            need_a = torch.zeros((g * g,), dtype=torch.long, device=dev).scatter_reduce(
                0, sid, is_l, "amax"
            )
            ne2d = torch.zeros((g * g,), dtype=torch.long, device=dev)
            ne2d[sid] = 1
            ne2d = ne2d.reshape(g, g)
            pad2d = torch.nn.functional.pad(need_a.reshape(g, g), (1, 1, 1, 1))
            dil = torch.zeros((g, g), dtype=torch.long, device=dev)
            for dz in range(3):
                for dx in range(3):
                    dil = torch.maximum(dil, pad2d[dz : dz + g, dx : dx + g])
            need_b = (dil * ne2d).reshape(-1)
            cov_ok = (
                cov_ok
                & ~torch.any(need_a > provided(mlargs.act_a[l]))
                & ~torch.any(need_b > provided(mlargs.act_b[l]))
            )

            # bucket-capacity certificate: a strip swept at cap_b must have
            # every NON-opaque cell of its 3x3 stencil (all y) within cap_b
            # slots; the top bucket (cap_b == cap) passes by construction
            occ3 = occ.reshape(g, g, g)
            col = torch.where(opaque, 0, occ3).max(dim=1).values
            colp = torch.nn.functional.pad(col, (1, 1, 1, 1))
            req2d = torch.zeros((g, g), dtype=col.dtype, device=dev)
            for dz in range(3):
                for dx in range(3):
                    req2d = torch.maximum(req2d, colp[dz : dz + g, dx : dx + g])
            zero1 = torch.zeros((1,), dtype=col.dtype, device=dev)
            req_pad = torch.cat([req2d.reshape(-1), zero1])  # sentinel g*g -> 0
            for (cb, _, _), a_ids, b_ids in zip(buckets, mlargs.act_a[l], mlargs.act_b[l]):
                if cb < cap:
                    cov_ok = cov_ok & torch.all(req_pad[a_ids] <= cb)
                    cov_ok = cov_ok & torch.all(req_pad[b_ids] <= cb)
            if mesh_level == 0 and l == 0:
                cov_ok = cov_ok & ~torch.any(ne2d.reshape(-1) > provided(mlargs.act_c))
                # tail-pass bucket certificate over the (2 c_hw + 1)^2
                # stencil (level 0 is certified opaque-free above)
                if c_hw == 1:
                    reqc_pad = req_pad
                else:
                    colc = torch.nn.functional.pad(col, (c_hw,) * 4)
                    reqc2d = torch.zeros((g, g), dtype=col.dtype, device=dev)
                    for dz in range(2 * c_hw + 1):
                        for dx in range(2 * c_hw + 1):
                            reqc2d = torch.maximum(reqc2d, colc[dz : dz + g, dx : dx + g])
                    reqc_pad = torch.cat([reqc2d.reshape(-1), zero1])
                for (cb, _), c_ids in zip(c_buckets, mlargs.act_c):
                    if cb < cap:
                        cov_ok = cov_ok & torch.all(reqc_pad[c_ids] <= cb)

            gp = g + 2
            total = gp**3 * cap
            slot = ((c[:, 2] + 1) * gp + c[:, 1] + 1) * gp * cap + (c[:, 0] + 1) * cap + rank
            slot = torch.where(dropped, total, slot)  # dropped rows fall off the plane
            binfo.append(dict(c=c, rank=rank, dropped=dropped, opaque=opaque, slot=slot))

        # ---- phase A per level x bucket: exact r_kh + rho for species-l rows
        Hrow = torch.zeros((n,), dtype=dtype, device=dev)
        RHOrow = torch.zeros((n,), dtype=dtype, device=dev)
        rows_ok = cov_ok & res_ok
        a_planes = []
        ones = torch.ones((n,), dtype=dtype, device=dev)
        for l, (g, cap, buckets) in enumerate(levels):
            s = s_l[l]
            gp = g + 2
            vals = torch.stack(
                [pos[:, 0], pos[:, 1], pos[:, 2], ones, (species == l).to(dtype), spec_f]
            )
            # X, Y, Z, MASK, species-l query mask, SPECP
            PA = _level_planes(vals, [0.0, 0.0, 0.0, 0.0, 0.0, -1.0], binfo[l]["slot"], gp**3 * cap)
            a_planes.append(PA)
            Hg = torch.zeros((g * g + 1, g, cap), dtype=dtype, device=dev)
            RHOg = torch.zeros_like(Hg)
            OKg = torch.ones_like(Hg)
            for bi, (cap_b, _, _) in enumerate(buckets):
                act = shard_ids(mlargs.act_a[l][bi])
                h_b, rho_b, ok_b = _phase_a_bucket(
                    PA, act, g, gp, cap, cap_b, s, half, m, kh, n_bisect
                )
                Hg[act, :, :cap_b] = h_b
                RHOg[act, :, :cap_b] = rho_b
                OKg[act, :, :cap_b] = ok_b
            rows_ok = rows_ok & torch.all(OKg[: g * g] > 0)
            c = binfo[l]["c"]
            strip = c[:, 2] * g + c[:, 0]
            ix = torch.clamp_max(binfo[l]["rank"], cap - 1)
            sel = (species == l) & ~binfo[l]["dropped"]
            Hrow = torch.where(sel, Hg[strip, c[:, 1], ix], Hrow)
            RHOrow = torch.where(sel, RHOg[strip, c[:, 1], ix], RHOrow)

            # opacity clearance, certified per ROW: every opaque stencil
            # cell must stay beyond max(h + s/2, 2h) of each species-l row
            opf = torch.nn.functional.pad(binfo[l]["opaque"].to(torch.uint8), (1,) * 6) > 0
            rcert_row = torch.maximum(Hrow + 0.5 * s, 2.0 * Hrow)
            czr, cyr, cxr = c[:, 2], c[:, 1], c[:, 0]
            ok_op = torch.ones((n,), dtype=torch.bool, device=dev)
            zero = torch.zeros((), dtype=dtype, device=dev)
            for ddz in range(3):
                for ddy in range(3):
                    for ddx in range(3):
                        op = opf[czr + ddz, cyr + ddy, cxr + ddx]
                        lozr = (czr + ddz - 1).to(dtype) * s - half
                        loyr = (cyr + ddy - 1).to(dtype) * s - half
                        loxr = (cxr + ddx - 1).to(dtype) * s - half
                        dxx = torch.maximum(
                            torch.maximum(loxr - pos[:, 0], pos[:, 0] - (loxr + s)), zero
                        )
                        dyy = torch.maximum(
                            torch.maximum(loyr - pos[:, 1], pos[:, 1] - (loyr + s)), zero
                        )
                        dzz = torch.maximum(
                            torch.maximum(lozr - pos[:, 2], pos[:, 2] - (lozr + s)), zero
                        )
                        dmin = torch.sqrt(dxx * dxx + dyy * dyy + dzz * dzz)
                        ok_op = ok_op & (~op | (dmin > rcert_row))
            rows_ok = rows_ok & torch.all(~sel | ok_op)

    return (yield from _mlevel_tail(
        pos, vel, m, K, h_hint, mlargs, levels, mesh_level, c_buckets, species,
        res_rows, binfo, a_planes, s_l, Hrow, RHOrow, rows_ok, half,
        eos=eos, gamma=gamma, cs0=cs0, alpha=alpha, beta=beta, kh=kh,
        mesh_factor=mesh_factor, sigma_cells=sigma_cells, c_hw=c_hw,
        n_shards=n_shards, shard_ids=shard_ids, joint_gravity=joint_gravity,
    ))


def _mlevel_tail(
    pos, vel, m, K, h_hint, mlargs, levels, mesh_level, c_buckets, species,
    res_rows, binfo, a_planes, s_l, Hrow, RHOrow, rows_ok, half, *, eos, gamma,
    cs0, alpha, beta, kh, mesh_factor, sigma_cells, c_hw, n_shards, shard_ids,
    joint_gravity=False,
):
    """Phases B/C + residual lane + merge (continuation of
    mlevel_forces_body, split as in the reference; a generator body)."""
    L = len(levels)
    n = pos.shape[0]
    dtype = pos.dtype
    dev = pos.device
    big = torch.finfo(dtype).max

    # ---- residual lane, part 1: exact r_k + rho (streaming bisection) ----
    if res_rows is not None:
        with stage("residual_knn"):
            rk2_res, nfound_res, h_res, rho_res = _res_knn(pos, res_rows, h_hint[res_rows], m, kh)
            rows_ok = rows_ok & torch.all(nfound_res >= kh)
            Hrow = Hrow.index_put((res_rows,), h_res)
            RHOrow = RHOrow.index_put((res_rows,), rho_res)

    # every row's h and rho came from exactly one shard (its strip's, or
    # its residual slice's); elsewhere the partial is 0
    Hrow, RHOrow = yield request("psum", (Hrow, RHOrow))

    # ---- derived per-row fields (merged across levels + residual) ----
    rho_safe = torch.where(RHOrow > 0, RHOrow, torch.ones((), dtype=dtype, device=dev))
    if eos == "polytropic":
        por2_row = K.to(dtype) * rho_safe ** (gamma - 2.0)
        cs_row = torch.sqrt(gamma * K.to(dtype) * rho_safe ** (gamma - 1.0))
    else:
        por2_row = cs0**2 / rho_safe
        cs_row = torch.zeros((n,), dtype=dtype, device=dev) + cs0

    # ---- phase B per level ----
    acc = torch.zeros((3, n), dtype=dtype, device=dev)
    visc_row = torch.zeros((n,), dtype=dtype, device=dev)
    div_row = torch.zeros((n,), dtype=dtype, device=dev)
    mu_row = torch.zeros((n,), dtype=dtype, device=dev)
    gg = torch.zeros((4, n), dtype=dtype, device=dev)
    # joint mode: a close pair's two gravity corrections in phase B alone
    joint = joint_gravity and mesh_level == 0 and dtype == torch.float32
    sigma_j = (s_l[0] / mesh_factor) * sigma_cells if joint else None

    with stage("phase_b"):
        for l, (g, cap, buckets) in enumerate(levels):
            gp = g + 2
            PA = a_planes[l]
            vals = torch.stack([
                vel[:, 0], vel[:, 1], vel[:, 2], Hrow, (2.0 * Hrow) ** 2, RHOrow, por2_row,
                cs_row,
            ])
            PB = _level_planes(vals, [0.0] * 8, binfo[l]["slot"], gp**3 * cap)
            # X, Y, Z, VX, VY, VZ, MASK, SPECP, H, RK2, RHO, POR2, CS
            planes = torch.cat([PA[0:3], PB[0:3], PA[3:4], PA[5:6], PB[3:8]])
            del PB
            grids = torch.zeros((10, g * g + 1, g, cap), dtype=dtype, device=dev)
            lf = float(l)

            def body(q, c, lf=lf):
                return _pairs_b(q, c, lf, m, eos, alpha, beta, big, sigma_j)

            for bi, (cap_b, _, _) in enumerate(buckets):
                _sweep_strips(planes, shard_ids(mlargs.act_b[l][bi]), g, gp, cap, cap_b, 3, 6,
                              10, body, grids)
            del planes
            c = binfo[l]["c"]
            strip = c[:, 2] * g + c[:, 0]
            ix = torch.clamp_max(binfo[l]["rank"], cap - 1)
            guard = ~binfo[l]["dropped"]
            sel = (species == l) & guard
            row = grids[:, strip, c[:, 1], ix]  # (10, n)
            del grids
            zero = torch.zeros((), dtype=dtype, device=dev)
            ext = torch.where(guard, row, zero)
            acc = acc + ext[0:3]
            div_row = torch.where(sel, row[3], div_row)
            mu_row = torch.where(sel, row[4], mu_row)
            visc_row = visc_row + ext[5]
            gg = gg + ext[6:10]

    # ---- phase C: P3M (Newtonian - mesh shape) tail on level 0 ----
    if mesh_level == 0:
        with stage("phase_c"):
            g0, cap0 = levels[0][0], levels[0][1]
            sigma = (s_l[0] / mesh_factor) * sigma_cells
            c0 = binfo[0]["c"]
            ix0 = torch.clamp_max(binfo[0]["rank"], cap0 - 1)
            c_depth = 2 * c_hw + 1
            if c_hw == 1:
                # tail reach fits the hydro stencil: reuse the level-0
                # phase-A planes (pad 1; they hold ALL binned particles)
                gpc = g0 + 2
                planes_c = a_planes[0][0:4]
                slot_c = binfo[0]["slot"]
            else:
                gpc = g0 + 2 * c_hw
                slot_c = ((c0[:, 2] + c_hw) * gpc + c0[:, 1] + c_hw) * gpc * cap0 + (
                    c0[:, 0] + c_hw
                ) * cap0 + ix0
                vals = torch.stack(
                    [pos[:, 0], pos[:, 1], pos[:, 2], torch.ones((n,), dtype=dtype, device=dev)]
                )
                planes_c = _level_planes(vals, [0.0] * 4, slot_c, gpc**3 * cap0)
            n_lv = 0
            if joint:
                # h, species and each level's cell of every row, for the
                # pairs phase B took (NaN: the level dropped the row)
                n_lv = L
                nan = torch.full((), float("nan"), dtype=dtype, device=dev)
                extra = [Hrow, species.to(dtype)] + [
                    torch.where(binfo[lv]["dropped"], nan, binfo[lv]["c"][:, a].to(dtype))
                    for lv in range(L) for a in range(3)
                ]
                planes_c = torch.cat([
                    planes_c,
                    _level_planes(torch.stack(extra), [0.0] * len(extra), slot_c, gpc**3 * cap0),
                ])
            cgrids = torch.zeros((4, g0 * g0 + 1, g0, cap0), dtype=dtype, device=dev)

            def body_c(q, c):
                return _pairs_c(q, c, m, sigma, n_lv)

            for (cap_b, _), c_ids in zip(c_buckets, mlargs.act_c):
                _sweep_strips(planes_c, shard_ids(c_ids), g0, gpc, cap0, cap_b, c_depth, 3, 4,
                              body_c, cgrids)
            del planes_c
            gg = gg + cgrids[:, c0[:, 2] * g0 + c0[:, 0], c0[:, 1], ix0]
            del cgrids

    # ---- residual lane, part 2: forces + scatter-back ----
    if n_shards > 1:
        # sharded REPLACE: every shard zeroes its plane partials at all
        # residual rows, the owning shard then ADDS its complete rows, and
        # the psum below gives each exactly once
        res_all = species == L
        zero = torch.zeros((), dtype=dtype, device=dev)
        acc = torch.where(res_all, zero, acc)
        visc_row = torch.where(res_all, zero, visc_row)
    if res_rows is not None and n_shards > 1:
        with stage("residual_forces"):
            rowB, recvC = _res_forces(
                pos, vel, m, res_rows, rk2_res, h_res, Hrow, RHOrow, por2_row, cs_row,
                species, L, eos=eos, alpha=alpha, beta=beta,
            )
            acc[:, res_rows] += rowB[0:3]
            div_row = div_row.index_put((res_rows,), rowB[3], accumulate=True)
            mu_row = mu_row.index_put((res_rows,), rowB[4], accumulate=True)
            visc_row = visc_row.index_put((res_rows,), rowB[5], accumulate=True)
            gg[:, res_rows] += rowB[6:10]
            acc = acc + recvC[0:3]
            visc_row = visc_row + recvC[3]
            gg = gg + recvC[4:8]
    elif res_rows is not None:
        with stage("residual_forces"):
            rowB, recvC = _res_forces(
                pos, vel, m, res_rows, rk2_res, h_res, Hrow, RHOrow, por2_row, cs_row,
                species, L, eos=eos, alpha=alpha, beta=beta,
            )
            # residual rows: their hydro plane-sum partials are re-computed
            # completely by sweep B2 -> REPLACE; their per-level gravity
            # sums are structurally zero while phase C's geometric term does
            # include them -> ADD the lane's (softened - Newtonian) term
            acc[:, res_rows] = rowB[0:3]
            div_row = div_row.index_put((res_rows,), rowB[3])
            mu_row = mu_row.index_put((res_rows,), rowB[4])
            visc_row = visc_row.index_put((res_rows,), rowB[5])
            gg[:, res_rows] += rowB[6:10]
            # non-residual receivers: contributions from residual sources
            acc = acc + recvC[0:3]
            visc_row = visc_row + recvC[3]
            gg = gg + recvC[4:8]

    acc, div_row, mu_row, visc_row, gg = yield request(
        "psum", (acc, div_row, mu_row, visc_row, gg)
    )
    rows_ok = (yield request("psum", rows_ok.to(torch.int64))) == n_shards
    out = ReducedForces(
        acc=acc.T.contiguous(),
        rho=RHOrow,
        h=Hrow,
        cs=cs_row,
        mu_max=mu_row,
        div_sum=div_row,
        visc_dk=visc_row,
    )
    return out, (gg[0], gg[1], gg[2], gg[3]), rows_ok


# ---------------------------------------------------------------------------
# Streaming residual lane (bisection + masked sweeps over all N)
# ---------------------------------------------------------------------------


def _res_knn(pos, rows, h_hint_r, m, kh):
    """Exact r_Kh / h / rho of the residual rows `rows` (B,) by 14 four-way
    count bisection passes over all N candidates. A chunk's (rows, N)
    squared distances are computed once and kept through its passes.
    Returns (rk2, nfound, h, rho), each (B,)."""
    n = pos.shape[0]
    dtype = pos.dtype
    q = pos[rows]
    hi0 = torch.clamp_min((3.4 * h_hint_r.to(dtype)) ** 2, 1e-30)
    zero = torch.zeros((), dtype=dtype, device=pos.device)
    one = torch.ones((), dtype=dtype, device=pos.device)
    rb = max(1, PAIR_CHUNK // max(n, 1))
    outs = []
    for r0 in range(0, q.shape[0], rb):
        qb = q[r0 : r0 + rb]
        dx = qb[:, 0:1] - pos[None, :, 0]
        dy = qb[:, 1:2] - pos[None, :, 1]
        dz = qb[:, 2:3] - pos[None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz
        del dx, dy, dz
        lo = torch.zeros((qb.shape[0], 1), dtype=dtype, device=pos.device)
        hi = hi0[r0 : r0 + rb, None]
        for _ in range(14):
            span = hi - lo
            t1 = lo + 0.25 * span
            t2 = lo + 0.5 * span
            t3 = lo + 0.75 * span
            f1 = torch.sum(d2 <= t1, dim=1, keepdim=True) >= kh
            f2 = torch.sum(d2 <= t2, dim=1, keepdim=True) >= kh
            f3 = torch.sum(d2 <= t3, dim=1, keepdim=True) >= kh
            lo, hi = (
                torch.where(f1, lo, torch.where(f2, t1, torch.where(f3, t2, t3))),
                torch.where(f1, t1, torch.where(f2, t2, torch.where(f3, t3, hi))),
            )
        rk2 = torch.max(torch.where(d2 <= hi, d2, zero), dim=1, keepdim=True).values
        h = torch.sqrt(rk2) / 2.0
        h_safe = torch.where(h > 0, h, one)
        inn = d2 <= rk2
        w = W(torch.sqrt(d2) / h_safe, h_safe)
        rho = m * torch.sum(torch.where(inn, w, zero), dim=1)
        outs.append(torch.stack([rk2[:, 0], torch.sum(inn, dim=1).to(dtype), h[:, 0], rho]))
    rk2, nf, h, rho = torch.cat(outs, dim=1)
    return rk2, nf, h, rho


def _res_forces(
    pos, vel, m, rows, rk2_res, h_res, h_all, rho_all, por2_all, cs_all, species, L,
    *, eos, alpha, beta,
):
    """Residual forces. Returns (rowB, recvC):

    rowB (10, B): the COMPLETE outputs of the residual rows (ax, ay, az,
    div, mu_max, visc, gx, gy, gz, gphi) — forward over their own exact kNN
    ball, reverse receive from every other ball, and the full (softened -
    Newtonian) near-gravity correction against all N.
    recvC (8, N): contributions of residual SOURCES to the non-residual
    receivers (ax, ay, az, visc, gx, gy, gz, gphi).

    Each (row chunk, N) block tests its pairs against the reference's masks
    and evaluates the terms only on the pairs inside one of them (a pair
    outside all adds exact zeros); sums are index_add_ over those pairs."""
    n = pos.shape[0]
    dtype = pos.dtype
    dev = pos.device
    big = torch.finfo(dtype).max
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)

    def dist2(a, b):
        """(rows, cols) squared distances, summed as pair_terms sums them."""
        dx = a[:, None, 0] - b[None, :, 0]
        dy = a[:, None, 1] - b[None, :, 1]
        dz = a[:, None, 2] - b[None, :, 2]
        return dx * dx + dy * dy + dz * dz

    def pair_terms(xi, vi, hi, rhoi, xj, vj, hj, rhoj):
        """Pair geometry and the shared SPH / gravity factors of pairs
        (i, j) (i the receiver, j the partner; fields already gathered)."""
        dx = xi[:, 0] - xj[:, 0]
        dy = xi[:, 1] - xj[:, 1]
        dz = xi[:, 2] - xj[:, 2]
        d2 = dx * dx + dy * dy + dz * dz
        r = torch.sqrt(d2)
        h_avg = 0.5 * (hi + hj)
        rho_avg = 0.5 * (rhoi + rhoj)
        v_dot_r = (vi[:, 0] - vj[:, 0]) * dx + (vi[:, 1] - vj[:, 1]) * dy + (vi[:, 2] - vj[:, 2]) * dz
        mu = torch.clamp_max(h_avg * v_dot_r / (d2 + 0.01 * h_avg**2), 0.0)
        r_safe = torch.where(d2 > 0, r, one)
        newt_g = torch.where(d2 > 0, 1.0 / r_safe**3, zero)
        newt_p = torch.where(d2 > 0, -1.0 / r_safe, zero)
        gm = r <= 2.0 * h_avg
        cgp = torch.where(gm, softened_gphi_over_r(r, h_avg) - newt_g, zero)
        cpp = torch.where(gm, softened_phi(r, h_avg) - newt_p, zero)
        return dx, dy, dz, d2, r, rho_avg, v_dot_r, mu, cgp, cpp

    # ---- part B2: complete rows for residual queries ----
    q = pos[rows]
    qv = vel[rows]
    h_q = torch.where(h_res > 0, h_res, one)
    rho_q = torch.where(rho_all[rows] > 0, rho_all[rows], one)
    por2_q = por2_all[rows]
    cs_q = cs_all[rows]
    B = rows.shape[0]
    rowB = torch.zeros((10, B), dtype=dtype, device=dev)
    rowB[4] = -big
    rb = max(1, PAIR_CHUNK // max(n, 1))
    for r0 in range(0, B, rb):
        sl = slice(r0, r0 + rb)
        d2 = dist2(q[sl], pos)
        keep = (
            (d2 <= rk2_res[sl, None])
            | (d2 <= (2.0 * h_all[None, :]) ** 2)
            | (torch.sqrt(d2) <= 2.0 * (0.5 * (h_q[sl, None] + h_all[None, :])))
        )
        i, j = torch.nonzero(keep, as_tuple=True)
        del d2, keep
        i_row = i + r0
        dx, dy, dz, d2, r, rho_avg, v_dot_r, mu, cgp, cpp = pair_terms(
            q[i_row], qv[i_row], h_q[i_row], rho_q[i_row], pos[j], vel[j], h_all[j], rho_all[j],
        )
        hq, hc = h_q[i_row], h_all[j]
        fwd = d2 <= rk2_res[i_row]
        rev = d2 <= (2.0 * hc) ** 2
        pi_fwd = (-alpha * cs_q[i_row] * mu + beta * mu * mu) / rho_avg
        pi_rev = (-alpha * cs_all[j] * mu + beta * mu * mu) / rho_avg
        dwdr_q = grad_W_over_r(r / hq, r, hq)
        dwdr_c = grad_W_over_r(r / hc, r, hc)
        if eos == "polytropic":
            psum = por2_q[i_row] + por2_all[j]
            ct_fwd = m * (psum + pi_fwd) / 2.0
            ct_rev = m * (psum + pi_rev) / 2.0
        else:
            ct_fwd = m * (por2_q[i_row] + pi_fwd / 2.0)
            ct_rev = m * (por2_all[j] + pi_rev / 2.0)
        coeff = -torch.where(fwd, ct_fwd * dwdr_q, zero) - torch.where(rev, ct_rev * dwdr_c, zero)
        v_dot_dw_q = v_dot_r * dwdr_q
        v_dot_dw_c = v_dot_r * dwdr_c
        terms = torch.stack([
            coeff * dx, coeff * dy, coeff * dz,
            m * torch.where(fwd, v_dot_dw_q, zero),
            torch.where(fwd, m * pi_fwd * v_dot_dw_q / 2.0, zero)
            + torch.where(rev, m * pi_rev * v_dot_dw_c / 2.0, zero),
            m * cgp * dx, m * cgp * dy, m * cgp * dz, m * cpp,
        ])
        rowB[[0, 1, 2, 3, 5, 6, 7, 8, 9]] = rowB[[0, 1, 2, 3, 5, 6, 7, 8, 9]].index_add(
            1, i_row, terms
        )
        rowB[4] = rowB[4].scatter_reduce(0, i_row, torch.where(fwd, mu, -big), "amax")

    # ---- part C: residual sources -> non-residual receivers ----
    recvC = torch.zeros((8, n), dtype=dtype, device=dev)
    nonres = species < L
    rr = max(1, PAIR_CHUNK // max(B, 1))
    for r0 in range(0, n, rr):
        sl = slice(r0, r0 + rr)
        d2 = dist2(pos[sl], q)
        keep = nonres[sl, None] & (
            (d2 <= rk2_res[None, :])
            | (torch.sqrt(d2) <= 2.0 * (0.5 * (h_all[sl, None] + h_q[None, :])))
        )
        i, j = torch.nonzero(keep, as_tuple=True)
        del d2, keep
        i_all = i + r0
        dx, dy, dz, d2, r, rho_avg, v_dot_r, mu, cgp, cpp = pair_terms(
            pos[i_all], vel[i_all], h_all[i_all], rho_all[i_all], q[j], qv[j], h_q[j], rho_q[j],
        )
        rev = d2 <= rk2_res[j]
        pi_rev = (-alpha * cs_q[j] * mu + beta * mu * mu) / rho_avg
        dwdr_c = grad_W_over_r(r / h_q[j], r, h_q[j])
        if eos == "polytropic":
            ct_rev = m * (por2_all[i_all] + por2_q[j] + pi_rev) / 2.0
        else:
            ct_rev = m * (por2_q[j] + pi_rev / 2.0)
        coeff = -torch.where(rev, ct_rev * dwdr_c, zero)
        terms = torch.stack([
            coeff * dx, coeff * dy, coeff * dz,
            torch.where(rev, m * pi_rev * v_dot_r * dwdr_c / 2.0, zero),
            m * cgp * dx, m * cgp * dy, m * cgp * dz, m * cpp,
        ])
        recvC.index_add_(1, i_all, terms)
    return rowB, recvC
