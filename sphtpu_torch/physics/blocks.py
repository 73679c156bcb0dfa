"""Block-compact SPH engine: packed queries, per-row reach windows.

Port of sphtpu/physics/blocks.py, single device. The reference's module
docstring describes the engine; in short:

*   Rows are packed densely in two orders: the QUERY order (Morton order
    of a fine grid, so each consecutive BQ = 128-row block is a tight
    spatial patch) and the CANDIDATE order (sorted by h octave, then by
    that octave's cell, so any axis-aligned cell box of one octave is a
    short list of contiguous index runs).
*   Every row gets its OWN reach window: a per-octave cell box covering
    max(own kNN ball * margin, the P3M tail radius). A block's candidate
    list is the union of its rows' boxes, padded to a menu capacity C_b;
    blocks of one capacity form a bucket.
*   One pair sweep per phase: phase A (exact k-th distance + density by
    count bisection, kernel K1 at the block shape (nb, BQ) x (nb, C_b)),
    phase B (SPH pair forces + the softened / mesh-tail gravity
    corrections, computed in the BALL OWNER's sweep: the owner emits both
    endpoints' contributions, its own by tile reduction, the partner's by
    one scatter-add through the candidate index tables). Phase B is kernel
    K5 (every bucket in one launch, `kernels/cuda_grouped_pairs.py`) or,
    with grouped=False, kernel K6 per bucket
    (`kernels/cuda_block_pairs.py`).

Exactness is certified per evaluation: host boxes carry drift margins
proportional to each row's own r_k, and the engine re-checks per row x
octave that the found r_k and the tail radius fit inside the planned
coverage minus the octave's measured drift. A False certificate makes the
caller fall back to the gather engine: stale plans cost speed, never
correctness.

The host planner (`plan_blocks`, `block_args_for_spec`) is the
reference's numpy code. The reference reads some of its constants from
SPHTPU_BLOCKS_* environment variables (TPU profiling knobs); here they
are plain constants at the reference's defaults.
"""

from __future__ import annotations

import functools
import math
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.cuda_block_pairs import phase_b_blocks
from ..kernels.cuda_grouped_pairs import CW, phase_b_grouped, unit_table
from ..kernels.cuda_strip_knn import phase_a_cells
from .mesh_gravity import _domain_half
from ..shard.collectives import request
from .tiles import ReducedForces

# query rows per block: one (BQ, C_b) pair tile per block (the reference
# measured 128 best on the deep-collapse fixture)
BQ = 128
# octave grid sizing: cell edge ~ OCT_CF * the octave's max ball, grids
# clipped to OCT_GMAX
OCT_CF = 0.33
OCT_GMAX = 128
# candidate-capacity menu (block lists pad to the smallest fitting
# entry). Every entry is a multiple of the grouped phase-B chunk width
# (kernels/cuda_grouped_pairs.CW = 512), so a block's candidate list is a
# whole number of consecutive chunks.
C_MENU = (512, 1024, 1536, 2048, 3072, 4096, 6144, 8192, 12288,
          16384, 24576, 32768)
assert all(c % CW == 0 for c in C_MENU)
# own-ball margin on the r_k hint: covers h growth between refreshes
# + both partners' CFL drift (0.15 r_k per step each). Boxes are built for
# one ML_SUBCHUNK (2 steps).
R_OWN_MARGIN = 1.45
# refit margin ladder (block_args_for_spec): full margin first, then mild
# degradation; the per-evaluation certificate still guards correctness
REFIT_MARGINS = (R_OWN_MARGIN, 1.38, 1.30)
# drift margin on the P3M tail radius r_c (ROADMAP D19; the reference
# covers r_c with none, F6). The phase-B certificate asks for
# max(2 h, r_c_now) <= coverage - drift at every evaluation of a plan, and
# a plan serves one ML_SUBCHUNK (2 steps): its last evaluation (the second
# half-step) lies 1.5 steps after the plan. Over those 1.5 steps:
# * the query and its partner each drift at most 0.15 r_k a step (the CFL
#   bound R_OWN_MARGIN uses); a row whose box is sized by r_c has
#   r_k < r_c / R_OWN_MARGIN, so each drifts < 0.225 r_c / 1.45 = 0.155 r_c,
#   both 0.31 r_c;
# * r_c grows with the domain (r_c ~ _domain_half), whose half-edge grows
#   by at most the outermost row's drift, 0.225 of its r_k; r_k <= half / 4
#   on the committed collapse states (0.24 and 0.26 at most), so r_c grows
#   by < 6 %.
# 1 + 0.31 + 0.06 = 1.37. The certificate subtracts the largest drift of
# the candidate's whole octave (dmax_o), not the partner's, so round up:
# 1.5. It scales the r_c term alone; the REFIT_MARGINS ladder degrades
# only the own-ball term.
R_TAIL_MARGIN = 1.5
# block-list granularity
BLK_GRAN = 8

# h-hint bisection seed factor: the previous evaluation's h bounds the
# k-th distance within a few %/step, so the bisection interval starts at
# (HINT_F * 2 h_hint)^2 instead of the coverage reach. If the true r_k
# outgrew it, nfound < kh and the row fails the certificate (gather
# fallback) — never a silently wrong ball.
HINT_F = 1.5
# binary bisection passes of phase A at float32: interval / ulp(r_k^2)
# <= HINT_F^4 * 2^23 ~ 2^25.4, so 28 passes with margin (the reference's)
N_BISECT_HINT = 28
# ... and at float64: 68 passes, the 68 interval bits of the reference's
# float64 XLA phase A (34 four-way passes), so h agrees with it (ROADMAP D8)
N_BISECT_F64 = 68


class BlockArgs(NamedTuple):
    """Per-chunk arguments (shapes fixed by the spec; contents refresh every
    sub-chunk). The planner returns them as numpy arrays;
    `block_args_to_device` puts them on a device."""

    order_q: object  # (Nq_pad,) int32 row id per packed query slot (N = pad)
    order_c: object  # (N,) int32 row id per packed candidate slot
    pos_ref: object  # (N, 3) plan-time positions (row order)
    half_ref: object  # () plan-time domain half-edge
    boxes: tuple  # per bucket: (n_blocks_b, n_oct, 6) int32 octave cell boxes
    starts: tuple  # per octave: (g_o, g_o, g_o + 1) int32 absolute prefix


# BlockSpec (hashable compile key, carried in EngineConfig.blocks):
#   ( buckets,     # ((C_b, n_blocks_b), ...) ascending C
#     oct_grids,   # (g_o, ...) per octave, fine -> coarse
#     runs_xy,     # per bucket: per octave: (NX, NY) static max box extents
#     g_mesh,      # P3M mesh anchor grid (mesh cells = mesh_factor * g_mesh)
#   )


# ---------------------------------------------------------------------------
# Host planner
# ---------------------------------------------------------------------------


def _snap_up(menu, v):
    for c in menu:
        if c >= v:
            return c
    return None


def _ceil_to(x, k):
    return ((x + k - 1) // k) * k


# grid-size menu for compile-key stability: octave grids and the fine
# grid snap to these, so slow drift in max/typical r_k does not produce
# a new spec (and a fresh multi-minute compile) every chunk
GRID_MENU = (2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32, 40, 48, 64, 80,
             96, 112, 128)


def _snap_grid(g):
    for m in GRID_MENU:
        if m >= g:
            return m
    return GRID_MENU[-1]


def _geometry(pos, h, oct_grids, gf, *, gravity, mesh_factor, sigma_cells,
              margin=R_OWN_MARGIN, tail_margin=1.0):
    """State-dependent planning geometry for FIXED grids: candidate
    packing (order_c + per-octave prefix tables), per-row octave boxes,
    and an O(1) box-count oracle. Shared by plan_blocks (fresh spec) and
    block_args_for_spec (refresh into a compiled spec). `margin` scales
    the own-ball coverage term (refits degrade it stepwise to keep a
    drifted state inside the compiled bucket shapes — see
    block_args_for_spec); `tail_margin` scales the P3M tail radius term
    (1.0, the reference's, covers r_c with no drift margin; the run loop
    passes R_TAIL_MARGIN)."""
    n = pos.shape[0]
    rk = 2.0 * h
    half = float(np.abs(pos).max()) * (1 + 1e-6) + 1e-30
    n_oct = len(oct_grids)
    rk_min = float(rk.min())
    edges = rk_min * (2.0 ** np.arange(1, n_oct))
    oct_id = np.searchsorted(edges, rk, side="right").astype(np.int32)

    if gravity == "p3m":
        r_c = 4.4 * sigma_cells * (2.0 * half / (mesh_factor * gf)) * tail_margin
    else:
        r_c = 0.0

    # per-row coverage radius: own kNN ball (with drift/growth margin)
    # union the P3M tail radius. NO rev-reach term: reverse-ball pair
    # terms are computed inside the ball OWNER's sweep and scattered to
    # the partner (the rev term equals the owner's fwd term — owner's
    # kernel, owner's-cs viscosity — so the owner emits both endpoints'
    # contributions). Covering each octave's max r_k here instead was
    # measured to inflate the candidate tables 10-50x past the true
    # ~230-720 rows a query needs on the deep-collapse fixture.
    R_req = np.maximum(rk * margin, r_c)  # (n,)

    # candidate packing: (octave, octave-cell) sort; per-octave prefix
    counts_o, starts_np = [], []
    order_c = np.empty(n, np.int64)
    base = 0
    for o, g_o in enumerate(oct_grids):
        rows_o = np.flatnonzero(oct_id == o)
        s_o = 2.0 * half / g_o
        c = np.clip(((pos[rows_o] + half) / s_o).astype(np.int64), 0, g_o - 1)
        cid = (c[:, 0] * g_o + c[:, 1]) * g_o + c[:, 2]  # x-major: z fastest
        srt = np.argsort(cid, kind="stable")
        order_c[base : base + rows_o.size] = rows_o[srt]
        cnt = np.bincount(cid, minlength=g_o**3)
        st = np.zeros(g_o**3 + 1, np.int64)
        st[1:] = np.cumsum(cnt)
        st += base
        # reshape to (x, y, z+1): starts[x, y, z0]..starts[x, y, z1+1]
        starts_np.append(
            np.concatenate(
                [st[:-1].reshape(g_o, g_o, g_o), st[1:].reshape(g_o, g_o, g_o)[:, :, -1:]],
                axis=2,
            ).astype(np.int32)
        )
        counts_o.append(cnt.reshape(g_o, g_o, g_o))
        base += rows_o.size

    # summed-area tables per octave for O(1) box counts (int32: values
    # are bounded by n; halves the cumsum+indexing traffic, measured the
    # hottest part of a refresh)
    prefixes = []
    for o, g_o in enumerate(oct_grids):
        P = np.zeros((g_o + 1, g_o + 1, g_o + 1), np.int32)
        core = P[1:, 1:, 1:]
        np.cumsum(counts_o[o], axis=0, dtype=np.int32, out=core)
        np.cumsum(core, axis=1, out=core)
        np.cumsum(core, axis=2, out=core)
        prefixes.append(P)

    def boxcount(o, lo, hi):
        P = prefixes[o]
        x0, y0, z0 = lo[:, 0], lo[:, 1], lo[:, 2]
        x1, y1, z1 = hi[:, 0] + 1, hi[:, 1] + 1, hi[:, 2] + 1
        return (
            P[x1, y1, z1] - P[x0, y1, z1] - P[x1, y0, z1] - P[x1, y1, z0]
            + P[x0, y0, z1] + P[x0, y1, z0] + P[x1, y0, z0] - P[x0, y0, z0]
        )

    # per-row octave boxes + C requirement (one box family: phases A and
    # B share the same candidate tables)
    row_lo, row_hi = [], []
    creq = np.zeros(n, np.int64)
    for o, g_o in enumerate(oct_grids):
        s_o = 2.0 * half / g_o
        lo = np.clip(((pos - R_req[:, None] + half) / s_o).astype(np.int64), 0, g_o - 1)
        hi = np.clip(((pos + R_req[:, None] + half) / s_o).astype(np.int64), 0, g_o - 1)
        row_lo.append(lo)
        row_hi.append(hi)
        creq += boxcount(o, lo, hi)

    if int(creq.max()) > C_MENU[-1]:
        return None

    # spatial-first query order: Morton code of the fine cell, so every
    # consecutive BQ-row block is a tight spatial patch and its union
    # bounding box stays close to the rows' own boxes (a class-first sort
    # was measured to scatter same-class rows across the domain — shell
    # blocks' bounding boxes swallowed the core)
    s_f = 2.0 * half / gf
    cf = np.clip(((pos + half) / s_f).astype(np.int64), 0, gf - 1)
    order_q = np.argsort(_morton3(cf), kind="stable")

    # blocks: consecutive BQ rows of order_q; a block whose union box
    # count blows the capacity menu (Morton jumps occasionally group
    # distant patches) is recursively split and its pieces padded.
    # The common case (every full block fits) is fully vectorized — this
    # runs on every sub-chunk refresh, so python-per-block was a real
    # tax (~0.35 s/refresh at N=1e5)
    nb_full = (n + BQ - 1) // BQ
    oq2d = np.concatenate(
        [order_q, np.repeat(order_q[-1:], nb_full * BQ - n)]
    ).reshape(nb_full, BQ)  # union-neutral padding (duplicate last row)
    lo_all = [row_lo[o][oq2d].min(axis=1) for o in range(n_oct)]
    hi_all = [row_hi[o][oq2d].max(axis=1) for o in range(n_oct)]
    cnt_all = sum(
        boxcount(o, lo_all[o], hi_all[o]) for o in range(n_oct)
    )

    def union_count(rows):
        lo = [row_lo[o][rows].min(0) for o in range(n_oct)]
        hi = [row_hi[o][rows].max(0) for o in range(n_oct)]
        cnt = sum(
            int(boxcount(o, lo[o][None], hi[o][None])[0])
            for o in range(n_oct)
        )
        return cnt, lo, hi

    groups = []  # (rows, cnt, lo, hi)

    def emit(rows):
        cnt, lo, hi = union_count(rows)
        if cnt <= C_MENU[-1] or rows.size <= 1:
            if cnt > C_MENU[-1]:
                raise _PlanInfeasible()
            groups.append((rows, cnt, lo, hi))
        else:
            mid = rows.size // 2
            emit(rows[:mid])
            emit(rows[mid:])

    over = np.flatnonzero(cnt_all > C_MENU[-1])
    try:
        for b in over:
            emit(order_q[b * BQ : min((b + 1) * BQ, n)])
    except _PlanInfeasible:
        return None

    n_ok = nb_full - over.size
    n_blocks = n_ok + len(groups)
    oq = np.full(n_blocks * BQ, n, np.int64)
    blk_lo = [np.empty((n_blocks, 3), np.int64) for _ in oct_grids]
    blk_hi = [np.empty((n_blocks, 3), np.int64) for _ in oct_grids]
    blk_cnt = np.zeros(n_blocks, np.int64)
    blk_ext = np.zeros((n_blocks, n_oct, 2), np.int64)
    keep = np.setdiff1d(np.arange(nb_full), over, assume_unique=True)
    oq_keep = oq2d[keep]
    # sentinel out the duplicate-padding of the (kept) last block
    if keep.size and keep[-1] == nb_full - 1 and n % BQ:
        oq_keep[-1, n % BQ :] = n
    oq[: n_ok * BQ] = oq_keep.reshape(-1)
    blk_cnt[:n_ok] = cnt_all[keep]
    for o in range(n_oct):
        blk_lo[o][:n_ok] = lo_all[o][keep]
        blk_hi[o][:n_ok] = hi_all[o][keep]
        blk_ext[:n_ok, o, 0] = hi_all[o][keep, 0] - lo_all[o][keep, 0] + 1
        blk_ext[:n_ok, o, 1] = hi_all[o][keep, 1] - lo_all[o][keep, 1] + 1
    for k, (rows, cnt, lo, hi) in enumerate(groups):
        b = n_ok + k
        oq[b * BQ : b * BQ + rows.size] = rows
        blk_cnt[b] = cnt
        for o in range(n_oct):
            blk_lo[o][b] = lo[o]
            blk_hi[o][b] = hi[o]
            blk_ext[b, o] = (hi[o][0] - lo[o][0] + 1, hi[o][1] - lo[o][1] + 1)
    return {
        "n": n, "half": half, "order_c": order_c, "starts": starts_np,
        "oq": oq, "n_blocks": n_blocks, "blk_lo": blk_lo, "blk_hi": blk_hi,
        "blk_cnt": blk_cnt, "blk_ext": blk_ext, "pos": pos,
    }


def _pack_bucket_boxes(pad_ids, blk_lo, blk_hi, n_oct):
    """Box array for one bucket's (possibly sentinel-padded) block list."""
    bx = np.zeros((pad_ids.size, n_oct, 6), np.int32)
    for k, b in enumerate(pad_ids):
        for o in range(n_oct):
            if b < 0:
                # sentinel block: empty box (hi < lo -> zero runs)
                bx[k, o] = (0, -1, 0, -1, 0, -1)
            else:
                bx[k, o] = (
                    blk_lo[o][b][0], blk_hi[o][b][0],
                    blk_lo[o][b][1], blk_hi[o][b][1],
                    blk_lo[o][b][2], blk_hi[o][b][2],
                )
    return bx


def _emit_args(spec, geo, assign):
    """BlockArgs for `spec` given the geometry and a per-bucket list of
    assigned block ids (each list sentinel-padded to the bucket's nb)."""
    n = geo["n"]
    n_oct = len(spec[1])
    boxes, oq_segs = [], []
    for pad_ids in assign:
        boxes.append(_pack_bucket_boxes(pad_ids, geo["blk_lo"], geo["blk_hi"], n_oct))
        for b in pad_ids:
            if b < 0:
                oq_segs.append(np.full(BQ, n, np.int64))
            else:
                oq_segs.append(geo["oq"][b * BQ : (b + 1) * BQ])
    return BlockArgs(
        order_q=np.concatenate(oq_segs).astype(np.int32),
        order_c=geo["order_c"].astype(np.int32),
        pos_ref=geo["pos"].astype(np.float64),
        half_ref=np.float64(geo["half"]),
        boxes=tuple(boxes),
        starts=tuple(geo["starts"]),
    )


def plan_blocks(
    pos,
    h,
    kh: int,
    *,
    gravity: str = "exact",
    mesh_factor: int = 5,
    sigma_cells: float = 2.2,
    fine_grid: int = 0,
    shards: int = 1,
    slots_max: float = 6e9,
    tail_margin: float = 1.0,
):
    """Build (spec, BlockArgs-as-numpy) for the current state, or None
    when some block's requirement exceeds the C menu / slots_max (caller
    keeps the strip engines). tail_margin: `_geometry`'s (1.0 is the
    reference's plan; the run loop passes R_TAIL_MARGIN, ROADMAP D19)."""
    pos = np.asarray(pos, np.float64)
    h = np.asarray(h, np.float64)
    rk = 2.0 * h
    half = float(np.abs(pos).max()) * (1 + 1e-6) + 1e-30

    # octaves over r_k (fine -> coarse), coarsest octaves merged so the
    # per-octave machinery stays bounded
    rk_min, rk_max = float(rk.min()), float(rk.max())
    n_oct = min(max(int(math.ceil(math.log2(rk_max / rk_min + 1e-12))) + 1, 1), 8)

    # per-octave grids: cell edge ~ OCT_CF x the octave's max ball so box
    # quantization dilation stays low; snapped to GRID_MENU for
    # compile-key stability
    edges = rk_min * (2.0 ** np.arange(1, n_oct))
    oct_id = np.searchsorted(edges, rk, side="right")
    oct_grids = []
    for o in range(n_oct):
        sel = oct_id == o
        scale = max(rk[sel].max() if sel.any() else 0.0, rk_min * 2.0**o)
        g_o = int(2.0 * half / (OCT_CF * scale)) if scale > 0 else 4
        oct_grids.append(_snap_grid(min(max(g_o, 2), OCT_GMAX)))
    oct_grids = tuple(oct_grids)

    gf = fine_grid if fine_grid else _snap_grid(_fine_grid_for(pos, h, half))

    geo = _geometry(
        pos, h, oct_grids, gf,
        gravity=gravity, mesh_factor=mesh_factor, sigma_cells=sigma_cells,
        tail_margin=tail_margin,
    )
    if geo is None:
        return None

    blk_cap = np.asarray([_snap_up(C_MENU, int(c)) for c in geo["blk_cnt"]])

    # bucket blocks by capacity; pad each bucket's block list
    gran = _lcm(BLK_GRAN, shards)
    caps_present = sorted(set(blk_cap.tolist()))
    buckets, runs_zy, assign = [], [], []
    total_slots = 0.0
    for cb in caps_present:
        ids = np.flatnonzero(blk_cap == cb)
        nb = max(_ceil_to(ids.size, gran), gran)
        # drift reserve: peak-rate h growth migrates blocks up-capacity
        # between refits, and placement failures concentrate in the
        # largest bucket (round-4 deep-peak refits died with the two top
        # buckets full and every mid bucket near-empty, deficit 1-2
        # slots). One spare granule of top-bucket slots lets
        # block_args_for_spec re-place the drifted state in the compiled
        # shapes instead of replanning; costs ~6% slot-work on the deep
        # fixture.
        if cb == caps_present[-1]:
            nb += gran
        pad_ids = np.concatenate([ids, np.full(nb - ids.size, -1, np.int64)])
        # static per-bucket max (x, y) box extents (z handled by runs),
        # padded one cell of drift headroom so a refreshed state's
        # slightly-wider boxes still fit the compiled shapes
        rz = []
        top = cb == caps_present[-1]
        for o in range(len(oct_grids)):
            # the top bucket is also the drift-reserve home for blocks
            # migrating up from ANY region, so its static extents cover
            # the global max (a refit-time migrator's box must fit the
            # compiled runs, not just its plan-time occupants')
            sel = slice(None) if top else ids
            nx = int(geo["blk_ext"][sel, o, 0].max()) if ids.size else 1
            ny = int(geo["blk_ext"][sel, o, 1].max()) if ids.size else 1
            g_o = oct_grids[o]
            rz.append((min(nx + 1, g_o), min(ny + 1, g_o)))
        buckets.append((int(cb), int(nb)))
        runs_zy.append(tuple(rz))
        assign.append(pad_ids)
        total_slots += nb * BQ * cb
    if total_slots > slots_max:
        return None

    spec = (tuple(buckets), oct_grids, tuple(runs_zy), int(gf))
    return spec, _emit_args(spec, geo, assign)


class _PlanInfeasible(Exception):
    pass


def _morton3(c):
    """Interleave 3x up-to-7-bit cell coords into a Morton key."""
    out = np.zeros(c.shape[0], np.int64)
    for bit in range(7):
        for ax in range(3):
            out |= ((c[:, ax] >> bit) & 1) << (3 * bit + ax)
    return out


def _fine_grid_for(pos, h, half):
    s = float(np.quantile(2.0 * np.asarray(h), 0.3))
    return int(min(max(int(2.0 * half / max(s, 1e-30)), 4), 64))


def _lcm(a, b):
    return a * b // math.gcd(a, b)


# why the last block_args_for_spec call returned None (diagnostics only).
# Thread-local so concurrent drivers (multi-chip / worker threads) cannot
# attribute a failure to the wrong refit; read via last_refit_fail().
_REFIT_TLS = threading.local()


def last_refit_fail():
    """Reason string for why this thread's last block_args_for_spec call
    returned None (None when it succeeded or was never called)."""
    return getattr(_REFIT_TLS, "reason", None)


def block_args_for_spec(pos, h, spec, *, gravity="exact", mesh_factor=5,
                        sigma_cells=2.2, tail_margin=1.0):
    """Refresh BlockArgs for an ALREADY-COMPILED spec from the current
    state, or None when the state no longer fits it (a block's
    requirement exceeds every bucket with a free slot, a box outgrows a
    bucket's static run extents, or the octave count changed). This is
    the compile hysteresis: grids and bucket shapes come from the spec;
    only the traced contents (packing, boxes, prefix tables) rebuild.
    tail_margin: `_geometry`'s, at every rung of the margin ladder."""
    _REFIT_TLS.reason = None
    pos = np.asarray(pos, np.float64)
    h = np.asarray(h, np.float64)
    buckets, oct_grids, runs_zy, gf = spec
    rk = 2.0 * h
    rk_min, rk_max = float(rk.min()), float(rk.max())
    n_oct_now = min(
        max(int(math.ceil(math.log2(rk_max / rk_min + 1e-12))) + 1, 1), 8
    )
    if n_oct_now != len(oct_grids):
        _REFIT_TLS.reason = f"octaves {len(oct_grids)} -> {n_oct_now}"
        return None
    # margin ladder: full drift margin first; when the drifted state's
    # boxes no longer fit the compiled bucket shapes (peak-rate h drift
    # widens them), retry with stepwise-smaller own-ball margins instead
    # of replanning — a degraded margin only narrows the drift headroom
    # the per-eval certificate checks (worst case: a cert-gated gather
    # fallback for one sub-chunk), while a replan costs a fresh
    # multi-minute XLA compile mid-collapse (VERDICT r3 weak-2).
    for margin in REFIT_MARGINS:
        geo = _geometry(
            pos, h, oct_grids, gf,
            gravity=gravity, mesh_factor=mesh_factor,
            sigma_cells=sigma_cells, margin=margin, tail_margin=tail_margin,
        )
        if geo is None:
            _REFIT_TLS.reason = (
                f"geometry infeasible (creq/block-split over menu) "
                f"at margin {margin}"
            )
            continue
        # first-fit each block into the cheapest bucket it fits
        # (capacity, static run extents, free slots)
        cnt = geo["blk_cnt"]
        ext = geo["blk_ext"]
        slots_left = [nb for _, nb in buckets]
        assign_lists = [[] for _ in buckets]
        placed_all = True
        for b in np.argsort(-cnt):  # big blocks first: fewest homes
            placed = False
            for k, (cb, nb) in enumerate(buckets):
                if slots_left[k] == 0 or cnt[b] > cb:
                    continue
                if any(
                    ext[b, o, 0] > runs_zy[k][o][0]
                    or ext[b, o, 1] > runs_zy[k][o][1]
                    for o in range(len(oct_grids))
                ):
                    continue
                assign_lists[k].append(int(b))
                slots_left[k] -= 1
                placed = True
                break
            if not placed:
                _REFIT_TLS.reason = (
                    f"block unplaceable at margin {margin}: "
                    f"cnt={int(cnt[b])} ext={ext[b].tolist()} "
                    f"slots_left={slots_left} buckets={buckets} "
                    f"runs={runs_zy}"
                )
                placed_all = False
                break
        if not placed_all:
            continue
        assign = []
        for (cb, nb), ids in zip(buckets, assign_lists):
            pad = np.full(nb - len(ids), -1, np.int64)
            assign.append(np.concatenate([np.asarray(ids, np.int64), pad]))
        _REFIT_TLS.reason = None
        return _emit_args(spec, geo, assign)
    return None


# ---------------------------------------------------------------------------
# Device engine
# ---------------------------------------------------------------------------


def block_args_to_device(bargs: BlockArgs, dtype, device) -> BlockArgs:
    """BlockArgs as tensors on `device`: index arrays int64, plan-time
    positions and half-edge in `dtype` (one rounding from float64, as the
    reference's `jnp.asarray(..., dtype)`)."""

    def idx(a):
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        return a.to(device=device, dtype=torch.int64)

    def real(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=dtype)
        return torch.as_tensor(np.asarray(a, np.float64)).to(device=device, dtype=dtype)

    return BlockArgs(
        order_q=idx(bargs.order_q),
        order_c=idx(bargs.order_c),
        pos_ref=real(bargs.pos_ref),
        half_ref=real(bargs.half_ref),
        boxes=tuple(idx(b) for b in bargs.boxes),
        starts=tuple(idx(s) for s in bargs.starts),
    )


def _cand_indices(boxes, starts_o_list, runs_zy_b, n_sentinel, C_b):
    """(nb, C_b) absolute packed-candidate indices for a bucket's blocks,
    built from their per-octave cell boxes (nb, n_oct, 6) by run expansion:
    the reference's `_cand_indices`, vectorised over the blocks."""
    nb = boxes.shape[0]
    device = boxes.device
    run_starts, run_lens = [], []
    for o, starts_o in enumerate(starts_o_list):
        x0, x1, y0, y1, z0, z1 = (boxes[:, o, i] for i in range(6))
        NX, NY = runs_zy_b[o]
        g_o = starts_o.shape[0]
        dx = torch.arange(NX, device=device)
        dy = torch.arange(NY, device=device)
        xr = x0[:, None] + dx  # (nb, NX)
        yr = y0[:, None] + dy  # (nb, NY)
        xs = torch.clamp(xr, 0, g_o - 1)[:, :, None]
        ys = torch.clamp(yr, 0, g_o - 1)[:, None, :]
        live = (xr <= x1[:, None])[:, :, None] & (yr <= y1[:, None])[:, None, :]
        z0c = torch.clamp(z0, 0, g_o - 1)[:, None, None]
        z1c = torch.clamp(z1 + 1, 0, g_o)[:, None, None]
        st = starts_o[xs, ys, z0c]  # (nb, NX, NY)
        en = starts_o[xs, ys, z1c]
        ln = torch.where(live & (z1 >= z0)[:, None, None], en - st, 0)
        run_starts.append(st.reshape(nb, -1))
        run_lens.append(ln.reshape(nb, -1))
    run_starts = torch.cat(run_starts, dim=1)
    run_lens = torch.cat(run_lens, dim=1)
    cum = torch.cumsum(run_lens, dim=1)
    slot = torch.arange(C_b, device=device)
    # run id per slot by scatter + cumulative max: each LIVE run writes its id
    # at its start offset (live starts are distinct); dead runs go to a sink
    # slot C_b that is cut off (the reference drops them out of range)
    off = cum - run_lens  # start offset of run i
    ids = torch.arange(run_lens.shape[1], device=device).expand(nb, -1)
    pos_s = torch.where(run_lens > 0, off, C_b).clamp(max=C_b)
    rid = torch.zeros((nb, C_b + 1), dtype=torch.int64, device=device)
    rid.scatter_reduce_(1, pos_s, ids, reduce="amax")
    rid = torch.cummax(rid[:, :C_b], dim=1).values
    idx = torch.gather(run_starts, 1, rid) + (slot - torch.gather(off, 1, rid))
    return torch.where(slot < cum[:, -1:], idx, n_sentinel)


class CandTables(NamedTuple):
    """Per-chunk index state for block_sph_forces.

    idx:    per-bucket (nb, C_b) candidate-ORDER indices (sentinel n)
    rows:   per-bucket (nb, C_b) particle-ROW ids (sentinel n): the
            candidate-side sums scatter straight into row order
    inv_oq: (n,) packed-query slot of each row (order_q is injective on
            real rows), turning every query-side unpack into a gather
    units:  the grouped phase B's work units (`unit_table` of the
            plan's chunk layout: (n_units, 3) and (NB + 1,) int32), on the
            device, so that its launches copy nothing from the host
    """

    idx: tuple
    rows: tuple
    inv_oq: torch.Tensor
    units: tuple


# run-expansion temporaries a batch of blocks may hold (elements)
_RUNS_PER_BATCH = 1 << 22


def shard_slices(buckets, shard: int = 0, n_shards: int = 1):
    """Per bucket, the (first block, blocks) of shard `shard`'s contiguous
    1/n_shards slice of its block list (the whole list unsharded): the
    reference's `_shard_slicer`. The planner pads every bucket to a
    multiple of lcm(BLK_GRAN, shards), so the slices are exact."""
    out = []
    for _, nb in buckets:
        if nb % n_shards:
            raise ValueError(
                f"bucket of {nb} blocks not divisible by {n_shards} shards; "
                "plan with plan_blocks(shards=...)"
            )
        k = nb // n_shards
        out.append((shard * k, k))
    return out


def build_cand_tables(bargs: BlockArgs, spec, n, *, shard: int = 0,
                      n_shards: int = 1) -> CandTables:
    """CandTables of shard `shard`'s slice of every bucket's block list (the
    whole lists unsharded). The tables depend only on the plan (boxes +
    prefix tables), not on the state, so the chunk runner builds them once
    a chunk and passes them to block_sph_forces as idx_tables. bargs must
    be on the device (`block_args_to_device`)."""
    buckets, oct_grids, runs_zy, _ = spec
    device = bargs.order_q.device
    oc_pad = torch.cat(
        [bargs.order_c, torch.full((1,), n, dtype=torch.int64, device=device)]
    )
    slices = shard_slices(buckets, shard, n_shards)
    tables, rows = [], []
    for (C_b, _), (s0, nb_s), bx, rz in zip(buckets, slices, bargs.boxes, runs_zy):
        n_runs = sum(nx * ny for nx, ny in rz)
        per = max(1, _RUNS_PER_BATCH // max(n_runs, C_b))
        idx = torch.cat([
            _cand_indices(bx[s0 + b0 : s0 + min(b0 + per, nb_s)], bargs.starts, rz, n, C_b)
            for b0 in range(0, nb_s, per)
        ]) if nb_s else torch.zeros((0, C_b), dtype=torch.int64, device=device)
        tables.append(idx)
        rows.append(oc_pad[idx])
    oq = bargs.order_q
    keep = oq < n
    inv_oq = torch.zeros((n,), dtype=torch.int64, device=device)
    inv_oq[oq[keep]] = torch.arange(oq.shape[0], device=device)[keep]
    sliced = tuple((C_b, nb_s) for (C_b, _), (_, nb_s) in zip(buckets, slices))
    qblk, first = _grouped_chunks(sliced)
    units = unit_table(qblk, first, sum(nb for _, nb in sliced))
    return CandTables(tuple(tables), tuple(rows), inv_oq,
                      tuple(torch.as_tensor(a).to(device) for a in units))


@functools.lru_cache(maxsize=16)
def _grouped_chunks(buckets):
    """Static (qblk, first) of the grouped phase B for a bucket list: the
    query block of every CW-slot chunk of the flat candidate table, and 1
    at each block's first chunk."""
    qblk, first = [], []
    blk = 0
    for C_b, nb in buckets:
        ck = C_b // CW
        for _ in range(nb):
            qblk.extend([blk] * ck)
            first.extend([1] + [0] * (ck - 1))
            blk += 1
    return tuple(qblk), tuple(first)


def block_sph_forces(pos, vel, m, K, h_hint, bargs: BlockArgs, **kw):
    """Block-compact force evaluation, one device. Same contract as
    tile_sph_forces: (ReducedForces, (gx, gy, gz, phi) near-gravity
    corrections, ok); ok is a 0-d bool tensor, False => the caller falls
    back (gather engine). No host synchronisation happens here. Keywords
    are `block_forces_body`'s (without shard / n_shards)."""
    from ..shard.collectives import run_local

    return run_local(block_forces_body(pos, vel, m, K, h_hint, bargs, **kw))


def block_forces_body(
    pos,
    vel,
    m,
    K,
    h_hint,
    bargs: BlockArgs,
    *,
    eos: str,
    gamma,
    cs0,
    alpha,
    beta,
    kh: int,
    spec: tuple,
    gravity: str = "exact",
    mesh_factor: int = 5,
    sigma_cells: float = 2.2,
    grouped: bool = True,
    idx_tables: CandTables = None,
    shard: int = 0,
    n_shards: int = 1,
):
    """The block engine's evaluation as a generator body
    (shard/collectives.py): under work-sharding the inputs are replicated,
    shard `shard` of `n_shards` sweeps its contiguous slice of every
    bucket's block list (`shard_slices`), and the per-row outputs are
    psum-combined (each real row is written by exactly one shard; the
    candidate-side sums by several, in shard order). With one shard every
    collective is the identity.

    Phase A is kernel K1 at the block shape; phase B is kernel K5 (every
    bucket in one launch), or K6 per bucket with grouped=False. On CPU
    tensors each runs its plain version. idx_tables: build_cand_tables'
    output for these bargs and this shard (the chunk runner builds it once
    a chunk); None rebuilds it here."""
    buckets, oct_grids, runs_zy, g_mesh = spec
    n = pos.shape[0]
    dtype = pos.dtype
    device = pos.device
    n_oct = len(oct_grids)
    big = torch.finfo(dtype).max
    bargs = block_args_to_device(bargs, dtype, device)
    half_ref = bargs.half_ref
    p3m = gravity == "p3m"

    def padrow(a, fill=0.0):
        pad = torch.full((1,) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=device)
        return torch.cat([a, pad], dim=0)

    oq = bargs.order_q  # (Nq_pad,) with sentinel n
    oc = bargs.order_c  # (N,)
    pq = padrow(pos)[oq]  # (Nq_pad, 3)
    pc = pos[oc]  # (N, 3)
    vq = padrow(vel)[oq]
    vc = vel[oc]
    qmask = (oq < n).to(dtype)
    pqx, pqy, pqz = (pq[:, a].contiguous() for a in range(3))
    vqx, vqy, vqz = (vq[:, a].contiguous() for a in range(3))

    # drift since plan, per octave segment (candidate order is octave-major;
    # octave segment ends are the last entries of each prefix table)
    pref = bargs.pos_ref
    drift_c = torch.sqrt(torch.sum((pc - pref[oc]) ** 2, dim=1))
    oct_end = torch.stack([s[-1, -1, -1] for s in bargs.starts])  # (n_oct,)
    slot_ids = torch.arange(n, device=device)
    oct_of_slot = torch.searchsorted(oct_end, slot_ids, right=True)
    zero = torch.zeros((), dtype=dtype, device=device)
    dmax_o = torch.stack([
        torch.max(torch.where(oct_of_slot == o, drift_c, zero)) for o in range(n_oct)
    ])  # (n_oct,)

    s_os = [2.0 * half_ref / g_o for g_o in oct_grids]

    def covered_radii(qx, qy, qz, qm, box):
        """(n_blocks, BQ, n_oct) guaranteed-coverage radius of each query
        against its block's octave box (0 where the box is empty/sentinel). A box
        side on the grid edge covers to infinity on that side: binning
        clips positions into the grid."""
        covs = []
        for o in range(n_oct):
            s_o = s_os[o]
            g_o = oct_grids[o]
            x0, x1, y0, y1, z0, z1 = (box[:, o, i][:, None] for i in range(6))
            c = torch.full(qx.shape, big, dtype=dtype, device=device)
            for q_ax, lo_i, hi_i in ((qx, x0, x1), (qy, y0, y1), (qz, z0, z1)):
                lo = lo_i.to(dtype) * s_o - half_ref
                hi = (hi_i.to(dtype) + 1.0) * s_o - half_ref
                d_lo = torch.where(lo_i == 0, big, q_ax - lo)
                d_hi = torch.where(hi_i == g_o - 1, big, hi - q_ax)
                c = torch.minimum(c, torch.minimum(d_lo, d_hi))
            covs.append(
                torch.where((x1 >= x0) & (qm > 0), torch.clamp_min(c, 0.0), zero)
            )
        return torch.stack(covs, dim=-1)

    if idx_tables is None:
        idx_tables = build_cand_tables(bargs, spec, n, shard=shard, n_shards=n_shards)
    slices = shard_slices(buckets, shard, n_shards)
    # one fused candidate-position gather for all buckets
    idx_flat = torch.cat([t.reshape(-1) for t in idx_tables.idx])
    cpos_flat = padrow(pc)[idx_flat]  # (T, 3)
    cmask_flat = (idx_flat < n).to(dtype)  # (T,)
    cpos3 = cpos_flat.T.contiguous()  # (3, T): contiguous per-axis bucket slices

    # the true r_k never exceeds the domain diameter, and edge boxes cover
    # "to infinity": min(reach, diam) is a convergent bisection seed and an
    # exact certification bound; the h-hint cap tightens it to the ball's
    # own scale wherever a hint exists
    diam = 2.0 * torch.sqrt(torch.tensor(3.0, dtype=dtype, device=device)) * half_ref * 1.5
    hint = h_hint.to(dtype)
    hint_row = torch.where(hint > 0, (HINT_F * 2.0) * hint, diam)
    hcapq = padrow(hint_row, 0.0)[oq]  # sentinel rows masked by qm
    n_bisect = N_BISECT_HINT if dtype == torch.float32 else N_BISECT_F64

    # guaranteed reach of every packed query (all buckets' blocks at once):
    # its coverage by its block's boxes less each octave's measured drift
    n_blk = oq.shape[0] // BQ
    qms_all = qmask.reshape(n_blk, BQ)
    cov = covered_radii(pqx.reshape(n_blk, BQ), pqy.reshape(n_blk, BQ),
                        pqz.reshape(n_blk, BQ), qms_all, torch.cat(bargs.boxes))
    reach = torch.clamp_min(
        torch.min(torch.where(cov > 0, cov - dmax_o, big), dim=-1).values, 0.0
    )
    r2 = (torch.minimum(torch.minimum(reach, diam), hcapq.reshape(n_blk, BQ)) ** 2).contiguous()

    # ---- phase A: exact r_k + rho per packed-query row (K1 per bucket) ----
    geo = []  # per bucket: (C_b, blocks swept, first block swept)
    h_parts, rho_parts, ok_parts = [], [], []
    b_first = 0
    t_base = 0
    for (C_b, nb), (s0, nb_s) in zip(buckets, slices):
        t1 = t_base + nb_s * C_b
        cands = tuple(cpos3[a, t_base:t1].reshape(nb_s, C_b) for a in range(3)) + (
            cmask_flat[t_base:t1].reshape(nb_s, C_b),
        )
        b0 = b_first + s0
        blk = slice(b0, b0 + nb_s)
        queries = tuple(a.reshape(n_blk, BQ)[blk] for a in (pqx, pqy, pqz, qmask))
        h_b, rho_b, ok_b = phase_a_cells(
            queries, r2[blk], cands, m, kh=kh, cap=BQ, n_bisect=n_bisect,
        )
        h_parts.append(h_b.reshape(-1))
        rho_parts.append(rho_b.reshape(-1))
        ok_parts.append(torch.all(ok_b > 0).reshape(1))
        geo.append((C_b, nb_s, b0))
        b_first, t_base = b_first + nb, t1
    Hq = _to_packed(torch.cat(h_parts), geo, n_blk, 0.0)
    RHOq = _to_packed(torch.cat(rho_parts), geo, n_blk, 0.0)
    rows_ok = torch.all(torch.cat(ok_parts))

    # packed-query results to row space through the inverse packing; a
    # shard reads 0 at the rows it does not own and the psum fills them in
    inv_oq = idx_tables.inv_oq
    Hrow, RHOrow = yield request("psum", (Hq[inv_oq], RHOq[inv_oq]))

    # EOS row fields
    rho_safe = torch.where(RHOrow > 0, RHOrow, torch.ones((), dtype=dtype, device=device))
    if eos == "polytropic":
        P_row = K * rho_safe**gamma
        cs_row = torch.sqrt(gamma * P_row / rho_safe)
    else:
        P_row = cs0 * cs0 * rho_safe
        cs_row = torch.zeros((n,), dtype=dtype, device=device) + cs0
    por2_row = P_row / (rho_safe * rho_safe)

    # candidate-order and query-order packed fields for phase B
    hc = Hrow[oc]
    rhoc = RHOrow[oc]
    por2c = por2_row[oc]
    hq_full = padrow(Hrow)[oq]
    rhoq_full = padrow(RHOrow, 1.0)[oq]
    por2q_full = padrow(por2_row)[oq]
    csq_full = padrow(cs_row)[oq]

    if p3m:
        # sigma tied to the CURRENT domain scale, exactly like the mesh
        # deposit in p3m_mesh_force
        half_now = _domain_half(pos)
        sigma = sigma_cells * (2.0 * half_now / (mesh_factor * g_mesh))
        r_c_now = 4.4 * sigma
    else:
        sigma = None
        r_c_now = zero

    # ---- phase B: pair forces + gravity corrections (owner sweep) ----
    qarrs = (pqx, pqy, pqz, vqx, vqy, vqz, qmask, hq_full, rhoq_full, por2q_full, csq_full)
    cacc = torch.zeros((n + 1, 8), dtype=dtype, device=device)
    if grouped:
        # one fused (T, 6) dynamic-field gather, one launch, one scatter-add
        dyn = torch.stack([vc[:, 0], vc[:, 1], vc[:, 2], hc, rhoc, por2c], dim=1)
        dyn_flat = padrow(dyn)[idx_flat]  # (T, 6)
        cstack = torch.cat([cpos_flat, dyn_flat, cmask_flat[:, None]], dim=1)
        cstack = cstack.reshape(-1, CW, 10).transpose(1, 2).contiguous()
        own = _shard_blocks(geo, n_blk, device)
        qfields = tuple(a.reshape(-1, BQ)[own] for a in qarrs)
        qblk, first = _grouped_chunks(tuple((C_b, nb_s) for C_b, nb_s, _ in geo))
        qouts, couts = phase_b_grouped(
            qfields, cstack, m, alpha, beta, sigma, r_c_now,
            eos=eos, p3m=p3m, cap=BQ, qblk=qblk, first=first, units=idx_tables.units,
        )
        packed = [o.reshape(-1) for o in qouts]
        rows_flat = torch.cat([r.reshape(-1) for r in idx_tables.rows])
        cacc.index_add_(0, rows_flat, couts.transpose(1, 2).reshape(-1, 8))
    else:
        vcp = tuple(padrow(vc[:, a].contiguous()) for a in range(3))
        hcp, rhocp, por2cp = padrow(hc), padrow(rhoc, 1.0), padrow(por2c)
        parts = [[] for _ in range(10)]
        t_base = 0
        for (C_b, nb, b0), idx_all, rows_t in zip(geo, idx_tables.idx, idx_tables.rows):
            t1 = t_base + nb * C_b
            qf = tuple(a.reshape(n_blk, BQ)[b0 : b0 + nb] for a in qarrs)
            cf = tuple(cpos3[a, t_base:t1].reshape(nb, C_b) for a in range(3)) + tuple(
                v[idx_all] for v in vcp
            ) + (
                cmask_flat[t_base:t1].reshape(nb, C_b),
                hcp[idx_all], rhocp[idx_all], por2cp[idx_all],
            )
            qo, co = phase_b_blocks(
                qf, cf, m, alpha, beta, sigma, r_c_now, eos=eos, p3m=p3m, cap=BQ
            )
            for k in range(10):
                parts[k].append(qo[k].reshape(-1))
            cacc.index_add_(0, rows_t.reshape(-1), torch.stack([c.reshape(-1) for c in co], -1))
            t_base = t1
        packed = [torch.cat(p) for p in parts]
    # a shard's swept blocks into the full packed-query arrays (a row a
    # shard does not own reads 0, or -max for mu_max, for the combine)
    packed = [_to_packed(a, geo, n_blk, -big if k == 4 else 0.0)
              for k, a in enumerate(packed)]

    # phase-B certificate: the forward ball and the tail radius inside the
    # planned coverage minus the measured drift (reach, as in phase A)
    need = torch.maximum(2.0 * hq_full.reshape(n_blk, BQ),
                         torch.as_tensor(r_c_now, dtype=dtype, device=device))
    rows_ok = rows_ok & torch.all((qms_all <= 0) | (need <= reach))

    # query-side unpack is a gather through the inverse packing
    def unpack(k):
        return packed[k][inv_oq]

    acc = torch.stack([
        unpack(0) + cacc[:n, 0],
        unpack(1) + cacc[:n, 1],
        unpack(2) + cacc[:n, 2],
    ], dim=1)
    div_row = unpack(3)
    visc_row = unpack(5) + cacc[:n, 3]
    gcorr = (
        unpack(6) + cacc[:n, 4],
        unpack(7) + cacc[:n, 5],
        unpack(8) + cacc[:n, 6],
        unpack(9) + cacc[:n, 7],
    )
    acc, div_row, visc_row, gcorr = yield request("psum", (acc, div_row, visc_row, gcorr))
    mu_row = yield request("pmax", unpack(4))
    rows_ok = (yield request("psum", rows_ok.to(torch.int64))) == n_shards
    red = ReducedForces(
        acc=acc, rho=RHOrow, h=Hrow, cs=cs_row, mu_max=mu_row, div_sum=div_row,
        visc_dk=visc_row,
    )
    return red, gcorr, rows_ok


def _shard_blocks(geo, n_blk: int, device):
    """The packed-query blocks a shard sweeps, bucket by bucket (None: all)."""
    if sum(nb_s for _, nb_s, _ in geo) == n_blk:
        return slice(None)
    return torch.cat([torch.arange(b0, b0 + nb_s, device=device) for _, nb_s, b0 in geo])


def _to_packed(a, geo, n_blk: int, fill):
    """A shard's swept blocks' values (flat, bucket by bucket) at their
    places in a full (n_blk * BQ) packed-query array, `fill` elsewhere
    (the array itself when the shard sweeps every block)."""
    if sum(nb_s for _, nb_s, _ in geo) == n_blk:
        return a
    out = torch.full((n_blk, BQ), fill, dtype=a.dtype, device=a.device)
    out[_shard_blocks(geo, n_blk, a.device)] = a.reshape(-1, BQ)
    return out.reshape(-1)
