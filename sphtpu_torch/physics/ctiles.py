"""Class-compacted tile engine: occupancy-classed query blocks.

A mono-tile engine pads EVERY cell's query slots to the global capacity:
at a uniform state (mean cell occupancy far below the cap) most swept
query slots are padding. This engine removes the QUERY-side padding while
keeping mono-level certification (r_k <= cell edge), the 27-cell candidate
prestack and the scatter-free fwd+rev symmetric pair sum:

*   Cells are classed per evaluation by OCCUPANCY into a static capacity
    menu (32, 64, 96, 128): a cell with 30 particles sweeps (32, 27*cap)
    pair tiles instead of (128, 27*cap). Class LIST SIZES are plan-time
    constants (with drift headroom) so launch shapes stay static per
    config; the per-eval class assignment is data-dependent and certified
    — a class-count overflow fails the evaluation certificate exactly like
    a slot overflow (fallback, never wrong physics).
*   Phases A and B both run per class as hand-written CUDA kernels over
    gathered prestack rows: phase A is the shape-generic
    kernels/cuda_strip_knn.phase_a_cells, phase B
    kernels/cuda_tile_pairs.phase_b_tiles (fwd+rev masks, near-gravity
    correction). On CPU tensors both run their plain PyTorch versions.
*   Candidate width stays the full 27*cap stencil (a candidate cell's
    occupancy class is independent of the query's), so certification and
    pair coverage are EXACTLY a mono engine's; only padded query rows
    disappear from the sweep.

P3M mode is supported when the tail stencil half-width is one cell
(EngineConfig.c_halfwidth == 1, which needs mesh_factor >=
ceil(4.4 * sigma_cells); the default mesh_factor of 5 does not satisfy it
and EngineConfig rejects that combination): the Newtonian-minus-mesh-shape
term rides the same 3^3 pass. The outlier lane is NOT supported here.

Reference parity: same pair physics as polytrope_hydroKDTree.jl:222-248 /
isothermal_hydroKDTree.jl:219-245; pinned against the gather engine and
the JAX package by tests/test_torch_ctiles.py.

No host synchronisation happens inside `ctile_sph_forces`: the class lists
are built on the device with static sizes and `ok` is returned as a device
scalar for the caller to read.
"""

from __future__ import annotations

import torch

from ..device import require_on, resolve_device
from ..kernels.cuda_strip_knn import phase_a_cells
from ..kernels.cuda_tile_pairs import phase_b_tiles
from .tiles import MASK, X, Y, Z, _extract, _stack_sph_fields, _tile_stack

CLASS_MENU = (32, 64, 96, 128)


def _class_thresholds(menu):
    """Max occupancy routed to each class. Shared by the planner and the
    engine so per-class counts are predictable: a cell goes to class k
    when occ <= thr_k, with thr sized so the class cap keeps ~10% + 2
    slots of drift headroom above the routing boundary; the LAST class
    accepts everything up to the global cap (the slot-overflow
    certificate guards beyond)."""
    thr = [int((ck - 2) / 1.1) for ck in menu[:-1]]
    thr.append(menu[-1])
    return tuple(thr)


def choose_tile_classes(
    pos_code,
    h,
    kh: int,
    *,
    safety: float = 1.05,
    cap_max: int = 128,
    headroom: float = 1.25,
    count_margin: float = 1.3,
    prestack_budget: float = 1.6e9,
):
    """Host-side planning: (grid, cap, classes) or None.

    grid/cap follow choose_tile_params (mono-level certification bound,
    measured max occupancy + drift headroom) restricted to cap <= 128
    (the capacity menu's largest class). classes is a tuple of
    (cap_k, n_cells_k) list sizes over CLASS_MENU entries <= cap, each
    padded by `count_margin` so per-step occupancy drift migrates cells
    between classes without replanning; migrations past the padding fail
    the in-engine certificate (fallback, then re-plan). Returns None when
    the state cannot certify or the 11-field candidate prestack would
    exceed `prestack_budget` bytes (the caller stays on the legacy
    engine)."""
    import numpy as np

    pos_code = np.asarray(pos_code)
    h = np.asarray(h)
    half = float(np.abs(pos_code).max()) * (1 + 1e-6)
    grid = max(int(2.0 * half / (safety * 2.0 * float(h.max()))), 2)
    s_eff = 2.0 * half / grid
    c = np.clip((pos_code + half) // s_eff, 0, grid - 1).astype(np.int64)
    cells = (c[:, 2] * grid + c[:, 1]) * grid + c[:, 0]
    occ = np.bincount(cells, minlength=grid**3)
    cmax = int(occ.max())
    cap = max(32, int(-(-headroom * cmax // 32)) * 32)
    if cap > cap_max:
        return None
    if 11 * grid**3 * 27 * cap * 4 > prestack_budget:
        return None
    menu = tuple(m for m in CLASS_MENU if m < cap) + (cap,)
    thr = np.asarray(_class_thresholds(menu))
    cls = np.searchsorted(thr, occ, side="left")
    counts = np.bincount(cls[occ > 0], minlength=len(menu))
    classes = []
    for k, cap_k in enumerate(menu):
        nk = int(counts[k])
        nk_pad = max(int(-(-nk * count_margin // 8)) * 8, 8)
        classes.append((int(cap_k), min(nk_pad, grid**3)))
    return grid, cap, tuple(classes)


def ctile_sph_forces(
    pos: torch.Tensor,
    vel: torch.Tensor,
    m,
    K,
    h_hint: torch.Tensor,
    *,
    eos: str,
    gamma,
    cs0,
    alpha,
    beta,
    kh: int,
    grid: int,
    cap: int,
    classes: tuple,
    mesh_factor: int = 0,
    sigma_cells: float = 2.2,
    device=None,
):
    """(ReducedForces, (gx, gy, gz, phi) near-gravity corrections, ok).
    ok False => caller falls back. mesh_factor == 0 is exact mode
    (corrections vs the pure-Newtonian sweep); > 0 is P3M with
    c_halfwidth == 1 REQUIRED (the caller/planner guarantees
    mesh_factor >= ceil(4.4 * sigma_cells)). device=None means the card."""
    require_on(resolve_device(device), pos, vel)
    dtype = pos.dtype
    dev = pos.device
    g = grid
    del h_hint  # classing is from actual occupancy, not the hint
    st = _tile_stack(pos, vel, g, cap)
    cell_row = st.cell_row
    n_cells = g**3
    n_cls = len(classes)
    qpl, pre_rows = st.qpl, st.pre_rows

    # per-eval occupancy classing (data-dependent; certified). Same
    # thresholds as choose_tile_classes so plan counts predict eval
    # counts; drift between refreshes is covered by count_margin.
    occ = torch.zeros((n_cells,), dtype=torch.int64, device=dev).index_add_(
        0, cell_row, torch.ones_like(cell_row)
    )
    thr = torch.tensor(
        _class_thresholds(tuple(ck for ck, _ in classes)),
        dtype=torch.int64, device=dev,
    )
    cls = torch.searchsorted(thr, occ, right=False)
    # empty cells carry no work; route them (and occupancies past the last
    # threshold) to the sentinel class so small classes stay small
    cls = torch.where(occ > 0, cls, torch.full_like(cls, n_cls))
    counts = torch.zeros((n_cls + 1,), dtype=torch.int64, device=dev).index_add_(
        0, cls, torch.ones_like(cls)
    )[:n_cls]
    planned = torch.tensor([nk for _, nk in classes], dtype=torch.int64, device=dev)
    fits = torch.all(counts <= planned) & torch.all(occ <= cap)

    # class lists of static size nk: the class's cells in ascending order,
    # padded (or cut) with the sentinel row n_cells
    by_class = torch.argsort(cls, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    cells_k = []
    for k, (_, nk) in enumerate(classes):
        slot = torch.arange(nk, device=dev)
        picked = by_class[torch.clamp_max(starts[k] + slot, n_cells - 1)]
        cells_k.append(
            torch.where(slot < counts[k], picked, torch.full_like(picked, n_cells))
        )

    # phase A per class: exact k-th distance + density over the gathered
    # candidate prestack rows
    a_fields = (X, Y, Z, MASK)
    Hf = torch.zeros((n_cells + 1, cap), dtype=dtype, device=dev)
    RHOf = torch.zeros((n_cells + 1, cap), dtype=dtype, device=dev)
    rows_ok = torch.ones((), dtype=torch.bool, device=dev)
    s2 = st.s * st.s
    cands_k = []
    for k, (cap_k, nk) in enumerate(classes):
        ck = cells_k[k]
        qs = tuple(
            qpl[f].index_select(0, ck)[:, :cap_k].contiguous() for f in a_fields
        )
        cs_ = {f: pre_rows[f].index_select(0, ck) for f in a_fields}
        cands_k.append(cs_)
        reach2 = s2.expand(nk, cap_k).contiguous()
        h_b, rho_b, ok_b = phase_a_cells(
            qs, reach2, tuple(cs_[f] for f in a_fields), m, kh=kh, cap=cap_k
        )
        Hf[ck, :cap_k] = h_b
        RHOf[ck, :cap_k] = rho_b
        rows_ok = rows_ok & torch.all(ok_b > 0)

    Hq = Hf[:n_cells]
    RHOq = RHOf[:n_cells]
    CSq = _stack_sph_fields(st, Hq, RHOq, K, eos=eos, gamma=gamma, cs0=cs0)

    if mesh_factor > 0:
        sigma = (st.s / mesh_factor) * sigma_cells
    else:
        sigma = None

    # phase B per class: class rows gathered from the 11-field prestack
    # (the four fields phase A gathered are reused)
    outs_flat = torch.zeros((10, n_cells + 1, cap), dtype=dtype, device=dev)
    for k, (cap_k, nk) in enumerate(classes):
        ck = cells_k[k]
        qs = tuple(
            qpl[f].index_select(0, ck)[:, :cap_k].contiguous() for f in range(11)
        )
        cs_ = tuple(
            cands_k[k][f] if f in cands_k[k] else pre_rows[f].index_select(0, ck)
            for f in range(11)
        )
        outs_k = phase_b_tiles(
            qs, cs_, m, alpha, beta, sigma,
            eos=eos, p3m=mesh_factor > 0, cap=cap_k,
        )
        outs_flat[:, ck, :cap_k] = torch.stack(outs_k)

    out, gcorr = _extract(st, outs_flat, Hq, RHOq, CSq, eos=eos, cs0=cs0)
    ok = (~st.overflow) & rows_ok & fits
    return out, gcorr, ok


def ctile_classes_still_ok(
    pos_code, h, grid: int, cap: int, classes: tuple, *, slack: float = 1.05
):
    """Host-side hysteresis forecast for an ALREADY-PLANNED class
    config: do the current state's per-class cell counts still fit the
    planned list sizes (with slack), on top of the mono-tile checks the
    caller performs via tile_params_still_ok? The in-engine certificate
    (`fits`) stays the safety net."""
    import numpy as np

    pos_code = np.asarray(pos_code)
    half = float(np.abs(pos_code).max()) * (1 + 1e-6)
    s_eff = 2.0 * half / grid
    c = np.clip((pos_code + half) // s_eff, 0, grid - 1).astype(np.int64)
    cells = (c[:, 2] * grid + c[:, 1]) * grid + c[:, 0]
    occ = np.bincount(cells, minlength=grid**3)
    if int(occ.max()) > cap:
        return False
    thr = np.asarray(_class_thresholds(tuple(ck for ck, _ in classes)))
    cls = np.searchsorted(thr, occ, side="left")
    if int(cls.max()) >= len(classes) and bool((occ[cls >= len(classes)] > 0).any()):
        return False
    counts = np.bincount(cls[occ > 0], minlength=len(classes))
    planned = np.asarray([nk for _, nk in classes])
    return bool(np.all(counts * slack <= planned))
