"""Sharded mono-tile engine: z-slab decomposition + ring halo exchange.

Port of sphtpu/shard/tiles.py, over a mesh of shards in one process
(shard/collectives.py). The reference module docstring describes the
engine; in short:

*   The host splits the tile grid's z-layers into contiguous slabs, one a
    shard, balanced by particle count (`plan_slabs`). Particles are
    permuted into a (n_dev, n_loc) padded row layout, each shard's real
    rows first; ownership and the domain half-width (hence the cell edge
    s) are frozen for one chunk and re-planned between chunks.
*   Each force evaluation exchanges halos twice over a ring of `hops`
    hops each way (fixed `budget` rows a hop and direction, certified
    against overflow): positions and velocities before phase A, phase A's
    h, rho, P/rho^2 and cs before phase B.
*   Within a shard the phases are the mono-tile engine's functions on the
    slab's query cells (`lz_max + 2 halo` layers of grid x grid): the
    slab-and-halo rows are binned with the plan's frozen half into a
    TileStack-like slot layout, and phase A is kernel K4
    (kernels/cuda_knn.phase_a_tile), phase B kernel K2
    (kernels/cuda_tile_pairs.phase_b_tiles, local rows as queries, local
    and halo rows as candidates), phase C under P3M the tail kernel
    (kernels/cuda_p3m_tail.p3m_tail over the slab's layers).
*   Far field: "exact" sweeps each shard's rows against the column blocks
    that rotate around the ring, one rows x columns launch of kernel K3 a
    round (kernels/cuda_gravity_rc.newton_rows_cols, real rows and columns
    only); "p3m" deposits each shard's mass on the mesh, psums it, and
    every shard solves it.

Certification is collective: slot overflow, per-row k found and r_k <= s,
halo budgets, frozen domain and ownership drift are reduced over the
shards, and the host reads the result once per evaluation. A failed
evaluation freezes the chunk (the state stops, the step reports
cert_fail) and the host re-plans.

One difference from the reference (ROADMAP D14): under P3M the mesh and the
tail's Gaussian width follow the evaluation's global half-width (a pmax
over the shards), as the single-device engines do, where the reference's
slab engine keeps the plan's frozen half. The binning keeps the frozen
half. The tail's reach only shrinks by it (the current half never exceeds
the frozen one while the state is in its box), and the P3M result no
longer depends on the number of shards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..engine.config import EngineConfig, Params, State
from ..kernels.cuda_gravity_rc import newton_rows_cols
from ..kernels.cuda_knn import phase_a_tile
from ..kernels.cuda_p3m_tail import p3m_tail
from ..kernels.cuda_tile_pairs import phase_b_tiles
from ..physics.mesh_gravity import greens_hat, mesh_deposit, mesh_solve, tail_halfwidth
from ..physics.tiles import CS, H, MASK, X, fill_stack
from ..profiling import stage
from .collectives import local_devices, local_shards, request, run_mesh
from .step import replicate

# ---------------------------------------------------------------------------
# Host-side slab planning (numpy; the reference's, bit for bit)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SlabPlan:
    """Static geometry of one chunk's slab decomposition (part of the
    compile key) plus the host-side layout arrays (not traced)."""

    grid: int  # tile cells per edge
    cap: int  # slots per cell
    lz_max: int  # thickest slab, layers
    halo: int  # drift halo depth, layers
    hops: int  # ring hops per direction per exchange
    budget: int  # halo-exchange rows per (direction, hop)
    n_loc: int  # padded rows per device
    n_dev: int
    half: float  # frozen domain half-width (code units)
    # host arrays (numpy; not part of the compile key)
    z0s: np.ndarray = dataclasses.field(compare=False)  # (n_dev+1,) layer bounds
    order: np.ndarray = dataclasses.field(compare=False)  # (n_dev*n_loc,) row -> global id, -1 pad
    # real rows a shard, where `order` is None (shard/mh_slabs.mh_plan_slabs)
    rows: tuple = dataclasses.field(default=None, compare=False)

    @property
    def static_key(self):
        return (
            self.grid, self.cap, self.lz_max, self.halo, self.hops,
            self.budget, self.n_loc, self.n_dev,
        )


def plan_slabs(
    pos_code: np.ndarray,
    h: np.ndarray,
    kh: int,
    n_dev: int,
    *,
    chunk_steps: int = 10,
    safety: float = 1.05,
    cap_max: int = 256,
    headroom: float = 1.25,
    slots_max: int = 12_000_000,
) -> Optional[SlabPlan]:
    """Choose (grid, cap, slabs, halo, hops, budget) for one chunk.

    Mono-level sizing (cell edge >= safety * 2 * max h, the same
    certification bound as physics/tiles.py choose_tile_params); slab
    boundaries balance particle counts. Returns None when the state cannot
    certify (capacity, geometry) — the caller uses the gather formulation.
    """
    pos_code = np.asarray(pos_code)
    h = np.asarray(h)
    n = pos_code.shape[0]

    # frozen domain: a small margin keeps chunk-long drift inside the box
    # (per-step drift <= 0.15 cell edges by the CFL bound); escapes fail
    # certification and trigger a host re-plan, never wrong physics
    half = float(np.abs(pos_code).max()) * (1.0 + 1e-6) * 1.02

    g = max(int(2.0 * half / (safety * 2.0 * float(h.max()))), 2)
    if g < n_dev:  # fewer layers than devices: no slab per chip
        return None
    s = 2.0 * half / g
    c = np.clip((pos_code + half) // s, 0, g - 1).astype(np.int64)
    cells = (c[:, 2] * g + c[:, 1]) * g + c[:, 0]
    cmax = int(np.bincount(cells, minlength=g**3).max())
    layer_counts = np.bincount(c[:, 2], minlength=g)

    geo = plan_slabs_from_hists(
        n, half, g, layer_counts, cmax, n_dev,
        chunk_steps=chunk_steps, cap_max=cap_max, headroom=headroom,
        slots_max=slots_max,
    )
    if geo is None:
        return None
    z0s, n_loc = geo["z0s"], geo["n_loc"]

    dev_of = np.searchsorted(z0s, c[:, 2], side="right") - 1
    order = np.full(n_dev * n_loc, -1, dtype=np.int64)
    for p in range(n_dev):
        rows = np.flatnonzero(dev_of == p)
        order[p * n_loc : p * n_loc + rows.size] = rows

    return SlabPlan(
        grid=g, cap=geo["cap"], lz_max=geo["lz_max"], halo=geo["halo"],
        hops=geo["hops"], budget=geo["budget"], n_loc=n_loc, n_dev=n_dev,
        half=half, z0s=z0s, order=order,
    )


def plan_slabs_from_hists(
    n: int,
    half: float,
    g: int,
    layer_counts: np.ndarray,
    cmax: int,
    n_dev: int,
    *,
    chunk_steps: int = 10,
    cap_max: int = 256,
    headroom: float = 1.25,
    slots_max: int = 12_000_000,
):
    """Slab geometry from HISTOGRAMS only (no positions): the shared core
    of plan_slabs (single host: histograms from the full state) and the
    multi-host state-sharded planner (shard/mh_slabs.py: per-process
    local histograms summed by one small allgather). Every quantity —
    boundaries, capacities, halo budgets — is a pure function of the
    z-layer histogram and the max cell occupancy, so processes that
    agree on those sums derive the identical plan with no global
    positions anywhere. Returns a dict of geometry fields or None."""
    cap = max(32, int(-(-headroom * cmax // 32)) * 32)
    if cap > cap_max or g**3 * cap > slots_max:
        return None

    # balanced contiguous layer partition by particle count
    cum = np.concatenate([[0], np.cumsum(layer_counts)])
    z0s = np.zeros(n_dev + 1, dtype=np.int64)
    z0s[n_dev] = g
    for p in range(1, n_dev):
        target = n * p / n_dev
        # strictly increasing with >= 1 layer per device (g >= n_dev holds)
        z0s[p] = min(
            max(int(np.searchsorted(cum, target)), z0s[p - 1] + 1),
            g - (n_dev - p),
        )

    lzs = np.diff(z0s)
    lz_max = int(lzs.max())
    halo = max(1, math.ceil(0.155 * chunk_steps))

    def count_z(lo, hi):
        """Particles with layer in [lo, hi) — from the histogram."""
        lo = max(int(lo), 0)
        hi = min(int(hi), g)
        return int(cum[hi] - cum[lo]) if hi > lo else 0

    counts = np.array([count_z(z0s[p], z0s[p + 1]) for p in range(n_dev)])
    n_loc = int(-(-int(counts.max()) // 256) * 256)

    # ring reach: receiver q needs layers [z0_q - halo - 2,
    # z_end_q + halo + 2); sender p's rows stay within
    # [z0_p - halo, z_end_p + halo). hops = max |q - p| with overlap.
    hops = 1
    for q in range(n_dev):
        for p in range(n_dev):
            if p == q:
                continue
            lo_q, hi_q = z0s[q] - halo - 2, z0s[q + 1] + halo + 2
            lo_p, hi_p = z0s[p] - halo, z0s[p + 1] + halo
            if hi_p > lo_q and lo_p < hi_q:
                hops = max(hops, abs(q - p))

    # per-(direction, hop) send budget from the initial state + margin
    max_send = 0
    for r in range(1, hops + 1):
        for i in range(n_dev):
            if i + r < n_dev:  # up: i -> i+r
                thr = z0s[i + r] - halo - 2
                max_send = max(
                    max_send, count_z(max(thr, z0s[i]), z0s[i + 1])
                )
            if i - r >= 0:  # down: i -> i-r
                thr = z0s[i - r + 1] + halo + 2
                max_send = max(
                    max_send, count_z(z0s[i], min(thr, z0s[i + 1]))
                )
    budget = int(-(-int(max_send * 1.5 + 64) // 256) * 256)

    return {
        "cap": cap, "z0s": z0s, "lz_max": lz_max, "halo": halo,
        "hops": hops, "budget": budget, "n_loc": n_loc,
    }


def slab_plan_still_ok(
    plan: SlabPlan,
    pos_code: np.ndarray,
    h: np.ndarray,
    *,
    edge_margin: float = 1.02,
    budget_margin: float = 1.1,
) -> bool:
    """Compile-aware hysteresis forecast: can an ALREADY-COMPILED slab
    geometry still certify on the current state? A slab compile costs
    minutes (remote AOT) and plan_slabs re-derives grid/cap/budget from
    the drifted state every chunk — so any cached plan that passes this
    host-side check is reused instead (the in-engine collective
    certificate remains the safety net; a wrong forecast costs a frozen
    chunk + re-plan, never physics). Mirrors the in-engine checks of
    make_slab_force_eval: frozen-domain inbox, mono-level cell-edge bound,
    slot capacity, per-device ownership drift within the halo, and the
    halo-exchange send budgets."""
    pos_code = np.asarray(pos_code)
    h = np.asarray(h)
    n = pos_code.shape[0]
    if plan.order.size < n or (plan.order >= 0).sum() != n:
        return False
    if float(np.abs(pos_code).max()) * (1.0 + 1e-6) >= plan.half:
        return False
    g = plan.grid
    s = 2.0 * plan.half / g
    if 2.0 * float(h.max()) * edge_margin > s:
        return False
    c = np.clip((pos_code + plan.half) // s, 0, g - 1).astype(np.int64)
    cells = (c[:, 2] * g + c[:, 1]) * g + c[:, 0]
    if int(np.bincount(cells, minlength=g**3).max()) > plan.cap:
        return False
    # ownership drift: each frozen-owner row must sit within its device's
    # halo reach (the engine's drift_ok term)
    z0s, H = plan.z0s, plan.halo
    mask = plan.order >= 0
    dev_of_row = np.repeat(np.arange(plan.n_dev), plan.n_loc)[mask]
    zc = c[plan.order[mask], 2]
    lo = z0s[dev_of_row] - H
    hi = z0s[dev_of_row + 1] + H
    if not bool(np.all((zc >= lo) & (zc < hi))):
        return False
    # halo send budgets (the engine's send_ok term), with margin
    for r in range(1, plan.hops + 1):
        for i in range(plan.n_dev):
            own = dev_of_row == i
            if i + r < plan.n_dev:
                thr = z0s[i + r] - H - 2
                if int(np.sum(own & (zc >= thr))) * budget_margin > plan.budget:
                    return False
            if i - r >= 0:
                thr = z0s[i - r + 1] + H + 2
                if int(np.sum(own & (zc < thr))) * budget_margin > plan.budget:
                    return False
    return True


class SlabState(NamedTuple):
    """One shard's chunk-local state: its n_loc padded rows."""

    pos: torch.Tensor  # (n_loc, 3)
    vel: torch.Tensor
    K: torch.Tensor  # (n_loc,)
    valid: torch.Tensor  # (n_loc,) bool; the real rows come first
    t: torch.Tensor  # scalar


def pack_state(state: State, plan: SlabPlan, mesh) -> list:
    """Permute an engine State into the padded slab layout: one SlabState
    a shard, on its device. The permutation is the host's (`plan.order`);
    the rows move as one gather on the state's device."""
    dev = state.pos.device
    o = torch.as_tensor(plan.order, device=dev)
    valid = o >= 0
    safe = torch.clamp_min(o, 0)
    zero = torch.zeros((), dtype=state.pos.dtype, device=dev)
    pos = torch.where(valid[:, None], state.pos[safe], zero)
    vel = torch.where(valid[:, None], state.vel[safe], zero)
    K = torch.where(valid, state.K[safe], zero)
    k = plan.n_loc
    return [
        SlabState(
            pos[i * k : (i + 1) * k].to(d),
            vel[i * k : (i + 1) * k].to(d),
            K[i * k : (i + 1) * k].to(d),
            valid[i * k : (i + 1) * k].to(d),
            state.t.to(d),
        )
        for i, d in enumerate(mesh)
    ]


def unpack_rows(arr: np.ndarray, plan: SlabPlan, n: int) -> np.ndarray:
    """Invert the pack permutation for a (n_dev*n_loc, ...) output."""
    out = np.zeros((n,) + arr.shape[1:], arr.dtype)
    mask = plan.order >= 0
    out[plan.order[mask]] = arr[mask]
    return out


def unpack_state(states, plan: SlabPlan, n: int) -> State:
    """The shards' SlabStates back into one State in particle order, on
    shard 0's device (one gather by the inverse permutation)."""
    dev = states[0].pos.device
    inv = torch.as_tensor(
        unpack_rows(np.arange(plan.order.size), plan, n), device=dev
    )

    def cat(field):
        return torch.cat([getattr(s, field).to(dev) for s in states])[inv]

    return State(cat("pos"), cat("vel"), cat("K"), states[0].t)


def real_rows(plan: SlabPlan) -> list:
    """Real rows of each shard (a prefix of its n_loc rows): from the
    plan's order, or its `rows` where ownership is process-local
    (shard/mh_slabs.py plans with order=None)."""
    if plan.order is None:
        return list(plan.rows)
    return [
        int((plan.order[i * plan.n_loc : (i + 1) * plan.n_loc] >= 0).sum())
        for i in range(plan.n_dev)
    ]


# ---------------------------------------------------------------------------
# Device-side force evaluation (one generator body a shard)
# ---------------------------------------------------------------------------


def _rank_in_cell(cid):
    """Ranks 0.. within equal cid groups, in row order (stable sort)."""
    n = cid.shape[0]
    order = torch.argsort(cid, stable=True)
    cid_s = cid[order]
    iota = torch.arange(n, device=cid.device)
    newseg = torch.ones((n,), dtype=torch.bool, device=cid.device)
    newseg[1:] = cid_s[1:] != cid_s[:-1]
    seg_start = torch.cummax(torch.where(newseg, iota, 0), dim=0).values
    return torch.empty_like(iota).scatter_(0, order, iota - seg_start)


def _select_rows(mask, budget: int, n_loc: int):
    """Fixed-size selection of the first `budget` rows where mask holds, in
    row order: rows (budget,) into [0, n_loc) (n_loc at pads), valid flags,
    and the overflow certificate. No host synchronisation."""
    idx = torch.cumsum(mask.to(torch.int64), 0) - 1
    dst = torch.where(mask & (idx < budget), idx, budget)
    rows = torch.full((budget + 1,), n_loc, dtype=torch.int64, device=mask.device)
    rows.scatter_(0, dst, torch.arange(n_loc, device=mask.device))
    rows[budget] = n_loc  # the sink of the unselected rows
    rows = rows[:budget]
    return rows, rows < n_loc, torch.sum(mask) <= budget


def _gather_rows(fields, rows, valid):
    """Stack (n_loc,) fields into a (budget, F) payload, zeros at pads."""
    safe = torch.clamp_max(rows, fields[0].shape[0] - 1)
    zero = torch.zeros((), dtype=fields[0].dtype, device=fields[0].device)
    return torch.stack([torch.where(valid, f[safe], zero) for f in fields], dim=1)


def _ring_sendrecv(payloads_up, payloads_dn, n_dev: int, hops: int):
    """ppermute each hop's payloads (a generator body): the list [up from
    r below, down from r above for r = 1..hops], zeros where no partner
    exists."""
    recv = []
    for r in range(1, hops + 1):
        perm_up = [(i, i + r) for i in range(n_dev - r)]
        perm_dn = [(i, i - r) for i in range(r, n_dev)]
        recv.append((yield request("ppermute", payloads_up[r - 1], perm=perm_up)))
        recv.append((yield request("ppermute", payloads_dn[r - 1], perm=perm_dn)))
    return recv


QMASK = 11  # the query-mask plane (local rows only)


def make_slab_force_eval(cfg: EngineConfig, plan: SlabPlan, joint_gravity: bool = False):
    """Per-shard force evaluation: eval(p, shard, pos_l, vel_l, K_l,
    valid_l, ghat) is a generator body (run it under `run_spmd`, one a
    shard) that returns (acc, aux dict incl. phi, ok) for the shard's
    rows (aux also holds g, the softened gravity that acc subtracts). ok
    is a replicated 0-d bool: False on any shard's certification failure
    means the result must be discarded. joint_gravity=True: in float32
    under P3M, K2 takes a close pair's two gravity corrections as one
    float64 term and the tail leaves the pair out (ROADMAP D21, as
    physics/tiles.tile_sph_forces does); the default, and float64 always,
    add them in the two kernels, as the reference does."""
    g, cap, Hh = plan.grid, plan.cap, plan.halo
    hops, B, n_loc, n_dev = plan.hops, plan.budget, plan.n_loc, plan.n_dev
    z0s = [int(z) for z in plan.z0s]
    kh = cfg.kh
    qz = plan.lz_max + 2 * Hh  # query layers a shard
    Z = qz + 4  # plane layers: queries +-2 candidate layers
    gp = g + 2
    n_slab = Z * g * g  # binned cells
    n_q = qz * g * g  # query cells
    p3m = cfg.gravity == "p3m"
    counts = real_rows(plan)

    def eval_forces(p: Params, shard: int, pos_l, vel_l, K_l, valid_l, ghat):
        dtype, dev = pos_l.dtype, pos_l.device
        joint = joint_gravity and p3m and dtype == torch.float32
        z0 = z0s[shard]
        lz = z0s[shard + 1] - z0
        half = torch.as_tensor(plan.half, dtype=dtype, device=dev)
        s = 2.0 * half / g
        zero = torch.zeros((), dtype=dtype, device=dev)

        with stage("slab_bin"):
            # ---- frozen-domain + drift certification ----
            inbox = torch.max(torch.where(valid_l[:, None], torch.abs(pos_l), zero)) < half
            cell = torch.clamp(torch.floor((pos_l + half) / s).to(torch.int64), 0, g - 1)
            zc, yc, xc = cell[:, 2], cell[:, 1], cell[:, 0]
            zl = zc - (z0 - Hh - 2)  # plane-local layer, queries in [2, 2+qz)
            drift_ok = torch.all(~valid_l | ((zc >= z0 - Hh) & (zc < z0 + lz + Hh)))

            # ---- halo exchange 1: pos + vel ----
            ups, dns, sel = [], [], []
            send_ok = torch.ones((), dtype=torch.bool, device=dev)
            fields1 = [pos_l[:, 0], pos_l[:, 1], pos_l[:, 2],
                       vel_l[:, 0], vel_l[:, 1], vel_l[:, 2]]
            for r in range(1, hops + 1):
                # up: partner shard+r needs zc >= z0s[shard+r] - H - 2
                if shard + r < n_dev:
                    mu = valid_l & (zc >= z0s[shard + r] - Hh - 2)
                else:
                    mu = torch.zeros_like(valid_l)
                # down: partner shard-r needs zc < z0s[shard-r+1] + H + 2
                if shard - r >= 0:
                    md = valid_l & (zc < z0s[shard - r + 1] + Hh + 2)
                else:
                    md = torch.zeros_like(valid_l)
                for msk, pays in ((mu, ups), (md, dns)):
                    rows, rv, ok_r = _select_rows(msk, B, n_loc)
                    pays.append(torch.cat(
                        [_gather_rows(fields1, rows, rv), rv[:, None].to(dtype)], dim=1
                    ))
                    sel.append((rows, rv))
                    send_ok = send_ok & ok_r
        recv = yield from _ring_sendrecv(ups, dns, n_dev, hops)
        with stage("slab_bin"):
            halo = torch.cat(recv, dim=0)  # (2*hops*B, 7)
            hpos, hvel = halo[:, 0:3], halo[:, 3:6]
            hval = halo[:, 6] > 0

            # slot assignment: local ranks first, halo ranks continue
            hcell = torch.clamp(torch.floor((hpos + half) / s).to(torch.int64), 0, g - 1)
            hzl = hcell[:, 2] - (z0 - Hh - 2)
            live_l = valid_l & (zl >= 0) & (zl < Z)
            cid_l = torch.where(live_l, (zl * g + yc) * g + xc, n_slab)
            rank_l = _rank_in_cell(cid_l)
            occ = torch.bincount(cid_l, minlength=n_slab + 1)[:n_slab]
            live_h = hval & (hzl >= 0) & (hzl < Z)
            cid_h = torch.where(live_h, (hzl * g + hcell[:, 1]) * g + hcell[:, 0], n_slab)
            rank_h = _rank_in_cell(cid_h) + torch.where(
                live_h, occ[torch.clamp_max(cid_h, n_slab - 1)], 0
            )
            overflow = torch.any(live_l & (rank_l >= cap)) | torch.any(live_h & (rank_h >= cap))

            def slots(zl_, yc_, xc_, rank_, live):
                pz = torch.where(live, zl_, Z)  # Z: the drop layer
                return pz, yc_ + 1, (xc_ + 1) * cap + torch.clamp_max(rank_, cap - 1)

            loc = slots(zl, yc, xc, rank_l, live_l)
            hsl = slots(hzl, hcell[:, 1], hcell[:, 0], rank_h, live_h)
            planes = torch.zeros((12, Z + 1, gp, gp * cap), dtype=dtype, device=dev)
            planes[0:MASK + 1, loc[0], loc[1], loc[2]] = torch.cat(
                [pos_l.T, vel_l.T, torch.ones((1, n_loc), dtype=dtype, device=dev)]
            )
            planes[0:MASK + 1, hsl[0], hsl[1], hsl[2]] = torch.cat(
                [hpos.T, hvel.T, torch.ones((1, hpos.shape[0]), dtype=dtype, device=dev)]
            )
            planes[QMASK, loc[0], loc[1], loc[2]] = 1.0
            planes = planes[:, :Z]
            # the slab's TileStack: the prestack is its largest buffer
            pre = torch.zeros((11, n_q, 27, cap), dtype=dtype, device=dev)
            qpl = torch.zeros((11, n_q, cap), dtype=dtype, device=dev)
            fill_stack(planes[:, 1:], pre, qpl, X, MASK + 1, qz, g, cap)
            pre_rows = pre.view(11, n_q, 27 * cap)
            # each local row's query cell and slot
            qcell = (torch.clamp(zl - 2, 0, qz - 1) * g + yc) * g + xc
            slot = torch.clamp_max(rank_l, cap - 1)

        # ---- phase A (K4): exact r_kh + density, every slot of the slab
        # (the halo rows' values are replaced by their owners' below) ----
        with stage("phase_a"):
            Hq, RHOq, OKq = phase_a_tile(
                tuple(pre_rows[f] for f in (0, 1, 2, MASK)), s * s, p.m, kh=kh, cap=cap
            )
            # certified on the local rows (query mask) only
            qmask = planes[QMASK, 2 : 2 + qz, 1 : g + 1, cap : (g + 1) * cap].reshape(n_q, cap)
            rows_ok = torch.all((qmask <= 0) | (OKq > 0))
            h_p = Hq[qcell, slot]
            rho_p = RHOq[qcell, slot]
            rho_safe = torch.where(rho_p > 0, rho_p, torch.ones_like(rho_p))
            if cfg.eos == "polytropic":
                por2_p = K_l * rho_safe ** (p.gamma - 2.0)
                cs_p = torch.sqrt(p.gamma * K_l * rho_safe ** (p.gamma - 1.0))
            else:
                por2_p = p.cs0**2 / rho_safe
                cs_p = torch.zeros_like(rho_safe) + p.cs0

        # ---- halo exchange 2: phase-A outputs for the reverse mask ----
        fields2 = [h_p, rho_p, por2_p, cs_p]
        ups2 = [_gather_rows(fields2, *sel[2 * (r - 1)]) for r in range(1, hops + 1)]
        dns2 = [_gather_rows(fields2, *sel[2 * (r - 1) + 1]) for r in range(1, hops + 1)]
        recv2 = yield from _ring_sendrecv(ups2, dns2, n_dev, hops)

        # ---- the global half for the mesh and the tail width (joint: K2
        # needs the tail's sigma) ----
        if p3m:
            amax = torch.max(torch.where(valid_l[:, None], torch.abs(pos_l), zero))
            half_now = (yield request("pmax", amax)) * (1.0 + 1e-6) + 1e-30
            sigma = (2.0 * half_now / g / cfg.mesh_factor) * cfg.sigma_cells

        # ---- phase B (K2): forces + near-gravity correction term 1 (with
        # joint, a close pair's term 2 too) ----
        with stage("phase_b"):
            halo2 = torch.cat(recv2, dim=0)  # (2*hops*B, 4)
            pl = torch.zeros((4, Z + 1, gp, gp * cap), dtype=dtype, device=dev)
            pl[:, loc[0], loc[1], loc[2]] = torch.stack(fields2)
            pl[:, hsl[0], hsl[1], hsl[2]] = halo2.T
            planes[H : CS + 1] = pl[:, :Z]
            del pl
            fill_stack(planes[:, 1:], pre, qpl, H, CS + 1, qz, g, cap)
            qf = [qpl[f] for f in range(11)]
            qf[MASK] = qmask
            outs = torch.stack(phase_b_tiles(
                tuple(qf), tuple(pre_rows[f] for f in range(11)),
                p.m, p.alpha, p.beta, sigma if joint else None, eos=cfg.eos, p3m=False,
                cap=cap, joint=joint,
            ))
            del pre, pre_rows, qpl, qf

        # ---- far field ----
        if p3m:
            with stage("phase_c"):
                # ---- phase C (the tail kernel): (Newtonian - mesh shape);
                # joint: without the pairs phase B took it for ----
                w = tail_halfwidth(cfg.mesh_factor, cfg.sigma_cells)
                gpc = g + 2 * w
                n_pl = 5 if joint else 4
                tp = torch.zeros((n_pl, qz + 2 * w + 1, gpc, gpc * cap), dtype=dtype, device=dev)
                off = w - 2  # plane-local layer zl sits at zl - 2 + w
                for (zz, yy, xx), rank, live, vals, hv in (
                    ((zl, yc, xc), rank_l, live_l, pos_l, h_p),
                    ((hzl, hcell[:, 1], hcell[:, 0]), rank_h, live_h, hpos, halo2[:, 0]),
                ):
                    tz = zz + off
                    keep = live & (tz >= 0) & (tz < qz + 2 * w)
                    rows = [vals.T, torch.ones((1, vals.shape[0]), dtype=dtype, device=dev)]
                    if joint:
                        rows.append(hv[None])
                    tp[:, torch.where(keep, tz, qz + 2 * w), yy + w,
                       (xx + w) * cap + torch.clamp_max(rank, cap - 1)] = torch.cat(rows)
                outs[6:] += p3m_tail(
                    tp[:, : qz + 2 * w].contiguous(), p.m, sigma, grid=g, cap=cap,
                    halfwidth=w, nz=qz, skip_joint=joint,
                )
                del tp
            g_far, phi_far = yield from _p3m_mesh_sharded(
                pos_l, p.m * valid_l.to(dtype), valid_l, ghat, half_now,
                gm=cfg.mesh_gm, pad=cfg.mesh_pad,
            )
        else:
            g_far, phi_far = yield from _newton_ring(
                pos_l, valid_l, p.m, shard, n_dev, counts
            )

        ex = outs[:, qcell, slot]  # (10, n_loc)
        acc = ex[0:3].T
        gcorr = ex[6:9].T
        gphi_corr = ex[9]
        g_tot = g_far + gcorr
        phi = phi_far + gphi_corr
        acc = acc - g_tot  # G = 1 in code units

        ok_local = inbox & drift_ok & send_ok & (~overflow) & rows_ok
        n_ok = yield request("psum", ok_local.to(torch.int64))
        aux = dict(
            rho=rho_p, h=h_p, cs=cs_p, mu_max=ex[4], div_sum=ex[3], visc_dk=ex[5], phi=phi,
            g=g_tot,
        )
        return acc, aux, n_ok == n_dev

    return eval_forces


def _newton_ring(pos_l, valid_l, m, shard: int, n_dev: int, counts):
    """Pure-Newtonian all-pairs sweep as a ring over the shards' blocks (a
    generator body): the local rows query each block that rotates past,
    one rows x columns launch of K3 a round and one cyclic ppermute
    between rounds. Round r holds shard (shard - r) mod n_dev's block, so
    the host knows its real-row count: only real rows and columns are
    swept (padding rows get zeros; the caller masks them)."""
    blk = (pos_l, valid_l.to(pos_l.dtype))
    g = torch.zeros_like(pos_l)
    phi = torch.zeros_like(pos_l[:, 0])
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    for r in range(n_dev):
        with stage("gravity"):
            g_r, phi_r = newton_rows_cols(
                pos_l, blk[0], blk[1], m, n_rows=counts[shard],
                n_cols=counts[(shard - r) % n_dev],
            )
            g = g + g_r
            phi = phi + phi_r
        if r + 1 < n_dev:
            blk = yield request("ppermute", blk, perm=perm)
    return g, phi


def _p3m_mesh_sharded(pos_l, w_l, valid_l, ghat, half, *, gm: int, pad: int):
    """Sharded mesh solve (a generator body): each shard deposits its rows
    with mass weights w_l, the mesh is psummed, and every shard solves it
    and interpolates at its rows (physics/mesh_gravity.p3m_mesh_force with
    the deposit split over the shards)."""
    # padding rows deposit zero mass at the origin
    pos_d = torch.where(valid_l[:, None], pos_l, torch.zeros_like(pos_l))
    with stage("gravity"):
        rho, idx, w, a = mesh_deposit(pos_d, w_l, half, gm=gm, pad=pad)
    rho = yield request("psum", rho)
    with stage("gravity"):
        return mesh_solve(rho, idx, w, a, ghat, pad=pad, dtype=pos_l.dtype)


# ---------------------------------------------------------------------------
# Sharded step + chunk runner
# ---------------------------------------------------------------------------


def make_slab_chunk_runner(cfg: EngineConfig, plan: SlabPlan, mesh, joint_gravity: bool = False):
    """chunk(states, p, n_steps) -> (states', stats (S, 10), valid (S,),
    cert_fail (S,), h_rows, rho_rows): states is `pack_state`'s per-shard
    list (on a mesh across processes, the rank's shards' only:
    shard/mh_slabs.mh_pack); h_rows / rho_rows are the last committed
    step's per-shard (n_loc,) values (zeros before any).

    The host reads t < t_end once a step and the collective certificate
    once per force evaluation. A failed evaluation freezes the chunk: the
    step is not committed, reports cert_fail, and the rest of the chunk is
    skipped, so the host can re-plan the slabs and resume. Stats rows
    match polytrope_sim.jl:202. joint_gravity: make_slab_force_eval's."""
    if len(mesh) != plan.n_dev:
        raise ValueError(f"plan for {plan.n_dev} shards on a mesh of {len(mesh)}")
    eval_forces = make_slab_force_eval(cfg, plan, joint_gravity)
    n_total = cfg.n
    # this process's shards: all of them, or a rank's slice (shard/dist.py)
    shards, devs = local_shards(mesh), local_devices(mesh)
    ghats = [
        greens_hat(cfg.mesh_pad, cfg.sigma_cells, cfg.torch_dtype, d)
        if cfg.gravity == "p3m" else None
        for d in devs
    ]

    def local_step(p: Params, shard: int, st: SlabState, ghat):
        """One KDK step on one shard (a generator body); returns (state',
        stats, h, rho) or None when a force evaluation failed its
        certificate."""
        pos_l, vel_l, K_l, valid_l = st.pos, st.vel, st.K, st.valid
        dtype = pos_l.dtype
        vf = valid_l.to(dtype)
        acc, aux, ok1 = yield from eval_forces(p, shard, pos_l, vel_l, K_l, valid_l, ghat)
        if not bool(ok1):  # the host read of this evaluation's certificate
            return None
        big = torch.tensor(torch.finfo(dtype).max, dtype=dtype, device=pos_l.device)

        def lmin(x):
            return torch.min(torch.where(valid_l, x, big))

        vel_r2 = torch.sum(vel_l * vel_l, dim=1)
        a_r = torch.sqrt(torch.sum(acc * acc, dim=1))
        rho_s = torch.where(aux["rho"] > 0, aux["rho"], torch.ones_like(aux["rho"]))
        abs_div = torch.abs(-aux["div_sum"] / rho_s)
        c = yield request("pmin", torch.stack([
            lmin(1.0 / abs_div),
            lmin(aux["h"] / torch.sqrt(vel_r2)),
            lmin(torch.sqrt(aux["h"] / a_r)),
            lmin(aux["h"] / (aux["cs"] + 1.2 * (p.alpha * aux["cs"] + p.beta * aux["mu_max"]))),
        ]))
        dt = 0.3 * torch.minimum(torch.minimum(c[0], c[1]), torch.minimum(c[2], c[3]))

        if cfg.eos == "polytropic":
            u_l = torch.sum(vf * K_l / (p.gamma - 1.0) * rho_s ** (p.gamma - 1.0))
        else:
            u_l = torch.zeros_like(dt)
        sums = yield request("psum", (
            torch.sum(vf * vel_r2), torch.sum(vf * aux["phi"]), u_l,
            torch.sum(vf[:, None] * pos_l, dim=0), torch.sum(vf[:, None] * vel_l, dim=0),
        ))
        T = 0.5 * p.m * sums[0]
        V = 0.5 * p.m * sums[1]
        if cfg.eos == "polytropic":
            U = p.m * sums[2]
            Etot = T + V + U
        else:
            U = p.U0
            Etot = T + V + 2.0 * U
        r_com = sums[3] / n_total
        p_lin = p.m * sums[4]
        ang = p.m * (yield request("psum", torch.sum(
            vf[:, None] * torch.linalg.cross(pos_l - r_com, vel_l), dim=0
        )))
        stats = torch.stack([
            st.t, T, V, U, Etot, r_com[0], r_com[1], r_com[2],
            torch.sqrt(torch.sum(p_lin**2)), torch.sqrt(torch.sum(ang**2)),
        ])

        accm = acc * vf[:, None]
        pos_half = pos_l + vel_l * (dt / 2.0)
        vel_half = vel_l + accm * (dt / 2.0)
        if cfg.eos == "polytropic":
            K_l = K_l + (
                0.5 * (p.gamma - 1.0) / rho_s ** (p.gamma - 1.0) * aux["visc_dk"]
            ) * (dt / 2.0) * vf
        acc2, aux2, ok2 = yield from eval_forces(
            p, shard, pos_half, vel_half, K_l, valid_l, ghat
        )
        if not bool(ok2):
            return None
        rho2_s = torch.where(aux2["rho"] > 0, aux2["rho"], torch.ones_like(aux2["rho"]))
        if cfg.eos == "polytropic":
            K_l = K_l + (
                0.5 * (p.gamma - 1.0) / rho2_s ** (p.gamma - 1.0) * aux2["visc_dk"]
            ) * (dt / 2.0) * vf
        acc2m = acc2 * vf[:, None]
        vel_new = vel_l + acc2m * dt
        pos_new = pos_l + vel_new * dt - 0.5 * acc2m * dt**2
        st2 = SlabState(pos_new, vel_new, K_l, valid_l, st.t + dt)
        return st2, stats, aux2["h"], aux2["rho"]

    def chunk(states, p: Params, n_steps: int):
        ps = replicate(p, devs)
        dtype, dev = states[0].pos.dtype, states[0].pos.device
        stats = torch.zeros((n_steps, 10), dtype=dtype, device=dev)
        valid = torch.zeros((n_steps,), dtype=torch.bool, device=dev)
        cert = torch.zeros((n_steps,), dtype=torch.bool, device=dev)
        h = [torch.zeros_like(s.K) for s in states]
        rho = [torch.zeros_like(s.K) for s in states]
        for i in range(n_steps):
            if not bool(states[0].t < ps[0].t_end):
                break
            out = run_mesh(mesh, [
                local_step(ps[i], k, states[i], ghats[i]) for i, k in enumerate(shards)
            ])
            if out[0] is None:
                cert[i] = True  # frozen: the state stays, the host re-plans
                break
            states = [o[0] for o in out]
            h = [o[2] for o in out]
            rho = [o[3] for o in out]
            stats[i] = out[0][1]
            valid[i] = True
        return states, stats, valid, cert, h, rho

    return chunk
