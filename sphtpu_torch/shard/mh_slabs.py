"""The state-sharded z-slab layer across processes: N scales with ranks.

Port of sphtpu/shard/mh_slabs.py. The driver's multi-process mode
(shard/multihost.py) keeps the whole state on every rank; this layer shards
the state itself: a rank's host memory and its shards only ever hold the
slab rows its shards own (plus the engine's fixed-size halo buffers).

*   Planning is rank-local plus small all-gathers. Every rank computes
    histograms of its own rows (z-layer counts, cell occupancies, max |pos|,
    max h) at the shared candidate grid; the sums over the ranks go through
    `plan_slabs_from_hists`, the core of the one-process planner, so every
    rank derives the same SlabPlan, with `order=None` and the real rows a
    shard in `rows`.
*   `mh_pack` / `mh_unpack` touch only local rows: a rank fills only its
    own shards' (n_loc, ...) buffers, each shard's rows in global id order
    (the order `plan_slabs` gives them, so a chunk equals the one-process
    chunk bit for bit), and reads back only its own shards.
*   Row migration at plan boundaries (`mh_migrate`) all-gathers the movers
    only: rows whose new owner is another rank, padded to the largest mover
    count. At bootstrap the same path shuffles any initial split into slab
    ownership.

The chunk runner is shard/tiles.make_slab_chunk_runner, unchanged, over the
mesh across processes (multihost.global_mesh). As in the reference, the
driver does not use this layer: the tests and chip_smoke.py drive it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .collectives import local_shards
from .dist import process_allgather, world
from .tiles import SlabPlan, SlabState, plan_slabs_from_hists


class LocalRows(NamedTuple):
    """One rank's particle rows (host numpy, any order). `gid` is the global
    particle id: it never leaves the host, and it lets snapshots and tests
    reassemble a globally ordered state from the ranks' pieces."""

    pos: np.ndarray  # (nl, 3) float64
    vel: np.ndarray  # (nl, 3)
    K: np.ndarray  # (nl,)
    h: np.ndarray  # (nl,)
    gid: np.ndarray  # (nl,) int64


def _allgather_sum(arrs):
    """Sum of each (same shape on every rank) numpy array over the ranks, in
    one all-gather."""
    if world()[1] == 1:
        return list(arrs)
    flat = np.concatenate([np.asarray(a, np.float64).ravel() for a in arrs])
    summed = np.sum(process_allgather(flat), axis=0)
    out, off = [], 0
    for a in arrs:
        a = np.asarray(a)
        out.append(summed[off : off + a.size].reshape(a.shape))
        off += a.size
    return out


def _allgather_max(vals):
    """Elementwise max of a small float vector over the ranks."""
    return np.max(process_allgather(np.asarray(vals, np.float64)), axis=0)


def mh_plan_slabs(
    local: LocalRows,
    kh: int,
    n_dev: int,
    *,
    chunk_steps: int = 10,
    safety: float = 1.05,
    cap_max: int = 256,
    headroom: float = 1.25,
    slots_max: int = 12_000_000,
) -> Optional[SlabPlan]:
    """The multi-process twin of shard.tiles.plan_slabs: the same geometry
    (plan_slabs_from_hists on the summed histograms), with `order=None`
    (ownership is rank-local, see mh_pack) and the real rows a shard in
    `rows`."""
    pos = np.asarray(local.pos, np.float64)
    h = np.asarray(local.h, np.float64)
    nl = pos.shape[0]

    maxes = _allgather_max([
        float(np.abs(pos).max()) if nl else 0.0,
        float(h.max()) if nl else 0.0,
    ])
    half = float(maxes[0]) * (1.0 + 1e-6) * 1.02
    hmax = float(maxes[1])
    g = max(int(2.0 * half / (safety * 2.0 * hmax)), 2)
    if g < n_dev:
        return None
    s = 2.0 * half / g
    c = np.clip((pos + half) // s, 0, g - 1).astype(np.int64)
    cells = (c[:, 2] * g + c[:, 1]) * g + c[:, 0]
    cell_counts = np.bincount(cells, minlength=g**3).astype(np.float64)
    layer_counts = np.bincount(c[:, 2], minlength=g).astype(np.float64)
    n_f = np.asarray([float(nl)])
    cell_counts, layer_counts, n_f = _allgather_sum([cell_counts, layer_counts, n_f])
    n = int(round(float(n_f[0])))
    cmax = int(round(float(cell_counts.max())))
    layer_counts = layer_counts.astype(np.int64)

    geo = plan_slabs_from_hists(
        n, half, g, layer_counts, cmax, n_dev,
        chunk_steps=chunk_steps, cap_max=cap_max, headroom=headroom, slots_max=slots_max,
    )
    if geo is None:
        return None
    cum = np.concatenate([[0], np.cumsum(layer_counts)])
    z0s = geo["z0s"]
    return SlabPlan(
        grid=g, cap=geo["cap"], lz_max=geo["lz_max"], halo=geo["halo"],
        hops=geo["hops"], budget=geo["budget"], n_loc=geo["n_loc"],
        n_dev=n_dev, half=half, z0s=z0s,
        order=None,  # ownership is rank-local
        rows=tuple(int(cum[z0s[p + 1]] - cum[z0s[p]]) for p in range(n_dev)),
    )


def _dev_of_rows(pos: np.ndarray, plan: SlabPlan) -> np.ndarray:
    s = 2.0 * plan.half / plan.grid
    zc = np.clip((pos[:, 2] + plan.half) // s, 0, plan.grid - 1).astype(np.int64)
    return np.searchsorted(plan.z0s, zc, side="right") - 1


def _local_range(mesh):
    """This rank's contiguous [d0, d1) of the (rank-major) mesh."""
    shards = local_shards(mesh)
    return shards.start, shards.stop


def mh_migrate(local: LocalRows, plan: SlabPlan, mesh) -> LocalRows:
    """Re-home rows to their owner rank under `plan` with one all-gather of
    the movers (padded to the largest mover count). Stayers never leave
    the host."""
    if world()[1] == 1:
        return local
    d0, d1 = _local_range(mesh)
    dev = _dev_of_rows(np.asarray(local.pos, np.float64), plan)
    stay = (dev >= d0) & (dev < d1)
    movers = ~stay
    n_mov = int(movers.sum())
    max_mov = int(process_allgather(np.asarray([n_mov], np.int64)).max())
    keep = LocalRows(*(np.asarray(f)[stay] for f in local))
    if max_mov == 0:
        return keep

    # one (n_ranks, max_mov, 9) all-gather: pos3 + vel3 + K + h + gid
    pack = np.zeros((max_mov, 9), np.float64)
    pack[:n_mov, 0:3] = local.pos[movers]
    pack[:n_mov, 3:6] = local.vel[movers]
    pack[:n_mov, 6] = local.K[movers]
    pack[:n_mov, 7] = local.h[movers]
    pack[:n_mov, 8] = local.gid[movers].astype(np.float64)
    pack[n_mov:, 8] = -1.0  # gid >= 0 always; -1 marks padding rows
    all_pack = process_allgather(pack).reshape(-1, 9)
    real = all_pack[:, 8] >= 0
    inc_dev = _dev_of_rows(all_pack[real, 0:3], plan)
    inc = all_pack[real][(inc_dev >= d0) & (inc_dev < d1)]
    return LocalRows(
        pos=np.concatenate([keep.pos, inc[:, 0:3]]),
        vel=np.concatenate([keep.vel, inc[:, 3:6]]),
        K=np.concatenate([keep.K, inc[:, 6]]),
        h=np.concatenate([keep.h, inc[:, 7]]),
        gid=np.concatenate([keep.gid, inc[:, 8].astype(np.int64)]),
    )


class LocalLayout(NamedTuple):
    """A rank's slot assignment for one packed chunk: row i of the rank's
    buffers (its shards' n_loc rows each, in order) holds local row `src[i]`
    (-1: padding)."""

    src: np.ndarray  # (local shards * n_loc,) int64 into LocalRows, -1 pad
    gid: np.ndarray  # (local shards * n_loc,) int64 global ids, -1 pad
    d0: int
    d1: int


def mh_pack(local: LocalRows, plan: SlabPlan, mesh, dtype, t=0.0):
    """(this rank's shards' SlabStates, LocalLayout) from the rank's own rows
    only: each shard's real rows first, in global id order, then padding.
    Rows must already be owned (mh_migrate)."""
    d0, d1 = _local_range(mesh)
    dev = _dev_of_rows(np.asarray(local.pos, np.float64), plan)
    if not bool(np.all((dev >= d0) & (dev < d1))):
        raise ValueError("rows not migrated: a row belongs to another rank's shard")
    n_loc = plan.n_loc
    src = np.full((d1 - d0) * n_loc, -1, np.int64)
    for k, d in enumerate(range(d0, d1)):
        rows = np.flatnonzero(dev == d)
        if rows.size > n_loc:
            raise ValueError(f"shard {d}: {rows.size} rows exceed n_loc={n_loc}")
        rows = rows[np.argsort(local.gid[rows], kind="stable")]
        src[k * n_loc : k * n_loc + rows.size] = rows
    valid = src >= 0
    safe = np.maximum(src, 0)
    gid = np.where(valid, np.asarray(local.gid)[safe], -1)

    def buf(a, k, d):
        a = np.asarray(a)[safe[k * n_loc : (k + 1) * n_loc]]
        v = valid[k * n_loc : (k + 1) * n_loc]
        a = np.where(v if a.ndim == 1 else v[:, None], a, 0.0)
        return torch.as_tensor(a).to(device=d, dtype=dtype)

    states = []
    for k, d in enumerate(mesh[i] for i in range(d0, d1)):
        states.append(SlabState(
            pos=buf(local.pos, k, d), vel=buf(local.vel, k, d), K=buf(local.K, k, d),
            valid=torch.as_tensor(valid[k * n_loc : (k + 1) * n_loc]).to(d),
            t=torch.as_tensor(t, dtype=dtype).to(d),
        ))
    return states, LocalLayout(src=src, gid=gid, d0=d0, d1=d1)


def mh_unpack(arrs, layout: LocalLayout) -> np.ndarray:
    """This rank's rows of a chunk output (its shards' (n_loc, ...) tensors,
    in shard order) as one host array in the packed slot order of `layout`
    (padding included)."""
    return np.concatenate([a.detach().cpu().numpy() for a in arrs], axis=0)


def mh_local_rows(states, h_rows, layout: LocalLayout) -> LocalRows:
    """LocalRows (compacted, padding dropped) from a chunk's output states:
    the host handoff between chunks and into mh_plan_slabs."""
    valid = layout.src >= 0

    def rows(arrs):
        return mh_unpack(arrs, layout)[valid].astype(np.float64)

    return LocalRows(
        pos=rows([s.pos for s in states]), vel=rows([s.vel for s in states]),
        K=rows([s.K for s in states]), h=rows(h_rows), gid=layout.gid[valid],
    )


def gather_to_primary(local: LocalRows, n: int):
    """The full state (dict of pos, vel, K, h in global id order) on rank 0
    only; other ranks return None. One all-gather, at snapshot cadence: the
    one place the global state materialises, and only on the I/O rank."""
    rank, n_ranks = world()
    nl = local.gid.shape[0]
    if n_ranks == 1:
        allp = None
    else:
        max_nl = int(process_allgather(np.asarray([nl], np.int64)).max())
        pack = np.full((max_nl, 9), -1.0, np.float64)
        pack[:nl, 0:3] = local.pos
        pack[:nl, 3:6] = local.vel
        pack[:nl, 6] = local.K
        pack[:nl, 7] = local.h
        pack[:nl, 8] = local.gid.astype(np.float64)
        allp = process_allgather(pack).reshape(-1, 9)
        if rank != 0:
            return None
    out = {"pos": np.zeros((n, 3)), "vel": np.zeros((n, 3)), "K": np.zeros(n), "h": np.zeros(n)}
    if allp is None:
        for k in out:
            out[k][local.gid] = getattr(local, k)
        return out
    real = allp[:, 8] >= 0
    gid = allp[real, 8].astype(np.int64)
    out["pos"][gid] = allp[real, 0:3]
    out["vel"][gid] = allp[real, 3:6]
    out["K"][gid] = allp[real, 6]
    out["h"][gid] = allp[real, 7]
    return out
