"""Hierarchical Morton-grid kNN: experimental multi-level neighbor path.

STATUS: not on the production path, in the reference as here. The
engine's answer to strong h contrast is the ladder of physics/tiles.py
(with its outlier lane), physics/blocks.py and physics/mlevel.py. This
module is kept, with its tests, as the reference keeps it.

Replaces the reference's KD-tree (getNeighbors,
polytrope_hydroKDTree.jl:118-163) with the space-filling-curve layout GPU
SPH codes use (see PAPERS.md):

1.  One Morton sort of the particles on the finest grid (the sort is the
    only O(N log N) piece).
2.  Each particle searches the 27 neighbor cells *at its own level* of a
    power-of-two cell hierarchy, chosen so the cell edge is ~2.1x its
    previous smoothing length. Because coarse cells are Morton-prefix
    ranges, every level's cells are contiguous runs of the SAME sorted
    array — 27 searchsorted ranges per particle, no per-level re-sort.
3.  One top-k over the gathered candidates replaces the blocked sweep's
    per-tile merges.
4.  Exactness is certified per row: no truncated range and found k-th
    distance <= own cell edge (then the 27-cell block provably contains
    all true neighbors). Uncertified rows get a second pass one level
    coarser with a bigger capacity, under a fixed row budget.
5.  If the residual budget overflows, the whole call falls back to the
    exact blocked sweep (neighbors/knn.py) — bad hints degrade
    performance, never correctness. Overflows are reported in
    NeighborInfo, not silently dropped.

Keys are int32 (30 bits at most); the host reads the residual count and
the certificate once a call (the reference's lax.cond).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .knn import knn


class NeighborInfo(NamedTuple):
    certified: torch.Tensor  # bool: fast path provably exact (no full fallback)
    n_residual: torch.Tensor  # int32: rows that needed the coarser second pass
    fell_back: torch.Tensor  # bool: full blocked fallback was used


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _spread_bits10(v: torch.Tensor) -> torch.Tensor:
    """Space the low 10 bits of v three apart (Morton component)."""
    v = v.to(torch.int32)
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3(cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor) -> torch.Tensor:
    """30-bit Morton key (int32) from 10-bit cell coordinates."""
    return _spread_bits10(cx) | (_spread_bits10(cy) << 1) | (_spread_bits10(cz) << 2)


def _candidate_pass(
    pos, pos_sorted, sorted_keys, order, coords, level, g0_log2: int, k, cap, row_block
):
    """One candidate-gather + select pass at the given per-row level.

    coords: (M, 3) finest-grid integer coords of each query row (int32).
    level: (M,) per-row level (0 = finest). Returns (idx, r_kth, ok_row):
    neighbor indices in original numbering, k-th distance, and a per-row
    flag that the search was provably exhaustive (no truncation, k found).
    """
    n = pos_sorted.shape[0]
    m_rows = pos.shape[0]
    dtype, dev = pos.dtype, pos.device
    big = torch.finfo(dtype).max
    nc = 27 * cap

    # coarse coords of each row at its level
    shift = level.to(torch.int32)
    ccoords = coords >> shift[:, None]
    g_level = torch.ones_like(shift) << (g0_log2 - shift)  # cells per edge at level

    lo_list, hi_list = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                xx = ccoords[:, 0] + dx
                yy = ccoords[:, 1] + dy
                zz = ccoords[:, 2] + dz
                ok = (
                    (xx >= 0) & (xx < g_level)
                    & (yy >= 0) & (yy < g_level)
                    & (zz >= 0) & (zz < g_level)
                )
                top = g_level - 1
                mk = morton3(
                    torch.minimum(torch.clamp_min(xx, 0), top),
                    torch.minimum(torch.clamp_min(yy, 0), top),
                    torch.minimum(torch.clamp_min(zz, 0), top),
                )
                zero = torch.zeros_like(mk)
                lo_list.append(torch.where(ok, mk << (3 * shift), zero))
                hi_list.append(torch.where(ok, (mk + 1) << (3 * shift), zero))
    lo = torch.stack(lo_list, dim=1)  # (M, 27) fine-key lower bounds
    hi = torch.stack(hi_list, dim=1)

    starts = torch.searchsorted(sorted_keys, lo).to(torch.int32)
    ends = torch.searchsorted(sorted_keys, hi).to(torch.int32)
    truncated = torch.any((ends - starts) > cap, dim=1)

    xs, ys, zs = pos_sorted[:, 0], pos_sorted[:, 1], pos_sorted[:, 2]
    span = torch.arange(cap, dtype=torch.int32, device=dev)[None, None, :]
    idx_out, d2k_out, nvalid_out = [], [], []
    for r0 in range(0, m_rows, row_block):
        st, en, qp = starts[r0 : r0 + row_block], ends[r0 : r0 + row_block], pos[r0 : r0 + row_block]
        raw = st[:, :, None] + span
        valid = (raw < en[:, :, None]).reshape(-1, nc)
        cand_s = torch.clamp_max(raw, n - 1).reshape(-1, nc).to(torch.int64)
        dx = qp[:, 0:1] - xs[cand_s]
        dy = qp[:, 1:2] - ys[cand_s]
        dz = qp[:, 2:3] - zs[cand_s]
        d2 = dx * dx + dy * dy + dz * dz
        d2 = torch.where(valid, d2, torch.full_like(d2, big))
        top, sel = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        idx_out.append(order[torch.gather(cand_s, 1, sel)])
        d2k_out.append(torch.clamp_min(top[:, -1], 0.0))
        nvalid_out.append(torch.sum(valid, dim=1))
    idx_c = torch.cat(idx_out)
    r_kth = torch.sqrt(torch.cat(d2k_out))
    ok_row = (~truncated) & (torch.cat(nvalid_out) >= k)
    return idx_c, r_kth, ok_row


def _celllist_rows(pos, k, h_hint, *, cap, cap_residual, g0_log2_max, safety, row_block):
    """The two candidate passes of knn_celllist, before its fallback:
    (idx (N, k), row_cert (N,) bool, n_res, budget). row_cert marks the rows
    whose neighbours either pass proved exact; n_res rows needed the second
    pass, of which the first `budget` ran it."""
    n = pos.shape[0]
    dtype = pos.dtype
    g0 = 1 << g0_log2_max

    half = torch.max(torch.abs(pos)) * (1.0 + 1e-6) + 1e-30
    s0 = 2.0 * half / g0

    coords = torch.clamp(torch.floor((pos + half) / s0).to(torch.int32), 0, g0 - 1)
    keys = morton3(coords[:, 0], coords[:, 1], coords[:, 2])
    order = torch.argsort(keys, stable=True)
    sorted_keys = keys[order].contiguous()
    pos_sorted = pos[order]

    # per-row level: smallest level whose cell edge >= safety * 2 h
    need = safety * 2.0 * h_hint.to(dtype)
    level = torch.clamp(
        torch.ceil(torch.log2(torch.clamp_min(need / s0, 1.0))), 0, g0_log2_max
    ).to(torch.int32)
    s_level = s0 * (2.0 ** level.to(dtype))

    idx, rk_a, ok_a = _candidate_pass(
        pos, pos_sorted, sorted_keys, order, coords, level, g0_log2_max, k, cap,
        row_block,
    )
    row_cert = ok_a & (rk_a <= s_level)

    # residual: one level coarser, bigger capacity, only flagged rows
    level_b = torch.clamp_max(level + 1, g0_log2_max)
    s_level_b = s0 * (2.0 ** level_b.to(dtype))
    budget = max(_ceil_to(max(n // 16, 64), 8), 8)
    res_all = torch.nonzero(~row_cert).flatten()
    n_res = res_all.numel()

    if n_res > 0:
        res_rows = res_all[:budget]
        idx_b, rk_b, ok_b = _candidate_pass(
            pos[res_rows], pos_sorted, sorted_keys, order, coords[res_rows],
            level_b[res_rows], g0_log2_max, k, cap_residual, min(512, budget),
        )
        cert_b = ok_b & (rk_b <= s_level_b[res_rows])
        idx = idx.clone()
        idx[res_rows[cert_b]] = idx_b[cert_b]
        row_cert = row_cert.clone()
        row_cert[res_rows] = cert_b
    return idx, row_cert, n_res, budget


def knn_celllist(
    pos: torch.Tensor,
    k: int,
    h_hint: torch.Tensor,
    *,
    cap: int = 128,
    cap_residual: int = 512,
    g0_log2_max: int = 9,
    safety: float = 1.05,
    row_block: int = 8192,
):
    """Exact kNN of pos against itself. Returns (idx (N, k) int64 sorted by
    approximate distance ascending — self first, NeighborInfo)."""
    idx, row_cert, n_res, budget = _celllist_rows(
        pos, k, h_hint, cap=cap, cap_residual=cap_residual, g0_log2_max=g0_log2_max,
        safety=safety, row_block=row_block,
    )
    certified = n_res <= budget and bool(row_cert.all())
    if not certified:
        idx = knn(pos, pos, k)[0]
    dev = pos.device
    return idx, NeighborInfo(
        torch.tensor(certified, device=dev),
        torch.tensor(n_res, dtype=torch.int32, device=dev),
        torch.tensor(not certified, device=dev),
    )
