"""The outlier lane: exact handling of the large-h particles that do not
fit the mono-tile certificate (h <= cell/2).

During a collapse the smoothing-length distribution stretches: the dense
core wants a fine grid while the envelope's h stays large. The mono-tile
engine with an outlier budget sizes its grid from the BULK of the h
distribution (`tiles.choose_tile_params_ml`), and the few large-h
"outlier" rows (h_hint * OUTLIER_CUT > cell edge) take this exact O(B*N)
lane:

  - `outlier_knn`: exact kNN of the outlier rows against all particles ->
    h, rho (the gather engine's semantics, polytrope_hydroKDTree.jl:118-178);
  - `outlier_forces`: the reference's symmetric pair scatter for outlier
    rows (hydroCalculation, :222-248): the row adds -ct dW(h_row) over its
    kNN and scatters +ct dW(h_row) to each neighbour; the tile engine's pair
    kernel leaves outlier SOURCES out of its reverse mask (and outlier
    QUERIES out of its forward mask), so each pair is counted once;
  - `outlier_gravity_corr`: the softened-minus-Newtonian correction of
    pairs with an outlier member at cell distance > 1, beyond the 27-cell
    pass of the pair kernel (2 h_avg > cell edge only happens when one
    member is an outlier).

Everything here is exact, so outliers never cost correctness, only B*N
work; `tile_sph_forces` certifies n_out <= budget. The engine passes the
real outlier rows (`tile_sph_forces` reads their count once an
evaluation). `outlier_knn` and `outlier_forces` also take the reference's
padded rows (rows >= N add nothing); `outlier_gravity_corr` takes real
rows only. The O(B*N) gravity sweeps run in blocks whose pair temporaries
hold at most OUT_CHUNK elements, and evaluate their terms only on the pairs
a mask keeps: each block reads its kept-pair count on the host (about 140
blocks an evaluation at N = 1e5 with 26 921 outliers).
"""

from __future__ import annotations

import torch

from ..kernels import W, grad_W_over_r, softened_gphi_over_r, softened_phi
from ..neighbors import knn

# species cut: rows with h_hint * OUTLIER_CUT > cell edge take the outlier
# lane. 2.0 is the certification bound (h <= s/2); the 7% margin keeps
# h drift within a chunk from flipping certified rows into failures.
OUTLIER_CUT = 2.0 * 1.07

# elements of a (receivers, sources) pair temporary in the gravity sweeps:
# 2^25 float32 elements are 128 MiB, and a block keeps about eight alive
OUT_CHUNK = 1 << 25


def outlier_knn(pos, out_rows, m, kh: int):
    """Exact kNN density pass for the outlier rows.

    out_rows: (B,) global row indices (>= N marks padding). Returns
    (idx (B, kh) neighbour indices, h (B,), rho (B,)); values at padded rows
    are harmless garbage the caller masks. r is recomputed from the indices,
    as the reference does, not taken as the square root of the returned
    d2."""
    n = pos.shape[0]
    safe = torch.clamp_max(out_rows, n - 1)
    q = pos[safe]
    idx, _ = knn(q, pos, kh)
    dx = q[:, 0:1] - pos[:, 0][idx]
    dy = q[:, 1:2] - pos[:, 1][idx]
    dz = q[:, 2:3] - pos[:, 2][idx]
    r = torch.sqrt(dx * dx + dy * dy + dz * dz)
    h = torch.max(r, dim=1).values / 2.0
    hcol = h[:, None]
    rho = m * torch.sum(W(r / hcol, hcol), dim=1)
    return idx, h, rho


def outlier_forces(
    pos, vel, out_rows, idx, h_all, rho_all, por2_all, cs_all, m,
    *, eos: str, alpha, beta,
):
    """Pair forces for outlier rows with the reference's symmetric scatter.

    h_all/rho_all/por2_all/cs_all: merged per-particle fields (tile values
    with outlier rows overwritten by the kNN pass). Returns
    (row = dict(acc, mu_max, div_sum, visc_dk) over the B rows,
     scat = dict(ax, ay, az, visc) (N,) buffers to add to every particle).
    Padded rows (out_rows >= N) contribute nothing."""
    n = pos.shape[0]
    dtype, dev = pos.dtype, pos.device
    safe = torch.clamp_max(out_rows, n - 1)
    row_valid = (out_rows < n)[:, None]
    zero = torch.zeros((), dtype=dtype, device=dev)

    q = pos[safe]
    qv = vel[safe]
    h_c = h_all[safe][:, None]
    rho_c = rho_all[safe][:, None]
    por2_c = por2_all[safe][:, None]
    cs_c = cs_all[safe][:, None]

    dx = q[:, 0:1] - pos[:, 0][idx]
    dy = q[:, 1:2] - pos[:, 1][idx]
    dz = q[:, 2:3] - pos[:, 2][idx]
    r = torch.sqrt(dx * dx + dy * dy + dz * dz)
    h_avg = 0.5 * (h_c + h_all[idx])
    rho_avg = 0.5 * (rho_c + rho_all[idx])
    vij_x = qv[:, 0:1] - vel[:, 0][idx]
    vij_y = qv[:, 1:2] - vel[:, 1][idx]
    vij_z = qv[:, 2:3] - vel[:, 2][idx]
    v_dot_r = vij_x * dx + vij_y * dy + vij_z * dz
    mu = torch.clamp_max(h_avg * v_dot_r / (r * r + 0.01 * h_avg**2), 0.0)
    Pi = (-alpha * cs_c * mu + beta * mu**2) / rho_avg

    dWdr = grad_W_over_r(r / h_c, r, h_c)
    if eos == "polytropic":
        ct = m * (por2_c + por2_all[idx] + Pi) / 2.0
    else:
        ct = m * (por2_c + Pi / 2.0)
    dead = (idx == out_rows[:, None]) | ~row_valid  # self pairs and padding
    ct = torch.where(dead, zero, ct)

    coeff = ct * dWdr
    # padding rows scatter into a dropped extra slot
    flat_idx = torch.where(row_valid, idx, n).reshape(-1)

    def scatter(v):
        buf = torch.zeros((n + 1,), dtype=dtype, device=dev)
        buf.index_add_(0, flat_idx, v.reshape(-1))
        return buf[:n]

    scat = {}
    accs = []
    for name, dax in (("ax", dx), ("ay", dy), ("az", dz)):
        contrib = coeff * dax
        accs.append(-torch.sum(contrib, dim=1))
        scat[name] = scatter(contrib)
    v_dot_dW = v_dot_r * dWdr
    ct_k = torch.where(dead, zero, m * Pi * v_dot_dW / 2.0)
    scat["visc"] = scatter(ct_k)
    big = torch.finfo(dtype).max
    row = dict(
        acc=torch.stack(accs, dim=1),
        mu_max=torch.max(torch.where(row_valid, mu, -big), dim=1).values,
        div_sum=torch.sum(torch.where(row_valid, m * v_dot_dW, zero), dim=1),
        visc_dk=torch.sum(ct_k, dim=1),
    )
    return row, scat


def _cells(pos, half, s, g: int):
    """Tile-grid cell coordinates, bit-identical to tiles._bin_particles."""
    return torch.clamp(torch.floor((pos + half) / s).to(torch.int64), 0, g - 1)


def _far_corr(rpos, rh, rcell, spos, sh, scell):
    """Sums over sources of the (softened - Newtonian) correction of every
    (receiver, source) pair at cell distance > 1: (4, receivers) sums of
    cg dx, cg dy, cg dz and cp, without the factor m.

    Beyond q = r / h_avg = 2 the softened forms equal the Newtonian ones
    exactly, so a block keeps only its pairs with d2 <= (2 h_avg)^2 (with a
    margin, so that no pair with q <= 2 is lost to rounding; a kept pair
    with q > 2 adds exact zeros) and evaluates the reference's terms on
    them."""
    dtype, dev = rpos.dtype, rpos.device
    out = torch.zeros((4, rpos.shape[0]), dtype=dtype, device=dev)
    ns = spos.shape[0]
    if ns == 0 or rpos.shape[0] == 0:
        return out
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    rb = max(1, OUT_CHUNK // ns)
    for r0 in range(0, rpos.shape[0], rb):
        pq = rpos[r0 : r0 + rb]
        dx = pq[:, 0:1] - spos[None, :, 0]
        dy = pq[:, 1:2] - spos[None, :, 1]
        dz = pq[:, 2:3] - spos[None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz
        del dx, dy, dz
        reach = rh[r0 : r0 + rb, None] + sh[None, :]  # 2 h_avg
        keep = d2 <= reach * reach * 1.0001
        del d2, reach
        i, j = torch.nonzero(keep, as_tuple=True)  # the block's host read
        del keep
        i_r = i + r0
        # pairs at cell distance <= 1 are the pair kernel's: they add zeros
        near = ((rcell[i_r] - scell[j]).abs() <= 1).all(dim=1)
        dx = rpos[i_r, 0] - spos[j, 0]
        dy = rpos[i_r, 1] - spos[j, 1]
        dz = rpos[i_r, 2] - spos[j, 2]
        h_avg = 0.5 * (rh[i_r] + sh[j])
        r2 = dx * dx + dy * dy + dz * dz
        r = torch.sqrt(r2)
        r_safe = torch.where(r2 > 0, r, one)
        newt_g = torch.where(r2 > 0, 1.0 / r_safe**3, zero)
        newt_p = torch.where(r2 > 0, -1.0 / r_safe, zero)
        cg = torch.where(near, zero, softened_gphi_over_r(r, h_avg) - newt_g)
        cp = torch.where(near, zero, softened_phi(r, h_avg) - newt_p)
        out.index_add_(1, i_r, torch.stack([cg * dx, cg * dy, cg * dz, cp]))
    return out


def outlier_gravity_corr(pos, h_all, rows, m, half, s, g: int):
    """(softened - Newtonian) corrections for pairs involving an outlier
    at cell distance > 1 (outside the pair kernel's 27-cell term-1 pass).

    rows: (B,) the real outlier rows, each once, ascending (the reference's
    out_rows without its padding and is_out as a list). Sweep 1: every
    particle receives corrections from outlier sources. Sweep 2: outlier
    rows receive corrections from non-outlier sources (outlier-outlier
    pairs are fully covered by sweep 1). Returns (dg (N, 3), dphi (N,)) to
    ADD to the gravity-correction accumulators."""
    n = pos.shape[0]
    cell_all = _cells(pos, half, s, g)

    # sweep 1: all N receivers x the outlier sources
    acc = _far_corr(pos, h_all, cell_all, pos[rows], h_all[rows], cell_all[rows])
    s1 = m * acc

    # sweep 2: the outlier receivers x the non-outlier sources, in
    # ascending order (a stable sort of the is-outlier mask puts them first;
    # their count is known, so the host reads nothing)
    is_out = torch.zeros((n,), dtype=torch.bool, device=pos.device)
    is_out[rows] = True
    src = torch.argsort(is_out.to(torch.int8), stable=True)[: n - rows.numel()]
    acc2 = _far_corr(pos[rows], h_all[rows], cell_all[rows], pos[src], h_all[src],
                     cell_all[src])
    s1.index_add_(1, rows, m * acc2)
    return s1[:3].T, s1[3]
