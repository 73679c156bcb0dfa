"""Softened self-gravity as a blocked all-pairs sweep.

The reference walks a Barnes-Hut octree per particle (gravOctree_Single.jl:
239-278); here every pair is evaluated with the same softened kernels the
octree applies at its leaves (h_ij = (h_i + h_j)/2, gravOctree_Single.jl:
261-263) — the exact theta -> 0 limit of the reference, O(N^2) but regular.

Matches gravity_acc (gravOctree_Single.jl:280-304): self-pair excluded,
potential gets the -(7/5) m / h_i self-softening correction. Returned g is
*per unit G*; the caller applies acc -= G g (polytrope_sim.jl:43-45).

`gravity_newton_allpairs` is the main path's sweep: on a CUDA device it is
the hand-written kernel (kernels/cuda_gravity.py). `gravity_sweep` /
`gravity_allpairs` serve the gather fallback and stay plain torch, blocked
so the (block_q, block_c) pair temporaries stay bounded.
"""

from __future__ import annotations

import torch

from ..device import require_on, resolve_device
from ..kernels import softened_gphi_over_r, softened_phi
from ..kernels.cuda_gravity import newton_sweep


# (block_q, block_c) of the blocked sweeps by device type. The pair
# temporaries are block_q x block_c; on the CPU they stay small, on the
# card the sweep is bound by the number of launches, so blocks are 16x
# larger (~35 MB per float32 temporary).
PAIR_BLOCKS = {"cpu": (256, 2048), "cuda": (1024, 8192)}


def gravity_sweep(
    pos_q: torch.Tensor,
    h_q: torch.Tensor,
    qid: torch.Tensor,
    pos_cols: torch.Tensor,
    h_cols: torch.Tensor,
    *,
    block_q: int = None,
    block_c: int = None,
):
    """Blocked pair sweep of M query rows against N candidate columns.

    qid (M,) are the queries' *global* candidate indices, used to exclude
    the self pair (pass -1 for probe points that are not in the candidate
    set). Returns (g, phi) per unit mass and G: g_i = sum_j gphi d_ij,
    phi_i = sum_j phi_ij. Block sizes default to PAIR_BLOCKS of the
    tensors' device.
    """
    block_q = block_q or PAIR_BLOCKS[pos_q.device.type][0]
    block_c = block_c or PAIR_BLOCKS[pos_q.device.type][1]
    m_q = pos_q.shape[0]
    n = pos_cols.shape[0]
    dtype, device = pos_q.dtype, pos_q.device
    cx, cy, cz = (pos_cols[:, a].contiguous() for a in range(3))
    g = torch.empty((m_q, 3), dtype=dtype, device=device)
    phi = torch.empty((m_q,), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    for r0 in range(0, m_q, block_q):
        qpos = pos_q[r0 : r0 + block_q]
        qh = h_q[r0 : r0 + block_q]
        qids = qid[r0 : r0 + block_q]
        bq = qpos.shape[0]
        gx = torch.zeros((bq,), dtype=dtype, device=device)
        gy = torch.zeros_like(gx)
        gz = torch.zeros_like(gx)
        ph = torch.zeros_like(gx)
        for c0 in range(0, n, block_c):
            dx = qpos[:, 0:1] - cx[None, c0 : c0 + block_c]
            dy = qpos[:, 1:2] - cy[None, c0 : c0 + block_c]
            dz = qpos[:, 2:3] - cz[None, c0 : c0 + block_c]
            ch = h_cols[c0 : c0 + block_c]
            cid = torch.arange(c0, c0 + ch.shape[0], device=device)
            r = torch.sqrt(dx * dx + dy * dy + dz * dz)
            h_ij = 0.5 * (qh[:, None] + ch[None, :])
            valid = cid[None, :] != qids[:, None]
            gp = torch.where(valid, softened_gphi_over_r(r, h_ij), zero)
            pp = torch.where(valid, softened_phi(r, h_ij), zero)
            gx = gx + torch.sum(gp * dx, dim=1)
            gy = gy + torch.sum(gp * dy, dim=1)
            gz = gz + torch.sum(gp * dz, dim=1)
            ph = ph + torch.sum(pp, dim=1)
        g[r0 : r0 + bq] = torch.stack([gx, gy, gz], dim=1)
        phi[r0 : r0 + bq] = ph
    return g, phi


def gravity_newton_allpairs(pos: torch.Tensor, m, *, device=None):
    """Pure-Newtonian all-pairs sweep (g, PHI), self pair excluded via
    r = 0. The tile engine's near-field correction (physics/ctiles.py)
    turns this into the reference's softened gravity exactly. device=None
    means the card."""
    require_on(resolve_device(device), pos)
    return newton_sweep(pos.contiguous(), m)


def gravity_allpairs(
    pos: torch.Tensor,
    h: torch.Tensor,
    m,
    *,
    block_q: int = None,
    block_c: int = None,
):
    """(g, PHI) with g_i = sum_j m gphi(r_ij; h_ij) d_ij and
    PHI_i = sum_j m phi(r_ij; h_ij) - (7/5) m / h_i. Runs on the device
    of `pos`."""
    n = pos.shape[0]
    qid = torch.arange(n, device=pos.device)
    g, phi = gravity_sweep(
        pos, h, qid, pos, h, block_q=block_q, block_c=block_c
    )
    return m * g, m * phi - m * 1.4 / h
