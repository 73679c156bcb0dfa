"""Exact k-nearest-neighbor search as a blocked sweep.

Replaces the reference's NearestNeighbors.jl KD-tree (getNeighbors,
polytrope_hydroKDTree.jl:118-163) with a dense, tiled running-top-k:

  for each query row block (Bq, 3):
      for each planar candidate column block (x/y/z, each (Bc,)):
          d2 = dx*dx + dy*dy + dz*dz              (exact per-axis diffs)
          merge into the running (Bq, K) best via topk

O(M*N) work with (Bq, Bc) temporaries. This module is the always-correct
fallback engine's neighbor search and the oracle in tests; the production
neighbor path is the class-compacted tile engine (physics/ctiles.py). The
per-axis diff form (not the |q|^2+|c|^2-2qc matmul form) is deliberate:
it is exact in f32 where the matmul form loses low bits to cancellation,
so the returned d2 can be trusted directly.
"""

from __future__ import annotations

import torch


# (block_q, block_c) by device type: small temporaries on the CPU, fewer
# and larger top-k merges on the card
KNN_BLOCKS = {"cpu": (512, 2048), "cuda": (2048, 8192)}


def knn(
    ri: torch.Tensor,
    rj: torch.Tensor,
    k: int,
    *,
    block_q: int = None,
    block_c: int = None,
):
    """k nearest neighbors of each row of ri among the rows of rj.

    Returns (idx, d2): idx (M, k) int64 sorted by squared distance
    ascending (self first when ri is rj), d2 (M, k) exact per-axis-diff
    squared distances (naturally >= 0). Block sizes default to KNN_BLOCKS
    of the tensors' device.
    """
    block_q = block_q or KNN_BLOCKS[ri.device.type][0]
    block_c = block_c or KNN_BLOCKS[ri.device.type][1]
    m_q = ri.shape[0]
    n_c = rj.shape[0]
    if k > n_c:
        raise ValueError(f"k={k} exceeds candidate count {n_c}")
    cx, cy, cz = (rj[:, a].contiguous() for a in range(3))
    big = torch.finfo(ri.dtype).max
    out_i = []
    out_d = []
    for r0 in range(0, m_q, block_q):
        qb = ri[r0 : r0 + block_q]
        bq = qb.shape[0]
        best_d = torch.full((bq, k), big, dtype=ri.dtype, device=ri.device)
        best_i = torch.full((bq, k), -1, dtype=torch.int64, device=ri.device)
        for c0 in range(0, n_c, block_c):
            dx = qb[:, 0:1] - cx[None, c0 : c0 + block_c]
            dy = qb[:, 1:2] - cy[None, c0 : c0 + block_c]
            dz = qb[:, 2:3] - cz[None, c0 : c0 + block_c]
            d2 = dx * dx + dy * dy + dz * dz
            col_idx = torch.arange(
                c0, c0 + d2.shape[1], dtype=torch.int64, device=ri.device
            )
            cat_d = torch.cat([best_d, d2], dim=1)
            cat_i = torch.cat([best_i, col_idx.expand(bq, -1)], dim=1)
            best_d, pos = torch.topk(cat_d, k, dim=1, largest=False, sorted=True)
            best_i = torch.gather(cat_i, 1, pos)
        out_i.append(best_i)
        out_d.append(best_d)
    idx = torch.cat(out_i, dim=0)
    d2 = torch.clamp_min(torch.cat(out_d, dim=0), 0.0)
    return idx, d2
