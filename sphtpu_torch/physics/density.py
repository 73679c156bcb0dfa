"""SPH density sampled at arbitrary points (the radial-profile probe).

Equivalent of HJL.density_plot (polytrope_hydroKDTree.jl:344-350): kNN of M
sample points against the particle set, h = (distance to the Kh-th
neighbor)/2, cubic-spline weight sum. Runs on the tensors' device in code
units. (The run loop samples its snapshots' profiles on the host instead,
scenes/setup.py::host_density_at.)
"""

from __future__ import annotations

import torch

from ..kernels import W
from ..neighbors import knn


def density_at(rr: torch.Tensor, pos: torch.Tensor, m, kh: int) -> torch.Tensor:
    """Density at the (M, 3) points rr from the (N, 3) particles pos."""
    idx, _ = knn(rr, pos, kh)
    d = rr[:, None, :] - pos[idx]
    r = torch.sqrt(torch.sum(d * d, dim=-1))
    h = torch.max(r, dim=1).values / 2.0
    q = r / h[:, None]
    w = W(q, h[:, None])
    return m * torch.sum(w, dim=1)
