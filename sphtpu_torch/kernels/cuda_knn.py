"""phase_a_tile: the mono-tile engine's exact k-th distance + density.

Counterpart of the reference's TPU kernel
sphtpu/kernels/pallas_knn.py::phase_a_pallas. Tensors on a CUDA device go
to the hand-written kernel (entry `sph_phase_a_tile` of
csrc/phase_a_cells.cu, the MONO variant of the kernel that also serves
phase_a_cells); tensors on the CPU go to `phase_a_tile_plain`. The choice
is made on the input's device only.

It computes what phase_a_cells computes, on the mono engine's layout: the
candidate rows are the 27-cell prestack (n_cells, 27 * cap), the queries
are each row's centre cell (slots 13 * cap .. 14 * cap), the occupancy
plane is the query mask, and the certification threshold is one uniform
s2 = (cell edge)^2: 34 binary bisections on [0, 1.001 s2], ties at the k-th
distance included, rk2 = max{d2 <= hi}, h = sqrt(rk2) / 2,
rho = m * sum W over d2 <= rk2, ok = !mask | (nfound >= kh & rk2 <= s2).

The kernel is K1's list design on this layout: one pass over the row
(streamed in pieces of `stage` slots) puts each query's in-radius squared
distances (d2 <= 1.001 s2) into a list of up to L entries in shared
memory, and the passes run over the list; a query with more than L
overflows to the full-row sweep (`last_overflow` counts such queries). h
and ok are bit-equal to the full-row form. `cuda_strip_knn.list_budget`
sizes L and `stage`.
"""

from __future__ import annotations

import torch

from . import build
from .cuda_strip_knn import N_BISECT, launch_sizes, phase_a_cells_plain

launches = 0  # kernel launches made by phase_a_tile (CUDA tensors only)
# queries of the last launch whose in-radius candidates overflowed L: an
# int32 tensor on the card, read only by measurements (never on the step path)
last_overflow = None


def phase_a_tile_plain(cands, s2, m, *, kh: int, cap: int, n_bisect: int = N_BISECT):
    """Plain PyTorch version: the centre-cell slice as the queries and s2 as
    every query's reach, through phase_a_cells' plain body."""
    centre = 13 * cap
    queries = tuple(c[:, centre : centre + cap] for c in cands)
    n_cells = cands[0].shape[0]
    reach2 = torch.as_tensor(s2, dtype=cands[0].dtype, device=cands[0].device)
    reach2 = reach2.reshape(1, 1).expand(n_cells, cap)
    return phase_a_cells_plain(
        queries, reach2, cands, m, kh=kh, cap=cap, n_bisect=n_bisect
    )


def phase_a_tile(
    cands,  # (cx, cy, cz, cm): each (n_cells, 27 * cap); cm = occupancy
    s2,  # uniform certification radius^2 (scalar or 0-d tensor)
    m,
    *,
    kh: int,
    cap: int,
    n_bisect: int = N_BISECT,
    stream_chunk: int = 0,
    list_cap: int = 0,
):
    """Returns (h, rho, ok) each (n_cells, cap); ok is 1.0 where the row
    certifies (unoccupied, or k found with r_k^2 <= s2). On the card,
    stream_chunk > 0 caps the candidate slots staged at a time and
    list_cap > 0 caps L, as in `cuda_strip_knn.phase_a_cells`."""
    cx = cands[0]
    if cx.device.type != "cuda":
        return phase_a_tile_plain(cands, s2, m, kh=kh, cap=cap, n_bisect=n_bisect)
    global launches, last_overflow
    n_cells, cw = cx.shape
    dtype, device = cx.dtype, cx.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"phase_a_tile: unsupported dtype {dtype}")
    for i, t in enumerate(cands):
        build.check_tensor(f"cands[{i}]", t, (n_cells, 27 * cap), dtype, device)
    scal = build.scalar_tensor([s2, m], dtype, device)
    h = torch.empty((n_cells, cap), dtype=dtype, device=device)
    rho = torch.empty_like(h)
    ok = torch.empty_like(h)
    if n_cells == 0:
        return h, rho, ok
    list_len, stage = launch_sizes(cap, cw, dtype, device, stream_chunk, list_cap)
    n_over = torch.empty((1,), dtype=torch.int32, device=device)  # zeroed by the entry
    lib = build.load_kernels()["phase_a_cells"]
    ptrs = build.pointer_array([scal[0:1], *cands, scal[1:2], h, rho, ok, n_over])
    with torch.cuda.device(device):
        code = lib.sph_phase_a_tile(
            ptrs, n_cells, cap, kh, n_bisect, stage, list_len, int(dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check("phase_a_cells", code)
    launches += 1
    last_overflow = n_over
    return h, rho, ok
