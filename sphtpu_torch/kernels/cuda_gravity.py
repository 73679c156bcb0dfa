"""newton_sweep: the pure-Newtonian all-pairs gravity sweep.

Counterpart of the reference's TPU kernel
sphtpu/kernels/pallas_gravity.py::newton_sweep_pallas. Tensors on a CUDA
device go to the hand-written kernel csrc/newton_sweep.cu; tensors on the
CPU go to `newton_sweep_plain`. physics/gravity.py::gravity_newton_allpairs
is a thin entry point over `newton_sweep`.

On the card each thread sums R rows, a CTA `threads * R` of them, and the
columns are split into S slices whose partial sums a second kernel adds in
the order s = 0 .. S - 1 (`split_plan`, `column_slices`): the grid fills
the card and the outputs repeat from run to run.

kernels/cuda_gravity_rc.py holds the same kernel with the rows and the
columns apart (the sharded engines' far field).
"""

from __future__ import annotations

import torch

from . import build

launches = 0  # kernel launches made by newton_sweep (CUDA tensors only)

# The sweep's plan: rows a thread (register blocking) by dtype, threads a
# CTA, the CTAs to aim for (WAVES times what 2048 resident threads an SM
# hold), and the fewest columns a slice may have (below that a slice's
# partial sums cost more than its pairs save). R and WAVES were chosen by
# `tools/chip_k1k3.py --sweep` on an H100 (PERF.md).
ROWS_PER_THREAD = {torch.float32: 4, torch.float64: 2}
THREADS = 256
WAVES = 4
MIN_SLICE_COLS = 4 * THREADS


def column_slices(n: int, n_slices: int, threads: int = THREADS) -> int:
    """Columns of each of the n_slices slices (the last one is cut at n):
    ceil(n / n_slices) rounded up to whole staged tiles of `threads`."""
    per_slice = -(-n // n_slices)
    return -(-per_slice // threads) * threads


def split_plan(n: int, n_sms: int, dtype) -> tuple[int, int, int]:
    """(R, threads, S) for N = n on a card of n_sms SMs: enough column
    slices that the grid holds about WAVES full waves of CTAs, no slice
    narrower than MIN_SLICE_COLS, none empty. S = 1 where the rows alone
    fill the card or n is small."""
    rows = ROWS_PER_THREAD[dtype]
    row_ctas = -(-n // (THREADS * rows))
    target = WAVES * n_sms * (2048 // THREADS)
    s = max(1, min(-(-target // row_ctas), n // MIN_SLICE_COLS))
    s = -(-n // column_slices(n, s))  # drop slices the rounding left empty
    return rows, THREADS, s


def newton_sweep_plain(
    pos: torch.Tensor, m, *, block_q: int = 256, block_c: int = 2048
):
    """Plain PyTorch version, blocked so the (block_q, block_c) pair
    temporaries stay bounded: g_i = m sum_j (x_i - x_j)/r^3,
    phi_i = -m sum_j 1/r, pairs with r^2 = 0 excluded."""
    n = pos.shape[0]
    cx, cy, cz = (pos[:, a].contiguous() for a in range(3))
    g = torch.empty_like(pos)
    phi = torch.empty((n,), dtype=pos.dtype, device=pos.device)
    one = torch.ones((), dtype=pos.dtype, device=pos.device)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    for r0 in range(0, n, block_q):
        qpos = pos[r0 : r0 + block_q]
        bq = qpos.shape[0]
        gx = torch.zeros((bq,), dtype=pos.dtype, device=pos.device)
        gy = torch.zeros_like(gx)
        gz = torch.zeros_like(gx)
        ph = torch.zeros_like(gx)
        for c0 in range(0, n, block_c):
            dx = qpos[:, 0:1] - cx[None, c0 : c0 + block_c]
            dy = qpos[:, 1:2] - cy[None, c0 : c0 + block_c]
            dz = qpos[:, 2:3] - cz[None, c0 : c0 + block_c]
            r2 = dx * dx + dy * dy + dz * dz
            pos_r2 = r2 > 0
            inv_r = torch.where(
                pos_r2, torch.rsqrt(torch.where(pos_r2, r2, one)), zero
            )
            inv_r3 = inv_r * inv_r * inv_r
            gx = gx + torch.sum(inv_r3 * dx, dim=1)
            gy = gy + torch.sum(inv_r3 * dy, dim=1)
            gz = gz + torch.sum(inv_r3 * dz, dim=1)
            ph = ph - torch.sum(inv_r, dim=1)
        g[r0 : r0 + bq] = m * torch.stack([gx, gy, gz], dim=1)
        phi[r0 : r0 + bq] = m * ph
    return g, phi


def newton_sweep(pos: torch.Tensor, m, *, plan=None):
    """(g (N, 3), phi (N,)): Newtonian all-pairs, self excluded by r = 0.
    On the card `plan` = (R, threads, S) overrides `split_plan`'s (a
    measurement compares plans with it)."""
    if pos.device.type != "cuda":
        return newton_sweep_plain(pos, m)
    global launches
    n = pos.shape[0]
    dtype, device = pos.dtype, pos.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"newton_sweep: unsupported dtype {dtype}")
    build.check_tensor("pos", pos, (n, 3), dtype, device)
    m_dev = build.scalar_tensor([m], dtype, device)
    g = torch.empty((n, 3), dtype=dtype, device=device)
    phi = torch.empty((n,), dtype=dtype, device=device)
    if n == 0:
        return g, phi
    rows, threads, n_slices = plan or split_plan(n, build.device_limits(device)[0], dtype)
    cols = column_slices(n, n_slices, threads)
    part = (torch.empty((n_slices, n, 4), dtype=dtype, device=device)
            if n_slices > 1 else None)
    lib = build.load_kernels()["newton_sweep"]
    with torch.cuda.device(device):
        code = lib.sph_newton_sweep(
            pos.data_ptr(), m_dev.data_ptr(), g.data_ptr(), phi.data_ptr(),
            part.data_ptr() if part is not None else None,
            n, rows, threads, n_slices, cols, int(dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check("newton_sweep", code)
    launches += 1
    return g, phi

