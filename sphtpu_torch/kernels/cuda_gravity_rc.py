"""newton_rows_cols: K3's sweep with the rows and the columns apart.

The pure-Newtonian sweep of kernels/cuda_gravity.py (the reference's TPU
kernel sphtpu/kernels/pallas_gravity.py::newton_sweep_pallas), entry
`sph_newton_rows_cols` of csrc/newton_sweep.cu: rows against the columns
whose weight is > 0, only the first n_rows rows and n_cols columns swept,
with K3's plan (R rows a thread, S column slices summed in a fixed order).
It is the sharded engines' far field: shard/tiles.py's ring of column
blocks and shard/mlevel.py's row split. Tensors on a CUDA device go to the
kernel; tensors on the CPU go to `newton_rows_cols_plain`.
"""

from __future__ import annotations

import torch

from . import build
from .cuda_gravity import MIN_SLICE_COLS, ROWS_PER_THREAD, THREADS, WAVES, column_slices

launches = 0  # kernel launches made by newton_rows_cols (CUDA tensors only)


def split_plan(n_rows: int, n_cols: int, n_sms: int, dtype) -> tuple[int, int, int]:
    """cuda_gravity.split_plan for n_rows rows against n_cols columns: the
    rows fix the CTAs of a slice, the columns the slices."""
    rows = ROWS_PER_THREAD[dtype]
    row_ctas = -(-n_rows // (THREADS * rows))
    target = WAVES * n_sms * (2048 // THREADS)
    s = max(1, min(-(-target // row_ctas), n_cols // MIN_SLICE_COLS))
    if n_cols > 0:
        s = -(-n_cols // column_slices(n_cols, s))
    return rows, THREADS, s


def newton_rows_cols_plain(
    pos_rows, pos_cols, col_weight, m, *, n_rows=None, n_cols=None,
    block_q: int = 256, block_c: int = 2048,
):
    """Plain PyTorch version: g_i = m sum_j w_j (x_i - x_j)/r^3, phi_i =
    -m sum_j w_j / r over the first n_cols columns, w_j = col_weight_j > 0
    (all columns when col_weight is None), pairs with r^2 = 0 excluded;
    rows past n_rows get zeros."""
    nr = pos_rows.shape[0] if n_rows is None else int(n_rows)
    nc = pos_cols.shape[0] if n_cols is None else int(n_cols)
    dtype, device = pos_rows.dtype, pos_rows.device
    cx, cy, cz = (pos_cols[:nc, a].contiguous() for a in range(3))
    live = (torch.ones((nc,), dtype=torch.bool, device=device) if col_weight is None
            else col_weight[:nc] > 0)
    g = torch.zeros((pos_rows.shape[0], 3), dtype=dtype, device=device)
    phi = torch.zeros((pos_rows.shape[0],), dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    for r0 in range(0, nr, block_q):
        qpos = pos_rows[r0 : min(r0 + block_q, nr)]
        bq = qpos.shape[0]
        gx = torch.zeros((bq,), dtype=dtype, device=device)
        gy = torch.zeros_like(gx)
        gz = torch.zeros_like(gx)
        ph = torch.zeros_like(gx)
        for c0 in range(0, nc, block_c):
            dx = qpos[:, 0:1] - cx[None, c0 : c0 + block_c]
            dy = qpos[:, 1:2] - cy[None, c0 : c0 + block_c]
            dz = qpos[:, 2:3] - cz[None, c0 : c0 + block_c]
            r2 = dx * dx + dy * dy + dz * dz
            keep = (r2 > 0) & live[None, c0 : c0 + block_c]
            inv_r = torch.where(keep, torch.rsqrt(torch.where(r2 > 0, r2, one)), zero)
            inv_r3 = inv_r * inv_r * inv_r
            gx = gx + torch.sum(inv_r3 * dx, dim=1)
            gy = gy + torch.sum(inv_r3 * dy, dim=1)
            gz = gz + torch.sum(inv_r3 * dz, dim=1)
            ph = ph - torch.sum(inv_r, dim=1)
        g[r0 : r0 + bq] = m * torch.stack([gx, gy, gz], dim=1)
        phi[r0 : r0 + bq] = m * ph
    return g, phi


def newton_rows_cols(pos_rows, pos_cols, col_weight, m, *, n_rows=None, n_cols=None,
                     plan=None):
    """(g (R, 3), phi (R,)) of the rows pos_rows (R, 3) against the columns
    pos_cols (C, 3) whose col_weight (C,) is > 0 (every column when
    col_weight is None): pure Newtonian, pairs with r^2 = 0 excluded. Only
    the first n_rows rows (default R) and n_cols columns (default C) are
    swept; the rows past n_rows get zeros. On the card `plan` = (R,
    threads, S) overrides `split_plan`'s."""
    if pos_rows.device.type != "cuda":
        return newton_rows_cols_plain(
            pos_rows, pos_cols, col_weight, m, n_rows=n_rows, n_cols=n_cols
        )
    global launches
    n_r, n_c = pos_rows.shape[0], pos_cols.shape[0]
    nr = n_r if n_rows is None else int(n_rows)
    nc = n_c if n_cols is None else int(n_cols)
    dtype, device = pos_rows.dtype, pos_rows.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"newton_rows_cols: unsupported dtype {dtype}")
    if not (0 <= nr <= n_r and 0 <= nc <= n_c):
        raise ValueError(f"newton_rows_cols: n_rows {nr} / n_cols {nc} out of range")
    build.check_tensor("pos_rows", pos_rows, (n_r, 3), dtype, device)
    build.check_tensor("pos_cols", pos_cols, (n_c, 3), dtype, device)
    if col_weight is not None:
        build.check_tensor("col_weight", col_weight, (n_c,), dtype, device)
    m_dev = build.scalar_tensor([m], dtype, device)
    g = torch.zeros((n_r, 3), dtype=dtype, device=device)
    phi = torch.zeros((n_r,), dtype=dtype, device=device)
    if nr == 0:
        return g, phi
    rows, threads, n_slices = plan or split_plan(
        nr, nc, build.device_limits(device)[0], dtype
    )
    cols = column_slices(nc, n_slices, threads) if nc else threads
    part = (torch.empty((n_slices, nr, 4), dtype=dtype, device=device)
            if n_slices > 1 else None)
    lib = build.load_kernels()["newton_sweep"]
    with torch.cuda.device(device):
        code = lib.sph_newton_rows_cols(
            pos_rows.data_ptr(), pos_cols.data_ptr(),
            col_weight.data_ptr() if col_weight is not None else None,
            m_dev.data_ptr(), g.data_ptr(), phi.data_ptr(),
            part.data_ptr() if part is not None else None,
            nr, nc, rows, threads, n_slices, cols, int(dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check("newton_sweep", code)
    launches += 1
    return g, phi
