"""p3m_tail: the mono-tile engine's P3M tail correction.

Per query slot, m * sum over the occupied candidates of the (2W+1)^3-cell
stencil of newton_minus_mesh (Newtonian minus the mesh's Gaussian-smoothed
shape): (gx, gy, gz, gphi). The reference runs this pass as XLA (phase C of
sphtpu/physics/tiles.py::tile_sph_forces); it has no TPU kernel. Tensors
on a CUDA device go to the hand-written kernel csrc/p3m_tail.cu; tensors on
the CPU go to `p3m_tail_plain`. The choice is made on the input's device
only.

Input layout: four padded planes (x, y, z, mask) of shape
(gpc, gpc, gpc * cap), gpc = grid + 2W — particles at their (cell, rank)
slots with a W-cell halo of zeros. Cell (iz, iy, ix) owns slots
[(iz+W, iy+W), (ix+W) * cap : (ix+W+1) * cap]; its stencil is the
(2W+1)^2 runs [(iz+dz, iy+dy), ix * cap : (ix+2W+1) * cap], in that
(dz, dy, x-slot) order.

The kernel first packs each padded cell's occupied slots in slot order,
then gives each cell row one CTA of TAIL_THREADS threads that stages the
stencil's packed candidates once for all of the row's queries, `chunk` at
a time, and splits the (query, candidate) pairs over its threads by
`thread_plan`; a query's slice partials are added in slice order.
`tail_shared_bytes` is its shared memory, `tail_budget` checks it against
the card.

`skip_joint=True` (with K2's joint mode, float32 under P3M, ROADMAP D21)
takes a fifth plane, h, and leaves out every pair of the inner 27 cells
(|d| <= 1 cell in each axis) that `cuda_grouped_pairs.joint_near` puts in
K2's joint term, the self slot included: K2 adds those pairs' term 2.
"""

from __future__ import annotations

import torch

from ..physics.mesh_gravity import newton_minus_mesh
from . import build
from .cuda_grouped_pairs import joint_near

launches = 0  # kernel launches made by p3m_tail (CUDA tensors only)

TAIL_THREADS = 256  # threads of a CTA (one cell row)
TAIL_CHUNK = 1024  # candidate records staged at a time
MAX_CAP = TAIL_THREADS  # a row's queries must fit one CTA's threads


def thread_plan(nq: int, threads: int = TAIL_THREADS) -> tuple[int, int, int]:
    """(R, QT, S) of a row with nq occupied queries, as the kernel picks it:
    R = 1, 2 or 4 queries a thread, QT = ceil(nq / R) query threads, S =
    threads // QT slices of the staged candidates (thread t < QT * S takes
    queries t % QT + r * QT, r < R, and candidates slice, slice + S, ... of
    each staged chunk, slice = t // QT). R is the one with the fewest
    candidate sweeps a thread, R / S, the smaller R on a tie."""
    if not 1 <= nq <= threads:
        raise ValueError(f"p3m_tail: {nq} queries do not fit {threads} threads")
    s = {r: threads // -(-nq // r) for r in (1, 2, 4)}
    if s[4] > 2 * s[2] and s[4] > 4 * s[1]:
        r = 4
    elif s[2] > 2 * s[1]:
        r = 2
    else:
        r = 1
    return r, -(-nq // r), s[r]


def tail_shared_bytes(halfwidth: int, chunk: int, dtype, skip: bool = False) -> int:
    """Dynamic shared memory of one CTA (the kernel's `tail_smem`): `chunk`
    staged (x, y, z, slot) records, with `skip` their h, and the stencil's
    count prefix."""
    span = 2 * halfwidth + 1
    rec = max(16, 4 * dtype.itemsize) + (dtype.itemsize if skip else 0)
    return chunk * rec + (span**3 + 1) * 4


def tail_budget(cap: int, halfwidth: int, dtype, smem_optin: int,
                chunk: int = TAIL_CHUNK, skip: bool = False) -> int:
    """The chunk of a launch: `chunk`, checked against the card's opt-in
    shared memory and the kernel's limits (cap <= MAX_CAP; chunk >= 4
    TAIL_THREADS, the slice partials reuse the staged records). Raises where
    the launch would not fit."""
    if cap > MAX_CAP or halfwidth < 1 or chunk < 4 * TAIL_THREADS:
        raise ValueError(
            f"p3m_tail: cap {cap} (<= {MAX_CAP}), halfwidth {halfwidth} (>= 1) and chunk "
            f"{chunk} (>= {4 * TAIL_THREADS}) out of the kernel's range"
        )
    need = tail_shared_bytes(halfwidth, chunk, dtype, skip)
    if need > smem_optin:
        raise ValueError(f"p3m_tail: {need} B of shared memory exceed {smem_optin} B")
    return chunk


def stencil_index(grid: int, cap: int, halfwidth: int, device, nz: int = None):
    """(corner (n_cells,), offsets (cwc,), centre (n_cells,)): flat plane
    index of each cell's stencil corner, the offsets of the (2W+1)^3 * cap
    stencil slots from it in (dz, dy, x-slot) order, and the flat index of
    each cell's first own slot. The query cells are nz (default grid)
    layers of grid x grid."""
    g, w = grid, halfwidth
    nz = g if nz is None else nz
    gpc = g + 2 * w
    xs = gpc * cap
    span = 2 * w + 1
    a = torch.arange(span, device=device)
    offsets = (
        (a[:, None, None] * gpc + a[None, :, None]) * xs
        + torch.arange(span * cap, device=device)[None, None, :]
    ).reshape(-1)
    rows = torch.arange(nz * g * g, device=device)
    ix, iy, iz = rows % g, (rows // g) % g, rows // (g * g)
    corner = (iz * gpc + iy) * xs + ix * cap
    centre = ((iz + w) * gpc + (iy + w)) * xs + (ix + w) * cap
    return corner, offsets, centre


def _inner_offsets(grid: int, cap: int, halfwidth: int, device):
    """(cwc,) bool: which of `stencil_index`'s offsets lie in the inner 27
    cells (|d| <= 1 in each axis), K2's 27-cell stencil."""
    span = 2 * halfwidth + 1
    d = (torch.arange(span, device=device) - halfwidth).abs() <= 1
    dx = d.repeat_interleave(cap)
    return (d[:, None, None] & d[None, :, None] & dx[None, None, :]).reshape(-1)


def p3m_tail_plain(planes, m, sigma, *, grid: int, cap: int, halfwidth: int,
                   row_chunk: int = 0, nz: int = None, skip_joint: bool = False):
    """Plain PyTorch version: per chunk of cell rows, gather the stencil's
    slots and broadcast (rows, cap', 1) against (rows, 1, cwc') over the
    chunk's occupied query and stencil columns only
    (`build.occupied_columns`). skip_joint: as p3m_tail takes it."""
    dtype, device = planes.dtype, planes.device
    nz = grid if nz is None else nz
    n_cells = nz * grid * grid
    corner, offsets, centre = stencil_index(grid, cap, halfwidth, device, nz)
    cwc = offsets.numel()
    if not row_chunk:
        row_chunk = max(1, 2_000_000 // max(cap * cwc, 1))
    n_pl = 5 if skip_joint else 4
    flat = planes.reshape(n_pl, -1)
    inner = _inner_offsets(grid, cap, halfwidth, device) if skip_joint else None
    slot = torch.arange(cap, device=device)
    out = torch.zeros((4, n_cells, cap), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    for r0 in range(0, n_cells, row_chunk):
        sl = slice(r0, r0 + row_chunk)
        qidx = centre[sl, None] + slot[None, :]
        qm = flat[3][qidx]
        if not bool((qm > 0).any()):
            continue
        qc = build.occupied_columns(qm)
        cidx = corner[sl, None] + offsets[None, :]
        cc = build.occupied_columns(flat[3][cidx])
        cidx = cidx[:, cc]
        cx, cy, cz, cm = (flat[k][cidx][:, None, :] for k in range(4))
        qx, qy, qz, qm = (flat[k][qidx[:, qc]][:, :, None] for k in range(4))
        dx = qx - cx
        dy = qy - cy
        dz = qz - cz
        d2 = dx * dx + dy * dy + dz * dz
        valid = (cm > 0) & (qm > 0)
        if skip_joint:
            # K2's joint term holds these pairs' term 2
            hq = flat[4][qidx[:, qc]][:, :, None]
            hc = flat[4][cidx][:, None, :]
            near = joint_near(d2, torch.where(hq > 0, hq, one), torch.where(hc > 0, hc, one))
            valid = valid & ~(near & inner[cc])
        inv_r = torch.rsqrt(torch.where(d2 > 0, d2, one))
        cgp, cpp = newton_minus_mesh(d2, inv_r, sigma)
        cgp = torch.where(valid, cgp, zero)
        cpp = torch.where(valid, cpp, zero)
        out[0, sl, qc] = m * torch.sum(cgp * dx, dim=2)
        out[1, sl, qc] = m * torch.sum(cgp * dy, dim=2)
        out[2, sl, qc] = m * torch.sum(cgp * dz, dim=2)
        out[3, sl, qc] = m * torch.sum(cpp, dim=2)
    return out


def p3m_tail(planes, m, sigma, *, grid: int, cap: int, halfwidth: int,
             chunk: int = TAIL_CHUNK, nz: int = None, skip_joint: bool = False):
    """Returns (4, nz * grid^2, cap): gx, gy, gz, gphi of the tail
    correction at every query slot (zeros at unoccupied slots). planes:
    (4, nz + 2 * halfwidth, gpc, gpc * cap) x, y, z, mask with gpc = grid +
    2 * halfwidth, (5, ...) with h after them when skip_joint; nz (default
    grid, the mono-tile engine's cube) is the number of query layers (the
    z-slab engine's slab). skip_joint=True leaves out the inner 27 cells'
    pairs that K2's joint mode takes (`joint_near`). On the card, `chunk`
    sets the records staged at a time."""
    nz = grid if nz is None else nz
    if planes.device.type != "cuda":
        return p3m_tail_plain(
            planes, m, sigma, grid=grid, cap=cap, halfwidth=halfwidth, nz=nz,
            skip_joint=skip_joint,
        )
    global launches
    dtype, device = planes.dtype, planes.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"p3m_tail: unsupported dtype {dtype}")
    gpc = grid + 2 * halfwidth
    gpz = nz + 2 * halfwidth
    n_pl = 5 if skip_joint else 4
    build.check_tensor("planes", planes, (n_pl, gpz, gpc, gpc * cap), dtype, device)
    chunk = tail_budget(cap, halfwidth, dtype, build.device_limits(device)[1], chunk,
                        skip_joint)
    scal = build.scalar_tensor([m, sigma], dtype, device)
    out = torch.empty((4, nz * grid * grid, cap), dtype=dtype, device=device)
    if grid == 0 or nz == 0:
        return out
    packed = torch.empty((gpz * gpc * gpc * cap * 4,), dtype=dtype, device=device)
    packed_h = (torch.empty((gpz * gpc * gpc * cap,), dtype=dtype, device=device)
                if skip_joint else packed)
    count = torch.empty((gpz * gpc * gpc,), dtype=torch.int32, device=device)
    lib = build.load_kernels()["p3m_tail"]
    with torch.cuda.device(device):
        code = lib.sph_p3m_tail(
            build.pointer_array(list(planes.unbind(0))),
            scal.data_ptr(),
            build.pointer_array(list(out.unbind(0))),
            packed.data_ptr(), packed_h.data_ptr(), count.data_ptr(),
            grid, nz, cap, halfwidth, chunk, int(skip_joint), int(dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check("p3m_tail", code)
    launches += 1
    return out
