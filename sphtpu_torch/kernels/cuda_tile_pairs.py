"""phase_b_tiles: pair forces + near-field gravity correction per cell row.

Counterpart of the reference's TPU kernel
sphtpu/kernels/pallas_tile_pairs.py::phase_b_tiles. Tensors on a CUDA
device go to the hand-written kernel csrc/phase_b_tiles.cu; tensors on the
CPU go to `phase_b_tiles_plain`, the plain PyTorch version that repeats the
kernel body step by step. The choice is made on the input's device only.

There are NO candidate-side accumulators: the tile formulation evaluates
the symmetric pair sum from the receiver's side (forward mask = c in
knn(q), reverse mask = q in knn(c) — the scatter-free factoring of
hydroCalculation, polytrope_hydroKDTree.jl:229-245), so each query row
owns its complete result.

Physics per slot is the division-diet algebra: everything on
inv_r = rsqrt(d2) with polynomial piecewise helpers in q = r/h. The gravity
correction is term 1 (softened - Newtonian, q <= 2) plus, with p3m=True,
term 2 (Newtonian - mesh shape) — valid when the tail stencil half-width
is one cell (EngineConfig.c_halfwidth == 1, i.e. mesh_factor >=
ceil(4.4 * sigma_cells); the default mesh_factor of 5 does NOT satisfy
it), which the caller must guarantee.

The kernel gives each cell row one CTA: the row's occupied queries and, in
pieces of up to `piece` records, its occupied candidates are compacted into
shared memory; each warp takes whole queries, tests each (query,
candidate) pair once against `cull_r2` (a radius that covers the forward,
reverse and gravity masks), evaluates the kept pairs 32 at a time, one a
lane, and adds their terms to the query's sums in candidate order.
`k2_shared_bytes` is its shared memory and `k2_budget` its default piece
on a card.

The mono-tile engine's outlier lane marks an outlier's slot with a mask of
2 (any other occupied slot holds 1; every occupancy test asks mask > 0) and
passes `outlier=True`: the forward mask then drops a pair whose query is an
outlier and the reverse mask a pair whose candidate is one (the
reference's `fwd & (qo <= 0)`, `rev & (cout <= 0)`,
sphtpu/physics/tiles.py:563-572); the gravity mask and the cull stay as
they are. The kernel stages the mask as a ninth record plane, in a variant
of its own: without `outlier` the launch is the kernel it was, bit for
bit.

`joint=True` (the mono-tile and z-slab engines under P3M in float32,
ROADMAP D21) takes a pair of the gravity mask's term 1 and term 2
(Newtonian - mesh shape) as one term, summed in float64 and rounded once
(`joint_term`), where the mask is `joint_near`: the P3M tail kernel's skip
mode (`p3m_tail(skip_joint=True)`) leaves out exactly those pairs, so their
1/r^3 parts no longer cancel in two float32 sums. It takes the outlier
masks or not, and p3m=False.
"""

from __future__ import annotations

import math

import torch

from ..physics.mesh_gravity import newton_minus_mesh
from . import build
from .cuda_grouped_pairs import joint_near, joint_term

launches = 0  # kernel launches made by phase_b_tiles (CUDA tensors only)

K2_THREADS = 256  # threads of a CTA (one cell row)
K2_WARPS = K2_THREADS // 32
MAX_CAP = K2_THREADS  # a row's queries must fit one CTA's threads
MAX_CW = 27 * MAX_CAP  # widest candidate row: a 27-cell stack
K2_PLANES = 8  # staged planes a record besides (x, y, z, cull): vx vy vz h rho por2 cs 1/h
K2_PLANES_OUT = K2_PLANES + 1  # with the outlier masks: the mask
K2_QUEUE = 96  # a warp's queue of kept records: < 32 waiting + a step's 2 x 32
CULL_MARGIN = 1.00390625  # 1 + 2^-8 on the cull radius^2
K2_PIECE = {torch.float32: 512, torch.float64: 256}  # default candidate records a piece


def cull_r2(h):
    """The cull radius^2 of a slot with smoothing length h (the kernel's
    `cull_r2`): (2 rho)^2 (1 + 2^-8), rho = h where h > 0, else max(|h|, 1).
    A pair can lie in the forward, reverse or gravity mask only if d2 <=
    max(cull_r2(h_q), cull_r2(h_c))."""
    a = torch.where(h > 0, h, torch.clamp(-h, min=1.0))
    return 4.0 * a * a * CULL_MARGIN


def k2_shared_bytes(cap: int, cw: int, piece: int, dtype, outlier: bool = False) -> int:
    """Dynamic shared memory of one CTA (the kernel's `phase_b_smem`): the
    query and candidate records (position and cull radius, then K2_PLANES
    planes, K2_PLANES_OUT with the outlier masks), the ten sums of each
    query, each warp's 32 pair terms (rows padded to 33), the query slots,
    each warp's queue, and the row's occupancy bits with their prefix."""
    words = -(-cw // 32)
    planes = K2_PLANES_OUT if outlier else K2_PLANES
    return (dtype.itemsize * ((4 + planes) * (cap + piece) + 10 * cap + K2_WARPS * 10 * 33)
            + 4 * (cap + K2_WARPS * K2_QUEUE + 2 * words + 1))


def k2_budget(cap: int, cw: int, dtype, smem_optin: int, piece: int = 0,
              outlier: bool = False) -> int:
    """The piece of a launch: K2_PIECE's unless given, checked against the
    kernel's limits (cap <= MAX_CAP, cw <= MAX_CW, piece a multiple of 64)
    and the card's opt-in shared memory. Raises where it would not fit."""
    piece = piece or K2_PIECE[dtype]
    if cap > MAX_CAP or cw > MAX_CW or piece < 64 or piece % 64 or piece > 1 << 16:
        raise ValueError(
            f"phase_b_tiles: cap {cap} (<= {MAX_CAP}), cw {cw} (<= {MAX_CW}) or piece "
            f"{piece} (a multiple of 64) out of the kernel's range"
        )
    need = k2_shared_bytes(cap, cw, piece, dtype, outlier)
    if need > smem_optin:
        raise ValueError(f"phase_b_tiles: {need} B of shared memory exceed {smem_optin} B")
    return piece


def phase_b_tiles_plain(
    qfields, cfields, m, alpha, beta, sigma, *, eos: str, p3m: bool, cap: int,
    outlier: bool = False, joint: bool = False, row_chunk: int = 0,
):
    """Plain PyTorch version: broadcast (rows, cap', 1) against
    (rows, 1, cw'), row-chunked to bound the pair temporaries, over the
    chunk's occupied query and candidate columns only (cap' <= cap,
    cw' <= cw; `build.occupied_columns`). outlier, joint: as phase_b_tiles
    takes them."""
    n_cells, cw = cfields[0].shape
    dtype = cfields[0].dtype
    device = cfields[0].device
    big = torch.finfo(dtype).max
    if not row_chunk:
        row_chunk = max(1, 1_000_000 // max(cap * cw, 1))
    # off-mask query slots: zeros, mu_max = -max
    outs = [torch.zeros((n_cells, cap), dtype=dtype, device=device) for _ in range(10)]
    outs[4].fill_(-big)
    zero = torch.zeros((), dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    for r0 in range(0, n_cells, row_chunk):
        sl = slice(r0, r0 + row_chunk)
        if not bool((qfields[6][sl] > 0).any()):
            continue
        qc = build.occupied_columns(qfields[6][sl])
        cc = build.occupied_columns(cfields[6][sl])
        qx, qy, qz, qvx, qvy, qvz, qm, qh, qrho, qpor2, qcs = (
            a[sl][:, qc, None] for a in qfields
        )
        cx, cy, cz, cvx, cvy, cvz, cm, ch, crho, cpor2, ccs = (
            a[sl][:, None, cc] for a in cfields
        )
        dx = qx - cx
        dy = qy - cy
        dz = qz - cz
        d2 = dx * dx + dy * dy + dz * dz
        inv_r = torch.rsqrt(torch.where(d2 > 0, d2, one))
        inv_r = torch.where(d2 > 0, inv_r, zero)  # self-pairs: 1/r -> 0
        r = d2 * inv_r
        valid = (cm > 0) & (qm > 0)

        # r_k = 2h recomputed here ((2h)^2 rounds identically)
        fwd = valid & (d2 <= (2.0 * qh) * (2.0 * qh))
        rev = valid & (d2 <= (2.0 * ch) * (2.0 * ch))
        if outlier:
            # outlier queries (mask 2) leave the forward mask, outlier
            # candidates the reverse mask (the lane sums those pairs exactly)
            fwd = fwd & (qm <= 1)
            rev = rev & (cm <= 1)

        h_q = torch.where(qh > 0, qh, one)
        h_c = torch.where(ch > 0, ch, one)
        h_avg = 0.5 * (h_q + h_c)
        inv_h = 1.0 / h_avg
        rho_avg = torch.where(valid, 0.5 * (qrho + crho), one)
        inv_rho = 1.0 / rho_avg

        dvx = qvx - cvx
        dvy = qvy - cvy
        dvz = qvz - cvz
        v_dot_r = dvx * dx + dvy * dy + dvz * dz
        mu = torch.clamp_max(
            h_avg * v_dot_r * (1.0 / (d2 + 0.01 * (h_avg * h_avg))), 0.0
        )
        pi_fwd = (-alpha * qcs * mu + beta * mu * mu) * inv_rho
        pi_rev = (-alpha * ccs * mu + beta * mu * mu) * inv_rho

        # grad_W(q)/r with per-side h (row/column reciprocal powers)
        inv_hq = 1.0 / h_q
        inv_hq2 = inv_hq * inv_hq
        ct_wq = (1.0 / math.pi) * inv_hq2 * inv_hq2
        q_q = r * inv_hq
        dwdr_q = torch.where(
            q_q <= 1.0,
            ct_wq * (2.25 * r * inv_hq2 - 3.0 * inv_hq),
            torch.where(
                q_q <= 2.0, ct_wq * (-0.75 * (2.0 - q_q) ** 2) * inv_r, zero
            ),
        )
        inv_hc = 1.0 / h_c
        inv_hc2 = inv_hc * inv_hc
        ct_wc = (1.0 / math.pi) * inv_hc2 * inv_hc2
        q_c = r * inv_hc
        dwdr_c = torch.where(
            q_c <= 1.0,
            ct_wc * (2.25 * r * inv_hc2 - 3.0 * inv_hc),
            torch.where(
                q_c <= 2.0, ct_wc * (-0.75 * (2.0 - q_c) ** 2) * inv_r, zero
            ),
        )

        if eos == "polytropic":
            psum = qpor2 + cpor2
            ct_fwd = m * (psum + pi_fwd) / 2.0
            ct_rev = m * (psum + pi_rev) / 2.0
        else:
            ct_fwd = m * (qpor2 + pi_fwd / 2.0)
            ct_rev = m * (cpor2 + pi_rev / 2.0)

        coeff = -torch.where(fwd, ct_fwd * dwdr_q, zero) - torch.where(
            rev, ct_rev * dwdr_c, zero
        )
        outs[0][sl, qc] = torch.sum(coeff * dx, dim=2)
        outs[1][sl, qc] = torch.sum(coeff * dy, dim=2)
        outs[2][sl, qc] = torch.sum(coeff * dz, dim=2)

        v_dot_dw_q = v_dot_r * dwdr_q
        v_dot_dw_c = v_dot_r * dwdr_c
        outs[3][sl, qc] = m * torch.sum(torch.where(fwd, v_dot_dw_q, zero), dim=2)
        outs[4][sl, qc] = torch.max(
            torch.where(fwd, mu, torch.full_like(mu, -big)), dim=2
        ).values
        outs[5][sl, qc] = torch.sum(
            torch.where(fwd, m * pi_fwd * v_dot_dw_q / 2.0, zero)
            + torch.where(rev, m * pi_rev * v_dot_dw_c / 2.0, zero),
            dim=2,
        )

        # near-field gravity correction, term 1: softened - Newtonian for
        # q <= 2 (Newtonian terms vanish at self-pairs via inv_r = 0)
        newt_g = inv_r * inv_r * inv_r
        newt_p = -inv_r
        q_g = r * inv_h
        q2_g = q_g * q_g
        q3_g = q2_g * q_g
        inv_h2 = inv_h * inv_h
        inv_q = h_avg * inv_r  # 1/q, 0 at self-pairs
        soft_g = torch.where(
            q_g <= 1.0,
            inv_h2 * inv_h * (4.0 / 3.0 - 1.2 * q2_g + 0.5 * q3_g),
            torch.where(
                q_g <= 2.0,
                inv_h2
                * (
                    8.0 / 3.0 * q_g
                    - 3.0 * q2_g
                    + 1.2 * q3_g
                    - q2_g * q2_g / 6.0
                    - (1.0 / 15.0) * inv_q * inv_q
                )
                * inv_r,
                newt_g,
            ),
        )
        soft_p = torch.where(
            q_g <= 1.0,
            inv_h
            * (2.0 / 3.0 * q2_g - 0.3 * q2_g * q2_g + 0.1 * q2_g * q3_g - 1.4),
            torch.where(
                q_g <= 2.0,
                inv_h
                * (
                    4.0 / 3.0 * q2_g
                    - q3_g
                    + 0.3 * q2_g * q2_g
                    - q2_g * q3_g / 30.0
                    - 1.6
                    + (1.0 / 15.0) * inv_q
                ),
                newt_p,
            ),
        )
        if joint:
            # terms 1 and 2 of a close pair as one float64 term
            gmask = valid & joint_near(d2, h_q, h_c)
            jg, jp = joint_term(d2, h_avg, sigma)
            cgp = torch.where(gmask, jg, zero)
            cpp = torch.where(gmask, jp, zero)
        else:
            gmask = valid & (r <= 2.0 * h_avg)
            cgp = torch.where(gmask, soft_g - newt_g, zero)
            cpp = torch.where(gmask, soft_p - newt_p, zero)
        if p3m:
            # term 2 (Newtonian - mesh shape), the c_halfwidth == 1 geometry
            tg, tp = newton_minus_mesh(d2, inv_r, sigma)
            cgp = cgp + torch.where(valid, tg, zero)
            cpp = cpp + torch.where(valid, tp, zero)
        outs[6][sl, qc] = m * torch.sum(cgp * dx, dim=2)
        outs[7][sl, qc] = m * torch.sum(cgp * dy, dim=2)
        outs[8][sl, qc] = m * torch.sum(cgp * dz, dim=2)
        outs[9][sl, qc] = m * torch.sum(cpp, dim=2)
    return tuple(outs)


def phase_b_tiles(
    qfields,  # 11-tuple of (n_cells, cap) query-slot tensors
    cfields,  # 11-tuple of (n_cells, cw) candidate prestack rows
    m, alpha, beta, sigma,
    *,
    eos: str,
    p3m: bool,
    cap: int,
    outlier: bool = False,
    joint: bool = False,
    piece: int = 0,
    keep_all: bool = False,
):
    """Returns 10 query-side (n_cells, cap) tensors: ax, ay, az, div,
    mu_max, visc, ggx, ggy, ggz, gphi. Field order on both sides: x, y, z,
    vx, vy, vz, mask, h, rho, P/rho^2, cs. sigma may be None when p3m is
    False. outlier=True applies the outlier masks: a slot whose mask is 2
    is an outlier, whose forward pairs (as the query) and reverse pairs (as
    the candidate) are dropped; it takes p3m=False only (the mono engine's
    term 2 is the tail kernel's). joint=True (needs sigma, p3m=False) takes
    a pair's term 1 and term 2 as one float64 term inside `joint_near`,
    the pairs `p3m_tail(skip_joint=True)` leaves out. On the card, piece overrides
    `k2_budget`'s and keep_all=True keeps every occupied pair (no cull);
    neither changes a result."""
    if eos not in ("polytropic", "isothermal"):
        raise ValueError(f"unknown EOS {eos!r}")
    if (p3m or joint) and sigma is None:
        raise ValueError("p3m=True and joint=True need sigma")
    if p3m and joint:
        raise ValueError("phase_b_tiles: joint=True takes p3m=False")
    c0 = cfields[0]
    if c0.device.type != "cuda":
        return phase_b_tiles_plain(
            qfields, cfields, m, alpha, beta, sigma, eos=eos, p3m=p3m, cap=cap,
            outlier=outlier, joint=joint,
        )
    global launches
    n_cells, cw = c0.shape
    dtype, device = c0.dtype, c0.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"phase_b_tiles: unsupported dtype {dtype}")
    if len(qfields) != 11 or len(cfields) != 11:
        raise ValueError("phase_b_tiles takes 11 query and 11 candidate fields")
    for i, t in enumerate(qfields):
        build.check_tensor(f"qfields[{i}]", t, (n_cells, cap), dtype, device)
    for i, t in enumerate(cfields):
        build.check_tensor(f"cfields[{i}]", t, (n_cells, cw), dtype, device)
    if outlier and p3m:
        raise ValueError("phase_b_tiles: the outlier masks take p3m=False")
    piece = k2_budget(cap, cw, dtype, build.device_limits(device)[1], piece, outlier)
    scal = build.scalar_tensor(
        [m, alpha, beta, sigma if sigma is not None else 1.0], dtype, device
    )
    out = torch.empty((10, n_cells, cap), dtype=dtype, device=device)
    outs = tuple(out.unbind(0))
    if n_cells == 0:
        return outs
    lib = build.load_kernels()["phase_b_tiles"]
    with torch.cuda.device(device):
        code = lib.sph_phase_b_tiles(
            build.pointer_array(list(qfields)),
            build.pointer_array(list(cfields)),
            scal.data_ptr(),
            build.pointer_array(list(outs)),
            n_cells, cap, cw, int(eos == "isothermal"), 2 if joint else int(p3m),
            int(outlier), piece,
            int(keep_all),
            int(dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check("phase_b_tiles", code)
    launches += 1
    return outs
