"""phase_b_grouped: the block engine's phase B for every bucket in one launch.

Counterpart of the reference's TPU kernel
sphtpu/kernels/pallas_grouped_pairs.py::phase_b_grouped. Tensors on a CUDA
device go to the hand-written kernel csrc/phase_b_grouped.cu (entry
`sph_phase_b_grouped`); tensors on the CPU go to `phase_b_grouped_plain`.
The choice is made on the input's device only.

Layout: every bucket's (nb, C_b) candidate table flattened into ONE list
of chunks of CW = 512 slots; chunk i is a (BQ, CW) pair tile of the
gathered candidate stack `cstack (n_chunks, 10, CW)` (x y z vx vy vz h rho
P/rho^2 mask) against packed-query block qblk[i]. Every menu capacity is a
multiple of CW, so a block's chunks are consecutive: the query-side
reductions accumulate over them (mu_max by max), and the candidate-side
sums come out per chunk as (n_chunks, 8, CW) (sax say saz svisc sgx sgy sgz
sgp) for the caller's single scatter-add into particle rows.

On the card the launch is a grid of WORK UNITS (`unit_table`): one query
block against a run of at most UNIT_SLOTS of its slots, numbered in the
block's chunk order. A unit's candidate-side sums are final; its
query-side sums are partials that a second small kernel adds in unit
order. Each (query, occupied slot) pair is tested once, and the pair body
runs only on the pairs inside the query's visibility radius. No output
uses an atomic: two launches on the same inputs give the same bits.

Pair semantics (`pair_sums_plain`, and `pair_terms` of the CUDA source):
owner-sweep terms — the reference's reverse term equals the ball owner's
forward term, so the owner emits both endpoints' contributions — on the
division-diet algebra (inv_r = rsqrt(d2), polynomials in q), gravity
corrections with two-sided ownership weights (reach max(2h, r_c) on each
side), and in p3m mode the Newtonian-minus-mesh tail (`newton_minus_mesh`).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..physics.mesh_gravity import newton_minus_mesh
from . import build

# flat candidate chunk width: divides every capacity of the block planner's
# menu (physics/blocks.C_MENU)
CW = 512
# slots of a work unit at most (a multiple of CW): the grid's grain
UNIT_SLOTS = 2048
# query rows a block, as the CUDA kernel is built (its shared-memory and
# register budget is checked for this many; the planner's BQ)
BQ_KERNEL = 128
# code the CUDA entry returns when that budget does not fit one CTA
ERR_BUDGET = 900
# pairs a batch of the plain versions holds (bounds their temporaries)
PLAIN_PAIRS = 1 << 20

launches = 0  # kernel launches made by phase_b_grouped (CUDA tensors only)


def _softened(r, inv_r, h_avg, inv_h):
    """(force over r, potential) of the cubic-spline softened gravity of a
    pair, Newtonian past r = 2 h_avg."""
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
            inv_r * inv_r * inv_r,
        ),
    )
    soft_p = torch.where(
        q_g <= 1.0,
        inv_h * (2.0 / 3.0 * q2_g - 0.3 * q2_g * q2_g + 0.1 * q2_g * q3_g - 1.4),
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
            -inv_r,
        ),
    )
    return soft_g, soft_p


def joint_near(d2, h_q, h_c):
    """Where a close pair's two gravity corrections are taken as one term
    (ROADMAP D21): d2 <= (h_q + h_c)^2, the gravity mask r <= 2 h_avg
    squared, on effective h (h > 0 ? h : 1). Every operation rounds on its
    own, as in the kernels' `joint_near` (csrc/common.cuh), so K2's joint
    mode, the tail kernel's skip mode and their plain versions decide it
    alike."""
    hs = h_q + h_c
    return d2 <= hs * hs


def joint_term(d2, h_avg, sigma):
    """(force over r, potential) of a close pair's two gravity corrections,
    softened - Newtonian plus Newtonian - mesh shape, summed in float64 and
    rounded once to d2's dtype (ROADMAP D21, as D12 takes them in K5): the
    1/r^3 and 1/r parts of the two cancel. At d2 = 0 (the self pair) the
    force is 0 and the potential the softened self term plus
    sqrt(2/pi)/sigma."""
    d2w = d2.double()
    sep = d2w > 0
    inv_rw = torch.where(sep, torch.rsqrt(torch.where(sep, d2w, 1.0)), 0.0)
    h_avgw = h_avg.double()
    soft_gw, soft_pw = _softened(d2w * inv_rw, inv_rw, h_avgw, 1.0 / h_avgw)
    tgw, tpw = newton_minus_mesh(d2w, inv_rw, sigma)
    cg = (soft_gw - inv_rw * inv_rw * inv_rw) + tgw
    cp = (soft_pw + inv_rw) + tpw
    return cg.to(d2.dtype), cp.to(d2.dtype)


def pair_sums_plain(q, c, m, alpha, beta, sigma, r_c_now, *, eos: str, p3m: bool):
    """The pair terms of the block engine on broadcast tiles: q = 11 query
    fields (x y z vx vy vz mask h rho P/rho^2 cs), each (..., Q, 1); c = 10
    candidate fields (x y z vx vy vz h rho P/rho^2 mask), each (..., 1, C).
    Returns (10 query-side reductions over C, each (..., Q): ax ay az div
    mu_max visc gx gy gz gphi; 8 candidate-side sums over Q, each (..., C):
    sax say saz svisc sgx sgy sgz sgp) — the Pallas kernels' body, op for
    op; in float32 under p3m a pair inside its softening radius takes its
    two gravity corrections' sum in float64, rounded once."""
    qx, qy, qz, qvx, qvy, qvz, qm, qh, qrho, qpor2, qcs = q
    cx, cy, cz, cvx, cvy, cvz, ch, crho, cpor2, cm = c
    dtype = qx.dtype
    big = torch.finfo(dtype).max
    zero = torch.zeros((), dtype=dtype, device=qx.device)
    one = torch.ones((), dtype=dtype, device=qx.device)

    dx = qx - cx
    dy = qy - cy
    dz = qz - cz
    d2 = dx * dx + dy * dy + dz * dz
    inv_r = torch.rsqrt(torch.where(d2 > 0, d2, one))
    inv_r = torch.where(d2 > 0, inv_r, zero)  # self-pairs: 1/r -> 0
    r = d2 * inv_r
    valid = (cm > 0) & (qm > 0)

    qrk2 = (2.0 * qh) * (2.0 * qh)
    fwd = valid & (d2 <= qrk2)

    h_q = torch.where(qh > 0, qh, one)
    h_c = torch.where(ch > 0, ch, one)
    h_avg = 0.5 * (h_q + h_c)
    inv_h = 1.0 / h_avg
    rho_avg = torch.where(valid, 0.5 * (qrho + crho), one)

    dvx = qvx - cvx
    dvy = qvy - cvy
    dvz = qvz - cvz
    v_dot_r = dvx * dx + dvy * dy + dvz * dz
    mu = torch.clamp_max(h_avg * v_dot_r * (1.0 / (d2 + 0.01 * h_avg * h_avg)), 0.0)
    pi_own = (-alpha * qcs * mu + beta * mu * mu) * (1.0 / rho_avg)

    inv_hq = 1.0 / h_q
    inv_hq2 = inv_hq * inv_hq
    ct_w = (1.0 / math.pi) * inv_hq2 * inv_hq2
    q_w = r * inv_hq
    g1 = ct_w * (2.25 * r * inv_hq2 - 3.0 * inv_hq)
    g2 = ct_w * (-0.75 * (2.0 - q_w) ** 2) * inv_r
    dwdr_q = torch.where(q_w <= 1.0, g1, torch.where(q_w <= 2.0, g2, zero))

    if eos == "polytropic":
        ct_own = m * (qpor2 + cpor2 + pi_own) / 2.0
    else:
        # isothermal asymmetric: the owner's P/rho^2 serves both endpoints
        ct_own = m * (qpor2 + pi_own / 2.0)

    coeff = torch.where(fwd, ct_own * dwdr_q, zero)
    cdx = coeff * dx
    cdy = coeff * dy
    cdz = coeff * dz
    v_dot_dw_q = v_dot_r * dwdr_q
    visc_pair = torch.where(fwd, m * pi_own * v_dot_dw_q / 2.0, zero)
    q_side = [
        -torch.sum(cdx, dim=-1),
        -torch.sum(cdy, dim=-1),
        -torch.sum(cdz, dim=-1),
        m * torch.sum(torch.where(fwd, v_dot_dw_q, zero), dim=-1),
        torch.max(torch.where(fwd, mu, torch.full_like(mu, -big)), dim=-1).values,
        torch.sum(visc_pair, dim=-1),
    ]
    c_side = [
        torch.sum(cdx, dim=-2),
        torch.sum(cdy, dim=-2),
        torch.sum(cdz, dim=-2),
        torch.sum(visc_pair, dim=-2),
    ]

    # gravity corrections with two-sided ownership weights
    gmask = valid & (r <= 2.0 * h_avg)
    soft_g, soft_p = _softened(r, inv_r, h_avg, inv_h)
    cgp = torch.where(gmask, soft_g - inv_r * inv_r * inv_r, zero)
    cpp = torch.where(gmask, soft_p + inv_r, zero)
    if p3m:
        tg, tp = newton_minus_mesh(d2, inv_r, sigma)
        cgp = cgp + torch.where(valid, tg, zero)
        cpp = cpp + torch.where(valid, tp, zero)
        if dtype != torch.float64:
            # a pair that takes both corrections: their 1/r^3 (and 1/r)
            # parts cancel, so the pair's sum is taken in float64 and
            # rounded once (the kernels likewise)
            d2w = d2.double()
            sep = d2w > 0
            inv_rw = torch.where(sep, torch.rsqrt(torch.where(sep, d2w, 1.0)), 0.0)
            h_avgw = h_avg.double()
            soft_gw, soft_pw = _softened(d2w * inv_rw, inv_rw, h_avgw, 1.0 / h_avgw)
            tgw, tpw = newton_minus_mesh(d2w, inv_rw, sigma)
            both = gmask & sep
            cgp = torch.where(both, ((soft_gw - inv_rw * inv_rw * inv_rw) + tgw).to(dtype), cgp)
            cpp = torch.where(both, ((soft_pw + inv_rw) + tpw).to(dtype), cpp)
    r_c = torch.as_tensor(r_c_now, dtype=dtype, device=qx.device)
    vq_r = torch.maximum(2.0 * qh, r_c)
    vc_r = torch.maximum(2.0 * ch, r_c)
    half = torch.full((), 0.5, dtype=dtype, device=qx.device)
    w = torch.where(r <= vq_r, torch.where(r <= vc_r, half, one), zero)
    cgw = w * cgp
    cpw = w * cpp
    gwx = cgw * dx
    gwy = cgw * dy
    gwz = cgw * dz
    q_side += [
        m * torch.sum(gwx, dim=-1),
        m * torch.sum(gwy, dim=-1),
        m * torch.sum(gwz, dim=-1),
        m * torch.sum(cpw, dim=-1),
    ]
    c_side += [
        -m * torch.sum(gwx, dim=-2),
        -m * torch.sum(gwy, dim=-2),
        -m * torch.sum(gwz, dim=-2),
        m * torch.sum(cpw, dim=-2),
    ]
    return q_side, c_side


def _check_args(eos, p3m, sigma):
    if eos not in ("polytropic", "isothermal"):
        raise ValueError(f"unknown EOS {eos!r}")
    if p3m and sigma is None:
        raise ValueError("p3m=True needs sigma")


@functools.lru_cache(maxsize=64)
def chunk_starts(qblk: tuple, first: tuple, nb: int) -> np.ndarray:
    """(nb + 1,) int32: block b owns chunks [starts[b], starts[b + 1]).
    Raises unless qblk is non-decreasing, every block's chunks are
    consecutive and `first` flags exactly each block's first chunk."""
    qb = np.asarray(qblk, np.int64)
    fr = np.asarray(first, np.int64)
    if qb.shape != fr.shape or qb.ndim != 1:
        raise ValueError("qblk and first must be flat and of one length")
    if qb.size and (qb.min() < 0 or qb.max() >= nb or np.any(np.diff(qb) < 0)):
        raise ValueError("qblk must be non-decreasing block ids < NB")
    want_first = np.ones_like(qb)
    want_first[1:] = (np.diff(qb) != 0).astype(np.int64)
    if not np.array_equal(fr, want_first):
        raise ValueError("first must flag exactly each block's first chunk")
    return np.searchsorted(qb, np.arange(nb + 1), side="left").astype(np.int32)


@functools.lru_cache(maxsize=16)
def unit_table(qblk: tuple, first: tuple, nb: int, unit_slots: int = UNIT_SLOTS):
    """The kernel's work units for a chunk layout: (units (n_units, 3) int32
    = query block, first chunk, chunks; ustart (nb + 1,) int32, block b owns
    units [ustart[b], ustart[b + 1])). A block of n chunks gets
    ceil(n / (unit_slots / CW)) units, numbered in its chunk order, whose
    chunk counts differ by at most one, so no unit holds more than
    unit_slots slots and every chunk lies in exactly one unit."""
    if unit_slots < CW or unit_slots % CW:
        raise ValueError(f"unit_slots must be a positive multiple of {CW}, not {unit_slots}")
    starts = chunk_starts(qblk, first, nb).astype(np.int64)
    per = unit_slots // CW
    n_chk = np.diff(starts)
    n_u = -(-n_chk // per)
    ustart = np.concatenate([[0], np.cumsum(n_u)])
    blk = np.repeat(np.arange(nb), n_u)
    j = np.arange(int(ustart[-1])) - ustart[blk]  # unit index within its block
    base, extra = n_chk[blk] // n_u[blk], n_chk[blk] % n_u[blk]
    first_chunk = starts[blk] + j * base + np.minimum(j, extra)
    count = base + (j < extra)
    units = np.stack([blk, first_chunk, count], axis=1).astype(np.int32)
    return units, ustart.astype(np.int32)


def phase_b_grouped_plain(
    qfields, cstack, m, alpha, beta, sigma, r_c_now, *, eos: str, p3m: bool,
    cap: int, qblk: tuple, first: tuple,
):
    """Plain PyTorch version: batches of chunks, each chunk's (cap, CW)
    tile broadcast against its query block; the query sums of a block's
    chunks added (mu_max by max) in chunk order."""
    _check_args(eos, p3m, sigma)
    nb = qfields[0].shape[0]
    n_chunks = cstack.shape[0]
    dtype, device = cstack.dtype, cstack.device
    chunk_starts(tuple(qblk), tuple(first), nb)
    qb = torch.as_tensor(np.asarray(qblk, np.int64), device=device)
    q_out = [torch.zeros((nb, cap), dtype=dtype, device=device) for _ in range(10)]
    q_out[4].fill_(-torch.finfo(dtype).max)
    c_out = torch.zeros((n_chunks, 8, CW), dtype=dtype, device=device)
    per = max(1, PLAIN_PAIRS // (cap * CW))
    for k0 in range(0, n_chunks, per):
        ks = slice(k0, k0 + per)
        blk = qb[ks]
        q = tuple(a[blk][:, :, None] for a in qfields)
        c = tuple(cstack[ks, f][:, None, :] for f in range(10))
        qs, cs = pair_sums_plain(q, c, m, alpha, beta, sigma, r_c_now, eos=eos, p3m=p3m)
        for i, v in enumerate(qs):
            if i == 4:
                q_out[4].scatter_reduce_(0, blk[:, None].expand_as(v), v, "amax")
            else:
                q_out[i].index_add_(0, blk, v)
        c_out[ks] = torch.stack(cs, dim=1)
    return tuple(q_out), c_out


def phase_b_grouped(
    qfields,  # 11-tuple of (NB, cap) packed-query tensors
    cstack,  # (n_chunks, 10, CW) gathered candidate field stack
    m, alpha, beta, sigma, r_c_now,
    *,
    eos: str,
    p3m: bool,
    cap: int,
    qblk: tuple,  # query block id per chunk (non-decreasing)
    first: tuple,  # 1 at each block's first chunk
    units=None,  # on the card: `unit_table`'s two arrays there
):
    """Returns (10 query-side (NB, cap) tensors: ax ay az div mu_max visc gx
    gy gz gphi; the (n_chunks, 8, CW) candidate-side sums). Query field
    order: x y z vx vy vz mask h rho P/rho^2 cs. sigma may be None when p3m
    is False; r_c_now is the tail radius (0 under exact gravity).

    On the card the launch takes its work units from `units`, the
    (units, ustart) int32 tensors of `unit_table(qblk, first, NB)` on the
    device, which the caller builds once a plan (the block engine keeps
    them with its candidate tables), so the launch makes no host
    synchronisation; the plain version takes the layout from qblk."""
    _check_args(eos, p3m, sigma)
    if cstack.device.type != "cuda":
        return phase_b_grouped_plain(
            qfields, cstack, m, alpha, beta, sigma, r_c_now, eos=eos, p3m=p3m,
            cap=cap, qblk=qblk, first=first,
        )
    global launches
    nb = qfields[0].shape[0]
    n_chunks = cstack.shape[0]
    dtype, device = cstack.dtype, cstack.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"phase_b_grouped: unsupported dtype {dtype}")
    if cap != BQ_KERNEL:
        raise ValueError(
            f"phase_b_grouped: the kernel is built for {BQ_KERNEL} query rows a "
            f"block, not cap={cap}"
        )
    if len(qfields) != 11:
        raise ValueError("phase_b_grouped takes 11 query fields")
    for i, t in enumerate(qfields):
        build.check_tensor(f"qfields[{i}]", t, (nb, cap), dtype, device)
    build.check_tensor("cstack", cstack, (n_chunks, 10, CW), dtype, device)
    if units is None:
        raise ValueError("phase_b_grouped on the card takes the plan's work units (unit_table)")
    unit_rows, ustart = units
    n_units = unit_rows.shape[0]
    build.check_tensor("units[0]", unit_rows, (n_units, 3), torch.int32, device)
    build.check_tensor("units[1]", ustart, (nb + 1,), torch.int32, device)
    scal = build.scalar_tensor(
        [m, alpha, beta, sigma if sigma is not None else 1.0, r_c_now], dtype, device
    )
    q_out = torch.empty((10, nb, cap), dtype=dtype, device=device)
    c_out = torch.empty((n_chunks, 8, CW), dtype=dtype, device=device)
    q_part = torch.empty((n_units, 10, cap), dtype=dtype, device=device)
    outs = tuple(q_out.unbind(0))
    if nb == 0:
        return outs, c_out
    lib = build.load_kernels()["phase_b_grouped"]
    with torch.cuda.device(device):
        code = lib.sph_phase_b_grouped(
            build.pointer_array(list(qfields)), cstack.data_ptr(), unit_rows.data_ptr(),
            ustart.data_ptr(), scal.data_ptr(), build.pointer_array(list(outs)),
            c_out.data_ptr(), q_part.data_ptr(), nb, n_units, int(eos == "isothermal"),
            int(p3m), int(dtype == torch.float64), torch.cuda.current_stream().cuda_stream,
        )
    check_code("phase_b_grouped", code)
    launches += 1
    return outs, c_out


def check_code(name: str, code: int) -> None:
    """Raise on a non-zero code of the phase-B entries; ERR_BUDGET is F2's
    guard: the kernel's shared memory or registers for BQ_KERNEL query rows
    do not fit one CTA of this card."""
    if code == ERR_BUDGET:
        raise RuntimeError(
            f"{name}: {BQ_KERNEL} query rows a block need more shared memory or "
            "registers than one CTA of this card has"
        )
    build.check(name, code)
