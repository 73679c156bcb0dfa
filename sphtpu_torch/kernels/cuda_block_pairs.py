"""phase_b_blocks: the block engine's phase B for one capacity bucket.

Counterpart of the reference's TPU kernel
sphtpu/kernels/pallas_block_pairs.py::phase_b_blocks: (nb, BQ) query
blocks against their (nb, C_b) candidate tables, with the pair terms of
`cuda_grouped_pairs` (the same device function, `pair_terms`, in
csrc/phase_b_grouped.cu, entry `sph_phase_b_blocks`). Tensors on a CUDA
device go to that kernel; tensors on the CPU go to `phase_b_blocks_plain`.
The choice is made on the input's device only.

The reference's wrapper splits C_b > 2048 into equal chunks, one launch
each, and combines their query sums (mu_max by max): that split exists for
the TPU's scoped VMEM. Here one launch takes any C_b; its sums equal the
split form's to reassociation roundoff.

On the card the launch is a grid of WORK UNITS, K5's design on this layout:
a unit is one 256-slot piece of a block's row (the last one possibly
partial), so every block of a bucket, which all have the same C_b, gets
`block_units(C_b)` units, and the grid needs no host table. A unit's
candidate-side sums are final; its query-side sums are partials that a
second small kernel adds in unit order. No output uses an atomic: two
launches on the same inputs give the same bits.
"""

from __future__ import annotations

import torch

from . import build
from .cuda_grouped_pairs import (
    BQ_KERNEL,
    PLAIN_PAIRS,
    _check_args,
    check_code,
    pair_sums_plain,
)

# the candidate fields in the grouped kernel's order (x y z vx vy vz h rho
# P/rho^2 mask) from this wrapper's (x y z vx vy vz mask h rho P/rho^2)
_GROUPED_ORDER = (0, 1, 2, 3, 4, 5, 7, 8, 9, 6)

launches = 0  # kernel launches made by phase_b_blocks (CUDA tensors only)


def block_units(cw: int) -> int:
    """Work units a block of cw candidate slots takes on the card (the
    kernel's own count: one 256-slot piece each, at least one)."""
    return build.load_kernels()["phase_b_grouped"].sph_phase_b_blocks_units(cw)


def phase_b_blocks_plain(
    qfields, cfields, m, alpha, beta, sigma, r_c_now, *, eos: str, p3m: bool, cap: int,
):
    """Plain PyTorch version: batches of blocks, each block's (cap, C_b)
    tile broadcast whole."""
    _check_args(eos, p3m, sigma)
    nb, cw = cfields[0].shape
    dtype, device = cfields[0].dtype, cfields[0].device
    q_out = [torch.empty((nb, cap), dtype=dtype, device=device) for _ in range(10)]
    c_out = [torch.empty((nb, cw), dtype=dtype, device=device) for _ in range(8)]
    per = max(1, PLAIN_PAIRS // max(cap * cw, 1))
    for r0 in range(0, nb, per):
        sl = slice(r0, r0 + per)
        q = tuple(a[sl][:, :, None] for a in qfields)
        c = tuple(cfields[k][sl][:, None, :] for k in _GROUPED_ORDER)
        qs, cs = pair_sums_plain(q, c, m, alpha, beta, sigma, r_c_now, eos=eos, p3m=p3m)
        for o, v in zip(q_out, qs):
            o[sl] = v
        for o, v in zip(c_out, cs):
            o[sl] = v
    return tuple(q_out), tuple(c_out)


def phase_b_blocks(
    qfields,  # 11-tuple of (nb, cap) query-side tensors
    cfields,  # 10-tuple of (nb, C_b) candidate-side tensors
    m, alpha, beta, sigma, r_c_now,
    *,
    eos: str,
    p3m: bool,
    cap: int,
):
    """Returns (10 query-side (nb, cap) tensors: ax ay az div mu_max visc gx
    gy gz gphi; 8 candidate-side (nb, C_b) tensors: sax say saz svisc sgx
    sgy sgz sgp). Field order: queries x y z vx vy vz mask h rho P/rho^2 cs,
    candidates x y z vx vy vz mask h rho P/rho^2."""
    _check_args(eos, p3m, sigma)
    c0 = cfields[0]
    if c0.device.type != "cuda":
        return phase_b_blocks_plain(
            qfields, cfields, m, alpha, beta, sigma, r_c_now, eos=eos, p3m=p3m, cap=cap
        )
    global launches
    nb, cw = c0.shape
    dtype, device = c0.dtype, c0.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"phase_b_blocks: unsupported dtype {dtype}")
    if cap != BQ_KERNEL:
        raise ValueError(
            f"phase_b_blocks: the kernel is built for {BQ_KERNEL} query rows a "
            f"block, not cap={cap}"
        )
    if len(qfields) != 11 or len(cfields) != 10:
        raise ValueError("phase_b_blocks takes 11 query and 10 candidate fields")
    for i, t in enumerate(qfields):
        build.check_tensor(f"qfields[{i}]", t, (nb, cap), dtype, device)
    for i, t in enumerate(cfields):
        build.check_tensor(f"cfields[{i}]", t, (nb, cw), dtype, device)
    scal = build.scalar_tensor(
        [m, alpha, beta, sigma if sigma is not None else 1.0, r_c_now], dtype, device
    )
    q_out = torch.empty((10, nb, cap), dtype=dtype, device=device)
    c_out = torch.empty((8, nb, cw), dtype=dtype, device=device)
    q_outs, c_outs = tuple(q_out.unbind(0)), tuple(c_out.unbind(0))
    if nb == 0:
        return q_outs, c_outs
    q_part = torch.empty((nb * block_units(cw), 10, cap), dtype=dtype, device=device)
    lib = build.load_kernels()["phase_b_grouped"]
    with torch.cuda.device(device):
        code = lib.sph_phase_b_blocks(
            build.pointer_array(list(qfields)),
            build.pointer_array([cfields[k] for k in _GROUPED_ORDER]),
            scal.data_ptr(), build.pointer_array(list(q_outs)),
            build.pointer_array(list(c_outs)), q_part.data_ptr(), nb, cw,
            int(eos == "isothermal"), int(p3m), int(dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream,
        )
    check_code("phase_b_blocks", code)
    launches += 1
    return q_outs, c_outs
