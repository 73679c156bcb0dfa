"""phase_a_cells: exact k-th neighbour distance + density per cell row.

Counterpart of the reference's TPU kernel
sphtpu/kernels/pallas_strip_knn.py::phase_a_cells. Tensors on a CUDA
device go to the hand-written kernel csrc/phase_a_cells.cu; tensors on the
CPU go to `phase_a_cells_plain`, the plain PyTorch version that repeats the
kernel body step by step. The choice is made on the input's device only.

Semantics: per query, d2 to every candidate of its cell row (invalid ->
+max), `n_bisect` binary count bisections on [0, 1.001 * reach2] for the
exact k-th distance, rk2 = max{d2 <= hi}, nfound = #{d2 <= rk2},
h = sqrt(rk2) / 2, rho = m * sum W over d2 <= rk2 (self pair included).
Ties at the k-th distance are all included (they sit at q = 2 where W
vanishes). Off-mask query rows return h = rho = 0, ok = 1.

The kernel reads a row's occupied candidates once, through shared memory
in pieces of `stage` slots, and keeps each query's in-radius squared
distances (d2 <= 1.001 * reach2, in candidate order) in a list of up to L
entries in shared memory; the bisection passes, rk2, nfound and rho run
over that list. Only those candidates can change any of them, so h and ok
are those of the full-row form bit for bit (the counts are integers) and
rho reassociates. A query with more than L in-radius candidates overflows
and takes the full-row sweep on the card (`last_overflow` counts such
queries). `list_budget` sizes L and `stage` for the card.
"""

from __future__ import annotations

import torch

from . import build
from .cubic_spline import W

N_BISECT = 34

# widest candidate row the kernel takes (twice the block engine's largest
# capacity, C_MENU[-1] = 32 768); wider rows raise
MAX_CW = 1 << 16

# The kernel's geometry (K1 and K4 alike): a CTA owns 32 query slots; its shared memory holds the
# three staged candidate planes (STAGE_BYTES of them) and one list per
# query slot, sized so that CTAS_PER_SM CTAs share an SM (each CTA also
# costs the SM 1 KB of reserved shared memory and 32 B of static share)
QUERIES_PER_CTA = 32
STAGE_BYTES = 24 * 1024
CTAS_PER_SM = 2
CTA_RESERVED = 1024 + 64

launches = 0  # kernel launches made by phase_a_cells (CUDA tensors only)
# queries of the last launch whose in-radius candidates overflowed L: an
# int32 tensor on the card, read only by measurements (never on the step path)
last_overflow = None


def phase_a_cells_plain(
    queries, reach2, cands, m, *, kh: int, cap: int,
    n_bisect: int = N_BISECT, row_chunk: int = 0,
):
    """Plain PyTorch version: broadcast (rows, cap', 1) against
    (rows, 1, cw'), row-chunked to bound the pair temporaries, over the
    chunk's occupied query and candidate columns only (cap' <= cap,
    cw' <= cw; `build.occupied_columns`)."""
    qx, qy, qz, qm = queries
    cx, cy, cz, cm = cands
    n_cells, cw = cx.shape
    dtype = cx.dtype
    big = torch.finfo(dtype).max
    if not row_chunk:
        row_chunk = max(1, 4_000_000 // max(cap * cw, 1))
    # off-mask query slots: h = rho = 0, ok = 1
    h_out = torch.zeros((n_cells, cap), dtype=dtype, device=cx.device)
    rho_out = torch.zeros_like(h_out)
    ok_out = torch.ones_like(h_out)
    zero = torch.zeros((), dtype=dtype, device=cx.device)
    one = torch.ones((), dtype=dtype, device=cx.device)
    for r0 in range(0, n_cells, row_chunk):
        sl = slice(r0, r0 + row_chunk)
        if not bool((qm[sl] > 0).any()):
            continue
        qc = build.occupied_columns(qm[sl])
        cc = build.occupied_columns(cm[sl])
        dx = qx[sl][:, qc, None] - cx[sl][:, None, cc]
        dy = qy[sl][:, qc, None] - cy[sl][:, None, cc]
        dz = qz[sl][:, qc, None] - cz[sl][:, None, cc]
        d2 = dx * dx + dy * dy + dz * dz
        valid = (cm[sl][:, None, cc] > 0) & (qm[sl][:, qc, None] > 0)
        d2m = torch.where(valid, d2, torch.full_like(d2, big))
        r2 = reach2[sl][:, qc, None]
        hi = 1.001 * r2
        lo = torch.zeros_like(r2)
        for _ in range(n_bisect):
            mid = 0.5 * (lo + hi)
            cnt = torch.sum(d2m <= mid, dim=2, keepdim=True)
            ge = cnt >= kh  # k-th distance <= mid: shrink to [lo, mid]
            lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
        inw = d2m <= hi
        rk2 = torch.max(torch.where(inw, d2m, zero), dim=2, keepdim=True).values
        within = d2m <= rk2
        nfound = torch.sum(within, dim=2, keepdim=True)
        h_t = torch.sqrt(rk2) / 2.0
        h_safe = torch.where(h_t > 0, h_t, one)
        w_k = W(torch.sqrt(d2) / h_safe, h_safe)
        rho_t = m * torch.sum(
            torch.where(valid & within, w_k, zero), dim=2, keepdim=True
        )
        row_ok = (qm[sl][:, qc, None] <= 0) | ((nfound >= kh) & (rk2 <= r2))
        h_out[sl, qc] = h_t[..., 0]
        rho_out[sl, qc] = rho_t[..., 0]
        ok_out[sl, qc] = row_ok[..., 0].to(dtype)
    return h_out, rho_out, ok_out


def list_stride(list_len: int) -> int:
    """Entries one query's list takes in shared memory: L rounded up to 32,
    plus 8, so the lists a warp reads at a time start on distinct banks
    (the kernel's `list_stride`)."""
    return -(-list_len // 32) * 32 + 8


def k1_shared_bytes(cap: int, list_len: int, stage: int, dtype) -> int:
    """Dynamic shared memory of one K1 or K4 CTA: the staged planes and the lists
    of its min(cap, 32) query slots (the kernel's `phase_a_smem`)."""
    slots = min(cap, QUERIES_PER_CTA)
    return (3 * stage + slots * list_stride(list_len)) * dtype.itemsize


def list_budget(cap: int, cw: int, dtype, smem_optin: int) -> tuple[int, int]:
    """(L, stage) of a K1 or K4 launch on a card whose blocks may opt into
    `smem_optin` bytes of shared memory: the staged raw candidate slots (the
    whole row where it is narrower than STAGE_BYTES of planes) and the
    largest multiple of 32 for L that leaves CTAS_PER_SM CTAs room on one
    SM. Raises where no list fits."""
    item = dtype.itemsize
    stage = min(cw, STAGE_BYTES // (3 * item))
    per_cta = min((smem_optin + 1024) // CTAS_PER_SM, smem_optin) - CTA_RESERVED
    slots = min(cap, QUERIES_PER_CTA)
    list_len = ((per_cta - 3 * stage * item) // (slots * item) - 8) // 32 * 32
    if list_len < 32:
        raise ValueError(
            f"phase_a_cells: no list fits {smem_optin} B of shared memory (cap {cap}, {dtype})"
        )
    return list_len, stage


def launch_sizes(cap: int, cw: int, dtype, device, stream_chunk: int = 0,
                 list_cap: int = 0) -> tuple[int, int]:
    """(L, stage) of a launch on `device`: `list_budget`'s, with stage
    capped at stream_chunk and L at list_cap where those are > 0 (the checks
    that force streaming and overflow)."""
    list_len, stage = list_budget(cap, cw, dtype, build.device_limits(device)[1])
    if stream_chunk > 0:
        stage = min(stage, stream_chunk)
    if list_cap > 0:
        list_len = min(list_len, list_cap)
    return list_len, stage


def phase_a_cells(
    queries,  # (qx, qy, qz, qm): each (n_cells, cap); qm = query mask
    reach2,  # (n_cells, cap) per-query certification radius^2
    cands,  # (cx, cy, cz, cm): each (n_cells, cw); cm = occupancy
    m,
    *,
    kh: int,
    cap: int,
    n_bisect: int = N_BISECT,
    stream_chunk: int = 0,
    list_cap: int = 0,
):
    """Returns (h, rho, ok) each (n_cells, cap); ok is 1.0 where the row
    certifies (masked-off, or k found with r_k^2 <= reach2).

    Shape-generic over cap and the candidate width cw <= MAX_CW. On the
    card, stream_chunk > 0 caps the candidate slots staged at a time and
    list_cap > 0 caps L (0: `list_budget`'s); h and ok do not depend on
    either, and checks of that force streaming and overflow with them."""
    cx = cands[0]
    if cx.device.type != "cuda":
        return phase_a_cells_plain(
            queries, reach2, cands, m, kh=kh, cap=cap, n_bisect=n_bisect
        )
    global launches, last_overflow
    n_cells, cw = cx.shape
    dtype, device = cx.dtype, cx.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"phase_a_cells: unsupported dtype {dtype}")
    for i, t in enumerate(queries):
        build.check_tensor(f"queries[{i}]", t, (n_cells, cap), dtype, device)
    build.check_tensor("reach2", reach2, (n_cells, cap), dtype, device)
    for i, t in enumerate(cands):
        build.check_tensor(f"cands[{i}]", t, (n_cells, cw), dtype, device)
    if cw > MAX_CW:
        raise ValueError(f"phase_a_cells: cw={cw} is wider than the kernel takes ({MAX_CW})")
    m_dev = build.scalar_tensor([m], dtype, device)
    h = torch.empty((n_cells, cap), dtype=dtype, device=device)
    rho = torch.empty_like(h)
    ok = torch.empty_like(h)
    if n_cells == 0:
        return h, rho, ok
    list_len, stage = launch_sizes(cap, cw, dtype, device, stream_chunk, list_cap)
    n_over = torch.empty((1,), dtype=torch.int32, device=device)  # zeroed by the entry
    lib = build.load_kernels()["phase_a_cells"]
    ptrs = build.pointer_array([*queries, reach2, *cands, m_dev, h, rho, ok, n_over])
    with torch.cuda.device(device):
        code = lib.sph_phase_a_cells(
            ptrs, n_cells, cap, cw, kh, n_bisect, stage, list_len,
            int(dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check("phase_a_cells", code)
    launches += 1
    last_overflow = n_over
    return h, rho, ok
