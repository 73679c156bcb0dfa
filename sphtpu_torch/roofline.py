"""Analytic operation and byte counts of the force pass, and the H100 roofline.

Port of sphtpu/roofline.py. Closed-form operation and memory-traffic counts
for each engine stage (the reference's, for the same arguments), held
against the card's peak rates, so a benchmark can report what share of the
card a force pass uses and which resource binds. Nothing on the run path
calls it.

Peaks (NVIDIA H100 80GB HBM3, SXM, 700 W; the figures PERF.md's kernel
table and chip_smoke.py's bounds use):

*   PEAK_F32 = 67e12 FLOP/s: NVIDIA's H100 SXM datasheet, FP32 without
    tensor cores (132 SMs x 128 FP32 lanes x 2 (FMA) x the 1.98 GHz boost
    clock). The SPH pair sweeps are elementwise and reduction work, so this,
    not a tensor-core rate, is their compute roof.
*   PEAK_HBM_BPS = 3.35e12 B/s: the same datasheet, HBM3 bandwidth.

A card set below 700 W runs slower under load; the report does not know
the limit, so record it beside every number (nvidia-smi).

Counts are per single force evaluation (one density + force + gravity
pass); a KDK step runs two. They are analytic (operations the formulation
must execute, transcendentals counted as 1, masked lanes counted), so the
shares are a conservative "useful work" utilisation.

Usage:

    cnt = block_force_counts(spec, n, kh, gravity="exact")
    cnt = add_counts(cnt, allpairs_gravity_counts(n))
    roof = roofline_report(cnt, seconds_per_pass)
"""

from __future__ import annotations

import math

# ---- H100 80GB HBM3 (SXM, 700 W) peaks --------------------------------------

PEAK_F32 = 67e12  # FLOP/s, FP32 without tensor cores, datasheet
PEAK_HBM_BPS = 3.35e12  # B/s, HBM3, datasheet


# ---- per-stage counts (the reference's formulas) -------------------------------


def _block_slots(spec) -> int:
    """Pair slots swept per phase: every bucket's (nb, BQ, C_b) tile
    (sentinel blocks included: the engine executes them)."""
    from .physics.blocks import BQ

    return sum(cb * nb for cb, nb in spec[0]) * BQ


def block_force_counts(spec, n: int, kh: int, *, gravity: str = "exact",
                       n_bisect: int | None = None, dtype_bytes: int = 4):
    """One block-compact force evaluation (physics/blocks.py), split by
    stage, with the reference's per-slot tallies:

    phase A: d2 (8) + n_bisect passes x (cmp + select + reduce ~ 3)
             + window/max/count (5) + density sqrt/W/accumulate (24)
    phase B: SPH pair terms ~ 70 + softened-gravity corrections ~ 55;
             the P3M tail ~ +25
    """
    from .physics.blocks import BQ, N_BISECT_HINT

    if n_bisect is None:
        n_bisect = N_BISECT_HINT
    slots = _block_slots(spec)
    nb_total = slots // BQ  # candidate-row slots (one per block x C_b)
    p3m = gravity == "p3m"

    f_a = slots * (8 + 3 * n_bisect + 5 + 24)
    f_b = slots * (70 + 55 + (25 if p3m else 0))
    # memory per evaluation: candidate planes once per block (phase A 4
    # fields + the index table; phase B 10 in + 8 out + the index table),
    # query planes (~11 in + 10 out a phase) once per packed row
    by_a = nb_total * (4 + 1) * dtype_bytes + n * 15 * dtype_bytes
    by_b = nb_total * (10 + 8 + 1) * dtype_bytes + n * 21 * dtype_bytes
    return {
        "flops": f_a + f_b,
        "bytes": by_a + by_b,
        "stages": {
            "phase_a": {"flops": f_a, "bytes": by_a, "slots": slots},
            "phase_b": {"flops": f_b, "bytes": by_b, "slots": slots},
        },
    }


def tile_force_counts(grid: int, cap: int, n: int, kh: int, *,
                      gravity: str = "exact", n_bisect: int = 34,
                      dtype_bytes: int = 4):
    """One mono-tile force evaluation (physics/tiles.py): every cell sweeps
    (cap, 27*cap) pair tiles for phase A (bisected kNN) and phase B (pair
    forces + near-gravity corrections)."""
    cells = grid**3
    cw = 27 * cap
    slots = cells * cap * cw
    p3m = gravity == "p3m"
    f_a = slots * (8 + 3 * n_bisect + 5 + 24)
    f_b = slots * (70 + 55 + (25 if p3m else 0))
    # prestacked candidate planes: 4 fields for phase A; phase B streams ~10
    # candidate planes a cell plus the query planes
    by_a = cells * cw * (4 + 1) * dtype_bytes + n * 15 * dtype_bytes
    by_b = cells * cw * (10 + 1) * dtype_bytes + n * 21 * dtype_bytes
    return {
        "flops": f_a + f_b,
        "bytes": by_a + by_b,
        "stages": {
            "phase_a": {"flops": f_a, "bytes": by_a, "slots": slots},
            "phase_b": {"flops": f_b, "bytes": by_b, "slots": slots},
        },
    }


def ctile_force_counts(classes, cap: int, n: int, kh: int, *,
                       gravity: str = "exact", n_bisect: int = 34,
                       dtype_bytes: int = 4):
    """One class-compacted tile force evaluation (physics/ctiles.py): each
    occupancy class k sweeps (n_cells_k, cap_k, 27*cap) pair tiles for
    phases A and B, the mono engine's count without its padded query rows.
    The prestack's build and gather (4 fields for A, 11 for B) is the extra
    memory term."""
    cw = 27 * cap
    slots = sum(nk * ck for ck, nk in classes) * cw
    n_cells = sum(nk for _, nk in classes)
    p3m = gravity == "p3m"
    f_a = slots * (8 + 3 * n_bisect + 5 + 24)
    f_b = slots * (70 + 55 + (25 if p3m else 0))
    by_a = n_cells * cw * (2 * 4 + 1) * dtype_bytes + n * 15 * dtype_bytes
    by_b = n_cells * cw * (2 * 11 + 1) * dtype_bytes + n * 21 * dtype_bytes
    return {
        "flops": f_a + f_b,
        "bytes": by_a + by_b,
        "stages": {
            "phase_a": {"flops": f_a, "bytes": by_a, "slots": slots},
            "phase_b": {"flops": f_b, "bytes": by_b, "slots": slots},
        },
    }


def allpairs_gravity_counts(n: int, dtype_bytes: int = 4):
    """The all-pairs Newtonian sweep (physics/gravity.py): N^2 pairs x
    (d2 8 + rsqrt 1 + cube/scale 4 + 3 axis FMAs 6 + phi 2); the candidate
    set (4 fields) streamed once per 512-row query tile."""
    f = n * n * 21
    tq = 512
    by = (n // tq + 1) * n * 4 * dtype_bytes + n * 8 * dtype_bytes
    return {"flops": f, "bytes": by,
            "stages": {"gravity_allpairs": {"flops": f, "bytes": by}}}


def p3m_mesh_counts(g_padded: int, n: int, dtype_bytes: int = 4):
    """The P3M mesh force (physics/mesh_gravity.py): CIC deposit (27 cells x
    ~10 ops), one forward and 3 inverse FFTs on the padded mesh (g_padded =
    EngineConfig.mesh_pad), the k-space multiply, the CIC gather of 4
    fields."""
    g = g_padded
    fft_one = 5.0 * g**3 * 3 * math.log2(max(g, 2))
    f = int(n * 27 * 10 + 4 * fft_one + g**3 * 8 + n * 27 * 12)
    by = int(8 * g**3 * dtype_bytes + n * 16 * dtype_bytes)
    return {"flops": f, "bytes": by,
            "stages": {"p3m_mesh": {"flops": f, "bytes": by}}}


def add_counts(*counts):
    out = {"flops": 0, "bytes": 0, "stages": {}}
    for c in counts:
        out["flops"] += c["flops"]
        out["bytes"] += c["bytes"]
        out["stages"].update(c["stages"])
    return out


def roofline_report(counts, seconds_per_pass: float):
    """Achieved rates against the H100's roof. `mfu_f32` is the headline:
    the achieved operation rate as a share of PEAK_F32 (FP32 without tensor
    cores; these sweeps are elementwise and reduction work). `hbm_frac` is
    the achieved byte rate over PEAK_HBM_BPS. `pct_roofline` is the achieved
    operation rate over the attainable one at the counts' arithmetic
    intensity, min(PEAK_F32, AI x PEAK_HBM_BPS); `bound` says which term
    binds."""
    f = counts["flops"]
    b = counts["bytes"]
    gflops = f / seconds_per_pass / 1e9
    gbs = b / seconds_per_pass / 1e9
    ai = f / max(b, 1)
    attainable = min(PEAK_F32, ai * PEAK_HBM_BPS)
    return {
        "gflop_per_pass": round(f / 1e9, 1),
        "gbyte_per_pass": round(b / 1e9, 3),
        "achieved_gflops": round(gflops, 1),
        "achieved_gbps": round(gbs, 2),
        "arithmetic_intensity": round(ai, 1),
        "mfu_f32": round(gflops * 1e9 / PEAK_F32, 4),
        "hbm_frac": round(gbs * 1e9 / PEAK_HBM_BPS, 4),
        "pct_roofline": round(100.0 * gflops * 1e9 / attainable, 2),
        "bound": "compute" if attainable == PEAK_F32 else "memory",
    }
