#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout,
holds each against its plain PyTorch version on the card, then drives the
port's paths, each with the launch counts set to 0 just before it and read
just after:

*   the class path: boss_bodenheimer, polytropic, N = 100 000, Kh = 32,
    float32, four steps, which the planner gives the class-compacted tile
    engine with exact gravity (kernels K1, K2, K3);
*   the exact path: the headline scene, the same at Kh = 50, which the
    planner gives the mono-tile engine with exact gravity (K4, K2, K3);
*   the P3M path: the same scene at N = 200 000, four steps with
    gravity="auto", which plans the mono-tile engine with the FFT mesh
    and the W = 2 tail (kernels K4, K2 and the tail kernel; K3 0 times),
    then the P3M force error against the exact sweep on its final state
    and its float32 gravity corrections against float64, with a close
    pair's two corrections in two sweeps (the reference's) and as one
    float64 term (ROADMAP D21, what the run loop does);
*   the collapse path: the committed deep-collapse state
    bench_data/bb_collapsed.npz (N = 100 000, density contrast 395)
    written as a snapshot through the port's writer and run four steps
    through the CLI, which no tile engine can plan: the block-compact
    engine with exact gravity (K1 once a capacity bucket, K5, K3 each
    evaluation), then one step on its per-bucket phase B (K6), one block
    evaluation against the gather engine's, and one evaluation of
    bench_data/bb_collapsed_deep.npz (contrast 1001) in each gravity mode
    with the P3M force error against the exact sweep;
*   the collapse path under P3M: bb_collapsed.npz through
    run_simulation(gravity="p3m") for six steps, three 2-step block chunks
    whose plans cover the tail radius with its drift margin (ROADMAP D19):
    no evaluation may fall back; the plan's buckets and K5's time on one
    evaluation beside the plan without the margin (the reference's);
*   the multi-level path: bb_collapsed_deep.npz on the multi-level engine
    (physics/mlevel.py, K1 once a level x bucket, K3 under exact gravity)
    in each gravity mode: the plan, one evaluation against the block
    engine's with both split by stage, the P3M force error and, under
    P3M, the float32 gravity corrections against float64 (two sweeps and
    the run loop's joint term), a 2-step chunk with its certificate per
    evaluation; then four CLI steps with plan_blocks made to decline, so
    that the run loop's ladder plans the multi-level engine;
*   the outlier lane: bb_collapsed.npz on the mono-tile engine with its
    outlier budget (choose_tile_params_ml: grid 27, cap 160, budget 65 536,
    26 921 outlier rows; K4, K2 with its outlier masks, K3 or the tail) in
    each gravity mode: the plan from the stored and the KD-tree h, one
    evaluation against the block engine's with both split by stage, the P3M
    force error, a 2-step chunk with its certificate per evaluation; then
    four CLI steps with plan_blocks and plan_mlevel made to decline, so that
    the run loop's ladder plans the outlier rung; then dense_forces and
    knn_celllist, off the production path, once each on the card;
*   the multi-device layer on four shards of the card: the headline scene
    (exact gravity) and the P3M scene through run_simulation(n_devices=4,
    devices=[cuda:0] * 4) for four steps, which plans the z-slab tile engine
    (K4, K2, and K3's rows x columns entry in the ring or the tail kernel),
    each with a 2-step slab chunk of its final state against the
    single-device chunk and one evaluation split by stage, whose K4, K2
    and tail launches (one a shard, at the slab's shapes; under P3M K2's
    joint mode and the tail's skip mode, as the run loop launches them)
    are held against their plain versions in float32 and float64, and
    under P3M its float32 gravity corrections against float64; then
    bb_collapsed.npz the same way, where no slab plan certifies and the
    work-sharded block engine carries every chunk (K1, K5, rows x columns),
    one evaluation against the single-device block engine, and one
    bb_collapsed_deep.npz evaluation on the work-sharded multi-level engine;
*   the multi-process layer (shard/multihost.py over torch.distributed):
    two gloo ranks, spawned after the kernels are built, each with two
    shards of the card and a hard time limit. multihost_work: bb_collapsed.npz
    through run_simulation(multihost=True) for four steps, each rank on its
    own copy of the snapshot (the work-sharded block engine: K1, K5, rows x
    columns), held against the one-process four-shard run above (ranks
    identical; bit-equal or within the shard bars; rank 1 writes no file);
    with two or more cards the same with NCCL, one card a rank, else a line
    saying it did not run. multihost_slabs: the headline run's final state
    state-sharded with shard/mh_slabs.py (each rank bootstraps from half of
    the rows, plans from summed histograms, migrates, packs its own shards)
    for one 2-step slab chunk (K4, K2, rows x columns) against the
    one-process chunk, rank 0's launches held against their plain versions.
    Each line gives the ranks' s/step beside the one-process figure and the
    seconds spent in the exchanges.

Every phase prints one JSON line; any failure raises, so the process exits
non-zero. There is no CPU continuation: with no CUDA device the script
fails before it prints a result.

The line before the last two is `{"kernels": [...]}` with, per kernel, its
launches on the path its times were taken on (K1, K2, K3: the class path;
K1 also on the multi-level path's exact chunk, under "on_mlevel_path";
K2 also on the outlier path's exact chunk, with its outlier masks, under
"on_outlier_path", with the share of occupied pairs its cull keeps;
K4 and the tail: the P3M path; K5: the collapse path; K6: the collapse
path's per-bucket step; K3's rows x columns entry, `newton_rows_cols`: the
sharded exact path, on the ring's and the row-sharded inputs; K2, K4 and
the tail also on the slab paths, under "on_slab_exact_path" and
"on_slab_p3m_path") and on every
path (`launches_by_path`; a multi-process path once a rank), its
error against the plain version and its time beside the plain version's
and the card's bound, all on the inputs that one force evaluation of that
path's final state gives it (K2 carries the exact and the P3M paths'
numbers under "on_exact_path" and "on_p3m_path", K4 the exact path's under
"on_exact_path", K1 the collapse path's under "on_collapse_path", K3
the exact path's under "on_exact_path": every kernel is held against its
plain version on the inputs of every path that launches it). K1 and K4
also report the share of valid queries whose in-radius candidates
overflowed their list, and on every input they are checked with the row
forced to stream in 1 000-slot pieces (no bit may change) and with the
list forced to overflow (h and ok bit-identical); K3 reports its plan (R,
S, grid) and that two launches are bit-identical; K5 is held against its
plain version in float32 and float64 on every input (the synthetic blocks,
the collapse path's and both gravity modes of the contrast-1001 state),
must give two bit-identical launches, and reports its work units; on
ROADMAP F7's draw (the sequence of draws that found it, `kernels_f7`) K5 and K6 in
float32 are held against their plain version in float64; K2 (the
four EOS x P3M variants in float32 and float64 on class rows, on mono rows
at cap 160 and 256 with rows filled to cap, and on every path's inputs)
must give two bit-identical launches and the same bits with its cull off
(`keep_all`), its joint mode (`joint`, ROADMAP D21: a close pair's two
gravity corrections as one float64 term) likewise on the mono rows, with
and without the outlier masks, and without P3M the same bits with its outlier masks on
where no slot is marked an outlier (its outlier variant is held against
its plain version on the synthetic rows and on the outlier path), and the tail (W = 1, 2 and 3 at cap 160 and W = 2 at cap
256, float32 and float64, cells filled to cap, and the P3M path's inputs)
two bit-identical launches, its skip mode (`skip_joint`, the pairs K2's
joint mode takes left out) likewise, and K2's joint mode plus the tail's
skip mode within check_phase_b's bars of the two sweeps in float64 (the
line's "f8_modes"). A time ("ms") is CUDA events around the
wrapper, so a short launch's time holds the wrapper's host work
(tools/chip_k1k3.py gives each kernel's device time alone). A bound
counts the bytes the
function needs: the occupancy plane of a padded slot layout whole, its
other planes at the occupied slots only; phase A's operations count the
pass work only on the pairs inside 1.001 reach2. Then the card's name and
power limit as nvidia-smi prints them, then the verdict line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import sphtpu_torch
from sphtpu_torch import cli
from sphtpu_torch.engine import EngineConfig, make_chunk_runner, state_from_numpy
from sphtpu_torch.engine.driver import CHUNK_REPAIRS, EVAL_REPAIRS, PLAN_REPAIRS
from sphtpu_torch.engine.step import force_eval
from sphtpu_torch.io import read_snapshot, snapshot_path
from sphtpu_torch.kernels import (
    build,
    cuda_block_pairs,
    cuda_gravity,
    cuda_gravity_rc,
    cuda_grouped_pairs,
    cuda_knn,
    cuda_p3m_tail,
    cuda_strip_knn,
    cuda_tile_pairs,
)
from sphtpu_torch.physics import blocks, ctiles, gravity_newton_allpairs, mlevel, tiles
from sphtpu_torch.physics.ctiles import CLASS_MENU, choose_tile_classes
from sphtpu_torch.physics.mesh_gravity import greens_hat, p3m_mesh_force

DEVICE = "cuda"
N_MAIN = 100_000  # particles of the exact paths' scenes
KH_CLASS = 32  # neighbour count of the class path's scene (Kh = 50 plans cap 160)
N_P3M = 200_000  # particles of the P3M path's scene (gravity="auto" picks P3M)
N_SMALL = 5_000  # particles of the fallback phase's scenes
N_DENSE = 4_000  # particles of the off-path phase's dense_forces run
ROWS_F32, ROWS_F64 = 256, 64  # synthetic cell rows per class in the kernels phase
N_NEWTON = {torch.float32: 100_000, torch.float64: 20_000}
N_NEWTON_ONE_SLICE = 1_500  # small enough that K3's plan has one column slice
# synthetic block rows of the kernels phase: candidate widths C_b and blocks
# per width (f32 from 24 576 and f64 from 12 288 on, K1 streams its rows)
BLOCK_ROWS = {torch.float32: ((512, 4096, 24576, 32768), 16),
              torch.float64: ((512, 4096, 12288, 32768), 4)}

# Published peaks of one H100 SXM (dense, no sparsity): float32 outside the
# tensor cores, float64 likewise, and HBM bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_BYTES = 3.35e12
# Operations the FUNCTIONS need (not what the kernels happen to do), per
# (query, occupied candidate) pair. Phase A: d2 and one compare against
# hi0 = 1.001 reach2 once; a compare and a count on each of the
# n_bisect + 3 passes only for the pairs with d2 <= hi0 (no other pair can
# change a count, rk2 or rho); the spline W on the ~kh pairs inside the
# k-th distance. Phase B: d2, 1/r, the three mask radii and their compares
# on every pair; the full body (140, counted on phase_b_tiles, the test
# included) only on pairs inside a mask.
K1_OPS_D2 = 8  # 3 sub, 3 mul, 2 add
K1_OPS_PAIR_TEST = K1_OPS_D2 + 1
K1_OPS_PER_PASS = 2
K1_OPS_W = 12
K2_OPS_MASK_TEST = 20
K2_OPS_PER_PAIR = 140
K3_FLOPS_PER_PAIR = 20
# P3M tail: d2 (8), rsqrt, t and z (3), u (2), the degree-8 Horner chain
# (16), exp(-z^2) (3), erfc and f (4), 1/r^3 and cgp (3), four sums (8)
TAIL_OPS_PER_PAIR = 48
B_OUTPUTS = "ax ay az div mu_max visc ggx ggy ggz gphi".split()
TAIL_OUTPUTS = "gx gy gz gphi".split()
MODULES = {
    "phase_a_cells": cuda_strip_knn,
    "phase_b_tiles": cuda_tile_pairs,
    "newton_sweep": cuda_gravity,
    "phase_a_tile": cuda_knn,
    "p3m_tail": cuda_p3m_tail,
    "phase_b_grouped": cuda_grouped_pairs,
    "phase_b_blocks": cuda_block_pairs,
    "newton_rows_cols": cuda_gravity_rc,
}
KERNEL_INFO = {
    "phase_a_cells": (
        "sphtpu_torch/kernels/csrc/phase_a_cells.cu",
        "sphtpu/kernels/pallas_strip_knn.py:139",
    ),
    "phase_b_tiles": (
        "sphtpu_torch/kernels/csrc/phase_b_tiles.cu",
        "sphtpu/kernels/pallas_tile_pairs.py:212",
    ),
    "newton_sweep": (
        "sphtpu_torch/kernels/csrc/newton_sweep.cu",
        "sphtpu/kernels/pallas_gravity.py:75",
    ),
    "phase_a_tile": (
        "sphtpu_torch/kernels/csrc/phase_a_cells.cu",
        "sphtpu/kernels/pallas_knn.py:117",
    ),
    "p3m_tail": (
        "sphtpu_torch/kernels/csrc/p3m_tail.cu",
        "sphtpu/physics/tiles.py:786 (phase C, XLA: no TPU kernel)",
    ),
    "phase_b_grouped": (
        "sphtpu_torch/kernels/csrc/phase_b_grouped.cu",
        "sphtpu/kernels/pallas_grouped_pairs.py:241",
    ),
    "phase_b_blocks": (
        "sphtpu_torch/kernels/csrc/phase_b_grouped.cu",
        "sphtpu/kernels/pallas_block_pairs.py:230",
    ),
    "newton_rows_cols": (
        "sphtpu_torch/kernels/csrc/newton_sweep.cu",
        "sphtpu/kernels/pallas_gravity.py:99 (K3's function, rows x columns: the sharded "
        "sweeps sphtpu/shard/tiles.py:862 and sphtpu/shard/mlevel.py:60 are XLA)",
    ),
}


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def run_text(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Median time of fn() by CUDA events."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def sync() -> None:
    torch.cuda.synchronize()


def dev(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE, dtype)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def slot_bytes(mask, n_other: int) -> int:
    """Bytes a function needs of a padded slot layout: its occupancy plane
    whole, and its `n_other` other planes (of the same shape) only at the
    occupied slots; the empty slots carry nothing it reads."""
    return (mask.numel() + int((mask > 0).sum()) * n_other) * mask.element_size()


# --------------------------------------------------------------------------
# synthetic kernel inputs at production shapes (numpy seed)
# --------------------------------------------------------------------------


def synthetic_rows(rng, n_cells, cap_k, cap, dtype, occupancy, full_rows=0):
    """Cell rows shaped like the class-compacted engine's: cw = 27 * cap
    candidate slots of which `occupancy` of each cell's cap slots are
    filled, positions inside a 3^3 block of unit cells, the queries being
    the centre cell's first cap_k slots. The first `full_rows` rows have
    every cell filled to cap."""
    cw = 27 * cap
    n_occ = max(1, min(cap_k, int(occupancy)))
    slot = np.arange(cap)[None, None, :]
    fill = rng.integers(max(1, n_occ // 2), n_occ + 1, size=(n_cells, 27, 1))
    fill[:full_rows] = cap
    cm = (slot < fill).astype(np.float64)
    cell = np.arange(27)
    off = np.stack([cell % 3, (cell // 3) % 3, cell // 9], 0)  # (3, 27)
    pos = [
        ((rng.random((n_cells, 27, cap)) + off[a][None, :, None]) * cm).reshape(n_cells, cw)
        for a in range(3)
    ]
    cm = cm.reshape(n_cells, cw)
    sl = slice(13 * cap, 13 * cap + cap_k)
    fields = {"x": pos[0], "y": pos[1], "z": pos[2], "m": cm}
    for name in ("vx", "vy", "vz"):
        fields[name] = 0.3 * rng.standard_normal((n_cells, cw)) * cm
    fields["por2"] = (0.5 + rng.random((n_cells, cw))) * cm
    fields["cs"] = (0.8 + 0.4 * rng.random((n_cells, cw))) * cm
    t = {k: dev(v, dtype) for k, v in fields.items()}
    return t, sl, cw


def check_phase_a(h_k, rho_k, ok_k, h_p, rho_p, ok_p, queries, reach2, cands, rho_rtol):
    """Kernel vs plain for phase A. h and ok derive from integer counts on
    an exactly rounded d2, so they must agree exactly; a row may differ
    only where a candidate sits within 2 ulp of the k-th distance or the
    k-th distance within 2 ulp of the reach (a tie). Returns
    (max_abs_err of rho, rows that differ and are ties)."""
    differ = (h_k != h_p) | (ok_k != ok_p)
    tie_rows = 0
    if bool(differ.any()):
        eps = torch.finfo(h_k.dtype).eps
        rows, cols = torch.nonzero(differ, as_tuple=True)
        for r, c in zip(rows.tolist(), cols.tolist()):
            d2 = sum((queries[a][r, c] - cands[a][r]) ** 2 for a in range(3))
            d2 = d2[cands[3][r] > 0]
            rk2 = max((2 * h_k[r, c]) ** 2, (2 * h_p[r, c]) ** 2)
            near = ((d2 - rk2).abs() <= 4 * eps * rk2).sum() > 1
            near |= (rk2 - reach2[r, c]).abs() <= 4 * eps * rk2
            if not bool(near):
                raise AssertionError(
                    f"phase_a_cells: row {r} slot {c} differs with no tie: "
                    f"h {h_k[r, c].item()} vs {h_p[r, c].item()}, "
                    f"ok {ok_k[r, c].item()} vs {ok_p[r, c].item()}"
                )
            tie_rows += 1
    same = ~differ
    err = (rho_k - rho_p).abs()[same]
    bad = err > rho_rtol * rho_p.abs()[same]
    if bool(bad.any()):
        raise AssertionError(
            f"phase_a_cells rho: max abs err {err.max().item()} over rtol {rho_rtol}"
        )
    return float(err.max()) if err.numel() else 0.0, tie_rows


FORCED_LIST = 32  # L of the forced-overflow check: below kh, so every query overflows
FORCED_STAGE = 1000  # raw slots a piece of the forced-streaming check


def phase_a_variants(launch, module, queries, reach2, cands, out_k, out_p, rho_rtol):
    """A phase-A kernel's launch `out_k` (K1 or K4; launch(**extra) launches
    it again on the same inputs, module.last_overflow counts its
    overflowed queries) against its own variants: the share of the valid
    queries whose in-radius candidates overflowed L; the rows forced to
    stream in FORCED_STAGE-slot pieces, which must not change a bit; L
    forced to FORCED_LIST, which sends the queries to the full-row sweep:
    h and ok bit-identical to out_k, rho within the bar against the plain
    version."""
    launch()
    valid = int((queries[3] > 0).sum())
    over = int(module.last_overflow.item())
    out_s = launch(stream_chunk=FORCED_STAGE)
    if not all(bool(torch.equal(a, b)) for a, b in zip(out_k, out_s)):
        raise AssertionError(f"{module.__name__}: rows streamed in pieces differ")
    out_f = launch(list_cap=FORCED_LIST)
    forced = int(module.last_overflow.item())
    if not (bool(torch.equal(out_f[0], out_k[0])) and bool(torch.equal(out_f[2], out_k[2]))):
        raise AssertionError(f"{module.__name__}: forced overflow changes h or ok")
    check_phase_a(*out_f, *out_p, queries, reach2, cands, rho_rtol)
    return {"valid_queries": valid, "overflowed": over,
            "overflow_share": over / max(valid, 1),
            "forced_overflow_share": forced / max(valid, 1),
            "forced_overflow_h_ok_equal": True, "streamed_equal": True}


def k1_variants(args, kw, out_k, out_p, rho_rtol):
    """`phase_a_variants` of a K1 launch on args = (queries, reach2, cands, m)."""
    return phase_a_variants(lambda **x: cuda_strip_knn.phase_a_cells(*args, **kw, **x),
                            cuda_strip_knn, args[0], args[1], args[2], out_k, out_p, rho_rtol)


def k4_variants(args, kw, out_k, out_p, rho_rtol):
    """`phase_a_variants` of a K4 launch on args = (cands, s2, m): the queries
    are the centre cell's slots, every query's reach s2."""
    cands, s2 = args[0], args[1]
    cap = kw["cap"]
    queries = tuple(c[:, 13 * cap : 14 * cap] for c in cands)
    reach2 = torch.as_tensor(s2, dtype=cands[0].dtype, device=DEVICE).expand(
        cands[0].shape[0], cap)
    return phase_a_variants(lambda **x: cuda_knn.phase_a_tile(*args, **kw, **x), cuda_knn,
                            queries, reach2, cands, out_k, out_p, rho_rtol)


def check_phase_b(outs_k, outs_p, dtype, names=B_OUTPUTS, kernel="phase_b_tiles"):
    """Kernel vs plain for a pair-sum kernel (phase B, the P3M tail):
    |a - b| <= rtol |b| + atol * (largest |b| of that output). The outputs
    are sums of signed pair terms that largely cancel for a particle with
    isotropic neighbours, so roundoff scales with the terms — of the size
    of the output's largest values — not with the particle's own (possibly
    cancelled) result. Returns the worst error over that scale."""
    rtol, atol = (2e-4, 2e-5) if dtype == torch.float32 else (1e-9, 1e-11)
    worst = 0.0
    for name, a, b in zip(names, outs_k, outs_p):
        live = b > -torch.finfo(b.dtype).max  # mu_max of masked rows is -max
        scale = float(b[live].abs().max()) if bool(live.any()) else 0.0
        err = (a - b).abs()
        if not bool((err <= rtol * b.abs() + atol * scale).all()):
            raise AssertionError(
                f"{kernel} {name}: max abs err {err.max().item()} "
                f"(rtol {rtol}, atol {atol} of the output's scale {scale})"
            )
        if scale > 0:
            worst = max(worst, float(err.max()) / scale)
    return worst, rtol, atol


def phase_kernels(seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    cap = CLASS_MENU[-1]
    kh = 50
    m = 1.0e-5
    report = {"cw": 27 * cap, "kh": kh, "cases": []}
    for dtype in (torch.float32, torch.float64):
        n_rows = ROWS_F32 if dtype == torch.float32 else ROWS_F64
        for cap_k in CLASS_MENU:
            t, sl, cw = synthetic_rows(rng, n_rows, cap_k, cap, dtype, 0.8 * cap_k)
            queries = tuple(t[k][:, sl].contiguous() for k in ("x", "y", "z", "m"))
            queries[3][1] = 0  # one masked-off query row
            cands = tuple(t[k] for k in ("x", "y", "z", "m"))
            reach2 = torch.full((n_rows, cap_k), 1.0, dtype=dtype, device=DEVICE)
            reach2[2] = 0.05  # one row whose reach cannot certify
            res_p = cuda_strip_knn.phase_a_cells_plain(
                queries, reach2, cands, m, kh=kh, cap=cap_k
            )
            case = {"dtype": str(dtype)[6:], "cap_k": cap_k, "rows": n_rows}
            h_k, rho_k, ok_k = cuda_strip_knn.phase_a_cells(
                queries, reach2, cands, m, kh=kh, cap=cap_k
            )
            sync()
            rho_rtol = 2e-5 if dtype == torch.float32 else 1e-12
            err, ties = check_phase_a(
                h_k, rho_k, ok_k, *res_p, queries, reach2, cands, rho_rtol
            )
            variants = k1_variants((queries, reach2, cands, m), dict(kh=kh, cap=cap_k),
                                   (h_k, rho_k, ok_k), res_p, rho_rtol)
            case["a"] = {"rho_max_abs_err": err, "rho_rtol": rho_rtol, "tie_rows": ties,
                         **variants}
            if not (bool((ok_k[2][queries[3][2] > 0] == 0).all()) and bool((ok_k[1] == 1).all())):
                raise AssertionError("phase_a_cells: certificate rows wrong")

            # phase B on phase A's own output for the centre cell, plausible
            # h/rho elsewhere
            ch = dev(0.3 + 0.2 * rng.random((n_rows, cw)), dtype) * t["m"]
            crho = dev(0.5 + rng.random((n_rows, cw)), dtype) * t["m"]
            ch[:, sl], crho[:, sl] = h_k, rho_k
            order = ("x", "y", "z", "vx", "vy", "vz", "m")
            cfields = tuple(t[k] for k in order) + (ch, crho, t["por2"], t["cs"])
            qfields = tuple(c[:, sl].contiguous() for c in cfields)
            qfields[6][1] = 0
            for eos in ("polytropic", "isothermal"):
                for p3m in (False, True):
                    sigma = 1.0 / 10 * 2.2 if p3m else None  # mesh_factor = 10
                    args = (qfields, cfields, m, 1.0, 2.0, sigma)
                    kw = dict(eos=eos, p3m=p3m, cap=cap_k)
                    outs_k = cuda_tile_pairs.phase_b_tiles(*args, **kw)
                    sync()
                    outs_p = cuda_tile_pairs.phase_b_tiles_plain(*args, **kw)
                    worst, rtol, atol = check_phase_b(outs_k, outs_p, dtype)
                    big = torch.finfo(dtype).max
                    if not bool((outs_k[4][1] == -big).all() and (outs_k[0][1] == 0).all()):
                        raise AssertionError("phase_b_tiles: masked row wrong")
                    case[f"b_{eos[:4]}_{'p3m' if p3m else 'exact'}"] = {
                        "max_err_over_scale": worst, "rtol": rtol, "atol_of_scale": atol,
                        **k2_repeats(args, kw, outs_k),
                    }
            report["cases"].append(case)

    # K3: N = 100 000 in f32, a smaller N in f64, and an N whose plan has
    # one column slice
    for dtype, n in (*N_NEWTON.items(), (torch.float32, N_NEWTON_ONE_SLICE)):
        pos = dev(rng.standard_normal((n, 3)), dtype)
        case = check_newton(pos, 1.0 / n)
        if n == N_NEWTON_ONE_SLICE and case["plan"]["S"] != 1:
            raise AssertionError(f"newton_sweep: N = {n} plans {case['plan']['S']} slices")
        report["cases"].append({"dtype": str(dtype)[6:], "newton_n": n, **case})
    # the cases added with the redesigned K2 and tail draw from their own
    # generator, so the earlier cases keep their inputs
    rng_new = np.random.default_rng(seed + 1)
    report["cases"] += (kernels_k4(rng, kh, m) + kernels_tail(rng, rng_new, m)
                        + kernels_blocks(rng, m) + kernels_k2_mono(rng_new, m)
                        + kernels_f7(m, seed))
    f8 = kernels_f8(m)
    report["cases"] += f8
    report["tie_rows_total"] = sum(
        c[k]["tie_rows"] for c in report["cases"] for k in ("a", "k4") if k in c
    )
    say("kernels", **report, kernels=list(MODULES))
    return f8


def newton_plan(n, dtype):
    """K3's plan on this card: R, threads, S, the slice width and the grid."""
    rows, threads, n_slices = cuda_gravity.split_plan(
        n, build.device_limits(DEVICE)[0], dtype)
    return {"R": rows, "threads": threads, "S": n_slices,
            "slice_cols": cuda_gravity.column_slices(n, n_slices, threads),
            "grid": [-(-n // (threads * rows)), n_slices]}


def check_newton(pos, m):
    """K3 against its plain version: g within 2e-4 (f32) / 1e-10 (f64) of
    the largest |g|, phi within the same relative bar, and two launches
    bit-identical (the partial sums are added in a fixed order)."""
    g_k, p_k = cuda_gravity.newton_sweep(pos, m)
    g_k2, p_k2 = cuda_gravity.newton_sweep(pos, m)
    sync()
    g_p, p_p = cuda_gravity.newton_sweep_plain(pos, m)
    rtol = 2e-4 if pos.dtype == torch.float32 else 1e-10
    g_err = float((g_k - g_p).abs().max())
    p_err = float(((p_k - p_p).abs() / p_p.abs()).max())
    if g_err > rtol * float(g_p.abs().max()) or p_err > rtol:
        raise AssertionError(f"newton_sweep {pos.dtype}: g err {g_err}, phi rel err {p_err}")
    if not (bool(torch.equal(g_k, g_k2)) and bool(torch.equal(p_k, p_k2))):
        raise AssertionError("newton_sweep: two launches on the same input differ")
    return {"g_max_abs_err": g_err, "phi_max_rel_err": p_err, "rtol_of_max": rtol,
            "max_abs_err": max(g_err, float((p_k - p_p).abs().max())),
            "runs_bit_identical": True, "plan": newton_plan(pos.shape[0], pos.dtype)}


def kernels_k4(rng, kh, m):
    """K4 vs its plain version on synthetic mono-tile rows: the queries are
    the centre cell of each 27-cell row, one uniform s2 (the unit cell
    edge squared, so most rows certify and the sparser ones do not), with
    `k4_variants`' checks and overflow shares (at cap 160 and 70 %
    occupancy a query has ~470 in-radius candidates: none overflows L =
    672 in float32, most overflow L = 320 in float64)."""
    cases = []
    for dtype in (torch.float32, torch.float64):
        n_rows = ROWS_F32 if dtype == torch.float32 else ROWS_F64
        for cap in (128, 160):
            t, sl, cw = synthetic_rows(rng, n_rows, cap, cap, dtype, 0.7 * cap)
            t["m"][3, sl] = 0  # one cell with no particle
            cands = tuple(t[k] for k in ("x", "y", "z", "m"))
            queries = tuple(c[:, sl] for c in cands)
            rho_rtol = 2e-5 if dtype == torch.float32 else 1e-12
            # s2 = 1: most rows certify; s2 = 0.05: no occupied row can
            for s2 in (1.0, 0.05):
                kw = dict(kh=kh, cap=cap)
                h_k, rho_k, ok_k = cuda_knn.phase_a_tile(cands, s2, m, **kw)
                sync()
                res_p = cuda_knn.phase_a_tile_plain(cands, s2, m, **kw)
                reach2 = torch.full((n_rows, cap), s2, dtype=dtype, device=DEVICE)
                err, ties = check_phase_a(
                    h_k, rho_k, ok_k, *res_p, queries, reach2, cands, rho_rtol
                )
                variants = k4_variants((cands, s2, m), kw, (h_k, rho_k, ok_k), res_p, rho_rtol)
                if not bool((ok_k[3] == 1).all() and (h_k[3] == 0).all()):
                    raise AssertionError("phase_a_tile: empty cell row wrong")
                cases.append({
                    "dtype": str(dtype)[6:], "cap": cap, "rows": n_rows, "s2": s2,
                    "k4": {"rho_max_abs_err": err, "rho_rtol": rho_rtol, "tie_rows": ties,
                           "rows_failing_cert": int((ok_k == 0).any(1).sum()), **variants},
                })
            if not bool((ok_k[queries[3] > 0] == 0).all()):
                raise AssertionError("phase_a_tile: rows certify beyond s2")
    return cases


def same_bits(a, b) -> bool:
    return all(bool(torch.equal(x, y)) for x, y in zip(a, b))


def k2_repeats(args, kw, outs_k):
    """K2's launch `outs_k` against a second launch on the same inputs and
    against a launch that keeps every occupied pair (no cull): both must
    give the same bits (a pair outside every mask adds exact zeros)."""
    again = cuda_tile_pairs.phase_b_tiles(*args, **kw)
    if not same_bits(outs_k, again):
        raise AssertionError(f"phase_b_tiles {kw}: two launches differ")
    every = cuda_tile_pairs.phase_b_tiles(*args, **kw, keep_all=True)
    if not same_bits(outs_k, every):
        worst = max(float((x - y).abs().max()) for x, y in zip(outs_k, every))
        raise AssertionError(f"phase_b_tiles {kw}: the cull changes the result ({worst})")
    return {"runs_bit_identical": True, "keep_all_bit_identical": True}


def k2_outlier_cases(args, kw, outs_k, sl):
    """K2 with its outlier masks on synthetic rows: where no slot is marked
    an outlier it gives the bits of the launch without them (`outs_k`);
    with about a quarter of the occupied slots marked (mask 2; the query
    slots are the candidates' centre-cell slots `sl`; drawn from a
    generator of their own, so that the other cases keep their inputs)
    within check_phase_b's bars of the plain version, two launches
    bit-identical, the cull against keep-all bit-identical."""
    rng = np.random.default_rng(9)
    cm = args[1][6]
    kw_o = dict(kw, outlier=True)
    if not same_bits(outs_k, cuda_tile_pairs.phase_b_tiles(*args, **kw_o)):
        raise AssertionError(f"phase_b_tiles {kw}: the outlier masks without outliers "
                             "change the bits")
    cm2 = cm + (dev(rng.random(tuple(cm.shape)), cm.dtype) < 0.25).to(cm.dtype) * (cm > 0)
    args_o = (args[0][:6] + (cm2[:, sl].contiguous(),) + args[0][7:],
              args[1][:6] + (cm2,) + args[1][7:], *args[2:])
    out_o = cuda_tile_pairs.phase_b_tiles(*args_o, **kw_o)
    sync()
    worst, rtol, atol = check_phase_b(
        out_o, cuda_tile_pairs.phase_b_tiles_plain(*args_o, **kw_o), cm.dtype)
    return {"no_outlier_bit_identical": True, "outlier_slots": int((cm2 > 1).sum()),
            "max_err_over_scale": worst, "rtol": rtol, "atol_of_scale": atol,
            **k2_repeats(args_o, kw_o, out_o)}


def kernels_k2_mono(rng, m):
    """K2 on mono-tile rows (cap 160, the paths' capacity, and 256, the mono
    planner's ceiling), all four (EOS, P3M) variants in both dtypes, the
    first two rows filled to cap: within check_phase_b's bars, two launches
    bit-identical, the cull against keep-all bit-identical."""
    cases = []
    for dtype, n_rows in ((torch.float32, 32), (torch.float64, 8)):
        for cap in (160, 256):
            t, sl, cw = synthetic_rows(rng, n_rows, cap, cap, dtype, 0.6 * cap, full_rows=2)
            ch = dev(0.3 + 0.2 * rng.random((n_rows, cw)), dtype) * t["m"]
            crho = dev(0.5 + rng.random((n_rows, cw)), dtype) * t["m"]
            order = ("x", "y", "z", "vx", "vy", "vz", "m")
            cfields = tuple(t[k] for k in order) + (ch, crho, t["por2"], t["cs"])
            qfields = tuple(c[:, sl].contiguous() for c in cfields)
            case = {"dtype": str(dtype)[6:], "k2_mono_cap": cap, "rows": n_rows,
                    "full_rows": 2, "piece": cuda_tile_pairs.k2_budget(
                        cap, cw, dtype, build.device_limits(DEVICE)[1])}
            for eos in ("polytropic", "isothermal"):
                for p3m in (False, True):
                    sigma = 1.0 / 10 * 2.2 if p3m else None
                    args = (qfields, cfields, m, 1.0, 2.0, sigma)
                    kw = dict(eos=eos, p3m=p3m, cap=cap)
                    outs_k = cuda_tile_pairs.phase_b_tiles(*args, **kw)
                    sync()
                    outs_p = cuda_tile_pairs.phase_b_tiles_plain(*args, **kw)
                    worst, rtol, atol = check_phase_b(outs_k, outs_p, dtype)
                    case[f"b_{eos[:4]}_{'p3m' if p3m else 'exact'}"] = {
                        "max_err_over_scale": worst, "rtol": rtol, "atol_of_scale": atol,
                        **k2_repeats(args, kw, outs_k)}
                    if not p3m:
                        case[f"b_{eos[:4]}_exact_outlier"] = k2_outlier_cases(args, kw, outs_k, sl)
                # joint mode (ROADMAP D21): a close pair's two corrections
                # as one float64 term, with and without the outlier masks
                for outlier in (False, True):
                    args = (qfields, cfields, m, 1.0, 2.0, 1.0 / 5 * 2.2)
                    kw = dict(eos=eos, p3m=False, cap=cap, joint=True, outlier=outlier)
                    outs_k = cuda_tile_pairs.phase_b_tiles(*args, **kw)
                    sync()
                    outs_p = cuda_tile_pairs.phase_b_tiles_plain(*args, **kw)
                    worst, rtol, atol = check_phase_b(outs_k, outs_p, dtype)
                    case[f"b_{eos[:4]}_joint{'_outlier' if outlier else ''}"] = {
                        "max_err_over_scale": worst, "rtol": rtol, "atol_of_scale": atol,
                        **k2_repeats(args, kw, outs_k)}
            cases.append(case)
            del t, cfields, qfields
            torch.cuda.empty_cache()
    return cases


def tail_repeats(args, kw, out_k):
    """The tail kernel's launch `out_k` against a second launch on the same
    inputs: the same bits."""
    if not bool(torch.equal(out_k, cuda_p3m_tail.p3m_tail(*args, **kw))):
        raise AssertionError(f"p3m_tail {kw}: two launches differ")
    return {"runs_bit_identical": True}


def synthetic_tail_planes(rng, grid, cap, w, dtype, occupancy, full_cells=0):
    """x, y, z, mask planes of the tail kernel's layout for unit cells:
    every cell holds between occupancy/2 and occupancy particles in its
    first slots (the first `full_cells` cells of the flat order cap of
    them), a w-cell halo of zeros around the grid."""
    gpc = grid + 2 * w
    fill = rng.integers(max(1, occupancy // 2), occupancy + 1, size=(grid, grid, grid, 1))
    fill.reshape(-1)[:full_cells] = cap
    occ = (np.arange(cap)[None, None, None, :] < fill).astype(np.float64)
    idx = np.indices((grid, grid, grid))  # z, y, x
    planes = np.zeros((4, gpc, gpc, gpc * cap))
    inner = (slice(w, w + grid), slice(w, w + grid), slice(w * cap, (w + grid) * cap))
    for k, a in enumerate((2, 1, 0)):  # x, y, z from the cell's index + [0, 1)
        coord = (idx[a][..., None] + rng.random((grid, grid, grid, cap))) * occ
        planes[k][inner] = coord.reshape(grid, grid, grid * cap)
    planes[3][inner] = occ.reshape(grid, grid, grid * cap)
    return dev(planes, dtype)


def kernels_tail(rng, rng_new, m):
    """The P3M tail kernel vs its plain version on synthetic planes, float32
    and float64: W = 2 (the default mesh_factor 5) and W = 1 (mesh_factor
    10) at cap 160 from `rng`; then, from `rng_new`, W = 1, 2 and 3
    (mesh_factor 4) at cap 160 and W = 2 at cap 256 (the mono planner's
    ceiling), each grid's first layer of cells filled to cap. Two launches
    bit-identical."""
    cases = []
    for dtype, w, grid, cap, gen, occ, full in (
            (torch.float32, 2, 8, 160, rng, 100, 0),
            (torch.float64, 2, 8, 160, rng, 100, 0),
            (torch.float64, 1, 8, 160, rng, 100, 0),
            *((dt, w, grid, cap, rng_new, int(0.6 * cap), grid * grid)
              for dt in (torch.float32, torch.float64)
              for w, grid, cap in ((1, 8, 160), (2, 8, 160), (3, 6, 160), (2, 5, 256)))):
        planes = synthetic_tail_planes(gen, grid, cap, w, dtype, occ, full_cells=full)
        sigma = 1.0 / {1: 10, 2: 5, 3: 4}[w] * 2.2
        kw = dict(grid=grid, cap=cap, halfwidth=w)
        out_k = cuda_p3m_tail.p3m_tail(planes, m, sigma, **kw)
        sync()
        out_p = cuda_p3m_tail.p3m_tail_plain(planes, m, sigma, **kw)
        worst, rtol, atol = check_phase_b(
            out_k, out_p, dtype, names=TAIL_OUTPUTS, kernel="p3m_tail"
        )
        cases.append({"dtype": str(dtype)[6:], "tail_w": w, "grid": grid, "cap": cap,
                      "full_cells": full,
                      "tail": {"max_err_over_scale": worst, "rtol": rtol,
                               "atol_of_scale": atol,
                               **tail_repeats((planes, m, sigma), kw, out_k)}})
        del planes, out_k, out_p
    return cases


def kernels_f8(m, seed: int = 13):
    """K2's joint mode and the tail's skip mode (ROADMAP D21) on synthetic
    unit cells with h in [0.2, 0.45) (so that pairs of neighbouring cells
    lie inside 2 h_avg), W = 1 and 2 at cap 160, float64 then float32, the
    first layer of cells filled to cap: the tail's skip mode against its
    plain version within check_phase_b's bars, two launches bit-identical;
    on the same slots as a 27-cell stack, K2's joint mode likewise (and its
    cull against keep-all); K2's joint launch plus the tail's skip launch
    against K2's term 1 plus the tail over every pair (the reference's two
    sweeps) within check_phase_b's bars in float64; and both float32 sums
    against the float64 joint one, over each output's scale."""
    rng = np.random.default_rng(seed)
    cases = []
    for w in (1, 2):
        grid, cap = 6, 160
        sums = {}
        for dtype in (torch.float64, torch.float32):
            g = np.random.default_rng(seed + w)
            planes = synthetic_tail_planes(g, grid, cap, w, dtype, int(0.6 * cap),
                                           full_cells=grid * grid)
            h = dev(0.2 + 0.25 * g.random(tuple(planes[3].shape)), dtype) * planes[3]
            planes5 = torch.cat([planes, h[None]]).contiguous()
            sigma = 1.0 / {1: 10, 2: 5}[w] * 2.2
            kw = dict(grid=grid, cap=cap, halfwidth=w, skip_joint=True)
            out_k = cuda_p3m_tail.p3m_tail(planes5, m, sigma, **kw)
            sync()
            out_p = cuda_p3m_tail.p3m_tail_plain(planes5, m, sigma, **kw)
            worst, rtol, atol = check_phase_b(out_k, out_p, dtype, names=TAIL_OUTPUTS,
                                              kernel="p3m_tail skip")
            case = {"dtype": str(dtype)[6:], "f8_w": w, "grid": grid, "cap": cap,
                    "skip": {"max_err_over_scale": worst, "rtol": rtol, "atol_of_scale": atol,
                             **tail_repeats((planes5, m, sigma), kw, out_k)}}
            # the same slots as K2's 27-cell stack, in the prestack's order
            gp = grid + 2
            pl = planes5[:, w - 1 : w + grid + 1, w - 1 : w + grid + 1,
                         (w - 1) * cap : (w + grid + 1) * cap].reshape(5, gp, gp, gp, cap)
            pre = torch.stack([pl[:, dz : dz + grid, dy : dy + grid, dx : dx + grid]
                               for dz in range(3) for dy in range(3) for dx in range(3)],
                              dim=4).reshape(5, grid**3, 27 * cap)
            occ = pre[3]
            shape = tuple(occ.shape)
            vel = [dev(0.1 * rng.standard_normal(shape), dtype) * occ for _ in range(3)]
            rho = dev(0.5 + rng.random(shape), dtype) * occ
            por2 = dev(0.5 + 0.5 * rng.random(shape), dtype) * occ
            cs_ = dev(0.8 + 0.4 * rng.random(shape), dtype) * occ
            cf = tuple(c.contiguous() for c in
                       (pre[0], pre[1], pre[2], *vel, occ, pre[4], rho, por2, cs_))
            qf = tuple(c[:, 13 * cap : 14 * cap].contiguous() for c in cf)
            args = (qf, cf, m, 1.0, 2.0, sigma)
            kwj = dict(eos="polytropic", p3m=False, cap=cap, joint=True)
            joint_k = cuda_tile_pairs.phase_b_tiles(*args, **kwj)
            sync()
            joint_p = cuda_tile_pairs.phase_b_tiles_plain(*args, **kwj)
            wj, rtol, atol = check_phase_b(joint_k, joint_p, dtype, kernel="phase_b_tiles joint")
            case["joint"] = {"max_err_over_scale": wj, "rtol": rtol, "atol_of_scale": atol,
                             **k2_repeats(args, kwj, joint_k)}
            split_k = cuda_tile_pairs.phase_b_tiles(*args, eos="polytropic", p3m=False, cap=cap)
            tail_all = cuda_p3m_tail.p3m_tail(planes, m, sigma, grid=grid, cap=cap, halfwidth=w)
            sync()
            sums[dtype] = {"joint": torch.stack(joint_k[6:]) + out_k,
                           "split": torch.stack(split_k[6:]) + tail_all}
            if dtype == torch.float64:
                wt, rtol, atol = check_phase_b(sums[dtype]["joint"], sums[dtype]["split"],
                                               dtype, names=TAIL_OUTPUTS,
                                               kernel="joint + skip against the two sweeps")
                case["joint_plus_skip_vs_split"] = {"max_err_over_scale": wt, "rtol": rtol,
                                                    "atol_of_scale": atol}
            else:
                ref = sums[torch.float64]["joint"]
                case["f32_against_f64_over_scale"] = {
                    mode: max(float((a.double() - b).abs().max()) / float(b.abs().max())
                              for a, b in zip(v, ref))
                    for mode, v in sums[dtype].items()}
            cases.append(case)
            del planes, planes5, pre, cf, qf
    return cases


def synthetic_blocks(rng, nb, cw, dtype, kh):
    """Rows shaped like the block engine's: nb blocks of BQ = 128 queries
    in the unit cube, each against cw candidate slots spread over
    [-0.25, 1.25]^3 of which the first 85 % are occupied (the rest the
    sentinel padding of a table), each query also a candidate (its self
    pair), one query slot masked off. reach2 = (1.5 r_k)^2 for the
    candidates' mean density, as the engine's h-hint cap gives. Returns
    (queries, reach2, cands, 11 query fields, 10 candidate fields in K6's
    order)."""
    cap = blocks.BQ
    n_occ = int(0.85 * cw)
    q = [rng.random((nb, cap)) for _ in range(3)]
    c = [rng.random((nb, cw)) * 1.5 - 0.25 for _ in range(3)]
    for a in range(3):
        c[a][:, :cap] = q[a]
    cm = np.broadcast_to((np.arange(cw) < n_occ).astype(np.float64), (nb, cw)).copy()
    qm = np.ones((nb, cap))
    qm[0, 3] = 0.0
    r_k = (3.0 * kh * 1.5**3 / (4.0 * np.pi * n_occ)) ** (1 / 3)
    reach2 = np.full((nb, cap), (1.5 * r_k) ** 2)
    reach2[1, :8] = (0.3 * r_k) ** 2  # rows whose reach cannot hold kh neighbours
    qv = [0.3 * rng.standard_normal((nb, cap)) for _ in range(3)]
    cv = [0.3 * rng.standard_normal((nb, cw)) for _ in range(3)]
    qh = (0.45 + 0.1 * rng.random((nb, cap))) * r_k
    ch = (0.45 + 0.1 * rng.random((nb, cw))) * r_k
    for a in range(3):
        cv[a][:, :cap] = qv[a]
    ch[:, :cap] = qh
    qrho, crho = 0.5 + rng.random((nb, cap)), 0.5 + rng.random((nb, cw))
    qpor2, cpor2 = 0.5 + rng.random((nb, cap)), 0.5 + rng.random((nb, cw))
    qcs = 0.8 + 0.4 * rng.random((nb, cap))
    qf = [dev(x, dtype) for x in (*q, *qv, qm, qh, qrho, qpor2, qcs)]
    cf = [dev(x, dtype) for x in (*c, *cv, cm, ch, crho, cpor2)]
    queries = (qf[0], qf[1], qf[2], qf[6])
    cands = (cf[0], cf[1], cf[2], cf[6])
    return queries, dev(reach2, dtype), cands, qf, cf


def grouped_layout(cf):
    """K6's per-bucket candidate planes (nb, cw) as K5's flat chunk stack
    (nb * cw / 512, 10, 512) with its (qblk, first)."""
    nb, cw = cf[0].shape
    cw_k = cuda_grouped_pairs.CW
    order = (0, 1, 2, 3, 4, 5, 7, 8, 9, 6)
    cstack = torch.stack([cf[k] for k in order], 0)  # (10, nb, cw)
    cstack = cstack.reshape(10, nb * cw // cw_k, cw_k).transpose(0, 1).contiguous()
    ck = cw // cw_k
    qblk = tuple(b for b in range(nb) for _ in range(ck))
    first = tuple(int(j == 0) for _ in range(nb) for j in range(ck))
    return cstack, qblk, first


C_NAMES = "sax say saz svisc sgx sgy sgz sgp".split()


def cast_args(args, dtype):
    """Kernel arguments with every floating tensor (also inside tuples)
    cast to dtype."""
    def cast(x):
        if isinstance(x, (tuple, list)):
            return type(x)(cast(v) for v in x)
        return x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x
    return tuple(cast(a) for a in args)


def plain_kw(kw):
    """K5's keyword arguments as its plain version takes them (the work
    units are the kernel's)."""
    return {k: v for k, v in kw.items() if k != "units"}


def k5_units(qfields, cstack, kw):
    """K5's work units for a launch (`kw["units"]` where the caller passes
    the plan's, else `unit_table`'s) and their sizes: count, slots of the
    largest and smallest, and their work in occupied (query, slot) pairs."""
    units = kw.get("units")
    if units is None:
        units = tuple(torch.as_tensor(a).to(DEVICE) for a in cuda_grouped_pairs.unit_table(
            tuple(kw["qblk"]), tuple(kw["first"]), qfields[0].shape[0]))
    u = units[0].long()
    occ = torch.cat([torch.zeros(1, dtype=torch.long, device=DEVICE),
                     torch.cumsum((cstack[:, 9] > 0).sum(1), 0)])
    work = (occ[u[:, 1] + u[:, 2]] - occ[u[:, 1]]) * (qfields[6] > 0).sum(1)[u[:, 0]]
    slots = u[:, 2] * cuda_grouped_pairs.CW
    return units, {"n_units": int(u.shape[0]), "query_blocks": int(qfields[0].shape[0]),
                   "unit_slots_max_min": [int(slots.max()), int(slots.min())],
                   "unit_work_max_min": [int(work.max()), int(work.min())]}


def k5_check(args, kw, dtypes=(torch.float32, torch.float64)):
    """K5 on one launch's inputs (args, kw as phase_b_grouped takes them),
    cast to each of `dtypes`: within check_phase_b's tolerance of its plain
    version, and two launches bit-identical (no output uses an atomic). Also
    the launch's work units (`k5_units`). Returns a summary; raises on a
    failed check."""
    units, summary = k5_units(args[0], args[1], kw)
    kw = dict(kw, units=units)
    for dtype in dtypes:
        a = cast_args(args, dtype)
        qo_k, co_k = cuda_grouped_pairs.phase_b_grouped(*a, **kw)
        qo_k2, co_k2 = cuda_grouped_pairs.phase_b_grouped(*a, **kw)
        sync()
        if not (all(bool(torch.equal(x, y)) for x, y in zip(qo_k, qo_k2))
                and bool(torch.equal(co_k, co_k2))):
            raise AssertionError(f"phase_b_grouped {dtype}: two launches differ")
        qo_p, co_p = cuda_grouped_pairs.phase_b_grouped_plain(*a, **plain_kw(kw))
        rq, rtol, atol = check_phase_b(qo_k, qo_p, dtype, kernel="phase_b_grouped")
        rc = check_phase_b(co_k.transpose(0, 1), co_p.transpose(0, 1), dtype,
                           names=C_NAMES, kernel="phase_b_grouped")[0]
        err = max(max(float((x - y).abs().max()) for x, y in zip(qo_k, qo_p) if x.numel()),
                  float((co_k - co_p).abs().max()))
        summary[str(dtype)[6:]] = {"max_err_over_scale": max(rq, rc), "max_abs_err": err,
                                   "rtol": rtol, "atol_of_scale": atol,
                                   "runs_bit_identical": True}
        del qo_k, co_k, qo_k2, co_k2, qo_p, co_p
    return summary


def k6_check(args, kw, dtypes=(torch.float32, torch.float64)):
    """K6 on one launch's inputs (args, kw as phase_b_blocks takes them),
    cast to each of `dtypes`: within check_phase_b's tolerance of its plain
    version, and two launches bit-identical (no output uses an atomic).
    Returns {dtype name: summary}; raises on a failed check."""
    out = {}
    for dtype in dtypes:
        a = cast_args(args, dtype)
        qo_k, co_k = cuda_block_pairs.phase_b_blocks(*a, **kw)
        qo_k2, co_k2 = cuda_block_pairs.phase_b_blocks(*a, **kw)
        sync()
        if not (same_bits(qo_k, qo_k2) and same_bits(co_k, co_k2)):
            raise AssertionError(f"phase_b_blocks {dtype}: two launches differ")
        qo_p, co_p = cuda_block_pairs.phase_b_blocks_plain(*a, **kw)
        rq, rtol, atol = check_phase_b(qo_k, qo_p, dtype, kernel="phase_b_blocks")
        rc = check_phase_b(co_k, co_p, dtype, names=C_NAMES, kernel="phase_b_blocks")[0]
        err = max(float((x - y).abs().max()) for x, y in zip(qo_k + co_k, qo_p + co_p)
                  if x.numel())
        out[str(dtype)[6:]] = {"max_err_over_scale": max(rq, rc), "max_abs_err": err,
                               "rtol": rtol, "atol_of_scale": atol, "runs_bit_identical": True}
        del qo_k, co_k, qo_k2, co_k2, qo_p, co_p
    return out


def k6_widths(m, seed: int = 12):
    """K6 on synthetic blocks of a legacy plan's C_b = 768, of the widest
    menu capacity, 32 768 (128 work units a block), and of C_b 700 and
    1 300, whose last 256-slot piece is partial, nb = 2: both EOS and both
    gravity modes, float32 and float64 (`k6_check`), from a generator of
    their own."""
    rng = np.random.default_rng(seed)
    cases = []
    for cw in (768, 32768, 700, 1300):
        for dtype in (torch.float32, torch.float64):
            _, _, _, qf, cf = synthetic_blocks(rng, 2, cw, dtype, 50)
            for eos in ("polytropic", "isothermal"):
                for p3m in (False, True):
                    sigma, r_c = (0.05, 0.22) if p3m else (None, 0.0)
                    kwb = dict(eos=eos, p3m=p3m, cap=blocks.BQ)
                    res = k6_check((qf, cf, m, 1.0, 2.0, sigma, r_c), kwb, dtypes=(dtype,))
                    cases.append({"c_b": cw, "blocks": 2,
                                  "units_a_block": cuda_block_pairs.block_units(cw),
                                  "eos": eos, "p3m": p3m, **res})
            del qf, cf
    return cases


def kernels_blocks(rng, m):
    """K1 at block widths (C_b from 512 to 32 768: resident and streamed
    rows; a resident row also forced to stream, which must not change a
    bit), K5 (`k5_check`) and K6 against their plain versions on synthetic
    block rows, float32 (28 bisection passes) and float64 (68), both
    gravity modes."""
    kh = 50
    cases = []
    for dtype, (widths, nb) in BLOCK_ROWS.items():
        n_bisect = blocks.N_BISECT_HINT if dtype == torch.float32 else blocks.N_BISECT_F64
        for cw in widths:
            queries, reach2, cands, qf, cf = synthetic_blocks(rng, nb, cw, dtype, kh)
            kw = dict(kh=kh, cap=blocks.BQ, n_bisect=n_bisect)
            out_k = cuda_strip_knn.phase_a_cells(queries, reach2, cands, m, **kw)
            sync()
            out_p = cuda_strip_knn.phase_a_cells_plain(queries, reach2, cands, m, **kw)
            rho_rtol = 2e-5 if dtype == torch.float32 else 1e-12
            err, ties = check_phase_a(*out_k, *out_p, queries, reach2, cands, rho_rtol)
            variants = k1_variants((queries, reach2, cands, m), kw, out_k, out_p, rho_rtol)
            ok = out_k[2]
            if not (bool((ok[1, :8] == 0).all()) and bool((ok[0, 3] == 1).all())):
                raise AssertionError(f"phase_a_cells cw={cw}: certificate rows wrong")
            case = {"dtype": str(dtype)[6:], "blocks": nb, "c_b": cw, "n_bisect": n_bisect,
                    "k1_block": {"rho_max_abs_err": err, "rho_rtol": rho_rtol,
                                 "tie_rows": ties, "rows_certified": int((ok > 0).sum()),
                                 **variants}}
            for p3m in (False, True):
                sigma, r_c = (0.05, 0.22) if p3m else (None, 0.0)
                args = (m, 1.0, 2.0, sigma, r_c)
                kwb = dict(eos="polytropic", p3m=p3m, cap=blocks.BQ)
                qo_k, co_k = cuda_block_pairs.phase_b_blocks(qf, cf, *args, **kwb)
                sync()
                qo_p, co_p = cuda_block_pairs.phase_b_blocks_plain(qf, cf, *args, **kwb)
                wq = check_phase_b(qo_k, qo_p, dtype, kernel="phase_b_blocks")[0]
                wc = check_phase_b(co_k, co_p, dtype, names=C_NAMES, kernel="phase_b_blocks")[0]
                cstack, qblk, first = grouped_layout(cf)
                k5 = k5_check((qf, cstack, *args), dict(kwb, qblk=qblk, first=first),
                              dtypes=(dtype,))
                case[f"k5_k6_{'p3m' if p3m else 'exact'}"] = {
                    "k6_query_err_over_scale": wq, "k6_cand_err_over_scale": wc, "k5": k5}
            cases.append(case)
            del queries, cands, qf, cf, out_k, out_p
            torch.cuda.empty_cache()
    return cases


def widen(outs):
    """Kernel outputs as float64, the float32 -max of a masked mu_max
    (no pair) mapped to the float64 -max the float64 plain version gives."""
    big32 = torch.finfo(torch.float32).max
    return tuple(torch.where(o == -big32, -torch.finfo(torch.float64).max, o.double())
                 for o in outs)


def f7_block_generator(seed: int = 0):
    """A generator at the state from which the kernels phase drew its
    synthetic block inputs in the run that found ROADMAP F7: one generator
    of `seed` through the class-row cases, K3's, K4's, every tail case and
    the K2 mono-row cases (the tail's and K2's later cases now draw from
    their own generator). Only the draws are repeated; nothing launches."""
    rng = np.random.default_rng(seed)
    big_cap = CLASS_MENU[-1]
    for dtype in (torch.float32, torch.float64):
        n_rows = ROWS_F32 if dtype == torch.float32 else ROWS_F64
        for cap_k in CLASS_MENU:
            _, _, cw = synthetic_rows(rng, n_rows, cap_k, big_cap, dtype, 0.8 * cap_k)
            rng.random((n_rows, cw))
            rng.random((n_rows, cw))
    for _, n in (*N_NEWTON.items(), (torch.float32, N_NEWTON_ONE_SLICE)):
        rng.standard_normal((n, 3))
    for dtype in (torch.float32, torch.float64):
        n_rows = ROWS_F32 if dtype == torch.float32 else ROWS_F64
        for cap in (128, 160):
            synthetic_rows(rng, n_rows, cap, cap, dtype, 0.7 * cap)
    for dtype, w, grid, cap, occ, full in (
            (torch.float32, 2, 8, 160, 100, 0), (torch.float64, 2, 8, 160, 100, 0),
            (torch.float64, 1, 8, 160, 100, 0),
            *((dt, w, grid, cap, int(0.6 * cap), grid * grid)
              for dt in (torch.float32, torch.float64)
              for w, grid, cap in ((1, 8, 160), (2, 8, 160), (3, 6, 160), (2, 5, 256)))):
        synthetic_tail_planes(rng, grid, cap, w, dtype, occ, full_cells=full)
    for dtype, n_rows in ((torch.float32, 32), (torch.float64, 8)):
        for cap in (160, 256):
            _, _, cw = synthetic_rows(rng, n_rows, cap, cap, dtype, 0.6 * cap, full_rows=2)
            rng.random((n_rows, cw))
            rng.random((n_rows, cw))
    return rng


def kernels_f7(m, seed: int = 0):
    """ROADMAP F7's draw: the sequence that found it (`f7_block_generator`), then the
    float32 block rows of kernels_blocks (C_b 512 ... 32 768). On each, K6
    and K5 in float32 are held, within check_phase_b's bars, against their
    plain version evaluated in float64 on the same float32-rounded inputs;
    the float32 plain version's distance from that sum is reported beside
    the kernels' (which side is nearer the exact sum)."""
    rng = f7_block_generator(seed)
    kh = 50
    widths, nb = BLOCK_ROWS[torch.float32]
    cases = []
    for cw in widths:
        _, _, _, qf, cf = synthetic_blocks(rng, nb, cw, torch.float32, kh)
        qf64, cf64 = [a.double() for a in qf], [a.double() for a in cf]
        case = {"dtype": "float32", "f7_draw": True, "blocks": nb, "c_b": cw}
        for p3m in (False, True):
            sigma, r_c = (0.05, 0.22) if p3m else (None, 0.0)
            args = (m, 1.0, 2.0, sigma, r_c)
            kwb = dict(eos="polytropic", p3m=p3m, cap=blocks.BQ)
            qo_k, co_k = cuda_block_pairs.phase_b_blocks(qf, cf, *args, **kwb)
            sync()
            qo_64, co_64 = cuda_block_pairs.phase_b_blocks_plain(qf64, cf64, *args, **kwb)
            qo_32, co_32 = cuda_block_pairs.phase_b_blocks_plain(qf, cf, *args, **kwb)
            cstack, qblk, first = grouped_layout(cf)
            kw5 = dict(kwb, qblk=qblk, first=first)
            units, _ = k5_units(qf, cstack, kw5)
            qo5, co5 = cuda_grouped_pairs.phase_b_grouped(qf, cstack, *args, **kw5, units=units)
            qo5b, co5b = cuda_grouped_pairs.phase_b_grouped(qf, cstack, *args, **kw5, units=units)
            sync()
            if not (same_bits(qo5, qo5b) and bool(torch.equal(co5, co5b))):
                raise AssertionError("phase_b_grouped: two launches differ on the F7 draw")
            co5 = tuple(co5.transpose(0, 1).reshape(8, nb, cw))
            f32 = torch.float32
            res = {
                "k6_query": check_phase_b(widen(qo_k), qo_64, f32, kernel="phase_b_blocks")[0],
                "k6_cand": check_phase_b(widen(co_k), co_64, f32, names=C_NAMES,
                                         kernel="phase_b_blocks")[0],
                "k5_query": check_phase_b(widen(qo5), qo_64, f32, kernel="phase_b_grouped")[0],
                "k5_cand": check_phase_b(widen(co5), co_64, f32, names=C_NAMES,
                                         kernel="phase_b_grouped")[0],
            }
            # the float32 plain version's own distance from the float64 sum
            near = {}
            for name, k, p32, p64 in zip(C_NAMES, co_k, co_32, co_64):
                scale = float(p64.abs().max())
                if scale > 0:
                    near[name] = {"kernel": float((k.double() - p64).abs().max()) / scale,
                                  "plain_f32": float((p32.double() - p64).abs().max()) / scale}
            case[f"k5_k6_{'p3m' if p3m else 'exact'}"] = {
                "err_over_scale_vs_f64_plain": res, "cand_err_over_scale_by_output": near,
                "k5_runs_bit_identical": True}
            del qo_k, co_k, qo_64, co_64, qo_32, co_32, qo5, co5, qo5b, co5b, cstack
        cases.append(case)
        del qf, cf, qf64, cf64
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return cases


# --------------------------------------------------------------------------
# main path
# --------------------------------------------------------------------------


def reset_counts() -> None:
    for mod in MODULES.values():
        mod.launches = 0


def drive_cli(root: str, n: int, kh: int = 50, generate: bool = True):
    """--generate boss_bodenheimer at N = n, Kh = kh (unless snapshot 1 is
    already written), then --run four steps on the card (snapshots 1, 3, 4)
    with the launch counts set to 0 just before the run and read just after.
    Returns (summary, counts, checks common to every path, energy drift)."""
    common = ["--EOS", "polytropic", "--ic_type", "boss_bodenheimer", "--root", root]
    if generate and cli.main(["--generate", *common, "--kwargs", f"N={n},Kh={kh}"]) != 0:
        raise AssertionError("--generate failed")
    reset_counts()
    rc = cli.main(
        ["--run", *common, "--snapID", "1", "--snapInterval", "2", "--keepSnaps", "true",
         "--showPlots", "false", "--max-steps", "4", "--quiet", "--device", DEVICE]
    )
    sync()
    counts = {name: mod.launches for name, mod in MODULES.items()}
    res = cli.LAST_RUN
    if rc != 0 or res is None:
        raise AssertionError("--run failed")
    checks, drift = run_checks(root, res, n)
    return res, counts, checks, drift


def run_checks(root: str, res, n: int):
    """The checks every 4-step path's run must pass (steps, no fallback,
    the stats file, the energy drift, the snapshots read back): (checks,
    energy drift)."""
    checks = {
        "float32": res["state"].pos.dtype == torch.float32,
        "on the card": res["state"].pos.device.type == DEVICE,
        "4 steps": res["steps"] == 4,
        "0 fallback evals": res["fallback_evals"] == 0,
    }
    stats_path = os.path.join(root, "snapshots", "boss_bodenheimer", "stats")
    checks["stats file is 8 000 000 bytes"] = os.path.getsize(stats_path) == 8_000_000
    from sphtpu_torch.io import StatsFile

    sf = StatsFile(stats_path)
    hist = sf.up_to(5)
    sf.close()
    checks["stats rows finite, 4 written"] = bool(
        np.isfinite(hist[:4]).all() and (np.diff(hist[:4, 0]) > 0).all() and not hist[4].any()
    )
    e = hist[:4, 4]
    drift = float(np.abs(e - e[0]).max() / abs(e[0]))
    checks["|dE/E| < 1e-2"] = drift < 1e-2
    for sid in res["snapshot_ids"]:
        snap = read_snapshot(snapshot_path(root, "boss_bodenheimer", str(sid)))
        checks[f"snapshot {sid} reads back"] = bool(
            snap["pos"].shape == (n, 3) and np.isfinite(snap["pos"]).all()
            and snap["K"].shape == (n,)
        )
    checks["snapshots 1, 3, 4"] = res["snapshot_ids"] == [1, 3, 4]
    return checks, drift


def walls_summary(res, n):
    """Seconds a step after the first chunk: the chunks' own walls, and the
    end-to-end figure that adds the host planning before each chunk (the
    block engine's refit runs there)."""
    walls, picks = res["chunk_walls"], res["pick_walls"]
    later_steps = sum(c[0] for c in walls[1:])
    s_per_step = sum(c[1] for c in walls[1:]) / later_steps
    s_e2e = (sum(c[1] for c in walls[1:]) + sum(picks[1:])) / later_steps
    return dict(chunk_walls=walls, pick_walls=picks, first_step_s=walls[0][1],
                s_per_step_after_first=s_per_step, particle_steps_per_s=n / s_per_step,
                s_per_step_end_to_end=s_e2e, particle_steps_per_s_end_to_end=n / s_e2e)


def phase_exact_path(tmp: str, gpu_line: str, kh: int):
    """An exact-gravity path at N = 1e5: with Kh = 50 (the headline scene)
    the planner's ladder gives the mono-tile engine (cap 160 exceeds the
    class planner's 128): K4, K2, K3; with Kh = KH_CLASS it gives the
    class-compacted engine: K1 and K2 once per class, K3."""
    name = "main_path" if kh == 50 else "class_path"
    res, counts, checks, drift = drive_cli(os.path.join(tmp, name), N_MAIN, kh)
    cfg = res["configs"][0]
    n_cls = len(cfg.tile_classes or ())
    if kh == 50:
        engine = {"one config, mono-tile": len(res["configs"]) == 1 and n_cls == 0}
        want = {"phase_a_cells": 0, "phase_b_tiles": 8, "newton_sweep": 8,
                "phase_a_tile": 8, "p3m_tail": 0, "phase_b_grouped": 0, "phase_b_blocks": 0,
                "newton_rows_cols": 0}
    else:
        engine = {"one config, with tile_classes": len(res["configs"]) == 1 and n_cls > 0}
        want = {"phase_a_cells": 8 * n_cls, "phase_b_tiles": 8 * n_cls, "newton_sweep": 8,
                "phase_a_tile": 0, "p3m_tail": 0, "phase_b_grouped": 0, "phase_b_blocks": 0,
                "newton_rows_cols": 0}
    checks = {
        **engine, "exact gravity": cfg.gravity == "exact", **checks,
        "kernel launches": counts == want,
    }
    failed = [k for k, v in checks.items() if not v]
    say(
        name, card=gpu_line, scene=f"boss_bodenheimer polytropic N={N_MAIN} Kh={kh} float32",
        tile=list(cfg.tile), tile_classes=[list(c) for c in cfg.tile_classes or ()],
        steps=res["steps"], fallback_evals=res["fallback_evals"], launches=counts,
        energy_drift=drift, **walls_summary(res, N_MAIN),
        snapshot_ids=res["snapshot_ids"], runtime_s=res["runtime_s"], failed=failed,
    )
    if failed:
        raise AssertionError(f"{name} checks failed: {failed}")
    return res, cfg, counts


def capture_eval_inputs(res, cfg, module, names, mlargs=None, grouped=True, out=None,
                        joint_gravity=EVAL_REPAIRS["joint_gravity"]):
    """Arguments the kernel wrappers `names`, as `module` calls them, get in
    one force evaluation of a path's final state (a block config's with its
    BlockArgs `mlargs`; `grouped` and `joint_gravity` as force_eval takes
    them, the latter as the run loop passes it by default). When `out` is a
    dict, the evaluation's (acc, reduced, phi) go there."""
    calls = {name: [] for name in names}
    orig = {name: getattr(module, name) for name in names}

    def recorder(name):
        def rec(*args, **kw):
            calls[name].append((args, kw))
            return orig[name](*args, **kw)

        return rec

    for name in names:
        setattr(module, name, recorder(name))
    try:
        st = res["state"]
        ghat = (greens_hat(cfg.mesh_pad, cfg.sigma_cells, st.pos.dtype, DEVICE)
                if cfg.gravity == "p3m" else None)
        acc, red, phi, fell_back = force_eval(
            cfg, res["params"], st.pos, st.vel, st.K, res["h_last"], ghat, mlargs,
            device=DEVICE, grouped=grouped, joint_gravity=joint_gravity,
        )
        if out is not None:
            out.update(acc=acc, red=red, phi=phi)
    finally:
        for name in names:
            setattr(module, name, orig[name])
    if fell_back:
        raise AssertionError("the captured evaluation fell back")
    return calls


def pairs_in_a_mask(qfields, cfields, chunk_elems: int = 1 << 27, margin: float = 1.0) -> int:
    """Occupied (query, candidate) pairs of phase B's inputs that lie inside
    the forward, the reverse or the gravity-correction mask: d2 <=
    (2 max(h_q, h_c))^2, which contains all three (with the outlier masks
    too, which only shrink the first two). margin = CULL_MARGIN counts the
    pairs K2's cull keeps instead."""
    qx, qy, qz, qm, qh = (qfields[k] for k in (0, 1, 2, 6, 7))
    cx, cy, cz, cm, ch = (cfields[k] for k in (0, 1, 2, 6, 7))
    n_rows, cap = qx.shape
    rows = max(1, chunk_elems // (cap * cx.shape[1]))
    total = 0
    for r0 in range(0, n_rows, rows):
        sl = slice(r0, r0 + rows)
        d2 = (
            (qx[sl, :, None] - cx[sl, None, :]) ** 2
            + (qy[sl, :, None] - cy[sl, None, :]) ** 2
            + (qz[sl, :, None] - cz[sl, None, :]) ** 2
        )
        reach = 2 * torch.maximum(qh[sl, :, None], ch[sl, None, :])
        inside = (d2 <= reach * reach * margin) & (qm[sl, :, None] > 0) & (cm[sl, None, :] > 0)
        total += int(inside.sum())
    return total


def phase_kernel_times(res, cfg, counts):
    """Each kernel of the exact path against its plain version on the inputs
    of one force evaluation of that path's final state: error, time of the
    evaluation's launches (all classes), the plain version's time and the
    card's bound for the same work."""
    calls = capture_eval_inputs(res, cfg, ctiles, ("phase_a_cells", "phase_b_tiles"))
    dtype = res["state"].pos.dtype
    peak = PEAK_FLOPS[dtype]
    entries = []

    k1 = k1_numbers(calls["phase_a_cells"])
    entries.append(kernel_entry("phase_a_cells", counts, k1.pop("err"), k1.pop("ms"),
                                k1.pop("plain_ms"), k1.pop("flops"), k1.pop("bytes"), peak,
                                **k1))
    entries.append(k2_entry(calls["phase_b_tiles"], counts, dtype))
    entries.append(k3_entry(res, counts, peak))
    return entries


def k1_numbers(calls, iters: int = 5):
    """K1 against its plain version over the captured launches `calls` of
    one evaluation (h and ok bit-equal, rho within 2e-5, the variants of
    `k1_variants`): error, the launches' time and the plain version's, the
    operations and bytes the function needs, the overflow shares."""
    out = dict(err=0.0, ms=0.0, plain_ms=0.0, flops=0.0, bytes=0.0, tie_rows=0,
               occupied_pairs=0.0, pairs_in_radius=0.0)
    valid = over = forced = 0
    for args, kw in calls:
        queries, reach2, cands, m = args
        out_k = cuda_strip_knn.phase_a_cells(*args, **kw)
        out_p = cuda_strip_knn.phase_a_cells_plain(*args, **kw)
        e, t_rows = check_phase_a(*out_k, *out_p, queries, reach2, cands, 2e-5)
        v = k1_variants(args, kw, out_k, out_p, 2e-5)
        valid += v["valid_queries"]
        over += v["overflowed"]
        forced += v["forced_overflow_share"] * v["valid_queries"]
        out["err"] = max(out["err"], e)
        out["tie_rows"] += t_rows
        out["ms"] += time_ms(lambda: cuda_strip_knn.phase_a_cells(*args, **kw), iters=iters)
        out["plain_ms"] += time_ms(
            lambda: cuda_strip_knn.phase_a_cells_plain(*args, **kw), iters=1, warmup=0
        )
        ops, pairs, inside = phase_a_ops(queries, reach2, cands, kw["kh"],
                                         kw.get("n_bisect", cuda_strip_knn.N_BISECT))
        out["flops"] += ops
        out["occupied_pairs"] += pairs
        out["pairs_in_radius"] += inside
        # query x, y, z and reach2 at occupied slots; candidate x, y, z likewise
        out["bytes"] += slot_bytes(queries[3], 4) + slot_bytes(cands[3], 3) + nbytes(*out_k)
    out.update(overflow_share=over / max(valid, 1), overflowed_queries=over,
               valid_queries=valid, forced_overflow_share=forced / max(valid, 1),
               forced_overflow_h_ok_equal=True, streamed_equal=True,
               list_len_stage_of_launches=[
                   cuda_strip_knn.list_budget(kw["cap"], args[2][0].shape[1], args[2][0].dtype,
                                              build.device_limits(DEVICE)[1])
                   for args, kw in calls])
    return out


def k3_entry(res, counts, peak):
    """K3 on a path's final state (N = 1e5): `check_newton`'s checks, its
    time beside the plain version's and the bound."""
    pos, m = res["state"].pos, res["params"].m
    checks = check_newton(pos, m)
    n = pos.shape[0]
    ms = time_ms(lambda: cuda_gravity.newton_sweep(pos, m))
    plain_ms = time_ms(lambda: cuda_gravity.newton_sweep_plain(pos, m), iters=1, warmup=0)
    return kernel_entry("newton_sweep", counts, checks.pop("max_abs_err"), ms, plain_ms,
                        float(n) * n * K3_FLOPS_PER_PAIR, 7 * n * pos.element_size(), peak,
                        **checks)  # pos in, g and phi out


def pairs_in_radius(queries, reach2, cands, chunk_elems: int = 1 << 26) -> float:
    """(valid query, occupied candidate) pairs of a phase-A launch with
    d2 <= 1.001 reach2 — the only ones a pass, rk2 or rho can use —
    counted on the card in row chunks with the kernel's arithmetic."""
    qx, qy, qz, qm = queries
    cx, cy, cz, cm = cands
    n_rows, cap = qx.shape
    rows = max(1, chunk_elems // (cap * cx.shape[1]))
    total = 0
    for r0 in range(0, n_rows, rows):
        sl = slice(r0, r0 + rows)
        dx = qx[sl, :, None] - cx[sl, None, :]
        dy = qy[sl, :, None] - cy[sl, None, :]
        dz = qz[sl, :, None] - cz[sl, None, :]
        d2 = dx * dx + dy * dy + dz * dz
        hi0 = 1.001 * reach2[sl]
        inside = (d2 <= hi0[:, :, None]) & (qm[sl, :, None] > 0) & (cm[sl, None, :] > 0)
        total += int(inside.sum())
    return float(total)


def phase_a_ops(queries, reach2, cands, kh: int, n_bisect: int):
    """(operations, occupied pairs, pairs in radius) a phase-A function
    needs on these rows: d2 and a compare against hi0 per (valid query,
    occupied candidate) pair, a compare and a count per pass per pair with
    d2 <= hi0, and the spline W on the kh pairs inside the k-th distance."""
    qmask, cmask = queries[3], cands[3]
    pairs = float(((qmask > 0).sum(1) * (cmask > 0).sum(1)).sum())
    inside = pairs_in_radius(queries, reach2, cands)
    ops = (pairs * K1_OPS_PAIR_TEST + inside * K1_OPS_PER_PASS * (n_bisect + 3)
           + float((qmask > 0).sum()) * kh * K1_OPS_W)
    return ops, pairs, inside


def k2_entry(calls, counts, dtype, plain_row_chunk: int = 0):
    """K2 against its plain version over the captured launches of one
    evaluation (with the outlier masks where the launches had them; the
    plain version in row chunks of plain_row_chunk rows where given). On a
    launch without P3M and without the outlier masks, a launch with them
    (no slot is marked an outlier there) must give the same bits."""
    ms = plain_ms = flops = byts = 0.0
    err = rel = err_scale = pairs_all = pairs_masked = pairs_kept = 0.0
    err_field = None
    no_outlier = {}
    for args, kw in calls:
        qfields, cfields = args[0], args[1]
        out_k = cuda_tile_pairs.phase_b_tiles(*args, **kw)
        out_p = cuda_tile_pairs.phase_b_tiles_plain(*args, **kw, row_chunk=plain_row_chunk)
        repeats = k2_repeats(args, kw, out_k)
        if not kw["p3m"] and not kw.get("outlier"):
            if not same_bits(out_k, cuda_tile_pairs.phase_b_tiles(*args, **dict(kw, outlier=True))):
                raise AssertionError("phase_b_tiles: the outlier masks without outliers "
                                     "change the bits")
            no_outlier = {"no_outlier_bit_identical": True}
        for name, a, b in zip(B_OUTPUTS, out_k, out_p):
            e = float((a - b).abs().max())
            if e > err:
                err, err_field, err_scale = e, name, float(b.abs().max())
        rel = max(rel, check_phase_b(out_k, out_p, dtype)[0])
        del out_k, out_p
        ms += time_ms(lambda: cuda_tile_pairs.phase_b_tiles(*args, **kw))
        plain_ms += time_ms(
            lambda: cuda_tile_pairs.phase_b_tiles_plain(*args, **kw, row_chunk=plain_row_chunk),
            iters=1, warmup=0,
        )
        pairs = float(((qfields[6] > 0).sum(1) * (cfields[6] > 0).sum(1)).sum())
        in_mask = pairs if kw["p3m"] else float(pairs_in_a_mask(qfields, cfields))
        pairs_all += pairs
        pairs_masked += in_mask
        pairs_kept += pairs if kw["p3m"] else float(
            pairs_in_a_mask(qfields, cfields, margin=cuda_tile_pairs.CULL_MARGIN))
        flops += pairs * K2_OPS_MASK_TEST + in_mask * (K2_OPS_PER_PAIR - K2_OPS_MASK_TEST)
        # the mask plane (index 6, which marks the outliers) of each side
        # whole, the other ten fields at occupied slots only
        byts += (slot_bytes(qfields[6], 10) + slot_bytes(cfields[6], 10)
                 + 10 * qfields[0].numel() * qfields[0].element_size())
    # the absolute error is in code units of whichever output is largest;
    # the check itself is relative to each output's scale
    cap, cw = calls[0][1]["cap"], calls[0][0][1][0].shape[1]
    return kernel_entry("phase_b_tiles", counts, err, ms, plain_ms, flops, byts,
                        PEAK_FLOPS[dtype], max_abs_err_output=err_field,
                        largest_value_of_it=err_scale, max_err_over_scale=rel,
                        occupied_pairs=pairs_all, pairs_in_a_mask=pairs_masked,
                        kept_pair_share=pairs_kept / max(pairs_all, 1.0),
                        piece=cuda_tile_pairs.k2_budget(
                            cap, cw, dtype, build.device_limits(DEVICE)[1],
                            outlier=calls[0][1].get("outlier", False)), **repeats,
                        **no_outlier)


# --------------------------------------------------------------------------
# the P3M path
# --------------------------------------------------------------------------


def phase_p3m_path(tmp: str, gpu_line: str):
    """boss_bodenheimer N = 200 000 through the CLI with gravity="auto": the
    planner must pick the mono-tile engine with P3M gravity (about grid 19,
    cap 160, mesh gm 95 / pad 200, tail W = 2), and the run must go
    through K4, K2 and the tail kernel and never through K1 or K3."""
    res, counts, checks, drift = drive_cli(os.path.join(tmp, "p3m"), N_P3M)
    cfg = res["configs"][0]
    checks.update({
        "one config, mono-tile": len(res["configs"]) == 1 and cfg.tile is not None
        and cfg.tile_classes is None,
        "P3M gravity": cfg.gravity == "p3m",
        "tail stencil W = 2": cfg.c_halfwidth == 2,
        "kernel launches": counts
        == {"phase_a_cells": 0, "phase_b_tiles": 8, "newton_sweep": 0,
            "phase_a_tile": 8, "p3m_tail": 8, "phase_b_grouped": 0, "phase_b_blocks": 0,
                "newton_rows_cols": 0},
    })
    failed = [k for k, v in checks.items() if not v]
    walls = walls_summary(res, N_P3M)
    say(
        "p3m_path", card=gpu_line, scene=f"boss_bodenheimer polytropic N={N_P3M} Kh=50 float32",
        plan={"grid": cfg.tile[0] if cfg.tile else None, "cap": cfg.tile[1] if cfg.tile else None,
              "mesh_gm": cfg.mesh_gm if cfg.tile else None,
              "mesh_pad": cfg.mesh_pad if cfg.tile else None, "W": cfg.c_halfwidth},
        steps=res["steps"], fallback_evals=res["fallback_evals"], launches=counts,
        energy_drift=drift, **walls, snapshot_ids=res["snapshot_ids"],
        runtime_s=res["runtime_s"], failed=failed,
    )
    if failed:
        raise AssertionError(f"P3M path checks failed: {failed}")
    return res, cfg, counts, walls["s_per_step_after_first"]


def tail_pairs(planes, grid: int, cap: int, w: int) -> float:
    """(occupied query, occupied candidate) pairs of the tail kernel's
    stencil: per cell, its occupancy times the occupancy summed over its
    (2w+1)^3 neighbourhood."""
    gpc = grid + 2 * w
    occ = (planes[3] > 0).reshape(gpc, gpc, gpc, cap).sum(-1).double()
    box = torch.zeros((grid, grid, grid), dtype=torch.float64, device=occ.device)
    for dz in range(2 * w + 1):
        for dy in range(2 * w + 1):
            for dx in range(2 * w + 1):
                box += occ[dz : dz + grid, dy : dy + grid, dx : dx + grid]
    own = occ[w : w + grid, w : w + grid, w : w + grid]
    return float((own * box).sum())


def phase_mono_kernel_times(res, cfg, counts):
    """K4, K2 and (under P3M) the tail kernel against their plain versions on
    the inputs of one force evaluation of a mono-tile path's final state.
    Returns the K4 entry, K2's numbers on this path, and the tail entry
    (None under exact gravity)."""
    calls = capture_eval_inputs(
        res, cfg, tiles, ("phase_a_tile", "phase_b_tiles", "p3m_tail")
    )
    dtype = res["state"].pos.dtype
    peak = PEAK_FLOPS[dtype]

    # K4: one launch over every cell row; h and ok bit-equal, rho at 2e-5
    (args, kw), = calls["phase_a_tile"]
    cands, s2, m = args
    cap = kw["cap"]
    out_k = cuda_knn.phase_a_tile(*args, **kw)
    out_p = cuda_knn.phase_a_tile_plain(*args, **kw)
    queries = tuple(c[:, 13 * cap : 14 * cap] for c in cands)
    reach2 = torch.as_tensor(s2, dtype=dtype, device=DEVICE).expand(cands[0].shape[0], cap)
    err, ties = check_phase_a(*out_k, *out_p, queries, reach2, cands, 2e-5)
    variants = k4_variants(args, kw, out_k, out_p, 2e-5)
    ms = time_ms(lambda: cuda_knn.phase_a_tile(*args, **kw))
    plain_ms = time_ms(lambda: cuda_knn.phase_a_tile_plain(*args, **kw), iters=1, warmup=0)
    flops, pairs, inside = phase_a_ops(queries, reach2, cands, kw["kh"],
                                       kw.get("n_bisect", cuda_knn.N_BISECT))
    # the queries are the candidate planes' centre cells: x, y, z of the
    # occupied candidate slots and the mask cover both
    k4 = kernel_entry("phase_a_tile", counts, err, ms, plain_ms, flops,
                      slot_bytes(cands[3], 3) + nbytes(*out_k), peak, tie_rows=ties,
                      rows=cands[0].shape[0], cap=cap, occupied_pairs=pairs,
                      pairs_in_radius=inside, **variants,
                      list_len_stage=list(cuda_strip_knn.list_budget(
                          cap, 27 * cap, dtype, build.device_limits(DEVICE)[1])))

    # the tail: one launch over every cell row
    tail = None
    if calls["p3m_tail"]:
        (args, kw), = calls["p3m_tail"]
        planes = args[0]
        out_k = cuda_p3m_tail.p3m_tail(*args, **kw)
        out_p = cuda_p3m_tail.p3m_tail_plain(*args, **kw)
        rel, rtol, atol = check_phase_b(out_k, out_p, dtype, names=TAIL_OUTPUTS,
                                        kernel="p3m_tail")
        repeats = tail_repeats(args, kw, out_k)
        err = float((out_k - out_p).abs().max())
        ms = time_ms(lambda: cuda_p3m_tail.p3m_tail(*args, **kw))
        plain_ms = time_ms(lambda: cuda_p3m_tail.p3m_tail_plain(*args, **kw),
                           iters=1, warmup=0)
        pairs = tail_pairs(planes, kw["grid"], kw["cap"], kw["halfwidth"])
        tail = kernel_entry("p3m_tail", counts, err, ms, plain_ms, pairs * TAIL_OPS_PER_PAIR,
                            slot_bytes(planes[3], 3) + nbytes(out_k), peak,
                            max_err_over_scale=rel,
                            tolerance={"rtol": rtol, "atol_of_scale": atol},
                            occupied_pairs=pairs, halfwidth=kw["halfwidth"],
                            chunk=cuda_p3m_tail.TAIL_CHUNK, **repeats)

    k2 = k2_entry(calls["phase_b_tiles"], counts, dtype)
    k2_here = {k: k2[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "max_err_over_scale", "occupied_pairs",
                                  "pairs_in_a_mask", "kept_pair_share", "runs_bit_identical",
                                  "keep_all_bit_identical", "no_outlier_bit_identical")
              if k in k2}
    return k4, k2_here, tail


def phase_p3m_accuracy(res, cfg, gpu_line, s_per_step):
    """On the P3M path's final state, one force evaluation with exact
    gravity (mono-tile + K3) and one with P3M: the bars of
    tests/test_mesh_gravity.py::test_p3m_beats_reference_octree. Then the
    mesh's own time and its FFTs' share of a step."""
    st, p, h = res["state"], res["params"], res["h_last"]
    ghat = greens_hat(cfg.mesh_pad, cfg.sigma_cells, st.pos.dtype, DEVICE)
    cfg_ex = dataclasses.replace(cfg, gravity="exact")
    _, _, phi_e, fb_e = force_eval(cfg_ex, p, st.pos, st.vel, st.K, h, device=DEVICE)
    _, _, phi_p, fb_p = force_eval(cfg, p, st.pos, st.vel, st.K, h, ghat, device=DEVICE,
                                   **EVAL_REPAIRS)
    # g from the pieces force_eval sums (acc - hydro acc would cancel: on
    # this scene the pressure term is ~1e7 times gravity in code units)
    kw = dict(eos=cfg.eos, gamma=p.gamma, cs0=p.cs0, alpha=p.alpha, beta=p.beta,
              kh=cfg.kh, grid=cfg.tile[0], cap=cfg.tile[1], sigma_cells=cfg.sigma_cells,
              device=DEVICE)
    g_far = {
        "exact": gravity_newton_allpairs(st.pos, p.m, device=DEVICE)[0],
        "p3m": p3m_mesh_force(st.pos, p.m, ghat, gm=cfg.mesh_gm, pad=cfg.mesh_pad)[0],
    }
    g = {}
    for mode, mf in (("exact", 0), ("p3m", cfg.mesh_factor)):
        _, gcorr, _ = tiles.tile_sph_forces(st.pos, st.vel, p.m, st.K, h, mesh_factor=mf,
                                            **EVAL_REPAIRS, **kw)
        g[mode] = (g_far[mode] + torch.stack(gcorr[:3], dim=1)).double()
    sync()
    # the float32 P3M gravity corrections against float64 on this state
    # (the kernels in float64, held against their plain versions at 1e-9
    # above): a close pair's two corrections in two sweeps (the
    # reference's, F8) and as one float64 term (ROADMAP D21, the run loop's)
    f64 = [a.double() for a in (st.pos, st.vel, st.K, h)]
    _, gc64, ok64 = tiles.tile_sph_forces(*f64[:2], p.m, *f64[2:], mesh_factor=cfg.mesh_factor,
                                          **kw)
    f8 = {"ok_float64": bool(ok64)}
    for label, joint in (("two_sweeps", False), ("joint", True)):
        _, gc32, _ = tiles.tile_sph_forces(st.pos, st.vel, p.m, st.K, h,
                                           mesh_factor=cfg.mesh_factor, joint_gravity=joint, **kw)
        f8[label] = over_scale(gc32, gc64)
    del f64, gc64

    def rms(v):
        return float(torch.sqrt(torch.mean(torch.sum(v * v, dim=1))))

    dg = g["p3m"] - g["exact"]
    rms_g = rms(g["exact"])
    err = rms(dg) / rms_g
    phi_e, phi_p = phi_e.double(), phi_p.double()
    phi_rel = float(torch.sqrt(torch.mean(((phi_p - phi_e) / phi_e) ** 2)))
    mom = float((float(p.m) * dg.sum(0)).abs().max()) / rms_g

    dtype, pad = st.pos.dtype, cfg.mesh_pad
    mesh_ms = time_ms(lambda: p3m_mesh_force(st.pos, p.m, ghat, gm=cfg.mesh_gm, pad=pad))
    rho = torch.rand((pad, pad, pad), dtype=dtype, device=DEVICE)

    def ffts():
        rho_hat = torch.fft.rfftn(rho)
        for _ in range(4):
            torch.fft.irfftn(rho_hat, s=(pad, pad, pad))

    fft_ms = time_ms(ffts)
    checks = {
        "no fallback": not fb_e and not fb_p,
        "g error RMS < 2e-3 of |g|": err < 2e-3,
        "phi relative RMS < 1e-3": phi_rel < 1e-3,
        "momentum < 1e-5 of |g|": mom < 1e-5,
    }
    failed = [k for k, v in checks.items() if not v]
    say("p3m_accuracy", card=gpu_line, n=st.pos.shape[0], g_err_rms_over_rms_g=err,
        gcorr_f32_vs_f64_over_scale=f8,
        phi_rel_rms=phi_rel, momentum_over_rms_g=mom, rms_g=rms_g,
        mesh_ms_per_eval=mesh_ms, fft_ms_per_eval=fft_ms,
        mesh_share_of_step=2 * mesh_ms / 1e3 / s_per_step,
        fft_share_of_step=2 * fft_ms / 1e3 / s_per_step, failed=failed)
    if failed:
        raise AssertionError(f"P3M accuracy checks failed: {failed}")


# --------------------------------------------------------------------------
# the collapse path (block-compact engine)
# --------------------------------------------------------------------------

HERE = os.path.dirname(os.path.abspath(__file__))
COLLAPSE = os.path.join(HERE, "bench_data", "bb_collapsed.npz")
COLLAPSE_DEEP = os.path.join(HERE, "bench_data", "bb_collapsed_deep.npz")
# code units of the committed collapse states (their `note`): G = 1 with
COLLAPSE_R, COLLAPSE_M = 1.077e17, 1.989e33  # unit length [cm], unit mass [g]
KH_COLLAPSE = 50  # and the reference's hard-regime parameters (bench.py:175-183)
# Phase B of the block engine (K5, K6), counted on phase_b_grouped.cu's
# pair_terms. Every occupied pair needs d2 and one compare against the
# query's visibility radius max(2 h_q, r_c), squared once a query row; only
# a pair inside it needs the rest: 1/r, the mask radii, one kernel gradient,
# viscosity, the softened-gravity polynomials, the weights and 18 sums (130
# in all, the test included). The P3M tail adds the erfcx chain
# (TAIL_OPS_PER_PAIR less d2 and the sums).
K5_OPS_PAIR_TEST = K1_OPS_D2 + 1
K5_OPS_PER_PAIR = 130
K5_OPS_P3M_EXTRA = 32


def write_collapse_snapshot(root: str, path: str) -> None:
    """A committed collapse state (code units, float32 or float64) as
    snapshot 1 of boss_bodenheimer under `root`, through the port's writer,
    in CGS with the units of its note; the run parameters of the reference's
    hard-regime benchmark: Kh 50, polytropic, gamma 5/3, alpha 1, beta 2."""
    from sphtpu_torch import constants as C
    from sphtpu_torch.io import write_snapshot
    from sphtpu_torch.scenes.setup import DEFAULTS
    from sphtpu_torch.units import UnitSystem

    d = np.load(path)
    u = UnitSystem.from_constants(C.G_CGS, COLLAPSE_M, COLLAPSE_R)
    gamma = 5.0 / 3.0
    consts = {
        "iterID": 1, "N": int(d["pos"].shape[0]), "Kh": KH_COLLAPSE, "Kgr": DEFAULTS["Kgr"],
        "t": float(d["t"]) * u.T, "tEnd": DEFAULTS["tEnd"], "M": COLLAPSE_M, "R": COLLAPSE_R,
        "alpha": 1.0, "beta": 2.0, "G": C.G_CGS, "theta": DEFAULTS["theta"],
        "m": float(d["m"]) * u.M, "gamma": gamma,
    }
    write_snapshot(
        "1", "boss_bodenheimer", d["pos"].astype(np.float64) * u.L,
        d["vel"].astype(np.float64) * u.V, K=d["K"].astype(np.float64) * u.K_entropy(gamma),
        constants=consts, root=root,
    )


def block_counts_want(n_buckets: int, grouped: bool = True, steps: int = 4) -> dict:
    """Launches of `steps` steps (2 evaluations each) on a block config
    with exact gravity: K1 once a bucket, K5 once (or K6 once a bucket), K3
    once, per evaluation."""
    want = {name: 0 for name in MODULES}
    evals = 2 * steps
    want.update(phase_a_cells=evals * n_buckets, newton_sweep=evals)
    if grouped:
        want["phase_b_grouped"] = evals
    else:
        want["phase_b_blocks"] = evals * n_buckets
    return want


def phase_collapse_path(tmp: str, gpu_line: str):
    """bb_collapsed.npz (N = 100 000, density contrast 395) written as a
    snapshot and run four steps through the CLI: no tile engine can plan
    it, so the planner gives the block-compact engine (exact gravity at this
    N): K1 once a bucket, K5 and K3 once an evaluation, and no fallback."""
    root = os.path.join(tmp, "collapse")
    write_collapse_snapshot(root, COLLAPSE)
    res, counts, checks, drift = drive_cli(root, N_MAIN, generate=False)
    cfg = res["configs"][0]
    buckets = list(cfg.blocks[0]) if cfg.blocks is not None else []
    checks.update({
        "one config, block-compact": len(res["configs"]) == 1 and cfg.blocks is not None,
        "exact gravity": cfg.gravity == "exact",
        "kernel launches": counts == block_counts_want(len(buckets)),
    })
    failed = [k for k, v in checks.items() if not v]
    walls = walls_summary(res, N_MAIN)
    say(
        "collapse_path", card=gpu_line,
        scene=f"bb_collapsed.npz (contrast 395) polytropic N={N_MAIN} Kh={KH_COLLAPSE} float32",
        plan={"buckets": [list(b) for b in buckets],
              "octave_grids": list(cfg.blocks[1]) if buckets else None,
              "fine_grid": cfg.blocks[3] if buckets else None,
              "pair_slots_a_phase": sum(cb * nb for cb, nb in buckets) * blocks.BQ},
        steps=res["steps"], fallback_evals=res["fallback_evals"], launches=counts,
        energy_drift=drift, **walls, snapshot_ids=res["snapshot_ids"],
        runtime_s=res["runtime_s"], failed=failed,
    )
    if failed:
        raise AssertionError(f"collapse path checks failed: {failed}")
    return res, cfg, counts


P3M_BLOCK_STEPS = 6  # three ML_SUBCHUNK block chunks


def phase_collapse_p3m_blocks(tmp: str, gpu_line: str):
    """bb_collapsed.npz through run_simulation(gravity="p3m") for six
    steps (snapshots only at the end, so that every chunk is ML_SUBCHUNK
    steps long): three 2-step chunks of the block engine (K1 once a bucket and K5
    once an evaluation; the mesh far field, no K3, no tail), the host refit
    between them. The plans cover the P3M tail radius with their drift
    margin (driver.PLAN_REPAIRS, ROADMAP D19), so no evaluation may fall
    back; the plan of the reference (no margin) fails every evaluation
    after a plan's first (F6). Also: how often the refit declined, and, on
    the initial state, the plan with and without the margin (buckets, pair
    slots) and K5's time on one evaluation of each (held against its plain
    version in float32). Returns K5's entry on this path."""
    from sphtpu_torch.engine import driver

    root = os.path.join(tmp, "collapse_p3m")
    write_collapse_snapshot(root, COLLAPSE)
    refits = []

    def counting(orig):
        def refit(*a, **kw):
            out = orig(*a, **kw)
            refits.append(out is not None)
            return out

        return refit

    reset_counts()
    with patched(driver, "block_args_for_spec", counting):
        res = driver.run_simulation(
            "polytropic", "boss_bodenheimer", 1, 2, False, False, root=root, gravity="p3m",
            max_steps=P3M_BLOCK_STEPS, verbose=False, device=DEVICE)
    sync()
    counts = {name: mod.launches for name, mod in MODULES.items()}
    cfgs = res["chunk_configs"]
    buckets = [list(b) for b in cfgs[0].blocks[0]] if cfgs and cfgs[0].blocks else []
    evals = 2 * P3M_BLOCK_STEPS
    checks = {
        f"{P3M_BLOCK_STEPS} steps": res["steps"] == P3M_BLOCK_STEPS,
        "0 fallback evals": res["fallback_evals"] == 0,
        "3 block chunks under P3M": len(cfgs) == 3 and all(
            c.blocks is not None and c.gravity == "p3m" for c in cfgs),
        "K5 once an evaluation, no K3, no tail": counts["phase_b_grouped"] == evals
        and counts["newton_sweep"] == 0 and counts["p3m_tail"] == 0,
        "K1 once a bucket an evaluation": counts["phase_a_cells"] == sum(
            2 * steps * len(c.blocks[0]) for (steps, _, _), c in zip(res["chunk_walls"], cfgs)),
    }

    # the plan with and without the margin on the initial state, K5 on each
    pos_h, _, h_h, st, p, h_dev = collapse_state(COLLAPSE)
    plans = {}
    for label, margin in (("no_margin", 1.0), ("margin", PLAN_REPAIRS["tail_margin"])):
        spec, bargs = blocks.plan_blocks(pos_h, h_h, KH_COLLAPSE, gravity="p3m",
                                         tail_margin=margin)
        cfg = EngineConfig(n=pos_h.shape[0], kh=KH_COLLAPSE, eos="polytropic",
                           dtype="float32", blocks=spec, gravity="p3m")
        calls = capture_eval_inputs({"state": st, "params": p, "h_last": h_dev}, cfg, blocks,
                                    ("phase_b_grouped",), mlargs=bargs)
        (args, kw), = calls["phase_b_grouped"]
        units, summary = k5_units(args[0], args[1], kw)
        kw = dict(kw, units=units)
        checked = k5_check(args, kw, dtypes=(torch.float32,))["float32"]
        plans[label] = {
            "tail_margin": margin, "buckets": [list(b) for b in spec[0]],
            "pair_slots": sum(cb * nb for cb, nb in spec[0]) * blocks.BQ,
            "k5_ms": time_ms(lambda: cuda_grouped_pairs.phase_b_grouped(*args, **kw), iters=5),
            "k5_f32_max_err_over_scale": checked["max_err_over_scale"], **summary}
        del calls, args, kw
        torch.cuda.empty_cache()
    failed = [k for k, v in checks.items() if not v]
    say("collapse_p3m_blocks", card=gpu_line,
        scene=f"bb_collapsed.npz (contrast 395) polytropic N={N_MAIN} Kh={KH_COLLAPSE} "
              "float32, gravity p3m",
        plan={"buckets": buckets, "tail_margin": PLAN_REPAIRS["tail_margin"]},
        steps=res["steps"], fallback_evals=res["fallback_evals"],
        chunk_engines=res["chunk_engines"], refits=len(refits),
        refits_declined=refits.count(False), launches=counts,
        **walls_summary(res, N_MAIN), plans_on_initial_state=plans, failed=failed)
    if failed:
        raise AssertionError(f"collapse P3M block path checks failed: {failed}")
    return counts


def refit_args(res, cfg):
    """The final state's BlockArgs in cfg's spec, as the run loop's next
    chunk would refit them."""
    st = res["state"]
    pos_h = st.pos.detach().double().cpu().numpy()
    h_h = res["h_last"].detach().double().cpu().numpy()
    args = blocks.block_args_for_spec(pos_h, h_h, cfg.blocks, gravity=cfg.gravity,
                                      **PLAN_REPAIRS)
    if args is None:
        raise AssertionError(f"the final state does not refit its spec: {blocks.last_refit_fail()}")
    return args


def block_pairs(qfields, cands, q_index, r_c, batch: int = 64):
    """(occupied pairs, occupied pairs inside the query's visibility radius
    max(2 h_q, r_c)) of a phase-B launch: rows of candidates `cands` =
    (x, y, z, mask), each (rows, width), row i against query block
    q_index[i] of qfields."""
    total = inside = 0
    for r0 in range(0, cands[0].shape[0], batch):
        sl = slice(r0, r0 + batch)
        qb = q_index[sl]
        qx, qy, qz, qm, qh = (qfields[k][qb] for k in (0, 1, 2, 6, 7))
        cx, cy, cz, cm = (c[sl] for c in cands)
        d2 = ((qx[:, :, None] - cx[:, None, :]) ** 2 + (qy[:, :, None] - cy[:, None, :]) ** 2
              + (qz[:, :, None] - cz[:, None, :]) ** 2)
        reach = torch.clamp_min(2 * qh, float(r_c))[:, :, None]
        occ = (qm[:, :, None] > 0) & (cm[:, None, :] > 0)
        total += int(((qm > 0).sum(1) * (cm > 0).sum(1)).sum())
        inside += int((occ & (d2 <= reach * reach)).sum())
    return float(total), float(inside)


def pairs_ops(total: float, inside: float, p3m: bool) -> float:
    """Operations of K5's or K6's function: the test on every occupied pair,
    the body on the pairs inside the visibility radius."""
    body = K5_OPS_PER_PAIR + (K5_OPS_P3M_EXTRA if p3m else 0)
    return total * K5_OPS_PAIR_TEST + inside * (body - K5_OPS_PAIR_TEST)


def phase_collapse_kernels(res, cfg, counts, gpu_line):
    """K1 (every bucket), K5 and, on the per-bucket path, K6 against their
    plain versions on the inputs one force evaluation of the collapse
    path's final state gives them; errors, times, bounds. The per-bucket
    path: one step of make_chunk_runner(grouped=False) from that state, its
    launch counts set to 0 just before and read just after. K5 and K6 are
    also held in float64 and must give two bit-identical launches; K6 also
    on synthetic blocks of C_b 768, 32 768, 700 and 1 300 (`k6_widths`)."""
    bargs = refit_args(res, cfg)
    dtype = res["state"].pos.dtype
    peak = PEAK_FLOPS[dtype]
    ev_g = {}
    calls = capture_eval_inputs(res, cfg, blocks, ("phase_a_cells", "phase_b_grouped"),
                                mlargs=bargs, out=ev_g)

    # K1, one launch a bucket
    k1 = k1_numbers(calls["phase_a_cells"], iters=3)
    k1 = {"launches": counts["phase_a_cells"], "max_abs_err": k1.pop("err"), "ms": k1.pop("ms"),
          "plain_ms": k1.pop("plain_ms"), **bound(k1.pop("flops"), k1.pop("bytes"), peak),
          **k1, "c_b_of_launches": [args[2][0].shape[1] for args, _ in calls["phase_a_cells"]],
          "n_bisect": calls["phase_a_cells"][0][1]["n_bisect"]}

    # K5, one launch: also in float64, and two launches bit-identical
    (args, kw), = calls["phase_b_grouped"]
    qfields, cstack = args[0], args[1]
    checks5 = k5_check(args, kw)
    ms = time_ms(lambda: cuda_grouped_pairs.phase_b_grouped(*args, **kw), iters=3)
    plain_ms = time_ms(lambda: cuda_grouped_pairs.phase_b_grouped_plain(*args, **plain_kw(kw)),
                       iters=1, warmup=0)
    qblk = torch.as_tensor(kw["qblk"], device=DEVICE)
    total, inside = block_pairs(qfields, tuple(cstack[:, k] for k in (0, 1, 2, 9)), qblk,
                                args[6])
    qo_k, co_k = cuda_grouped_pairs.phase_b_grouped(*args, **kw)
    byts = (slot_bytes(qfields[6], 10) + slot_bytes(cstack[:, 9], 9)
            + nbytes(*qo_k, co_k))
    f32 = checks5.pop("float32")
    k5 = kernel_entry("phase_b_grouped", counts, f32["max_abs_err"], ms, plain_ms,
                      pairs_ops(total, inside, kw["p3m"]), byts, peak,
                      max_err_over_scale=f32["max_err_over_scale"],
                      tolerance={"rtol": f32["rtol"], "atol_of_scale": f32["atol_of_scale"]},
                      runs_bit_identical=True, float64=checks5.pop("float64"),
                      chunks=int(cstack.shape[0]), occupied_pairs=total,
                      pairs_in_visibility=inside, **checks5,
                      chunks_a_block_min_max=[min(cb for cb, _ in cfg.blocks[0]) // 512,
                                              max(cb for cb, _ in cfg.blocks[0]) // 512])

    # the per-bucket path: K6 once a bucket an evaluation
    st, p = res["state"], res["params"]
    reset_counts()
    out_pb = make_chunk_runner(cfg, device=DEVICE, grouped=False)(
        st, p, res["h_last"], 1, bargs)
    sync()
    counts_pb = {name: mod.launches for name, mod in MODULES.items()}
    checks = {"0 fallback evals": int(out_pb[5].sum()) == 0,
              "kernel launches": counts_pb == block_counts_want(len(cfg.blocks[0]), False, 1)}
    ev_b = {}
    calls_b = capture_eval_inputs(res, cfg, blocks, ("phase_b_blocks",), mlargs=bargs,
                                  grouped=False, out=ev_b)
    ms = plain_ms = flops = byts = 0.0
    worst6, shapes = {}, []
    for args, kw in calls_b["phase_b_blocks"]:
        qfields, cfields = args[0], args[1]
        for name, r in k6_check(args, kw).items():  # the launch's dtype and float64
            w = worst6.setdefault(name, dict(r))
            for key in ("max_err_over_scale", "max_abs_err"):
                w[key] = max(w[key], r[key])
        ms += time_ms(lambda: cuda_block_pairs.phase_b_blocks(*args, **kw), iters=3)
        plain_ms += time_ms(lambda: cuda_block_pairs.phase_b_blocks_plain(*args, **kw),
                            iters=1, warmup=0)
        rows = torch.arange(cfields[0].shape[0], device=DEVICE)
        tot, ins = block_pairs(qfields, (cfields[0], cfields[1], cfields[2], cfields[6]),
                               rows, args[6])
        flops += pairs_ops(tot, ins, kw["p3m"])
        # the outputs: 10 query-side (nb, cap) and 8 candidate-side (nb, C_b) planes
        byts += (slot_bytes(qfields[6], 10) + slot_bytes(cfields[6], 9)
                 + nbytes(qfields[0]) * 10 + nbytes(cfields[0]) * 8)
        nb, cw = cfields[0].shape
        shapes.append([cw, nb, cuda_block_pairs.block_units(cw)])
    f32 = worst6.pop(str(dtype)[6:])
    k6 = kernel_entry("phase_b_blocks", counts_pb, f32["max_abs_err"], ms, plain_ms, flops,
                      byts, peak, max_err_over_scale=f32["max_err_over_scale"],
                      tolerance={"rtol": f32["rtol"], "atol_of_scale": f32["atol_of_scale"]},
                      runs_bit_identical=True, float64=worst6.pop("float64"),
                      launches_path="collapse_per_bucket",
                      c_b_blocks_units_of_launches=shapes,
                      synthetic_widths=k6_widths(1.0e-5))
    # the two phase-B forms give one evaluation to f32 reassociation
    worst = check_phase_b(
        (ev_b["acc"][:, 0], ev_b["red"].visc_dk, ev_b["phi"]),
        (ev_g["acc"][:, 0], ev_g["red"].visc_dk, ev_g["phi"]), dtype,
        names=("acc_x", "visc_dk", "phi"), kernel="per-bucket vs grouped evaluation")[0]
    failed = [k for k, v in checks.items() if not v]
    say("collapse_per_bucket", card=gpu_line, launches=counts_pb,
        fallback_evals=int(out_pb[5].sum()), eval_err_over_scale=worst, failed=failed)
    if failed:
        raise AssertionError(f"per-bucket path checks failed: {failed}")
    return k1, k5, k6, counts_pb, bargs


def bound(flops, byts, peak):
    """The least time the card could take: operations over the peak rate or
    bytes over the memory rate, whichever is larger (ms, and which)."""
    t_ops = flops / peak * 1e3
    t_bytes = byts / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_collapse_vs_gather(res, cfg, bargs, gpu_line):
    """One block-engine evaluation of the collapse path's final state
    against the gather engine's on the card: h, rho, the hydro acceleration
    and g (Newtonian sweep + the block corrections against the softened
    all-pairs sum)."""
    from sphtpu_torch.engine.step import _gather_reduced
    from sphtpu_torch.physics import gravity_allpairs

    st, p, h = res["state"], res["params"], res["h_last"]
    red_b, gcorr, ok = blocks.block_sph_forces(
        st.pos, st.vel, p.m, st.K, h, bargs, eos=cfg.eos, gamma=p.gamma, cs0=p.cs0,
        alpha=p.alpha, beta=p.beta, kh=cfg.kh, spec=cfg.blocks,
    )
    g_b = gravity_newton_allpairs(st.pos, p.m, device=DEVICE)[0] + torch.stack(gcorr[:3], 1)
    t0 = time.time()
    red_g = _gather_reduced(dataclasses.replace(cfg, blocks=None), p, st.pos, st.vel, st.K)
    g_g = gravity_allpairs(st.pos, red_g.h, p.m)[0]
    sync()
    gather_s = time.time() - t0
    eps = torch.finfo(st.pos.dtype).eps
    h_rel = float(((red_b.h - red_g.h).abs() / red_g.h).max())
    rho_rel = float(((red_b.rho - red_g.rho).abs() / red_g.rho).max())
    worst, rtol, atol = check_phase_b(
        (red_b.acc[:, 0], red_b.acc[:, 1], red_b.acc[:, 2], g_b[:, 0], g_b[:, 1], g_b[:, 2]),
        (red_g.acc[:, 0], red_g.acc[:, 1], red_g.acc[:, 2], g_g[:, 0], g_g[:, 1], g_g[:, 2]),
        st.pos.dtype, names=("acc_x", "acc_y", "acc_z", "g_x", "g_y", "g_z"),
        kernel="block vs gather")
    checks = {"certified": bool(ok), "h within 4 ulp": h_rel <= 4 * float(eps),
              "rho within 1e-5": rho_rel <= 1e-5}
    failed = [k for k, v in checks.items() if not v]
    say("collapse_vs_gather", card=gpu_line, h_max_rel_err=h_rel, rho_max_rel_err=rho_rel,
        acc_g_max_err_over_scale=worst, tolerance={"rtol": rtol, "atol_of_scale": atol},
        gather_eval_s=gather_s, failed=failed)
    if failed:
        raise AssertionError(f"block vs gather checks failed: {failed}")


def phase_deep_state(gpu_line):
    """bb_collapsed_deep.npz (contrast 1001): the block plan and one
    evaluation in each gravity mode must certify; K5 on each evaluation's
    inputs (`k5_check`, float32 and float64); the P3M force error against
    the exact sweep within the bars of tests/test_mesh_gravity.py."""
    from sphtpu_torch.engine import params_from_numpy

    d = np.load(COLLAPSE_DEEP)
    pos_h, h_h = d["pos"].astype(np.float64), d["h"].astype(np.float64)
    st = state_from_numpy(pos_h, d["vel"], d["K"], float(d["t"]), device=DEVICE)
    p = params_from_numpy(m=float(d["m"]), gamma=5 / 3, cs0=0.0, alpha=1.0, beta=2.0, U0=0.0,
                          t_end=1e30, device=DEVICE)
    h = dev(h_h, torch.float32)
    g, phi, plans, ms, k5 = {}, {}, {}, {}, {}
    for grav in ("exact", "p3m"):
        plan = blocks.plan_blocks(pos_h, h_h, KH_COLLAPSE, gravity=grav, **PLAN_REPAIRS)
        if plan is None:
            raise AssertionError(f"the deep state does not plan under {grav} gravity")
        spec, bargs = plan
        cfg = EngineConfig(n=pos_h.shape[0], kh=KH_COLLAPSE, eos="polytropic", dtype="float32",
                           blocks=spec, gravity=grav)
        bargs = blocks.block_args_to_device(bargs, torch.float32, DEVICE)
        tables = blocks.build_cand_tables(bargs, spec, cfg.n)

        def evaluate():
            return blocks.block_sph_forces(
                st.pos, st.vel, p.m, st.K, h, bargs, eos="polytropic", gamma=p.gamma,
                cs0=p.cs0, alpha=p.alpha, beta=p.beta, kh=KH_COLLAPSE, spec=spec,
                gravity=grav, mesh_factor=cfg.mesh_factor, sigma_cells=cfg.sigma_cells,
                idx_tables=tables,
            )

        calls = {"phase_b_grouped": []}
        orig = blocks.phase_b_grouped

        def rec(*a, **kw):
            calls["phase_b_grouped"].append((a, kw))
            return orig(*a, **kw)

        blocks.phase_b_grouped = rec
        try:
            red, gcorr, ok = evaluate()
        finally:
            blocks.phase_b_grouped = orig
        if not bool(ok):
            raise AssertionError(f"the deep state's {grav} evaluation does not certify")
        (a5, kw5), = calls["phase_b_grouped"]
        k5[grav] = k5_check(a5, kw5)
        del calls, a5, kw5
        ms[grav] = time_ms(evaluate, iters=3)
        if grav == "p3m":
            ghat = greens_hat(cfg.mesh_pad, cfg.sigma_cells, torch.float32, DEVICE)
            gfar, phifar = p3m_mesh_force(st.pos, p.m, ghat, gm=cfg.mesh_gm, pad=cfg.mesh_pad)
        else:
            gfar, phifar = gravity_newton_allpairs(st.pos, p.m, device=DEVICE)
        g[grav] = (gfar + torch.stack(gcorr[:3], 1)).double()
        phi[grav] = (phifar + gcorr[3]).double()
        plans[grav] = {"buckets": [list(b) for b in spec[0]], "octave_grids": list(spec[1]),
                       "pair_slots_a_phase": sum(cb * nb for cb, nb in spec[0]) * blocks.BQ}

    def rms(v):
        return float(torch.sqrt(torch.mean(torch.sum(v * v, dim=1))))

    dg = g["p3m"] - g["exact"]
    rms_g = rms(g["exact"])
    err = rms(dg) / rms_g
    phi_rel = float(torch.sqrt(torch.mean(((phi["p3m"] - phi["exact"]) / phi["exact"]) ** 2)))
    mom = float((float(p.m) * dg.sum(0)).abs().max()) / rms_g
    checks = {"g error RMS < 2e-3 of |g|": err < 2e-3, "phi relative RMS < 1e-3": phi_rel < 1e-3,
              "momentum < 1e-5 of |g|": mom < 1e-5}
    failed = [k for k, v in checks.items() if not v]
    say("deep_state", card=gpu_line, scene="bb_collapsed_deep.npz (contrast 1001) N=100000 "
        "Kh=50 float32", plans=plans, block_eval_ms=ms, certified=True, k5=k5,
        g_err_rms_over_rms_g=err, phi_rel_rms=phi_rel, momentum_over_rms_g=mom, failed=failed)
    if failed:
        raise AssertionError(f"deep-state checks failed: {failed}")


# --------------------------------------------------------------------------
# the multi-level engine (physics/mlevel.py) on the contrast-1001 state
# --------------------------------------------------------------------------

class StageClock:
    """name -> context manager adding the wall seconds of the stage to
    `seconds[name]`, the card synchronised at both ends."""

    def __init__(self):
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, name):
        sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync()
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def patched(module, name, wrapper):
    """module.name replaced by wrapper(original) inside the block."""
    orig = getattr(module, name)
    setattr(module, name, wrapper(orig))
    try:
        yield orig
    finally:
        setattr(module, name, orig)


def deep_state():
    """bb_collapsed_deep.npz on the card (float32) with h from a k = 50
    KD-tree (the run loop's bootstrap): (pos, h as float64 host arrays,
    state, params, h on the card)."""
    from scipy.spatial import cKDTree

    from sphtpu_torch.engine import params_from_numpy

    d = np.load(COLLAPSE_DEEP)
    pos_h = d["pos"].astype(np.float64)
    h_h = cKDTree(pos_h).query(pos_h, k=KH_COLLAPSE)[0][:, -1] / 2.0
    st = state_from_numpy(pos_h, d["vel"], d["K"], float(d["t"]), device=DEVICE)
    p = params_from_numpy(m=float(d["m"]), gamma=5 / 3, cs0=0.0, alpha=1.0, beta=2.0, U0=0.0,
                          t_end=1e30, device=DEVICE)
    return pos_h, h_h, st, p, dev(h_h, torch.float32)


def far_field(cfg, st, p, ghat):
    """The far field of a tile config: the FFT mesh under p3m, K3 else."""
    if cfg.gravity == "p3m":
        return p3m_mesh_force(st.pos, p.m, ghat, gm=cfg.mesh_gm, pad=cfg.mesh_pad)
    return gravity_newton_allpairs(st.pos, p.m, device=DEVICE)


def mlevel_eval(cfg, st, p, h, margs, ghat, clock=None):
    """One multi-level evaluation of the state, and its far field:
    (reduced forces, g, phi, ok); with a clock, each of the engine's
    profiling stages timed by it."""
    with contextlib.ExitStack() as es:
        if clock is not None:
            es.enter_context(patched(mlevel, "stage", lambda orig: clock))
        red, gcorr, ok = mlevel.mlevel_sph_forces(
            st.pos, st.vel, p.m, st.K, h, margs, eos=cfg.eos, gamma=p.gamma, cs0=p.cs0,
            alpha=p.alpha, beta=p.beta, kh=cfg.kh, spec=cfg.mlevel,
            mesh_factor=cfg.mesh_factor, sigma_cells=cfg.sigma_cells, **EVAL_REPAIRS,
        )
    with clock("gravity") if clock else contextlib.nullcontext():
        gfar, phifar = far_field(cfg, st, p, ghat)
    return red, gfar + torch.stack(gcorr[:3], 1), phifar + gcorr[3], bool(ok)


def block_eval(cfg, st, p, h, bargs, tables, ghat, clock=None):
    """One block-engine evaluation of the state (K1 timed as its phase A,
    K5 as its phase B when a clock is given) and its far field."""
    def timed(name):
        def wrap(orig):
            def run(*a, **kw):
                with clock(name):
                    return orig(*a, **kw)
            return run
        return wrap

    with contextlib.ExitStack() as es:
        if clock is not None:
            es.enter_context(patched(blocks, "phase_a_cells", timed("phase_a")))
            es.enter_context(patched(blocks, "phase_b_grouped", timed("phase_b")))
        red, gcorr, ok = blocks.block_sph_forces(
            st.pos, st.vel, p.m, st.K, h, bargs, eos=cfg.eos, gamma=p.gamma, cs0=p.cs0,
            alpha=p.alpha, beta=p.beta, kh=cfg.kh, spec=cfg.blocks, gravity=cfg.gravity,
            mesh_factor=cfg.mesh_factor, sigma_cells=cfg.sigma_cells, idx_tables=tables,
        )
    with clock("gravity") if clock else contextlib.nullcontext():
        gfar, phifar = far_field(cfg, st, p, ghat)
    return red, gfar + torch.stack(gcorr[:3], 1), phifar + gcorr[3], bool(ok)


def timed_eval(fn):
    """fn()'s result, and its wall seconds split by stage (a StageClock
    passed as `clock`) with the whole evaluation's beside them."""
    clock = StageClock()
    sync()
    t0 = time.perf_counter()
    out = fn(clock)
    sync()
    seconds = dict(clock.seconds, total=time.perf_counter() - t0)
    seconds["other"] = seconds["total"] - sum(v for k, v in seconds.items() if k != "total")
    return out, seconds


def as_float64(st, p):
    """A State and its Params cast to float64 on the card."""
    return type(st)(*(x.double() for x in st)), type(p)(*(x.double() for x in p))


def over_scale(outs, refs):
    """The largest |a - b| over the largest |b|, for each output pair."""
    return [float((a.double() - b).abs().max() / b.abs().max()) for a, b in zip(outs, refs)]


# A pair counted by both of a close pair's kernels, or by neither, would
# miss its float64 value by about its own 1/r^2 term: orders of magnitude
# beyond float32 roundoff (measured up to 2.5e-4 of the scale in two sweeps)
GCORR_GROSS_BAR = 1e-3


def phase_mlevel(gpu_line):
    """The multi-level engine on bb_collapsed_deep.npz (N = 100 000,
    contrast 1001, Kh = 50, polytropic, float32), in both gravity modes:
    the port's plan_mlevel and its spec; one evaluation, which must certify,
    held against the block engine's on the same state (h bit for bit but
    for ties, ok, the hydro acceleration within check_phase_b's float32
    bars, and under exact gravity g and phi too); under P3M the force error
    against the exact evaluation (< 2e-3 of the RMS |g|); each evaluation's
    seconds by stage beside the block engine's; then a 2-step chunk
    (ML_SUBCHUNK) from the state, with the launch counts set to 0 just
    before and read just after, its certificate per evaluation, fallbacks
    and energy drift (< 1e-2). K1 is held against its plain version on one
    evaluation's launches (exact gravity). Returns (K1's numbers on this
    path, launch counts by chunk)."""
    from sphtpu_torch.engine import driver, step as step_mod

    pos_h, h_h, st, p, h = deep_state()
    n = pos_h.shape[0]
    peak = PEAK_FLOPS[torch.float32]
    report, counts_by, g_ml, k1 = {}, {}, {}, None
    for grav in ("exact", "p3m"):
        t0 = time.time()
        plan = mlevel.plan_mlevel(pos_h, h_h, KH_COLLAPSE, gravity=grav)
        plan_s = time.time() - t0
        if plan is None:
            raise AssertionError(f"the deep state does not plan the multi-level engine ({grav})")
        spec, args = plan
        cfg = EngineConfig(n=n, kh=KH_COLLAPSE, eos="polytropic", dtype="float32", mlevel=spec,
                           gravity=grav)
        margs = mlevel.mlevel_args_to_device(args, DEVICE)
        ghat = (greens_hat(cfg.mesh_pad, cfg.sigma_cells, torch.float32, DEVICE)
                if grav == "p3m" else None)

        calls = []

        def record(orig):
            def rec(*a, **kw):
                calls.append((a, kw))
                return orig(*a, **kw)
            return rec

        with patched(mlevel, "phase_a_cells", record):
            mlevel_eval(cfg, st, p, h, margs, ghat)  # warm-up, records K1's launches
        (red, g, phi, ok), ml_s = timed_eval(
            lambda clock: mlevel_eval(cfg, st, p, h, margs, ghat, clock))
        g_ml[grav] = g.double()
        f8 = None
        if grav == "p3m":
            # the float32 gravity corrections against float64 (the two
            # sweeps, as the reference adds them): two sweeps and the run
            # loop's joint term (ROADMAP D21)
            def gcorr(st_, p_, h_, joint):
                _, gc, ok_ = mlevel.mlevel_sph_forces(
                    st_.pos, st_.vel, p_.m, st_.K, h_, margs, eos=cfg.eos, gamma=p_.gamma,
                    cs0=p_.cs0, alpha=p_.alpha, beta=p_.beta, kh=cfg.kh, spec=cfg.mlevel,
                    mesh_factor=cfg.mesh_factor, sigma_cells=cfg.sigma_cells,
                    joint_gravity=joint)
                if not bool(ok_):
                    raise AssertionError(f"mlevel {st_.pos.dtype} evaluation did not certify")
                return gc

            st64, p64 = as_float64(st, p)
            gc64 = [x.double() for x in gcorr(st64, p64, h.double(), False)]
            del st64, p64
            f8 = {label: over_scale(gcorr(st, p, h, joint), gc64)
                  for label, joint in (("two_sweeps", False), ("joint", True))}
            del gc64

        bplan = blocks.plan_blocks(pos_h, h_h, KH_COLLAPSE, gravity=grav, **PLAN_REPAIRS)
        bcfg = EngineConfig(n=n, kh=KH_COLLAPSE, eos="polytropic", dtype="float32",
                            blocks=bplan[0], gravity=grav)
        bargs = blocks.block_args_to_device(bplan[1], torch.float32, DEVICE)
        tables = blocks.build_cand_tables(bargs, bplan[0], n)
        ghat_b = (greens_hat(bcfg.mesh_pad, bcfg.sigma_cells, torch.float32, DEVICE)
                  if grav == "p3m" else None)
        block_eval(bcfg, st, p, h, bargs, tables, ghat_b)
        (red_b, g_b, phi_b, ok_b), blk_s = timed_eval(
            lambda clock: block_eval(bcfg, st, p, h, bargs, tables, ghat_b, clock))

        h_differ = int((red.h != red_b.h).sum())
        eps = torch.finfo(torch.float32).eps
        h_rel = float(((red.h - red_b.h).abs() / red_b.h).max())
        outs_ml = [red.acc[:, a] for a in range(3)]
        outs_b = [red_b.acc[:, a] for a in range(3)]
        names = ["acc_x", "acc_y", "acc_z"]
        if grav == "exact":
            outs_ml += [g[:, 0], g[:, 1], g[:, 2], phi]
            outs_b += [g_b[:, 0], g_b[:, 1], g_b[:, 2], phi_b]
            names += ["g_x", "g_y", "g_z", "phi"]
        worst, rtol, atol = check_phase_b(outs_ml, outs_b, torch.float32, names=names,
                                          kernel=f"mlevel vs blocks ({grav})")

        if grav == "exact":
            k1 = k1_numbers(calls, iters=3)
            for a, kw in calls:
                if not same_bits(cuda_strip_knn.phase_a_cells(*a, **kw),
                                 cuda_strip_knn.phase_a_cells(*a, **kw)):
                    raise AssertionError("phase_a_cells: two launches on the mlevel path differ")
            k1.update(runs_bit_identical=True,
                      cap_b_of_launches=[kw["cap"] for _, kw in calls],
                      rows_of_launches=[a[0][0].shape[0] for a, _ in calls],
                      n_bisect=calls[0][1]["n_bisect"])
        del calls

        # the 2-step chunk, every evaluation's certificate recorded
        oks = []

        def keep_ok(orig):
            def rec(*a, **kw):
                out = orig(*a, **kw)
                oks.append(bool(out[2]))
                return out
            return rec

        with patched(step_mod, "mlevel_sph_forces", keep_ok):
            reset_counts()
            t0 = time.time()
            out = make_chunk_runner(cfg, device=DEVICE, **CHUNK_REPAIRS)(
                st, p, h, driver.ML_SUBCHUNK, args)
            sync()
            chunk_s = time.time() - t0
        counts = {name: mod.launches for name, mod in MODULES.items()}
        counts_by[f"mlevel_{grav}_chunk"] = counts
        e = out[1][:, 4].double().cpu().numpy()
        drift = float(np.abs(e - e[0]).max() / abs(e[0]))
        n_evals = 2 * driver.ML_SUBCHUNK
        n_buckets = sum(len(lv[2]) for lv in spec[0])
        want = {name: 0 for name in MODULES}
        want.update(phase_a_cells=n_evals * n_buckets,
                    newton_sweep=sum(oks) if grav == "exact" else 0)
        checks = {
            "plans": True, "certified": ok, "block engine certifies": ok_b,
            "h as the block engine's but for ties": h_rel <= 4 * float(eps),
            "chunk valid": bool(out[2].all()), "|dE/E| < 1e-2": drift < 1e-2,
            "kernel launches": counts == want,
        }
        if f8 is not None:
            checks[f"joint gcorr within {GCORR_GROSS_BAR} of the float64 scale"] = (
                max(f8["joint"]) < GCORR_GROSS_BAR)
        report[grav] = {
            "plan": {"levels": [[g_, cap, [list(b) for b in bk]] for g_, cap, bk in spec[0]],
                     "res_budget": spec[1], "mesh_level": spec[2],
                     "c_buckets": [list(b) for b in spec[3]], "host_s": plan_s,
                     "residual_rows": int((args.species == len(spec[0])).sum())},
            "certified": ok, "h_rows_differ_from_blocks": h_differ, "h_max_rel_err": h_rel,
            "vs_blocks_err_over_scale": worst, "tolerance": {"rtol": rtol, "atol_of_scale": atol},
            "eval_s_by_stage": ml_s, "block_eval_s_by_stage": blk_s,
            "gcorr_f32_vs_f64_over_scale": f8,
            "block_plan": {"buckets": [list(b) for b in bplan[0][0]]},
            "chunk": {"steps": driver.ML_SUBCHUNK, "certificate_by_eval": oks,
                      "fallbacks": int(out[5].sum()), "energy_drift": drift, "wall_s": chunk_s,
                      "launches": counts},
            "failed": [k for k, v in checks.items() if not v],
        }
        del red, red_b, g, g_b, out, bargs, tables, margs
        torch.cuda.empty_cache()

    def rms(v):
        return float(torch.sqrt(torch.mean(torch.sum(v * v, dim=1))))

    err = rms(g_ml["p3m"] - g_ml["exact"]) / rms(g_ml["exact"])
    if not err < 2e-3:
        report["p3m"]["failed"].append("P3M force error < 2e-3")
    report["p3m"]["g_err_rms_over_rms_g"] = err
    failed = report["exact"]["failed"] + report["p3m"]["failed"]
    say("mlevel", card=gpu_line, scene="bb_collapsed_deep.npz (contrast 1001) N=100000 Kh=50 "
        "polytropic float32", **report, failed=failed)
    if failed:
        raise AssertionError(f"mlevel checks failed: {failed}")
    k1 = {"launches": counts_by["mlevel_exact_chunk"]["phase_a_cells"],
          "max_abs_err": k1.pop("err"), "ms": k1.pop("ms"), "plain_ms": k1.pop("plain_ms"),
          **bound(k1.pop("flops"), k1.pop("bytes"), peak), **k1,
          "launches_path": "mlevel_exact_chunk"}
    return k1, counts_by


def phase_mlevel_ladder(tmp: str, gpu_line: str):
    """bb_collapsed_deep.npz written as a snapshot and run four steps
    through the CLI with plan_blocks made to decline: the run loop's ladder
    then plans the multi-level engine (exact gravity at this N) for every
    chunk; K1 once a bucket and K3 once an evaluation, counts set to 0 just
    before the run and read just after. Its fallbacks are reported."""
    from sphtpu_torch.engine import driver

    root = os.path.join(tmp, "mlevel_ladder")
    write_collapse_snapshot(root, COLLAPSE_DEEP)
    with patched(driver, "plan_blocks", lambda orig: (lambda *a, **kw: None)):
        res, counts, checks, drift = drive_cli(root, N_MAIN, generate=False)
    cfgs = res["configs"]
    n_fb = res["fallback_evals"]
    checks.pop("0 fallback evals")
    want = {name: 0 for name in MODULES}
    want.update(phase_a_cells=sum(2 * steps * sum(len(lv[2]) for lv in c.mlevel[0])
                                  for (steps, _, _), c in zip(res["chunk_walls"],
                                                              res["chunk_configs"])),
                newton_sweep=8 - n_fb)
    checks.update({
        "every chunk on the multi-level engine": set(res["chunk_engines"]) == {"mlevel"},
        "exact gravity": all(c.gravity == "exact" for c in cfgs),
        "kernel launches": counts == want,
    })
    failed = [k for k, v in checks.items() if not v]
    say("mlevel_ladder", card=gpu_line, plan_blocks="made to decline",
        scene=f"bb_collapsed_deep.npz (contrast 1001) polytropic N={N_MAIN} Kh={KH_COLLAPSE} "
        "float32", chunk_engines=res["chunk_engines"], steps=res["steps"],
        fallback_evals=n_fb, launches=counts, energy_drift=drift,
        specs=[[[lv[0], lv[1]] for lv in c.mlevel[0]] + [c.mlevel[1]] for c in cfgs],
        **walls_summary(res, N_MAIN), failed=failed)
    if failed:
        raise AssertionError(f"mlevel ladder checks failed: {failed}")
    return counts


# --------------------------------------------------------------------------
# the outlier lane (the mono-tile engine with an outlier budget) on the
# contrast-395 state
# --------------------------------------------------------------------------

K2_PLAIN_ROW_CHUNK = 64  # rows a piece of K2's plain version on the outlier path
K2_F64_ROWS = 2048  # rows of the outlier path's K2 inputs held in float64
OUTLIER_PLAN = (27, 160, 65536)  # (grid, cap, budget) the driver plans on bb_collapsed.npz


def collapse_state(path: str):
    """A committed collapse state on the card (float32) with h from a k = 50
    KD-tree (the run loop's bootstrap): (pos, stored h, KD-tree h as float64
    host arrays, state, params, KD-tree h on the card)."""
    from scipy.spatial import cKDTree

    from sphtpu_torch.engine import params_from_numpy

    d = np.load(path)
    pos_h = d["pos"].astype(np.float64)
    h_h = cKDTree(pos_h).query(pos_h, k=KH_COLLAPSE)[0][:, -1] / 2.0
    st = state_from_numpy(pos_h, d["vel"], d["K"], float(d["t"]), device=DEVICE)
    p = params_from_numpy(m=float(d["m"]), gamma=5 / 3, cs0=0.0, alpha=1.0, beta=2.0, U0=0.0,
                          t_end=1e30, device=DEVICE)
    return pos_h, d["h"].astype(np.float64), h_h, st, p, dev(h_h, torch.float32)


def outlier_plan(pos_h, h_h):
    """choose_tile_params_ml with the driver's arguments, and the outlier
    rows it routes: (grid, cap, budget, n_out)."""
    grid, cap, budget = tiles.choose_tile_params_ml(pos_h, h_h, KH_COLLAPSE, headroom=1.5,
                                                    budget_margin=2.0)
    half = float(np.abs(pos_h).max()) * (1 + 1e-6)
    n_out = int(np.sum(h_h * tiles.OUTLIER_CUT > 2.0 * half / grid))
    return grid, cap, budget, n_out


def outlier_eval(cfg, st, p, h, ghat, clock=None):
    """One evaluation of the mono-tile engine with its outlier lane, and its
    far field: (reduced forces, g, phi, ok); with a clock, each of the
    engine's profiling stages timed by it."""
    with contextlib.ExitStack() as es:
        if clock is not None:
            es.enter_context(patched(tiles, "stage", lambda orig: clock))
        red, gcorr, ok = tiles.tile_sph_forces(
            st.pos, st.vel, p.m, st.K, h, eos=cfg.eos, gamma=p.gamma, cs0=p.cs0,
            alpha=p.alpha, beta=p.beta, kh=cfg.kh, grid=cfg.tile[0], cap=cfg.tile[1],
            mesh_factor=cfg.mesh_factor if cfg.gravity == "p3m" else 0,
            sigma_cells=cfg.sigma_cells, outlier_budget=cfg.outlier_budget, device=DEVICE,
            **EVAL_REPAIRS,
        )
    with clock("gravity") if clock else contextlib.nullcontext():
        gfar, phifar = far_field(cfg, st, p, ghat)
    return red, gfar + torch.stack(gcorr[:3], 1), phifar + gcorr[3], bool(ok)


def k2_outlier_f64(args, kw, rows: int = K2_F64_ROWS):
    """K2 with the outlier masks in float64 against its plain version, on
    the `rows` cell rows of the launch's inputs holding the most outlier
    candidates (mask 2; two launches bit-identical)."""
    pick = torch.argsort((args[1][6] > 1).sum(1), descending=True, stable=True)[:rows]
    sub = lambda fields: tuple(f[pick].double().contiguous() for f in fields)  # noqa: E731
    a64 = (sub(args[0]), sub(args[1]), *args[2:])
    out_k = cuda_tile_pairs.phase_b_tiles(*a64, **kw)
    out_p = cuda_tile_pairs.phase_b_tiles_plain(*a64, **kw, row_chunk=16)
    worst, rtol, atol = check_phase_b(out_k, out_p, torch.float64)
    again = cuda_tile_pairs.phase_b_tiles(*a64, **kw)
    if not same_bits(out_k, again):
        raise AssertionError("phase_b_tiles with outlier masks: two float64 launches differ")
    return {"rows": int(pick.numel()), "outlier_candidates": int((a64[1][6] > 1).sum()),
            "max_err_over_scale": worst, "rtol": rtol, "atol_of_scale": atol,
            "runs_bit_identical": True}


def phase_outlier(gpu_line):
    """The outlier lane on bb_collapsed.npz (N = 100 000, contrast 395,
    Kh = 50, polytropic, float32), in both gravity modes: the plan of
    choose_tile_params_ml (driver arguments) from the stored h and from the
    k = 50 KD-tree h; one evaluation, which must certify, held against the
    block engine's on the same state (h within 1e-5 relative on every row;
    the hydro acceleration within 2e-5 of its scale, and under exact gravity
    g and phi too) with both split by stage; under P3M the force error
    against the exact evaluation (< 2e-3 of the RMS |g|); then a 2-step
    chunk from the state with the launch counts set to 0 just before and
    read just after, its certificate per evaluation and its energy drift.
    K2 with the outlier masks is held against its plain version on the exact
    evaluation's launch (float32 whole, float64 on K2_F64_ROWS rows).
    Returns (K2's numbers on this path, launch counts by chunk)."""
    from sphtpu_torch.engine import step as step_mod

    pos_h, h_stored, h_h, st, p, h = collapse_state(COLLAPSE)
    n = pos_h.shape[0]
    plans = {"stored_h": outlier_plan(pos_h, h_stored), "kdtree_h": outlier_plan(pos_h, h_h)}
    say("outlier_plan", card=gpu_line, scene=f"bb_collapsed.npz (contrast 395) N={n} "
        f"Kh={KH_COLLAPSE}", **{k: dict(zip(("grid", "cap", "budget", "n_out"), v))
                                for k, v in plans.items()})
    grid, cap, budget, n_out = plans["kdtree_h"]
    report, counts_by, g_out, k2 = {}, {}, {}, None
    for grav in ("exact", "p3m"):
        cfg = EngineConfig(n=n, kh=KH_COLLAPSE, eos="polytropic", dtype="float32",
                           tile=(grid, cap), outlier_budget=budget, gravity=grav)
        ghat = (greens_hat(cfg.mesh_pad, cfg.sigma_cells, torch.float32, DEVICE)
                if grav == "p3m" else None)
        calls = []

        def record(orig):
            def rec(*a, **kw):
                calls.append((a, kw))
                return orig(*a, **kw)
            return rec

        with patched(tiles, "phase_b_tiles", record):
            outlier_eval(cfg, st, p, h, ghat)  # warm-up, records K2's launch
        (red, g, phi, ok), out_s = timed_eval(
            lambda clock: outlier_eval(cfg, st, p, h, ghat, clock))
        g_out[grav] = g.double()

        bplan = blocks.plan_blocks(pos_h, h_h, KH_COLLAPSE, gravity=grav, **PLAN_REPAIRS)
        bcfg = EngineConfig(n=n, kh=KH_COLLAPSE, eos="polytropic", dtype="float32",
                            blocks=bplan[0], gravity=grav)
        bargs = blocks.block_args_to_device(bplan[1], torch.float32, DEVICE)
        tables = blocks.build_cand_tables(bargs, bplan[0], n)
        ghat_b = (greens_hat(bcfg.mesh_pad, bcfg.sigma_cells, torch.float32, DEVICE)
                  if grav == "p3m" else None)
        block_eval(bcfg, st, p, h, bargs, tables, ghat_b)
        (red_b, g_b, phi_b, ok_b), blk_s = timed_eval(
            lambda clock: block_eval(bcfg, st, p, h, bargs, tables, ghat_b, clock))

        h_rel = float(((red.h - red_b.h).abs() / red_b.h).max())
        pairs = [("acc_x", red.acc[:, 0], red_b.acc[:, 0]), ("acc_y", red.acc[:, 1], red_b.acc[:, 1]),
                 ("acc_z", red.acc[:, 2], red_b.acc[:, 2])]
        if grav == "exact":
            pairs += [("g_x", g[:, 0], g_b[:, 0]), ("g_y", g[:, 1], g_b[:, 1]),
                      ("g_z", g[:, 2], g_b[:, 2]), ("phi", phi, phi_b)]
        vs_blocks = {name: float((a - b).abs().max()) / float(b.abs().max())
                     for name, a, b in pairs}

        if grav == "exact":
            (a2, kw2), = calls
            k2 = k2_entry(calls, {"phase_b_tiles": 0}, torch.float32,
                          plain_row_chunk=K2_PLAIN_ROW_CHUNK)
            k2["float64"] = k2_outlier_f64(a2, kw2)
            k2["outlier_queries"] = int((a2[0][6] > 1).sum())
            del a2, kw2
        del calls

        # the 2-step chunk, every evaluation's certificate recorded
        oks = []

        def keep_ok(orig):
            def rec(*a, **kw):
                out = orig(*a, **kw)
                oks.append(bool(out[2]))
                return out
            return rec

        with patched(step_mod, "tile_sph_forces", keep_ok):
            reset_counts()
            t0 = time.time()
            out = make_chunk_runner(cfg, device=DEVICE, **CHUNK_REPAIRS)(st, p, h, 2)
            sync()
            chunk_s = time.time() - t0
        counts = {name: mod.launches for name, mod in MODULES.items()}
        counts_by[f"outlier_{grav}_chunk"] = counts
        e = out[1][:, 4].double().cpu().numpy()
        drift = float(np.abs(e - e[0]).max() / abs(e[0]))
        want = {name: 0 for name in MODULES}
        want.update(phase_a_tile=4, phase_b_tiles=4,
                    **({"newton_sweep": 4} if grav == "exact" else {"p3m_tail": 4}))
        checks = {
            "plans OUTLIER_PLAN": plans["kdtree_h"][:3] == OUTLIER_PLAN,
            "certified": ok, "block engine certifies": ok_b,
            "h within 1e-5 of the block engine's": h_rel <= 1e-5,
            "within 2e-5 of the block engine's scale": max(vs_blocks.values()) <= 2e-5,
            "chunk certified every evaluation": oks == [True] * 4,
            "chunk valid": bool(out[2].all()), "|dE/E| < 1e-2": drift < 1e-2,
            "kernel launches": counts == want,
        }
        report[grav] = {
            "certified": ok, "h_max_rel_err_vs_blocks": h_rel,
            "vs_blocks_err_over_scale": vs_blocks, "eval_s_by_stage": out_s,
            "block_eval_s_by_stage": blk_s,
            "chunk": {"steps": 2, "certificate_by_eval": oks, "fallbacks": int(out[5].sum()),
                      "energy_drift": drift, "wall_s": chunk_s, "launches": counts},
            "failed": [k for k, v in checks.items() if not v],
        }
        del red, red_b, g, g_b, out, bargs, tables
        torch.cuda.empty_cache()

    def rms(v):
        return float(torch.sqrt(torch.mean(torch.sum(v * v, dim=1))))

    err = rms(g_out["p3m"] - g_out["exact"]) / rms(g_out["exact"])
    if not err < 2e-3:
        report["p3m"]["failed"].append("P3M force error < 2e-3")
    report["p3m"]["g_err_rms_over_rms_g"] = err
    failed = report["exact"]["failed"] + report["p3m"]["failed"]
    say("outlier", card=gpu_line, scene=f"bb_collapsed.npz (contrast 395) N={n} Kh=50 "
        "polytropic float32", plan={"grid": grid, "cap": cap, "budget": budget, "n_out": n_out},
        **report, failed=failed)
    if failed:
        raise AssertionError(f"outlier checks failed: {failed}")
    k2["launches"] = counts_by["outlier_exact_chunk"]["phase_b_tiles"]
    k2["launches_path"] = "outlier_exact_chunk"
    return {k: v for k, v in k2.items() if k not in ("name", "route", "source", "replaces")}, \
        counts_by


def phase_outlier_ladder(tmp: str, gpu_line: str):
    """bb_collapsed.npz written as a snapshot and run four steps through
    the CLI with plan_blocks and plan_mlevel made to decline: the run loop's
    ladder then plans the outlier rung (exact gravity at this N) for every
    chunk: K4, K2 and K3 once an evaluation, counts set to 0 just before the
    run and read just after."""
    from sphtpu_torch.engine import driver

    root = os.path.join(tmp, "outlier_ladder")
    write_collapse_snapshot(root, COLLAPSE)
    decline = lambda orig: (lambda *a, **kw: None)  # noqa: E731
    with patched(driver, "plan_blocks", decline), patched(driver, "plan_mlevel", decline):
        res, counts, checks, drift = drive_cli(root, N_MAIN, generate=False)
    n_fb = res["fallback_evals"]
    checks.pop("0 fallback evals")
    want = {name: 0 for name in MODULES}
    want.update(phase_a_tile=8, phase_b_tiles=8, newton_sweep=8 - n_fb)
    checks.update({
        "every chunk on the outlier rung": set(res["chunk_engines"]) == {"outliers"},
        "exact gravity": all(c.gravity == "exact" for c in res["chunk_configs"]),
        "kernel launches": counts == want,
    })
    failed = [k for k, v in checks.items() if not v]
    say("outlier_ladder", card=gpu_line, plan_blocks="made to decline",
        plan_mlevel="made to decline",
        scene=f"bb_collapsed.npz (contrast 395) polytropic N={N_MAIN} Kh={KH_COLLAPSE} float32",
        chunk_engines=res["chunk_engines"], steps=res["steps"], fallback_evals=n_fb,
        launches=counts, energy_drift=drift,
        plans=[[*c.tile, c.outlier_budget] for c in res["chunk_configs"]],
        **walls_summary(res, N_MAIN), failed=failed)
    if failed:
        raise AssertionError(f"outlier ladder checks failed: {failed}")
    return counts


def phase_offpath(gpu_line):
    """The modules off the production path, on the card: dense_forces at
    N = N_DENSE (float32 against its float64 run, finite, momentum with the
    viscosity off) and knn_celllist on the headline scene (boss_bodenheimer
    N = 100 000, Kh = 50) against the port's knn: equal neighbour sets but
    for rows whose Kh-th distance ties, on the rows its two candidate passes
    certify (held before the call's all-or-nothing fallback, so that the
    Morton, searchsorted and topk path itself is checked) and on what the
    call returns (its certificate, or its fallback to the blocked sweep)."""
    from scipy.spatial import cKDTree

    from sphtpu_torch.neighbors import knn, knn_celllist
    from sphtpu_torch.neighbors.celllist import _celllist_rows
    from sphtpu_torch.physics.dense import dense_forces
    from sphtpu_torch.scenes.generators import boss_bodenheimer

    rng = np.random.default_rng(0)
    n_d = N_DENSE
    pos = rng.standard_normal((n_d, 3))
    vel = 0.2 * rng.standard_normal((n_d, 3))
    kw = dict(eos="polytropic", gamma=5 / 3, cs0=0.0, alpha=0.0, beta=0.0, kh=50, G=1.0)
    t0 = time.time()
    d32, phi32 = dense_forces(dev(pos, torch.float32), dev(vel, torch.float32), 1.0 / n_d,
                              torch.ones(n_d, device=DEVICE), **kw)
    sync()
    dense_s = time.time() - t0
    d64, _ = dense_forces(dev(pos, torch.float64), dev(vel, torch.float64), 1.0 / n_d,
                          torch.ones(n_d, device=DEVICE, dtype=torch.float64), **kw)
    acc_err = float((d32.acc.double() - d64.acc).abs().max() / d64.acc.abs().max())
    mom = float(d64.acc.sum(0).abs().max() / d64.acc.abs().max())
    del d32, d64, phi32
    torch.cuda.empty_cache()

    pos_h, _, _ = boss_bodenheimer(N_MAIN, 1.0, 1.0, rng=np.random.default_rng(1))
    h_h = cKDTree(pos_h).query(pos_h, k=50)[0][:, -1] / 2.0
    pos_c = dev(pos_h, torch.float32)
    sync()
    t0 = time.time()
    idx, info = knn_celllist(pos_c, 50, dev(h_h, torch.float32))
    sync()
    cl_s = time.time() - t0
    idx_k, d2_k = knn(pos_c, pos_c, 50)

    def differ(ix):
        """Rows whose neighbour set differs from knn's, and those of them
        whose Kh-th distance ties another candidate's."""
        other = (torch.sort(ix, 1).values != torch.sort(idx_k, 1).values).any(1)
        d2_c = ((pos_c[:, None, :] - pos_c[ix]) ** 2).sum(-1)
        return other, other & (d2_c.max(1).values == d2_k[:, -1])

    idx_f, row_cert, _, _ = _celllist_rows(pos_c, 50, dev(h_h, torch.float32), cap=128,
                                           cap_residual=512, g0_log2_max=9, safety=1.05,
                                           row_block=8192)
    other_f, ties_f = differ(idx_f)
    other, ties = differ(idx)
    rows_cert = int(row_cert.sum())
    cert_differ = int((other_f & row_cert).sum())
    rows_differ = int(other.sum())
    checks = {"dense finite": acc_err == acc_err, "dense float32 within 1e-4 of float64":
              acc_err < 1e-4, "dense momentum < 1e-10": mom < 1e-10,
              "celllist passes certify 99 % of the rows": rows_cert >= 0.99 * N_MAIN,
              "celllist certified rows differ only at ties":
              cert_differ == int((ties_f & row_cert).sum()),
              "celllist returned rows differ only at ties": rows_differ == int(ties.sum())}
    failed = [k for k, v in checks.items() if not v]
    say("offpath", card=gpu_line, dense={"n": n_d, "s": dense_s, "acc_f32_vs_f64": acc_err,
                                         "momentum_over_acc_scale": mom},
        celllist={"scene": f"boss_bodenheimer N={N_MAIN} Kh=50 float32", "s": cl_s,
                  "certified": bool(info.certified), "n_residual": int(info.n_residual),
                  "rows_certified_by_the_passes": rows_cert,
                  "certified_rows_differ_from_knn": cert_differ,
                  "certified_rows_at_ties": int((ties_f & row_cert).sum()),
                  "returned_rows_differ_from_knn": rows_differ,
                  "returned_rows_at_ties": int(ties.sum())},
        failed=failed)
    if failed:
        raise AssertionError(f"off-path checks failed: {failed}")


# --------------------------------------------------------------------------
# the multi-device layer: four shards of the one card
# --------------------------------------------------------------------------

SHARDS = 4  # shards of the sharded paths, all on cuda:0
# float32 bars of a sharded chunk or evaluation against the single-device
# one on the same state (the summation orders differ): positions over the
# position scale, stats over the largest stat, h and rho relative, forces
# over the largest force
SHARD_POS_TOL, SHARD_STATS_TOL, SHARD_ROW_TOL, SHARD_ACC_TOL = 1e-5, 1e-4, 1e-5, 1e-4


def shard_mesh():
    return [torch.device(DEVICE, 0)] * SHARDS


def drive_sharded(root: str, n: int, generate: bool = True):
    """boss_bodenheimer at N = n, Kh = 50 (generated unless snapshot 1 is
    written) run four steps through run_simulation over SHARDS shards of
    the card, launch counts set to 0 just before the run and read just
    after: (summary, counts, checks, energy drift)."""
    from sphtpu_torch.engine.driver import run_simulation

    common = ["--EOS", "polytropic", "--ic_type", "boss_bodenheimer", "--root", root]
    if generate and cli.main(["--generate", *common, "--kwargs", f"N={n},Kh=50"]) != 0:
        raise AssertionError("--generate failed")
    reset_counts()
    res = run_simulation(
        "polytropic", "boss_bodenheimer", snap_id=1, snap_interval=2, keep_snaps=True,
        show_plots=False, root=root, n_devices=SHARDS, devices=shard_mesh(), max_steps=4,
        verbose=False,
    )
    sync()
    counts = {name: mod.launches for name, mod in MODULES.items()}
    checks, drift = run_checks(root, res, n)
    checks.update({
        "sharded chunks >= 1": res["sharded_chunks"] >= 1,
        "0 single-device chunks": res["single_chunks"] == 0,
        "0 failed certificates": res["shard_replans"] == 0,
    })
    return res, counts, checks, drift


def slab_counts_want(p3m: bool, evals: int = 8) -> dict:
    """Launches of `evals` slab evaluations over SHARDS shards: K4 and K2
    once a shard; under P3M the tail once a shard, else K3's rows x columns
    entry once a shard and ring round."""
    want = {name: 0 for name in MODULES}
    want.update(phase_a_tile=evals * SHARDS, phase_b_tiles=evals * SHARDS)
    if p3m:
        want["p3m_tail"] = evals * SHARDS
    else:
        want["newton_rows_cols"] = evals * SHARDS * SHARDS
    return want


def host64(t):
    return t.detach().double().cpu().numpy()


def chunk_errors(pos, stats, h, pos_r, stats_r, h_r):
    """(pos error over the position scale, stats error over the largest
    stat, largest relative h error) of a chunk against a reference chunk."""
    scale = np.abs(pos_r).max()
    return (float(np.abs(pos - pos_r).max() / scale),
            float(np.abs(stats - stats_r).max() / (np.abs(stats_r).max() + 1e-30)),
            float((np.abs(h - h_r) / np.abs(h_r)).max()))


def timed(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def phase_shard_slabs(tmp: str, gpu_line: str, p3m: bool):
    """The headline scene (N = 1e5, exact gravity) or the P3M scene (N =
    2e5, gravity "auto") through run_simulation over SHARDS shards of the
    card: the z-slab tile engine (K4, K2 on every shard; K3's rows x
    columns entry in the ring, or the tail kernel under P3M). Then one
    2-step slab chunk of the run's final state against the single-device
    mono-tile chunk on the same state and the same (grid, cap), both timed
    here (both with the run loop's repairs); and one evaluation whose
    K4, K2 and tail launches are held against their plain versions
    (`slab_kernel_checks`; under P3M they must be K2's joint and the
    tail's skip launches) and whose ring's K3 launches are captured for
    the kernels line; under P3M the float32 gravity corrections against
    float64 (`slab_gcorr`: two sweeps and joint). Returns (the run's
    launch counts, the ring's K3 calls, the slab kernels' report, the final
    state as a `final_scene`)."""
    from sphtpu_torch.shard import tiles as shard_tiles
    from sphtpu_torch.shard.collectives import particle_mesh, run_spmd
    from sphtpu_torch.shard.step import replicate

    n = N_P3M if p3m else N_MAIN
    name = "slab_p3m_n2e5_x4" if p3m else "slab_exact_n1e5_x4"
    res, counts, checks, drift = drive_sharded(os.path.join(tmp, name), n)
    grav = "p3m" if p3m else "exact"
    checks["every chunk on slabs"] = set(res["chunk_engines"]) == {"slabs"}
    checks["kernel launches"] = counts == slab_counts_want(p3m)

    st, p = res["state"], res["params"]
    pos_h, h_h = host64(st.pos), host64(res["h_last"])
    plan = shard_tiles.plan_slabs(pos_h, h_h, 50, SHARDS, chunk_steps=2)
    if plan is None:
        raise AssertionError(f"{name}: no slab plan on the final state")
    cfg = EngineConfig(n=n, kh=50, eos="polytropic", tile=(plan.grid, plan.cap), gravity=grav)
    mesh = particle_mesh(shard_mesh())
    slab_run = shard_tiles.make_slab_chunk_runner(cfg, plan, mesh, **EVAL_REPAIRS)
    mono_run = make_chunk_runner(cfg, device=DEVICE, **CHUNK_REPAIRS)
    slab_run(shard_tiles.pack_state(st, plan, mesh), p, 1)  # warm-up of both
    mono_run(st, p, res["h_last"], 1)
    (sl2, stats_s, valid_s, cert_s, h_rows, _), t_slab = timed(
        lambda: slab_run(shard_tiles.pack_state(st, plan, mesh), p, 2))
    (st_m, stats_m, valid_m, h_m, _, nfb_m), t_mono = timed(
        lambda: mono_run(st, p, res["h_last"], 2))
    pos_s = host64(shard_tiles.unpack_state(sl2, plan, n).pos)
    h_s = shard_tiles.unpack_rows(np.concatenate([host64(x) for x in h_rows]), plan, n)
    errs = chunk_errors(pos_s, host64(stats_s), h_s, host64(st_m.pos), host64(stats_m),
                        host64(h_m))
    checks.update({
        "slab chunk certified": bool(valid_s.all()) and not bool(cert_s.any()),
        "single-device chunk certified": bool(valid_m.all()) and int(nfb_m.sum()) == 0,
        "pos vs single device": errs[0] <= SHARD_POS_TOL,
        "stats vs single device": errs[1] <= SHARD_STATS_TOL,
        "h vs single device": errs[2] <= SHARD_ROW_TOL,
    })

    # one evaluation of the final state split by stage (the card synchronised
    # at each stage's ends), recording its launches of K4, K2, the tail and
    # the ring's K3 rows x columns entry
    caught = {name: [] for name in SLAB_KERNELS}

    def rec(name):
        def wrap(orig):
            def run(*a, **kw):
                caught[name].append((a, kw))
                return orig(*a, **kw)
            return run
        return wrap

    ev = shard_tiles.make_slab_force_eval(cfg, plan, **EVAL_REPAIRS)
    ghat = (greens_hat(cfg.mesh_pad, cfg.sigma_cells, torch.float32, DEVICE) if p3m else None)
    packed = shard_tiles.pack_state(st, plan, mesh)
    ps = replicate(p, mesh)
    ghats = [None if ghat is None else ghat.to(d) for d in mesh]
    with contextlib.ExitStack() as patches:
        for kname in SLAB_KERNELS:
            patches.enter_context(patched(shard_tiles, kname, rec(kname)))
        out, stage_s = timed_eval(lambda clock: _with_stage(shard_tiles, clock, lambda: run_spmd(
            [ev(ps[k], k, s.pos, s.vel, s.K, s.valid, ghats[k])
             for k, s in enumerate(packed)])))
    checks["captured evaluation certified"] = all(bool(o[2]) for o in out)
    del out
    f8 = None
    if p3m:
        # the launches held against their plain versions are the run loop's:
        # K2's joint mode and the tail's skip mode (ROADMAP D21)
        checks["K2 joint and tail skip launches"] = (
            all(kw.get("joint") for _, kw in caught["phase_b_tiles"])
            and all(kw.get("skip_joint") for _, kw in caught["p3m_tail"]))
        # the float32 gravity corrections against float64 (the two sweeps,
        # as the reference adds them)
        gc64 = slab_gcorr(cfg, plan, mesh, *as_float64(st, p), False)
        f8 = {label: over_scale(slab_gcorr(cfg, plan, mesh, st, p, joint), gc64)
              for label, joint in (("two_sweeps", False), ("joint", True))}
        del gc64
        checks[f"joint gcorr within {GCORR_GROSS_BAR} of the float64 scale"] = (
            max(f8["joint"]) < GCORR_GROSS_BAR)
    calls = caught.pop("newton_rows_cols")
    slab_kernels = slab_kernel_checks(caught)
    checks["the slab's K4, K2 (and tail) launches held against their plain versions"] = (
        all(v["launches_checked"] == SHARDS for v in slab_kernels.values())
        and set(slab_kernels) == ({"phase_a_tile", "phase_b_tiles", "p3m_tail"} if p3m
                                  else {"phase_a_tile", "phase_b_tiles"}))
    del caught
    failed = [k for k, v in checks.items() if not v]
    walls = walls_summary(res, n)
    say(name, card=gpu_line, shards=SHARDS, devices=[str(d) for d in mesh],
        scene=f"boss_bodenheimer polytropic N={n} Kh=50 float32 gravity={grav}",
        plan_of_run=[{"grid": c.tile[0], "cap": c.tile[1]} for c in res["configs"]],
        plan_final_state={"grid": plan.grid, "cap": plan.cap, "lz_max": plan.lz_max,
                          "halo": plan.halo, "hops": plan.hops, "budget": plan.budget,
                          "n_loc": plan.n_loc, "z0s": [int(z) for z in plan.z0s],
                          "real_rows": shard_tiles.real_rows(plan)},
        steps=res["steps"], fallback_evals=res["fallback_evals"],
        sharded_chunks=res["sharded_chunks"], single_chunks=res["single_chunks"],
        shard_replans=res["shard_replans"], chunk_engines=res["chunk_engines"],
        launches=counts, energy_drift=drift, **walls,
        chunk_2_steps_s={"slabs_x4": t_slab, "single_device": t_mono,
                         "s_per_step_slabs_x4": t_slab / 2, "s_per_step_single": t_mono / 2},
        errors_vs_single={"pos_over_scale": errs[0], "stats_over_max": errs[1],
                          "h_rel": errs[2]},
        eval_seconds_by_stage=stage_s, slab_kernels_vs_plain=slab_kernels,
        gcorr_f32_vs_f64_over_scale=f8,
        tolerances=[SHARD_POS_TOL, SHARD_STATS_TOL, SHARD_ROW_TOL],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        snapshot_ids=res["snapshot_ids"], runtime_s=res["runtime_s"], failed=failed)
    if failed:
        raise AssertionError(f"{name} checks failed: {failed}")
    return counts, calls, slab_kernels, final_scene(res)


def slab_gcorr(cfg, plan, mesh, st, p, joint):
    """One P3M slab evaluation of the state (its dtype) with joint_gravity
    `joint` and the far field left out (the mesh solve runs, its result is
    dropped): the near-field gravity corrections (gx, gy, gz, phi) as
    global rows, on the card."""
    from sphtpu_torch.shard import tiles as shard_tiles
    from sphtpu_torch.shard.collectives import run_spmd
    from sphtpu_torch.shard.step import replicate

    def near_only(orig):
        def far(*a, **kw):
            g, phi = yield from orig(*a, **kw)
            return torch.zeros_like(g), torch.zeros_like(phi)
        return far

    ev = shard_tiles.make_slab_force_eval(cfg, plan, joint_gravity=joint)
    ghat = greens_hat(cfg.mesh_pad, cfg.sigma_cells, st.pos.dtype, DEVICE)
    ps = replicate(p, mesh)
    with patched(shard_tiles, "_p3m_mesh_sharded", near_only):
        out = run_spmd([ev(ps[k], k, s.pos, s.vel, s.K, s.valid, ghat.to(d))
                        for k, (s, d) in enumerate(zip(shard_tiles.pack_state(st, plan, mesh),
                                                       mesh))])
    if not all(bool(o[2]) for o in out):
        raise AssertionError("a slab evaluation for the gravity corrections did not certify")
    rows = torch.cat([torch.cat([o[1]["g"], o[1]["phi"][:, None]], 1).double().cpu()
                      for o in out])
    g = torch.from_numpy(shard_tiles.unpack_rows(rows.numpy(), plan, st.pos.shape[0]))
    return [g[:, c] for c in range(4)]


def final_scene(res):
    """A run's final state, its h and its parameters as host float64 (numpy
    and floats): the input of phase_multihost_slabs."""
    st, p = res["state"], res["params"]
    return dict(pos=host64(st.pos), vel=host64(st.vel), K=host64(st.K), h=host64(res["h_last"]),
                t=float(st.t), **{k: float(getattr(p, k)) for k in PARAM_KEYS})


PARAM_KEYS = ("m", "gamma", "cs0", "alpha", "beta", "U0", "t_end")


SLAB_KERNELS = ("phase_a_tile", "phase_b_tiles", "p3m_tail", "newton_rows_cols")


def slab_kernel_checks(caught):
    """A slab evaluation's K4, K2 and tail launches (one a shard, at the
    slab's shapes: n_cells = qz * grid^2 query cell rows, the tail over nz
    = qz layers) against their plain versions: every shard's launch as the
    run made it (float32) and shard 0's cast to float64, with
    check_phase_a's and check_phase_b's bars; two launches on the same
    inputs give the same bits. Returns, per kernel: the launches checked,
    the largest error (absolute, and over its output's scale for K2 and
    the tail), K4's tie rows, and ms and plain ms summed over the shards'
    float32 launches. Raises on a failed check."""
    report = {}
    for name, calls in caught.items():
        if not calls:
            continue
        d = report.setdefault(name, dict(launches_checked=0, max_abs_err=0.0,
                                         max_err_over_scale=0.0, tie_rows=0, ms=0.0,
                                         plain_ms=0.0, n_cells=[], float64_max_abs_err=0.0))
        for k, (args, kw) in enumerate(calls):
            for dtype in (torch.float32, torch.float64) if k == 0 else (torch.float32,):
                a = args if dtype == torch.float32 else cast_args(args, dtype)
                if name == "phase_a_tile":
                    fn, plain = cuda_knn.phase_a_tile, cuda_knn.phase_a_tile_plain
                elif name == "phase_b_tiles":
                    fn, plain = cuda_tile_pairs.phase_b_tiles, cuda_tile_pairs.phase_b_tiles_plain
                else:
                    fn, plain = cuda_p3m_tail.p3m_tail, cuda_p3m_tail.p3m_tail_plain
                out_k = fn(*a, **kw)
                if not same_bits(out_k, fn(*a, **kw)):
                    raise AssertionError(f"{name} (slab shard {k}, {dtype}): two launches differ")
                out_p, plain_s = timed(lambda: plain(*a, **kw))
                if name == "phase_a_tile":
                    cands, s2, cap = a[0], a[1], kw["cap"]
                    queries = tuple(c[:, 13 * cap : 14 * cap] for c in cands)
                    reach2 = torch.as_tensor(s2, dtype=dtype, device=cands[0].device).expand(
                        cands[0].shape[0], cap)
                    err, ties = check_phase_a(*out_k, *out_p, queries, reach2, cands,
                                              2e-5 if dtype == torch.float32 else 1e-12)
                    d["tie_rows"] += ties
                    rel = 0.0
                else:
                    rel = check_phase_b(out_k, out_p, dtype, **(
                        {} if name == "phase_b_tiles"
                        else dict(names=TAIL_OUTPUTS, kernel="p3m_tail")))[0]
                    err = max(float((x - y).abs().max()) for x, y in zip(out_k, out_p))
                if dtype == torch.float64:
                    d["float64_max_abs_err"] = max(d["float64_max_abs_err"], err)
                    continue
                d["launches_checked"] += 1
                d["max_abs_err"] = max(d["max_abs_err"], err)
                d["max_err_over_scale"] = max(d["max_err_over_scale"], rel)
                d["plain_ms"] += plain_s * 1e3
                d["ms"] += time_ms(lambda: fn(*a, **kw))
                d["n_cells"].append(int(a[1][0].shape[0] if name == "phase_b_tiles"
                                        else a[0][0].shape[0] if name == "phase_a_tile"
                                        else kw.get("nz") * kw["grid"] ** 2))
                del out_k, out_p
        d["nz"] = [kw.get("nz") for _, kw in calls] if name == "p3m_tail" else None
        d["runs_bit_identical"] = True
    return report


def _with_stage(module, clock, fn):
    """fn() with module.stage timed by clock."""
    with patched(module, "stage", lambda orig: clock):
        return fn()


def rc_cases(calls, row_sharded):
    """The rows x columns launches to hold against the plain version: the
    ring's captured calls, and the work-sharded row split of a state
    (`row_sharded`: (pos, m); 1/SHARDS of the rows against all N)."""
    from sphtpu_torch.shard.mlevel import _ceil_to

    cases = [("ring", a, kw) for a, kw in calls]
    pos, m = row_sharded
    n = pos.shape[0]
    per = _ceil_to(n, 8 * SHARDS) // SHARDS
    for k in range(SHARDS):
        r0, r1 = min(k * per, n), min((k + 1) * per, n)
        cases.append(("row_sharded", (pos[r0:r1], pos, None, m), {}))
    return cases


def rc_entry(calls, row_sharded, counts):
    """K3's rows x columns entry against its plain version on the ring's and
    the row-sharded inputs, in float32 (g within 2e-4 of the largest |g|,
    phi relative 2e-4, K3's bars) and float64 (1e-10), with two launches
    bit-identical. The entry's time is the ring's launches of one
    evaluation (CUDA events around each wrapper, summed) beside the plain
    version's and the bound: n_rows x n_cols x 20 operations at 67 TFLOP/s,
    or the bytes (rows and g, phi: 7 values a row; columns and weights: 4 a
    column), whichever is larger."""
    err = 0.0
    by_kind = {}
    for kind, args, kw in rc_cases(calls, row_sharded):
        for dtype in (torch.float32, torch.float64):
            a = tuple(x.to(dtype) if isinstance(x, torch.Tensor) else x for x in args)
            g_k, p_k = cuda_gravity_rc.newton_rows_cols(*a, **kw)
            g_k2, p_k2 = cuda_gravity_rc.newton_rows_cols(*a, **kw)
            sync()
            g_p, p_p = cuda_gravity_rc.newton_rows_cols_plain(*a, **kw)
            rtol = 2e-4 if dtype == torch.float32 else 1e-10
            g_err = float((g_k - g_p).abs().max())
            live = p_p != 0
            p_err = float(((p_k - p_p).abs()[live] / p_p.abs()[live]).max()) if live.any() else 0.0
            if g_err > rtol * float(g_p.abs().max()) or p_err > rtol:
                raise AssertionError(f"newton_rows_cols {kind} {dtype}: g {g_err}, phi {p_err}")
            if not (torch.equal(g_k, g_k2) and torch.equal(p_k, p_k2)):
                raise AssertionError("newton_rows_cols: two launches on the same input differ")
            if dtype == torch.float32:
                err = max(err, g_err, float((p_k - p_p).abs().max()))
        nr = kw.get("n_rows") or args[0].shape[0]
        nc = kw.get("n_cols") or args[1].shape[0]
        d = by_kind.setdefault(kind, dict(launches=0, pairs=0.0, bytes=0.0, ms=0.0,
                                          plain_ms=0.0, plans=[]))
        d["launches"] += 1
        d["pairs"] += float(nr) * nc
        d["bytes"] += (7.0 * nr + 4.0 * nc) * 4
        d["ms"] += time_ms(lambda: cuda_gravity_rc.newton_rows_cols(*args, **kw))
        d["plain_ms"] += time_ms(lambda: cuda_gravity_rc.newton_rows_cols_plain(*args, **kw),
                                 iters=1, warmup=0)
        d["plans"].append(list(cuda_gravity_rc.split_plan(
            nr, nc, build.device_limits(DEVICE)[0], torch.float32)))
    peak = PEAK_FLOPS[torch.float32]
    for v in by_kind.values():
        v.update(bound(v["pairs"] * K3_FLOPS_PER_PAIR, v["bytes"], peak))
    ring = by_kind["ring"]
    return kernel_entry(
        "newton_rows_cols", counts, err, ring["ms"], ring["plain_ms"],
        ring["pairs"] * K3_FLOPS_PER_PAIR, ring["bytes"], peak,
        inputs="the ring's launches of one evaluation of the headline scene's final state "
               "over 4 shards (n_rows x n_cols: the shards' real rows)",
        runs_bit_identical=True, rtol_of_max={"float32": 2e-4, "float64": 1e-10},
        by_input=by_kind)


def phase_shard_work(tmp: str, gpu_line: str):
    """bb_collapsed.npz through run_simulation over SHARDS shards of the
    card: no slab plan certifies, so the work-sharded block engine carries
    every chunk (K1 once a bucket and shard, K5 once a shard, K3's rows x
    columns entry once a shard, an evaluation). One evaluation of the final
    state work-sharded against the single-device block engine; then one
    bb_collapsed_deep.npz evaluation on the work-sharded multi-level engine
    against the single-device one. Returns (counts of the run, the
    row-sharded K3 inputs, the counts of the multi-level evaluation)."""
    from sphtpu_torch.shard.collectives import run_spmd
    from sphtpu_torch.shard.mlevel import _newton_rows_sharded

    root = os.path.join(tmp, "shard_work")
    write_collapse_snapshot(root, COLLAPSE)
    res, counts, checks, drift = drive_sharded(root, N_MAIN, generate=False)
    cfgs = res["chunk_configs"]
    n_buckets = len(cfgs[0].blocks[0]) if cfgs and cfgs[0].blocks is not None else 0
    want = {name: 0 for name in MODULES}
    want.update(phase_a_cells=8 * n_buckets * SHARDS, phase_b_grouped=8 * SHARDS,
                newton_rows_cols=8 * SHARDS)
    checks.update({
        "every chunk on the work-sharded block engine":
            set(res["chunk_engines"]) == {"blocks_sharded"},
        "exact gravity": all(c.gravity == "exact" for c in cfgs),
        "kernel launches": counts == want,
    })

    st, p = res["state"], res["params"]
    pos_h, h_h = host64(st.pos), host64(res["h_last"])
    n = pos_h.shape[0]

    def compare(engine, plan_fn, body, single, st, p, h, pos_h, h_h):
        planned = plan_fn(pos_h, h_h, KH_COLLAPSE, gravity="exact", shards=SHARDS)
        if planned is None:
            raise AssertionError(f"{engine}: no plan on the state")
        spec, args = planned
        cfg = EngineConfig(n=n, kh=KH_COLLAPSE, eos="polytropic", gravity="exact",
                           **{engine: spec})
        dev_args = (blocks.block_args_to_device(args, torch.float32, DEVICE)
                    if engine == "blocks" else mlevel.mlevel_args_to_device(args, DEVICE))
        kw = dict(eos=cfg.eos, gamma=p.gamma, cs0=p.cs0, alpha=p.alpha, beta=p.beta,
                  kh=cfg.kh, spec=spec, mesh_factor=cfg.mesh_factor, sigma_cells=cfg.sigma_cells)
        if engine == "blocks":
            kw["gravity"] = "exact"
        (red1, gc1, ok1), t1 = timed(lambda: single(st.pos, st.vel, p.m, st.K, h, dev_args, **kw))
        reset_counts()
        outs, t4 = timed(lambda: run_spmd([
            body(st.pos, st.vel, p.m, st.K, h, dev_args, shard=k, n_shards=SHARDS, **kw)
            for k in range(SHARDS)]))
        sync()
        ev_counts = {name: mod.launches for name, mod in MODULES.items()}
        red4, gc4, ok4 = outs[0]
        acc1 = red1.acc - torch.stack(gc1[:3], 1)
        acc4 = red4.acc - torch.stack(gc4[:3], 1)
        errs = {
            "acc_over_max": float((acc4 - acc1).abs().max() / acc1.abs().max()),
            "h_rel": float(((red4.h - red1.h).abs() / red1.h).max()),
            "rho_rel": float(((red4.rho - red1.rho).abs() / red1.rho).max()),
        }
        ok = (bool(ok1) and all(bool(o[2]) for o in outs)
              and errs["acc_over_max"] <= SHARD_ACC_TOL and errs["h_rel"] <= SHARD_ROW_TOL
              and errs["rho_rel"] <= SHARD_ROW_TOL)
        return ok, dict(errors=errs, seconds_single=t1, seconds_x4=t4, launches=ev_counts,
                        plan=[list(b) for b in spec[0]] if engine == "blocks"
                        else [[g, c, [list(b) for b in bk]] for g, c, bk in spec[0]])

    ok_b, blk = compare("blocks", blocks.plan_blocks, blocks.block_forces_body,
                        blocks.block_sph_forces, st, p, res["h_last"], pos_h, h_h)
    checks["block evaluation vs single device"] = ok_b
    # the far field of the work-sharded engines against K3's whole sweep
    g4 = run_spmd([_newton_rows_sharded(st.pos, p.m, k, SHARDS) for k in range(SHARDS)])[0][0]
    g1, _ = cuda_gravity.newton_sweep(st.pos, p.m)
    g_err = float((g4 - g1).abs().max() / g1.abs().max())
    checks["row-sharded far field vs K3"] = g_err <= 2e-4

    pos_d, h_d, st_d, p_d, h_dev = deep_state()
    ok_m, ml = compare("mlevel", mlevel.plan_mlevel, mlevel.mlevel_forces_body,
                       mlevel.mlevel_sph_forces, st_d, p_d, h_dev, pos_d, h_d)
    checks["multi-level evaluation vs single device"] = ok_m
    failed = [k for k, v in checks.items() if not v]
    say("shard_work", card=gpu_line, shards=SHARDS,
        scene=f"bb_collapsed.npz (contrast 395) polytropic N={N_MAIN} Kh={KH_COLLAPSE} float32",
        slab_plan_declines=True, steps=res["steps"], fallback_evals=res["fallback_evals"],
        sharded_chunks=res["sharded_chunks"], single_chunks=res["single_chunks"],
        shard_replans=res["shard_replans"], chunk_engines=res["chunk_engines"],
        buckets=[list(b) for b in cfgs[0].blocks[0]] if n_buckets else None,
        launches=counts, energy_drift=drift, **walls_summary(res, N_MAIN),
        block_eval_vs_single=blk, far_field_rel_err_vs_k3=g_err,
        mlevel_deep_eval_vs_single=ml,
        tolerances={"acc": SHARD_ACC_TOL, "h_rho": SHARD_ROW_TOL, "far_field": 2e-4},
        snapshot_ids=res["snapshot_ids"], runtime_s=res["runtime_s"], failed=failed)
    if failed:
        raise AssertionError(f"shard_work checks failed: {failed}")
    return counts, (st.pos, p.m), ml["launches"], res


# --------------------------------------------------------------------------
# the multi-process layer: two gloo ranks, two shards each, on cuda:0
# --------------------------------------------------------------------------

MH_RANKS, MH_SHARDS = 2, 2  # ranks, shards a rank: four shards of the card in all
MH_LIMIT_S = 300.0  # hard limit of a phase's ranks, rendezvous and collectives included
# module settings a rank takes from the parent (a rehearsal on the CPU changes them)
MH_SETTINGS = ("DEVICE", "N_MAIN", "COLLAPSE", "sync", "time_ms")


def mh_spawn(name: str, out: str, backend: str = "gloo", *args):
    """Run phase `name`'s rank function in MH_RANKS processes (start method
    "spawn"; the kernels are already built, the ranks load them), each in a
    process group over a file rendezvous in `out`. Waits at most MH_LIMIT_S
    for all of them, kills any still running, and raises if one failed.
    Returns the ranks' results in rank order."""
    ctx = torch.multiprocessing.get_context("spawn")
    settings = {k: globals()[k] for k in MH_SETTINGS}
    procs = [ctx.Process(target=_mh_rank, args=(name, r, out, backend, settings, args))
             for r in range(MH_RANKS)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + MH_LIMIT_S
    try:
        for proc in procs:
            proc.join(max(deadline - time.monotonic(), 0.1))
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    codes = [proc.exitcode for proc in procs]
    if any(c != 0 for c in codes):
        raise AssertionError(f"{name}: rank exit codes {codes} (None or -9: killed at the limit)")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(MH_RANKS)]


def _mh_rank(name, rank, out, backend, settings, args):
    from sphtpu_torch.shard import multihost as mh

    globals().update(settings)
    mh.initialize(init_method=f"file://{out}/rdv", num_processes=MH_RANKS, process_id=rank,
                  backend=backend, timeout_s=MH_LIMIT_S)
    try:
        if DEVICE == "cuda":
            build.load_kernels()  # built by the parent: loaded, not compiled
        res = MH_PHASES[name](rank, out, *args)
    finally:
        mh.shutdown()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def tree_listing(root: str):
    return sorted((os.path.relpath(os.path.join(d, f), root), os.path.getsize(os.path.join(d, f)),
                   os.path.getmtime(os.path.join(d, f)))
                  for d, _, fs in os.walk(root) for f in fs)


def _mh_work_rank(rank, out, roots, devs):
    """A rank of `multihost_work`: run_simulation(multihost=True) four steps
    on its own copy of the collapse snapshot (roots[rank]) over its shards
    (devs[rank]), its launch counts set to 0 just before the run and read
    just after."""
    from sphtpu_torch.engine.driver import run_simulation

    root, devices = roots[rank], devs[rank]
    before = tree_listing(root)
    reset_counts()
    reset_exchanges()
    res = run_simulation(
        "polytropic", "boss_bodenheimer", snap_id=1, snap_interval=2, keep_snaps=True,
        show_plots=False, root=root, multihost=True, devices=devices, max_steps=4,
        verbose=False,
    )
    sync()
    counts = {name: mod.launches for name, mod in MODULES.items()}
    st = res["state"]
    return dict(
        primary=res["primary"], n_devices=res["n_devices"], steps=res["steps"],
        fallback_evals=res["fallback_evals"], sharded_chunks=res["sharded_chunks"],
        single_chunks=res["single_chunks"], shard_replans=res["shard_replans"],
        chunk_engines=res["chunk_engines"], snapshot_ids=res["snapshot_ids"],
        buckets=[list(b) for b in res["chunk_configs"][0].blocks[0]]
        if res["chunk_configs"] and res["chunk_configs"][0].blocks is not None else None,
        pos=host64(st.pos), vel=host64(st.vel), K=host64(st.K),
        last_stats=res["last_stats_cgs"], counts=counts, walls=walls_summary(res, N_MAIN),
        runtime_s=res["runtime_s"], tree_before=before, tree_after=tree_listing(root),
        devices=[str(d) for d in devices], exchanges=read_exchanges(),
    )


def reset_exchanges() -> None:
    from sphtpu_torch.shard import dist

    dist.exchanges, dist.exchange_bytes, dist.exchange_s = 0, 0, 0.0


def read_exchanges() -> dict:
    """This rank's requests since reset_exchanges, their payload bytes sent
    and their wall seconds (packing, the two all-gathers through the host,
    waiting for the other ranks included, the copy back to the card)."""
    from sphtpu_torch.shard import dist

    return {"requests": dist.exchanges, "bytes_sent": dist.exchange_bytes,
            "seconds": dist.exchange_s}


def mh_rel(a, b, scale=None):
    """Largest |a - b| over the scale (default: max |b|)."""
    s = np.abs(b).max() if scale is None else scale
    return float(np.abs(a - b).max() / (s + 1e-30))


def phase_multihost_work(tmp: str, gpu_line: str, one, backend: str = "gloo"):
    """bb_collapsed.npz through run_simulation(multihost=True) over MH_RANKS
    ranks x MH_SHARDS shards (four shards in all), four steps with a snapshot
    every 2: the work-sharded block engine (K1, K5, K3's rows x columns entry)
    in every chunk. Each rank runs on its own copy of the snapshot tree.
    Held against `one`, the one-process four-shard run of phase_shard_work
    from the same snapshot: the ranks' states identical, equal to it bit for
    bit or within SHARD_POS_TOL; rank 0 wrote the snapshots and the stats,
    rank 1 no file. With "nccl" each rank runs on its own card. Returns the
    ranks' launch counts."""
    name = "multihost_work" if backend == "gloo" else "multihost_work_nccl"
    out = os.path.join(tmp, name)
    roots = [os.path.join(out, f"rank{r}") for r in range(MH_RANKS)]
    for root in roots:
        write_collapse_snapshot(root, COLLAPSE)
    devs = [[f"{DEVICE}:{r if backend == 'nccl' else 0}"] * MH_SHARDS for r in range(MH_RANKS)]
    ranks = mh_spawn("work", out, backend, roots, devs)
    r0, r1 = ranks
    n_buckets = len(r0["buckets"]) if r0["buckets"] else 0
    want = {name_: 0 for name_ in MODULES}
    want.update(phase_a_cells=8 * n_buckets * MH_SHARDS, phase_b_grouped=8 * MH_SHARDS,
                newton_rows_cols=8 * MH_SHARDS)
    pos1, stats1 = host64(one["state"].pos), np.asarray(one["last_stats_cgs"])
    errs = {
        "pos_over_scale": mh_rel(r0["pos"], pos1),
        "vel_over_scale": mh_rel(r0["vel"], host64(one["state"].vel)),
        "K_rel": float((np.abs(r0["K"] - host64(one["state"].K)) / np.abs(host64(one["state"].K))).max()),
        "last_stats_over_max": mh_rel(r0["last_stats"], stats1),
    }
    bit_equal = all(v == 0.0 for v in errs.values())
    names0 = {f for f, _, _ in r0["tree_after"]}
    checks = {
        "rank 0 primary, rank 1 not": r0["primary"] and not r1["primary"],
        "4 shards": r0["n_devices"] == r1["n_devices"] == MH_RANKS * MH_SHARDS,
        "4 steps, 0 fallback evals": all(r["steps"] == 4 and r["fallback_evals"] == 0
                                         for r in ranks),
        "every chunk on the work-sharded block engine": all(
            set(r["chunk_engines"]) == {"blocks_sharded"} for r in ranks),
        "0 failed certificates, 0 single-device chunks": all(
            r["shard_replans"] == 0 and r["single_chunks"] == 0 for r in ranks),
        "ranks' states identical": all(np.array_equal(r0[k], r1[k])
                                       for k in ("pos", "vel", "K", "last_stats")),
        "one-process run's chunk engines": r0["chunk_engines"] == one["chunk_engines"],
        "vs the one-process run: pos": errs["pos_over_scale"] <= SHARD_POS_TOL,
        "vs the one-process run: stats": errs["last_stats_over_max"] <= SHARD_STATS_TOL,
        "rank 0 wrote snapshots 1, 3, 4 and the stats": r0["snapshot_ids"] == [1, 3, 4]
        and {f for f, _, _ in r0["tree_before"]} < names0
        and any(f.endswith("stats") for f in names0),
        "rank 1 wrote no file": r1["snapshot_ids"] == [] and r1["tree_after"] == r1["tree_before"],
        "kernel launches a rank": all(r["counts"] == want for r in ranks),
    }
    failed = [k for k, v in checks.items() if not v]
    one_walls = walls_summary(one, N_MAIN)
    say(name, card=gpu_line, backend=backend, ranks=MH_RANKS, shards_per_rank=MH_SHARDS,
        devices=[r["devices"] for r in ranks],
        scene=f"bb_collapsed.npz (contrast 395) polytropic N={N_MAIN} Kh={KH_COLLAPSE} float32",
        buckets=r0["buckets"], chunk_engines=r0["chunk_engines"],
        launches_per_rank=[r["counts"] for r in ranks],
        s_per_step_end_to_end={"ranks": [r["walls"]["s_per_step_end_to_end"] for r in ranks],
                               "one_process_x4": one_walls["s_per_step_end_to_end"]},
        s_per_step_after_first={"ranks": [r["walls"]["s_per_step_after_first"] for r in ranks],
                                "one_process_x4": one_walls["s_per_step_after_first"]},
        chunk_walls_rank0=r0["walls"]["chunk_walls"], pick_walls_rank0=r0["walls"]["pick_walls"],
        first_step_s=[r["walls"]["first_step_s"] for r in ranks],
        exchanges_of_run=[r["exchanges"] for r in ranks],
        runtime_s=[r["runtime_s"] for r in ranks], bit_equal_to_one_process=bit_equal,
        errors_vs_one_process=errs, tolerances=[SHARD_POS_TOL, SHARD_STATS_TOL],
        snapshot_ids=[r["snapshot_ids"] for r in ranks], failed=failed)
    if failed:
        raise AssertionError(f"{name} checks failed: {failed}")
    return [r["counts"] for r in ranks]


def _mh_slabs_rank(rank, out, path, capture_n):
    """A rank of `multihost_slabs`: bootstrap from the rank's contiguous
    share of the rows, plan (histograms summed over the ranks), migrate,
    pack its own shards, then a 1-step warm-up chunk (rank 0 records its
    first evaluation's K4, K2 and rows x columns launches) and the timed
    2-step chunk, its launch counts set to 0 just before it and read just
    after. Rank 0 then holds the recorded launches against their plain
    versions."""
    from sphtpu_torch.engine import params_from_numpy
    from sphtpu_torch.shard import multihost as mh
    from sphtpu_torch.shard import tiles as shard_tiles
    from sphtpu_torch.shard.mh_slabs import (
        LocalRows, _dev_of_rows, mh_local_rows, mh_migrate, mh_pack, mh_plan_slabs,
    )

    d = np.load(path)
    n = d["pos"].shape[0]
    lo, hi = rank * n // MH_RANKS, (rank + 1) * n // MH_RANKS
    local = LocalRows(d["pos"][lo:hi], d["vel"][lo:hi], d["K"][lo:hi], d["h"][lo:hi],
                      np.arange(lo, hi))
    p = params_from_numpy(**{k: float(d[k]) for k in PARAM_KEYS}, device=DEVICE)
    t = float(d["t"])
    del d
    mesh = mh.global_mesh([f"{DEVICE}:0"] * MH_SHARDS)
    t0 = time.perf_counter()
    plan = mh_plan_slabs(local, 50, len(mesh), chunk_steps=2)
    if plan is None:
        raise AssertionError("multihost_slabs: no slab plan")
    local = mh_migrate(local, plan, mesh)
    owned = bool(np.all(np.isin(_dev_of_rows(local.pos, plan), list(mesh.local))))
    states, layout = mh_pack(local, plan, mesh, torch.float32, t=t)
    t_plan = time.perf_counter() - t0
    cfg = EngineConfig(n=n, kh=50, eos="polytropic", tile=(plan.grid, plan.cap), gravity="exact")
    chunk = shard_tiles.make_slab_chunk_runner(cfg, plan, mesh, **EVAL_REPAIRS)

    caught = {k: [] for k in ("phase_a_tile", "phase_b_tiles", "newton_rows_cols")}

    def rec(kname):
        def wrap(orig):
            def run(*a, **kw):
                if rank == 0 and len(caught[kname]) < capture_n[kname]:
                    caught[kname].append((a, kw))
                return orig(*a, **kw)
            return run
        return wrap

    with contextlib.ExitStack() as patches:
        for kname in caught:
            patches.enter_context(patched(shard_tiles, kname, rec(kname)))
        chunk(states, p, 1)  # warm-up
    sync()
    reset_counts()
    reset_exchanges()
    (st2, stats, valid, cert, h_rows, _), t_chunk = timed(lambda: chunk(states, p, 2))
    counts = {name: mod.launches for name, mod in MODULES.items()}
    exchanges = read_exchanges()
    rows = mh_local_rows(st2, h_rows, layout)
    res = dict(
        static_key=plan.static_key, z0s=[int(z) for z in plan.z0s], half=plan.half,
        rows=list(plan.rows), d0=layout.d0, d1=layout.d1, owned=owned,
        n_local_rows=int(rows.gid.size), pos=rows.pos, vel=rows.vel, K=rows.K, h=rows.h,
        gid=rows.gid, stats=host64(stats), valid=bool(valid.all()), cert=bool(cert.any()),
        counts=counts, chunk_2_steps_s=t_chunk, plan_migrate_pack_s=t_plan, exchanges=exchanges,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else None,
    )
    if rank == 0:
        rc = caught.pop("newton_rows_cols")
        res["kernels_vs_plain"] = slab_kernel_checks(caught)
        err = 0.0
        for a, kw in rc:
            g_k, p_k = cuda_gravity_rc.newton_rows_cols(*a, **kw)
            g_p, p_p = cuda_gravity_rc.newton_rows_cols_plain(*a, **kw)
            if not same_bits((g_k, p_k), cuda_gravity_rc.newton_rows_cols(*a, **kw)):
                raise AssertionError("newton_rows_cols (multihost slab): two launches differ")
            g_err = float((g_k - g_p).abs().max())
            if g_err > 2e-4 * float(g_p.abs().max()):
                raise AssertionError(f"newton_rows_cols (multihost slab): g {g_err}")
            err = max(err, g_err, float((p_k - p_p).abs().max()))
        res["kernels_vs_plain"]["newton_rows_cols"] = dict(
            launches_checked=len(rc), max_abs_err=err, runs_bit_identical=True)
    return res


def phase_multihost_slabs(tmp: str, gpu_line: str, scene):
    """The headline scene (N = 1e5, Kh = 50, exact gravity) state-sharded with
    shard/mh_slabs.py over MH_RANKS ranks x MH_SHARDS shards of the card, from
    `scene` (phase_shard_slabs' final state: the 4-step run's; at t = 0 the
    rigid rotation's div v cancels to below K2's check's scale): each rank
    bootstraps from half of the rows, plans, migrates, packs and runs one
    2-step slab chunk (K4, K2, K3's rows x columns entry). Checks:
    both ranks derive plan_slabs' plan on the whole state; the gid sets are
    disjoint and complete; the reassembled state equals the one-process
    four-shard slab chunk's (timed here) bit for bit or within the shard
    bars; rank 0's launches of its own shards held against their plain
    versions. Returns the ranks' launch counts."""
    from sphtpu_torch.engine import params_from_numpy
    from sphtpu_torch.shard import tiles as shard_tiles
    from sphtpu_torch.shard.collectives import particle_mesh

    out = os.path.join(tmp, "multihost_slabs")
    os.makedirs(out)
    path = os.path.join(out, "state.npz")
    np.savez(path, **scene)
    pos, h0 = scene["pos"], scene["h"]
    n = pos.shape[0]
    st = state_from_numpy(pos, scene["vel"], scene["K"], scene["t"], device=DEVICE)
    p = params_from_numpy(**{k: scene[k] for k in PARAM_KEYS}, device=DEVICE)
    plan = shard_tiles.plan_slabs(pos, h0, 50, MH_RANKS * MH_SHARDS, chunk_steps=2)
    if plan is None:
        raise AssertionError("multihost_slabs: no one-process slab plan")
    mesh = particle_mesh(shard_mesh())
    cfg = EngineConfig(n=n, kh=50, eos="polytropic", tile=(plan.grid, plan.cap), gravity="exact")
    run = shard_tiles.make_slab_chunk_runner(cfg, plan, mesh, **EVAL_REPAIRS)
    run(shard_tiles.pack_state(st, plan, mesh), p, 1)  # warm-up
    (sl2, stats1, valid1, cert1, h_rows1, _), t_one = timed(
        lambda: run(shard_tiles.pack_state(st, plan, mesh), p, 2))
    one = shard_tiles.unpack_state(sl2, plan, n)
    pos1, vel1, K1 = host64(one.pos), host64(one.vel), host64(one.K)
    h1 = shard_tiles.unpack_rows(np.concatenate([host64(x) for x in h_rows1]), plan, n)
    stats1 = host64(stats1)
    del sl2, one, h_rows1, st, run
    torch.cuda.empty_cache()
    real = shard_tiles.real_rows(plan)
    # rank 0 records its first evaluation's launches: K4 and K2 once a shard,
    # the ring's rows x columns once a shard and round
    capture_n = {"phase_a_tile": MH_SHARDS, "phase_b_tiles": MH_SHARDS,
                 "newton_rows_cols": MH_SHARDS * MH_RANKS * MH_SHARDS}
    ranks = mh_spawn("slabs", out, "gloo", path, capture_n)
    r0, r1 = ranks

    full = {k: np.zeros((n, 3) if k in ("pos", "vel") else n) for k in ("pos", "vel", "K", "h")}
    for r in ranks:
        for k in full:
            full[k][r["gid"]] = r[k]
    errs = {"pos_over_scale": mh_rel(full["pos"], pos1), "vel_over_scale": mh_rel(full["vel"], vel1),
            "K_rel": float((np.abs(full["K"] - K1) / np.abs(K1)).max()),
            "h_rel": float((np.abs(full["h"] - h1) / np.abs(h1)).max()),
            "stats_over_max": mh_rel(r0["stats"], stats1)}
    bit_equal = all(v == 0.0 for v in errs.values())
    g0, g1 = set(r0["gid"].tolist()), set(r1["gid"].tolist())
    evals = 4
    want = {name: 0 for name in MODULES}
    want.update(phase_a_tile=evals * MH_SHARDS, phase_b_tiles=evals * MH_SHARDS,
                newton_rows_cols=evals * MH_SHARDS * MH_RANKS * MH_SHARDS)
    kern = r0["kernels_vs_plain"]
    checks = {
        "both ranks derive plan_slabs' plan": all(
            r["static_key"] == plan.static_key and r["z0s"] == [int(z) for z in plan.z0s]
            and r["half"] == plan.half and r["rows"] == real for r in ranks),
        "each rank holds only its own shards' rows": all(r["owned"] for r in ranks)
        and (r0["d0"], r0["d1"], r1["d0"], r1["d1"]) == (0, 2, 2, 4),
        "gid sets disjoint and complete": not (g0 & g1) and len(g0 | g1) == n,
        "chunks certified": r0["valid"] and r1["valid"] and not (r0["cert"] or r1["cert"])
        and bool(valid1.all()) and not bool(cert1.any()),
        "ranks' stats identical": np.array_equal(r0["stats"], r1["stats"]),
        "vs the one-process chunk: pos": errs["pos_over_scale"] <= SHARD_POS_TOL,
        "vs the one-process chunk: stats": errs["stats_over_max"] <= SHARD_STATS_TOL,
        "vs the one-process chunk: h": errs["h_rel"] <= SHARD_ROW_TOL,
        "kernel launches a rank": all(r["counts"] == want for r in ranks),
        "rank 0's K4, K2 and rows x columns launches held against their plain versions":
            kern["phase_a_tile"]["launches_checked"] == MH_SHARDS
            and kern["phase_b_tiles"]["launches_checked"] == MH_SHARDS
            and kern["newton_rows_cols"]["launches_checked"] == capture_n["newton_rows_cols"],
    }
    failed = [k for k, v in checks.items() if not v]
    say("multihost_slabs", card=gpu_line, backend="gloo", ranks=MH_RANKS,
        shards_per_rank=MH_SHARDS, scene=f"boss_bodenheimer polytropic N={n} Kh=50 float32 "
        "gravity=exact", plan={"grid": plan.grid, "cap": plan.cap, "lz_max": plan.lz_max,
                              "halo": plan.halo, "hops": plan.hops, "budget": plan.budget,
                              "n_loc": plan.n_loc, "z0s": [int(z) for z in plan.z0s],
                              "real_rows": real},
        rows_a_rank=[r["n_local_rows"] for r in ranks],
        launches_per_rank=[r["counts"] for r in ranks],
        s_per_step={"ranks": [r["chunk_2_steps_s"] / 2 for r in ranks],
                    "one_process_x4": t_one / 2},
        plan_migrate_pack_s=[r["plan_migrate_pack_s"] for r in ranks],
        exchanges_of_chunk=[r["exchanges"] for r in ranks],
        bit_equal_to_one_process=bit_equal, errors_vs_one_process=errs,
        tolerances=[SHARD_POS_TOL, SHARD_STATS_TOL, SHARD_ROW_TOL],
        rank0_kernels_vs_plain=kern, peak_memory_gb=[r["peak_memory_gb"] for r in ranks],
        failed=failed)
    if failed:
        raise AssertionError(f"multihost_slabs checks failed: {failed}")
    return [r["counts"] for r in ranks]


MH_PHASES = {"work": _mh_work_rank, "slabs": _mh_slabs_rank}


def kernel_entry(name, counts, err, ms, plain_ms, flops, byts, peak, **extra):
    source, replaces = KERNEL_INFO[name]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": counts[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        **bound(flops, byts, peak), "library_ms": None, **extra,
    }


# --------------------------------------------------------------------------
# forced fallback
# --------------------------------------------------------------------------


def load_scene(tmp: str, ic_type: str, n: int, kh: int | None = None):
    """Generate a polytropic scene through the CLI (Kh = kh, or the scene's
    default) and put it on the card in code units: (cfg fields, state,
    params, pos, h0)."""
    from scipy.spatial import cKDTree

    from sphtpu_torch.engine import params_from_numpy
    from sphtpu_torch.units import UnitSystem

    common = ["--EOS", "polytropic", "--ic_type", ic_type, "--root", tmp]
    kwargs = f"N={n}" if kh is None else f"N={n},Kh={kh}"
    if cli.main(["--generate", *common, "--kwargs", kwargs]) != 0:
        raise AssertionError("--generate failed")
    snap = read_snapshot(snapshot_path(tmp, ic_type, "1"))
    c = snap["constants"]
    u = UnitSystem.from_constants(float(c["G"]), float(c["M"]), float(c["R"]))
    kh, gamma = int(c["Kh"]), float(c.get("gamma", 5.0 / 3.0))
    pos = snap["pos"] / u.L
    state = state_from_numpy(
        pos, snap["vel"] / u.V, snap["K"] / u.K_entropy(gamma), 0.0, device=DEVICE
    )
    params = params_from_numpy(
        m=c["m"] / u.M, gamma=gamma, cs0=0.0, alpha=float(c["alpha"]),
        beta=float(c["beta"]), U0=0.0, t_end=float(c["tEnd"]) / u.T, device=DEVICE,
    )
    d_knn, _ = cKDTree(pos).query(pos, k=kh)
    h0 = d_knn[:, -1] / 2.0
    base = dict(n=int(c["N"]), kh=kh, eos="polytropic", dtype="float32")
    return base, state, params, pos, h0


def rel_err(out, ref):
    """(position error over the position scale, stats error over the
    largest stat) of two chunk outputs."""
    pos_err = float((out[0].pos - ref[0].pos).abs().max() / ref[0].pos.abs().max())
    stats_err = float(((out[1] - ref[1]).abs() / (ref[1].abs().max() + 1e-30)).max())
    return pos_err, stats_err


def phase_fallback(tmp: str) -> None:
    """One step at N = 5000 (gaussian_sphere) on a tile config far too small
    for the state: the certificate must fail on both evaluations and the
    step must be the gather engine's. Then, on a state the planner can
    certify (boss_bodenheimer, N = 5000), the class path with 0 fallbacks
    must step the gather engine's trajectory to f32 roundoff."""
    tol = 1e-5
    base, state, params, pos, h0 = load_scene(tmp, "gaussian_sphere", N_SMALL)
    h_dev = dev(h0, torch.float32)
    starved = dict(tile=(3, 32), tile_classes=((32, 8),))
    out_s = make_chunk_runner(EngineConfig(**base, **starved), device=DEVICE)(state, params, h_dev, 1)
    out_g = make_chunk_runner(EngineConfig(**base), device=DEVICE)(state, params, h_dev, 1)
    sync()
    n_fb = int(out_s[5].sum())
    err, err_stats = rel_err(out_s, out_g)

    base, state, params, pos, h0 = load_scene(tmp, "boss_bodenheimer", N_SMALL)
    plan = choose_tile_classes(pos, h0, base["kh"])
    if plan is None:
        raise AssertionError("the planner cannot certify boss_bodenheimer at N = 5000")
    grid, cap, classes = plan
    h_dev = dev(h0, torch.float32)
    out_c = make_chunk_runner(
        EngineConfig(**base, tile=(grid, cap), tile_classes=classes), device=DEVICE
    )(state, params, h_dev, 1)
    out_g2 = make_chunk_runner(EngineConfig(**base), device=DEVICE)(state, params, h_dev, 1)
    sync()
    err_c, err_c_stats = rel_err(out_c, out_g2)
    say("fallback", forced={"scene": f"gaussian_sphere N={N_SMALL}", **starved, "n_fallbacks": n_fb,
                            "pos_err_vs_gather": err, "stats_err_vs_gather": err_stats},
        certified={"scene": f"boss_bodenheimer N={N_SMALL}", "tile": [grid, cap],
                   "tile_classes": [list(x) for x in classes],
                   "n_fallbacks": int(out_c[5].sum()), "pos_err_vs_gather": err_c,
                   "stats_err_vs_gather": err_c_stats},
        tol=tol)
    if n_fb != 2 or not (err <= tol and err_stats <= tol):
        raise AssertionError("forced fallback does not match the gather engine")
    if int(out_c[5].sum()) != 0 or not (err_c <= tol and err_c_stats <= 1e-4):
        raise AssertionError("certified class path disagrees with the gather engine")


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    gpu_line = run_text(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    ).splitlines()[0]
    nvcc = run_text([build._nvcc(), "--version"]).splitlines()[-2:]
    say("env", python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=nvcc, card=gpu_line, port=sphtpu_torch.__version__)

    t0 = time.time()
    build.load_kernels()
    say("build", seconds=time.time() - t0, sources=list(build.SOURCES),
        ptxas=[ln for log in build.build_log.values() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln and "0 bytes spill" not in ln][:24])

    f8 = phase_kernels()
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        res, cfg, by_path["class_n1e5_kh32"] = phase_exact_path(tmp, gpu_line, KH_CLASS)
        entries = phase_kernel_times(res, cfg, by_path["class_n1e5_kh32"])
        del res
        torch.cuda.empty_cache()
        res, cfg, by_path["exact_n1e5"] = phase_exact_path(tmp, gpu_line, 50)
        k4_exact, k2_exact, _ = phase_mono_kernel_times(res, cfg, by_path["exact_n1e5"])
        k3_exact = k3_entry(res, by_path["exact_n1e5"], PEAK_FLOPS[torch.float32])
        del res
        torch.cuda.empty_cache()
        res, cfg, by_path["p3m_n2e5"], s_per_step = phase_p3m_path(tmp, gpu_line)
        k4, k2_p3m, tail = phase_mono_kernel_times(res, cfg, by_path["p3m_n2e5"])
        phase_p3m_accuracy(res, cfg, gpu_line, s_per_step)
        del res
        torch.cuda.empty_cache()
        phase_fallback(tmp)
        res, cfg, by_path["collapse_n1e5"] = phase_collapse_path(tmp, gpu_line)
        k1_blk, k5, k6, by_path["collapse_per_bucket"], bargs = phase_collapse_kernels(
            res, cfg, by_path["collapse_n1e5"], gpu_line)
        phase_collapse_vs_gather(res, cfg, bargs, gpu_line)
        del res, bargs
        torch.cuda.empty_cache()
        by_path["collapse_p3m_n1e5"] = phase_collapse_p3m_blocks(tmp, gpu_line)
        torch.cuda.empty_cache()
        phase_deep_state(gpu_line)
        k1_ml, counts_ml = phase_mlevel(gpu_line)
        by_path.update(counts_ml)
        by_path["mlevel_ladder"] = phase_mlevel_ladder(tmp, gpu_line)
        torch.cuda.empty_cache()
        k2_out, counts_out = phase_outlier(gpu_line)
        by_path.update(counts_out)
        by_path["outlier_ladder"] = phase_outlier_ladder(tmp, gpu_line)
        phase_offpath(gpu_line)
        torch.cuda.empty_cache()
        by_path["slab_exact_n1e5_x4"], ring_calls, slab_exact, headline = phase_shard_slabs(
            tmp, gpu_line, p3m=False)
        torch.cuda.empty_cache()
        by_path["slab_p3m_n2e5_x4"], _, slab_p3m, _ = phase_shard_slabs(tmp, gpu_line, p3m=True)
        torch.cuda.empty_cache()
        (by_path["blocks_sharded_collapse_x4"], row_sharded,
         by_path["mlevel_sharded_deep_eval_x4"], one_work) = phase_shard_work(tmp, gpu_line)
        rc = rc_entry(ring_calls, row_sharded, by_path["slab_exact_n1e5_x4"])
        del ring_calls, row_sharded
        torch.cuda.empty_cache()
        for r, c in enumerate(phase_multihost_work(tmp, gpu_line, one_work)):
            by_path[f"multihost_work_rank{r}"] = c
        if torch.cuda.device_count() >= MH_RANKS:
            for r, c in enumerate(phase_multihost_work(tmp, gpu_line, one_work, "nccl")):
                by_path[f"multihost_work_nccl_rank{r}"] = c
        else:
            say("multihost_work_nccl", ran=False, visible_cards=torch.cuda.device_count(),
                reason=f"NCCL needs one card a rank: {MH_RANKS} ranks, "
                       f"{torch.cuda.device_count()} card")
        del one_work
        for r, c in enumerate(phase_multihost_slabs(tmp, gpu_line, headline)):
            by_path[f"multihost_slabs_rank{r}"] = c
        del headline
    entries[0]["on_collapse_path"] = k1_blk
    entries[0]["on_mlevel_path"] = k1_ml
    entries[1]["on_exact_path"] = k2_exact
    entries[1]["on_p3m_path"] = k2_p3m
    entries[1]["on_outlier_path"] = k2_out
    # K2's joint mode and the tail's skip mode (ROADMAP D21): the P3M
    # paths' launches are in them (on_p3m_path, on_slab_p3m_path); here the
    # synthetic cases of `kernels_f8`
    entries[1]["joint_mode"] = [{"dtype": c["dtype"], "w": c["f8_w"], **c["joint"]} for c in f8]
    f8_tail = [{"dtype": c["dtype"], "w": c["f8_w"], **c["skip"],
                **{k: c[k] for k in ("joint_plus_skip_vs_split", "f32_against_f64_over_scale")
                   if k in c}} for c in f8]
    entries[2]["on_exact_path"] = {k: k3_exact[k] for k in (
        "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "runs_bit_identical", "plan")}
    k4["on_exact_path"] = {k: k4_exact[k] for k in (
        "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "tie_rows",
        "rows", "cap", "occupied_pairs", "pairs_in_radius", "valid_queries", "overflowed",
        "overflow_share", "forced_overflow_share", "forced_overflow_h_ok_equal",
        "streamed_equal", "list_len_stage")}
    k4["on_slab_exact_path"] = slab_exact["phase_a_tile"]
    k4["on_slab_p3m_path"] = slab_p3m["phase_a_tile"]
    entries[1]["on_slab_exact_path"] = slab_exact["phase_b_tiles"]
    entries[1]["on_slab_p3m_path"] = slab_p3m["phase_b_tiles"]
    tail["on_slab_p3m_path"] = slab_p3m["p3m_tail"]
    tail["skip_mode"] = f8_tail
    entries += [k4, tail, k5, k6, rc]
    for e in entries:
        e["launches_by_path"] = {path: c[e["name"]] for path, c in by_path.items()}
    side = (k2_exact, k2_p3m, k4["on_exact_path"], k1_blk, entries[2]["on_exact_path"], k1_ml,
            k2_out)
    if any(e["launches"] <= 0 for e in entries + list(side)):
        raise AssertionError("a kernel of a main path was never launched")
    print(json.dumps({"kernels": entries}), flush=True)
    print(gpu_line, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
