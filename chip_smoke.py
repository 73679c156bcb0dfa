#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout,
holds each against its plain PyTorch version on the card, then drives the
port's main path through the CLI: boss_bodenheimer, polytropic,
N = 100 000, Kh = 50, float32, four steps on the class-compacted tile
engine with exact gravity. Every phase prints one JSON line; any failure
raises, so the process exits non-zero. There is no CPU continuation: with
no CUDA device the script fails before it prints a result.

The line before the last two is `{"kernels": [...]}` with, per kernel, its
launches on the main path, its error against the plain version and its
time beside the plain version's and the card's bound, all on the inputs
that one force evaluation of the main path's final state gives it. Then
the card's name and power limit as nvidia-smi prints them, then the
verdict line.
"""

from __future__ import annotations

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
from sphtpu_torch.engine.step import force_eval
from sphtpu_torch.io import read_snapshot, snapshot_path
from sphtpu_torch.kernels import build, cuda_gravity, cuda_strip_knn, cuda_tile_pairs
from sphtpu_torch.physics import ctiles
from sphtpu_torch.physics.ctiles import CLASS_MENU, choose_tile_classes

DEVICE = "cuda"
N_MAIN = 100_000  # particles of the main path's scene
N_SMALL = 5_000  # particles of the fallback phase's scenes
ROWS_F32, ROWS_F64 = 256, 64  # synthetic cell rows per class in the kernels phase
N_NEWTON = {torch.float32: 100_000, torch.float64: 20_000}

# Published peaks of one H100 SXM (dense, no sparsity): float32 outside the
# tensor cores, float64 likewise, and HBM bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_BYTES = 3.35e12
# Operations the FUNCTIONS need (not what the kernels happen to do), per
# (query, occupied candidate) pair. Phase A: d2 once, then a compare and a
# count on each of the n_bisect + 3 passes, and the spline W on the ~kh
# pairs inside the k-th distance. Phase B: d2, 1/r, the three mask radii
# and their compares on every pair; the full body (140, counted on
# phase_b_tiles, the test included) only on pairs inside a mask.
K1_OPS_D2 = 8  # 3 sub, 3 mul, 2 add
K1_OPS_PER_PASS = 2
K1_OPS_W = 12
K2_OPS_MASK_TEST = 20
K2_OPS_PER_PAIR = 140
K3_FLOPS_PER_PAIR = 20
B_OUTPUTS = "ax ay az div mu_max visc ggx ggy ggz gphi".split()
MODULES = {
    "phase_a_cells": cuda_strip_knn,
    "phase_b_tiles": cuda_tile_pairs,
    "newton_sweep": cuda_gravity,
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


# --------------------------------------------------------------------------
# synthetic kernel inputs at production shapes (numpy seed)
# --------------------------------------------------------------------------


def synthetic_rows(rng, n_cells, cap_k, cap, dtype, occupancy):
    """Cell rows shaped like the class-compacted engine's: cw = 27 * cap
    candidate slots of which `occupancy` of each cell's cap slots are
    filled, positions inside a 3^3 block of unit cells, the queries being
    the centre cell's first cap_k slots."""
    cw = 27 * cap
    n_occ = max(1, min(cap_k, int(occupancy)))
    slot = np.arange(cap)[None, None, :]
    fill = rng.integers(max(1, n_occ // 2), n_occ + 1, size=(n_cells, 27, 1))
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


def check_phase_b(outs_k, outs_p, dtype):
    """Kernel vs plain for phase B: |a - b| <= rtol |b| + atol * (largest
    |b| of that output). The outputs are sums of signed pair terms that
    largely cancel for a particle with isotropic neighbours, so roundoff
    scales with the terms — of the size of the output's largest values —
    not with the particle's own (possibly cancelled) result. Returns the
    worst error over that scale."""
    rtol, atol = (2e-4, 2e-5) if dtype == torch.float32 else (1e-9, 1e-11)
    worst = 0.0
    for name, a, b in zip(B_OUTPUTS, outs_k, outs_p):
        live = b > -torch.finfo(b.dtype).max  # mu_max of masked rows is -max
        scale = float(b[live].abs().max()) if bool(live.any()) else 0.0
        err = (a - b).abs()
        if not bool((err <= rtol * b.abs() + atol * scale).all()):
            raise AssertionError(
                f"phase_b_tiles {name}: max abs err {err.max().item()} "
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
            case["a"] = {"rho_max_abs_err": err, "rho_rtol": rho_rtol, "tie_rows": ties}
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
                    }
            report["cases"].append(case)

    # K3: N = 100 000 in f32, a smaller N in f64
    for dtype, n in N_NEWTON.items():
        pos = dev(rng.standard_normal((n, 3)), dtype)
        mm = 1.0 / n
        g_k, p_k = cuda_gravity.newton_sweep(pos, mm)
        sync()
        g_p, p_p = cuda_gravity.newton_sweep_plain(pos, mm)
        rtol = 2e-4 if dtype == torch.float32 else 1e-10
        g_err = float((g_k - g_p).abs().max())
        p_err = float(((p_k - p_p).abs() / p_p.abs()).max())
        if g_err > rtol * float(g_p.abs().max()) or p_err > rtol:
            raise AssertionError(f"newton_sweep {dtype}: g err {g_err}, phi rel err {p_err}")
        report["cases"].append(
            {"dtype": str(dtype)[6:], "newton_n": n, "g_max_abs_err": g_err,
             "phi_max_rel_err": p_err, "rtol_of_max": rtol}
        )
    report["tie_rows_total"] = sum(c["a"]["tie_rows"] for c in report["cases"] if "a" in c)
    say("kernels", **report, kernels=list(MODULES))


# --------------------------------------------------------------------------
# main path
# --------------------------------------------------------------------------


def reset_counts() -> None:
    for mod in MODULES.values():
        mod.launches = 0


def phase_main_path(tmp: str, gpu_line: str):
    common = ["--EOS", "polytropic", "--ic_type", "boss_bodenheimer", "--root", tmp]
    if cli.main(["--generate", *common, "--kwargs", f"N={N_MAIN}"]) != 0:
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
    cfg = res["configs"][0]
    n_cls = len(cfg.tile_classes or ())
    checks = {
        "one config, with tile_classes": len(res["configs"]) == 1 and n_cls > 0,
        "float32": res["state"].pos.dtype == torch.float32,
        "on the card": res["state"].pos.device.type == DEVICE,
        "4 steps": res["steps"] == 4,
        "0 fallback evals": res["fallback_evals"] == 0,
        "kernel launches": counts
        == {"phase_a_cells": 8 * n_cls, "phase_b_tiles": 8 * n_cls, "newton_sweep": 8},
    }
    stats_path = os.path.join(tmp, "snapshots", "boss_bodenheimer", "stats")
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
        snap = read_snapshot(snapshot_path(tmp, "boss_bodenheimer", str(sid)))
        checks[f"snapshot {sid} reads back"] = bool(
            snap["pos"].shape == (N_MAIN, 3) and np.isfinite(snap["pos"]).all()
            and snap["K"].shape == (N_MAIN,)
        )
    checks["snapshots 1, 3, 4"] = res["snapshot_ids"] == [1, 3, 4]
    failed = [k for k, v in checks.items() if not v]
    walls = res["chunk_walls"]
    later_steps = sum(c[0] for c in walls[1:])
    s_per_step = sum(c[1] for c in walls[1:]) / later_steps
    say(
        "main_path", card=gpu_line, scene=f"boss_bodenheimer polytropic N={N_MAIN} Kh=50 float32",
        tile=list(cfg.tile), tile_classes=[list(c) for c in cfg.tile_classes],
        steps=res["steps"], fallback_evals=res["fallback_evals"], launches=counts,
        energy_drift=drift, chunk_walls=walls, first_step_s=walls[0][1],
        s_per_step_after_first=s_per_step, particle_steps_per_s=N_MAIN / s_per_step,
        snapshot_ids=res["snapshot_ids"], runtime_s=res["runtime_s"], failed=failed,
    )
    if failed:
        raise AssertionError(f"main path checks failed: {failed}")
    return res, cfg, counts


def capture_eval_inputs(res, cfg):
    """Arguments the two tile kernels get in one force evaluation of the
    main path's final state."""
    calls = {"a": [], "b": []}
    orig_a, orig_b = ctiles.phase_a_cells, ctiles.phase_b_tiles

    def rec_a(*args, **kw):
        calls["a"].append((args, kw))
        return orig_a(*args, **kw)

    def rec_b(*args, **kw):
        calls["b"].append((args, kw))
        return orig_b(*args, **kw)

    ctiles.phase_a_cells, ctiles.phase_b_tiles = rec_a, rec_b
    try:
        st = res["state"]
        _, _, _, fell_back = force_eval(
            cfg, res["params"], st.pos, st.vel, st.K, res["h_last"], device=DEVICE
        )
    finally:
        ctiles.phase_a_cells, ctiles.phase_b_tiles = orig_a, orig_b
    if fell_back:
        raise AssertionError("the captured evaluation fell back")
    return calls


def pairs_in_a_mask(qfields, cfields, chunk_elems: int = 1 << 27) -> int:
    """Occupied (query, candidate) pairs of phase B's inputs that lie inside
    the forward, the reverse or the gravity-correction mask: d2 <=
    (2 max(h_q, h_c))^2, which contains all three."""
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
        inside = (d2 <= reach * reach) & (qm[sl, :, None] > 0) & (cm[sl, None, :] > 0)
        total += int(inside.sum())
    return total


def phase_kernel_times(res, cfg, counts):
    """Each kernel against its plain version on the inputs of one force
    evaluation of the main path's final state: error, time of the
    evaluation's launches (all classes), the plain version's time and the
    card's bound for the same work."""
    calls = capture_eval_inputs(res, cfg)
    dtype = res["state"].pos.dtype
    peak = PEAK_FLOPS[dtype]
    entries = []

    # K1
    ms = plain_ms = flops = byts = 0.0
    err = 0.0
    ties = 0
    for args, kw in calls["a"]:
        queries, reach2, cands, m = args
        out_k = cuda_strip_knn.phase_a_cells(*args, **kw)
        out_p = cuda_strip_knn.phase_a_cells_plain(*args, **kw)
        e, t_rows = check_phase_a(*out_k, *out_p, queries, reach2, cands, 2e-5)
        err, ties = max(err, e), ties + t_rows
        ms += time_ms(lambda: cuda_strip_knn.phase_a_cells(*args, **kw))
        plain_ms += time_ms(
            lambda: cuda_strip_knn.phase_a_cells_plain(*args, **kw), iters=1, warmup=0
        )
        pairs = float(((queries[3] > 0).sum(1) * (cands[3] > 0).sum(1)).sum())
        n_bisect = kw.get("n_bisect", cuda_strip_knn.N_BISECT)
        flops += pairs * (K1_OPS_D2 + K1_OPS_PER_PASS * (n_bisect + 3))
        flops += float((queries[3] > 0).sum()) * kw["kh"] * K1_OPS_W
        byts += nbytes(*queries, reach2, *cands, *out_k)
    entries.append(kernel_entry("phase_a_cells", counts, err, ms, plain_ms, flops, byts, peak,
                                tie_rows=ties))

    # K2
    ms = plain_ms = flops = byts = 0.0
    err = rel = err_scale = pairs_all = pairs_masked = 0.0
    err_field = None
    for args, kw in calls["b"]:
        qfields, cfields = args[0], args[1]
        out_k = cuda_tile_pairs.phase_b_tiles(*args, **kw)
        out_p = cuda_tile_pairs.phase_b_tiles_plain(*args, **kw)
        for name, a, b in zip(B_OUTPUTS, out_k, out_p):
            e = float((a - b).abs().max())
            if e > err:
                err, err_field, err_scale = e, name, float(b.abs().max())
        rel = max(rel, check_phase_b(out_k, out_p, dtype)[0])
        ms += time_ms(lambda: cuda_tile_pairs.phase_b_tiles(*args, **kw))
        plain_ms += time_ms(
            lambda: cuda_tile_pairs.phase_b_tiles_plain(*args, **kw), iters=1, warmup=0
        )
        pairs = float(((qfields[6] > 0).sum(1) * (cfields[6] > 0).sum(1)).sum())
        in_mask = pairs if kw["p3m"] else float(pairs_in_a_mask(qfields, cfields))
        pairs_all += pairs
        pairs_masked += in_mask
        flops += pairs * K2_OPS_MASK_TEST + in_mask * (K2_OPS_PER_PAIR - K2_OPS_MASK_TEST)
        byts += nbytes(*qfields, *cfields, *out_k)
    # the absolute error is in code units of whichever output is largest;
    # the check itself is relative to each output's scale
    entries.append(kernel_entry("phase_b_tiles", counts, err, ms, plain_ms, flops, byts, peak,
                                max_abs_err_output=err_field, largest_value_of_it=err_scale,
                                max_err_over_scale=rel, occupied_pairs=pairs_all,
                                pairs_in_a_mask=pairs_masked))

    # K3
    pos, m = res["state"].pos, res["params"].m
    g_k, p_k = cuda_gravity.newton_sweep(pos, m)
    g_p, p_p = cuda_gravity.newton_sweep_plain(pos, m)
    err = max(float((g_k - g_p).abs().max()), float((p_k - p_p).abs().max()))
    if err > 2e-4 * max(float(g_p.abs().max()), float(p_p.abs().max())):
        raise AssertionError(f"newton_sweep on the main path's state: max abs err {err}")
    n = pos.shape[0]
    ms = time_ms(lambda: cuda_gravity.newton_sweep(pos, m))
    plain_ms = time_ms(lambda: cuda_gravity.newton_sweep_plain(pos, m), iters=1, warmup=0)
    entries.append(
        kernel_entry("newton_sweep", counts, err, ms, plain_ms,
                     float(n) * n * K3_FLOPS_PER_PAIR, nbytes(pos, g_k, p_k), peak)
    )
    return entries


def kernel_entry(name, counts, err, ms, plain_ms, flops, byts, peak, **extra):
    t_ops = flops / peak * 1e3
    t_bytes = byts / PEAK_BYTES * 1e3
    source, replaces = KERNEL_INFO[name]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": counts[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None, **extra,
    }


# --------------------------------------------------------------------------
# forced fallback
# --------------------------------------------------------------------------


def load_scene(tmp: str, ic_type: str, n: int):
    """Generate a polytropic scene through the CLI and put it on the card
    in code units: (cfg fields, state, params, pos, h0)."""
    from scipy.spatial import cKDTree

    from sphtpu_torch.engine import params_from_numpy
    from sphtpu_torch.units import UnitSystem

    common = ["--EOS", "polytropic", "--ic_type", ic_type, "--root", tmp]
    if cli.main(["--generate", *common, "--kwargs", f"N={n}"]) != 0:
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

    phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        res, cfg, counts = phase_main_path(tmp, gpu_line)
        entries = phase_kernel_times(res, cfg, counts)
        del res
        torch.cuda.empty_cache()
        phase_fallback(tmp)
    if any(e["launches"] <= 0 for e in entries):
        raise AssertionError("a kernel of the main path was never launched")
    print(json.dumps({"kernels": entries}), flush=True)
    print(gpu_line, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
