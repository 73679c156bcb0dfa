"""The roofline accounting (sphtpu_torch/roofline.py) against the reference's.

The six tests of tests/test_roofline.py, mirrored: on the same arguments
the port's operation and byte counts, and each stage's split, equal
sphtpu.roofline's. The peak test becomes a check of the H100 figures (67
TFLOP/s FP32 without tensor cores, 3.35 TB/s HBM3) and of the knee the
report classifies by; the report's shares and bound are computed from
those peaks (the reference's report keeps its TPU peaks).
"""

import numpy as np
import pytest

import sphtpu.roofline as R
from sphtpu_torch.roofline import (
    PEAK_F32,
    PEAK_HBM_BPS,
    add_counts,
    allpairs_gravity_counts,
    block_force_counts,
    ctile_force_counts,
    p3m_mesh_counts,
    roofline_report,
    tile_force_counts,
)

SPEC = (((1024, 8), (4096, 16)), 3)  # the reference test's (buckets, n_oct) spec


def test_peaks_are_the_h100s():
    assert PEAK_F32 == 67e12 and PEAK_HBM_BPS == 3.35e12
    # 132 SMs x 128 FP32 lanes x 2 (FMA) x 1.98 GHz boost, within the
    # datasheet's rounding
    assert np.isclose(PEAK_F32, 132 * 128 * 2 * 1.98e9, rtol=1e-2)
    knee = PEAK_F32 / PEAK_HBM_BPS  # FLOP/B where the two roofs meet
    assert np.isclose(knee, 20.0)
    below = {"flops": int(0.99 * knee * 1e9), "bytes": int(1e9), "stages": {}}
    above = {"flops": int(1.01 * knee * 1e9), "bytes": int(1e9), "stages": {}}
    assert roofline_report(below, 1.0)["bound"] == "memory"
    assert roofline_report(above, 1.0)["bound"] == "compute"


@pytest.mark.parametrize("gravity", ["exact", "p3m"])
def test_counts_positive_and_stage_split(gravity):
    cnt = block_force_counts(SPEC, n=10_000, kh=50, gravity=gravity)
    assert cnt == R.block_force_counts(SPEC, n=10_000, kh=50, gravity=gravity)
    assert cnt["flops"] > 0 and cnt["bytes"] > 0
    assert set(cnt["stages"]) == {"phase_a", "phase_b"}
    assert cnt["flops"] == sum(s["flops"] for s in cnt["stages"].values())
    assert cnt["bytes"] == sum(s["bytes"] for s in cnt["stages"].values())
    if gravity == "p3m":  # p3m adds the pair tail to phase B
        assert cnt["flops"] > block_force_counts(SPEC, n=10_000, kh=50)["flops"]


def test_tile_counts_scale_with_grid():
    small = tile_force_counts(8, 64, 10_000, 50)
    big = tile_force_counts(16, 64, 10_000, 50)
    assert small == R.tile_force_counts(8, 64, 10_000, 50)
    assert big == R.tile_force_counts(16, 64, 10_000, 50)
    assert 7.0 < big["flops"] / small["flops"] < 9.0
    classes = ((32, 100), (64, 40), (128, 5))
    for gravity in ("exact", "p3m"):
        assert ctile_force_counts(classes, 128, 10_000, 50, gravity=gravity) == (
            R.ctile_force_counts(classes, 128, 10_000, 50, gravity=gravity))
        assert tile_force_counts(15, 128, 100_000, 50, gravity=gravity, dtype_bytes=8) == (
            R.tile_force_counts(15, 128, 100_000, 50, gravity=gravity, dtype_bytes=8))


def test_add_counts_merges():
    a = allpairs_gravity_counts(10_000)
    b = p3m_mesh_counts(64, 10_000)
    assert a == R.allpairs_gravity_counts(10_000)
    assert b == R.p3m_mesh_counts(64, 10_000)
    tot = add_counts(a, b)
    assert tot == R.add_counts(a, b)
    assert tot["flops"] == a["flops"] + b["flops"]
    assert tot["bytes"] == a["bytes"] + b["bytes"]
    assert set(tot["stages"]) == {"gravity_allpairs", "p3m_mesh"}


def test_report_compute_vs_memory_bound():
    hi = {"flops": int(1e12), "bytes": int(1e9), "stages": {}}
    rep = roofline_report(hi, seconds_per_pass=1.0)
    assert rep["bound"] == "compute"
    assert np.isclose(rep["mfu_f32"], 1e12 / PEAK_F32, atol=5e-5)
    assert np.isclose(rep["pct_roofline"], 100.0 * 1e12 / PEAK_F32, atol=5e-3)
    lo = {"flops": int(1e9), "bytes": int(1e9), "stages": {}}
    rep = roofline_report(lo, seconds_per_pass=1.0)
    assert rep["bound"] == "memory"
    assert np.isclose(rep["hbm_frac"], 1e9 / PEAK_HBM_BPS, atol=5e-5)
    attainable = (1e9 / 1e9) * PEAK_HBM_BPS
    assert np.isclose(rep["pct_roofline"], 100.0 * 1e9 / attainable, atol=5e-3)
    # every key of the reference's report but its TPU share, renamed
    ref_keys = set(R.roofline_report(lo, 1.0))
    assert set(rep) == ref_keys - {"mfu_vpu"} | {"mfu_f32"}
    for k in ("gflop_per_pass", "gbyte_per_pass", "achieved_gflops", "achieved_gbps",
              "arithmetic_intensity"):
        assert rep[k] == R.roofline_report(lo, 1.0)[k]


def test_report_mfu_bounded():
    cnt = tile_force_counts(15, 128, 100_000, 50)
    fast = roofline_report(cnt, seconds_per_pass=0.1)
    slow = roofline_report(cnt, seconds_per_pass=0.4)
    assert np.isclose(fast["mfu_f32"], 4 * slow["mfu_f32"], rtol=5e-2)
    assert 0.0 < slow["mfu_f32"] < 1.0
    assert np.isclose(slow["mfu_f32"], cnt["flops"] / 0.4 / PEAK_F32, atol=5e-5)
