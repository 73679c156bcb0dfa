"""On the card: every cell's command prints a correct result, and at each
cell's own size the program passes its limits while the control (the
reference in bfloat16) fails them. Skipped where there is no CUDA device."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import compare, manifest

from .conftest import ROOT

CELLS = [w["name"] for w in manifest.load(ROOT)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_command_prints_a_correct_result(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "2147483999",
         "--seconds", "3", "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload", cell, "--seeds", "2147483998",
         "--control-seeds", "2147483998"], capture_output=True, text=True, cwd=ROOT, timeout=600,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    limits = manifest.Cell(ROOT, cell).spec["limits"]
    assert compare.judge(line["program"], limits), line["program"]
    assert not compare.judge(line["control"], limits), line["control"]
