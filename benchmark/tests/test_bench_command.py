"""The command's refusals: no result without a card, none from a directory
that holds only the benchmark."""

import os
import shutil
import subprocess
import sys

import pytest

from .conftest import BENCH, ROOT


def run(cwd, cell="cloud2e5.p3m"):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=cwd, timeout=300)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    out = run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


@pytest.mark.card
def test_no_result_from_the_benchmark_alone(card, tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = run(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
