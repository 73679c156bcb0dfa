"""Fixtures of the benchmark's tests: a small checkout (the benchmark's
folder with two small cells of its own, on the CPU) and the `card` marker.

Tests marked `card` need a CUDA device; they decide inside a fixture
whether there is one and skip with the reason where there is none.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np
import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the real cells whose limits and metrics the small cells take
LIKE = {"tiny.tiles": "cloud2e5.exact", "tiny.blocks": "collapse.exact"}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (runs on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here: run on the chip (benchmark/README.md)")
    return torch.device("cuda")


def read(path):
    with open(path) as f:
        return json.load(f)


def write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_small_checkout(root: str) -> str:
    """A checkout at `root` whose BENCHMARK.json holds two small cells on
    the real cells' code, metrics and limits: `tiny.tiles` (the cloud at
    N = 1 500, generated in set-up, exact gravity, 2-step requests) and `tiny.blocks` (every 20th
    particle of the collapsed state, h from a KD-tree at Kh = 50)."""
    from scipy.spatial import cKDTree

    bench = os.path.join(root, "benchmark")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cloud = read(os.path.join(BENCH, "configs", "bb_cloud_2e5.json"))
    cloud.update(N=1500, scene="generated_cloud")
    write(os.path.join(bench, "configs", "tiny_cloud.json"), cloud)
    d = np.load(os.path.join(BENCH, "data", "bb_collapsed.npz"))
    pos = d["pos"][::20]
    h = cKDTree(pos).query(pos, k=50)[0][:, -1] / 2.0
    np.savez(os.path.join(bench, "data", "tiny_collapse.npz"), pos=pos, vel=d["vel"][::20],
             K=d["K"][::20], h=h.astype(np.float32), t=d["t"], m=d["m"] * 20)
    collapse = read(os.path.join(BENCH, "configs", "bb_collapsed_1e5.json"))
    collapse.update(N=int(pos.shape[0]), state="benchmark/data/tiny_collapse.npz")
    write(os.path.join(bench, "configs", "tiny_collapse.json"), collapse)
    common = {"warmup_requests": 1, "traced_requests": 1, "checked_requests": 1}
    write(os.path.join(bench, "traffic", "tiny_tiles.json"),
          {"gravity": "exact", "steps": 2, **common})
    write(os.path.join(bench, "traffic", "tiny_blocks.json"),
          {"gravity": "auto", "steps": "ML_SUBCHUNK", **common})
    for cell, like in LIKE.items():
        write(os.path.join(bench, "workloads", cell + ".json"),
              read(os.path.join(BENCH, "workloads", like + ".json")))
    real = read(os.path.join(ROOT, "BENCHMARK.json"))
    tiny = dict(real)
    tiny["configs"] = [
        {"name": "tiny_cloud", "source": "the bb_cloud_2e5 configuration at N = 1 500",
         "file": "benchmark/configs/tiny_cloud.json", "reduced": ["N"], "why": "CPU tests"},
        {"name": "tiny_collapse", "source": "every 20th particle of bb_collapsed_1e5",
         "file": "benchmark/configs/tiny_collapse.json", "reduced": ["N"], "why": "CPU tests"},
    ]
    tiny["workloads"] = [
        {"name": "tiny.tiles", "config": "tiny_cloud", "traffic": "tiny_tiles", "chips": 1,
         "why": "CPU tests of the tile path"},
        {"name": "tiny.blocks", "config": "tiny_collapse", "traffic": "tiny_blocks", "chips": 1,
         "why": "CPU tests of the block path"},
    ]
    for kind in ("end_to_end", "per_layer"):
        tiny[kind] = []
        for m in real[kind]:
            m = dict(m)
            if "workloads" in m:
                m["workloads"] = [c for c, like in LIKE.items() if like in m["workloads"]]
            tiny[kind].append(m)
    write(os.path.join(root, "BENCHMARK.json"), tiny)
    return root


@pytest.fixture(scope="session")
def small_root(tmp_path_factory):
    return make_small_checkout(str(tmp_path_factory.mktemp("checkout")))
