"""A configuration, a cell and a metric are added by files and manifest
entries alone: a copy with one more of each runs, and no file that was
there changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from .conftest import ROOT, read, write

METRIC = '''"""Requests the window ran."""


def read(ctx):
    return len(ctx.requests)
'''


def digests(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            if "__pycache__" in base:
                continue
            path = os.path.join(base, f)
            out[os.path.relpath(path, root)] = hashlib.sha256(open(path, "rb").read()).hexdigest()
    return out


def test_a_new_config_cell_and_metric_are_files_and_entries(small_root, tmp_path):
    root = str(tmp_path / "checkout")
    shutil.copytree(small_root, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(root)
    bench = os.path.join(root, "benchmark")
    conf = read(os.path.join(bench, "configs", "tiny_cloud.json"))
    conf["N"] = 1000
    write(os.path.join(bench, "configs", "tiny_cloud_1e3.json"), conf)
    write(os.path.join(bench, "traffic", "tiny_tiles_one_step.json"),
          {"gravity": "exact", "steps": 1, "warmup_requests": 1,
           "traced_requests": 1, "checked_requests": 2})
    write(os.path.join(bench, "workloads", "tiny.extra.json"),
          read(os.path.join(bench, "workloads", "tiny.tiles.json")))
    with open(os.path.join(bench, "metrics", "requests_done.py"), "w") as f:
        f.write(METRIC)
    manifest = read(os.path.join(root, "BENCHMARK.json"))
    manifest["configs"].append({"name": "tiny_cloud_1e3", "source": "tiny_cloud at N = 1 000",
                                "file": "benchmark/configs/tiny_cloud_1e3.json", "reduced": ["N"],
                                "why": "the discovery test"})
    manifest["workloads"].append({"name": "tiny.extra", "config": "tiny_cloud_1e3",
                                  "traffic": "tiny_tiles_one_step", "chips": 1, "why": "added"})
    for m in manifest["end_to_end"]:
        if "tiny.tiles" in m.get("workloads", []):
            m["workloads"].append("tiny.extra")
    manifest["end_to_end"].append({"name": "requests_done", "unit": "count", "better": "higher",
                                   "bound": 0.25, "source": "host_clock",
                                   "workloads": ["tiny.extra"]})
    write(os.path.join(root, "BENCHMARK.json"), manifest)
    code = ("import sys, time, json; t = time.perf_counter(); sys.path[:0] = [%r, %r];"
            "from benchmark import harness;"
            "print(json.dumps(harness.execute(%r, 'tiny.extra', 5, 0.01, False, device='cpu',"
            " t_start=t)))" % (root, ROOT, root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["metrics"]["requests_done"]["value"] >= 1
    assert set(result["metrics"]) == {"requests_done", "particle_steps_per_s", "setup_s"}
    # every file that was there is as it was, but the manifest's new entries
    after = digests(root)
    before.pop("BENCHMARK.json")
    assert {k: after[k] for k in before} == before


def test_a_multilevel_config_is_picked_as_the_run_loop_picks_it(monkeypatch):
    """A cell whose plan is the multi-level engine needs no new code: the
    pick refreshes the cached spec's strip lists (`mlevel_args_still_ok`,
    as `run_simulation`'s pick does) and plans afresh where that declines."""
    import numpy as np
    import torch

    import sphtpu_torch.physics.mlevel as mlevel
    from benchmark.request import Request
    from sphtpu_torch.engine.config import EngineConfig

    cfg = EngineConfig(n=4, kh=2, eos="polytropic", mlevel=("spec",))
    seen = []
    monkeypatch.setattr(mlevel, "mlevel_args_still_ok",
                        lambda pos, h, spec: seen.append(spec) or "strip lists")
    req = Request.__new__(Request)
    req.cfg, req.h_host, req.replans = cfg, np.ones(4), 0
    req.replan = lambda pos, h: ("a fresh plan", None)
    state = type("S", (), {"pos": torch.zeros(4, 3)})()
    assert req.pick(state) == (cfg, "strip lists") and seen == [("spec",)]
    assert req.replans == 0
    monkeypatch.setattr(mlevel, "mlevel_args_still_ok", lambda pos, h, spec: None)
    assert req.pick(state) == ("a fresh plan", None) and req.replans == 1
