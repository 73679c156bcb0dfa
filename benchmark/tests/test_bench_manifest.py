"""BENCHMARK.json against the benchmark's rules, and the files it names."""

import ast
import os

from benchmark import compare, manifest

from .conftest import BENCH, ROOT

KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_manifest_follows_the_rules():
    m = manifest.load(ROOT)
    assert manifest.problems(m, ROOT) == []
    assert set(m) == KEYS["top"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m[kind]:
            assert set(e) <= KEYS[kind], (kind, e["name"])
    assert m["paths"] == ["benchmark"] and m["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= m["run_seconds"] <= 51
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25, e["name"]
    assert all(w["chips"] == 1 for w in m["workloads"])


def test_every_cell_reports_what_its_metrics_move():
    m = manifest.load(ROOT)
    e2e = {e["name"]: e for e in m["end_to_end"]}
    for w in m["workloads"]:
        cell = manifest.Cell(ROOT, w["name"])
        reported = {e["name"] for e in cell.metrics("end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        layers = cell.metrics("per_layer")
        assert layers, w["name"]
        for p in layers:
            assert p["moves"] in reported, (w["name"], p["name"])
            assert w["name"] in e2e[p["moves"]].get("workloads", [w["name"]])


def test_every_name_has_its_files():
    m = manifest.load(ROOT)
    for w in m["workloads"]:
        cell = manifest.Cell(ROOT, w["name"])
        assert set(cell.spec["limits"]) <= set(compare.NAMES)
        assert cell.spec["limits"], w["name"]
        assert cell.traffic["gravity"] in ("auto", "exact", "p3m")
        assert cell.traffic["steps"] == "ML_SUBCHUNK" or int(cell.traffic["steps"]) >= 1
        assert os.path.exists(os.path.join(BENCH, "scenes", cell.config["scene"] + ".py"))
    for e in m["end_to_end"] + m["per_layer"]:
        path = os.path.join(BENCH, "metrics", e["name"] + ".py")
        tree = ast.parse(open(path).read())
        assert any(isinstance(n, ast.FunctionDef) and n.name == "read" for n in tree.body), path


def test_layers_are_named_alike():
    m = manifest.load(ROOT)
    layers = {p["layer"] for p in m["per_layer"]}
    assert layers == {"run loop", "run-loop planner", "chunk and step", "engine glue", "kernels",
                      "device", "fallback"}


def test_names_and_units_are_refused_where_they_break_the_rules():
    m = manifest.load(ROOT)
    bad = dict(m)
    bad["per_layer"] = [dict(m["per_layer"][0], name="has space", unit="tokens per second")]
    found = manifest.problems(bad, ROOT)
    assert any("bad name" in p for p in found) and any("bad unit" in p for p in found)
    bad["per_layer"] = [dict(m["per_layer"][0], moves="setup_s", workloads=["no.such.cell"])]
    assert any("unknown cell" in p for p in manifest.problems(bad, ROOT))


def test_setup_s_is_reported_in_every_cell():
    m = manifest.load(ROOT)
    setup = [e for e in m["end_to_end"] if e["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    bad = dict(m, end_to_end=[dict(e, workloads=[m["workloads"][0]["name"]])
                              if e["name"] == "setup_s" else e for e in m["end_to_end"]])
    assert any("setup_s: a workloads list" in p for p in manifest.problems(bad, ROOT))
