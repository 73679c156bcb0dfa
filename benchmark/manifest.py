"""BENCHMARK.json and the files it names, found by name.

A cell `<cell>` of `workloads` reads `workloads/<cell>.json` (its limits for
`correct`), its configuration `configs/<config>.json` (through the
`configs` entry's `file`) and its traffic `traffic/<traffic>.json`; a
metric `<metric>` is read by `metrics/<metric>.py`. Adding a configuration,
a cell or a metric is adding those files and the manifest's entries.
"""

from __future__ import annotations

import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
FOLDER = os.path.basename(HERE)  # the benchmark's folder under a checkout's root
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench_dir(root: str) -> str:
    """The benchmark's folder in the checkout at `root`."""
    return os.path.join(root, FOLDER)


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of `workloads` with everything it names."""

    def __init__(self, root: str, name: str):
        self.root = root
        self.manifest = load(root)
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = read_json(os.path.join(root, self.config_entry["file"]))
        here = bench_dir(root)
        self.traffic = read_json(os.path.join(here, "traffic", self.entry["traffic"] + ".json"))
        self.spec = read_json(os.path.join(here, "workloads", name + ".json"))

    def metrics(self, kind: str) -> list:
        """The `end_to_end` or `per_layer` entries this cell reports."""
        return [m for m in self.manifest[kind]
                if "workloads" not in m or self.name in m["workloads"]]


def problems(manifest: dict, root: str) -> list:
    """What in the manifest breaks the benchmark's rules, as sentences."""
    out = []
    names = set()
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[kind]:
            if not NAME.match(e["name"]):
                out.append(f"bad name {e['name']!r}")
            if e["name"] in names:
                out.append(f"name {e['name']!r} used twice")
            names.add(e["name"])
    cells = {w["name"]: w for w in manifest["workloads"]}
    for w in manifest["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                out.append(f"cell {w['name']}: bad {key} {w[key]!r}")
        if w["chips"] not in (1, 4):
            out.append(f"cell {w['name']}: chips {w['chips']}")
    for c in manifest["configs"]:
        if not os.path.exists(os.path.join(root, c["file"])):
            out.append(f"config {c['name']}: no file {c['file']}")
        for key in c["reduced"]:
            if not NAME.match(key):
                out.append(f"config {c['name']}: bad reduced key {key!r}")
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if not UNIT.match(m["unit"]):
            out.append(f"metric {m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"metric {m['name']}: better {m['better']!r}")
        if m["source"] not in SOURCES:
            out.append(f"metric {m['name']}: source {m['source']!r}")
        for cell in m.get("workloads", []):
            if cell not in cells:
                out.append(f"metric {m['name']}: unknown cell {cell!r}")
    for m in manifest["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"metric {m['name']}: an end-to-end metric from {m['source']}")
        if m["name"] == "setup_s":
            if "workloads" in m:
                out.append("metric setup_s: a workloads list (every cell reports it)")
        elif "workloads" not in m:
            out.append(f"metric {m['name']}: no workloads list")
    for m in manifest["per_layer"]:
        moved = e2e.get(m["moves"])
        if moved is None:
            out.append(f"metric {m['name']}: moves unknown {m['moves']!r}")
            continue
        for cell in m.get("workloads", list(cells)):
            if "workloads" in moved and cell not in moved["workloads"]:
                out.append(f"metric {m['name']}: cell {cell} does not report {m['moves']}")
    for w in manifest["workloads"]:
        reported = [m for m in manifest["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        if len(reported) < 2:
            out.append(f"cell {w['name']}: fewer than two end-to-end metrics")
        if not any(w["name"] in m.get("workloads", [w["name"]]) for m in manifest["per_layer"]):
            out.append(f"cell {w['name']}: no per-layer metric")
    return out
