"""What one cell of BENCHMARK.json asks for, found by name in files:
the configuration's file (its `file` entry), the traffic mix
(benchmark/traffic/<traffic>.json), the runner that runs the
configuration's kind (benchmark/runners/<runner>.py, named by the
configuration file) and each metric's reader (benchmark/metrics/<name>.py,
or the file of the name's first dotted parts: `reader_path`).
Adding a cell, a mix or a metric adds files and entries; nothing here
changes."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Metric:
    name: str
    unit: str
    reader: object  # the module of reader_path(name)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    runner: object  # the module benchmark/runners/<runner>.py
    end_to_end: list
    per_layer: list


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader_path(name: str) -> str:
    """benchmark/metrics/<name>.py, else the reader of the name with its
    last dotted part taken off (idle_share.one_caller -> idle_share.py),
    so that one reader serves each kind of reading."""
    base = name
    while True:
        path = os.path.join(BENCH_DIR, "metrics", f"{base}.py")
        if os.path.exists(path) or "." not in base:
            return path
        base = base.rsplit(".", 1)[0]


def load_reader(name: str):
    return load_module(reader_path(name), f"bench_metric_{name.replace('.', '_')}")


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, workload: str) -> Cell:
    """The cell named `workload` of <root>/BENCHMARK.json and its files."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = _read_json(os.path.join(root, cfg_entry["file"]))
    traffic = _read_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    runner = load_module(os.path.join(BENCH_DIR, "runners", f"{config['runner']}.py"),
                         f"bench_runner_{config['runner']}")

    def metric(m):
        return Metric(m["name"], m["unit"], load_reader(m["name"]))

    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                runner=runner, end_to_end=[metric(m) for m in e2e],
                per_layer=[metric(m) for m in per_layer])
