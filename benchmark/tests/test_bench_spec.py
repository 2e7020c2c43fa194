"""BENCHMARK.json against the benchmark's contract, and the harness
finding each configuration, traffic mix, runner and metric by name."""

import json
import os
import re

import pytest

from conftest import BENCH_DIR, ROOT
from harness import spec

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.fullmatch(n) for n in names)
    assert len(set(CELLS)) == len(CELLS)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    for text in ([c["why"] for c in BENCH["configs"]] + [c["source"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    c = spec.load_cell(ROOT, cell)
    e2e = [m.name for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        entry = next(e for e in BENCH["per_layer"] if e["name"] == m.name)
        assert entry["moves"] in e2e
    assert c.runner.Runner and c.traffic and c.config["runner"]


def test_every_metric_has_a_reader_and_every_mix_a_file():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.load_reader(m["name"]).read)
    for w in BENCH["workloads"]:
        assert os.path.exists(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))


def test_layers_name_modules_of_the_port_in_perf_md():
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for layer in {m["layer"] for m in BENCH["per_layer"]}:
        assert layer in perf


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell(ROOT, "no_such.cell")


def test_a_cell_is_found_from_files_alone(tmp_path):
    """A cell added as entries and files: the harness reads its mix and
    metric by name, with no code changed."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "wormhole_zk.probe", "config": "wormhole_zk",
                               "traffic": "one_caller", "chips": 1, "why": "probe"})
    bench["end_to_end"][0]["workloads"].append("wormhole_zk.probe")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in bench["configs"]:
        os.makedirs(tmp_path / os.path.dirname(c["file"]), exist_ok=True)
        (tmp_path / c["file"]).write_text(open(os.path.join(ROOT, c["file"])).read())
    cell = spec.load_cell(str(tmp_path), "wormhole_zk.probe")
    assert [m.name for m in cell.end_to_end] == [bench["end_to_end"][0]["name"], "setup_s"]
    assert cell.per_layer == [] and cell.traffic["callers"] == 1


def test_a_metric_falls_back_to_the_reader_of_its_kind():
    assert spec.reader_path("idle_share.one_caller") == os.path.join(
        BENCH_DIR, "metrics", "idle_share.py")
    assert spec.reader_path("idle_share.some.new_cell") == os.path.join(
        BENCH_DIR, "metrics", "idle_share.py")
    assert spec.reader_path("proofs_per_s") == os.path.join(BENCH_DIR, "metrics", "proofs_per_s.py")
    with pytest.raises(FileNotFoundError):
        spec.load_reader("no_such_kind.one_caller")
