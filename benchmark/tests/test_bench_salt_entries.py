"""The `salt_ms` entries of BENCHMARK.json (the zk blinding stream's
threefry draws, span `blinding.draw`): each loads the salt_ms.py reader
in the cell it lists, and the four-caller entry reads like the other two."""

import json
import os

import pytest

from conftest import ROOT
from harness import spec
from harness.cell import Run
from harness.window import Marks, Request

from qzk_tpu_torch.utils import spans

# name, layer, the end-to-end metric it moves, the cell it lists
SALT_ENTRIES = [
    ("salt_ms.one_caller", "zk blinding", "prove_p95_ms", "wormhole_zk.one_caller"),
    ("salt_ms.four_callers", "zk blinding", "proofs_per_s", "wormhole_zk.four_callers"),
    ("salt_ms.agg", "zk blinding", "agg_leaves_per_s", "agg_2x3.one_card"),
]


class _Clock:
    """perf_counter that advances by one millisecond a reading."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        self.t += 1e-3
        return self.t


def _run(requests):
    return Run(setup_s=1.0, window_s=1.0, requests=requests, leaves_per_request=1, cards=1,
               trace=None, traced_proofs=0, traced_work=None, rates=None)


def _registered():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return [m for m in bench["per_layer"] if m["name"].split(".")[0] == "salt_ms"]


def test_each_registered_salt_entry_loads_the_salt_reader():
    """Each salt_ms entry of BENCHMARK.json loads, in the one cell it
    lists, with salt_ms.py, under its layer and end-to-end metric."""
    salts = _registered()
    expected = {e[0]: e for e in SALT_ENTRIES}
    assert sorted(m["name"] for m in salts) == sorted(expected)
    for m in salts:
        _, layer, moves, cell = expected[m["name"]]
        assert (m["layer"], m["moves"], m["workloads"]) == (layer, moves, [cell])
        assert (m["unit"], m["better"], m["source"]) == ("ms", "lower", "program_span")
        loaded = {x.name: x for x in spec.load_cell(ROOT, cell).per_layer}
        assert os.path.basename(loaded[m["name"]].reader.__file__) == "salt_ms.py"
        assert callable(loaded[m["name"]].reader.read)


@pytest.mark.parametrize("name", [e[0] for e in SALT_ENTRIES])
def test_a_salt_entry_sums_the_draws_of_a_prove(monkeypatch, name):
    """Three draws of 1 ms each a prove read 3 ms; a request with no draw
    span, or no marks at all, reads nothing."""
    monkeypatch.setattr(spans, "time", _Clock())
    reader = spec.load_reader(name)
    reqs = []
    for seq in range(2):
        m = Marks()
        with spans.span("prove", timer=m):
            for _ in range(3):
                with spans.span("blinding.draw"):
                    pass
        reqs.append(Request(caller=seq % 2, seq=seq, sent=0.0, done=1.0, marks=m))
    assert reader.read(_run(reqs)) == pytest.approx(3.0)
    bare = Marks()
    with spans.span("prove", timer=bare):
        pass
    assert reader.read(_run([Request(caller=0, seq=0, sent=0.0, done=1.0, marks=bare),
                             Request(caller=0, seq=1, sent=0.0, done=1.0, marks=None)])) is None
