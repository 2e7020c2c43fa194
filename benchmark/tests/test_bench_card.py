"""On CUDA cards (`-m card`): the control of each cell, read at the
cell's own size, must come out not correct.

The configurations state no precision; the control breaks one guarantee
they state, 100-bit soundness, in the way a faster prover would be
tempted to: the same circuit proved with 1 proof-of-work bit in place of
16 (for the aggregation cells, the leaves and so every level of the
tree).  Its circuits go to a cache directory of their own: the program
keys its chunk circuits by the leaf circuit's digest, which does not
change with the proof-of-work bits, so a cache that holds the cell's own
chunk circuits would hand them to the control's leaves.  Each seed's
compared numbers are printed as one JSON line (run with -s to keep
them)."""

import json
import os
import time

import pytest

from conftest import ROOT
from harness import cell as cell_mod
from harness import spec

CONTROL_SEEDS = (1_000_003, 2_000_003, 3_000_017)


def run_seconds() -> int:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)["run_seconds"]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["wormhole_zk.one_caller", "wormhole_zk.four_callers",
                                      "agg_2x3.one_card"])
def test_control_is_not_correct(cards, workload, monkeypatch):
    cell = spec.load_cell(ROOT, workload)
    if cards < cell.chips:
        pytest.skip(f"{workload} needs {cell.chips} cards")
    cache = os.path.join(ROOT, "benchmark", ".cache", "control")
    monkeypatch.setenv("QZK_CIRCUIT_CACHE_DIR", os.path.join(cache, "circuits"))
    cell.config = {**cell.config, "circuit": {**cell.config["circuit"], "proof_of_work_bits": 1}}
    for seed in CONTROL_SEEDS:
        result, _, _ = cell_mod.run_cell(cell, seed, run_seconds(), False, time.perf_counter(),
                                      cache)
        print(json.dumps({"control": workload, "seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"], "checks": result["checks"]}),
              flush=True)
        assert result["correct"] is False
