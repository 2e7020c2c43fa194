"""The 7x2 aggregation configuration (configs/agg_7x2.json) and its cell
agg_7x2.one_card_49: the keys are the JAX package's builds and read as
two chunk circuits of 2^17 rows, a pool of 64 gives batches of 49
distinct leaves, the cell loads its six per-layer metrics, and
`fill_ms` (metrics/fill_ms.py) reads the mean of the span
`aggregation.fill` per chunk prove, and nothing without it.  On CUDA
cards (`-m card`), the cell's control must come out not correct."""

import hashlib
import json
import os

import pytest

import test_bench_card
from conftest import ROOT
from harness import spec, traffic
from harness.cell import Run
from harness.window import Marks, Request
from reference import formats

from qzk_tpu_torch.utils import spans

CELL = "agg_7x2.one_card_49"
# The sha256 of the key bytes (common, verifier) that the JAX package
# builds for the two chunk circuits of its (7, 2) tree
# (qzk_tpu.models.wormhole.aggregator.build_chunk_circuit over the zk
# Wormhole leaf's common data, then over the level-1 chunk's, written by
# qzk_tpu.utils.serialization's common_to_bytes and
# verifier_only_to_bytes); the leaf's are agg_2x3's.
JAX_KEY_SHA256 = {
    "wormhole": ("d961baf32e54d2b72defb5c9f68f61130d91148bcd66f960474b60cdc616e532",
                 "92a22c05785a71f8a351aecb1f02204af0b6574062b7a9f2828476f1da234f73"),
    "level1": ("b9d5781d15534295c490dc04ffa1dc91dd6b1d4e4fa253c5e9f622ba25eaf47f",
               "718dc99bd94d021bc62af7e2226708354870eb9b1bfd35c4aef916cb17b0b6ad"),
    "level2": ("651a64088e896dcbb16ba946893f226a42b0019826adc076f07c82bbab9eebce",
               "19c6af8e6a8c235fd0a40bb4918e788bbb8804059b6b655ea0d45b4f29f08c7f"),
}


def config() -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", "agg_7x2.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(JAX_KEY_SHA256))
def test_keys_are_the_jax_packages(name):
    k = config()["keys"][name]
    assert (hashlib.sha256(bytes.fromhex(k["common"])).hexdigest(),
            hashlib.sha256(bytes.fromhex(k["verifier"])).hexdigest()) == JAX_KEY_SHA256[name]


def test_the_configuration_is_the_7x2_tree_at_published_widths():
    c = config()
    with open(os.path.join(ROOT, "benchmark", "configs", "agg_2x3.json")) as f:
        default = json.load(f)
    assert c["tree"] == {"branching": 7, "depth": 2} and c["runner"] == "aggregation"
    assert c["circuit"] == default["circuit"] and c["keys"]["wormhole"] == default["keys"]["wormhole"]
    for lv, pis in (("level1", 7 * 16), ("level2", 49 * 16)):
        lc = formats.read_common(bytes.fromhex(c["keys"][lv]["common"]))
        assert (lc.degree_bits, lc.lde_bits, lc.num_public_inputs, lc.num_wires,
                lc.zero_knowledge) == (c["chunk_degree_bits"], 20, pis, 135, True)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        entry = next(e for e in json.load(f)["configs"] if e["name"] == "agg_7x2")
    assert entry["reduced"] == [] and entry["file"] == "benchmark/configs/agg_7x2.json"


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 5303535991])
def test_a_pool_of_64_gives_49_distinct_leaves_a_batch(seed):
    rng = traffic.rng_of(seed)
    bs = traffic.batches(rng, 64, 49, 200)
    assert all(len(b) == 49 and len(set(b)) == 49 and all(0 <= i < 64 for i in b) for b in bs)
    assert len({tuple(b) for b in bs}) == 200
    assert bs == traffic.batches(traffic.rng_of(seed), 64, 49, 200)


def test_the_cell_loads_its_metrics():
    cell = spec.load_cell(ROOT, CELL)
    assert cell.chips == 1 and cell.traffic["leaf_pool"] == 64 and cell.traffic["callers"] == 1
    assert [m.name for m in cell.end_to_end] == ["agg_leaves_per_s", "setup_s"]
    readers = {m.name: os.path.basename(m.reader.__file__) for m in cell.per_layer}
    assert readers == {"witness_ms.agg_7x2": "witness_ms.py", "fused_ms.agg_7x2": "fused_ms.py",
                       "generators_ms.agg_7x2": "generators_ms.py",
                       "idle_share.agg_7x2": "idle_share.py",
                       "poseidon_roofline.agg_7x2": "poseidon_roofline.py",
                       "fill_ms.agg_7x2": "fill_ms.py"}


class _Clock:
    """perf_counter that advances by one millisecond a reading."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        self.t += 1e-3
        return self.t


def _run(requests):
    return Run(setup_s=1.0, window_s=1.0, requests=requests, leaves_per_request=49, cards=1,
               trace=None, traced_proofs=0, traced_work=None, rates=None)


def test_fill_ms_reads_the_mean_fill_per_chunk_prove(monkeypatch):
    """Two requests of a root each: eight chunk proves, each fill 4 ms
    and 6 ms in turn (with its end reading), one prove with no fill (a
    chunk filled inside its prove would still count): 40 ms over 9."""
    clock = _Clock()
    monkeypatch.setattr(spans, "time", clock)
    reqs = []
    for seq in range(2):
        m = Marks()
        with spans.span("aggregate", timer=m):
            for chunk in range(4):
                with spans.span("aggregation.fill", attrs={"children": 7}):
                    clock.t += 0.003 if chunk % 2 == 0 else 0.005
                with spans.span("aggregation.chunk", level=1, chunk=chunk):
                    with spans.span("prove"):
                        pass
            if seq == 1:
                with spans.span("prove"):
                    pass
        reqs.append(Request(caller=0, seq=seq, sent=0.0, done=1.0, marks=m))
    reader = spec.load_reader("fill_ms.agg_7x2")
    assert reader.read(_run(reqs)) == pytest.approx(40.0 / 9)


def test_fill_ms_reads_nothing_without_its_span(monkeypatch):
    monkeypatch.setattr(spans, "time", _Clock())
    m = Marks()
    with spans.span("aggregate", timer=m):
        with spans.span("prove"):
            pass
    reader = spec.load_reader("fill_ms.agg_7x2")
    assert reader.read(_run([Request(caller=0, seq=0, sent=0.0, done=1.0, marks=m)])) is None
    assert reader.read(_run([Request(caller=0, seq=0, sent=0.0, done=1.0, marks=None)])) is None
    assert reader.read(_run([])) is None


@pytest.mark.card
def test_control_is_not_correct(cards, monkeypatch):
    test_bench_card.test_control_is_not_correct(cards, CELL, monkeypatch)
