"""The 7x2 aggregation tree (TreeAggregationConfig.new(7, 2): 49 leaves,
7 chunk proves at level 1, the root at level 2) on the one-card walk
(aggregator._walk), on the CPU.

On stubbed fronts and device parts: the chunks prove in tree order, the
root's front is begun only once all seven level-1 chunks are proved, and
six fronts (level-1 chunks 1 to 6) are prefetched during the chunk
before.

On a real tree of 49 leaves, each one of 7 small zk proofs (chunk
circuits that take the child proofs' targets and re-export their public
inputs without the in-circuit verifier, whose CPU prove takes minutes):
the root carries the 49 leaves' public inputs in order, equals byte for
byte the root of the path that fills and proves each chunk in place, and
the benchmark's plain numpy verifier (benchmark/reference/) accepts it
under its key; the request
holds each chunk's `children` (7) and `degree_bits` and each fill's
`children` and `values`.  A context build is the span "device.context"
with its `degree_bits` and `evicted`.

The port's branching-7 chunk circuit over the zk Wormhole leaf has the
key bytes of benchmark/configs/agg_7x2.json's `level1` (a host build of
about a minute)."""

import hashlib
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from qzk_tpu_torch.models.wormhole import aggregator as tagg
from qzk_tpu_torch.models.wormhole.aggregator import TreeAggregationConfig, aggregate_to_tree
from qzk_tpu_torch.plonk import device_prover as dp
from qzk_tpu_torch.utils import serialization as tser
from qzk_tpu_torch.utils import spans
from test_torch_agg_prefetch import CPU, Recorder, StubTree, _helpers_alive, _reexport_circuit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "benchmark")
if BENCH_DIR not in sys.path:
    sys.path.append(BENCH_DIR)
from reference import formats, verify  # noqa: E402

TREE_7X2 = [(1, i) for i in range(7)] + [(2, 0)]
# the chunks whose front the walk begins during the previous chunk's
# device part: every one but the first and the root
PREFETCHED = set(TREE_7X2) - {(1, 0), (2, 0)}
SQUARES = 49
VALUES = range(2, 9)
LEAF_PROOF = [(i + i // 7) % 7 for i in range(SQUARES)]  # leaf -> proof of VALUES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _one_worker(monkeypatch):
    monkeypatch.delenv("QZK_AGG_WORKERS", raising=False)


def _stub_tree(timer=None):
    return aggregate_to_tree(list(range(SQUARES)), "common0", "vo0",
                             TreeAggregationConfig.new(7, 2), device="cpu", timer=timer)


def test_the_root_front_waits_for_all_seven_and_six_are_prefetched(monkeypatch):
    """Each device part waits for the next chunk's front to end, so a
    prefetched front is done when asked for: `ready` reads 1 for level-1
    chunks 1 to 6 and 0 for the first chunk and the root."""
    front_done = {key: threading.Event() for key in TREE_7X2}
    after = dict(zip(TREE_7X2, TREE_7X2[1:]))

    def on_prove(key):
        if after.get(key) in PREFETCHED:
            assert front_done[after[key]].wait(20)
            time.sleep(0.05)  # the helper hands the front to its future

    tree = StubTree(monkeypatch, on_prove=on_prove)
    original = tree.front

    def front(circuit, chunk, verifier_only):
        out = original(circuit, chunk, verifier_only)
        front_done[out[1]].set()
        return out

    monkeypatch.setattr(tagg, "_chunk_front", front)
    timer = Recorder()
    root = _stub_tree(timer)
    assert root.proof == ("p", 2, 0) and root.circuit_data.common == "common2"
    assert tree.events("prove") == TREE_7X2 and tree.events("prove_end") == TREE_7X2
    assert sorted(tree.events("front")) == TREE_7X2
    for i in range(7):
        assert tree.index("prove_end", (1, i)) < tree.index("front", (2, 0))
    assert timer.marks == ["witness"] * 8
    recorded = spans.spans_of(timer)
    waits = [s for s in recorded if s.name == "aggregation.prefetch_wait"]
    assert [(s.parent.attrs["level"], s.parent.attrs["chunk"]) for s in waits] == TREE_7X2
    assert [s.attrs["ready"] for s in waits] == [int(k in PREFETCHED) for k in TREE_7X2]
    levels = [s for s in recorded if s.name == "aggregation.level"]
    assert [(s.attrs["level"], s.attrs["chunks"]) for s in levels] == [(1, 7), (2, 1)]
    assert not _helpers_alive()


# -- a real tree of 49 small zk leaves -----------------------------------------


@pytest.fixture(scope="module")
def square_leaves():
    """(leaf circuit data, 49 leaves of 7 proofs of x * x for x = 2 .. 8:
    chunk j holds the seven rotated by j, so that a swap of two leaves or
    of two chunks changes the root's public inputs)."""
    import qzk_tpu_torch.plonk.builder as tbuilder
    import qzk_tpu_torch.plonk.witness as twitness
    from test_torch_agg_prefetch import CONFIG, _cheap_pow

    builder = tbuilder.CircuitBuilder(CONFIG)
    x = builder.add_virtual_target()
    builder.register_public_input(builder.mul(x, x))
    data = builder.build()
    _cheap_pow(data)
    proofs = []
    for v in VALUES:
        pw = twitness.PartialWitness()
        pw.set_target(x, v)
        proofs.append(data.prove(pw, device=CPU))
    return data, [proofs[i] for i in LEAF_PROOF]


@pytest.fixture(scope="module")
def walked(square_leaves):
    """The walk's root over the 49 leaves (a request with a timer), the
    in-place path's root, the spans of the request, and the build used."""
    data, leaves = square_leaves
    circuits = {}

    def build(common, size):
        key = (bytes(np.asarray(common.circuit_digest).tobytes()), size)
        if key not in circuits:
            circuits[key] = _reexport_circuit(common, size)
        return circuits[key]

    mp = pytest.MonkeyPatch()
    mp.setattr(tagg, "build_chunk_circuit", build)
    mp.delenv("QZK_AGG_WORKERS", raising=False)
    try:
        timer = Recorder()
        root = aggregate_to_tree(leaves, data.common, data.verifier_only,
                                 TreeAggregationConfig.new(7, 2), device="cpu", timer=timer)
        assert not _helpers_alive()
        level1 = [tagg._prove_chunk(build(data.common, 7), leaves[i : i + 7],
                                    data.verifier_only, "cpu") for i in range(0, SQUARES, 7)]
        c1 = level1[0].circuit_data
        in_place = tagg._prove_chunk(build(c1.common, 7), [p.proof for p in level1],
                                     c1.verifier_only, "cpu")
    finally:
        mp.undo()
    return root, in_place, spans.spans_of(timer), timer


def test_root_carries_the_49_leaves_in_order_and_equals_the_in_place_path(square_leaves,
                                                                           walked):
    _, leaves = square_leaves
    root, in_place, _, timer = walked
    want = np.concatenate([np.asarray(p.public_inputs, dtype=np.uint64) for p in leaves])
    assert np.array_equal(want, [VALUES[k] ** 2 for k in LEAF_PROOF])
    assert np.array_equal(np.asarray(root.proof.public_inputs, dtype=np.uint64), want)
    assert (hashlib.sha256(root.proof.to_bytes()).digest()
            == hashlib.sha256(in_place.proof.to_bytes()).digest())
    root.circuit_data.verify(root.proof)
    assert timer.marks.count("witness") == 8


def test_the_numpy_reference_accepts_the_root_and_refuses_a_flip(walked):
    root, _, _, _ = walked
    data = root.circuit_data
    c = formats.read_common(tser.common_to_bytes(data.common))
    vk = formats.read_verifier(tser.verifier_only_to_bytes(data.verifier_only))
    blob = root.proof.to_bytes()
    good = formats.read_proof(blob, c)
    assert good.public_inputs.shape == (SQUARES,)
    bad = bytearray(blob)
    bad[len(blob) // 2] ^= 1
    assert verify.verify_batch(c, vk, [good, formats.read_proof(bytes(bad), c)])[0] is None
    assert verify.verify_batch(c, vk, [formats.read_proof(bytes(bad), c)])[0] is not None


def test_the_request_holds_each_chunks_children_and_degree(walked):
    root, _, recorded, _ = walked
    chunks = [s for s in recorded if s.name == "aggregation.chunk"]
    assert [(s.attrs["level"], s.attrs["chunk"]) for s in chunks] == TREE_7X2
    assert {s.attrs["children"] for s in chunks} == {7}
    assert chunks[-1].attrs["degree_bits"] == root.circuit_data.common.degree_bits
    assert all(s.attrs["degree_bits"] >= 2 for s in chunks)
    fills = [s for s in recorded if s.name == "aggregation.fill"]
    assert len(fills) == 8 and {s.attrs["children"] for s in fills} == {7}
    assert {s.parent.name for s in fills} == {"aggregation.prefetch"}
    # a child proof sets its public input and the targets of its proof
    assert all(s.attrs["values"] > 7 for s in fills)
    prefetched = [s.attrs["ready"] for s in recorded if s.name == "aggregation.prefetch_wait"]
    assert len(prefetched) == 8 and prefetched[0] == prefetched[-1] == 0


def test_a_context_build_is_a_span_with_its_degree_and_evictions(monkeypatch, square_leaves):
    """With room for one context, building a second evicts the first:
    the request's "device.context" spans read `evicted` 0 then 1, and
    `degree_bits` of each circuit; no `bytes` off a card."""
    data, _ = square_leaves
    other = _reexport_circuit(data.common, 1).data
    monkeypatch.setenv("QZK_CTX_LIMIT", "1")
    monkeypatch.setattr(dp, "_CTX_LRU", [])
    for d in (data, other):
        d.prover_only._torch_ctxs = {}
    timer = Recorder()
    with spans.span("request", timer=timer):
        dp.get_context(data.common, data.prover_only, CPU)
        dp.get_context(other.common, other.prover_only, CPU)
        dp.get_context(other.common, other.prover_only, CPU)  # resident: no build
    built = [s for s in spans.spans_of(timer) if s.name == "device.context"]
    assert [s.attrs for s in built] == [
        {"degree_bits": data.common.degree_bits, "evicted": 0},
        {"degree_bits": other.common.degree_bits, "evicted": 1}]
    assert data.prover_only._torch_ctxs == {}


def test_branching_7_chunk_over_the_zk_wormhole_has_the_configs_level1_key(monkeypatch):
    """The level-1 chunk circuit built from the leaf's common bytes (no
    leaf build) gives the configuration's level1 key bytes."""
    with open(os.path.join(BENCH_DIR, "configs", "agg_7x2.json")) as f:
        keys = json.load(f)["keys"]
    leaf = tser.common_from_bytes(bytes.fromhex(keys["wormhole"]["common"]))
    monkeypatch.setenv("QZK_CIRCUIT_CACHE_DIR", "")
    chunk = tagg._build_chunk_circuit_uncached(leaf, 7)
    assert chunk.data.common.degree_bits == 17
    assert chunk.data.common.num_public_inputs == 7 * 16
    assert tser.common_to_bytes(chunk.data.common).hex() == keys["level1"]["common"]
    assert tser.verifier_only_to_bytes(chunk.data.verifier_only).hex() == \
        keys["level1"]["verifier"]
