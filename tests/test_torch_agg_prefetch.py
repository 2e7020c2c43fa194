"""The one-card walk over the aggregation tree (aggregator._walk): with
one worker a level, the chunks prove in tree order on the caller's
thread while the next chunk's host front (_chunk_front: fill,
generators, public inputs, blinding seed) runs on one helper thread.

On stubbed fronts and device parts (a 2x3 tree, 7 chunks):
- the front of chunk k+1 runs while chunk k's device part runs (a
  barrier that only the two together pass);
- no front starts before its children are proved, so the root's front
  waits for the last chunk of level 2;
- _prove_chunk is called, and returns, in tree order, on the caller's
  thread;
- an exception in a front or in a device part reaches the caller and
  leaves no helper thread alive;
- each chunk prove is one span "prove" and one "witness" mark, and the
  request holds each chunk's "aggregation.prefetch",
  "aggregation.prefetch_wait" (`ready`: 5 of 7) and the front's spans;
- a 2x5 tree keeps all of this with threads switched every microsecond;
- levels of more than one worker still fan out, the root level walked.

On a real tree of small zk proofs on the CPU (chunk circuits that take
the child proofs' targets and re-export their public inputs, without
the in-circuit verifier, whose CPU prove takes minutes): the walk's
root is the bytes of the sequential path that fills and proves each
chunk in place, and verifies."""

import hashlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

import qzk_tpu_torch.plonk.builder as tbuilder
import qzk_tpu_torch.plonk.config as tconfig
import qzk_tpu_torch.plonk.witness as twitness
from qzk_tpu_torch.models.wormhole import aggregator as tagg
from qzk_tpu_torch.models.wormhole.aggregator import TreeAggregationConfig, aggregate_to_tree
from qzk_tpu_torch.plonk import device_prover as dp
from qzk_tpu_torch.plonk import recursion as rec
from qzk_tpu_torch.utils import spans

CPU = torch.device("cpu")
TREE_2X3 = [(1, 0), (1, 1), (1, 2), (1, 3), (2, 0), (2, 1), (3, 0)]
# the chunks whose front the walk begins during the previous chunk's
# device part: every one but the first and the root
PREFETCHED = set(TREE_2X3) - {(1, 0), (3, 0)}


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


class Recorder:
    def __init__(self):
        self.marks = []

    def mark(self, name):
        self.marks.append(name)


class _Data:
    def __init__(self, level):
        self.common, self.verifier_only = f"common{level}", f"vo{level}"


def _helpers_alive() -> list:
    return [t for t in threading.enumerate() if t.name.startswith("qzk-prefetch")]


class StubTree:
    """Stubbed chunk circuits, fronts and device parts over a tree whose
    leaves are ints: chunk (level, i)'s proof is ("p", level, i).  Each
    front and device part logs its start and end; `on_front` and
    `on_prove` run inside them, given the chunk's (level, i)."""

    def __init__(self, monkeypatch, on_front=None, on_prove=None):
        self.log, self.threads = [], {}
        self.lock = threading.Lock()
        self.on_front = on_front or (lambda key: None)
        self.on_prove = on_prove or (lambda key: None)
        monkeypatch.setattr(tagg, "build_chunk_circuit",
                            lambda common, size: (int(common[-1]) + 1, size))
        monkeypatch.setattr(tagg, "_chunk_front", self.front)
        monkeypatch.setattr(tagg, "_prove_chunk", self.prove)

    def key(self, circuit, chunk):
        level = circuit[0]
        first = chunk[0] if level == 1 else chunk[0][2]
        return level, first // circuit[1]

    def record(self, event, key):
        with self.lock:
            self.log.append((event, key))
            self.threads.setdefault(event, set()).add(threading.current_thread().name)

    def front(self, circuit, chunk, verifier_only):
        key = self.key(circuit, chunk)
        self.record("front", key)
        with spans.span("witness.generators"):
            self.on_front(key)
        self.record("front_end", key)
        return ("front", key, tuple(chunk), verifier_only)

    def prove(self, circuit, chunk, verifier_only, device=None, timer=None, front=None):
        key = self.key(circuit, chunk)
        assert front == ("front", key, tuple(chunk), verifier_only)
        self.record("prove", key)
        with spans.span("prove", timer=timer, card=device) as phases:
            if phases is not None:
                phases.mark("witness")
            self.on_prove(key)
        self.record("prove_end", key)
        return tagg.AggregatedProof(proof=("p",) + key, circuit_data=_Data(key[0]))

    def events(self, name) -> list:
        return [key for event, key in self.log if event == name]

    def index(self, event, key) -> int:
        return self.log.index((event, key))


def _tree(timer=None):
    return aggregate_to_tree(list(range(8)), "common0", "vo0", TreeAggregationConfig.new(2, 3),
                             device="cpu", timer=timer)


def test_next_front_overlaps_the_device_part(monkeypatch):
    """Chunk k's device part and chunk k+1's front meet at a barrier:
    they pass it only if they run at once."""
    barriers = {key: threading.Barrier(2, timeout=20) for key in PREFETCHED}
    after = dict(zip(TREE_2X3, TREE_2X3[1:]))

    def on_front(key):
        if key in barriers:
            barriers[key].wait()

    def on_prove(key):
        if after.get(key) in barriers:
            barriers[after[key]].wait()

    tree = StubTree(monkeypatch, on_front, on_prove)
    root = _tree()
    assert root.proof == ("p", 3, 0)
    assert not any(b.broken for b in barriers.values())
    assert tree.threads["prove"] == {threading.current_thread().name}
    assert len(tree.threads["front"]) == 1
    assert tree.threads["front"] != tree.threads["prove"]
    assert not _helpers_alive()


def test_fronts_wait_for_their_children_and_proves_keep_tree_order(monkeypatch):
    tree = StubTree(monkeypatch)
    root = _tree()
    assert tree.events("prove") == TREE_2X3 and tree.events("prove_end") == TREE_2X3
    assert sorted(tree.events("front")) == TREE_2X3
    for level, i in TREE_2X3[4:]:
        for child in (2 * i, 2 * i + 1):
            assert tree.index("prove_end", (level - 1, child)) < tree.index("front", (level, i))
    # the root's front starts only once the last chunk of level 2 is proved
    assert tree.index("prove_end", (2, 1)) < tree.index("front", (3, 0))
    # one front in flight at a time, in tree order, each begun once
    # the chunk before it has its own
    for before, key in zip(TREE_2X3, TREE_2X3[1:]):
        assert tree.index("front_end", before) < tree.index("front", key)
    assert root.proof == ("p", 3, 0) and root.circuit_data.common == "common3"


@pytest.mark.parametrize("where", ["front", "prove"])
@pytest.mark.parametrize("key", [(1, 0), (1, 2), (2, 1), (3, 0)])
def test_a_failure_reaches_the_caller_and_no_helper_lives(monkeypatch, where, key):
    class Boom(Exception):
        pass

    def fail(at):
        if at == key:
            raise Boom(at)

    tree = StubTree(monkeypatch, **{f"on_{where}": fail})
    with pytest.raises(Boom) as raised:
        _tree(timer=Recorder())
    assert raised.value.args == (key,)
    assert not _helpers_alive()
    proved = tree.events("prove_end")
    assert proved == TREE_2X3[: TREE_2X3.index(key)]


def test_each_chunk_prove_marks_once_and_records_its_prefetch(monkeypatch):
    """The prefetched fronts are done before they are asked for (each
    device part waits for the next front's end), so `ready` reads 1 for
    the 5 chunks of 7 whose front ran during the chunk before."""
    front_done = {key: threading.Event() for key in TREE_2X3}
    after = dict(zip(TREE_2X3, TREE_2X3[1:]))

    def on_prove(key):
        if after.get(key) in PREFETCHED:
            assert front_done[after[key]].wait(20)
            time.sleep(0.05)  # the helper hands the front to its future

    tree = StubTree(monkeypatch, on_front=lambda key: None, on_prove=on_prove)
    original = tree.front

    def front(circuit, chunk, verifier_only):
        out = original(circuit, chunk, verifier_only)
        front_done[out[1]].set()
        return out

    monkeypatch.setattr(tagg, "_chunk_front", front)
    timer = Recorder()
    _tree(timer)
    assert timer.marks == ["witness"] * 7
    recorded = spans.spans_of(timer)
    root = recorded[0]
    assert root.name == "aggregate" and {s.request for s in recorded} == {root.request}
    by_name = {}
    for s in recorded:
        by_name.setdefault(s.name, []).append(s)
    assert len(by_name["prove"]) == 7
    assert [s.parent.name for s in by_name["prove"]] == ["aggregation.chunk"] * 7
    prefetch = by_name["aggregation.prefetch"]
    assert sorted((s.attrs["level"], s.attrs["chunk"]) for s in prefetch) == TREE_2X3
    assert all(s.parent is root for s in prefetch)
    assert [s.parent.name for s in by_name["witness.generators"]] == \
        ["aggregation.prefetch"] * 7
    waits = by_name["aggregation.prefetch_wait"]
    chunks = [s.parent for s in waits]
    assert [(c.name, c.attrs["level"], c.attrs["chunk"]) for c in chunks] == \
        [("aggregation.chunk",) + key for key in TREE_2X3]
    ready = [s.attrs["ready"] for s in waits]
    assert ready == [int(key in PREFETCHED) for key in TREE_2X3]
    assert sum(ready) == 5
    # each front ends before its chunk's wait does, and within the request
    for s, key in zip(waits, TREE_2X3):
        mine = next(p for p in prefetch if (p.attrs["level"], p.attrs["chunk"]) == key)
        assert root.start <= mine.start <= mine.end <= s.end <= root.end


def test_a_wide_tree_under_a_short_switch_interval(monkeypatch):
    """A 2x5 tree (31 chunks) three times with the interpreter switching
    threads every microsecond: every chunk proved once in tree order,
    and the request holds each chunk's spans once."""
    order = [(level, i) for level in range(1, 6) for i in range(2 ** (5 - level))]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            tree = StubTree(monkeypatch)
            timer = Recorder()
            root = aggregate_to_tree(list(range(32)), "common0", "vo0",
                                     TreeAggregationConfig.new(2, 5), device="cpu", timer=timer)
            assert root.proof == ("p", 5, 0)
            assert tree.events("prove_end") == order and sorted(tree.events("front")) == order
            names = [s.name for s in spans.spans_of(timer)]
            for name in ("prove", "aggregation.prefetch", "aggregation.prefetch_wait",
                         "witness.generators"):
                assert names.count(name) == 31, name
            assert timer.marks == ["witness"] * 31
    finally:
        sys.setswitchinterval(old)
    assert not _helpers_alive()


def test_the_fan_out_keeps_its_level_by_level_pool(monkeypatch):
    """With QZK_AGG_WORKERS=2 the levels of two or more chunks fan out
    (each chunk fills its own witness, no front is passed) and the root
    level, of one chunk, is walked."""
    monkeypatch.setenv("QZK_AGG_WORKERS", "2")
    tree = StubTree(monkeypatch)
    passed = []

    def prove(circuit, chunk, verifier_only, device=None, timer=None, front=None):
        passed.append((tree.key(circuit, chunk), front is not None))
        if front is None:
            front = tree.front(circuit, chunk, verifier_only)
        return tree.prove(circuit, chunk, verifier_only, device, timer, front)

    monkeypatch.setattr(tagg, "_prove_chunk", prove)
    root = _tree()
    assert root.proof == ("p", 3, 0)
    assert sorted(passed) == sorted((key, key == (3, 0)) for key in TREE_2X3)


# -- a real tree of small zk proofs ---------------------------------------------


# 4 PoW bits: the CPU's first PoW batch, cut to POW_BATCH candidates,
# holds a hit
CONFIG = tconfig.CircuitConfig(zero_knowledge=True,
                               fri_config=tconfig.FriConfig(proof_of_work_bits=4))
POW_BATCH = 1 << 6


def _cheap_pow(data):
    dp.get_context(data.common, data.prover_only, CPU).pow_batch = POW_BATCH


def _reexport_circuit(common, branching):
    """A chunk circuit with the recursion circuit's targets (verifier
    data, `branching` child proofs) that re-exports the children's
    public inputs without verifying them: the fill, the generators, the
    blinding and the prove of a chunk, at 4 rows."""
    builder = tbuilder.CircuitBuilder(common.config)
    vd_t = rec.add_virtual_verifier_data(builder, common.config.fri_config.cap_height)
    proof_ts = []
    for _ in range(branching):
        pt = rec.add_virtual_proof_with_pis(builder, common)
        builder.register_public_inputs(pt.public_inputs)
        proof_ts.append(pt)
    data = builder.build()
    _cheap_pow(data)
    return tagg._ChunkCircuit(data=data, verifier_data_target=vd_t, proof_targets=proof_ts)


@pytest.fixture(scope="module")
def small_leaves():
    """(leaf circuit data, four leaves of two distinct square proofs)."""
    builder = tbuilder.CircuitBuilder(CONFIG)
    x = builder.add_virtual_target()
    builder.register_public_input(builder.mul(x, x))
    data = builder.build()
    _cheap_pow(data)
    proofs = []
    for v in (5, 6):
        pw = twitness.PartialWitness()
        pw.set_target(x, v)
        proofs.append(data.prove(pw, device=CPU))
    return data, [proofs[0], proofs[1], proofs[1], proofs[0]]


def test_real_tree_root_equals_the_in_place_path(monkeypatch, small_leaves):
    data, leaves = small_leaves
    circuits = {}

    def build(common, size):
        key = (bytes(np.asarray(common.circuit_digest).tobytes()), size)
        if key not in circuits:
            circuits[key] = _reexport_circuit(common, size)
        return circuits[key]

    monkeypatch.setattr(tagg, "build_chunk_circuit", build)
    tree = TreeAggregationConfig.new(2, 2)
    timer = Recorder()
    root = aggregate_to_tree(leaves, data.common, data.verifier_only, tree, device="cpu",
                             timer=timer)

    # the sequential path: each chunk filled and proved in place
    proofs, common, vo = leaves, data.common, data.verifier_only
    while True:
        level = [tagg._prove_chunk(build(common, 2), proofs[i : i + 2], vo, "cpu")
                 for i in range(0, len(proofs), 2)]
        if len(level) == 1:
            break
        proofs = [p.proof for p in level]
        common, vo = level[0].circuit_data.common, level[0].circuit_data.verifier_only
    blob = root.proof.to_bytes()
    assert hashlib.sha256(blob).digest() == hashlib.sha256(level[0].proof.to_bytes()).digest()
    root.circuit_data.verify(root.proof)
    want = np.concatenate([np.asarray(p.public_inputs, dtype=np.uint64) for p in leaves])
    assert np.array_equal(np.asarray(root.proof.public_inputs, dtype=np.uint64), want)

    assert timer.marks.count("witness") == 3
    recorded = spans.spans_of(timer)
    names = [s.name for s in recorded]
    assert names.count("prove") == 3
    for name in ("aggregation.prefetch", "aggregation.prefetch_wait", "aggregation.fill",
                 "witness.generators"):
        assert names.count(name) == 3, name
    fills = [s for s in recorded if s.name in ("aggregation.fill", "witness.generators")]
    assert {s.parent.name for s in fills} == {"aggregation.prefetch"}
    # L1c1's front runs during L1c0's device part; the root's children
    # are the chunk before it
    assert [s.attrs["ready"] for s in recorded if s.name == "aggregation.prefetch_wait"][2] == 0
    assert not _helpers_alive()
