"""The program's spans (qzk_tpu_torch/utils/spans.py) in the prove and
the aggregation, on the CPU, on test_torch_fused.py's small circuit:

- without a timer nothing is recorded and no span site reads a clock;
- with one, the proof's bytes are the same, the marks keep their names
  and order, and the spans form one request whose phases end at the
  marks, whether the first PoW batch holds the hit or the host grinds;
- the prove's lock wait covers a lock another thread holds;
- a level's chunks that fan out record their spans in the worker
  threads, in the caller's request, and forward no mark; the sequential
  path forwards them;
- the torch profiler sees the spans as record_function ranges.
"""

import gc
import threading
import time
import weakref

import pytest
import torch

import qzk_tpu_torch.plonk.builder as tbuilder
import qzk_tpu_torch.plonk.config as tconfig
import qzk_tpu_torch.plonk.witness as twitness
from qzk_tpu_torch.models.wormhole import aggregator as tagg
from qzk_tpu_torch.models.wormhole.aggregator import (
    TreeAggregationConfig,
    aggregate_level,
    aggregate_to_tree,
)
from qzk_tpu_torch.plonk import device_prover as dp
from qzk_tpu_torch.utils import spans

CPU = torch.device("cpu")
# a first PoW batch this short misses, so the proves grind on the host
# (pow.grind) as a proof past the card's first batch does
POW_BATCH = 1 << 6
MARKS = ["fused pipeline (device, 1 dispatch)", "PoW finalize (host)",
         "FRI queries (in-dispatch gathers)"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


class Recorder:
    """The timer protocol on the host clock: (name, perf_counter)."""

    def __init__(self):
        self.marks = []

    def mark(self, name):
        self.marks.append((name, time.perf_counter()))


def _build(zk):
    """test_torch_fused.py's small circuit (every gate type)."""
    cfg = tconfig.CircuitConfig.standard_recursion_config().with_zero_knowledge(zk)
    builder = tbuilder.CircuitBuilder(cfg)
    xs = [builder.add_virtual_target() for _ in range(4)]
    h = builder.hash_n_to_hash_no_pad(xs)
    builder.register_public_inputs(h.elements)
    for x in xs:
        builder.range_check(x, 32)
    builder.register_public_input(builder.add(builder.mul(xs[0], xs[1]), xs[2]))
    data = builder.build()
    pw = twitness.PartialWitness()
    for i, x in enumerate(xs):
        pw.set_target(x, 1000 + i)
    return data, pw


def _raiser(*args, **kwargs):
    raise AssertionError("a span site did work with no request open")


class _NoClock:
    perf_counter = staticmethod(_raiser)


@pytest.fixture(scope="module")
def circuits():
    return {zk: _build(zk) for zk in (False, True)}


@pytest.fixture(scope="module")
def first_hits():
    """zk -> the small circuit's PoW witness, the first candidate with a
    hit, as a grind case finds it."""
    return {}


def _pow_witness(data, pw, ctx):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ctx, "pow_batch", POW_BATCH)
        return data.prove(pw, device=CPU).proof.fri.pow_witness


@pytest.fixture(scope="module", params=[(True, False), (True, True), (False, False),
                                        (False, True)],
                ids=["grind-nonzk", "grind-zk", "batch-nonzk", "batch-zk"])
def case(request, circuits, first_hits):
    """(grinds, zk, data, the proof without a timer, the proof with one,
    the timer) of the small circuit; the proof without a timer is made
    with every piece of the recorder raising.  A grind case's first PoW
    batch is POW_BATCH candidates, short of the first hit, so the host
    grinds on; another's ends just past the first hit, which the device
    finds in its batch."""
    grinds, zk = request.param
    data, pw = circuits[zk]
    ctx = dp.get_context(data.common, data.prover_only, CPU)
    if not grinds and zk not in first_hits:
        first_hits[zk] = _pow_witness(data, pw, ctx)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ctx, "pow_batch", POW_BATCH if grinds else first_hits[zk] + 1)
        with pytest.MonkeyPatch.context() as off:
            for name in ("_Open", "_Locked", "Phases", "Span", "_Request"):
                off.setattr(spans, name, _raiser)
            off.setattr(spans, "time", _NoClock)
            plain = data.prove(pw, device=CPU)
        timer = Recorder()
        traced = data.prove(pw, device=CPU, timer=timer)
    if grinds:
        first_hits[zk] = plain.proof.fri.pow_witness
    return grinds, zk, data, plain, traced, timer


def test_a_timer_leaves_the_proof_bytes(case):
    _, _, data, plain, traced, _ = case
    assert traced.to_bytes() == plain.to_bytes()
    data.verify(traced)


def test_marks_keep_their_names_and_order(case):
    _, zk, _, _, _, timer = case
    assert [n for n, _ in timer.marks] == ["witness"] + (["blinding"] if zk else []) + MARKS


def test_spans_form_one_request_ending_the_phases_at_the_marks(case):
    grinds, zk, data, _, traced, timer = case
    recorded = spans.spans_of(timer)
    root = recorded[0]
    assert root.name == "prove" and root.parent is None and root.attrs == {"card": "cpu"}
    assert {s.request for s in recorded} == {root.request}
    for s in recorded[1:]:
        assert s.parent is not None and s.parent.start <= s.start <= s.end <= s.parent.end
    phases = [s for s in recorded if s.parent is root and s.name in dict(timer.marks)]
    assert [p.name for p in phases] == [n for n, _ in timer.marks]
    assert phases[0].start == root.start
    for i, (p, (_, t)) in enumerate(zip(phases, timer.marks)):
        assert p.end <= t
        if i + 1 < len(phases):
            assert t <= phases[i + 1].end and phases[i + 1].start == p.end

    names = [s.name for s in recorded]
    assert names.count("witness.generators") == 1
    n_used = len(data.prover_only.rows)
    draws = (1 if n_used < data.common.degree else 0) + 3
    assert names.count("blinding.draw") == (draws if zk else 0)
    fused_spans = ["fused.upload", "fused.lock_wait", "fused.lock_held", "fused.replay",
                   "fused.download"]
    assert [names.count(n) for n in fused_spans] == [1] * 5
    assert not grinds or traced.proof.fri.pow_witness >= POW_BATCH
    assert names.count("pow.grind") == (1 if grinds else 0)
    by = {s.name: s for s in recorded}
    held = by["fused.lock_held"]
    assert by["fused.lock_wait"].end <= held.start
    for inner in ("fused.replay", "fused.download") + (("pow.grind",) if grinds else ()):
        assert by[inner].parent is held
    assert by["fused.replay"].device_ms is None  # no device time on the CPU


def test_generators_span_carries_threads_and_split_items(case):
    """The generators' span holds the threads they ran on, the items of
    the batches split across them and all their items: the small
    circuit's batches are too narrow to split."""
    *_, timer = case
    gen = [s for s in spans.spans_of(timer) if s.name == "witness.generators"]
    assert len(gen) == 1
    attrs = gen[0].attrs
    assert 0 <= attrs["split_items"] <= attrs["items"] and attrs["items"] > 0
    assert (attrs["threads"], attrs["split_items"]) == (1, 0)


def test_lock_wait_covers_a_lock_held_elsewhere(circuits, monkeypatch):
    """A thread holds the context's lock until the prove has asked for
    it, then 0.2 s more: the prove's lock wait spans that time."""
    data, pw = circuits[False]
    ctx = dp.get_context(data.common, data.prover_only, CPU)
    monkeypatch.setattr(ctx, "pow_batch", POW_BATCH)
    timer = Recorder()
    out = {}
    prover = threading.Thread(
        target=lambda: out.setdefault("proof", data.prove(pw, device=CPU, timer=timer)))
    with ctx.lock:
        prover.start()
        deadline = time.perf_counter() + 120
        while not any(s.name == "fused.lock_wait" for s in spans.spans_of(timer)):
            assert time.perf_counter() < deadline and prover.is_alive()
            time.sleep(0.005)
        time.sleep(0.2)
        released = time.perf_counter()
    prover.join(timeout=120)
    assert not prover.is_alive() and "proof" in out
    wait = next(s for s in spans.spans_of(timer) if s.name == "fused.lock_wait")
    assert wait.start < released <= wait.end
    assert wait.end - wait.start >= 0.2


def _stub_chunk(seen):
    """A _prove_chunk that records its thread, its timer and its chunk,
    and proves in a span "prove" as the real one does."""
    lock = threading.Lock()

    def stub(circuit, chunk, verifier_only, device=None, timer=None, front=None):
        with spans.span("prove", timer=timer, card=device) as phases:
            if phases is not None:
                phases.mark("witness")
        with lock:
            seen.append((threading.current_thread().name, timer, tuple(chunk)))
        return tagg.AggregatedProof(proof=("p", tuple(chunk)), circuit_data=circuit)

    return stub


def test_fan_out_records_chunk_spans_in_the_request(monkeypatch):
    monkeypatch.setenv("QZK_AGG_WORKERS", "2")
    monkeypatch.setattr(tagg, "build_chunk_circuit", lambda common, size: f"circuit/{size}")
    seen = []
    monkeypatch.setattr(tagg, "_prove_chunk", _stub_chunk(seen))
    timer = Recorder()
    out = aggregate_level(list(range(5)), "common", "vo", TreeAggregationConfig.new(2, 2),
                          device="cpu", timer=timer)
    assert [p.proof for p in out] == [("p", (0, 1)), ("p", (2, 3)), ("p", (4,))]
    assert timer.marks == []
    assert all(t is None for _, t, _ in seen)
    assert threading.main_thread().name not in {name for name, _, _ in seen}
    recorded = spans.spans_of(timer)
    level = recorded[0]
    assert level.name == "aggregation.level" and level.parent is None
    assert level.attrs == {"level": 1, "chunks": 3}
    assert {s.request for s in recorded} == {level.request}
    chunks = sorted((s for s in recorded if s.name == "aggregation.chunk"),
                    key=lambda s: s.attrs["chunk"])
    assert [c.attrs for c in chunks] == [{"level": 1, "chunk": i, "card": "cpu"}
                                         for i in range(3)]
    assert all(c.parent is level for c in chunks)
    proves = [s for s in recorded if s.name == "prove"]
    assert len(proves) == 3 and {p.parent for p in proves} == set(chunks)
    assert all(s.parent.start <= s.start <= s.end <= s.parent.end for s in recorded[1:])


def test_sequential_levels_forward_marks(monkeypatch):
    monkeypatch.delenv("QZK_AGG_WORKERS", raising=False)
    monkeypatch.setattr(tagg, "build_chunk_circuit", lambda common, size: f"circuit/{size}")
    seen = []
    stub = _stub_chunk(seen)

    class _Data:
        common = verifier_only = "next"

    def chunk_proof(*args, **kwargs):
        out = stub(*args, **kwargs)
        out.circuit_data = _Data
        return out

    monkeypatch.setattr(tagg, "_prove_chunk", chunk_proof)
    monkeypatch.setattr(tagg, "_chunk_front", lambda circuit, chunk, vo: tuple(chunk))
    timer = Recorder()
    aggregate_to_tree(list(range(4)), "common", "vo", TreeAggregationConfig.new(2, 2),
                      device="cpu", timer=timer)
    assert [n for n, _ in timer.marks] == ["witness"] * 3
    assert all(t is timer for _, t, _ in seen)
    assert {name for name, _, _ in seen} == {threading.current_thread().name}
    recorded = spans.spans_of(timer)
    root = recorded[0]
    assert root.name == "aggregate" and root.parent is None
    levels = [s for s in recorded if s.name == "aggregation.level"]
    assert [lv.attrs for lv in levels] == [{"level": 1, "chunks": 2}, {"level": 2, "chunks": 1}]
    chunks = [(s.attrs["level"], s.attrs["chunk"]) for s in recorded
              if s.name == "aggregation.chunk"]
    assert chunks == [(1, 0), (1, 1), (2, 0)]
    assert {s.request for s in recorded} == {root.request}


def test_requests_of_threads_stay_apart():
    """Each thread's prove opens its own request, as four callers do."""
    timers = [Recorder() for _ in range(4)]
    barrier = threading.Barrier(4, timeout=30)

    def caller(timer):
        with spans.span("prove", timer=timer):
            barrier.wait()
            with spans.span("fused.upload"):
                barrier.wait()

    threads = [threading.Thread(target=caller, args=(t,)) for t in timers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    recorded = [spans.spans_of(t) for t in timers]
    assert [[s.name for s in r] for r in recorded] == [["prove", "fused.upload"]] * 4
    assert len({r[0].request for r in recorded}) == 4
    assert all(r[1].parent is r[0] and r[1].request == r[0].request for r in recorded)


def test_set_attrs_adds_to_the_innermost_open_span():
    """Attributes known at a span's end join the innermost open span's,
    and its parent's stay; with no request open nothing is kept."""
    spans.set_attrs(values=1)  # no request: a no-op
    timer = Recorder()
    with spans.span("aggregation.chunk", timer=timer, level=1, chunk=0):
        with spans.span("aggregation.fill", attrs={"children": 7}):
            spans.set_attrs(values=12)
        spans.set_attrs(children=7, degree_bits=17)
    chunk, fill = spans.spans_of(timer)
    assert fill.attrs == {"children": 7, "values": 12}
    assert chunk.attrs == {"level": 1, "chunk": 0, "children": 7, "degree_bits": 17}


def test_spans_live_as_long_as_their_timer():
    timer = Recorder()
    with spans.span("prove", timer=timer):
        pass
    assert len(spans.spans_of(timer)) == 1
    alive = weakref.ref(timer)
    del timer
    gc.collect()
    assert alive() is None  # nothing of the spans keeps the timer
    assert spans.spans_of(Recorder()) == []
    # a timer that takes no weak reference still gets its marks, and no spans
    with spans.span("prove", timer=object()) as phases:
        with spans.span("fused.upload"):
            pass
        assert phases is not None
    assert spans.spans_of(object()) == []


def test_the_profiler_sees_each_span_as_a_range(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    timer = Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("prove", timer=timer) as phases:
            with spans.span("witness.generators"):
                torch.ones(4).sum()
            phases.mark("witness")
    names = {e.name for e in prof.events()}
    assert {"prove", "witness.generators"} <= names
    assert "witness" not in names  # a phase is named at its end: no range
    assert [n for n, _ in timer.marks] == ["witness"]
