"""The readers of the program's spans (benchmark/metrics/{generators,
salt,upload,replay,lock_wait,lock_held}_ms.py, harness/spans.py) on
synthetic windows whose Marks carry spans the program recorded on a
scripted clock, and spec.load_cell finding a reader for each entry that
names them."""

import json
import os

import pytest

from conftest import ROOT
from harness import spans as bench_spans
from harness import spec
from harness.cell import Run
from harness.window import Marks, Request

from qzk_tpu_torch.utils import spans

# the per-layer entries that read the spans, each with the cells it lists
ENTRIES = [
    ("generators_ms.one_caller", "witness", "prove_p95_ms", "wormhole_zk.one_caller"),
    ("generators_ms.four_callers", "witness", "proofs_per_s", "wormhole_zk.four_callers"),
    ("generators_ms.agg", "aggregation", "agg_leaves_per_s", "agg_2x3.one_card"),
    ("salt_ms.one_caller", "zk blinding", "prove_p95_ms", "wormhole_zk.one_caller"),
    ("salt_ms.agg", "zk blinding", "agg_leaves_per_s", "agg_2x3.one_card"),
    ("upload_ms.one_caller", "fused pipeline", "prove_p95_ms", "wormhole_zk.one_caller"),
    ("upload_ms.agg", "fused pipeline", "agg_leaves_per_s", "agg_2x3.one_card"),
    ("replay_ms.one_caller", "fused pipeline", "prove_p95_ms", "wormhole_zk.one_caller"),
    ("replay_ms.agg", "fused pipeline", "agg_leaves_per_s", "agg_2x3.one_card"),
    ("lock_wait_ms.four_callers", "fused pipeline", "proofs_per_s", "wormhole_zk.four_callers"),
    ("lock_held_ms.four_callers", "fused pipeline", "proofs_per_s", "wormhole_zk.four_callers"),
]


class _Clock:
    """perf_counter that advances by one millisecond a reading."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        self.t += 1e-3
        return self.t


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def _leaf_prove(timer, replay_device_ms=None):
    """One prove's spans as the fused path records them: generators,
    four draws, upload, lock wait and hold, replay, download."""
    with spans.span("prove", timer=timer, card="cuda:0"):
        with spans.span("witness.generators"):
            pass
        for _ in range(4):
            with spans.span("blinding.draw"):
                pass
        with spans.span("fused.upload"):
            pass
        with spans.locked(_NoLock(), "fused.lock_wait", "fused.lock_held"):
            with spans.span("fused.replay"):
                pass
            with spans.span("fused.download"):
                pass
    if replay_device_ms is not None:
        replay = [s for s in spans.spans_of(timer) if s.name == "fused.replay"][-1]
        replay._events = (_Event(0.0), _Event(replay_device_ms))


class _NoLock:
    def acquire(self):
        pass

    def release(self):
        pass


def _run(requests):
    return Run(setup_s=1.0, window_s=1.0, requests=requests, leaves_per_request=1, cards=1,
               trace=None, traced_proofs=0, traced_work=None, rates=None)


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(spans, "time", c)
    return c


def _reader(name):
    return spec.load_reader(name)


def test_each_reader_takes_the_mean_per_prove(clock):
    """A span of one clock reading at each end lasts 1 ms; a draw 1 ms
    each, four a prove; the lock's wait and hold each span their inner
    readings."""
    reqs = []
    for seq in range(3):
        m = Marks()
        _leaf_prove(m, replay_device_ms=10.0 + seq)
        reqs.append(Request(caller=0, seq=seq, sent=0.0, done=1.0, marks=m))
    run = _run(reqs)
    assert _reader("generators_ms.one_caller").read(run) == pytest.approx(1.0)
    assert _reader("salt_ms.one_caller").read(run) == pytest.approx(4.0)
    assert _reader("upload_ms.one_caller").read(run) == pytest.approx(1.0)
    assert _reader("lock_wait_ms.four_callers").read(run) == pytest.approx(1.0)
    # held: its own end reading, and the replay's and download's two each
    assert _reader("lock_held_ms.four_callers").read(run) == pytest.approx(5.0)
    assert _reader("replay_ms.one_caller").read(run) == pytest.approx(11.0)


def test_a_chunk_prove_counts_as_one_prove(clock):
    """An aggregation request of three chunk proves, generators in each:
    the mean is over the three proves, not the one request."""
    m = Marks()
    with spans.span("aggregate", timer=m):
        for chunk in range(3):
            with spans.span("aggregation.chunk", level=1, chunk=chunk):
                with spans.span("prove"):
                    with spans.span("witness.generators"):
                        clock.t += 0.009  # 10 ms with its end reading
    run = _run([Request(caller=0, seq=0, sent=0.0, done=1.0, marks=m)])
    assert _reader("generators_ms.agg").read(run) == pytest.approx(10.0)


@pytest.mark.parametrize("name", sorted({e[0] for e in ENTRIES}))
def test_a_reader_reads_nothing_without_its_span(clock, name):
    """No span of the name (a staged prove holds no fused.*; the replay
    on the CPU has no device time), no marks, or no spans at all: None."""
    m = Marks()
    with spans.span("prove", timer=m):
        with spans.span("fused.replay"):  # no device time
            pass
    reqs = [Request(caller=0, seq=0, sent=0.0, done=1.0, marks=m),
            Request(caller=0, seq=1, sent=0.0, done=1.0, marks=None)]
    reader = _reader(name)
    assert reader.read(_run(reqs)) is None
    assert reader.read(_run([])) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """The parent of the spans: importing them fails, and each reader
    gives None without raising."""
    import builtins

    real = builtins.__import__

    def no_spans(name, *args, **kwargs):
        if name == "qzk_tpu_torch.utils.spans":
            raise ImportError(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_spans)
    run = _run([Request(caller=0, seq=0, sent=0.0, done=1.0, marks=Marks())])
    assert bench_spans.request_spans(run) == []
    assert all(_reader(e[0]).read(run) is None for e in ENTRIES)


def test_load_cell_finds_each_entrys_reader(tmp_path):
    """BENCHMARK.json with the entries appended: each cell that an entry
    lists loads it, with the reader of its kind."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"] += [
        {"name": name, "unit": "ms", "better": "lower", "source": "program_span",
         "layer": layer, "moves": moves, "workloads": [cell]}
        for name, layer, moves, cell in ENTRIES]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    os.symlink(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark")
    for name, _, _, cell in ENTRIES:
        loaded = {m.name: m for m in spec.load_cell(str(tmp_path), cell).per_layer}
        assert name in loaded
        kind = name.split(".")[0]
        assert os.path.basename(loaded[name].reader.__file__) == f"{kind}.py"
        assert callable(loaded[name].reader.read)
