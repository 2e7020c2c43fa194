"""The port's prove profiler (qzk_tpu_torch/tools/profile_prover.py):
its chrome-trace parsing on synthetic traces, as tests/test_tools.py
covers the JAX tool's, so that the fast tier needs no card and no
profile run."""

import gzip
import json
import os
import subprocess
import sys

import pytest

from qzk_tpu_torch.tools.profile_prover import kernel_name, summarize

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(path, events, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(path)


@pytest.mark.parametrize("gz", [False, True], ids=["json", "json.gz"])
def test_device_events_and_grouping(tmp_path, gz):
    """torch.profiler's kernel, memcpy and memset categories count; host
    ops, runtime calls and annotations do not; every instantiation of a
    kernel groups under its bare name."""
    trace = _write(tmp_path / ("t.json.gz" if gz else "t.json"), [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "process_name", "pid": 77, "args": {"name": "python3"}},
        {"ph": "X", "cat": "kernel", "pid": 0, "name": "void hash_rows_kernel<8>(unsigned long const*)",
         "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "kernel", "pid": 0, "name": "void hash_rows_kernel<4>(unsigned long const*)",
         "ts": 1000, "dur": 3000},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "name": "Memcpy DtoH (Device -> Pageable)",
         "ts": 4000, "dur": 500},
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "name": "qzk_prove", "ts": 0, "dur": 9000},
        {"ph": "X", "cat": "cpu_op", "pid": 77, "name": "aten::mul", "ts": 0, "dur": 99999},
        {"ph": "X", "cat": "cuda_runtime", "pid": 77, "name": "cudaLaunchKernel", "ts": 0, "dur": 5},
        {"ph": "B", "cat": "kernel", "pid": 0, "name": "begin", "ts": 0},
    ], gz)
    lines = []
    rec = summarize(trace, top=10, out=lines.append)
    assert rec["device_ms"] == pytest.approx(4.5)
    assert rec["device_events"] == 3 and rec["kernels"] == 2
    assert rec["by_name"][0] == ["hash_rows_kernel", pytest.approx(4.0), 2]
    assert rec["by_name"][1][0] == "Memcpy DtoH"
    text = "\n".join(lines)
    assert "aten::mul" not in text and "cudaLaunchKernel" not in text


def test_idle_share_from_overlapping_intervals(tmp_path):
    """Busy time is the union of the device intervals, clipped to the
    qzk_prove range; the idle share is the rest of that range."""
    trace = _write(tmp_path / "t.json", [
        {"ph": "X", "cat": "user_annotation", "pid": 77, "name": "qzk_prove", "ts": 1000, "dur": 5000},
        {"ph": "X", "cat": "kernel", "pid": 0, "name": "a", "ts": 1000, "dur": 1000},
        {"ph": "X", "cat": "kernel", "pid": 0, "name": "b", "ts": 1500, "dur": 1000},  # overlaps a
        {"ph": "X", "cat": "kernel", "pid": 0, "name": "c", "ts": 4000, "dur": 1000},
        {"ph": "X", "cat": "kernel", "pid": 0, "name": "d", "ts": 5500, "dur": 1000},  # half outside
        {"ph": "X", "cat": "kernel", "pid": 0, "name": "e", "ts": 9000, "dur": 1000},  # outside
    ])
    rec = summarize(trace, out=lambda s: None)
    assert rec["window_ms"] == pytest.approx(5.0)
    assert rec["busy_ms"] == pytest.approx(1.5 + 1.0 + 0.5)
    assert rec["idle_share"] == pytest.approx(1 - 3.0 / 5.0)
    assert rec["device_ms"] == pytest.approx(1.0 + 1.0 + 1.0 + 0.5)
    assert rec["device_events"] == 4


def test_lane_filter_without_categories(tmp_path):
    """An event without a category counts when it lies on a device
    lane; with no lane named, the window is the span of all events."""
    trace = _write(tmp_path / "t.json", [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "name": "process_name", "pid": 2, "args": {"name": "python"}},
        {"ph": "X", "pid": 1, "name": "k", "ts": 0, "dur": 2000},
        {"ph": "X", "pid": 2, "name": "hostwork", "ts": 0, "dur": 4000},
    ])
    rec = summarize(trace, out=lambda s: None)
    assert rec["device_ms"] == pytest.approx(2.0)
    assert rec["window_ms"] == pytest.approx(4.0)
    assert rec["idle_share"] == pytest.approx(0.5)
    empty = summarize(_write(tmp_path / "e.json", []), out=lambda s: None)
    assert empty["device_events"] == 0 and empty["idle_share"] is None


def test_idle_gaps_named_by_the_innermost_span(tmp_path):
    """The program's spans are user_annotation ranges on the host: each
    idle gap of the window goes to the innermost range holding its
    midpoint, a gap inside none to "outside any span"; the window's own
    range names nothing."""
    def rng(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "pid": 77, "tid": 1, "name": name,
                "ts": ts, "dur": dur}

    trace = _write(tmp_path / "t.json", [
        rng("qzk_prove", 0, 10000),
        rng("prove", 1000, 9000),
        rng("fused.lock_held", 5000, 4000),
        rng("fused.replay", 5000, 1000),
        rng("fused.download", 6000, 2000),
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "name": "fused.replay",
         "ts": 5000, "dur": 4000},
        {"ph": "X", "cat": "kernel", "pid": 0, "name": "k", "ts": 500, "dur": 1000},
        {"ph": "X", "cat": "kernel", "pid": 0, "name": "k", "ts": 5500, "dur": 1000},
    ])
    lines = []
    rec = summarize(trace, out=lines.append)
    # idle: [0, 500) outside; [1500, 5500) mid 3500 in prove; [6500, 10000)
    # mid 8250 in fused.lock_held (the download ended at 8000)
    assert dict(rec["idle_by_span"]) == pytest.approx(
        {"outside any span": 0.5, "prove": 4.0, "fused.lock_held": 3.5})
    assert rec["idle_by_span"][0][0] == "prove"
    assert sum(ms for _, ms in rec["idle_by_span"]) == pytest.approx(
        rec["window_ms"] - rec["busy_ms"])
    assert any("innermost program span" in line for line in lines)


def test_idle_gap_inside_nested_spans_takes_the_innermost():
    from qzk_tpu_torch.tools.profile_prover import idle_by_span

    ranges = [(0, 100, "prove"), (10, 90, "fused.lock_held"), (20, 40, "fused.download")]
    assert idle_by_span(ranges, [(0, 25), (35, 100)], 0, 100) == {"fused.download": 0.01}
    assert idle_by_span(ranges, [], 0, 100) == {"fused.lock_held": 0.1}
    assert idle_by_span([], [(0, 50)], 0, 100) == {"outside any span": 0.05}


@pytest.mark.parametrize("raw, name", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<long, long, "
     "long, at::native::BitwiseAndFunctor<long> >, at::detail::Array<char*, 3> >(int, T1, T2)",
     "at::native::vectorized_elementwise_kernel"),
    ("void ntt_axis0_kernel<5>(Args)", "ntt_axis0_kernel"),
    ("void (anonymous namespace)::hash_rows_kernel<8>(unsigned long const*, long long)",
     "hash_rows_kernel"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<long, 4>(long*)",
     "at::native::CatArrayBatchedCopy"),
    ("permute_kernel", "permute_kernel"),
    ("Memset (Device)", "Memset"),
])
def test_kernel_name(raw, name):
    assert kernel_name(raw) == name


def test_import_runs_nothing():
    """Importing the tool neither profiles nor imports the card's
    libraries or JAX."""
    code = ("import sys; sys.path.insert(0, %r); import qzk_tpu_torch.tools.profile_prover; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'qzk_tpu')]; "
            "assert not bad, bad; print('IMPORT_OK')" % _REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "IMPORT_OK" in res.stdout


@pytest.mark.parametrize("outdir", [None, "nested/bins"], ids=["default", "given"])
def test_export_dummy_proof_writes_both_files(tmp_path, monkeypatch, outdir):
    """The port's dummy-proof tool (qzk_tpu_torch/tools/export_dummy_proof.py)
    with the prove stubbed: one prove of synthetic_circuit_inputs() under
    CircuitConfig() with zero knowledge on, one with it off, each written
    under its file name into the given directory (generated-bins under
    the working directory by default)."""
    from qzk_tpu_torch.models.wormhole.fixtures import synthetic_circuit_inputs
    from qzk_tpu_torch.plonk.config import CircuitConfig
    from qzk_tpu_torch.tools import export_dummy_proof as tool

    seen = []

    def fake_prove(config, inputs, device):
        assert inputs == synthetic_circuit_inputs()
        seen.append((config, device))
        return b"zk proof" if config.zero_knowledge else b"non-zk proof"

    monkeypatch.setattr(tool, "prove_bytes", fake_prove)
    monkeypatch.chdir(tmp_path)
    tool.main(([] if outdir is None else [outdir]) + ["--device", "cpu"])
    out = tmp_path / (outdir or "generated-bins")
    assert seen == [(CircuitConfig().with_zero_knowledge(True), "cpu"),
                    (CircuitConfig().with_zero_knowledge(False), "cpu")]
    assert sorted(p.name for p in out.iterdir()) == ["dummy_proof.bin", "dummy_proof_zk.bin"]
    assert (out / "dummy_proof_zk.bin").read_bytes() == b"zk proof"
    assert (out / "dummy_proof.bin").read_bytes() == b"non-zk proof"
